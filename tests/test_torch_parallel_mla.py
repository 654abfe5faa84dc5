"""DeepSeek-V2 MLA + MoE under a mesh (``InferenceEngine(mesh=...)``,
``models/deepseek.py``) on the CPU, two gloo processes
(``tests/_torch_ranks.py``), against the JAX package and the unsharded
port engine.

The model is ``tests/test_deepseek_mla.py``'s ``MOE_CFG`` (4 q heads, 4
routed experts of which 2 a token, one shared, the first layer dense;
numpy-seeded fp32 weights, ``deepseek.numpy_params``), at a model axis of
2: each rank holds 2 q heads and 2 experts.

  * Expert parallelism: each rank's ``deepseek._mlp`` on its shard of an
    MoE layer (its experts, the others' combine weights zero, the fp32
    partials summed over the model axis), against the JAX
    ``moe_expert_parallel`` on a (data 1, model 2) mesh of the virtual CPU
    devices (``tests/conftest.py``), within rtol 2e-4 / atol 2e-5, the JAX
    package's own tolerance (``tests/test_sharding_parallel.py``): a
    12-token prefill (the sorted path), a decode step of one token (the
    gathered experts) and of three (more pairs on a rank than its experts:
    the dense form). With 3 experts, which do not divide the axis, every
    rank holds and runs every expert, as the JAX ``_mlp`` does: against it.
  * The engine, xKV groups of 2 over the latent (rank 16, exact SVD), a
    24-token prompt, ``tail_max`` 4, 10 tokens (two refolds), bf16 and
    int4 latent factors: tokens equal to the unsharded port engine's
    (``tests/test_torch_deepseek.py`` holds that one against the JAX
    engine). The latent and its factors are whole on every rank, so one
    device over a rank's own cache (``gather_cache(..., heads=False)``)
    takes the same step: within 1e-5, the first step and the first after a
    refold. Against the unsharded engine's own cache the two sides'
    latents differ by ~1e-7 (the sharded model sums ``o_proj`` and
    ``w_down`` in two halves), which rounds single bf16 / int4 factor
    elements the other way: the first step read 3.8e-5 (bf16) and 9.7e-7
    (int4), the first after a refold 1.8e-4 and 2.2e-4; ``TOL_OWN`` is
    twice those (1e-5 for int4's first step).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_ranks import run_ranks  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401
from xkv_tpu.models import deepseek as jds  # noqa: E402
from xkv_tpu.models.config import ModelConfig as JaxModelConfig  # noqa: E402
from xkv_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from xkv_tpu_torch.models import deepseek  # noqa: E402
from xkv_tpu_torch.models.config import ModelConfig  # noqa: E402

MOE_CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=4,
               num_q_heads=4, num_kv_heads=4, head_dim=16, model_type="deepseek_v2",
               q_lora_rank=None, kv_lora_rank=32, qk_rope_head_dim=8, qk_nope_head_dim=16,
               v_head_dim=16, n_routed_experts=4, n_shared_experts=1, num_experts_per_tok=2,
               moe_intermediate_size=32, first_k_dense_replace=1, routed_scaling_factor=1.0,
               norm_topk_prob=True)
# (token shape, decode): the sorted path, the gathered experts, the dense form.
MOE_INPUTS = {"prefill": ((1, 12), False), "decode b1": ((1, 1), True),
              "decode b3": ((3, 1), True)}
TOL_EP = dict(rtol=2e-4, atol=2e-5)
TOL = 1e-5
# Against the unsharded engine's own cache, by factor dtype and step: twice
# the readings (module docstring).
TOL_OWN = {"bf16": {"first": 2 * 3.8e-5, "refold": 2 * 1.8e-4},
           "int4": {"first": TOL, "refold": 2 * 2.2e-4}}
PROMPT, NEW, TAIL = 24, 10, 4

RANK = """
import numpy as np
from xkv_tpu_torch.configs import generate_consecutive_xkv_config
from xkv_tpu_torch.engine import InferenceEngine
from xkv_tpu_torch.models import deepseek
from xkv_tpu_torch.models.ckpt import params_from_numpy
from xkv_tpu_torch.models.config import ModelConfig
from xkv_tpu_torch.parallel.mesh import make_mesh
from xkv_tpu_torch.parallel.sharding import gather_cache, shard_params

fields, inputs, (n_prompt, n_new, tail) = (json.loads(a) for a in argv)
mesh = make_mesh(data=1, model=2)
res = {}
for n_exp in (4, 3):
    cfg = ModelConfig(**dict(fields, n_routed_experts=n_exp))
    params = params_from_numpy(deepseek.numpy_params(cfg, 1), device="cpu")
    layer = shard_params(params, mesh)["layers"][1]["mlp"]
    for name, (shape, decode) in inputs.items():
        x = torch.from_numpy(np.random.default_rng(7).standard_normal(
            (*shape, cfg.hidden_size), dtype=np.float32))
        y = deepseek._mlp(layer, cfg, x, decode=decode, mesh=mesh)
        res[f"moe {n_exp} {name}"] = [y.tolist(), layer["experts"]["w_gate"].shape[0]]

cfg = ModelConfig(**fields)
params = params_from_numpy(deepseek.numpy_params(cfg, 1), device="cpu")
prompt = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (1, n_prompt)))

def diff(a, b):
    return (a - b).abs().max().item()

for fd in ("bf16", "int4"):
    xkv = generate_consecutive_xkv_config(
        num_layers=4, end_layer=3, group_size=2, rank_k=16, rank_v=None, merge_value=False,
        extra_kwargs={"svd_method": "exact", "int4_rank_frac": 0.5})
    kw = dict(xkv=xkv, mode="factored", tail_max=tail, cache_dtype=torch.float32,
              factor_dtype="int4" if fd == "int4" else torch.bfloat16, device="cpu")
    tp = InferenceEngine(params, cfg, mesh=mesh, **kw)
    one = InferenceEngine(params, cfg, **kw)
    row = {"tokens": tp.generate(prompt, n_new).tolist(),
           "tokens_one": one.generate(prompt, n_new).tolist(),
           "heads": [tp.shard_cfg.num_q_heads,
                     tp.params["layers"][1]["mlp"]["experts"]["w_gate"].shape[0]]}
    lo, co = one.prefill(prompt)
    lt, ct = tp.prefill(prompt)
    row["prefill"] = diff(lo, lt)
    toks = row["tokens"][0]
    pos = n_prompt
    for name in ("first", "refold"):
        i0 = tail if name == "refold" else 0
        if name == "refold":
            for i in range(1, tail + 1):
                t = torch.tensor([[toks[i - 1]]])
                _, co = one.decode_step(co, t, pos + i - 1)
                _, ct = tp.decode_step(ct, t, pos + i - 1)
            co, ct = one.refactorize(co), tp.refactorize(ct)
        t = torch.tensor([[toks[i0]]])
        joined = gather_cache(ct, [2, 2], mesh, heads=False)
        s_one, _ = one.decode_step(co, t, pos + i0)
        s_join, _ = one.decode_step(joined, t, pos + i0)
        s_tp, _ = tp.decode_step(ct, t, pos + i0)
        row[name] = [diff(s_tp, s_join), diff(s_tp, s_one)]
    res[fd] = row
finish(res)
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tp_mla"))
    return run_ranks(RANK, 2, out, json.dumps(MOE_CFG),
                     json.dumps({k: [list(s), d] for k, (s, d) in MOE_INPUTS.items()}),
                     json.dumps([PROMPT, NEW, TAIL]))


@pytest.mark.parametrize("n_exp", [4, 3], ids=["ep", "replicated"])
@pytest.mark.parametrize("name", list(MOE_INPUTS))
def test_moe_under_a_mesh_matches_jax(two_ranks, name, n_exp):
    fields = dict(MOE_CFG, n_routed_experts=n_exp)
    tcfg = ModelConfig(**fields)
    p = jax.tree.map(jnp.asarray, deepseek.numpy_params(tcfg, 1)["layers"][1]["mlp"])
    shape, _ = MOE_INPUTS[name]
    x = np.random.default_rng(7).standard_normal((*shape, tcfg.hidden_size), dtype=np.float32)
    mesh = jax_make_mesh(data=1, model=2, devices=jax.devices()[:2])
    want = jax.jit(lambda p, x: jds._mlp(p, JaxModelConfig(**fields), x, mesh=mesh))(p, x)
    got, local = two_ranks[f"moe {n_exp} {name}"]
    assert local == (2 if n_exp == 4 else 3)  # a rank's experts
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL_EP)


@pytest.mark.parametrize("fd", ["bf16", "int4"])
def test_mla_tp_engine_matches_one_device(two_ranks, fd):
    row = two_ranks[fd]
    assert row["heads"] == [2, 2]  # q heads and experts a rank
    assert len(row["tokens"][0]) == NEW
    assert row["tokens"] == row["tokens_one"]
    assert row["prefill"] <= TOL
    for name in ("first", "refold"):
        joined, one = row[name]
        assert joined <= TOL, (name, joined)
        assert one <= TOL_OWN[fd][name], (name, one)
