"""Pipeline parallelism (``xkv_tpu_torch/parallel/pipeline.py``) on the
CPU, gloo processes on 127.0.0.1 (``tests/_torch_ranks.py``) as the
stages, against the JAX package (``xkv_tpu/parallel/pipeline.py`` on a
``("pipe",)`` mesh of the virtual devices of ``tests/conftest.py``), with
the JAX tests' settings (``tests/test_sharding_parallel.py``):

  * ``pipelined_forward`` over 4 stages at M 2 (4 layers of 4 q / 2 kv
    heads of 16, hidden 64; b 4 x 16 tokens): the logits within 1e-5 of
    the JAX ``pipelined_forward`` and of the JAX and the port's
    ``llama.prefill``;
  * ``pipelined_decode_step`` over 2 stages (4 layers of 8 q / 4 kv heads,
    two xKV groups of 2 at rank 16, post RoPE; b 4, a 32-token prompt),
    with fp32 and int8 factors, over the JAX engine's cache (carried with
    ``cache_from_numpy``): two chained steps at M 2 then M 4, the logits
    and the stages' joined tail rows within 1e-5 of the port's
    ``llama.decode_step`` over the same cache, the tail's fill equal, and
    of the JAX ``pipelined_decode_step``'s within 1e-5 with fp32 factors.
    With int8 factors K2's plain version rounds the query's projection into
    rank space to bf16, as the kernel does, where the JAX XLA path keeps
    fp32: the port's single-device step reads 1.59e-3 and 1.86e-3 off the
    JAX one's logits (tail 3.04e-3), the pipeline the same to within 1e-5,
    so the pipeline is held to the JAX one at twice those readings and to
    the JAX step's gap within 1e-5;
  * every layout ``_check_uniform_groups`` refuses, with the JAX function's
    message, on both sides; a batch that the microbatches do not divide,
    a multi-token step, and ``stack_layer_params`` against the JAX one.
"""

import json
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_ranks import numpy_llama, run_ranks  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

TOL = 1e-5
FWD_CFG = dict(num_layers=4, num_q_heads=4, num_kv_heads=2, head_dim=16, hidden_size=64,
               intermediate_size=128)
DEC_CFG = dict(num_layers=4, num_q_heads=8, num_kv_heads=4, head_dim=16, hidden_size=128,
               intermediate_size=256)
FACTORS = ("fp32", "int8")
# Against the JAX pipeline (module docstring): twice the int8 readings.
TOL_JAX = {"fp32": {"logits": TOL, "tail": TOL},
           "int8": {"logits": 2 * 1.86e-3, "tail": 2 * 3.04e-3}}
B, PROMPT = 4, 32

FWD_RANK = """
import numpy as np
from xkv_tpu_torch.models.ckpt import params_from_numpy
from xkv_tpu_torch.models.config import tiny_llama_config
from xkv_tpu_torch.parallel.pipeline import make_pipe_mesh, pipelined_forward, stage_params

cfg = tiny_llama_config(**json.loads(argv[0]))
mesh = make_pipe_mesh()
params = stage_params(params_from_numpy(numpy_llama(cfg, 11), device="cpu"), cfg, mesh)
tokens = torch.from_numpy(np.load(out + "/tokens.npy"))
logits = pipelined_forward(params, cfg, tokens, mesh, num_microbatches=2)
if rank == 0:
    np.save(out + "/logits.npy", logits.numpy())
finish({"layers": len(params["layers"])})
"""

DEC_RANK = """
import numpy as np
from xkv_tpu_torch.configs import generate_consecutive_xkv_config
from xkv_tpu_torch.models import llama
from xkv_tpu_torch.models.ckpt import params_from_numpy
from xkv_tpu_torch.models.config import tiny_llama_config
from xkv_tpu_torch.ops.rope import rope_cos_sin
from xkv_tpu_torch.parallel.pipeline import (join_stage_tails, make_pipe_mesh,
                                             pipelined_decode_step, stage_cache)

cfg = tiny_llama_config(**json.loads(argv[0]))
mesh = make_pipe_mesh()
params = params_from_numpy(numpy_llama(cfg, 0), device="cpu")
xkv = generate_consecutive_xkv_config(num_layers=4, end_layer=-1, group_size=2, rank_k=16,
                                      rank_v=16, extra_kwargs={"rope_mode": "post"})
res = {}
for fd in json.loads(argv[1]):
    data = torch.load(out + f"/cache_{fd}.pt", weights_only=False)
    whole, toks, pos = data["cache"], data["tokens"], data["pos"]
    mine = stage_cache(whole, cfg, xkv, mesh)
    cos_sin = rope_cos_sin(torch.arange(whole.prefill_len), cfg.head_dim, cfg.rope_theta,
                           cfg.rope_scaling)
    keep = {"rows": [len(mine.groups), mine.tail_k.shape[0]]}
    for i, m in enumerate((2, 4)):
        logits, mine = pipelined_decode_step(params, cfg, xkv, mine, toks[i], pos + i, mesh,
                                             num_microbatches=m)
        ref, whole = llama.decode_step(params, cfg, xkv, whole, toks[i], pos + i, cos_sin)
        tail_k, tail_v = join_stage_tails(mine, cfg, mesh)
        keep[f"step{i}"] = dict(logits=logits, tail_k=tail_k, tail_v=tail_v,
                                count=mine.tail_count, ref=ref, ref_k=whole.tail_k.clone(),
                                ref_v=whole.tail_v.clone(), ref_count=whole.tail_count)
    res[fd] = keep
if rank == 0:
    torch.save(res, out + "/decode.pt")
finish({})
"""


@pytest.fixture(scope="module")
def forward(tmp_path_factory):
    """The port's 4 stages, the JAX pipeline and both plain prefills."""
    from xkv_tpu.models.config import tiny_llama_config as jax_tiny
    from xkv_tpu.models.llama import prefill as jax_prefill
    from xkv_tpu.parallel.pipeline import pipelined_forward as jax_pipelined_forward
    from xkv_tpu_torch.models import llama
    from xkv_tpu_torch.models.ckpt import params_from_numpy
    from xkv_tpu_torch.models.config import tiny_llama_config

    out = str(tmp_path_factory.mktemp("pp_fwd"))
    tokens = np.random.default_rng(11).integers(0, 256, size=(4, 16)).astype(np.int32)
    np.save(os.path.join(out, "tokens.npy"), tokens.astype(np.int64))
    res = run_ranks(FWD_RANK, 4, out, json.dumps(FWD_CFG))
    cfg = jax_tiny(**FWD_CFG)
    np_params = numpy_llama(cfg, 11)
    params = jax.tree.map(jnp.asarray, np_params)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("pipe",))
    got = {"jax_pipe": np.asarray(jax_pipelined_forward(params, cfg, jnp.asarray(tokens), mesh,
                                                        axis_name="pipe", num_microbatches=2)),
           "jax_prefill": np.asarray(jax_prefill(params, cfg, jnp.asarray(tokens))[0])}
    tcfg = tiny_llama_config(**FWD_CFG)
    got["port_prefill"] = llama.prefill(params_from_numpy(np_params, device="cpu"), tcfg,
                                        torch.from_numpy(tokens).long())[0].numpy()
    return np.load(os.path.join(out, "logits.npy")), got, res


@pytest.mark.parametrize("ref", ["jax_pipe", "jax_prefill", "port_prefill"])
def test_pipelined_forward_matches(forward, ref):
    logits, refs, res = forward
    assert logits.shape == (4, 16, 256)
    assert np.abs(logits - refs[ref]).max() <= TOL
    assert res["layers"] == 1  # each stage holds its layer


@pytest.fixture(scope="module")
def decode(tmp_path_factory):
    """The JAX engine's cache, prefill token and next token; the JAX
    pipeline's and the port's two steps on it."""
    from xkv_tpu.configs import generate_consecutive_xkv_config as jax_xkv
    from xkv_tpu.engine import InferenceEngine as JaxEngine
    from xkv_tpu.models.config import tiny_llama_config as jax_tiny
    from xkv_tpu.models.llama import decode_step as jax_decode_step
    from xkv_tpu.parallel.pipeline import pipelined_decode_step as jax_pipelined
    from xkv_tpu_torch.cache import cache_from_numpy

    out = str(tmp_path_factory.mktemp("pp_dec"))
    cfg = jax_tiny(**DEC_CFG)
    params = jax.tree.map(jnp.asarray, numpy_llama(cfg, 0))
    xkv = jax_xkv(num_layers=4, end_layer=-1, group_size=2, rank_k=16, rank_v=16,
                  extra_kwargs={"rope_mode": "post"})
    prompt = np.random.default_rng(31).integers(0, 256, size=(B, PROMPT)).astype(np.int32)
    pipe = jax.sharding.Mesh(np.asarray(jax.devices()[:2]).reshape(2), ("pipe",))
    jax_res = {}
    for fd in FACTORS:
        eng = JaxEngine(params, cfg, xkv=xkv, mode="factored", tail_max=8,
                        cache_dtype=jnp.float32,
                        factor_dtype=jnp.float32 if fd == "fp32" else "int8",
                        attention_impl="xla", donate_cache=False)
        logits, cache = eng.prefill(prompt)
        tok = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
        pos = jnp.asarray(PROMPT, jnp.int32)
        cos_sin = eng._prefill_cos_sin(cache.prefill_len)
        r1, rc = jax_decode_step(params, cfg, xkv, cache, tok, pos, cos_sin, attention_impl="xla")
        tok2 = jnp.argmax(r1[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
        p1, pc = jax_pipelined(params, cfg, xkv, cache, tok, pos, pipe, num_microbatches=2)
        p2, pc2 = jax_pipelined(params, cfg, xkv, pc, tok2, pos + 1, pipe, num_microbatches=4)
        r2, _ = jax_decode_step(params, cfg, xkv, rc, tok2, pos + 1, cos_sin,
                                attention_impl="xla")
        jax_res[fd] = [(np.asarray(p1), np.asarray(pc.tail_k), int(pc.tail_len), np.asarray(r1)),
                       (np.asarray(p2), np.asarray(pc2.tail_k), int(pc2.tail_len),
                        np.asarray(r2))]
        torch.save({"cache": cache_from_numpy(jax.tree.map(np.asarray, cache), device="cpu"),
                    "tokens": [torch.tensor(np.asarray(t), dtype=torch.long) for t in (tok, tok2)],
                    "pos": PROMPT}, os.path.join(out, f"cache_{fd}.pt"))
    run_ranks(DEC_RANK, 2, out, json.dumps(DEC_CFG), json.dumps(FACTORS))
    return torch.load(os.path.join(out, "decode.pt"), weights_only=False), jax_res


@pytest.mark.parametrize("fd", FACTORS)
@pytest.mark.parametrize("step", [0, 1])
def test_pipelined_decode_step_matches(decode, fd, step):
    """Step 0 at M 2, step 1 (chained on the stages' caches) at M 4."""
    port, jax_res = decode
    got = port[fd][f"step{step}"]
    logits, tail_k, count, jax_step = jax_res[fd][step]
    assert port[fd]["rows"] == [1, 2]  # a stage's group and its layers' tail rows
    assert got["logits"].shape == (B, 1, 256)
    lim = TOL_JAX[fd]
    assert np.abs(got["logits"].numpy() - logits).max() <= lim["logits"]
    assert np.abs(got["tail_k"].numpy() - tail_k).max() <= lim["tail"]
    # What parts the pipelines is what parts the two packages' decode steps.
    assert np.abs((got["logits"].numpy() - logits) - (got["ref"].numpy() - jax_step)).max() <= TOL
    assert (got["logits"] - got["ref"]).abs().max() <= TOL
    assert (got["tail_k"] - got["ref_k"]).abs().max() <= TOL
    assert (got["tail_v"] - got["ref_v"]).abs().max() <= TOL
    assert got["count"] == got["ref_count"] == count == step + 1


def _xkv(rope="post", groups=((0, 1), (2, 3)), ranks=((16, 16), (16, 16))):
    return SimpleNamespace(rope_mode=rope, layer_groups=[
        SimpleNamespace(layers=list(g), rank_k=rk, rank_v=rv) for g, (rk, rv) in zip(groups,
                                                                                   ranks)])


def _cache(field=None):
    gf = SimpleNamespace(k_us=1, v_us=1, k_us4=None, v_us4=None, k_cmin=None, slerp_k=None,
                         slerp_v=None)
    if field is not None:
        setattr(gf, field, 1)
    return SimpleNamespace(groups=[gf, gf])


CFG4 = SimpleNamespace(num_layers=4, sliding_window=None)
# label: (xkv, cfg, stages, cache, the JAX message)
LAYOUTS = {
    "pre": (_xkv(rope="pre"), CFG4, 2, None, "requires rope_mode='post'"),
    "window": (_xkv(), SimpleNamespace(num_layers=4, sliding_window=8), 2, None,
               "sliding_window configs are unsupported"),
    "int4": (_xkv(), CFG4, 2, _cache("k_us4"), "has k_us4 set"),
    "quest": (_xkv(), CFG4, 2, _cache("k_cmin"), "has k_cmin set"),
    "slerp": (_xkv(), CFG4, 2, _cache("slerp_k"), "has slerp_k set"),
    "interleaved": (_xkv(groups=((0, 2), (1, 3))), CFG4, 2, None,
                    "consecutive equal-size groups"),
    "ranks": (_xkv(ranks=((16, 16), (8, 16))), CFG4, 2, None, "uniform group ranks"),
    "cover": (_xkv(groups=((0, 1),)), CFG4, 2, None, "groups must cover every layer"),
    "stages": (_xkv(), CFG4, 3, None, "4 layers / 3 stages"),
    "split group": (_xkv(groups=((0, 1, 2, 3),), ranks=((16, 16),)), CFG4, 2, None,
                    "must be a whole number of groups"),
}


@pytest.mark.parametrize("label", list(LAYOUTS))
def test_bad_layouts_are_refused_as_in_jax(label):
    from xkv_tpu.parallel.pipeline import _check_uniform_groups as jax_check
    from xkv_tpu_torch.parallel.pipeline import _check_uniform_groups

    xkv, cfg, stages, cache, msg = LAYOUTS[label]
    for check in (jax_check, _check_uniform_groups):
        with pytest.raises(ValueError, match=msg):
            check(xkv, cfg, stages, cache)


def test_step_and_batch_refusals():
    """A multi-token step, and batches the microbatches do not divide, in
    decode and in the forward (before any transfer)."""
    from xkv_tpu_torch.models.config import tiny_llama_config
    from xkv_tpu_torch.parallel.pipeline import (PipeMesh, pipelined_decode_step,
                                                 pipelined_forward)

    cfg = tiny_llama_config(num_layers=4)
    mesh = PipeMesh(stages=2, rank=0)
    with pytest.raises(ValueError, match="single-token"):
        pipelined_decode_step({}, cfg, _xkv(), _cache(), torch.zeros(4, 2, dtype=torch.long),
                              0, mesh)
    with pytest.raises(ValueError, match="batch 4 must divide microbatches 3"):
        pipelined_decode_step({}, cfg, _xkv(), _cache(), torch.zeros(4, 1, dtype=torch.long),
                              0, mesh, num_microbatches=3)
    with pytest.raises(ValueError, match="batch 3 must divide microbatches 2"):
        pipelined_forward({}, cfg, torch.zeros(3, 8, dtype=torch.long), mesh)
    with pytest.raises(ValueError, match="4 layers must divide 3 stages"):
        pipelined_forward({}, cfg, torch.zeros(4, 8, dtype=torch.long), PipeMesh(3, 0))


def test_stack_layer_params_matches_jax():
    from xkv_tpu.parallel.pipeline import stack_layer_params as jax_stack
    from xkv_tpu_torch.models.ckpt import params_from_numpy
    from xkv_tpu_torch.models.config import tiny_llama_config
    from xkv_tpu_torch.parallel.pipeline import stack_layer_params

    np_params = numpy_llama(tiny_llama_config(**FWD_CFG), 3)
    want = jax_stack(jax.tree.map(jnp.asarray, np_params))
    got = stack_layer_params(params_from_numpy(np_params, device="cpu"))
    flat_w, _ = jax.tree_util.tree_flatten_with_path(want)
    for path, w in flat_w:
        g = got
        for k in path:
            g = g[k.key]
        assert tuple(g.shape) == w.shape and np.array_equal(g.numpy(), np.asarray(w))
