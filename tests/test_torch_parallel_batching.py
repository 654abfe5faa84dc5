"""Continuous batching under a mesh (``BatchedEngine(mesh=...)``: slots
over the data axis, heads and weights over the model axis) on the CPU,
four gloo processes on 127.0.0.1 (``tests/_torch_ranks.py``) at
``make_mesh(data=2, model=2)``, against the single-device port
``BatchedEngine`` in rank 0 (which ``tests/test_torch_batching*.py`` hold
to the JAX ``BatchedEngine``).

The JAX tests' settings (``tests/test_sharding_parallel.py``): the 4-layer
model of 8 q / 4 kv heads of 16, numpy-seeded fp32 weights (normal 0.25:
random weights at the JAX init's 0.02 emit one token over and over), xKV
groups of 2 at rank 16 / 16 with the exact SVD, fp32 cache, 4 slots of 16
rows, 8-row tails, one 16-row bucket, prompts of 16, 11, 14, 9 and 16
tokens, 4 new each, in fp32 and int8 factors; chunked admission (8-row
chunks); slots of 32 rows with 4-row tails and 12 new tokens, so slots
refold on their data row (fp32 factors: with int8 ones the model axis's
split products move the SVD's input by ~1e-7, which put one int8 factor
element of an admitted slot one unit off one device's, and after a refold
the tokens parted at the 6th of 12; ``tests/test_torch_parallel.py`` holds
int8 refolds under a model axis by their logits); batched speculation with sparse drafts
(``sparse_topk=2``, ``sparse_block=8``, ``speculative_k=3``: prompts of 16,
12, 15 and 10 tokens, 6 new, 10-row tails); post int4 factors; and the
MLA + MoE model of ``tests/test_torch_parallel_mla.py`` (experts split over
the model axis) speculating with ``draft_rank`` 8. Every request's tokens
equal the single-device engine's, on every rank; each rank's slot cache
holds its 2 slots and its kv heads. ``num_slots`` that the data axis does
not divide and the slerp scheme are refused.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_ranks import run_ranks  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

CFG = dict(num_layers=4, num_q_heads=8, num_kv_heads=4, head_dim=16, hidden_size=128,
           intermediate_size=256)
MOE_CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=4,
               num_q_heads=4, num_kv_heads=4, head_dim=16, model_type="deepseek_v2",
               q_lora_rank=None, kv_lora_rank=32, qk_rope_head_dim=8, qk_nope_head_dim=16,
               v_head_dim=16, n_routed_experts=4, n_shared_experts=1, num_experts_per_tok=2,
               moe_intermediate_size=32, first_k_dense_replace=1, routed_scaling_factor=1.0,
               norm_topk_prob=True)
BASE = dict(num_slots=4, s_max=16, tail_max=8, prefill_buckets=[16])
PROMPTS = ((11, [16, 11, 14, 9, 16]), (13, [16, 12, 15, 10]))
# label: (model, rope, factor dtype, engine options, prompts (seed, lengths), new tokens)
RUNS = {
    "pre fp32": ("llama", "pre", "fp32", {}, 0, 4),
    "pre int8": ("llama", "pre", "int8", {}, 0, 4),
    "chunked": ("llama", "pre", "fp32", dict(prefill_chunk=8), 0, 4),
    "refolds": ("llama", "pre", "fp32", dict(s_max=32, tail_max=4, prefill_buckets=[16, 32]),
                0, 12),
    "sparse speculation": ("llama", "pre", "fp32", dict(sparse_topk=2, sparse_block=8,
                                                       speculative_k=3, tail_max=10), 1, 6),
    "post int4": ("llama", "post", "int4", {}, 0, 4),
    "mla draft_rank": ("mla", None, "fp32", dict(draft_rank=8, speculative_k=3, tail_max=10),
                       0, 6),
}

RANK = """
import dataclasses
import numpy as np
from xkv_tpu_torch.configs import generate_consecutive_xkv_config
from xkv_tpu_torch.engine import BatchedEngine
from xkv_tpu_torch.models import deepseek
from xkv_tpu_torch.models.ckpt import params_from_numpy
from xkv_tpu_torch.models.config import ModelConfig, tiny_llama_config
from xkv_tpu_torch.parallel.distributed import allgather_obj
from xkv_tpu_torch.parallel.mesh import make_mesh

runs, base, cfg_kw, moe_kw, prompt_sets = (json.loads(a) for a in argv)
mesh = make_mesh(data=2, model=2)
models = {"llama": tiny_llama_config(**cfg_kw), "mla": ModelConfig(**moe_kw)}
weights = {"llama": params_from_numpy(numpy_llama(models["llama"], 0, scale=0.25), device="cpu"),
           "mla": params_from_numpy(deepseek.numpy_params(models["mla"], 1), device="cpu")}
res = {}
for label, (model, rope, fd, opts, pset, n_new) in runs.items():
    cfg, params = models[model], weights[model]
    if model == "mla":
        xkv = generate_consecutive_xkv_config(num_layers=4, end_layer=3, group_size=2,
                                              rank_k=16, rank_v=None, merge_value=False,
                                              extra_kwargs={"svd_method": "exact"})
    else:
        xkv = generate_consecutive_xkv_config(num_layers=4, end_layer=-1, group_size=2,
                                              rank_k=16, rank_v=16, extra_kwargs={
                                                  "svd_method": "exact", "rope_mode": rope})
    seed, lengths = prompt_sets[pset]
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32) for n in lengths]
    kw = dict(base, xkv=xkv, cache_dtype=torch.float32, device="cpu",
              factor_dtype={"fp32": torch.float32, "int8": "int8", "int4": "int4"}[fd], **opts)

    def serve(m):
        be = BatchedEngine(params, cfg, mesh=m, **kw)
        ids = [be.submit(p, n_new) for p in prompts]
        done = {r.request_id: r.generated for r in be.run()}
        return be, [done[i] for i in ids]

    be, tokens = serve(mesh)
    row = {"tokens": allgather_obj(tokens),
           "slots": allgather_obj([be.batch_cache.tail_k.shape[1],
                                   be.batch_cache.tail_k.shape[2], be.local_slots, be._lo]),
           "rounds": be.spec_stats["rounds"]}
    if rank == 0:
        row["tokens_one"] = serve(None)[1]
        if opts.get("speculative_k"):
            plain = {k: v for k, v in opts.items()
                     if k not in ("speculative_k", "draft_rank", "sparse_topk")}
            kw = dict(kw, **plain)
            for k in ("speculative_k", "draft_rank", "sparse_topk"):
                kw.pop(k, None)
            row["tokens_plain"] = serve(None)[1]
    res[label] = row
finish(res)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("batched_mesh"))
    return run_ranks(RANK, 4, out, json.dumps(RUNS), json.dumps(BASE), json.dumps(CFG),
                     json.dumps(MOE_CFG), json.dumps(PROMPTS))


@pytest.mark.parametrize("label", list(RUNS))
def test_batched_mesh_matches_single_device(ranks, label):
    row = ranks[label]
    model, _, _, opts, pset, n_new = RUNS[label]
    assert all(t == row["tokens_one"] for t in row["tokens"])
    assert len(row["tokens_one"]) == len(PROMPTS[pset][1])
    # Not one token repeated over and over: the run tells engines apart.
    assert len({t for toks in row["tokens_one"] for t in toks}) > 4
    if "tokens_plain" in row:  # speculation emits exact greedy decoding's tokens
        assert row["tokens_one"] == row["tokens_plain"]
        assert row["rounds"] > 0
    kv = 1 if model == "mla" else CFG["num_kv_heads"] // 2
    assert row["slots"] == [[2, kv, 2, 2 * (r // 2)] for r in range(4)]


def test_slots_that_do_not_split_and_slerp_are_refused():
    """num_slots=3 over a data axis of 2, with the JAX engine's message;
    the slerp scheme under a mesh names ROADMAP item 17."""
    import jax.numpy as jnp
    import torch
    from xkv_tpu.engine.batching import BatchedEngine as JaxBatched
    from xkv_tpu.models.config import tiny_llama_config as jax_tiny
    from xkv_tpu.models.llama import init_params as jax_init
    from xkv_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from xkv_tpu_torch.configs import generate_consecutive_xkv_config
    from xkv_tpu_torch.engine import BatchedEngine
    from xkv_tpu_torch.models.config import tiny_llama_config
    from xkv_tpu_torch.parallel.mesh import Mesh

    jcfg = jax_tiny(**CFG)
    with pytest.raises(ValueError, match="must be a multiple of the mesh data axis"):
        JaxBatched(jax_init(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32), jcfg, xkv=None,
                   num_slots=3, s_max=16, tail_max=8,
                   mesh=jax_make_mesh(data=2, model=1, devices=jax.devices()[:2]))
    cfg = tiny_llama_config(**CFG)
    mesh = Mesh(data=2, model=1, rank=0)
    with pytest.raises(ValueError, match=r"num_slots=3 must be a multiple of the mesh data "
                                         r"axis \(2\)"):
        BatchedEngine({}, cfg, None, num_slots=3, s_max=16, tail_max=8, device="cpu",
                      mesh=mesh)
    slerp = generate_consecutive_xkv_config(layer_merge_impl="slerp", num_layers=4,
                                            end_layer=-1, group_size=2, rank_k=None,
                                            rank_v=None)
    with pytest.raises(ValueError, match="ROADMAP item 17"):
        BatchedEngine({}, cfg, slerp, num_slots=4, s_max=16, tail_max=8, device="cpu",
                      mesh=mesh)
    del torch
