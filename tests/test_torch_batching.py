"""The port's continuous batching (``xkv_tpu_torch/engine/batching.py``
``BatchedEngine``) against the JAX package's, on the CPU.

Greedy tokens equal the JAX ``BatchedEngine``'s (fp32, exact SVD, weights
carried across from numpy) for: mixed prompt lengths with more requests
than slots (uncompressed); factored pre with a slot reused after a longer
request and refolded twice, admitted monolithically and in chunks; int8;
int4 post; MLA + MoE admitted monolithically and in chunks; sparse top-k
under a Mistral window. The rest is held against the port's own
single-stream ``InferenceEngine`` (held against the JAX engine in
``tests/test_torch_engine.py``): a full-rank refold is lossless, the
capacity finish, EOS, sparse decode over every chunk. Three faults of
the reference are pinned: stale rank columns in a reused slot, the chunk
width of a slot refold, and requests that finish at admission lost by
``run()`` (ROADMAP queue 3). Refusals, batched speculation's included
(its engines are held in ``tests/test_torch_batching_spec.py``), are held
by message against the JAX engine's, before any device work (the port's engines are
made for "cuda", which this CPU-only machine cannot reach).

Models: ``tiny_llama_config`` (and its Mistral variant, window 10) with
JAX's init scaled by 5, the MLA + MoE config of
``tests/test_torch_deepseek.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xkv_tpu.configs import generate_consecutive_xkv_config as jax_xkv
from xkv_tpu.engine.batching import BatchedEngine as JaxBatched
from xkv_tpu.engine.compression import refactorize_slot_cache as jax_refold
from xkv_tpu.models import llama as jllama
from xkv_tpu.models.config import ModelConfig as JaxModelConfig
from xkv_tpu.models.config import tiny_llama_config as jax_tiny
from xkv_tpu_torch.cache import cache_from_numpy
from xkv_tpu_torch.configs import generate_consecutive_xkv_config as torch_xkv
from xkv_tpu_torch.engine import BatchedEngine, InferenceEngine
from xkv_tpu_torch.engine.compression import (
    _k_matrix,
    chunk_bounds,
    refactorize_slot_cache,
    slot_fields,
)
from xkv_tpu_torch.models import deepseek
from xkv_tpu_torch.models.ckpt import params_from_numpy
from xkv_tpu_torch.models.config import ModelConfig, tiny_llama_config
from xkv_tpu_torch.ops.rope import apply_rope, rope_cos_sin

MLA_CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=4,
               num_q_heads=4, num_kv_heads=4, head_dim=16, model_type="deepseek_v2",
               q_lora_rank=None, kv_lora_rank=32, qk_rope_head_dim=8, qk_nope_head_dim=16,
               v_head_dim=16, n_routed_experts=4, n_shared_experts=1, num_experts_per_tok=2,
               moe_intermediate_size=32, first_k_dense_replace=1, routed_scaling_factor=1.0,
               norm_topk_prob=True)
JAX_DT = {"fp32": jnp.float32, "int8": "int8", "int4": "int4"}
TORCH_DT = {"fp32": torch.float32, "int8": "int8", "int4": "int4"}
# (model, xKV options or None (uncompressed), factor dtype, engine options,
# prompt lengths, new tokens); every case: 2 slots.
ENGINE = dict(num_slots=2, s_max=32, tail_max=4, prefill_buckets=[8, 16, 24])
CASES = {
    "none, 3 requests through 2 slots": (
        "llama", None, "fp32", dict(ENGINE, s_max=24, tail_max=8), (12, 19, 7), 5),
    # Request 3 reuses request 1's slot after 20 rows of it were used.
    "pre, slot reuse, refolds, chunked": (
        "llama", dict(rank_k=8, rank_v=8), "fp32", ENGINE, (12, 19, 7), 10),
    "int8 pre": ("llama", dict(rank_k=16, rank_v=16), "int8",
                 dict(ENGINE, s_max=16, tail_max=8, prefill_buckets=[16]), (16, 16), 4),
    "int4 post": ("llama", dict(rank_k=16, rank_v=16, rope_mode="post", int4_rank_frac=0.5),
                  "int4", dict(ENGINE, s_max=16, tail_max=8, prefill_buckets=[16]), (16, 16), 4),
    "mla, chunked": ("mla", dict(rank_k=24, rank_v=None, merge_value=False), "fp32",
                     dict(ENGINE, s_max=16, tail_max=8, prefill_buckets=[16]), (15, 9), 4),
    "sparse pre, window": ("mistral", dict(rank_k=24, rank_v=24), "fp32",
                           dict(ENGINE, s_max=16, tail_max=8, prefill_buckets=[16],
                                sparse_topk=4, sparse_block=8), (16, 12), 4),
}


@pytest.fixture(scope="module")
def models():
    def scaled(cfg):
        return jax.tree.map(lambda a: np.array(a) * (1 if a.ndim == 1 else 5),
                            jllama.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32))

    win = dict(model_type="mistral", sliding_window=10)
    return {"llama": (jax_tiny(), tiny_llama_config(), scaled(jax_tiny())),
            "mistral": (jax_tiny(**win), tiny_llama_config(**win), scaled(jax_tiny(**win))),
            "mla": (JaxModelConfig(**MLA_CFG), ModelConfig(**MLA_CFG),
                    deepseek.numpy_params(ModelConfig(**MLA_CFG), 1))}


def xkv_kw(cfg, opts):
    opts = dict(opts)
    extra = {"svd_method": "exact"}
    for key in ("rope_mode", "int4_rank_frac"):
        if key in opts:
            extra[key] = opts.pop(key)
    return dict(group_size=2, num_layers=cfg.num_layers, end_layer=cfg.num_layers - 1,
                extra_kwargs=extra, **opts)


def run_jax(models, model, opts, factor, kw, prompts, n_new):
    jcfg, tcfg, np_params = models[model]
    je = JaxBatched(jax.tree.map(jnp.asarray, np_params), jcfg,
                    None if opts is None else jax_xkv(**xkv_kw(tcfg, opts)),
                    cache_dtype=jnp.float32, factor_dtype=JAX_DT[factor], **kw)
    return serve(je, prompts, n_new)


def port(models, model, opts, factor, kw):
    _, tcfg, np_params = models[model]
    return BatchedEngine(params_from_numpy(np_params, torch.float32, "cpu"), tcfg,
                         None if opts is None else torch_xkv(**xkv_kw(tcfg, opts)),
                         cache_dtype=torch.float32, factor_dtype=TORCH_DT[factor],
                         device="cpu", **kw)


def serve(engine, prompts, n_new):
    """Every request's greedy tokens, in submission order."""
    ids = [engine.submit(p, n_new) for p in prompts]
    by_id = {r.request_id: r.generated for r in engine.run()}
    assert sorted(by_id) == sorted(ids)
    return [by_id[i] for i in ids]


def prompts_of(lengths, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,)).astype(np.int32) for n in lengths]


@pytest.mark.parametrize("case", list(CASES))
def test_batched_tokens_match_jax(models, case):
    """Greedy tokens equal the JAX engine's; the chunked cases admit with
    ``prefill_chunk=8`` (4 for the MLA prompts) too, and equal them
    again."""
    model, opts, factor, kw, lengths, n_new = CASES[case]
    prompts = prompts_of(lengths, models[model][1].vocab_size)
    want = run_jax(models, model, opts, factor, kw, prompts, n_new)
    assert all(len(w) == n_new for w in want)
    assert serve(port(models, model, opts, factor, kw), prompts, n_new) == want
    if "chunked" in case:
        chunk = 4 if model == "mla" else 8
        got = serve(port(models, model, opts, factor, dict(kw, prefill_chunk=chunk)), prompts,
                    n_new)
        assert got == want


def test_full_rank_refolds_are_lossless(models):
    """Groups of 2 at full rank (64, the group's width) through folds at
    tail 4: the tokens of the uncompressed single-stream engine (JAX
    ``test_batched_refactorization_extends_generation``)."""
    _, tcfg, np_params = models["llama"]
    params = params_from_numpy(np_params, torch.float32, "cpu")
    prompts = prompts_of((12, 12), tcfg.vocab_size, seed=11)
    n_new = 10
    want = [InferenceEngine(params, tcfg, mode="none", tail_max=n_new, cache_dtype=torch.float32,
                            device="cpu").generate(p[None], n_new)[0].tolist() for p in prompts]
    be = port(models, "llama", dict(rank_k=64, rank_v=64), "fp32",
              dict(ENGINE, prefill_buckets=[16]))
    assert serve(be, prompts, n_new) == want


def test_capacity_finish(models):
    """A 16-token prompt fills s_max 16: no room to fold, so the request
    ends when its tail is full, after 1 + tail_max tokens, which are the
    single-stream engine's."""
    _, tcfg, np_params = models["llama"]
    opts = dict(rank_k=16, rank_v=16)
    prompt = prompts_of((16,), tcfg.vocab_size, seed=12)[0]
    be = port(models, "llama", opts, "fp32",
              dict(num_slots=1, s_max=16, tail_max=4, prefill_buckets=[16]))
    be.submit(prompt, 50)
    done = be.run()
    assert len(done) == 1 and done[0].done
    single = InferenceEngine(params_from_numpy(np_params, torch.float32, "cpu"), tcfg,
                             torch_xkv(**xkv_kw(tcfg, opts)), tail_max=4,
                             cache_dtype=torch.float32, factor_dtype=torch.float32,
                             device="cpu")
    assert done[0].generated == single.generate(prompt[None], 5)[0].tolist()


def test_eos_frees_the_slot(models):
    """With the EOS id set to a token that a run without it emits, each
    request stops at its first EOS, inclusive, and the slot takes the next
    request: one slot, three requests."""
    _, tcfg, _ = models["llama"]
    opts = dict(rank_k=8, rank_v=8)
    prompts = prompts_of((12, 19, 7), tcfg.vocab_size)
    full = serve(port(models, "llama", opts, "fp32", dict(ENGINE, num_slots=1)), prompts, 10)
    eos = full[0][3]
    got = serve(port(models, "llama", opts, "fp32", dict(ENGINE, num_slots=1,
                                                         eos_token_id=eos)), prompts, 10)
    for g, f in zip(got, full):
        assert g == (f[:f.index(eos) + 1] if eos in f else f)
    assert len(got[0]) < len(full[0])


def test_requests_finished_at_admission_are_returned(models):
    """``max_new_tokens=1``: each request finishes at admission with the
    first token of a longer run, and ``run()`` returns it, also from the
    chunked admission. Reference fault (ROADMAP queue 3): the JAX
    engine's ``run()`` returns none of them."""
    jcfg, tcfg, np_params = models["llama"]
    kw = dict(ENGINE, s_max=24, tail_max=8)
    prompts = prompts_of((12, 19, 7), tcfg.vocab_size, seed=13)
    full = serve(port(models, "llama", None, "fp32", kw), prompts, 3)
    for engine_kw in (kw, dict(kw, prefill_chunk=8)):
        assert serve(port(models, "llama", None, "fp32", engine_kw), prompts, 1) == [
            f[:1] for f in full]
    je = JaxBatched(jax.tree.map(jnp.asarray, np_params), jcfg, None, cache_dtype=jnp.float32,
                    **kw)
    for p in prompts:
        je.submit(p, 1)
    assert je.run() == [] and not je.queue and not je.slot_request


def test_sparse_over_every_chunk_equals_dense(models):
    """Top-4 of the four 8-row chunks of s_max 32 reads every row: the
    tokens of the same engine without sparse decode (JAX
    ``test_batched_sparse_full_coverage_matches_dense_selection``)."""
    _, tcfg, _ = models["llama"]
    opts = dict(rank_k=24, rank_v=24)
    prompts = prompts_of((16, 12), tcfg.vocab_size, seed=5)
    kw = dict(num_slots=2, s_max=32, tail_max=8, prefill_buckets=[16, 32])
    dense = serve(port(models, "llama", opts, "fp32", kw), prompts, 4)
    sparse = serve(port(models, "llama", opts, "fp32",
                        dict(kw, sparse_topk=4, sparse_block=8)), prompts, 4)
    assert sparse == dense


def test_reused_slot_clears_stale_rank_columns(models):
    """Reference fault: a prompt whose bucket (8) is below the rank (24)
    gets factors of rank 8 (the SVD of an 8-row matrix), and the JAX
    insert writes them into the slot's first 8 rank columns, leaving
    columns 8-23 as the slot's previous request left them. The port
    zeroes the slot first, so the reused slot gives the tokens of a fresh
    engine; the JAX engine's leave them."""
    _, tcfg, _ = models["llama"]
    opts = dict(rank_k=24, rank_v=24)
    kw = dict(ENGINE, num_slots=1)
    prompts = prompts_of((12, 7), tcfg.vocab_size)
    fresh = run_jax(models, "llama", opts, "fp32", kw, prompts[1:], 10)[0]
    reused_jax = run_jax(models, "llama", opts, "fp32", kw, prompts, 10)[1]
    reused = serve(port(models, "llama", opts, "fp32", kw), prompts, 10)[1]
    assert reused == fresh
    assert reused_jax != fresh


def test_slot_refold_keeps_the_chunk_width(models):
    """Reference fault: s_max 24 over 16-row chunks (2 chunks). The JAX
    slot refold takes the width as ceil(24 / 2) = 12 and stores bounds of
    12-row chunks, which decode gathers as 16-row ones; the port's equal
    ``chunk_bounds`` at 16 rows. Same slot cache on both sides (the JAX
    engine's after three steps, carried across), its tail folded at plen
    16 (three rows and a zero one: a fourth step would fold inside the
    engine)."""
    jcfg, tcfg, np_params = models["llama"]
    opts = dict(rank_k=24, rank_v=24)
    jxkv, txkv = jax_xkv(**xkv_kw(tcfg, opts)), torch_xkv(**xkv_kw(tcfg, opts))
    je = JaxBatched(jax.tree.map(jnp.asarray, np_params), jcfg, jxkv, num_slots=1, s_max=24,
                    tail_max=4, prefill_buckets=[16], cache_dtype=jnp.float32,
                    factor_dtype=jnp.float32, sparse_topk=1, sparse_block=16)
    je.submit(prompts_of((16,), tcfg.vocab_size)[0], 50)
    for _ in range(3):
        je.step()
    assert je.tail_len.tolist() == [3]
    cache = jax.tree.map(np.asarray, je.batch_cache)
    tcache = cache_from_numpy(cache, "cpu")
    # The keys the refold bounds: the slot's pre-RoPE keys with the tail's
    # un-rotated rows at [16, 20), rotated at their positions.
    cos, sin = rope_cos_sin(torch.arange(24), tcfg.head_dim, tcfg.rope_theta)
    grp, gf = txkv.layer_groups[0], tcache.groups[0]
    k_ext = _k_matrix(slot_fields(gf, 0))
    tail = [tcache.tail_k[l][:1] for l in grp.layers]
    un = [apply_rope(t, cos[None, 16:20], -sin[None, 16:20]) for t in tail]
    k_ext[:, 16:20] = torch.cat(un, dim=1).permute(0, 2, 1, 3).reshape(1, 4, -1)
    want = chunk_bounds(k_ext, cos, sin, 16, len(grp.layers) * tcfg.num_kv_heads)
    wrong = chunk_bounds(k_ext, cos, sin, 12, len(grp.layers) * tcfg.num_kv_heads)

    refactorize_slot_cache(tcache, txkv, tcfg, 0, 16, sparse_block=16)
    jout = jax_refold(je.batch_cache, jxkv, jcfg, jnp.asarray(0, jnp.int32),
                      jnp.asarray(16, jnp.int32))
    got = tcache.groups[0]
    np.testing.assert_allclose(got.k_cmin.numpy(), want[0].numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.k_cmax.numpy(), want[1].numpy(), rtol=1e-4, atol=1e-4)
    jmin = np.asarray(jout.groups[0].k_cmin)
    np.testing.assert_allclose(jmin, wrong[0].numpy(), rtol=1e-4, atol=1e-4)
    assert np.abs(jmin - want[0].numpy()).max() > 0.1


def refusal_cases(models):
    """(engine arguments, message), each refused by the JAX engine too."""
    _, tcfg, _ = models["llama"]
    pre = dict(rank_k=16, rank_v=16)
    post4 = dict(pre, rope_mode="post", int4_rank_frac=0.5)
    return [
        (("llama", pre, "int4", dict(s_max=16)), "rope_mode"),
        (("llama", dict(post4, rank_v=None, merge_value=False), "int4", dict(s_max=16)),
         "merge_key=True and merge_value=True"),
        (("llama", post4, "int4", dict(s_max=32, prefill_buckets=[8, 32])),
         "every prefill bucket"),
        (("llama", pre, "fp32", dict(s_max=16, prefill_buckets=[12], prefill_chunk=5)),
         "not multiples"),
        (("mla", dict(rank_k=24, rank_v=None, merge_value=False), "fp32",
          dict(s_max=16, sparse_topk=2)), "llama-family only"),
        (("mla", dict(rank_k=24, rank_v=24), "fp32", dict(s_max=16)), "merge_value=False"),
        # Batched speculation.
        (("llama", pre, "fp32", dict(s_max=16, tail_max=8, speculative_k=3)),
         "requires sparse_topk"),
        (("mistral", pre, "fp32", dict(s_max=16, tail_max=8, speculative_k=3, sparse_topk=2,
                                       sparse_block=8)), "sliding_window"),
        (("llama", pre, "fp32", dict(s_max=16, tail_max=3, speculative_k=3, sparse_topk=2,
                                     sparse_block=8)), "needs tail_max > speculative_k"),
        (("llama", post4, "int4", dict(s_max=16, speculative_k=3, sparse_topk=2,
                                       sparse_block=8)), "does not compose with batched"),
        (("llama", pre, "fp32", dict(s_max=16, speculative_k=3, draft_rank=8)), "MLA-only"),
    ]


def test_refusals_match_jax(models, monkeypatch):
    """JAX's validation, with its messages, batched speculation's
    included; every refusal comes before the slot cache is made (zeros on
    "cuda" would raise another error here). Compact MiniCache slots under
    MLA (the JAX MLA decode cannot read them: ROADMAP queue 3) and a mesh
    (item 17, no such argument) are refused too."""
    for (model, opts, factor, kw), msg in refusal_cases(models):
        jcfg, tcfg, np_params = models[model]
        with pytest.raises(ValueError, match=msg):
            JaxBatched(jax.tree.map(jnp.asarray, np_params), jcfg,
                       jax_xkv(**xkv_kw(tcfg, opts)), factor_dtype=JAX_DT[factor], **kw)
        with pytest.raises(ValueError, match=msg):
            BatchedEngine({}, tcfg, torch_xkv(**xkv_kw(tcfg, opts)),
                          factor_dtype=TORCH_DT[factor], **kw)
    _, tcfg, _ = models["llama"]
    xkv = torch_xkv(**xkv_kw(tcfg, dict(rank_k=16, rank_v=16)))
    _, mcfg, _ = models["mla"]
    slerp = torch_xkv(layer_merge_impl="slerp", group_size=2, num_layers=4, end_layer=3,
                      rank_k=None, rank_v=None, merge_value=False,
                      extra_kwargs={"slerp_compact": True})
    with pytest.raises(ValueError, match="slerp_compact"):
        BatchedEngine({}, mcfg, slerp)
    with pytest.raises(TypeError, match="mesh"):
        BatchedEngine({}, tcfg, xkv, mesh=object())
