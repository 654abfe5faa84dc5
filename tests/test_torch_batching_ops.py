"""The batched model functions of continuous batching against the JAX
package's, on the CPU: ``prefill_chunk`` (Llama and MLA),
``decode_step_batched`` and ``refactorize_slot_cache``.

The slot state comes from the JAX ``BatchedEngine`` itself, so both sides
read the same slot cache (``cache.cache_from_numpy`` carries it across):
three slots, s_max 32, tail 4; request A (19 tokens) admitted and stepped
twice, then request B (9 tokens) admitted with one more step, the third
slot never used. That leaves ragged prefill lengths (19, 9, 0) and tail
fills (3, 1, 0) and an empty slot. Then, on both sides, from the same
cache: one ``decode_step_batched`` (logits of every slot, the tails it
wrote), which fills A's tail; ``refactorize_slot_cache`` of A's slot (the
factors' products, ``k_rnorm``, chunk bounds, the zeroed tail); one more
step over the refolded slot; one multi-token step (tokens (B, 2)) over it
(the Mistral window refuses it on both sides).

Weights: ``tiny_llama_config`` (and its Mistral variant, window 10) with
JAX's init scaled by 5, and the MLA + MoE config of
``tests/test_torch_deepseek.py``, from numpy seeds. Exact SVD.

Tolerances: fp32 logits 1e-3 (the single-stream engine tests' own), int8
and int4 factors 3e-2 (an int8 entry at a rounding boundary can quantise
to the neighbouring level in one framework), bf16 caches 5e-2 (bf16
keeps 8 bits, the factors are products of bf16 operands); the refolded
factors' products (SVD signs may differ, the products do not) to 1e-4 x
the matrix's largest entry in fp32, 2e-2 in bf16 and int8, 0.1 in int4
(``PRODUCT_TOL``), and the step after it in int4 to 7e-2 (the reading
past a refactorisation in ``tests/test_torch_speculative.py``); chunk
prefill logits and scratch 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xkv_tpu.configs import generate_consecutive_xkv_config as jax_xkv
from xkv_tpu.engine.batching import BatchedEngine as JaxBatched
from xkv_tpu.engine.compression import refactorize_slot_cache as jax_refold
from xkv_tpu.models import deepseek as jds
from xkv_tpu.models import llama as jllama
from xkv_tpu.models.config import ModelConfig as JaxModelConfig
from xkv_tpu.models.config import tiny_llama_config as jax_tiny
from xkv_tpu.ops.rope import rope_cos_sin as jax_rope_cos_sin
from xkv_tpu_torch.cache import cache_from_numpy
from xkv_tpu_torch.configs import generate_consecutive_xkv_config as torch_xkv
from xkv_tpu_torch.engine.compression import (
    _k_matrix,
    _v_matrix,
    refactorize_slot_cache,
    slot_fields,
)
from xkv_tpu_torch.models import deepseek, llama
from xkv_tpu_torch.models.ckpt import params_from_numpy
from xkv_tpu_torch.models.config import ModelConfig, tiny_llama_config
from xkv_tpu_torch.ops.rope import rope_cos_sin

MLA_CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=4,
               num_q_heads=4, num_kv_heads=4, head_dim=16, model_type="deepseek_v2",
               q_lora_rank=None, kv_lora_rank=32, qk_rope_head_dim=8, qk_nope_head_dim=16,
               v_head_dim=16, n_routed_experts=4, n_shared_experts=1, num_experts_per_tok=2,
               moe_intermediate_size=32, first_k_dense_replace=1, routed_scaling_factor=1.0,
               norm_topk_prob=True)
S_MAX, TAIL, BUCKETS, BLOCK = 32, 4, [16, 24, 32], 8
JAX_DT = {"fp32": jnp.float32, "bf16": jnp.bfloat16, "int8": "int8", "int4": "int4"}
# (model, rope mode, factor dtype, engine options)
SPARSE = dict(sparse_topk=2, sparse_block=BLOCK)
VARIANTS = {
    "pre": ("llama", "pre", "fp32", {}),
    "pre bf16": ("llama", "pre", "bf16", {}),
    "post": ("llama", "post", "fp32", {}),
    "int8 pre": ("llama", "pre", "int8", {}),
    "int4 post": ("llama", "post", "int4", {}),
    "sparse pre": ("llama", "pre", "fp32", SPARSE),
    "sparse post": ("llama", "post", "fp32", SPARSE),
    "mistral window": ("mistral", "pre", "fp32", {}),
    # MLA: tests/test_torch_batching_mla.py, the same checks.
    "mla": ("mla", None, "fp32", {}),
    "mla bf16": ("mla", None, "bf16", {}),
    "mla int8": ("mla", None, "int8", {}),
}
LLAMA_VARIANTS = [name for name, v in VARIANTS.items() if v[0] != "mla"]
TOL = {"fp32": 1e-3, "bf16": 5e-2, "int8": 3e-2, "int4": 3e-2}
# Refolded group matrices, against the matrix's largest entry: fp32 SVD
# rounding; bf16 factors (2^-8 per operand); an int8 level (1/127 of a
# column's range) or an int4 one (1/7) flipped by the two SVDs' rounding.
PRODUCT_TOL = {"fp32": 1e-4, "bf16": 2e-2, "int8": 2e-2, "int4": 0.1}
# The step over a refolded slot: int4 factors put the two frameworks'
# logits up to ~7e-2 apart past a refactorisation (``test_torch_speculative``).
TOL_REFOLDED = dict(TOL, int4=7e-2)


def build_models():
    def scaled(cfg):
        return jax.tree.map(lambda a: np.array(a) * (1 if a.ndim == 1 else 5),
                            jllama.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32))

    win = dict(model_type="mistral", sliding_window=10)
    return {"llama": (jax_tiny(), tiny_llama_config(), scaled(jax_tiny())),
            "mistral": (jax_tiny(**win), tiny_llama_config(**win), scaled(jax_tiny(**win))),
            "mla": (JaxModelConfig(**MLA_CFG), ModelConfig(**MLA_CFG),
                    deepseek.numpy_params(ModelConfig(**MLA_CFG), 1))}


def xkv_kw(cfg, model, rope):
    if model == "mla":
        return dict(group_size=2, rank_k=16, rank_v=None, num_layers=cfg.num_layers,
                    end_layer=cfg.num_layers - 1, merge_value=False,
                    extra_kwargs={"svd_method": "exact"})
    return dict(group_size=2, rank_k=16, rank_v=16, num_layers=cfg.num_layers,
                end_layer=cfg.num_layers - 1,
                extra_kwargs={"svd_method": "exact", "rope_mode": rope,
                              "int4_rank_frac": 0.5})


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    return build_models()


def slot_state(models, name):
    """The JAX engine's slot cache and host state after the admissions
    of the module docstring, and the pieces both sides need."""
    model, rope, factor, kw = VARIANTS[name]
    jcfg, tcfg, np_params = models[model]
    cache_dt = jnp.bfloat16 if factor == "bf16" else jnp.float32
    jxkv = jax_xkv(**xkv_kw(tcfg, model, rope))
    je = JaxBatched(jax.tree.map(jnp.asarray, np_params), jcfg, jxkv, num_slots=3,
                    s_max=S_MAX, tail_max=TAIL, prefill_buckets=BUCKETS, cache_dtype=cache_dt,
                    factor_dtype=JAX_DT[factor], **kw)
    rng = np.random.default_rng(3)
    je.submit(rng.integers(0, tcfg.vocab_size, 19).astype(np.int32), 50)
    je.step()
    je.step()
    je.submit(rng.integers(0, tcfg.vocab_size, 9).astype(np.int32), 50)
    je.step()
    assert je.prefill_len.tolist() == [19, 9, 0] and je.tail_len.tolist() == [3, 1, 0]
    return dict(name=name, model=model, factor=factor, kw=kw, je=je, jcfg=jcfg,
                tcfg=tcfg, jxkv=jxkv, txkv=torch_xkv(**xkv_kw(tcfg, model, rope)),
                params=params_from_numpy(np_params, torch.float32, "cpu"))


def jax_step(st, cache, state):
    """The JAX ``decode_step_batched`` on the engine's weights, jitted once
    a variant (op by op it takes seconds a call on the CPU)."""
    if "jax_step" not in st:
        je = st["je"]
        mod = jds if st["model"] == "mla" else jllama
        sparse = {} if not st["kw"] else dict(sparse_select=st["kw"]["sparse_topk"],
                                              sparse_block=BLOCK)
        st["jax_step"] = jax.jit(lambda c, *x: mod.decode_step_batched(
            je.params, st["jcfg"], st["jxkv"], c, *x, je._cos_sin, **sparse))
    return st["jax_step"](cache, *(jnp.asarray(x) for x in state))


def torch_step(st, cache, state):
    mod = deepseek if st["model"] == "mla" else llama
    cos_sin = rope_cos_sin(torch.arange(S_MAX), st["tcfg"].head_dim, st["tcfg"].rope_theta,
                           st["tcfg"].rope_scaling)
    sparse = {} if not st["kw"] else dict(sparse_select=st["kw"]["sparse_topk"],
                                          sparse_block=BLOCK)
    return mod.decode_step_batched(st["params"], st["tcfg"], st["txkv"], cache,
                                   *(torch.as_tensor(x) for x in state), cos_sin, **sparse)


def assert_products_close(got, want, factor):
    """Group matrices rebuilt from each side's factors: SVD signs may
    differ, the products not."""
    np.testing.assert_allclose(got, want, atol=PRODUCT_TOL[factor] * float(np.abs(want).max()))


@pytest.mark.parametrize("name", LLAMA_VARIANTS)
def test_decode_step_batched_and_slot_refold_match_jax(models, name):
    check_step_and_refold(slot_state(models, name))


def check_step_and_refold(st):
    je, factor = st["je"], st["factor"]
    tol = TOL[factor]
    state = [je.token, je.pos, je.prefill_len, je.tail_len]
    jcache = je.batch_cache
    tcache = cache_from_numpy(to_np(jcache), "cpu")

    want, jcache = jax_step(st, jcache, state)
    got, tcache = torch_step(st, tcache, state)
    # Every slot, the empty one included (no live prefill key, finite).
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)
    for name in ("tail_k", "tail_v"):
        np.testing.assert_allclose(getattr(tcache, name).float().numpy(),
                                   np.asarray(getattr(jcache, name), np.float32),
                                   rtol=tol, atol=tol)

    # Slot 0's tail is full now: fold it into its factors at rows [19, 23).
    jcache = jax_refold(jcache, st["jxkv"], st["jcfg"], jnp.asarray(0, jnp.int32),
                        jnp.asarray(19, jnp.int32))
    tcache = refactorize_slot_cache(tcache, st["txkv"], st["tcfg"], 0, 19,
                                    sparse_block=BLOCK if st["kw"] else None)
    jref = cache_from_numpy(to_np(jcache), "cpu")
    for gt, gj in zip(tcache.groups, jref.groups):
        for mat in (_k_matrix, _v_matrix):
            if (gt.k_us if mat is _k_matrix else gt.v_us) is None:
                continue
            for slot in range(3):
                assert_products_close(mat(slot_fields(gt, slot)).numpy(),
                                      mat(slot_fields(gj, slot)).numpy(), factor)
        if gt.k_rnorm is not None:
            np.testing.assert_allclose(gt.k_rnorm.numpy(), gj.k_rnorm.numpy(),
                                       rtol=tol, atol=tol)
        if gt.k_cmin is not None:
            for name in ("k_cmin", "k_cmax"):
                np.testing.assert_allclose(getattr(gt, name).float().numpy(),
                                           getattr(gj, name).float().numpy(),
                                           rtol=tol, atol=tol)
    for d in ("dense_k", "dense_v"):
        for l, x in getattr(tcache, d).items():
            np.testing.assert_allclose(x.float().numpy(), getattr(jref, d)[l].float().numpy(),
                                       rtol=tol, atol=tol)
    assert not tcache.tail_k[:, 0].any() and not tcache.tail_v[:, 0].any()

    # One more step over the refolded slot (prefill 23, empty tail).
    state = [np.asarray(want).argmax(-1).astype(np.int32), je.pos + 1,
             np.array([23, 9, 0], np.int32), np.array([0, 2, 1], np.int32)]
    want, _ = jax_step(st, jcache, state)
    got, tcache = torch_step(st, tcache, state)
    tol = TOL_REFOLDED[factor]
    np.testing.assert_allclose(got[:2].numpy(), np.asarray(want, np.float32)[:2],
                               rtol=tol, atol=tol)

    # The multi-token pass (tokens (B, 2), the batched verify's step) over
    # the same refolded cache: two rows a slot at its tail_len, causal
    # among themselves (exact, also where the engine is sparse). Its first
    # column is the step's token, so its tail rows overwrite the ones that
    # step wrote on the port's side.
    tokens2 = np.stack([state[0], (state[0] + 1) % st["tcfg"].vocab_size], 1)
    state2 = [tokens2] + state[1:]
    if st["model"] == "mistral":
        for step, cache in ((jax_step, jcache), (torch_step, tcache)):
            with pytest.raises(ValueError, match="sliding_window"):
                step(st, cache, state2)
        return
    want2, jcache2 = jax_step(st, jcache, state2)
    got2, tcache = torch_step(st, tcache, state2)
    assert got2.shape == (3, 2, st["tcfg"].vocab_size)
    np.testing.assert_allclose(got2[:2].numpy(), np.asarray(want2, np.float32)[:2],
                               rtol=tol, atol=tol)
    for name in ("tail_k", "tail_v"):
        np.testing.assert_allclose(getattr(tcache, name).float().numpy(),
                                   np.asarray(getattr(jcache2, name), np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("model", ["llama", "mistral"])
def test_prefill_chunk_matches_jax(models, model):
    check_prefill_chunk(models, model)


def check_prefill_chunk(models, model):
    """Three chunks of 8 over a 24-row scratch (a 21-token prompt): each
    chunk's logits at its last valid row and the scratch against the JAX
    ``prefill_chunk``, and the last chunk's logits against the monolithic
    prefill's last position."""
    jcfg, tcfg, np_params = models[model]
    jmod, tmod = (jds, deepseek) if model == "mla" else (jllama, llama)
    jparams = jax.tree.map(jnp.asarray, np_params)
    tparams = params_from_numpy(np_params, torch.float32, "cpu")
    S, C, n = 24, 8, 21
    L = tcfg.num_layers
    if model == "mla":
        k_shape = (L, 1, 1, S, tcfg.kv_lora_rank)
        v_shape = (L, 1, 1, S, tcfg.qk_rope_head_dim)
        rope_dim = tcfg.qk_rope_head_dim
    else:
        k_shape = v_shape = (L, 1, tcfg.num_kv_heads, S, tcfg.head_dim)
        rope_dim = tcfg.head_dim
    jk, jv = jnp.zeros(k_shape), jnp.zeros(v_shape)
    tk, tv = torch.zeros(k_shape), torch.zeros(v_shape)
    jcs = jax_rope_cos_sin(jnp.arange(S), rope_dim, jcfg.rope_theta, jcfg.rope_scaling)
    tcs = rope_cos_sin(torch.arange(S), rope_dim, tcfg.rope_theta, tcfg.rope_scaling)
    toks = np.random.default_rng(4).integers(0, tcfg.vocab_size, n).astype(np.int32)
    jchunk = jax.jit(lambda *a: jmod.prefill_chunk(jparams, jcfg, *a))
    for ci in range(3):
        pos0 = ci * C
        valid = min(C, n - pos0)
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :valid] = toks[pos0:pos0 + valid]
        last = valid - 1
        want, jk, jv = jchunk(jnp.asarray(chunk), jk, jv, jnp.asarray(pos0), *jcs,
                              jnp.asarray(last))
        # Ints on the CPU; the last chunk as 0-d tensors (every row read).
        p0, li = (pos0, last) if ci < 2 else (torch.tensor(pos0), torch.tensor(last))
        got, tk, tv = tmod.prefill_chunk(tparams, tcfg, torch.as_tensor(chunk).long(), tk, tv,
                                         p0, *tcs, li)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-4)
    mono, _ = tmod.prefill(tparams, tcfg, torch.as_tensor(toks[None]).long(),
                           logits_position=n - 1)
    np.testing.assert_allclose(got.numpy(), mono.numpy(), rtol=1e-4, atol=1e-4)
