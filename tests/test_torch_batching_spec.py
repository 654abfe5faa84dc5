"""The port's batched speculation (``BatchedEngine(speculative_k=...)``,
``engine/graphs.py`` ``BatchedSpecRound``) against the JAX package's, on
the CPU.

Every emitted token comes from an exact verify pass or an exact top-up
step, so a request's tokens equal those of the plain exact
``BatchedEngine`` (no drafts, no sparse options) whatever the drafts. The
port must also give the JAX engine's tokens and ``spec_stats`` (rounds,
round_tokens, plain_steps) exactly (fp32, exact SVD, weights carried
across from numpy) for Llama sparse drafts in ``pre`` and ``post``, the
refactorising case of ``tests/test_batching.py``
(``test_batched_speculative_with_refactorization``) and MLA ``draft_rank``
drafts (``test_batched_mla_speculative_matches_plain``). One fault of the
reference is held apart: when a slot lacks the tail rows of a round, the
JAX engine's top-up is its ``_step_jit``, which runs the engine's sparse
options, so its tokens past a top-up leave exact greedy decoding's
(ROADMAP queue 3). The port tops up with exact steps; the Llama cases
hold it against the JAX engine with its ``_step_jit`` rebuilt without the
sparse options (``jax_engine(exact_top_ups=True)``), and
``test_batched_speculative_topups_are_exact`` pins the fault.

Models: ``tiny_llama_config`` with JAX's init scaled by 5 (as
``tests/test_torch_batching.py``: varied greedy tokens, drafts accepted
and rejected) and the MLA + MoE config of that file. The JAX runs are
shared across the tests (``jax_runs``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_batching import MLA_CFG, prompts_of, serve, xkv_kw
from xkv_tpu.configs import generate_consecutive_xkv_config as jax_xkv
from xkv_tpu.engine.batching import BatchedEngine as JaxBatched
from xkv_tpu.models import llama as jllama
from xkv_tpu.models.config import ModelConfig as JaxModelConfig
from xkv_tpu.models.config import tiny_llama_config as jax_tiny
from xkv_tpu_torch.configs import generate_consecutive_xkv_config as torch_xkv
from xkv_tpu_torch.engine import BatchedEngine
from xkv_tpu_torch.models import deepseek
from xkv_tpu_torch.models.ckpt import params_from_numpy
from xkv_tpu_torch.models.config import ModelConfig, tiny_llama_config

SPARSE = dict(sparse_topk=2, sparse_block=8)
# (model, xKV options, engine options, draft options, prompt lengths, new
# tokens); speculative_k 3 and 2 slots in every case.
CASES = {
    # The 32-token prompt runs out of s_max 40 after one refold (32 -> 40
    # rows): it ends at 17 tokens with a full tail, and its slot stays free
    # while the 5-token one speculates on through three more refolds;
    # rounds, exact top-ups. Top-2 of the five 8-row chunks: the drafts
    # are not exact.
    "pre, top-ups, refolds, a slot freed at a full tail": (
        "llama", dict(rank_k=24, rank_v=24),
        dict(s_max=40, tail_max=8, prefill_buckets=[16, 32]), SPARSE, (32, 5), 40),
    "post, 3 requests through 2 slots": (
        "llama", dict(rank_k=24, rank_v=24, rope_mode="post"),
        dict(s_max=32, tail_max=12, prefill_buckets=[16]), SPARSE, (16, 12, 9), 12),
    # tests/test_batching.py::test_batched_speculative_with_refactorization
    "pre full rank, refactorising": (
        "llama", dict(rank_k=64, rank_v=64),
        dict(s_max=48, tail_max=6, prefill_buckets=[16]), SPARSE, (12, 12), 11),
    # tests/test_batching.py::test_batched_mla_speculative_matches_plain
    "mla draft_rank": (
        "mla", dict(rank_k=24, rank_v=None, merge_value=False),
        dict(s_max=16, tail_max=10, prefill_buckets=[16]), dict(draft_rank=8),
        (16, 12, 10), 7),
}
FREED = "pre, top-ups, refolds, a slot freed at a full tail"


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jax_tiny(), tiny_llama_config()
    llama = jax.tree.map(lambda a: np.array(a) * (1 if a.ndim == 1 else 5),
                         jllama.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32))
    return {"llama": (jcfg, tcfg, llama),
            "mla": (JaxModelConfig(**MLA_CFG), ModelConfig(**MLA_CFG),
                    deepseek.numpy_params(ModelConfig(**MLA_CFG), 1))}


def jax_engine(models, case, exact_top_ups):
    """The JAX engine of ``case``; ``exact_top_ups`` rebuilds its plain
    step (the top-ups) without the sparse options. Its drafts keep them:
    ``_draft_kw`` is the dict the engine made, which stays bound."""
    model, opts, kw, draft, _, _ = CASES[case]
    jcfg, tcfg, np_params = models[model]
    je = JaxBatched(jax.tree.map(jnp.asarray, np_params), jcfg, jax_xkv(**xkv_kw(tcfg, opts)),
                    num_slots=2, cache_dtype=jnp.float32, factor_dtype=jnp.float32,
                    speculative_k=3, **kw, **draft)
    if exact_top_ups:
        je._sparse_kw = {}
        je._step_jit = jax.jit(je._step_impl)
    return je


def port_engine(models, case, speculate=True):
    """The port's engine of ``case``; without ``speculate``, the plain
    exact engine of the same configuration (no drafts, no sparse)."""
    model, opts, kw, draft, _, _ = CASES[case]
    _, tcfg, np_params = models[model]
    return BatchedEngine(params_from_numpy(np_params, torch.float32, "cpu"), tcfg,
                         torch_xkv(**xkv_kw(tcfg, opts)), num_slots=2,
                         cache_dtype=torch.float32, factor_dtype=torch.float32, device="cpu",
                         **kw, **(dict(draft, speculative_k=3) if speculate else {}))


def prompts(models, case):
    model, _, _, _, lengths, _ = CASES[case]
    return prompts_of(lengths, models[model][1].vocab_size, seed=31)


@pytest.fixture(scope="module")
def jax_runs(models):
    """(tokens, spec_stats) of a JAX engine, by (case, exact_top_ups),
    each run once for the module."""
    runs = {}

    def run(case, exact_top_ups):
        if (case, exact_top_ups) not in runs:
            je = jax_engine(models, case, exact_top_ups)
            runs[case, exact_top_ups] = serve(je, prompts(models, case), CASES[case][5]), \
                dict(je.spec_stats)
        return runs[case, exact_top_ups]

    return run


@pytest.mark.parametrize("case", list(CASES))
def test_batched_speculative_matches_jax_and_plain(models, jax_runs, case):
    """Tokens and ``spec_stats`` equal the JAX engine's (Llama: its top-ups
    made exact); tokens equal the plain exact engine's, every request
    served in full or to its capacity finish."""
    n_new = CASES[case][5]
    be = port_engine(models, case)
    got = serve(be, prompts(models, case), n_new)
    want, stats = jax_runs(case, CASES[case][0] == "llama")
    assert got == want
    assert be.spec_stats == stats
    assert stats["rounds"] > 0
    assert got == serve(port_engine(models, case, speculate=False), prompts(models, case), n_new)
    if case != FREED:
        assert all(len(g) == n_new for g in got)


def test_batched_speculative_topups_are_exact(models, jax_runs):
    """Reference fault: a case that tops up (plain_steps > 0) and drafts
    over top-2 of five chunks. The JAX engine's own top-ups run its sparse
    step, and its tokens leave the plain exact engine's; the port's equal
    them, and equal the JAX engine's once its top-ups are exact."""
    plain = serve(port_engine(models, FREED, speculate=False), prompts(models, FREED), 40)
    sparse_jax, stats = jax_runs(FREED, False)
    assert stats["plain_steps"] > 0
    assert sparse_jax != plain
    be = port_engine(models, FREED)
    got = serve(be, prompts(models, FREED), 40)
    assert got == plain == jax_runs(FREED, True)[0]
    assert be.spec_stats["plain_steps"] > 0


def test_free_slot_at_a_full_tail(models):
    """A slot whose request ended with its tail full (a capacity finish:
    17 tokens, s_max used up) stays free at tail_len == tail_max while the
    other slot goes on speculating. Its drafts and verify write the rows
    clamped to the tail's end (``append_slot_tails``, as the JAX
    ``dynamic_update_slice`` clamps), and the other request's tokens are
    those of the plain exact engine. The clamp itself: a 4-row write at a
    full 8-row tail lands on rows 4-7."""
    be = port_engine(models, FREED)
    rounds_with_full_free_slot = []
    spec_round = be._spec_round

    def watched():
        free = [s for s in range(be.num_slots) if s not in be.slot_request]
        if any(be.tail_len[s] == be.tail_max for s in free):
            rounds_with_full_free_slot.append(be.spec_stats["rounds"])
        spec_round()

    be._spec_round = watched
    got = serve(be, prompts(models, FREED), 40)
    assert [len(g) for g in got] == [17, 40]
    assert rounds_with_full_free_slot
    assert got == serve(port_engine(models, FREED, speculate=False), prompts(models, FREED), 40)

    cache = be.batch_cache
    k = torch.ones((2, cache.tail_k.shape[2], 4, cache.tail_k.shape[4]))
    cache.tail_k[0].zero_()
    cache.append_slot_tails(0, k, k.clone(), torch.tensor([8, 0]))
    rows = cache.tail_k[0].abs().sum(dim=(1, 3))
    assert rows[0].tolist() == [0] * 4 + [rows[0, 4].item()] * 4 and rows[0, 4] > 0
    assert rows[1, :4].min() > 0 and rows[1, 4:].max() == 0
