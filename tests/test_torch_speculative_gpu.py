"""Speculative decoding on the captured draft and verify graphs
(``engine/graphs.py`` ``SpecRounds``) and the staged prefill, on a card.

Marked ``gpu``: each test skips without a CUDA device. Like
``tests/test_torch_compiled_gpu.py`` this file imports neither JAX nor the
JAX package; run it on the card as

    python -m pytest --noconftest tests/test_torch_speculative_gpu.py -q

Engines: ``tiny_llama_config`` with groups of 2 at rank_k 64 / rank_v 48,
drafting with sparse top-4 of 24-row chunks in pre (K5 drafts, K3 verify)
and post (K4, K2); the MLA + MoE model of ``tests/test_torch_compiled_gpu.py``
at rank 48 drafting at ``draft_rank`` 24 (K7 over the factors' first 24
columns, read in place at a rank that is not a multiple of 16) and 32. Random
bf16 weights from a seed, scaled by 5 so that the greedy tokens vary, a
200-token prompt, a tail of 12 and ``draft_k`` 3: rounds, a top-up and a
refactorisation in 24 tokens.

Checks: the speculative tokens equal the exact engine's ``generate`` (the
same configuration without drafts) up to the first step whose exact top-2
logit gap is below 2^-6 of the step's logit range, where the bf16
verify pass (a ``ql = 4`` step: other row tiles and splits, other GEMM
shapes) may break a tie the other way from the single-token step; the
launch counts equal what the rounds, top-ups and prefill imply (a
captured launch counted once per replay); the draft and verify graphs are
captured once per factor segment. Staged prefill at the tiny shapes gives
the monolithic prefill's cache and logits bit for bit.
"""

import pytest
import torch

from xkv_tpu_torch.configs import generate_consecutive_xkv_config
from xkv_tpu_torch.engine import InferenceEngine
from xkv_tpu_torch.engine.graphs import RoundTiming
from xkv_tpu_torch.models import deepseek, llama
from xkv_tpu_torch.models.config import ModelConfig, tiny_llama_config
from xkv_tpu_torch.ops.kernels import _build

MLA_CFG = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=4,
               num_q_heads=4, num_kv_heads=4, head_dim=32, model_type="deepseek_v2",
               kv_lora_rank=64, qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32,
               n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2,
               moe_intermediate_size=64, first_k_dense_replace=1)
SPARSE = dict(sparse_topk=4, sparse_block=24)
# (rope mode, draft options, draft kernel, verify kernel)
RUNS = {"pre": ("pre", SPARSE, "K5", "K3"), "post": ("post", SPARSE, "K4", "K2"),
        "mla 24": (None, dict(draft_rank=24), "K7", "K7"),
        "mla 32": (None, dict(draft_rank=32), "K7", "K7")}
N_NEW, TAIL, DRAFT_K, GAP = 24, 12, 3, 2.0 ** -6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def model(run, cuda):
    rope = RUNS[run][0]
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    if rope is None:
        cfg = ModelConfig(**MLA_CFG)
        params = deepseek.init_params(cfg, gen, torch.bfloat16, cuda)
        xkv = generate_consecutive_xkv_config(
            group_size=2, rank_k=48, rank_v=None, num_layers=cfg.num_layers,
            end_layer=cfg.num_layers - 1, merge_value=False)
    else:
        cfg = tiny_llama_config()
        params = llama.init_params(cfg, gen, torch.bfloat16, cuda)
        xkv = generate_consecutive_xkv_config(
            group_size=2, rank_k=64, rank_v=48, num_layers=cfg.num_layers,
            end_layer=cfg.num_layers - 1, extra_kwargs={"rope_mode": rope})
    params = _scaled(params)
    prompt = torch.randint(0, cfg.vocab_size, (1, 200), generator=gen, device=cuda)
    return params, cfg, xkv, prompt


def _scaled(tree):
    if isinstance(tree, dict):
        return {k: _scaled(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_scaled(v) for v in tree]
    return tree if tree.dim() == 1 else tree * 5


def top2_gaps(eng, prompt, tokens):
    """Top-2 logit gap of each of the exact run's steps over the step's
    logit range (max - min): prefill's, then the teacher-forced steps
    (``score``, segment by segment, refactorising a full tail as
    ``generate`` does; log-probs keep the gaps and the range)."""
    logits, cache = eng.prefill(prompt)
    rows = [logits[0, -1].float()]
    pos, done = prompt.shape[1], 1
    while done < tokens.shape[1]:
        if cache.tail_count == cache.tail_max:
            cache = eng.refactorize(cache)
        n = min(tokens.shape[1] - done, cache.tail_max - cache.tail_count)
        lp, cache = eng.score(cache, tokens[:, done - 1:done - 1 + n], pos)
        rows.extend(lp[0].float())
        pos, done = pos + n, done + n
    rows = torch.stack(rows)
    top = rows.topk(2, dim=-1).values
    return ((top[:, 0] - top[:, 1]) / (top[:, 0] - rows.amin(dim=-1))).tolist()


def agreeing_prefix(gaps):
    """Steps before the first whose gap is below ``GAP``."""
    return next((i for i, g in enumerate(gaps) if g < GAP), len(gaps))


@pytest.mark.gpu
@pytest.mark.parametrize("run", list(RUNS))
def test_speculative_matches_generate_on_the_card(cuda, run):
    rope, draft, k_draft, k_verify = RUNS[run]
    params, cfg, xkv, prompt = model(run, cuda)
    spec = InferenceEngine(params, cfg, xkv, mode="factored", tail_max=TAIL, device=cuda,
                           **draft)
    exact = InferenceEngine(params, cfg, xkv, mode="factored", tail_max=TAIL, device=cuda)
    want = exact.generate(prompt, N_NEW)
    n = agreeing_prefix(top2_gaps(exact, prompt, want))
    _build.reset_counts()
    got, stats = spec.generate_speculative(prompt, N_NEW, draft_k=DRAFT_K, return_stats=True)
    torch.cuda.synchronize()
    counts = _build.read_counts()
    assert got.shape == (1, N_NEW)
    assert torch.equal(got[:, :n], want[:, :n].cpu()), (n, got, want)
    L = cfg.num_layers
    expect = {key: 0 for key in counts}
    expect["K1"] = 0 if rope is None else L
    expect[k_draft] += L * DRAFT_K * stats["rounds"]
    expect[k_verify] += L * (stats["rounds"] + stats["plain_steps"])
    assert counts == expect
    rounds = [t for t in spec.last_timings if isinstance(t, RoundTiming)]
    assert len(rounds) >= 2 and sum(t.rounds for t in rounds) == stats["rounds"]
    for t in rounds:  # one capture of each graph per segment
        assert t.draft_capture_ms is not None and t.verify_capture_ms is not None
        assert len(t.events) == t.rounds - 1


@pytest.mark.gpu
@pytest.mark.parametrize("rope", ["pre", "post"])
def test_staged_prefill_matches_monolithic_on_the_card(cuda, rope):
    params, cfg, xkv, prompt = model(rope, cuda)
    engines = [InferenceEngine(params, cfg, xkv, mode="factored", tail_max=TAIL,
                               prefill_logits="last", staged_prefill=staged, device=cuda)
               for staged in (True, False)]
    _build.reset_counts()
    (ls, cs), (lm, cm) = (eng.prefill(prompt) for eng in engines)
    assert _build.read_counts()["K1"] == 2 * cfg.num_layers
    assert torch.equal(ls, lm)
    for gs, gm in zip(cs.groups, cm.groups):
        for name in ("k_us", "k_vt", "v_us", "v_vt"):
            assert torch.equal(getattr(gs, name), getattr(gm, name))
    assert torch.equal(engines[0].generate(prompt, 8), engines[1].generate(prompt, 8))
