"""Continuous batching on a card: the captured batched step
(``engine/graphs.py`` ``BatchedStep``) and the decode kernels at b = 3
with ragged lengths and an empty slot.

Marked ``gpu``: each test skips without a CUDA device. This file imports
neither JAX nor the JAX package; run it on the card as

    python -m pytest --noconftest tests/test_torch_batching_gpu.py -q

Engines: ``tiny_llama_config`` (head size 16) with groups of 2 at rank_k
64 / rank_v 48, in factored pre (K3), post (K2), sparse pre and post
(top-2 of 32-row chunks: K5, K4) and post with int8 + int4 factors (K6);
the MLA + MoE model of ``tests/test_torch_compiled_gpu.py`` (bf16
factors: K7). Random bf16 weights from a seed; 3 slots, s_max 256,
tail 4; four requests of 200, 120, 60 and 150 tokens and 10, 6, 8 and 3
new tokens, so slots refold, free and refill, and the last steps run
with empty slots.

Exact checks: the graph engine's tokens and launch counts equal those of
the same engine stepping eagerly (the same kernels on the same inputs);
one capture per engine (every step after the first a replay); an eager
batched step makes no host sync. Batched speculation (speculative_k 3,
tail 8; sparse pre and post drafts, MLA draft_rank 32): the captured
draft, verify and top-up steps against the same engine run eagerly, one
capture of each per engine. Kernel checks: K2-K7 against their plain
versions with the limits of ``tests/test_torch_kernels_gpu.py``.
"""

import pytest
import torch

from xkv_tpu_torch.compress.quant import pack_int4_pairs
from xkv_tpu_torch.configs import generate_consecutive_xkv_config
from xkv_tpu_torch.engine import BatchedEngine
from xkv_tpu_torch.models import deepseek, llama
from xkv_tpu_torch.models.config import ModelConfig, tiny_llama_config
from xkv_tpu_torch.ops.kernels import _build
from xkv_tpu_torch.ops.kernels import lowrank_attention as k3
from xkv_tpu_torch.ops.kernels import rankspace_attention as k2

MLA_CFG = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=4,
               num_q_heads=4, num_kv_heads=4, head_dim=32, model_type="deepseek_v2",
               kv_lora_rank=64, qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32,
               n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2,
               moe_intermediate_size=64, first_k_dense_replace=1)
SPARSE = dict(sparse_topk=2, sparse_block=32)
# (rope mode, engine options, the decode kernel)
RUNS = {"pre": ("pre", {}, "K3"), "post": ("post", {}, "K2"),
        "sparse pre": ("pre", SPARSE, "K5"), "sparse post": ("post", SPARSE, "K4"),
        "int4 post": ("post", dict(factor_dtype="int4"), "K6"), "mla": (None, {}, "K7")}
LENGTHS, NEW = (200, 120, 60, 150), (10, 6, 8, 3)
TOL_BF16_OUT, TOL_T, TOL_LSE = 2.0 ** -6, 2.0 ** -7, 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def engine(run, cuda, tail_max=4, **extra):
    rope, kw, _ = RUNS[run]
    kw = dict(kw, **extra)
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
    eng = BatchedEngine(params, cfg, xkv, num_slots=3, s_max=256, tail_max=tail_max,
                        prefill_buckets=[64, 128, 256], device=cuda, **kw)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen, device=cuda).cpu().numpy()
               for n in LENGTHS]
    return eng, prompts


def serve(eng, prompts):
    _build.reset_counts()
    ids = [eng.submit(p, n) for p, n in zip(prompts, NEW)]
    by_id = {r.request_id: r.generated for r in eng.run()}
    torch.cuda.synchronize()
    return [by_id[i] for i in ids], _build.read_counts()


@pytest.mark.gpu
@pytest.mark.parametrize("run", list(RUNS))
def test_batched_graph_equals_eager_steps(cuda, run):
    eager_eng, prompts = engine(run, cuda)
    eager_eng.step_graph.graphed = False  # every step eager, as on the CPU
    want, eager_counts = serve(eager_eng, prompts)
    eng, _ = engine(run, cuda)
    got, counts = serve(eng, prompts)
    assert got == want
    assert [len(g) for g in got] == list(NEW)
    assert counts == eager_counts
    steps = eng.step_graph.steps
    assert counts[RUNS[run][2]] == eng.cfg.num_layers * steps
    # One capture (the first step), every later step a replay.
    replay_ms, replays = eng.step_graph.replay_ms()
    assert eng.step_graph.capture_ms is not None and replays == steps - 1 and replay_ms > 0


# Batched speculation (speculative_k 3, tail 8): the draft options and the
# kernels of a draft step and of the verify and top-up steps.
SPEC = {"sparse pre": (dict(speculative_k=3), "K5", "K3"),
        "sparse post": (dict(speculative_k=3), "K4", "K2"),
        "mla": (dict(speculative_k=3, draft_rank=32), "K7", "K7")}


@pytest.mark.gpu
@pytest.mark.parametrize("run", list(SPEC))
def test_batched_speculation_graphs_equal_eager_rounds(cuda, run):
    """``BatchedEngine(speculative_k=3)``: the captured draft and verify
    steps (``BatchedSpecRound``) and the captured top-up step give the
    tokens, ``spec_stats`` and launch counts of the same engine run
    eagerly; each graph is captured once per engine and replayed by every
    later round or top-up; the launches are k drafts and one verify a
    round and one exact step a top-up."""
    spec, draft_kernel, exact_kernel = SPEC[run]
    eager_eng, prompts = engine(run, cuda, tail_max=8, **spec)
    eager_eng.step_graph.graphed = eager_eng.spec_graph.graphed = False
    want, eager_counts = serve(eager_eng, prompts)
    eng, _ = engine(run, cuda, tail_max=8, **spec)
    got, counts = serve(eng, prompts)
    assert got == want and [len(g) for g in got] == list(NEW)
    assert eng.spec_stats == eager_eng.spec_stats and counts == eager_counts
    rounds, plain = eng.spec_stats["rounds"], eng.spec_stats["plain_steps"]
    assert rounds > 1
    L = eng.cfg.num_layers
    want_counts = {key: 0 for key in counts}
    want_counts[draft_kernel] += L * 3 * rounds
    want_counts[exact_kernel] += L * (rounds + plain)
    want_counts["K1"] = counts["K1"]
    assert counts == want_counts
    t = eng.spec_graph.timing
    assert t.draft_capture_ms is not None and t.verify_capture_ms is not None
    assert len(t.events) == rounds - 1
    draft_ms, verify_ms, _ = t.replayed()
    assert draft_ms > 0 and verify_ms > 0
    _, replays = eng.step_graph.replay_ms()
    assert replays == max(plain - 1, 0)
    assert (eng.step_graph.capture_ms is not None) == (plain > 0)


@pytest.mark.gpu
@pytest.mark.parametrize("run", ["pre", "mla"])
def test_eager_batched_step_makes_no_host_sync(cuda, run):
    eng, prompts = engine(run, cuda)
    eng.submit(prompts[0], 5)
    eng._admit()  # one slot admitted, two empty
    buf = eng.step_graph
    buf.load(eng.token, eng.pos, eng.prefill_len, eng.tail_len)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits = eng.step_logits(*buf.inputs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(logits).all())


LENS = [180, 37, 0]  # ragged, short, an empty slot


def _rows(gen, cuda, b, s, w, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn((b, s, w), generator=gen, device=cuda) * scale).to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
def test_decode_kernels_at_b3_ragged(cuda, int8):
    """K2, K3 (dense), K4, K5 (two chunks a slot) and K6 at b = 3 over
    200 rows, lengths 180, 37 and 0."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(7)
    b, s_p, rk, rv, hq, hkv = 3, 200, 64, 96, 8, 2
    lengths = torch.tensor(LENS, device=cuda)
    if int8:
        k_us = torch.randint(-127, 128, (b, s_p, rk), generator=gen, device=cuda).to(torch.int8)
        v_us = torch.randint(-127, 128, (b, s_p, rv), generator=gen, device=cuda).to(torch.int8)
        scale = 0.5 / rk ** 0.5 / 73.0
    else:
        k_us, v_us, scale = _rows(gen, cuda, b, s_p, rk), _rows(gen, cuda, b, s_p, rv), 0.06
    q_emb = _rows(gen, cuda, b, hq, rk, scale)
    ids = torch.tensor([[3, 0], [0, 1], [0, 2]], dtype=torch.int32, device=cuda)
    for run, plain, args in (
            (k2.rankspace_kernel, k2.rankspace_kernel_plain, (q_emb, k_us, v_us, lengths)),
            (k2.sparse_rankspace_kernel, k2.sparse_rankspace_kernel_plain,
             (q_emb, k_us, v_us, ids, 64, lengths))):
        t, lse = run(*args)
        t_ref, lse_ref = plain(*args)
        assert_ragged(t, lse, t_ref, lse_ref, TOL_T)
    k_vt = _rows(gen, cuda, b, rk, hkv * 128, 0.05, torch.float32)
    v_vt = _rows(gen, cuda, b, rv, hkv * 128, 0.05)
    if int8:
        k_vt = (k_vt * 1000).round().clamp(-127, 127).to(torch.int8)
        v_scale = torch.rand((b, 1, rv), generator=gen, device=cuda) * 0.01
    else:
        k_vt, v_scale = k_vt.to(torch.bfloat16), None
    theta = torch.arange(s_p, device=cuda)[:, None] * 0.01 * torch.arange(1, 65, device=cuda)
    cos_h, sin_h = theta.cos().to(torch.bfloat16), theta.sin().to(torch.bfloat16)
    qab = _rows(gen, cuda, b, hq, 256, 0.1)
    common = (qab, k_us, k_vt, v_us, v_vt, cos_h, sin_h, v_scale)
    for run, plain, args in (
            (k3.lowrank_kernel, k3.lowrank_kernel_plain, common + (lengths, None)),
            (k3.sparse_lowrank_kernel, k3.sparse_lowrank_kernel_plain,
             common + (ids, 64, lengths, None))):
        out, lse = run(*args, num_q_heads=hq, num_kv_heads=hkv)
        out_ref, lse_ref = plain(*args, num_q_heads=hq, num_kv_heads=hkv)
        assert_ragged(out, lse, out_ref, lse_ref, TOL_BF16_OUT)
    if not int8:
        return
    us4k = pack_int4_pairs(torch.randint(-7, 8, (b, s_p, 48), generator=gen, device=cuda))
    us4v = pack_int4_pairs(torch.randint(-7, 8, (b, s_p, 64), generator=gen, device=cuda))
    q6 = _rows(gen, cuda, b, hq, rk + 48, 0.01)
    args = (q6, k_us, us4k, v_us, us4v, lengths)
    t, lse = k2.mixed_rankspace_kernel(*args)
    t_ref, lse_ref = k2.mixed_rankspace_kernel_plain(*args)
    assert_ragged(t, lse, t_ref, lse_ref, TOL_T)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_mla_kernel_at_b3_ragged(cuda, kind):
    """K7 at b = 3, DeepSeek-V2-Lite's widths (16 heads, rank 512, RoPE 64),
    lengths 180, 37 and 0."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(8)
    b, s_p, rk, nh, rope = 3, 200, 512, 16, 64
    q_emb = _rows(gen, cuda, b, nh, rk, 0.4 / rk ** 0.5)
    q_pe = _rows(gen, cuda, b, nh, rope, 0.1)
    k_pe = _rows(gen, cuda, b, s_p, rope)
    r = torch.rand((b, s_p), generator=gen, device=cuda) + 0.5
    us = torch.randn((b, s_p, rk), generator=gen, device=cuda)
    if kind == "int8":
        us, q_emb = (us * 40).round().clamp(-127, 127).to(torch.int8), q_emb * 0.02
    else:
        us = us.to(torch.bfloat16)
    args = (q_emb, q_pe, us, k_pe, r, torch.tensor(LENS, device=cuda))
    t, lse = k2.mla_rankspace_kernel(*args)
    t_ref, lse_ref = k2.mla_rankspace_kernel_plain(*args)
    assert_ragged(t, lse, t_ref, lse_ref, TOL_T)


def assert_ragged(out, lse, out_ref, lse_ref, tol):
    """Slots 0 and 1 (live keys) within the limits; slot 2 (no live key)
    outputs exactly 0 and an lse of a finite -inf (the kernels' NEG_INF,
    -2.4e38, the plain version's -1e30), which weighs 0 in the merge."""
    assert bool(torch.isfinite(out).all()) and not out[2].any()
    assert _row_rel_err(out[:2], out_ref[:2]) <= tol
    assert _lse_err(lse[:2], lse_ref[:2]) <= TOL_LSE
    assert bool((lse[2] <= -1e29).all()) and bool((lse_ref[2] <= -1e29).all())


def _row_rel_err(out, ref):
    diff = (out.float() - ref.float()).abs().amax(-1)
    scale = ref.float().abs().amax(-1).clamp_min(torch.finfo(torch.float32).tiny)
    return (diff / scale).max().item()


def _lse_err(lse, ref):
    return ((lse - ref).abs() / ref.abs().clamp_min(1.0)).max().item()
