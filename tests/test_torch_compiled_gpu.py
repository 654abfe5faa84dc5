"""The captured decode step (``engine/graphs.py``) on a card.

Marked ``gpu``: each test skips without a CUDA device. Like
``tests/test_torch_kernels_gpu.py`` this file imports neither JAX nor the
JAX package; run it on the card as

    python -m pytest --noconftest tests/test_torch_compiled_gpu.py -q

Engines: ``tiny_llama_config`` (head size 16, which K1, K3 and K5 take
zero-padded) with groups of 2 at rank_k 64 / rank_v 48, in factored pre
(K3), post (K2), sparse post top-4 of 24-row chunks (K4) and post with
int8 + int4 factors (K6); and the MLA + MoE model of
``xkv_tpu_torch/testdata/mla_golden.npz``'s config (every width a multiple
of 16, bf16 factors: K7). Random bf16 weights from a seed, a 200-token
prompt, a tail of 4 and 10 new tokens: two refactorisations, so segments
of 4, 4 and 1 steps, the first two captured and replayed.

Exact checks: ``generate`` on the graph gives the eager greedy loop's
tokens (the same kernels on the same inputs); the launch counts read around
it equal the eager loop's; an eager decode step makes no host sync
(``torch.cuda.set_sync_debug_mode("error")``), with the position as an int
and as a tensor on the card.
"""

import pytest
import torch

from xkv_tpu_torch.configs import generate_consecutive_xkv_config
from xkv_tpu_torch.engine import InferenceEngine
from xkv_tpu_torch.models import deepseek, llama
from xkv_tpu_torch.models.config import ModelConfig, tiny_llama_config
from xkv_tpu_torch.ops.kernels import _build

MLA_CFG = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=4,
               num_q_heads=4, num_kv_heads=4, head_dim=32, model_type="deepseek_v2",
               kv_lora_rank=64, qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32,
               n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2,
               moe_intermediate_size=64, first_k_dense_replace=1)
# (rope mode, engine options, the decode kernel)
RUNS = {"pre": ("pre", {}, "K3"), "post": ("post", {}, "K2"),
        "sparse post": ("post", dict(sparse_topk=4, sparse_block=24), "K4"),
        "int4 post": ("post", dict(factor_dtype="int4"), "K6"),
        "mla": (None, {}, "K7")}
N_NEW, TAIL = 10, 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def engine(run, cuda):
    rope, kw, _ = RUNS[run]
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
    eng = InferenceEngine(params, cfg, xkv, mode="factored", tail_max=TAIL, device=cuda, **kw)
    prompt = torch.randint(0, cfg.vocab_size, (1, 200), generator=gen, device=cuda)
    return eng, prompt


def eager_greedy(eng, prompt, n_new):
    logits, cache = eng.prefill(prompt)
    tok = logits[:, -1].argmax(-1)[:, None]
    out, pos = [tok], prompt.shape[1]
    for _ in range(n_new - 1):
        if cache.tail_count == cache.tail_max:
            cache = eng.refactorize(cache)
        logits, cache = eng.decode_step(cache, tok, pos)
        tok = logits[:, -1].argmax(-1)[:, None]
        out.append(tok)
        pos += 1
    return torch.cat(out, dim=1)


@pytest.mark.gpu
@pytest.mark.parametrize("run", list(RUNS))
def test_graph_generate_equals_eager_loop(cuda, run):
    eng, prompt = engine(run, cuda)
    want = eager_greedy(eng, prompt, N_NEW)
    got = eng.generate(prompt, N_NEW)
    assert torch.equal(got, want), (got, want)
    # Segments of 4, 4 and 1 steps: the first two captured and replayed.
    timings = eng.last_timings
    assert [t.steps for t in timings] == [4, 4, 1]
    assert all(t.capture_ms is not None for t in timings[:2]) and timings[2].capture_ms is None
    assert [t.replays for t in timings] == [3, 3, 0]
    assert all(t.replay_ms_per_step() > 0 for t in timings[:2])


@pytest.mark.gpu
@pytest.mark.parametrize("run", list(RUNS))
def test_replay_launch_counts_equal_eager(cuda, run):
    eng, prompt = engine(run, cuda)
    kernel = RUNS[run][2]
    _build.reset_counts()
    eager_greedy(eng, prompt, N_NEW)
    torch.cuda.synchronize()
    eager = _build.read_counts()
    _build.reset_counts()
    eng.generate(prompt, N_NEW)
    torch.cuda.synchronize()
    graph = _build.read_counts()
    layers = eng.cfg.num_layers
    assert eager[kernel] == layers * (N_NEW - 1)
    assert graph == eager


@pytest.mark.gpu
@pytest.mark.parametrize("run", list(RUNS))
def test_eager_step_makes_no_host_sync(cuda, run):
    eng, prompt = engine(run, cuda)
    logits, cache = eng.prefill(prompt)
    tok = logits[:, -1].argmax(-1)[:, None]
    s = prompt.shape[1]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step, cache = eng.decode_step(cache, tok, s)
        step, cache = eng.decode_step(cache, step[:, -1].argmax(-1)[:, None],
                                      torch.full((), s + 1, device=cuda))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert cache.tail_count == 2 and int(cache.tail_len) == 2
    assert bool(torch.isfinite(step).all())
