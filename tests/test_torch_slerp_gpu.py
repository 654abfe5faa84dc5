"""MiniCache SLERP (compact storage) on a card.

Marked ``gpu``: each test skips without a CUDA device. This file imports
neither JAX nor the JAX package; run it on the card as

    python -m pytest --noconftest tests/test_torch_slerp_gpu.py -q

Engines: ``tiny_llama_config`` in SLERP pairs (gamma 0.05), compact at
keep 0.25, random weights from a seed, a 200-token prompt. The SLERP
decode runs no kernel (its prefill segment is rebuilt from the compact
rows and read by the plain dense decode attention), so:

  * the first decode step on the card, over a compact cache built on the
    CPU and moved across, against the same engine's step on the CPU, in
    fp32 (the two devices sum in another order): logits within 1e-4 of
    the largest;
  * ``generate`` (tail 4, 10 new tokens: two refactorisations) on the
    captured graph against the eager greedy loop in bf16: equal tokens,
    equal launches, K1 only (one per layer a prefill);
  * ``BatchedEngine`` with compact slots (3 slots, s_max 256, tail 4; four
    requests, so slots refold, free and refill) on the captured step
    against the same engine stepping eagerly: equal tokens and launches,
    one capture.
"""

import dataclasses

import pytest
import torch

from xkv_tpu_torch.configs import generate_consecutive_xkv_config
from xkv_tpu_torch.engine import BatchedEngine, InferenceEngine
from xkv_tpu_torch.models import llama
from xkv_tpu_torch.models.config import tiny_llama_config
from xkv_tpu_torch.ops.kernels import _build

N_NEW, TAIL = 10, 4
LENGTHS, NEW = (200, 120, 60, 150), (10, 6, 8, 3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def xkv():
    cfg = tiny_llama_config()
    return generate_consecutive_xkv_config(
        layer_merge_impl="slerp", group_size=2, num_layers=cfg.num_layers,
        end_layer=cfg.num_layers - 1, slerp_gamma=0.05, rank_k=None, rank_v=None,
        extra_kwargs={"slerp_compact": True, "slerp_keep_frac": 0.25})


def params_and_prompts(device, dtype):
    cfg = tiny_llama_config()
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = llama.init_params(cfg, gen, dtype, device)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen, device=device)
               for n in LENGTHS]
    return cfg, params, prompts


def to_device(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    if isinstance(x, list):
        return [to_device(v, device) for v in x]
    if isinstance(x, tuple):
        return tuple(to_device(v, device) for v in x)
    if dataclasses.is_dataclass(x):  # the cache, its groups, compact sides
        return dataclasses.replace(x, **{f.name: to_device(getattr(x, f.name), device)
                                         for f in dataclasses.fields(x)})
    return x


@pytest.mark.gpu
def test_compact_decode_step_matches_cpu(cuda):
    cfg, params, prompts = params_and_prompts("cpu", torch.float32)
    kw = dict(mode="factored", tail_max=TAIL, cache_dtype=torch.float32)
    ref = InferenceEngine(params, cfg, xkv(), device="cpu", **kw)
    card = InferenceEngine(to_device(params, cuda), cfg, xkv(), device=cuda, **kw)
    logits, cache = ref.prefill(prompts[0][None])
    assert cache.groups[0].slerp_k is not None
    tok = logits[:, -1].argmax(-1)[:, None]
    s = prompts[0].shape[0]
    on_card, _ = card.decode_step(to_device(cache, cuda), tok.to(cuda), s)
    want, _ = ref.decode_step(cache, tok, s)
    err = (on_card.cpu() - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), err


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
def test_graph_generate_equals_eager_loop(cuda):
    cfg, params, prompts = params_and_prompts(cuda, torch.bfloat16)
    eng = InferenceEngine(params, cfg, xkv(), mode="factored", tail_max=TAIL, device=cuda)
    prompt = prompts[0][None]
    _build.reset_counts()
    want = eager_greedy(eng, prompt, N_NEW)
    torch.cuda.synchronize()
    eager = _build.read_counts()
    _build.reset_counts()
    got = eng.generate(prompt, N_NEW)
    torch.cuda.synchronize()
    graph = _build.read_counts()
    assert torch.equal(got, want), (got, want)
    assert graph == eager and graph["K1"] == cfg.num_layers
    assert sum(graph.values()) == cfg.num_layers
    timings = eng.last_timings
    assert [t.steps for t in timings] == [4, 4, 1]
    assert [t.replays for t in timings] == [3, 3, 0]


def batched(cuda, graphed):
    cfg, params, prompts = params_and_prompts(cuda, torch.bfloat16)
    eng = BatchedEngine(params, cfg, xkv(), num_slots=3, s_max=256, tail_max=TAIL,
                        prefill_buckets=[64, 128, 256], device=cuda)
    eng.step_graph.graphed = graphed
    _build.reset_counts()
    ids = [eng.submit(p.cpu().numpy(), n) for p, n in zip(prompts, NEW)]
    by_id = {r.request_id: r.generated for r in eng.run()}
    torch.cuda.synchronize()
    return eng, [by_id[i] for i in ids], _build.read_counts()


@pytest.mark.gpu
def test_batched_compact_graph_equals_eager_steps(cuda):
    _, want, eager_counts = batched(cuda, graphed=False)
    eng, got, counts = batched(cuda, graphed=True)
    assert got == want and [len(g) for g in got] == list(NEW)
    assert counts == eager_counts and counts["K1"] == eng.cfg.num_layers * len(LENGTHS)
    replay_ms, replays = eng.step_graph.replay_ms()
    assert eng.step_graph.capture_ms is not None and replays == eng.step_graph.steps - 1
    assert replay_ms > 0
