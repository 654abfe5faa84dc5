#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``xkv_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:
  1. build   compile the CUDA kernels from ``xkv_tpu_torch/csrc``;
  2. kernels hold K1 (prefill attention), K2 (rank-space decode) and K3
             (low-rank decode) against their plain versions on the card, at
             the Llama-3.1-8B xKV-4 shapes, and time kernel, plain version,
             library call and bound;
  3. main    serve Llama-3.1-8B (full width and depth, random bf16 weights
             from a seed) with an 8192-token prompt through
             ``InferenceEngine.generate`` in every mode, checking launch
             counts, factored-vs-fake logits and one refactorisation;
  4. anchor  teacher-force the golden tokens of the JAX engine on the
             in-repo checkpoint and compare per-step logits.
Then it prints the card's name and power limit, one JSON line of kernel
records, and as the last line ``{"ok": true, "device": {...}}``.
Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_OPS_PER_S = 989e12
SEED = 0

# Kernel against plain version. Outputs are held row by row against the
# row's own largest value (``row_rel_err``): at s = 8192 a row averages
# thousands of keys and its values are ~0.02, so an absolute limit would
# be as large as the outputs. bf16 keeps 8 significant bits, so one unit
# in the last place is at most 2^-7 of a value.
#  K1, K3: bf16 outputs; the kernel and the plain version each round P to
#     bf16 against another maximum (running or final) and round the output
#     once: at most 2 units in the last place of the row's largest value.
#  K2: fp32 t, whose only rounding is P to bf16 (2^-9 relative per
#     probability, against another maximum): 2^-7 of the row's largest
#     value.
#  lse: fp32 on both sides from the same maximum and sums in another
#     order, so the error grows with the scores (``lse_err``).
TOL = {"K1": 2.0 ** -6, "K2": 2.0 ** -7, "K3": 2.0 ** -6, "lse": 1e-5}
# Logits of the main path and of the anchor (prefill step, decode steps):
# twice the readings of these seeded runs on an H100, the same in every
# call.
TOL_FACTORED_VS_FAKE = 2 * 0.2603
TOL_ANCHOR = {"prefill": 2 * 0.2073, "decode": 2 * 0.1148}


def log(msg: str) -> None:
    print(msg, flush=True)


def max_abs_err(out, ref) -> float:
    return (out.float() - ref.float()).abs().max().item()


def row_rel_err(out, ref) -> float:
    """Largest over rows (the last axis) of max |out - ref| / max |ref|."""
    import torch

    diff = (out.float() - ref.float()).abs().amax(-1)
    scale = ref.float().abs().amax(-1).clamp_min(torch.finfo(torch.float32).tiny)
    return (diff / scale).max().item()


def lse_err(lse, ref) -> float:
    """Largest |lse - ref| / max(1, |ref|)."""
    return ((lse - ref).abs() / ref.abs().clamp_min(1.0)).max().item()


_L2_FLUSH = []


def cuda_time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, each timed alone
    with CUDA events and each started with a cold L2: a 512 MB buffer (ten
    times the L2) is written before every call, outside the timed span, as
    the layers between two calls of a decode step would evict it. The
    device then spins ~1 ms, so the host has queued a short call's
    launches before its span opens and the span holds no host time."""
    import torch

    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.empty(128 << 20, dtype=torch.int32, device="cuda"))
    for _ in range(warmup):
        fn()
    spans = []
    for _ in range(iters):
        _L2_FLUSH[0].zero_()
        torch.cuda._sleep(2_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in spans) / iters


def bound_ms(nbytes: float, ops_time_s: float) -> tuple:
    """(bound in ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the operations over their peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    if t_bytes >= ops_time_s:
        return t_bytes * 1e3, "bytes"
    return ops_time_s * 1e3, "operations"


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# ------------------------------------------------------------------ kernels
def check_flash(gen, results):
    import torch
    import torch.nn.functional as F

    from xkv_tpu_torch.ops.kernels import flash_attention as k1

    b, hq, hkv, hd = 1, 32, 8, 128
    scale = 1.0 / math.sqrt(hd)
    tol = TOL["K1"]
    worst, worst_rel = 0.0, 0.0
    for s, window in ((8192, None), (1000, None), (2048, 512)):
        q = torch.randn((b, hq, s, hd), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((b, hkv, s, hd), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((b, hkv, s, hd), generator=gen, device="cuda").to(torch.bfloat16)
        out = k1.flash_attention(q, k, v, scale=scale, window=window)
        ref = k1.flash_attention_plain(q, k, v, scale=scale, window=window)
        torch.cuda.synchronize()
        err, rel = max_abs_err(out, ref), row_rel_err(out, ref)
        log(f"K1 s={s} window={window}: max_abs_err={err:.3e}, "
            f"max_rel_err={rel:.3e} (limit {tol:.3e})")
        if not rel <= tol:
            raise AssertionError(f"K1 disagrees with its plain version at s={s}")
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
        if s == 8192:
            ms = cuda_time_ms(lambda: k1.flash_attention(q, k, v, scale=scale))
            plain_ms = cuda_time_ms(
                lambda: k1.flash_attention_plain(q, k, v, scale=scale), iters=2, warmup=1)
            lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=scale, enable_gqa=True))
            pairs = s * (s + 1) / 2
            ops = 4.0 * b * hq * hd * pairs
            bnd, by = bound_ms(nbytes(q, k, v, out), ops / BF16_OPS_PER_S)
    results["K1"] = dict(
        name="flash_attention", route="cuda", source="xkv_tpu_torch/csrc/flash_attention.cu",
        replaces="xkv_tpu/ops/pallas/flash_attention.py:118", max_abs_err=worst,
        max_rel_err=worst_rel, tol=f"{tol} of each row's max |ref|", ms=ms,
        plain_ms=plain_ms, bound_ms=bnd, bound_by=by, library_ms=lib_ms)


def _decode_inputs(gen, s_p, rk, rv, m, dtype):
    import torch

    from xkv_tpu_torch.compress.quant import quantize_k_factors, quantize_v_factors

    us_k = torch.randn((1, s_p, rk), generator=gen, device="cuda")
    vt_k = torch.randn((1, rk, 4 * m), generator=gen, device="cuda") * 0.05
    us_v = torch.randn((1, s_p, rv), generator=gen, device="cuda")
    vt_v = torch.randn((1, rv, 4 * m), generator=gen, device="cuda") * 0.05
    if dtype == "int8":
        qk, qv = quantize_k_factors(us_k, vt_k), quantize_v_factors(us_v, vt_v)
        return dict(k_us=qk.us_q, k_vt=qk.vt_q, k_scale=qk.out_scale,
                    v_us=qv.us_q, v_vt=qv.vt, v_scale=qv.rank_scale)
    bf = torch.bfloat16
    return dict(k_us=us_k.to(bf), k_vt=vt_k.to(bf), k_scale=None,
                v_us=us_v.to(bf), v_vt=vt_v.to(bf), v_scale=None)


def check_decode(gen, results):
    """K2 and K3 at the 8B xKV-4 shapes (layer 1 of a 4-layer group)."""
    import torch

    from xkv_tpu_torch.cache import vt_layer_slice
    from xkv_tpu_torch.ops.kernels import lowrank_attention as k3
    from xkv_tpu_torch.ops.kernels import rankspace_attention as k2
    from xkv_tpu_torch.ops.rope import rope_cos_sin

    hq, hkv, hd, s_p, rk, rv = 32, 8, 128, 8192, 512, 768
    m = hkv * hd
    scale = 1.0 / math.sqrt(hd)
    worst = {"K2": 0.0, "K3": 0.0}
    worst_rel = {"K2": 0.0, "K3": 0.0}
    worst_lse = {"K2": 0.0, "K3": 0.0}
    timing = {}
    cos_p, sin_p = rope_cos_sin(torch.arange(s_p, device="cuda"), hd, 500000.0)
    for dtype in ("bf16", "int8"):
        f = _decode_inputs(gen, s_p, rk, rv, m, dtype)
        vt_k = vt_layer_slice(f["k_vt"], 1, hkv, hd)
        vt_v = vt_layer_slice(f["v_vt"], 1, hkv, hd)
        k_scale = None if f["k_scale"] is None else vt_layer_slice(f["k_scale"], 1, hkv, hd)
        for ql, lens, lo in ((1, None, None), (4, s_p - 300, 1000), (1, s_p - 37, 4100)):
            lengths = None if lens is None else torch.tensor([lens], device="cuda")
            win_lo = None if lo is None else torch.tensor([lo], device="cuda")
            q = torch.randn((1, hq, ql, hd), generator=gen, device="cuda").to(torch.bfloat16)
            # K2: the kernel proper (scores, softmax, t = P @ v_us).
            q_emb = k2._project_q(q, vt_k, hkv, scale, k_scale, torch.bfloat16)
            t, lse = k2.rankspace_kernel(q_emb, f["k_us"], f["v_us"], lengths, win_lo)
            t_ref, lse_ref = k2.rankspace_kernel_plain(q_emb, f["k_us"], f["v_us"], lengths, win_lo)
            torch.cuda.synchronize()
            # K3: query embeds at position s_p + 5.
            cos_t, sin_t = rope_cos_sin(s_p + 5 + torch.arange(ql, device="cuda")[None], hd,
                                        500000.0)
            cos_h, sin_h = k3.half_tables(cos_p, sin_p, f["k_us"].dtype)
            qab = k3._query_embeds(q, cos_t, sin_t, hkv, scale, k_scale)
            args = (qab, f["k_us"], vt_k, f["v_us"], vt_v, cos_h, sin_h, f["v_scale"],
                    lengths, win_lo)
            kw = dict(num_q_heads=hq, num_kv_heads=hkv)
            o3, l3 = k3.lowrank_kernel(*args, **kw)
            o3_ref, l3_ref = k3.lowrank_kernel_plain(*args, **kw)
            torch.cuda.synchronize()
            errs = {"K2": (max_abs_err(t, t_ref), row_rel_err(t, t_ref), lse_err(lse, lse_ref)),
                    "K3": (max_abs_err(o3, o3_ref), row_rel_err(o3, o3_ref), lse_err(l3, l3_ref))}
            log(f"{dtype} ql={ql} valid_len={lens} win_lo={lo}: " + ", ".join(
                f"{key} max_abs_err={a:.3e} max_rel_err={r:.3e} (limit {TOL[key]:.3e}) "
                f"lse_err={e:.3e} (limit {TOL['lse']:.0e})" for key, (a, r, e) in errs.items()))
            for key, (a, r, e) in errs.items():
                if not (r <= TOL[key] and e <= TOL["lse"]):
                    raise AssertionError(
                        f"{key} disagrees with its plain version ({dtype}, ql={ql})")
                worst[key] = max(worst[key], a)
                worst_rel[key] = max(worst_rel[key], r)
                worst_lse[key] = max(worst_lse[key], e)
            if ql == 1 and lens is None and dtype == "bf16":
                # The main path's shapes: bf16 factors, one query row per head.
                live = s_p
                timing["K2"] = dict(
                    ms=cuda_time_ms(lambda: k2.rankspace_kernel(q_emb, f["k_us"], f["v_us"])),
                    plain_ms=cuda_time_ms(
                        lambda: k2.rankspace_kernel_plain(q_emb, f["k_us"], f["v_us"])),
                    bound=bound_ms(nbytes(q_emb, f["k_us"], f["v_us"], t, lse),
                                   2.0 * q_emb.shape[1] * live * (rk + rv) / BF16_OPS_PER_S))
                R = qab.shape[1]
                recon = 2.0 * live * rk * m
                rest = 2.0 * R * live * (2 * hd + rv) + 2.0 * R * rv * hd
                # Inputs as the kernel reads them: vt slices are rk x m and
                # rv x m of the group's wider bases.
                slice_bytes = (rk + rv) * m * 2
                timing["K3"] = dict(
                    ms=cuda_time_ms(lambda: k3.lowrank_kernel(*args, **kw)),
                    plain_ms=cuda_time_ms(lambda: k3.lowrank_kernel_plain(*args, **kw)),
                    bound=bound_ms(nbytes(qab, f["k_us"], f["v_us"], cos_h, sin_h, o3, l3)
                                   + slice_bytes, (recon + rest) / BF16_OPS_PER_S))
    for key, name, src, rep in (
        ("K2", "rankspace_decode_attention", "xkv_tpu_torch/csrc/rankspace_attention.cu",
         "xkv_tpu/ops/pallas/rankspace_attention.py:285"),
        ("K3", "lowrank_decode_attention", "xkv_tpu_torch/csrc/lowrank_attention.cu",
         "xkv_tpu/ops/pallas/lowrank_attention.py:343"),
    ):
        bnd, by = timing[key]["bound"]
        results[key] = dict(name=name, route="cuda", source=src, replaces=rep,
                            max_abs_err=worst[key], max_rel_err=worst_rel[key],
                            max_lse_err=worst_lse[key],
                            tol=f"{TOL[key]} of each row's max |ref|; lse {TOL['lse']} of max(1, |lse|)",
                            ms=timing[key]["ms"],
                            plain_ms=timing[key]["plain_ms"], bound_ms=bnd, bound_by=by,
                            library_ms=None)


# ---------------------------------------------------------------- main path
def reset_counts():
    from xkv_tpu_torch.ops.kernels import flash_attention, lowrank_attention, rankspace_attention

    flash_attention.launches = lowrank_attention.launches = rankspace_attention.launches = 0


def read_counts() -> dict:
    from xkv_tpu_torch.ops.kernels import flash_attention, lowrank_attention, rankspace_attention

    return {"K1": flash_attention.launches, "K2": rankspace_attention.launches,
            "K3": lowrank_attention.launches}


def main_path(results):
    import torch

    from xkv_tpu_torch.configs import generate_consecutive_xkv_config
    from xkv_tpu_torch.engine import InferenceEngine
    from xkv_tpu_torch.models.config import llama31_8b_config
    from xkv_tpu_torch.models.llama import init_params

    cfg = llama31_8b_config()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    t0 = time.time()
    params = init_params(cfg, gen, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    log(f"8B params: {sum(nbytes(t) for t in _leaves(params)) / 1e9:.2f} GB "
        f"in {time.time() - t0:.1f} s")
    s = 8192
    prompt = torch.randint(0, cfg.vocab_size, (1, s), generator=gen, device="cuda")
    runs = [
        ("none", "none", "pre", torch.bfloat16, 128, 32),
        ("fake pre", "fake", "pre", torch.bfloat16, 128, 32),
        ("factored pre bf16", "factored", "pre", torch.bfloat16, 128, 32),
        ("factored pre int8", "factored", "pre", "int8", 128, 32),
        ("factored post bf16", "factored", "post", torch.bfloat16, 128, 32),
        ("factored post int8", "factored", "post", "int8", 128, 32),
        ("factored pre bf16 refactorize", "factored", "pre", torch.bfloat16, 32, 48),
    ]
    totals = {"K1": 0, "K2": 0, "K3": 0}
    first_logits = {}
    rows = []
    for label, mode, rope, fdt, tail_max, n_new in runs:
        xkv = generate_consecutive_xkv_config(
            group_size=4, rank_k=512, rank_v=768, num_layers=cfg.num_layers,
            end_layer=cfg.num_layers - 1, extra_kwargs={"rope_mode": rope})
        eng = InferenceEngine(params, cfg, xkv, mode=mode, tail_max=tail_max,
                              factor_dtype=fdt, prefill_logits="last", device="cuda")
        # Prefill alone (timed), then the first decode step's logits.
        torch.cuda.synchronize()
        t0 = time.time()
        logits, cache = eng.prefill(prompt)
        torch.cuda.synchronize()
        prefill_s = time.time() - t0
        ratio = cache.compression_ratio(cfg)
        tok = logits[:, -1].argmax(-1)
        step_logits, cache = eng.decode_step(cache, tok[:, None], s)
        first_logits[label] = step_logits[0, -1].float()
        # Decode alone (timed): the rest of the tail's steps on this cache.
        steps = min(n_new, tail_max) - 1
        torch.cuda.synchronize()
        t0 = time.time()
        for i in range(steps):
            step_logits, cache = eng.decode_step(cache, tok[:, None], s + 1 + i)
        torch.cuda.synchronize()
        decode_ms = (time.time() - t0) * 1e3 / steps
        profile = (profile_decode(eng, cache, tok[:, None], s + 1 + steps, decode_ms)
                   if label in PROFILED else None)
        del cache, logits, step_logits
        # The entry point a user calls, with the launch counts read around it.
        reset_counts()
        out = eng.generate(prompt, n_new)
        torch.cuda.synchronize()
        counts = read_counts()
        steps = n_new - 1
        want = {"K1": cfg.num_layers, "K2": 0, "K3": 0}
        if mode == "factored":
            want["K3" if rope == "pre" else "K2"] = cfg.num_layers * steps
        if counts != want:
            raise AssertionError(f"{label}: launches {counts}, expected {want}")
        if tuple(out.shape) != (1, n_new) or not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
            raise AssertionError(f"{label}: bad output tokens {out.shape}")
        if not bool(torch.isfinite(first_logits[label]).all()):
            raise AssertionError(f"{label}: non-finite logits")
        for key in totals:
            totals[key] += counts[key]
        row = dict(run=label, prefill_s=prefill_s, decode_ms_per_token=decode_ms,
                   compression_ratio=ratio, launches=counts, decode_profile=profile)
        rows.append(row)
        log("main " + json.dumps(row))
        del eng
        torch.cuda.empty_cache()
    # Factored and fake come from the same SVD: fake multiplies the fp32
    # factors out and stores bf16 keys, factored keeps bf16 factors and
    # rebuilds keys in the kernel. The first-step logits differ by those
    # bf16 roundings, carried through 32 layers of random weights. The
    # truncation itself (none against fake) is printed beside it for scale.
    ref = first_logits["fake pre"]
    diff = (first_logits["factored pre bf16"] - ref).abs().max().item()
    trunc = (first_logits["none"] - ref).abs().max().item()
    tol = TOL_FACTORED_VS_FAKE
    log(f"factored vs fake first-step logits: max_abs_diff={diff:.4e} (limit {tol:.4e}; "
        f"max |logit| {ref.abs().max().item():.4e}); none vs fake: {trunc:.4e}")
    if not diff <= tol:
        raise AssertionError("factored and fake first-step logits disagree")
    results["main_runs"] = rows
    return totals


PROFILED = ("none", "factored pre bf16", "factored post bf16")


def profile_decode(eng, cache, tok, pos, step_ms: float, steps: int = 4) -> dict:
    """Device time of a few decode steps under torch.profiler: the summed
    time of the kernels the device ran per step, its share of the step's
    wall time ``step_ms`` measured without the profiler, and the kernels
    that take most of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            _, cache = eng.decode_step(cache, tok, pos + i)
        torch.cuda.synchronize()
    # Only the device's own events: a CPU op's device time repeats its kernels'.
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:6]
    return dict(device_busy_ms_per_step=busy_ms, device_idle_share=1.0 - busy_ms / step_ms,
                top_kernels_ms_per_step={e.key[:60]: e.self_device_time_total / 1e3 / steps
                                         for e in top})


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ------------------------------------------------------------------- anchor
def anchor():
    """Teacher-force the JAX engine's golden tokens through the port on the
    card (bf16) and compare each step's logits with the golden fp32 ones."""
    import numpy as np
    import torch

    from xkv_tpu_torch.configs import generate_consecutive_xkv_config
    from xkv_tpu_torch.engine import InferenceEngine
    from xkv_tpu_torch.models.ckpt import load_checkpoint

    gold = np.load(os.path.join(ROOT, "xkv_tpu_torch", "testdata",
                                "production_model_golden.npz"))
    params, cfg = load_checkpoint(os.path.join(ROOT, "results", "production_model"),
                                  dtype=torch.bfloat16, device="cuda")
    prompt = torch.as_tensor(gold["prompt"], device="cuda")
    for rope in ("pre", "post"):
        xkv = generate_consecutive_xkv_config(
            group_size=int(gold["group_size"]), rank_k=int(gold["rank_k"]),
            rank_v=int(gold["rank_v"]), num_layers=cfg.num_layers,
            end_layer=cfg.num_layers - 1,
            extra_kwargs={"svd_method": "exact", "rope_mode": rope})
        eng = InferenceEngine(params, cfg, xkv, mode="factored", tail_max=64, device="cuda")
        toks = gold[f"tokens_{rope}"]
        want = gold[f"logits_{rope}"]
        reset_counts()
        logits, cache = eng.prefill(prompt)
        got = [logits[0, -1].float().cpu().numpy()]
        pos = prompt.shape[1]
        for i in range(len(toks) - 1):
            tok = torch.tensor([[int(toks[i])]], device="cuda")
            step, cache = eng.decode_step(cache, tok, pos + i)
            got.append(step[0, -1].float().cpu().numpy())
        step_err = np.abs(np.stack(got) - want).max(axis=-1)
        err = {"prefill": float(step_err[0]), "decode": float(step_err[1:].max())}
        counts = read_counts()
        log(f"anchor {rope}: {len(toks)} steps, max_abs_err prefill step {err['prefill']:.4e} "
            f"(limit {TOL_ANCHOR['prefill']:.4e}), decode steps {err['decode']:.4e} "
            f"(limit {TOL_ANCHOR['decode']:.4e}); max |logit| {np.abs(want).max():.4e}; "
            f"launches {counts}")
        if not all(err[k] <= TOL_ANCHOR[k] for k in err):
            raise AssertionError(f"anchor {rope}: logits disagree with the JAX golden")
        kernel = "K3" if rope == "pre" else "K2"
        if counts[kernel] != cfg.num_layers * (len(toks) - 1) or counts["K1"] != cfg.num_layers:
            raise AssertionError(f"anchor {rope}: launches {counts}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    from xkv_tpu_torch.ops.kernels import _build

    t_start = time.time()
    t0 = time.time()
    lib_path = _build.build()
    _build.load()
    log(f"build: {time.time() - t0:.1f} s -> {lib_path}")
    build_log = os.path.join(os.path.dirname(lib_path), "build.log")
    if os.path.exists(build_log):
        with open(build_log) as f:
            for line in f:
                if "registers" in line or "spill" in line or line.startswith("=="):
                    log("  " + line.rstrip())

    results = {}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    check_flash(gen, results)
    check_decode(gen, results)
    totals = main_path(results)
    anchor()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"total {time.time() - t_start:.1f} s")
    log(smi)
    kernels = []
    for key in ("K1", "K2", "K3"):
        rec = dict(results[key])
        rec["launches"] = totals[key]
        kernels.append(rec)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
