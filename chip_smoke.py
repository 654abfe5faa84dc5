#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``xkv_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:
  1. build   compile the CUDA kernels from ``xkv_tpu_torch/csrc``;
  2. kernels hold K1 (prefill attention), K2 (rank-space decode), K3
             (low-rank decode), K4 (sparse rank-space decode), K5 (sparse
             low-rank decode) and K6 (mixed int8+int4 rank-space decode)
             against their plain versions on the card, at the Llama-3.1-8B
             xKV-4 shapes (K1 also at group sizes 3 and 7, head size 64
             and a 4096 window), and K7 (MLA rank-space decode) and K8 (its
             mixed int8+int4 variant) at the DeepSeek-V2-Lite shapes, K2,
             K3, K6 also at ql 8 (R 256) and K7, K8 at ql 8 as a
             speculative verify pass runs them, K7 also over a draft's
             view of the factors (their first 128 or 120 columns, read in
             place); and time kernel, plain version, library call and
             bound (K2 also over int8 factors, K2 and K6 also at R 128 and
             R 256);
  2a. limits K4 and K5 at chunk widths 16, 24, 100 and 512, and K1, K3
             and K5 at head sizes 16, 24 and 32 (zero-padded to 64 by
             their wrappers), against their plain versions; K4, K5 timed
             at widths 16 and 512;
  2b. wide   K2-K8 at the widest ranks the JAX kernels' layout gives the
             repo's models (K2, K4, K6 at rank 4096, K3, K5 at value rank
             4096, K7, K8 at rank 2048; value slices, streamed q_emb),
             against their plain versions, each timed;
  2c. tools  the kernel-study kernels: K9 (design variants of K3's score
             stage) against K3's plain version at K3's shapes, K10 (K3's
             stage ablation) in every stage set against its plain version,
             K11 (tensor-core rate probe) in bf16, int8 and int4 against its
             plain version, each timed beside the library's calls; then
             the four tools
             (``xkv_tpu_torch.scripts``) run once through their ``main()``
             at their default sizes, with the launch counts read around
             them;
  3. main    serve Llama-3.1-8B (full width and depth, random bf16 weights
             from a seed) with an 8192-token prompt in every mode, sparse
             top-k and int4 included: each run's greedy loop eagerly
             (``decode_step``; one step under the host-sync check), then
             through ``InferenceEngine.generate``, which replays a captured
             CUDA graph of the step: equal tokens, launch counts, eager and
             graph ms/token side by side; factored-vs-fake and
             all-chunks-sparse-vs-dense logits and refactorisations; then
             Llama-3.2-1B (head_dim 64) in mode none through K1, in
             factored pre (xKV-4, bf16 factors) through K3, and at rank_k
             1024 / rank_v 1536 in fake and factored pre (K3) and post
             (K2), factored against fake; then tiny_llama_config (head
             size 16) in factored pre and sparse pre / post at chunk widths
             16, 24 and 100, each held against the same engine on the CPU;
  4. anchor  teacher-force the golden tokens of the JAX engine on the
             in-repo checkpoint and compare per-step logits (pre, post,
             sparse pre, sparse post, int4 post);
  5. mla     serve DeepSeek-V2-Lite (MLA + MoE, full width and depth,
             random bf16 weights from a seed) with an 8192-token prompt,
             eagerly and on the graph as in phase 3, in modes none, fake and
             factored (bf16, int8: K7; int4 with a refactorisation: K8),
             checking launch counts and factored-vs-fake logits;
  6. mla anchor  teacher-force the JAX engine's golden tokens of a small
             MLA + MoE model (weights from a numpy seed) and compare
             per-step logits (bf16 factors: K7; int4: K8);
  7. spec    speculative decoding and staged prefill, run inside phases 3,
             5 and after 6 on their models: ``generate_speculative``
             (draft_k 7, 40 tokens, tail 32: rounds, top-ups and
             refactorisations) on the 8B in sparse top-4 post (K4 drafts,
             K2 verify), pre (K5, K3) and int4 sparse-mixed (K6), and on
             V2-Lite at draft_rank 128 and 120 in bf16 (K7 over the
             factors' first columns, K7 verify) and 120 in int4 (K7, K8):
             the run's tokens teacher-forced through the exact steps (each
             within the near-tie limit of its step's top log-prob, and
             exact greedy decoding's up to the first near tie), launches
             against the rounds, one capture of each graph per segment,
             draft / verify replay ms, ms per emitted token beside the
             exact step's and generate's, the break-even tokens per round;
             staged against monolithic 8B prefill (peak
             allocated memory, seconds, logits, tokens, K1 launches); the
             in-repo checkpoint in pre and post on the golden prompt and on
             a copy-induction prompt (tokens per round);
  8. batch   continuous batching, run inside phases 3 and 5 on their
             models: ``BatchedEngine`` (4 slots, s_max 8704, 64-row tails)
             serves 8 requests of 1500-8192 tokens on the 8B in factored
             pre bf16 (K3), post int4 (K6), both admitted through K1, and
             sparse top-4 post (K4) admitted in 2048-token chunks, and 6
             on V2-Lite (bf16, K7, chunked): every request's tokens, the
             captured step against the eager one (16 steps of the first
             run, and in every run the first step after each refold),
             launches against the steps, one capture per engine, three
             requests teacher-forced through the single-stream engine up
             to their first refold (near-tie limit); tokens/s, replay ms
             per step beside b = 1, admission and refold s, peak memory.
             Phase 2 holds K2-K7 at b = 4 (slots of 8192, 5000, 1500 and 0
             rows) against their plain versions, each timed ("b4");
  9. batch-spec  batched speculation and prompt-cache persistence, run
             after phase 2 and inside phases 3 and 5: K2, K3 and K7 at b 4
             x ql 8 (the verify pass) and K7 over 128- and 120-column
             views at b 4 (the MLA draft), over phase 8's slots, against
             their plain versions, each timed ("b4_ql8",
             "b4_draft_view_<width>"); ``BatchedEngine(speculative_k=7)``
             on phase 8's engine and first five requests: the 8B in pre
             and post with sparse top-4 drafts (K5 / K4 drafts, K3 / K2
             verify and exact top-ups) and V2-Lite at draft_rank 128 (K7):
             tokens, replayed rounds against eager ones, launches against
             the rounds, one capture of each graph, three requests
             teacher-forced (near-tie limit), rounds, tokens a round, draft
             and verify replay ms, tokens/s beside phase 8's plain step;
             ``save_cache`` / ``load_cache`` of the 8B factored cache at
             8192 tokens in bf16 and int8 (file MB, save / load s, the
             first step's logits bitwise); V2-Lite's legacy reconstruct
             path (``k_rnorm`` dropped) against the rank-space step;
  10. minicache  MiniCache SLERP (configs/minicache_llama31_8b.yaml:
             layers 16-31 in pairs, gamma 0.05), run inside phases 3 and 4
             on their models: the 8B in fake, factored dense storage and
             factored compact storage at keep 0.125 with a refactorisation,
             eager and on the graph (equal tokens; K1 at every prefill, no
             decode kernel); compact against dense storage (kept rows
             bitwise, the other rows' error, the rows the merge kept that
             fell outside the budget, cache bytes and ratio, first-step
             logits, the reconstruction's device time per step);
             ``BatchedEngine`` over compact slots (phase 8's layout, its
             first four requests, three teacher-forced); save / load of
             the compact cache; and the JAX engine's MiniCache golden on
             the in-repo checkpoint, dense and compact, teacher-forced;
  11. eval   the evaluation path, after phase 7's checkpoint runs: (a)
             the safetensors loader at full width (Llama-3.1-8B cut to 2
             layers, random bf16 weights: ``save_llama_params`` then
             ``load_params`` onto the card, every tensor bitwise, file MB,
             save and load s) and ``evaluate_texts`` on one 4096-byte text
             through an engine from ``cli.common.build_engine`` (xKV groups
             of 2, pre: K1, then 2047 scored steps through K3) on the
             loaded weights and on those in memory: equal perplexities;
             (b) ``cli.eval_acc.main`` on the in-repo checkpoint over two
             RULER tasks in mode none and xKV-4 pre: the JAX result-file
             format, tokens against the JAX golden
             (``testdata/eval_golden.npz``) up to each sample's first near
             tie, scores beside the golden's; (c) ``cli.eval_perplexity
             .main`` on the same checkpoint, two synthetic texts, both
             modes, perplexity against the golden's, and xKV's shift from
             mode none against the golden's shift; launches held to the
             path's counts in every part;
  12. train  training and CKA grouping, after phase 11: (a)
             ``CompressorTrainer`` on Llama-3.2-1B (full width and depth,
             random bf16 weights from the seed; Dual1D at ratio 32, b 2 x
             2048 tokens of synthetic text, 50 steps: K1 in every frozen
             forward, the loss falling, the checkpoint loaded back bitwise;
             step ms, K/V tokens/s, peak memory); (b)
             ``cli.train_compressor.main`` on the checkpoint; (c) the
             accuracy gates of the JAX package's two gate files on the
             card: the induction model trained by ``train_lm`` (fp32, plain
             attention, no kernel), served in bf16 through K1, K3 (bf16,
             int8), K5, K2 and K6 at the gates' ranks (zero-padded to the
             kernels' layout), every gate's threshold held, and each of
             those kernels at the gates' ranks against its plain version;
             (d) ``cli.group_layers.main --model`` on the checkpoint (K1);
  13. examples and tensor parallelism, after phase 12: (a) the port's
             three examples (``xkv_tpu_torch/examples``) at their own sizes
             on the card: quickstart (8 layers, width 256, 512-token
             prompt, 32 new tokens; K1, K3 pre, K2 post int8: launches
             held to the runs' counts), serving (bf16; K1, K3, K5) and
             accuracy_demo (300 training steps, then its rank sweep; K1,
             K3), tokens and recalls printed; (b) tensor parallelism over
             kv heads, two ranks sharing the card over gloo
             (``scripts/tp_serve.py``): Llama-3.1-8B's widths cut to 4
             layers (one xKV-4 group), a 4096-token prompt, 16 new tokens
             with an 8-row tail (one refold), in pre bf16 (K3), post bf16
             and post int8 (K2), run after (a): held to the unsharded
             engine on the same card, within twice their readings, over
             the same factors (the prefill's logits, each step up to the
             refold over the ranks' prefill cache and one past the pass
             over their last, joined and read by one device) and over
             each side's own factors (every step fed one device's tokens,
             and each greedy token of the ranks against one device's top
             logit at its step); the ranks' greedy tokens equal one
             device's up to the first near tie; controls (one device in
             modes none and fake) beyond the step limit; rank 0's K1 and
             K3 / K2 calls on its own head shard against their plain
             versions at the kernels' limits; each rank's K1 and K2 / K3
             launches on its head shard, its prefill s and eager ms/token;
             (c)
             ``utils.profiling.device_op_times`` of a traced run of 8B-width
             decode replays against the profiler's own totals
             (``key_averages``, and ``profile_op_times``, which the
             profiled phases above total through);
  14. tensor parallelism's rest: three meshes of
             ``scripts/tp_serve.py`` ranks sharing the card over gloo,
             (c) launched beside phase 11's eval_acc and eval_perplexity,
             (a) and (b) beside phase 13, each held against one device on
             the same card after phase 13:
             (a) Llama-3.1-8B's widths cut to 4 layers, a model axis of 2,
             sparse top-4 of 512-row chunks post (K4) and pre (K5) with
             per-shard selection, int4 factors (K6) and int4 with sparse
             top-4 (selection over every head); (b) DeepSeek-V2-Lite's
             widths cut to 4 layers (the dense first layer, 3 MoE layers
             with expert parallelism), a model axis of 2, bf16 (K7) and
             int4 (K8) latent factors; (c) the 8B widths at data 2 x model
             2 (four ranks), b = 2, pre bf16 (K3). 4096-token prompts, 16
             tokens over an 8-row tail (one refold). Held: each rank's
             launches; rank 0's K4 / K5 / K6 / K7 / K8 call on its shard
             against the plain version (K7 / K8 at R = 8, timed); one
             device over the ranks' joined caches fed their tokens at
             every step (the prefill, the steps before and after the
             refold, one past the pass; in the sparse K4 / K5 runs with
             each shard's own chunk selection, as the ranks select), and
             each greedy token of the ranks against its top logit; a
             sparse run's step over every chunk against one device's exact
             step; every rank's prefill s, eager ms/token, peak GB and
             launches printed beside the card's name and power limit;
  15. sequence parallelism, batching under a mesh and the pipeline:
             three waves of ranks sharing the card over gloo, one at a
             time, (a) beside phase 8's admissions, (b) from phase 9's
             persistence on, (c) beside the 1B, tiny-engine and anchor
             phases, each held against one device at the end: (a)
             ``scripts/tp_serve.py --sequence_parallel``, Llama-3.1-8B's
             widths cut to 4 layers, an 8192-token prompt at data 2 x model
             2 (ring attention over the data axis, plain blocks), pre bf16,
             16 tokens over an 8-row tail (K3); (b) ``tp_serve --batched``,
             ``BatchedEngine`` at data 2 x model 2, 4 slots of 4608 rows, 6
             requests of 1000-4096 tokens, pre bf16 admitted in chunks (K3)
             and post bf16 with sparse top-4 drafts and speculative_k 3 (K1,
             K4, K2 at R 64); (c) ``scripts/pp_serve.py``, 8 layers in two
             stages, b 4 of 2048 tokens, ``pipelined_forward`` (K1) and 8
             ``pipelined_decode_step``s at M 2 and 4 in bf16 and int8 (K2).
             Held: each rank's launches; rank 0's first K1-K4 calls
             against their plain versions; (a) one device over the ranks'
             joined factors at every step, the ring prefill against one
             device's K1 within twice the plain-vs-K1 control; (b) every
             rank's tokens equal and each request's tokens teacher-forced
             over its admitted factors; (c) rank 0 against one device
             holding every layer, the forward, each step and the joined
             tails.
Then it prints the card's name and power limit, one JSON line of kernel
records, and as the last line ``{"ok": true, "device": {...}}``.
Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
from xkv_tpu_torch.ops.kernels._build import COUNTERS, read_counts, reset_counts  # noqa: E402
from xkv_tpu_torch.scripts.kernel_variants import lse_err, row_rel_err  # noqa: E402
from xkv_tpu_torch.scripts.timing import cuda_time_ms  # noqa: E402
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
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
#  K4, K6: K2's arithmetic over selected chunks or over int8 + unpacked
#     int4 values (exact in bf16): K2's limit. K5: K3's over selected
#     chunks: K3's limit.
#  lse: fp32 on both sides from the same maximum and sums in another
#     order, so the error grows with the scores (``lse_err``).
#  K7, K8: K2's arithmetic with P * r rounded to bf16 in place of P, over
#     bf16, int8 or int8 + unpacked int4 latent factors: K2's limit.
#  K9: K3's function, held against K3's plain version: K3's limits.
#  K10: against its plain version at the kernel's split count; bf16 output
#     rows carry the rounding of P (as K3); the running max m is fp32 from
#     sums in another order (the lse limit, -inf equal to -inf).
#  K11: integer products are exact (bit for bit); bf16 sums in another
#     order can flip the rounding of the next input: as K3.
TOL = {"K1": 2.0 ** -6, "K2": 2.0 ** -7, "K3": 2.0 ** -6, "K4": 2.0 ** -7,
       "K5": 2.0 ** -6, "K6": 2.0 ** -7, "K7": 2.0 ** -7, "K8": 2.0 ** -7,
       "K9": 2.0 ** -6, "K10": 2.0 ** -6, "K11": 2.0 ** -6, "lse": 1e-5}
# Logits of the main path and of the anchor (prefill step, decode steps):
# twice the readings of these seeded runs on an H100, the same in every
# call.
TOL_FACTORED_VS_FAKE = 2 * 0.2603
# Sparse decode over all 16 chunks against dense factored post decode,
# first step: the kernels agree to 1e-6 of a row, and the bf16 roundings
# that this flips are carried through 32 layers of random weights.
TOL_SPARSE_ALL = 2 * 0.2188
TOL_ANCHOR = {"prefill": 2 * 0.2073, "decode": 2 * 0.1148}
# Golden runs anchored on the card: rope mode, engine options, the decode
# kernel, and the limit of the decode steps (the prefill step is the same
# in every run): twice the readings on an H100.
ANCHOR_RUNS = {
    "pre": ("pre", {}, "K3", TOL_ANCHOR["decode"]),
    "post": ("post", {}, "K2", TOL_ANCHOR["decode"]),
    "sparse_pre": ("pre", dict(sparse_topk=2, sparse_block=64), "K5", 2 * 0.1764),
    "sparse_post": ("post", dict(sparse_topk=2, sparse_block=64), "K4", 2 * 0.1896),
    "int4_post": ("post", dict(factor_dtype="int4"), "K6", 2 * 0.3977),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def max_abs_err(out, ref) -> float:
    return (out.float() - ref.float()).abs().max().item()


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
# K1 cases: (q heads, kv heads, head_dim, s, window, timed). The first is
# the main path's shape (Llama-3.1-8B prefill); then group sizes 3
# (Llama-3.2-3B) and 7 (Qwen2-7B), head size 64 (Llama-3.2-1B) and
# Mistral-7B-v0.1's sliding window of 4096.
K1_CASES = [(32, 8, 128, 8192, None, True), (32, 8, 128, 1000, None, False),
            (32, 8, 128, 2048, 512, False), (24, 8, 128, 2048, None, False),
            (28, 4, 128, 2048, None, False), (32, 8, 64, 8192, None, True),
            (32, 8, 128, 8192, 4096, False)]
K1_DESIGN = ("stage 2 (the Hopper design; stage 1 was mma.sync with a cp.async ring): "
             "persistent, warp-specialised, TMA into a two-stage K/V ring, wgmma products, "
             "ping-pong consumers at head size 128")


def ptxas_resources(build_log: str, source: str) -> dict:
    """Registers and spill bytes per kernel of one source, from the
    compiler's report in ``build.log``: {entry: {...}}, each entry named by
    its mangled name cut to the kernel and its template arguments."""
    found, entry, section = {}, None, False
    with open(build_log) as f:
        for line in f:
            if line.startswith("== "):
                section = line.strip() == f"== {source}"
            elif section and "Compiling entry function" in line:
                tail = line.split("'")[1].split("_cu_", 1)[-1]
                entry = re.sub(r"^[0-9a-f]{8}\d+", "", tail).split("Ev")[0]
                found[entry] = {}
            elif section and entry and "spill stores" in line:
                nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
                found[entry].update(stack_bytes=nums[0], spill_stores=nums[1],
                                    spill_loads=nums[2])
            elif section and entry and "Used" in line and "registers" in line:
                found[entry]["registers"] = int(line.split("Used")[1].split()[0])
    return found


def check_flash(gen, results, build_log=None):
    import torch
    import torch.nn.functional as F

    from xkv_tpu_torch.ops.kernels import flash_attention as k1

    b = 1
    tol = TOL["K1"]
    worst, worst_rel = 0.0, 0.0
    timing = {}
    for hq, hkv, hd, s, window, timed in K1_CASES:
        scale = 1.0 / math.sqrt(hd)
        q = torch.randn((b, hq, s, hd), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((b, hkv, s, hd), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((b, hkv, s, hd), generator=gen, device="cuda").to(torch.bfloat16)
        out = k1.flash_attention(q, k, v, scale=scale, window=window)
        ref = k1.flash_attention_plain(q, k, v, scale=scale, window=window)
        torch.cuda.synchronize()
        err, rel = max_abs_err(out, ref), row_rel_err(out, ref)
        label = f"{hq}/{hkv} heads hd={hd} s={s} window={window}"
        log(f"K1 {label}: max_abs_err={err:.3e}, max_rel_err={rel:.3e} (limit {tol:.3e})")
        if not rel <= tol:
            raise AssertionError(f"K1 disagrees with its plain version at {label}")
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
        if timed:
            pairs = s * (s + 1) / 2
            ops = 4.0 * b * hq * hd * pairs
            bnd, by = bound_ms(nbytes(q, k, v, out), ops / BF16_OPS_PER_S)
            timing[hd] = dict(
                ms=cuda_time_ms(lambda: k1.flash_attention(q, k, v, scale=scale)),
                plain_ms=cuda_time_ms(
                    lambda: k1.flash_attention_plain(q, k, v, scale=scale), iters=2, warmup=1),
                library_ms=cuda_time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, scale=scale, enable_gqa=True)),
                bound_ms=bnd, bound_by=by)
            log(f"K1 {label} ms: " + ", ".join(f"{key} {val}" for key, val in timing[hd].items()))
    resources = ptxas_resources(build_log, "flash_attention.cu") if build_log else {}
    results["K1"] = dict(
        name="flash_attention", route="cuda", source="xkv_tpu_torch/csrc/flash_attention.cu",
        replaces="xkv_tpu/ops/pallas/flash_attention.py:118", max_abs_err=worst,
        max_rel_err=worst_rel, tol=f"{tol} of each row's max |ref|", **timing[128],
        hd64=timing[64], design=K1_DESIGN, ptxas=resources)


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


# K3/K5 shapes, (q heads, kv heads, head_dim, s_p, rank_k, rank_v): the
# Llama-3.1-8B xKV-4 layer and the Llama-3.2-1B one (head size 64; the 8B
# ranks at the same fraction of the group width, 2048 against 4096).
LOWRANK_SHAPES = {"8B": (32, 8, 128, 8192, 512, 768), "1B": (32, 8, 64, 8192, 256, 384)}
K2_DESIGN = ("stage 2 (the Hopper design; PR 8 measured a stage-1 mma.sync kernel first): one "
             "CTA per (key split, value slice, 32-row tile), 256-rank value slices when R <= 32, "
             "a producer warp loading q_emb and a ring of 64-key x 64-rank panels by TMA (as "
             "deep as shared memory allows), int8 and int4 widened to bf16 in shared memory, "
             "scores s^T = k_us . q_emb^T and t^T += v_us^T . P^T on wgmma (keys and ranks on "
             "M, tnspA), splits filling the SMs once; merge per (64-rank chunk, row); K4 and K6 "
             "run the same kernel")
MLA_DESIGN = ("stage 2 (the Hopper design; the first port was mma.sync scores and a "
              "CUDA-core value product over blocks staged in shared memory): K2's producer "
              "warp, TMA ring and two wgmma warpgroups, each 64-key block's k_pe and us panels "
              "in the ring, "
              "s^T = (us . q_emb^T) * r + k_pe . q_pe^T with r applied per key in registers, "
              "round_bf16(P * r) as wgmma's B operand of t^T += us^T . (P r)^T (tnspA); the "
              "block's us panels held in shared memory between the two products at one value "
              "slice (int8 / int4 widened to bf16 once), reloaded per 1024-rank value slice "
              "past 512 ranks; mla_split_count's splits; K2's merge per (64-rank chunk, row)")
K3_DESIGN = ("stage 2 (the Hopper design; stage 1 was mma.sync with a cp.async ring): one CTA "
             "per (kv head, 16-row tile, key split), the head's k_vt slice resident in shared "
             "memory, a producer warp filling a 4-stage TMA ring of k_us, [cos | sin] and v_us "
             "chunks, the key rebuild on wgmma (m64n64, hd 128; mma.sync at hd 64), scores "
             "and P @ v_us on mma.sync; merge per (head, 64-rank chunk), the last chunk CTA "
             "summing; k_vt slices too large to stay resident stream through a cp.async ring")


def _lowrank_timing(run, plain, in_bytes, recon, rest, int8):
    """Kernel and plain times of one K3/K5 call, and its bound: the rebuild's
    operations at the factors' tensor-core rate (int8 or bf16), the rest at
    bf16's."""
    ops_s = recon / (INT8_OPS_PER_S if int8 else BF16_OPS_PER_S) + rest / BF16_OPS_PER_S
    return dict(ms=cuda_time_ms(run), plain_ms=cuda_time_ms(plain),
                bound=bound_ms(in_bytes, ops_s))


def _lowrank_extra(timing, key, build_log):
    """The K3/K5 record's readings beyond the 8B bf16 call: 8B int8, the 1B
    shape (bf16, int8), the design, where k_vt lives, and registers."""
    from xkv_tpu_torch.ops.kernels import lowrank_attention as k3

    kvt = {f"{shape} {dt}": ("streamed" if k3.streams_kvt(hd, rk, dt == "int8") else "resident")
           for shape, (_, _, hd, _, rk, _) in LOWRANK_SHAPES.items() for dt in ("bf16", "int8")}
    return dict(int8=_row(timing[(key, "8B", "int8")]),
                hd64={dt: _row(timing[(key, "1B", dt)]) for dt in ("bf16", "int8")},
                design=K3_DESIGN, k_vt=kvt,
                ptxas=ptxas_resources(build_log, "lowrank_attention.cu") if build_log else {})


def check_decode(gen, results, build_log=None):
    """K2 at the 8B xKV-4 shapes and K3 at the 8B and 1B ones (layer 1 of a
    4-layer group)."""
    import torch

    import torch.nn.functional as F

    from xkv_tpu_torch.cache import vt_layer_slice
    from xkv_tpu_torch.ops.kernels import lowrank_attention as k3
    from xkv_tpu_torch.ops.kernels import rankspace_attention as k2
    from xkv_tpu_torch.ops.rope import rope_cos_sin

    worst = {key: {"abs": 0.0, "rel": 0.0, "lse": 0.0} for key in ("K2", "K3")}
    timing = {}
    for shape, (hq, hkv, hd, s_p, rk, rv) in LOWRANK_SHAPES.items():
        m = hkv * hd
        scale = 1.0 / math.sqrt(hd)
        cos_p, sin_p = rope_cos_sin(torch.arange(s_p, device="cuda"), hd, 500000.0)
        for dtype in ("bf16", "int8"):
            f = _decode_inputs(gen, s_p, rk, rv, m, dtype)
            vt_k = vt_layer_slice(f["k_vt"], 1, hkv, hd)
            vt_v = vt_layer_slice(f["v_vt"], 1, hkv, hd)
            k_scale = None if f["k_scale"] is None else vt_layer_slice(f["k_scale"], 1, hkv, hd)
            # ql 8: a speculative verify pass (draft_k 7), R 256 at 8B.
            for ql, lens, lo in ((1, None, None), (4, s_p - 300, 1000), (1, s_p - 37, 4100),
                                 (8, None, None)):
                lengths = None if lens is None else torch.tensor([lens], device="cuda")
                win_lo = None if lo is None else torch.tensor([lo], device="cuda")
                q = torch.randn((1, hq, ql, hd), generator=gen, device="cuda").to(torch.bfloat16)
                label = f"{shape} {dtype} ql={ql} valid_len={lens} win_lo={lo}"
                if shape == "8B":
                    # K2: the kernel proper (scores, softmax, t = P @ v_us).
                    q_emb = k2._project_q(q, vt_k, hkv, scale, k_scale, torch.bfloat16)
                    t, lse = k2.rankspace_kernel(q_emb, f["k_us"], f["v_us"], lengths, win_lo)
                    t_ref, lse_ref = k2.rankspace_kernel_plain(q_emb, f["k_us"], f["v_us"],
                                                               lengths, win_lo)
                    torch.cuda.synchronize()
                    _hold("K2", label, t, t_ref, lse, lse_ref, worst["K2"])
                # K3: query embeds at position s_p + 5.
                cos_t, sin_t = rope_cos_sin(s_p + 5 + torch.arange(ql, device="cuda")[None],
                                            hd, 500000.0)
                cos_h, sin_h = k3.half_tables(cos_p, sin_p, f["k_us"].dtype)
                qab = k3._query_embeds(q, cos_t, sin_t, hkv, scale, k_scale)
                args = (qab, f["k_us"], vt_k, f["v_us"], vt_v, cos_h, sin_h, f["v_scale"],
                        lengths, win_lo)
                kw = dict(num_q_heads=hq, num_kv_heads=hkv)
                o3, l3 = k3.lowrank_kernel(*args, **kw)
                o3_ref, l3_ref = k3.lowrank_kernel_plain(*args, **kw)
                torch.cuda.synchronize()
                _hold("K3", label, o3, o3_ref, l3, l3_ref, worst["K3"])
                if ql == 1 and lens is None:
                    # The main path's shapes: one query row per head.
                    live = s_p
                    if shape == "8B":
                        # K2 at R 32 (ql 1), R 128 (ql 4) and R 256 (ql 8, a
                        # speculative verify pass at draft_k 7); the library
                        # time at R 32, bf16: SDPA over the same rank-space
                        # operands, scale 1.
                        q_more = [k2._project_q(
                            torch.randn((1, hq, n, hd), generator=gen, device="cuda").to(
                                torch.bfloat16), vt_k, hkv, scale, k_scale, torch.bfloat16)
                            for n in (4, 8)]
                        for qe in [q_emb] + q_more:
                            R = qe.shape[1]
                            t_r, lse_r = k2.rankspace_kernel(qe, f["k_us"], f["v_us"])
                            timing[("K2", dtype, R)] = dict(
                                ms=cuda_time_ms(lambda: k2.rankspace_kernel(qe, f["k_us"],
                                                                            f["v_us"])),
                                plain_ms=cuda_time_ms(lambda: k2.rankspace_kernel_plain(
                                    qe, f["k_us"], f["v_us"])),
                                bound=bound_ms(nbytes(qe, f["k_us"], f["v_us"], t_r, lse_r),
                                               2.0 * R * live * (rk + rv) / BF16_OPS_PER_S))
                            log(f"K2 {dtype} R {R} ms: {timing[('K2', dtype, R)]}")
                        if dtype == "bf16":
                            q4, k4, v4 = q_emb[:, None], f["k_us"][:, None], f["v_us"][:, None]
                            timing["K2"] = dict(timing[("K2", dtype, 32)], library_ms=cuda_time_ms(
                                lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)))
                    R = qab.shape[1]
                    # Inputs as the kernel reads them: vt slices are rk x m
                    # and rv x m of the group's wider bases.
                    slice_bytes = rk * m * vt_k.element_size() + rv * m * 2
                    timing[("K3", shape, dtype)] = _lowrank_timing(
                        lambda: k3.lowrank_kernel(*args, **kw),
                        lambda: k3.lowrank_kernel_plain(*args, **kw),
                        nbytes(qab, f["k_us"], f["v_us"], cos_h, sin_h, o3, l3) + slice_bytes,
                        2.0 * live * rk * m,
                        2.0 * R * live * (2 * hd + rv) + 2.0 * R * rv * hd, dtype == "int8")
                    log(f"K3 {shape} {dtype} ms: {timing[('K3', shape, dtype)]}")
    timing["K3"] = timing[("K3", "8B", "bf16")]
    for key, name, src, rep in (
        ("K2", "rankspace_decode_attention", "xkv_tpu_torch/csrc/rankspace_attention.cu",
         "xkv_tpu/ops/pallas/rankspace_attention.py:285"),
        ("K3", "lowrank_decode_attention", "xkv_tpu_torch/csrc/lowrank_attention.cu",
         "xkv_tpu/ops/pallas/lowrank_attention.py:343"),
    ):
        _report(results, key, name, src, rep, worst[key], timing[key])
    results["K3"].update(_lowrank_extra(timing, "K3", build_log))
    results["K2"].update(
        int8=_row(timing[("K2", "int8", 32)]),
        r128={dt: _row(timing[("K2", dt, 128)]) for dt in ("bf16", "int8")},
        r256={dt: _row(timing[("K2", dt, 256)]) for dt in ("bf16", "int8")},
        design=K2_DESIGN,
        ptxas=ptxas_resources(build_log, "rankspace_attention.cu") if build_log else {})


def _row(t):
    """A kernel's readings beyond the main record: ms, plain ms, bound."""
    return dict(ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound"][0],
                bound_by=t["bound"][1])


def bytes_per_row(*ts) -> int:
    return sum(t.shape[-1] * t.element_size() for t in ts)


def _report(results, key, name, src, rep, worst, timing):
    bnd, by = timing["bound"]
    results[key] = dict(name=name, route="cuda", source=src, replaces=rep,
                        max_abs_err=worst["abs"], max_rel_err=worst["rel"],
                        max_lse_err=worst["lse"],
                        tol=f"{TOL[key]} of each row's max |ref|; lse {TOL['lse']} of max(1, |lse|)",
                        ms=timing["ms"], plain_ms=timing["plain_ms"], bound_ms=bnd,
                        bound_by=by, library_ms=timing.get("library_ms"))


def _hold(key, label, out, ref, lse, lse_ref, worst):
    a, r, e = max_abs_err(out, ref), row_rel_err(out, ref), lse_err(lse, lse_ref)
    log(f"{key} {label}: max_abs_err={a:.3e} max_rel_err={r:.3e} (limit {TOL[key]:.3e}) "
        f"lse_err={e:.3e} (limit {TOL['lse']:.0e})")
    if not (r <= TOL[key] and e <= TOL["lse"]):
        raise AssertionError(f"{key} disagrees with its reference ({label})")
    worst["abs"], worst["rel"] = max(worst["abs"], a), max(worst["rel"], r)
    worst["lse"] = max(worst["lse"], e)


def check_sparse_and_mixed(gen, results, build_log=None):
    """K4 and K5 (top-k of 512-row chunks) and K6 (mixed int8+int4 at the
    8B split 256 + 256 / 256 + 512) at the 8B xKV-4 shapes, K5 also at the
    1B ones, layer 1 of a 4-layer group, one query row per head."""
    import torch
    import torch.nn.functional as F

    from xkv_tpu_torch.cache import vt_layer_slice
    from xkv_tpu_torch.compress.quant import (
        quantize_k_factors_mixed4,
        quantize_v_factors_mixed4,
    )
    from xkv_tpu_torch.ops.kernels import lowrank_attention as k3
    from xkv_tpu_torch.ops.kernels import rankspace_attention as k2
    from xkv_tpu_torch.ops.rope import rope_cos_sin

    block = 512
    dev = "cuda"
    worst = {key: {"abs": 0.0, "rel": 0.0, "lse": 0.0} for key in ("K4", "K5", "K6")}
    timing = {}
    # (ids, valid_len, win_lo): the main path's top-4; a chunk wholly and
    # one partly past valid_len; a window that cuts chunk 8 and drops
    # chunk 2; the adaptive budget's low step (-1: no chunk).
    for shape, (hq, hkv, hd, s_p, rk, rv) in LOWRANK_SHAPES.items():
        m = hkv * hd
        scale = 1.0 / math.sqrt(hd)
        cos_p, sin_p = rope_cos_sin(torch.arange(s_p, device=dev), hd, 500000.0)
        cos_t, sin_t = rope_cos_sin(s_p + 5 + torch.arange(1, device=dev)[None], hd, 500000.0)
        cases = [([0, 5, 11, 15], None, None), ([15, 3, 14, 0], s_p - 600, None),
                 ([8, 2, 12, 15], None, 4100), ([3, 9, 15, 0, -1, -1, -1, -1], None, None)]
        for dtype in ("bf16", "int8"):
            f = _decode_inputs(gen, s_p, rk, rv, m, dtype)
            vt_k = vt_layer_slice(f["k_vt"], 1, hkv, hd)
            vt_v = vt_layer_slice(f["v_vt"], 1, hkv, hd)
            k_scale = None if f["k_scale"] is None else vt_layer_slice(f["k_scale"], 1, hkv, hd)
            q = torch.randn((1, hq, 1, hd), generator=gen, device=dev).to(torch.bfloat16)
            q_emb = k2._project_q(q, vt_k, hkv, scale, k_scale, torch.bfloat16)
            cos_h, sin_h = k3.half_tables(cos_p, sin_p, f["k_us"].dtype)
            qab = k3._query_embeds(q, cos_t, sin_t, hkv, scale, k_scale)
            kw = dict(num_q_heads=hq, num_kv_heads=hkv)
            for ids_l, lens, lo in cases:
                ids = torch.tensor([ids_l], dtype=torch.int32, device=dev)
                lengths = None if lens is None else torch.tensor([lens], device=dev)
                win_lo = None if lo is None else torch.tensor([lo], device=dev)
                label = f"{shape} {dtype} ids={ids_l} valid_len={lens} win_lo={lo}"
                a4 = (q_emb, f["k_us"], f["v_us"], ids, block, lengths, win_lo)
                if shape == "8B":
                    t4, l4 = k2.sparse_rankspace_kernel(*a4)
                    t4r, l4r = k2.sparse_rankspace_kernel_plain(*a4)
                a5 = (qab, f["k_us"], vt_k, f["v_us"], vt_v, cos_h, sin_h, f["v_scale"], ids,
                      block, lengths, win_lo)
                o5, l5 = k3.sparse_lowrank_kernel(*a5, **kw)
                o5r, l5r = k3.sparse_lowrank_kernel_plain(*a5, **kw)
                torch.cuda.synchronize()
                if shape == "8B":
                    _hold("K4", label, t4, t4r, l4, l4r, worst["K4"])
                _hold("K5", label, o5, o5r, l5, l5r, worst["K5"])
                if ids_l != cases[0][0]:
                    continue
                # The main path's shapes: top-4 chunks.
                live = len(ids_l) * block
                if shape == "8B" and dtype == "bf16":
                    # Library: SDPA over the whole segment, the rows of the
                    # selected chunks let through by a boolean mask.
                    rows = torch.zeros((1, 1, 1, s_p), dtype=torch.bool, device=dev)
                    for i in ids_l:
                        rows[..., i * block:(i + 1) * block] = True
                    q4, k4, v4 = q_emb[:, None], f["k_us"][:, None], f["v_us"][:, None]
                    timing["K4"] = dict(
                        ms=cuda_time_ms(lambda: k2.sparse_rankspace_kernel(*a4)),
                        plain_ms=cuda_time_ms(lambda: k2.sparse_rankspace_kernel_plain(*a4)),
                        library_ms=cuda_time_ms(lambda: F.scaled_dot_product_attention(
                            q4, k4, v4, attn_mask=rows, scale=1.0)),
                        bound=bound_ms(nbytes(q_emb, ids, t4, l4)
                                       + live * bytes_per_row(f["k_us"], f["v_us"]),
                                       2.0 * hq * live * (rk + rv) / BF16_OPS_PER_S))
                slice_bytes = rk * m * vt_k.element_size() + rv * m * 2
                timing[("K5", shape, dtype)] = _lowrank_timing(
                    lambda: k3.sparse_lowrank_kernel(*a5, **kw),
                    lambda: k3.sparse_lowrank_kernel_plain(*a5, **kw),
                    nbytes(qab, ids, o5, l5) + slice_bytes
                    + live * bytes_per_row(f["k_us"], f["v_us"], cos_h, sin_h),
                    2.0 * live * rk * m, 2.0 * hq * live * (2 * hd + rv) + 2.0 * hq * rv * hd,
                    dtype == "int8")
                log(f"K5 {shape} {dtype} ms: {timing[('K5', shape, dtype)]}")
            if shape != "8B":
                continue
            # Every chunk selected: K4 reads the rows K2 reads.
            all_ids = torch.arange(s_p // block, dtype=torch.int32, device=dev).flip(0)[None]
            t4, l4 = k2.sparse_rankspace_kernel(q_emb, f["k_us"], f["v_us"], all_ids, block)
            t2, l2 = k2.rankspace_kernel(q_emb, f["k_us"], f["v_us"])
            torch.cuda.synchronize()
            _hold("K4", f"{dtype} all 16 chunks against K2", t4, t2, l4, l2, worst["K4"])
    timing["K5"] = timing[("K5", "8B", "bf16")]

    hq, hkv, hd, s_p, rk, rv = LOWRANK_SHAPES["8B"]
    m = hkv * hd
    scale = 1.0 / math.sqrt(hd)
    # K6: mixed factors at the 8B split.
    us_k = torch.randn((1, s_p, rk), generator=gen, device=dev)
    vt_kf = torch.randn((1, rk, 4 * m), generator=gen, device=dev) * 0.05
    us_v = torch.randn((1, s_p, rv), generator=gen, device=dev)
    vt_vf = torch.randn((1, rv, 4 * m), generator=gen, device=dev) * 0.05
    qk = quantize_k_factors_mixed4(us_k, vt_kf, 256)
    qv = quantize_v_factors_mixed4(us_v, vt_vf, 256)
    sl = lambda x: vt_layer_slice(x, 1, hkv, hd)  # noqa: E731
    for ql, lens, lo in ((1, None, None), (4, s_p - 300, 1000), (1, s_p - 37, 4100),
                         (8, None, None)):
        lengths = None if lens is None else torch.tensor([lens], device=dev)
        win_lo = None if lo is None else torch.tensor([lo], device=dev)
        q = torch.randn((1, hq, ql, hd), generator=gen, device=dev).to(torch.bfloat16)
        q_emb = torch.cat([k2._project_q(q, sl(qk.vt8), hkv, scale, sl(qk.out_scale),
                                         torch.bfloat16),
                           k2._project_q(q, sl(qk.vt4), hkv, scale, sl(qk.scale4),
                                         torch.bfloat16)], dim=2)
        a6 = (q_emb, qk.us8, qk.us4p, qv.us8, qv.us4p, lengths, win_lo)
        t6, l6 = k2.mixed_rankspace_kernel(*a6)
        t6r, l6r = k2.mixed_rankspace_kernel_plain(*a6)
        torch.cuda.synchronize()
        _hold("K6", f"ql={ql} valid_len={lens} win_lo={lo}", t6, t6r, l6, l6r, worst["K6"])
        if ql == 1 and lens is None:
            # R 32 (ql 1), R 128 (ql 4) and R 256 (ql 8, a speculative
            # verify pass at draft_k 7).
            q_more = []
            for n in (4, 8):
                qn = torch.randn((1, hq, n, hd), generator=gen, device=dev).to(torch.bfloat16)
                q_more.append(torch.cat([
                    k2._project_q(qn, sl(qk.vt8), hkv, scale, sl(qk.out_scale), torch.bfloat16),
                    k2._project_q(qn, sl(qk.vt4), hkv, scale, sl(qk.scale4), torch.bfloat16)],
                    dim=2))
            for qe in [q_emb] + q_more:
                a = (qe,) + a6[1:]
                t_r, l_r = k2.mixed_rankspace_kernel(*a)
                timing[("K6", qe.shape[1])] = dict(
                    ms=cuda_time_ms(lambda: k2.mixed_rankspace_kernel(*a)),
                    plain_ms=cuda_time_ms(lambda: k2.mixed_rankspace_kernel_plain(*a)),
                    bound=bound_ms(nbytes(qe, qk.us8, qk.us4p, qv.us8, qv.us4p, t_r, l_r),
                                   2.0 * qe.shape[1] * s_p * (rk + rv) / BF16_OPS_PER_S))
                log(f"K6 R {qe.shape[1]} ms: {timing[('K6', qe.shape[1])]}")
            timing["K6"] = timing[("K6", 32)]
    rs = "xkv_tpu/ops/pallas/rankspace_attention.py"
    for key, name, src, rep in (
        ("K4", "sparse_rankspace_decode_attention",
         "xkv_tpu_torch/csrc/rankspace_attention.cu", f"{rs}:423"),
        ("K5", "sparse_lowrank_decode_attention", "xkv_tpu_torch/csrc/lowrank_attention.cu",
         "xkv_tpu/ops/pallas/lowrank_attention.py:477"),
        ("K6", "rankspace_decode_attention (mixed int8+int4)",
         "xkv_tpu_torch/csrc/rankspace_attention.cu", f"{rs}:141"),
    ):
        _report(results, key, name, src, rep, worst[key], timing[key])
    results["K5"].update(_lowrank_extra(timing, "K5", build_log))
    results["K6"].update(r128=_row(timing[("K6", 128)]), r256=_row(timing[("K6", 256)]),
                         design=K2_DESIGN)
    results["K4"].update(design=K2_DESIGN)


def check_mla(gen, results):
    """K7 (bf16 and int8 latent factors) and K8 (256 int8 + 256 int4 ranks)
    at the DeepSeek-V2-Lite shapes: 16 heads, rank 512, RoPE key 64, s_p
    8192, one query row per head; also at a ragged length, ql = 2 and ql =
    8 (a speculative verify pass at draft_k 7). Then K7 as a speculative
    draft runs it: over the first 128 and 120 columns of the bf16 and int8
    factors, read in place."""
    import torch
    import torch.nn.functional as F

    from xkv_tpu_torch.compress.quant import (
        quantize_k_factors,
        quantize_k_factors_mixed4,
        unpack_int4_rows,
    )
    from xkv_tpu_torch.ops.kernels import rankspace_attention as k2

    nh, s_p, rk, rope = 16, 8192, 512, 64
    dev = "cuda"
    bf = torch.bfloat16
    worst = {key: {"abs": 0.0, "rel": 0.0, "lse": 0.0} for key in ("K7", "K8")}
    timing = {}
    us_f = torch.randn((1, s_p, rk), generator=gen, device=dev)
    vt_f = torch.randn((1, rk, 4 * rk), generator=gen, device=dev) * 0.05
    k_pe = torch.randn((1, s_p, rope), generator=gen, device=dev).to(bf)
    r = torch.rand((1, s_p), generator=gen, device=dev) + 0.5
    q4 = quantize_k_factors_mixed4(us_f, vt_f, 256)
    factors = {"bf16": ("K7", us_f.to(bf), None),
               "int8": ("K7", quantize_k_factors(us_f, vt_f).us_q, None),
               "int8+int4": ("K8", q4.us8, q4.us4p)}
    for dtype, (key, us, us4) in factors.items():
        us_all = us if us4 is None else torch.cat([us, unpack_int4_rows(us4)], dim=-1)
        # Scores of a few units: q_emb against us rows of its own scale.
        sigma = 1.5 / (math.sqrt(rk) * us_all.float().std().item())
        for ql, lens in ((1, None), (1, s_p - 300), (2, None), (8, None)):
            R = ql * nh
            lengths = None if lens is None else torch.tensor([lens], device=dev)
            qe = (torch.randn((1, R, rk), generator=gen, device=dev) * sigma).to(bf)
            qp = (torch.randn((1, R, rope), generator=gen, device=dev) * 0.1).to(bf)
            if us4 is None:
                args = (qe, qp, us, k_pe, r, lengths)
                run, plain = k2.mla_rankspace_kernel, k2.mla_rankspace_kernel_plain
            else:
                args = (qe, qp, us, us4, k_pe, r, lengths)
                run, plain = k2.mla_mixed_rankspace_kernel, k2.mla_mixed_rankspace_kernel_plain
            t, lse = run(*args)
            t_ref, lse_ref = plain(*args)
            torch.cuda.synchronize()
            _hold(key, f"{dtype} ql={ql} valid_len={lens}", t, t_ref, lse, lse_ref, worst[key])
            if lens is not None:
                continue
            # Timed at full length: the main path's shapes (bf16 factors
            # and the int4 run at ql 1); int8, ql 2 and ql 8 as extra rows. K7
            # has SDPA beside it on prebuilt operands, q = [q_emb | q_pe],
            # k = [r * us | k_pe], v = r * us, scale 1; K8 none, as K6:
            # no one call takes the packed int4 ranks.
            ops = 2.0 * R * s_p * (2 * rk + rope)
            row = dict(ms=cuda_time_ms(lambda: run(*args)),
                       plain_ms=cuda_time_ms(lambda: plain(*args)),
                       bound=bound_ms(nbytes(qe, qp, us, us4, k_pe, r, t, lse),
                                      ops / BF16_OPS_PER_S))
            if ql == 1 and dtype == "int8+int4":
                timing[key] = row
            elif ql == 1 and dtype == "bf16":
                rus = (r[..., None] * us_all.float()).to(bf)
                lq = torch.cat([qe, qp], dim=-1)[:, None]
                lk = torch.cat([rus, k_pe], dim=-1)[:, None]
                lv = rus[:, None]
                row["library_ms"] = cuda_time_ms(
                    lambda: F.scaled_dot_product_attention(lq, lk, lv, scale=1.0))
                timing[key] = row
            else:
                timing[f"{key} {dtype} ql {ql}"] = _row(row)
    # A draft step's K7 (one token of 16 heads): the factors' first
    # ``width`` columns through their row stride, q_emb zero past ``width``
    # up to ``rank_width`` (as ``mla_rankspace_decode_attention`` pads it);
    # the kernel zero-fills the rank columns past 120.
    for dtype in ("bf16", "int8"):
        us = factors[dtype][1]
        for width in (128, 120):
            view = us[..., :width]
            sigma = 1.5 / (math.sqrt(width) * view.float().std().item())
            qe = F.pad(torch.randn((1, nh, width), generator=gen, device=dev) * sigma,
                       (0, k2.rank_width(width) - width)).to(bf)
            qp = (torch.randn((1, nh, rope), generator=gen, device=dev) * 0.1).to(bf)
            args = (qe, qp, view, k_pe, r)
            t, lse = k2.mla_rankspace_kernel(*args)
            t_ref, lse_ref = k2.mla_rankspace_kernel_plain(*args)
            torch.cuda.synchronize()
            _hold("K7", f"{dtype} draft view of {width} ranks ql=1", t, t_ref, lse, lse_ref,
                  worst["K7"])
            row = dict(ms=cuda_time_ms(lambda: k2.mla_rankspace_kernel(*args)),
                       plain_ms=cuda_time_ms(lambda: k2.mla_rankspace_kernel_plain(*args)),
                       bound=bound_ms(nbytes(qe, qp, view, k_pe, r, t, lse),
                                      2.0 * nh * s_p * (2 * width + rope) / BF16_OPS_PER_S))
            timing[f"K7 {dtype} draft view {width}"] = _row(row)
    rs = "xkv_tpu/ops/pallas/rankspace_attention.py"
    for key, name, rep in (
        ("K7", "mla_rankspace_decode_attention", f"{rs}:788"),
        ("K8", "mla_rankspace_decode_attention (mixed int8+int4)", f"{rs}:766"),
    ):
        _report(results, key, name, "xkv_tpu_torch/csrc/rankspace_attention.cu", rep,
                worst[key], timing[key])
        results[key].update(design=MLA_DESIGN, **{
            label.split(" ", 1)[1]: row for label, row in timing.items()
            if label.startswith(key + " ")})


# ------------------------------------------------------------ wide ranks
# The widest ranks the JAX kernels' layout gives the repo's models: K2, K4
# and K6 at rk = rv = 4096 (Llama-3.1-8B xKV-4's full rank, 4 layers x 8
# kv heads x 128) and rv 1536 at R 128; K3 and K5 at rv 1536 and 4096 (head
# sizes 128 and 64, the main path's rank_k); K7 and K8 at rank 2048
# (DeepSeek-V2-Lite's full rank in groups of 4). All at s_p 8192.
WIDE_S = 8192


def _wide_time(results, key, label, run, plain, in_bytes, ops_s):
    """Time one wide case beside its plain version and bound; kept in the
    kernel's record under ``wide``."""
    t = dict(ms=cuda_time_ms(run, iters=5, warmup=1),
             plain_ms=cuda_time_ms(plain, iters=3, warmup=1),
             bound=bound_ms(in_bytes, ops_s))
    results[key].setdefault("wide", {})[label] = _row(t)
    log(f"{key} wide {label} ms: {_row(t)}")


def check_wide(gen, results):
    """K2-K8 past the ranks their single CTA holds (value slices; K2/K4/K6
    q_emb streamed beside the key panels at rk 4096), held against their
    plain versions with the main path's limits, and timed."""
    import torch

    from xkv_tpu_torch.cache import vt_layer_slice
    from xkv_tpu_torch.compress.quant import pack_int4_pairs, unpack_int4_rows
    from xkv_tpu_torch.ops.kernels import lowrank_attention as k3
    from xkv_tpu_torch.ops.kernels import rankspace_attention as k2
    from xkv_tpu_torch.ops.rope import rope_cos_sin

    dev, bf, s_p = "cuda", torch.bfloat16, WIDE_S
    worst = {key: {"abs": 0.0, "rel": 0.0, "lse": 0.0}
             for key in ("K2", "K3", "K4", "K5", "K6", "K7", "K8")}

    def ints(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, device=dev).to(torch.int8)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    ids = torch.tensor([[0, 5, 11, 15]], dtype=torch.int32, device=dev)
    # K2, K4: (R, rk, rv), bf16 and int8 factors; scores of a few tenths.
    for R, rk, rv in ((32, 4096, 4096), (128, 512, 1536)):
        for dtype in ("bf16", "int8"):
            if dtype == "bf16":
                k_us, v_us, sc = randn(1, s_p, rk).to(bf), randn(1, s_p, rv).to(bf), 0.5
            else:
                k_us, v_us = ints((1, s_p, rk), -127, 128), ints((1, s_p, rv), -127, 128)
                sc = 0.5 / 73
            q = (randn(1, R, rk) * (sc / rk ** 0.5)).to(bf)
            label = f"{dtype} R {R} rk {rk} rv {rv}"
            t, lse = k2.rankspace_kernel(q, k_us, v_us, torch.tensor([s_p - 37], device=dev))
            tr, lr = k2.rankspace_kernel_plain(q, k_us, v_us,
                                               torch.tensor([s_p - 37], device=dev))
            torch.cuda.synchronize()
            _hold("K2", label, t, tr, lse, lr, worst["K2"])
            _wide_time(results, "K2", label, lambda: k2.rankspace_kernel(q, k_us, v_us),
                       lambda: k2.rankspace_kernel_plain(q, k_us, v_us),
                       nbytes(q, k_us, v_us, t, lse), 2.0 * R * s_p * (rk + rv) / BF16_OPS_PER_S)
            if R == 32:
                a4 = (q, k_us, v_us, ids, 512)
                t4, l4 = k2.sparse_rankspace_kernel(*a4)
                t4r, l4r = k2.sparse_rankspace_kernel_plain(*a4)
                torch.cuda.synchronize()
                _hold("K4", label, t4, t4r, l4, l4r, worst["K4"])
                live = 4 * 512
                _wide_time(results, "K4", label, lambda: k2.sparse_rankspace_kernel(*a4),
                           lambda: k2.sparse_rankspace_kernel_plain(*a4),
                           nbytes(q, ids, t4, l4) + live * bytes_per_row(k_us, v_us),
                           2.0 * R * live * (rk + rv) / BF16_OPS_PER_S)
    # K6: rk = rv = 4096 as 2048 int8 + 2048 int4 ranks each, R 32.
    k8, k4 = ints((1, s_p, 2048), -127, 128), pack_int4_pairs(ints((1, s_p, 2048), -7, 8))
    v8, v4 = ints((1, s_p, 2048), -127, 128), pack_int4_pairs(ints((1, s_p, 2048), -7, 8))
    q = (randn(1, 32, 4096) * (0.5 / 64 / 40)).to(bf)
    a6 = (q, k8, k4, v8, v4)
    t6, l6 = k2.mixed_rankspace_kernel(*a6)
    t6r, l6r = k2.mixed_rankspace_kernel_plain(*a6)
    torch.cuda.synchronize()
    _hold("K6", "R 32 rk 4096 rv 4096", t6, t6r, l6, l6r, worst["K6"])
    _wide_time(results, "K6", "R 32 rk 4096 rv 4096", lambda: k2.mixed_rankspace_kernel(*a6),
               lambda: k2.mixed_rankspace_kernel_plain(*a6), nbytes(*a6, t6, l6),
               2.0 * 32 * s_p * 8192 / BF16_OPS_PER_S)
    del k8, k4, v8, v4, a6
    # K3, K5: (hq, hkv, hd, rk, rv) at head sizes 128 and 64, layer 1 of a
    # 4-layer group, query embeds at position s_p + 5 as check_decode's.
    for hq, hkv, hd, rk, rv in ((32, 8, 128, 512, 1536), (32, 8, 128, 512, 4096),
                                (32, 8, 64, 256, 1536), (32, 8, 64, 256, 4096)):
        m = hkv * hd
        cos_p, sin_p = rope_cos_sin(torch.arange(s_p, device=dev), hd, 500000.0)
        cos_t, sin_t = rope_cos_sin(s_p + 5 + torch.arange(1, device=dev)[None], hd, 500000.0)
        for dtype in ("bf16", "int8"):
            f = _decode_inputs(gen, s_p, rk, rv, m, dtype)
            vt_k = vt_layer_slice(f["k_vt"], 1, hkv, hd)
            vt_v = vt_layer_slice(f["v_vt"], 1, hkv, hd)
            k_scale = None if f["k_scale"] is None else vt_layer_slice(f["k_scale"], 1, hkv, hd)
            cos_h, sin_h = k3.half_tables(cos_p, sin_p, f["k_us"].dtype)
            q = randn(1, hq, 1, hd).to(bf)
            qab = k3._query_embeds(q, cos_t, sin_t, hkv, 1.0 / math.sqrt(hd), k_scale)
            kw = dict(num_q_heads=hq, num_kv_heads=hkv)
            a = (qab, f["k_us"], vt_k, f["v_us"], vt_v, cos_h, sin_h, f["v_scale"])
            label = f"{dtype} hd {hd} rk {rk} rv {rv}"
            lengths = torch.tensor([s_p - 300], device=dev)
            o3, l3 = k3.lowrank_kernel(*a, lengths, None, **kw)
            o3r, l3r = k3.lowrank_kernel_plain(*a, lengths, None, **kw)
            o5, l5 = k3.sparse_lowrank_kernel(*a, ids, 512, None, None, **kw)
            o5r, l5r = k3.sparse_lowrank_kernel_plain(*a, ids, 512, None, None, **kw)
            torch.cuda.synchronize()
            _hold("K3", label, o3, o3r, l3, l3r, worst["K3"])
            _hold("K5", label, o5, o5r, l5, l5r, worst["K5"])
            if dtype == "bf16":
                slices = -(-rv // 1024)
                recon = 2.0 * s_p * rk * m
                _wide_time(results, "K3", label, lambda: k3.lowrank_kernel(*a, None, None, **kw),
                           lambda: k3.lowrank_kernel_plain(*a, None, None, **kw),
                           nbytes(qab, f["k_us"], f["v_us"], cos_h, sin_h, o3, l3)
                           + (rk + rv) * m * 2,
                           (recon + 2.0 * hq * s_p * (2 * hd + rv)) / BF16_OPS_PER_S)
                results["K3"]["wide"][label]["value_slices"] = slices
                live = 4 * 512
                _wide_time(results, "K5", label,
                           lambda: k3.sparse_lowrank_kernel(*a, ids, 512, None, None, **kw),
                           lambda: k3.sparse_lowrank_kernel_plain(*a, ids, 512, None, None, **kw),
                           nbytes(qab, ids, o5, l5) + (rk + rv) * m * 2
                           + live * bytes_per_row(f["k_us"], f["v_us"], cos_h, sin_h),
                           (2.0 * live * rk * m + 2.0 * hq * live * (2 * hd + rv))
                           / BF16_OPS_PER_S)
                results["K5"]["wide"][label]["value_slices"] = slices
            del f, a
    # K7 (bf16, int8) and K8 (1024 int8 + 1024 int4) at rank 2048, 16 heads.
    nh, rope, rk = 16, 64, 2048
    k_pe, r = randn(1, s_p, rope).to(bf), torch.rand((1, s_p), generator=gen, device=dev) + 0.5
    us8 = ints((1, s_p, rk), -127, 128)
    mixed = (ints((1, s_p, 1024), -127, 128), pack_int4_pairs(ints((1, s_p, 1024), -7, 8)))
    factors = {"bf16": ("K7", randn(1, s_p, rk).to(bf), None), "int8": ("K7", us8, None),
               "int8+int4": ("K8",) + mixed}
    for dtype, (key, us, us4) in factors.items():
        us_all = us if us4 is None else torch.cat([us, unpack_int4_rows(us4)], dim=-1)
        sigma = 1.5 / (math.sqrt(rk) * us_all.float().std().item())
        for ql in (1, 2):
            R = ql * nh
            qe = (randn(1, R, rk) * sigma).to(bf)
            qp = (randn(1, R, rope) * 0.1).to(bf)
            if us4 is None:
                args = (qe, qp, us, k_pe, r, torch.tensor([s_p - 300], device=dev))
                run, plain = k2.mla_rankspace_kernel, k2.mla_rankspace_kernel_plain
            else:
                args = (qe, qp, us, us4, k_pe, r, torch.tensor([s_p - 300], device=dev))
                run, plain = k2.mla_mixed_rankspace_kernel, k2.mla_mixed_rankspace_kernel_plain
            label = f"{dtype} ql {ql} rank {rk}"
            t, lse = run(*args)
            tr, lr = plain(*args)
            torch.cuda.synchronize()
            _hold(key, label, t, tr, lse, lr, worst[key])
            if ql == 1 and dtype != "int8":
                _wide_time(results, key, label, lambda: run(*args), lambda: plain(*args),
                           nbytes(qe, qp, us, us4, k_pe, r, t, lse),
                           2.0 * R * s_p * (2 * rk + rope) / BF16_OPS_PER_S)
    for key, w in worst.items():
        results[key]["wide_max_rel_err"] = w["rel"]
        results[key]["wide_max_lse_err"] = w["lse"]
    torch.cuda.empty_cache()


# ---------------------------------------------------- repaired limits
# K4/K5 chunk widths: each selected chunk is walked as ceil(width / 64)
# blocks of 64 keys masked at the chunk's end; at every width 2048 rows are
# selected, as by the main path's top-4 of 512-row chunks. Head sizes other
# than 64 and 128, which K1, K3 and K5 take zero-padded to 64: those of
# tiny_llama_config (16) and of the examples (24, 32).
CHUNK_WIDTHS = (16, 24, 100, 512)
PADDED_HEADS = (16, 24, 32)


def check_chunk_widths(gen, results):
    """K4 and K5 at the 8B shapes over chunks of 16, 24, 100 and 512 rows
    (2048 selected rows; the last chunk, ragged past s_p where the width
    does not divide it, always among them; int8 also with a valid_len and
    a window inside chunks) against their plain versions, and timed at
    widths 16 and 512 (bf16)."""
    import torch

    from xkv_tpu_torch.cache import vt_layer_slice
    from xkv_tpu_torch.ops.kernels import lowrank_attention as k3
    from xkv_tpu_torch.ops.kernels import rankspace_attention as k2
    from xkv_tpu_torch.ops.rope import rope_cos_sin

    hq, hkv, hd, s_p, rk, rv = LOWRANK_SHAPES["8B"]
    m = hkv * hd
    scale = 1.0 / math.sqrt(hd)
    dev = "cuda"
    cos_p, sin_p = rope_cos_sin(torch.arange(s_p, device=dev), hd, 500000.0)
    cos_t, sin_t = rope_cos_sin(s_p + 5 + torch.arange(1, device=dev)[None], hd, 500000.0)
    worst = {key: {"abs": 0.0, "rel": 0.0, "lse": 0.0} for key in ("K4", "K5")}
    times = {}
    pick = torch.Generator().manual_seed(SEED)
    for dtype in ("bf16", "int8"):
        f = _decode_inputs(gen, s_p, rk, rv, m, dtype)
        vt_k = vt_layer_slice(f["k_vt"], 1, hkv, hd)
        vt_v = vt_layer_slice(f["v_vt"], 1, hkv, hd)
        k_scale = None if f["k_scale"] is None else vt_layer_slice(f["k_scale"], 1, hkv, hd)
        q = torch.randn((1, hq, 1, hd), generator=gen, device=dev).to(torch.bfloat16)
        q_emb = k2._project_q(q, vt_k, hkv, scale, k_scale, torch.bfloat16)
        cos_h, sin_h = k3.half_tables(cos_p, sin_p, f["k_us"].dtype)
        qab = k3._query_embeds(q, cos_t, sin_t, hkv, scale, k_scale)
        kw = dict(num_q_heads=hq, num_kv_heads=hkv)
        for width in CHUNK_WIDTHS:
            n_chunks = -(-s_p // width)
            ids = torch.randperm(n_chunks, generator=pick)[:2048 // width]
            ids[0] = n_chunks - 1
            ids = ids.to(device=dev, dtype=torch.int32)[None]
            lengths = None if dtype == "bf16" else torch.tensor([s_p - 37], device=dev)
            win_lo = None if dtype == "bf16" else torch.tensor([100], device=dev)
            a4 = (q_emb, f["k_us"], f["v_us"], ids, width, lengths, win_lo)
            a5 = (qab, f["k_us"], vt_k, f["v_us"], vt_v, cos_h, sin_h, f["v_scale"], ids, width,
                  lengths, win_lo)
            t4, l4 = k2.sparse_rankspace_kernel(*a4)
            t4r, l4r = k2.sparse_rankspace_kernel_plain(*a4)
            o5, l5 = k3.sparse_lowrank_kernel(*a5, **kw)
            o5r, l5r = k3.sparse_lowrank_kernel_plain(*a5, **kw)
            torch.cuda.synchronize()
            label = f"{dtype} width {width}, {ids.shape[1]} chunks, valid_len={lengths}"
            _hold("K4", label, t4, t4r, l4, l4r, worst["K4"])
            _hold("K5", label, o5, o5r, l5, l5r, worst["K5"])
            if dtype == "bf16" and width in (16, 512):
                times[f"K4 width {width}"] = cuda_time_ms(lambda: k2.sparse_rankspace_kernel(*a4))
                times[f"K5 width {width}"] = cuda_time_ms(
                    lambda: k3.sparse_lowrank_kernel(*a5, **kw))
    log(f"K4/K5 over 2048 selected rows by chunk width (bf16, ms): {times}")
    for key in ("K4", "K5"):
        results[key]["chunk_widths"] = dict(
            widths=CHUNK_WIDTHS, rows_selected=2048, max_rel_err=worst[key]["rel"],
            max_lse_err=worst[key]["lse"],
            ms={w: times[f"{key} width {w}"] for w in (16, 512)})


def check_head_sizes(gen, results):
    """K1, K3 and K5 at head sizes 16, 24 and 32, which their wrappers
    zero-pad to 64 (K1 at the end of each head, K3 and K5 per RoPE half),
    against their plain versions at the unpadded size: K1 at 32/8 heads,
    s 2048, with and without a 512 window; K3 and K5 at 32/8 heads, s_p
    8192, rank_k 512 / rank_v 768, bf16 and int8, K5 over the 2048 rows of
    85 chunks of 24 (the last one ragged past s_p), as many rows as the
    main path's top-4 of 512-row chunks selects."""
    import torch

    from xkv_tpu_torch.cache import vt_layer_slice
    from xkv_tpu_torch.ops.kernels import flash_attention as k1
    from xkv_tpu_torch.ops.kernels import lowrank_attention as k3
    from xkv_tpu_torch.ops.rope import rope_cos_sin

    hq, hkv, _, s_p, rk, rv = LOWRANK_SHAPES["8B"]
    dev = "cuda"
    bf = torch.bfloat16
    worst = {key: {"abs": 0.0, "rel": 0.0, "lse": 0.0} for key in ("K1", "K3", "K5")}
    pick = torch.Generator().manual_seed(SEED)
    for hd in PADDED_HEADS:
        scale = 1.0 / math.sqrt(hd)
        for window in (None, 512):
            q = torch.randn((1, hq, 2048, hd), generator=gen, device=dev).to(bf)
            k = torch.randn((1, hkv, 2048, hd), generator=gen, device=dev).to(bf)
            v = torch.randn((1, hkv, 2048, hd), generator=gen, device=dev).to(bf)
            out = k1.flash_attention(q, k, v, scale=scale, window=window)
            ref = k1.flash_attention_plain(q, k, v, scale=scale, window=window)
            torch.cuda.synchronize()
            a, r = max_abs_err(out, ref), row_rel_err(out, ref)
            log(f"K1 hd {hd} window {window}: max_abs_err={a:.3e} max_rel_err={r:.3e} "
                f"(limit {TOL['K1']:.3e})")
            if not (tuple(out.shape) == (1, 2048, hq, hd) and r <= TOL["K1"]):
                raise AssertionError(f"K1 at head size {hd} disagrees with its plain version")
            worst["K1"]["abs"] = max(worst["K1"]["abs"], a)
            worst["K1"]["rel"] = max(worst["K1"]["rel"], r)
        m = hkv * hd
        cos_p, sin_p = rope_cos_sin(torch.arange(s_p, device=dev), hd, 500000.0)
        cos_t, sin_t = rope_cos_sin(s_p + 5 + torch.arange(1, device=dev)[None], hd, 500000.0)
        for dtype in ("bf16", "int8"):
            f = _decode_inputs(gen, s_p, rk, rv, m, dtype)
            vt_k = vt_layer_slice(f["k_vt"], 1, hkv, hd)
            vt_v = vt_layer_slice(f["v_vt"], 1, hkv, hd)
            k_scale = None if f["k_scale"] is None else vt_layer_slice(f["k_scale"], 1, hkv, hd)
            q = torch.randn((1, hq, 1, hd), generator=gen, device=dev).to(bf)
            cos_h, sin_h = k3.half_tables(cos_p, sin_p, f["k_us"].dtype)
            qab = k3._query_embeds(q, cos_t, sin_t, hkv, scale, k_scale)
            kw = dict(num_q_heads=hq, num_kv_heads=hkv)
            rest = (f["k_us"], vt_k, f["v_us"], vt_v, cos_h, sin_h, f["v_scale"])
            o3, l3 = k3.lowrank_kernel(qab, *rest, None, None, **kw)
            o3r, l3r = k3.lowrank_kernel_plain(qab, *rest, None, None, **kw)
            ids = torch.randperm(-(-s_p // 24), generator=pick)[:2048 // 24]
            ids[0] = -(-s_p // 24) - 1
            ids = ids.to(device=dev, dtype=torch.int32)[None]
            o5, l5 = k3.sparse_lowrank_kernel(qab, *rest, ids, 24, None, None, **kw)
            o5r, l5r = k3.sparse_lowrank_kernel_plain(qab, *rest, ids, 24, None, None, **kw)
            torch.cuda.synchronize()
            _hold("K3", f"hd {hd} {dtype}", o3, o3r, l3, l3r, worst["K3"])
            _hold("K5", f"hd {hd} {dtype} width 24", o5, o5r, l5, l5r, worst["K5"])
    for key in ("K1", "K3", "K5"):
        results[key]["padded_head_sizes"] = dict(
            head_dims=PADDED_HEADS, padded_to=64, max_rel_err=worst[key]["rel"],
            max_lse_err=worst[key]["lse"] if key != "K1" else None)


# ------------------------------------------------------------ kernel tools
K9_VARIANTS = ("two_gemm", "scratch_ab", "b512", "b2048")
K9_DESIGN = ("redesigned on K3's machinery: K3's resident split kernel (one CTA per kv head, "
             "16-row tile and key split, a producer warp keeping a TMA ring of k_us, "
             "[cos | sin] and v_us chunks full, the head's k_vt slice resident, the rebuild on "
             "wgmma m64n64, fp32 online softmax, P @ v_us, K3's merge) with another score "
             "stage, reading the compact embeds of each row's own head: two_gemm feeds K*cos "
             "and K*sin of each warpgroup's column half as wgmma register A operands (m64n16k16) "
             "against K-major [qa | qb] panels, the halves meeting in shared memory; scratch_ab "
             "stores [K*cos | K*sin] into a swizzled 64 x 2 hd panel (3-stage ring) and "
             "warpgroup 0 issues one wgmma chain of depth 2 hd; b<N> is scratch_ab with N keys "
             "a split")
K11_DESIGN = ("redesigned: a cluster of 8 CTAs per 64-row tile of x, each CTA's column "
              "slice of w resident in shared memory, its columns of x_{i+1} sent to every "
              "peer by st.async stores counted on the peer's mbarrier (no cluster barrier "
              "per product); wgmma (bf16 m64nNk16, s8 m64nNk32), mma.sync m16n8k64 s4 for "
              "int4")


def kernel_count(prof) -> int:
    """The number of kernel events a profiler trace holds."""
    from xkv_tpu_torch.utils.profiling import kernel_events

    return len(kernel_events(prof))


def split_and_merge_us(prof) -> dict:
    """Mean device time of a K3-machinery call's two kernels from a
    profiler trace: the split kernel's span (its total by name,
    ``profile_op_times``), and the merge's span past the split's end (the
    merge is launched as a programmatic dependent, so it starts early and
    its own span holds its wait for the split)."""
    from xkv_tpu_torch.utils.profiling import kernel_events, profile_op_times

    kernels = kernel_events(prof)
    splits = [e for e in kernels if "split_kernel" in e[0]]
    merges = [e for e in kernels if "merge_chunk_kernel" in e[0]]
    if not splits or len(splits) != len(merges):
        raise AssertionError(f"profiler: {len(splits)} split and {len(merges)} merge kernels")
    split_ms = sum(ms for name, ms in profile_op_times(prof).items() if "split_kernel" in name)
    return dict(split=split_ms * 1e3 / len(splits),
                merge=sum(max(m[2] - s[2], 0.0) for s, m in zip(splits, merges)) / len(splits))


def check_variants(gen, results):
    """K9: each design of K3's score stage at K3's main-path shapes (b 1, 32
    rows, s_p 8192, rank_k 512, rank_v 768), bf16 and int8 factors, held
    against K3's plain version and timed beside K3 (``prod``) in the same
    run; each call's device time split into the split kernel and the merge
    (profiler, warm L2). Returns K3's time over the int8 factors."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from xkv_tpu_torch.cache import vt_layer_slice
    from xkv_tpu_torch.ops.kernels import kernel_variants as k9
    from xkv_tpu_torch.ops.kernels import lowrank_attention as k3
    from xkv_tpu_torch.ops.rope import rope_cos_sin

    hq, hkv, hd, s_p, rk, rv = 32, 8, 128, 8192, 512, 768
    m = hkv * hd
    scale = 1.0 / math.sqrt(hd)
    worst = {"abs": 0.0, "rel": 0.0, "lse": 0.0}
    cos_p, sin_p = rope_cos_sin(torch.arange(s_p, device="cuda"), hd, 500000.0)
    cos_t, sin_t = rope_cos_sin(s_p + 5 + torch.arange(1, device="cuda")[None], hd, 500000.0)
    times, by_kernel = {}, {}
    for dtype in ("bf16", "int8"):
        f = _decode_inputs(gen, s_p, rk, rv, m, dtype)
        sl = lambda x: None if x is None else vt_layer_slice(x, 1, hkv, hd)  # noqa: E731
        q = torch.randn((1, hq, 1, hd), generator=gen, device="cuda").to(torch.bfloat16)
        cos_h, sin_h = k3.half_tables(cos_p, sin_p, f["k_us"].dtype)
        qab = k3._query_embeds(q, cos_t, sin_t, hkv, scale, sl(f["k_scale"]))
        rest = (f["k_us"], sl(f["k_vt"]), f["v_us"], sl(f["v_vt"]), cos_h, sin_h, f["v_scale"])
        kw = dict(num_q_heads=hq, num_kv_heads=hkv)
        o_ref, l_ref = k3.lowrank_kernel_plain(qab, *rest, None, None, **kw)
        calls = {"prod": lambda: k3.lowrank_kernel(qab, *rest, None, None, **kw)}
        for v in K9_VARIANTS:
            calls[v] = lambda v=v: k9.variant_kernel(qab, *rest, None, variant=v, **kw)
            o, lse = calls[v]()
            torch.cuda.synchronize()
            _hold("K9", f"{v} {dtype}", o, o_ref, lse, l_ref, worst)
        for v, call in calls.items():  # K3 and the variants in turns, twice
            times[(v, dtype)] = cuda_time_ms(call)
        for v, call in reversed(list(calls.items())):
            times[(v, dtype)] = (times[(v, dtype)] + cuda_time_ms(call)) / 2
        for v, call in calls.items():
            for attempt in range(2):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(10):
                        call()
                    torch.cuda.synchronize()
                try:
                    by_kernel[f"{v} {dtype}"] = split_and_merge_us(prof)
                    break
                except AssertionError as err:
                    # A trace with no kernel at all was seen once on a card
                    # whose other traces were whole: trace once more, and
                    # fail if that one holds none either.
                    if attempt or kernel_count(prof):
                        raise
                    log(f"K9 {v} {dtype}: {err}; tracing again")
        if dtype == "bf16":
            plain_ms = cuda_time_ms(lambda: k9.variant_kernel_plain(qab, *rest, None, **kw))
            recon = 2.0 * s_p * rk * m
            rest_ops = 2.0 * hq * s_p * (2 * hd + rv) + 2.0 * hq * rv * hd
            bound = bound_ms(nbytes(qab, *rest, o, lse), (recon + rest_ops) / BF16_OPS_PER_S)
    for dtype in ("bf16", "int8"):
        k3_ms = times[("prod", dtype)]
        log(f"K9 {dtype} ms/call (x K3): " + ", ".join(
            f"{v} {times[(v, dtype)]:.4f} ({times[(v, dtype)] / k3_ms:.2f})"
            for v in ("prod",) + K9_VARIANTS))
        log(f"K9 {dtype} device us per call, split kernel / merge past it (warm L2): " + ", ".join(
            f"{v} {by_kernel[f'{v} {dtype}']['split']:.1f} / "
            f"{by_kernel[f'{v} {dtype}']['merge']:.1f}" for v in ("prod",) + K9_VARIANTS))
    results["K9"] = dict(
        name="variant_attention (scratch_ab)", route="cuda",
        source="xkv_tpu_torch/csrc/kernel_variants.cu",
        replaces="scripts/kernel_variants.py:138", max_abs_err=worst["abs"],
        max_rel_err=worst["rel"], max_lse_err=worst["lse"],
        tol=f"{TOL['K9']} of each row's max |ref| (K3's plain version); lse {TOL['lse']}",
        ms=times[("scratch_ab", "bf16")], plain_ms=plain_ms, bound_ms=bound[0],
        bound_by=bound[1], library_ms=None,
        variants_ms={f"{v} {d}": t for (v, d), t in times.items()},
        us_by_kernel=by_kernel, design=K9_DESIGN)
    return times[("prod", "int8")]


K10_DESIGN = ("redesigned on K3's machinery: one CTA per key split, a producer warp loading "
              "the query panels once and per 64-key block the k_us rows and tables, then a "
              "4-stage TMA ring of k_vt panels (transposed to K-major once per call) and "
              "v_us rows; per kv head the rebuild on wgmma m64n128k32 s8, scale and RoPE in "
              "the accumulator registers, the rotated keys as the register A operand of "
              "S^T += K_h . q_h^T (wgmma m64n32k16); P @ v_us on wgmma; a merge over 128 CTAs")


def check_ablation(gen, results, k3_int8_ms):
    """K10: every stage set at b 1, s 8192 over int8 factors, held against
    its plain version at the kernel's split count and timed; prints what
    each set saves against ``full`` and against K3 (int8, same shapes)."""
    import torch

    from xkv_tpu_torch.ops.kernels import kernel_ablation as k10

    hq, hkv, hd, s, rk, rv = 32, 8, 128, 8192, 512, 768
    m = hkv * hd
    ops = k10.inputs(1, s, hq, hkv, hd, rk, rv, "cuda", seed=SEED)
    nsplit = k10.num_splits(1, s, torch.device("cuda"))
    worst = {"abs": 0.0, "rel": 0.0, "m": 0.0}
    times = {}
    for name, stages in k10.configs():
        tabs = k10.tables(s, hd, stages, "cuda")
        args = (*ops, *tabs, stages)
        out, mx = k10.ablation_step(*args, num_kv_heads=hkv, nsplit=nsplit)
        ref, m_ref = k10.ablation_step_plain(*args, num_kv_heads=hkv, nsplit=nsplit)
        torch.cuda.synchronize()
        a, r = max_abs_err(out, ref), row_rel_err(out, ref)
        inf = torch.isinf(m_ref)
        same_inf = torch.equal(torch.isinf(mx), inf)
        e = lse_err(mx[~inf], m_ref[~inf]) if bool((~inf).any()) else 0.0
        log(f"K10 {name}: max_abs_err={a:.3e} max_rel_err={r:.3e} (limit {TOL['K10']:.3e}) "
            f"m_err={e:.3e} (limit {TOL['lse']:.0e}), -inf where the plain version has it: "
            f"{same_inf}")
        if not (r <= TOL["K10"] and e <= TOL["lse"] and same_inf):
            raise AssertionError(f"K10 {name} disagrees with its plain version")
        worst["abs"], worst["rel"] = max(worst["abs"], a), max(worst["rel"], r)
        worst["m"] = max(worst["m"], e)
        times[name] = cuda_time_ms(lambda: k10.ablation_step(*args, num_kv_heads=hkv,
                                                             nsplit=nsplit))
        if name == "full":
            plain_ms = cuda_time_ms(lambda: k10.ablation_step_plain(
                *args, num_kv_heads=hkv, nsplit=nsplit), iters=3, warmup=1)
            op_time = (2.0 * s * rk * m / INT8_OPS_PER_S
                       + 2.0 * hq * s * (m + rv) / BF16_OPS_PER_S)
            bound = bound_ms(nbytes(*ops, *tabs, out, mx), op_time)
    # Where a `full` call's device time goes: the k_vt transpose, the split
    # kernel and the merge, from the profiler's kernel records (warm L2).
    from torch.profiler import ProfilerActivity, profile

    from xkv_tpu_torch.utils.profiling import profile_op_times

    a_full = (*ops, *k10.tables(s, hd, k10.ALL, "cuda"), k10.ALL)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            k10.ablation_step(*a_full, num_kv_heads=hkv, nsplit=nsplit)
        torch.cuda.synchronize()
    totals = profile_op_times(prof)
    by_kernel = {k: sum(ms for name, ms in totals.items() if k in name) * 1e3 / 10
                 for k in ("transpose_kvt_kernel", "ablation_split_kernel",
                           "ablation_merge_kernel")}
    log(f"K10 full, device us per call by kernel: {by_kernel}")
    full = times["full"]
    log(f"K10 stage costs (K3 int8 at these shapes {k3_int8_ms:.4f} ms):")
    for name, t in times.items():
        saves = "" if name == "full" else f"  (saves {full - t:7.4f} ms)"
        log(f"  {name:12s} {t:8.4f} ms/call{saves}  ({t / k3_int8_ms:5.2f} x K3)")
    results["K10"] = dict(
        name="kernel_ablation build_step (full)", route="cuda",
        source="xkv_tpu_torch/csrc/kernel_ablation.cu",
        replaces="scripts/kernel_ablation.py:197", max_abs_err=worst["abs"],
        max_rel_err=worst["rel"], max_m_err=worst["m"],
        tol=f"{TOL['K10']} of each row's max |ref|; m {TOL['lse']} of max(1, |m|)",
        ms=full, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1], library_ms=None,
        stages_ms=times, k3_int8_ms=k3_int8_ms, nsplit=nsplit, full_us_by_kernel=by_kernel,
        design=K10_DESIGN)


def check_probe(results):
    """K11: bf16, int8 and int4 chains of 256 products at M = K = 512 (the
    probe's shape) and at an M that gives every SM two 32-row tiles, held
    against the plain version and timed beside the library's calls; the
    rate against the published peak."""
    import torch

    from xkv_tpu_torch.ops.kernels import probe_int4 as k11
    from xkv_tpu_torch.scripts import probe_int4 as tool

    reps, k = 256, 512
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    peak = {"bf16": BF16_OPS_PER_S, "int8": INT8_OPS_PER_S, "int4": None}
    rows = {}
    worst = {"abs": 0.0, "rel": 0.0}
    for m in (512, 2 * 32 * n_sm):
        for kind in ("bf16", "int8", "int4"):
            x, w = tool.inputs(kind, torch.device("cuda"), m, k)
            got = k11.gemm_chain(x, w, reps, kind)
            ref = k11.gemm_chain_plain(x, w, reps, kind)
            torch.cuda.synchronize()
            a, r = max_abs_err(got, ref), row_rel_err(got, ref)
            ok = r <= TOL["K11"] if kind == "bf16" else bool(torch.equal(got, ref))
            rule = f"limit {TOL['K11']:.3e}" if kind == "bf16" else "bit-exact"
            log(f"K11 {kind} M={m} K={k} reps={reps}: max_abs_err={a:.3e} max_rel_err={r:.3e} "
                f"({rule}: {ok})")
            if not ok:
                raise AssertionError(f"K11 {kind} M={m} disagrees with its plain version")
            worst["abs"], worst["rel"] = max(worst["abs"], a), max(worst["rel"], r)
            ms = cuda_time_ms(lambda: k11.gemm_chain(x, w, reps, kind), iters=5, warmup=1)
            ops = 2.0 * m * k * k * reps
            rate = ops / (ms * 1e-3)
            share = rate / peak[kind] if peak[kind] else None
            row = dict(ms=ms, us_per_gemm=ms * 1e3 / reps, tops=rate / 1e12, peak_share=share)
            if kind == "bf16":
                row["library_ms"] = cuda_time_ms(
                    lambda: [torch.matmul(x, w) for _ in range(reps)], iters=3, warmup=1)
            elif kind == "int8":
                wc = w.t().contiguous().t()  # column-major, cuBLASLt's int8 layout
                row["library_ms"] = cuda_time_ms(
                    lambda: [torch._int_mm(x, wc) for _ in range(reps)], iters=3, warmup=1)
            if m == 512:
                row["plain_ms"] = cuda_time_ms(
                    lambda: k11.gemm_chain_plain(x, w, reps, kind), iters=3, warmup=1)
                row["bound"] = (bound_ms(nbytes(x, w, ref), ops / peak[kind]) if peak[kind]
                                else None)
            rows[f"{kind} M={m}"] = row
            log(f"K11 {kind} M={m}: {json.dumps(row)}; {row['us_per_gemm']:.3f} us/GEMM, "
                f"{row['tops']:.1f} TOP/s"
                + (f", {share:.1%} of the published peak" if share else ", no published peak"))
    base = rows["int8 M=512"]
    results["K11"] = dict(
        name="probe_int4 gemm chain (int8, M = K = 512, 256 products)", route="cuda",
        source="xkv_tpu_torch/csrc/probe_int4.cu", replaces="scripts/probe_int4.py:45",
        max_abs_err=worst["abs"], max_rel_err=worst["rel"],
        tol=f"int8/int4 bit-exact; bf16 {TOL['K11']} of each row's max |ref|",
        ms=base["ms"], plain_ms=base["plain_ms"], bound_ms=base["bound"][0],
        bound_by=base["bound"][1],
        library_ms=base["library_ms"], library="256 torch._int_mm calls on the same inputs",
        design=K11_DESIGN, cases=rows)


def tools_path(results) -> dict:
    """The kernel-study path: the four tools at their JAX defaults, in
    process through their ``main()``, with short runs; the launch counts
    read around it (K9, K10 and K11 must each launch)."""
    import gc

    import torch

    from xkv_tpu_torch.scripts import bench_kernel, kernel_ablation, kernel_variants, probe_int4

    t0 = time.time()
    reset_counts()
    bench_kernel.main(["--n", "2"])
    probe_int4.main(["--reps", "16"])
    kernel_ablation.main(["--n", "2"])
    variants = kernel_variants.main(["--n", "2", "--check"])
    torch.cuda.synchronize()
    if "b2048" not in variants:  # the JAX tool's default --variants, b2048 included
        raise AssertionError(f"tools: kernel_variants ran {sorted(variants)}")
    counts = read_counts()
    log(f"tools: {time.time() - t0:.1f} s, launches {counts}")
    for key in ("K3", "K9", "K10", "K11"):
        if counts[key] == 0:
            raise AssertionError(f"tools: {key} was not launched")
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------- main path
def main_runs(n_layers: int) -> list:
    """(label, mode, rope, factor dtype, tail_max, new tokens, engine
    options, kernel launches per decode step). The sparse runs take top-4
    of 512-row chunks (the JAX package's bench.py sparse configuration);
    "sparse-mixed" reads every 4th layer exactly (sparse_layers)."""
    import torch

    bf = torch.bfloat16
    L = n_layers
    top4 = dict(sparse_topk=4, sparse_block=512)
    mixed = dict(top4, sparse_layers=[l for l in range(L) if (l + 1) % 4 != 0])
    n_sp = len(mixed["sparse_layers"])
    return [
        ("none", "none", "pre", bf, 128, 32, {}, {}),
        ("fake pre", "fake", "pre", bf, 128, 32, {}, {}),
        ("factored pre bf16", "factored", "pre", bf, 128, 32, {}, {"K3": L}),
        ("factored pre int8", "factored", "pre", "int8", 128, 32, {}, {"K3": L}),
        ("factored post bf16", "factored", "post", bf, 128, 32, {}, {"K2": L}),
        ("factored post int8", "factored", "post", "int8", 128, 32, {}, {"K2": L}),
        ("factored pre bf16 refactorize", "factored", "pre", bf, 32, 48, {}, {"K3": L}),
        ("factored post int4 refactorize", "factored", "post", "int4", 32, 48, {}, {"K6": L}),
        ("factored post bf16 sparse top-4", "factored", "post", bf, 128, 32, top4, {"K4": L}),
        ("factored pre bf16 sparse top-4 refactorize", "factored", "pre", bf, 32, 48, top4,
         {"K5": L}),
        ("factored post int8 sparse-mixed top-4", "factored", "post", "int8", 128, 32, mixed,
         {"K4": n_sp, "K2": L - n_sp}),
        # The 24 sparse layers run the reference's plain sparse x int4 path.
        ("factored post int4 sparse-mixed top-4", "factored", "post", "int4", 128, 32, mixed,
         {"K6": L - n_sp}),
        ("factored post bf16 sparse top-4 max 8", "factored", "post", bf, 128, 32,
         dict(top4, sparse_topk_max=8), {"K4": L}),
    ]


def serve(eng, cfg, prompt, label, n_new, want, profiled):
    """One run of the main path, eager and then on the captured graph.

    Prefill alone (timed); the eager greedy loop of ``decode_step`` +
    argmax for ``n_new`` tokens, refactorising a full tail as ``generate``
    does (its first step's logits kept; its second step run under
    ``set_sync_debug_mode("error")``, so a step that waits for the device
    raises; its steps timed on the host clock, the folds left out); when
    ``profiled``, a few eager steps and graph replays under torch.profiler.
    Then ``generate``, which replays a captured CUDA graph of the step, with
    the launch counts read around it, which must equal ``want``, and its
    tokens, which must equal the eager loop's. Returns (row, counts,
    first-step logits)."""
    import torch

    s = prompt.shape[1]
    torch.cuda.synchronize()
    t0 = time.time()
    logits, cache = eng.prefill(prompt)
    torch.cuda.synchronize()
    prefill_s = time.time() - t0
    ratio = cache.compression_ratio(cfg)
    tok = logits[:, -1].argmax(-1)[:, None]
    eager, first = [tok], None
    pos, remaining, decode_s = s, n_new - 1, 0.0
    while remaining > 0:
        if cache.tail_count == cache.tail_max:
            cache = eng.refactorize(cache)
        n = min(remaining, cache.tail_max - cache.tail_count)
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(n):
            if len(eager) == 2:
                torch.cuda.set_sync_debug_mode("error")
            try:
                step_logits, cache = eng.decode_step(cache, tok, pos)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            if first is None:
                first = step_logits[0, -1].float()
            tok = step_logits[:, -1].argmax(-1)[:, None]
            eager.append(tok)
            pos += 1
        torch.cuda.synchronize()
        decode_s += time.time() - t0
        remaining -= n
    eager = torch.cat(eager, dim=1)
    log(f"{label}: one eager decode step without a host sync")
    decode_ms = decode_s * 1e3 / (n_new - 1)
    profiles = profile_decode(eng, cache, tok, pos, decode_ms) if profiled else (None, None)
    del cache, logits, step_logits
    # The entry point a user calls, with the launch counts read around it.
    reset_counts()
    out = eng.generate(prompt, n_new)
    torch.cuda.synchronize()
    counts = read_counts()
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")
    if tuple(out.shape) != (1, n_new) or not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"{label}: bad output tokens {out.shape}")
    if not torch.equal(out, eager):
        raise AssertionError(f"{label}: graph tokens {out.tolist()} differ from the eager "
                             f"loop's {eager.tolist()}")
    if not bool(torch.isfinite(first).all()):
        raise AssertionError(f"{label}: non-finite logits")
    replayed = [t for t in eng.last_timings if t.start is not None]
    graph_ms = (sum(t.replay_ms_per_step() * t.replays for t in replayed)
                / sum(t.replays for t in replayed))
    row = dict(run=label, prefill_s=prefill_s, decode_ms_per_token=decode_ms,
               decode_ms_per_token_graph=graph_ms,
               capture_ms=[t.capture_ms for t in eng.last_timings if t.capture_ms is not None],
               compression_ratio=ratio, launches=counts, graph_tokens_equal_eager=True,
               decode_profile=profiles[0], decode_profile_graph=profiles[1])
    log("main " + json.dumps(row))
    return row, counts, first


def main_path(results, beside=None):
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
    log(f"8B params: {sum(nbytes(t) for _, t in _leaves(params)) / 1e9:.2f} GB "
        f"in {time.time() - t0:.1f} s")
    s = 8192
    prompt = torch.randint(0, cfg.vocab_size, (1, s), generator=gen, device="cuda")
    totals = {key: 0 for key in COUNTERS}
    first_logits = {}
    rows = []

    def engine(mode, rope, fdt, tail_max, **kw):
        xkv = generate_consecutive_xkv_config(
            group_size=4, rank_k=512, rank_v=768, num_layers=cfg.num_layers,
            end_layer=cfg.num_layers - 1, extra_kwargs={"rope_mode": rope})
        return InferenceEngine(params, cfg, xkv, mode=mode, tail_max=tail_max,
                               factor_dtype=fdt, prefill_logits="last", device="cuda", **kw)

    for label, mode, rope, fdt, tail_max, n_new, kw, per_step in main_runs(cfg.num_layers):
        eng = engine(mode, rope, fdt, tail_max, **kw)
        want = {key: per_step.get(key, 0) * (n_new - 1) for key in COUNTERS}
        want["K1"] = cfg.num_layers
        row, counts, first_logits[label] = serve(
            eng, cfg, prompt, label, n_new, want, label in PROFILED)
        for key in totals:
            totals[key] += counts[key]
        rows.append(row)
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
    # All 16 chunks selected: K4 reads every row K2 reads, in another
    # order, so the first step equals dense factored post decode up to the
    # order of the sums.
    eng = engine("factored", "post", torch.bfloat16, 128, sparse_topk=16, sparse_block=512)
    logits, cache = eng.prefill(prompt)
    step_logits, _ = eng.decode_step(cache, logits[:, -1].argmax(-1)[:, None], s)
    dense = first_logits["factored post bf16"]
    diff = (step_logits[0, -1].float() - dense).abs().max().item()
    log(f"sparse all 16 chunks vs dense factored post first-step logits: "
        f"max_abs_diff={diff:.4e} (limit {TOL_SPARSE_ALL:.4e}; "
        f"max |logit| {dense.abs().max().item():.4e})")
    if not diff <= TOL_SPARSE_ALL:
        raise AssertionError("sparse decode over every chunk disagrees with dense decode")
    del eng, cache, logits, step_logits
    torch.cuda.empty_cache()
    i4 = (first_logits["factored post int4 refactorize"]
          - first_logits["factored post int8"]).abs().max().item()
    log(f"int4 vs int8 factors (post) first-step logits: max_abs_diff={i4:.4e} (for scale)")
    results["main_runs"] = rows
    spec_counts = speculative_8b(results, params, cfg, prompt, engine)
    served = {r["run"]: r["decode_ms_per_token_graph"] for r in rows}
    if (beside or {}).get("batching") is not None:
        beside["batching"]()
    batch_counts = batched_8b(results, params, cfg, served)
    spec9_counts = batched_spec_8b(results, params, cfg, engine, prompt,
                                   (beside or {}).get("persistence"))
    minicache_counts = minicache_8b(results, params, cfg, prompt, served)
    for key in totals:
        totals[key] += (spec_counts[key] + batch_counts[key] + spec9_counts[key]
                        + minicache_counts[key])
    return totals


# Llama-3.2-1B at wide ranks: past one CTA's 1024 value ranks in K2
# (post) and K3 (pre), and factored-vs-fake first-step logits held to the
# main path's rule.
WIDE_1B_RANKS = (1024, 1536)


def llama_1b_path(results):
    """Llama-3.2-1B (head_dim 64) at full width and depth, random bf16
    weights from the seed, one 8192-token prompt: mode none, 8 greedy
    tokens (every prefill layer runs K1 at head size 64); then factored
    pre, xKV-4 over all 16 layers at rank_k 256 / rank_v 384 (the 8B
    config's ranks at the same fraction of the group width), 32 greedy
    tokens (every decode step runs K3 at head size 64 in every layer);
    then, at rank_k 1024 / rank_v 1536 (``WIDE_1B_RANKS``), fake and
    factored pre (K3), fake and factored post (K2), 8 tokens each; each
    factored run's first-step logits must agree with its fake run's as the
    8B's do."""
    import torch

    from xkv_tpu_torch.configs import generate_consecutive_xkv_config
    from xkv_tpu_torch.engine import InferenceEngine
    from xkv_tpu_torch.models.config import llama32_1b_config
    from xkv_tpu_torch.models.llama import init_params

    cfg = llama32_1b_config()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    t0 = time.time()
    params = init_params(cfg, gen, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    log(f"1B params: {sum(nbytes(t) for _, t in _leaves(params)) / 1e9:.2f} GB "
        f"in {time.time() - t0:.1f} s")
    prompt = torch.randint(0, cfg.vocab_size, (1, 8192), generator=gen, device="cuda")
    totals = {key: 0 for key in COUNTERS}
    rows = []
    _, rk, rv = LOWRANK_SHAPES["1B"][3:]
    wk, wv = WIDE_1B_RANKS

    def xkv(rope, rank_k, rank_v):
        return generate_consecutive_xkv_config(
            group_size=4, rank_k=rank_k, rank_v=rank_v, num_layers=cfg.num_layers,
            end_layer=cfg.num_layers - 1, extra_kwargs={"rope_mode": rope})

    L = cfg.num_layers
    wide = f"rank {wk}/{wv}"
    first = {}
    for label, mode, rope, ranks, n_new, per_step in (
            ("1B none", "none", "pre", None, 8, {}),
            ("1B factored pre bf16", "factored", "pre", (rk, rv), 32, {"K3": L}),
            (f"1B fake pre {wide}", "fake", "pre", (wk, wv), 8, {}),
            (f"1B factored pre bf16 {wide}", "factored", "pre", (wk, wv), 8, {"K3": L}),
            (f"1B fake post {wide}", "fake", "post", (wk, wv), 8, {}),
            (f"1B factored post bf16 {wide}", "factored", "post", (wk, wv), 8, {"K2": L})):
        eng = InferenceEngine(params, cfg, None if ranks is None else xkv(rope, *ranks),
                              mode=mode, tail_max=128, prefill_logits="last", device="cuda")
        want = {key: per_step.get(key, 0) * (n_new - 1) for key in COUNTERS}
        want["K1"] = L
        row, counts, first[label] = serve(eng, cfg, prompt, label, n_new, want,
                                          label == "1B factored pre bf16")
        rows.append(row)
        for key in totals:
            totals[key] += counts[key]
        del eng
        torch.cuda.empty_cache()
    for rope in ("pre", "post"):
        ref = first[f"1B fake {rope} {wide}"]
        diff = (first[f"1B factored {rope} bf16 {wide}"] - ref).abs().max().item()
        log(f"1B {wide} factored {rope} vs fake first-step logits: max_abs_diff={diff:.4e} "
            f"(limit {TOL_FACTORED_VS_FAKE:.4e}; max |logit| {ref.abs().max().item():.4e})")
        if not diff <= TOL_FACTORED_VS_FAKE:
            raise AssertionError(f"1B {wide}: factored {rope} and fake first-step logits "
                                 "disagree")
    results["llama_1b_runs"] = rows
    del params
    torch.cuda.empty_cache()
    return totals


# tiny_llama_config (head size 16) on the card: factored pre, then sparse
# decode at chunk widths 16 and 24 (top-4) and 100 (all 10 chunks of the
# 1000 rows, each walked as two blocks) in pre (K5) and post (K4); group
# size 2 at full rank (rank_k 64, the width of two layers' keys; rank_v
# 48). At width 100 top-4 of 10 chunks is no check: the chunk-bound scores
# that pick them round differently on the card and on the CPU, so the two
# read different chunks (first-step logits 0.021 apart against 0.0024 with
# every chunk read). (label, rope, sparse options, kernel launches per
# decode step)
SMALL_RUNS = [("tiny factored pre", "pre", {}, "K3")] + [
    (f"tiny sparse {rope} width {w}", rope, dict(sparse_topk=k, sparse_block=w),
     "K5" if rope == "pre" else "K4")
    for w, k in ((16, 4), (24, 4), (100, 10)) for rope in ("pre", "post")]
# First decode step's logits, card against the same engine on the CPU (the
# plain versions, the same bf16 weights; cuBLAS and the CPU round the bf16
# products at other places): twice the readings on an H100.
TOL_SMALL_VS_CPU = {
    "tiny factored pre": 2 * 2.4414e-03,
    "tiny sparse pre width 16": 2 * 2.4414e-03, "tiny sparse post width 16": 2 * 2.9297e-03,
    "tiny sparse pre width 24": 2 * 2.6855e-03, "tiny sparse post width 24": 2 * 1.9531e-03,
    "tiny sparse pre width 100": 2 * 2.4109e-03, "tiny sparse post width 100": 2 * 2.9297e-03}


def small_engine_path(results):
    """``tiny_llama_config`` widths (head size 16, which K1, K3 and K5 take
    zero-padded) at random bf16 weights from the seed, one 1000-token
    prompt: each run of ``SMALL_RUNS`` served through ``serve`` (launch
    counts read around ``generate``), its first decode step's logits held
    against the same engine's on the CPU."""
    import torch

    from xkv_tpu_torch.configs import generate_consecutive_xkv_config
    from xkv_tpu_torch.engine import InferenceEngine
    from xkv_tpu_torch.models.config import tiny_llama_config
    from xkv_tpu_torch.models.llama import init_params

    cfg = tiny_llama_config()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = init_params(cfg, gen, torch.bfloat16, "cuda")
    params_cpu = _to_cpu(params)
    prompt = torch.randint(0, cfg.vocab_size, (1, 1000), generator=gen, device="cuda")
    totals = {key: 0 for key in COUNTERS}
    rows, readings = [], {}
    L, n_new = cfg.num_layers, 4
    for label, rope, sparse, kernel in SMALL_RUNS:
        xkv = generate_consecutive_xkv_config(
            group_size=2, rank_k=64, rank_v=48, num_layers=L, end_layer=L - 1,
            extra_kwargs={"rope_mode": rope})
        kw = dict(mode="factored", tail_max=8, **sparse)
        eng = InferenceEngine(params, cfg, xkv, device="cuda", **kw)
        want = {key: 0 for key in COUNTERS}
        want["K1"], want[kernel] = L, L * (n_new - 1)
        row, counts, first = serve(eng, cfg, prompt, label, n_new, want, False)
        ref_eng = InferenceEngine(params_cpu, cfg, xkv, device="cpu", **kw)
        logits, cache = ref_eng.prefill(prompt.cpu())
        tok = logits[:, -1].argmax(-1)[:, None]
        ref, _ = ref_eng.decode_step(cache, tok, prompt.shape[1])
        diff = (first.cpu() - ref[0, -1].float()).abs().max().item()
        readings[label] = diff
        limit = TOL_SMALL_VS_CPU[label]
        log(f"{label}: first-step logits against the CPU: max_abs_diff={diff:.4e} (limit "
            f"{limit:.4e}; max |logit| {ref.abs().max().item():.4e})")
        if not diff <= limit:
            raise AssertionError(f"{label}: the card's logits disagree with the CPU's")
        rows.append(row)
        for key in totals:
            totals[key] += counts[key]
        del eng, ref_eng, cache, logits
    results["tiny_runs"] = dict(runs=rows, logits_vs_cpu=readings)
    return totals


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu() if hasattr(tree, "cpu") else tree


PROFILED = ("none", "factored pre bf16", "factored post bf16", "factored post bf16 sparse top-4",
            "factored post int8 sparse-mixed top-4", "factored post int4 sparse-mixed top-4",
            "factored post bf16 sparse top-4 max 8")


def _union_ms(spans) -> float:
    """Milliseconds covered by (start, end) microsecond spans, each
    instant counted once."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total / 1e3


def _profile(run_step, steps: int, step_ms: float, trace_dir=None) -> dict:
    """Device time of ``steps`` calls of ``run_step`` under torch.profiler:
    the time the device ran kernels per step (the union of their spans,
    so kernels that overlap, such as a merge pass whose span holds its
    wait for the split, count once), its share of the step's wall time
    ``step_ms`` measured without the profiler, and the kernels that take
    most of it (each kernel's summed spans, which may overlap; totals by
    name from ``profile_op_times``). With ``trace_dir`` the Chrome trace
    is written there and the result carries ``op_times_ms``, the totals by
    name, for ``device_op_times`` to be held against."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from xkv_tpu_torch.utils.profiling import kernel_events, profile_op_times

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
    # Only the device's own events: a CPU op's device time repeats its kernels'.
    totals = profile_op_times(prof)
    device_events = kernel_events(prof)
    busy_ms = _union_ms((start, end) for _, start, end in device_events) / steps
    top = list(totals.items())[:6]
    # The decode kernels' split and merge passes by name (K2/K4/K6:
    # rankspace_tma_split_kernel; K7/K8: mla_tma_split_kernel; both merged
    # by rankspace_merge_cols_kernel).
    def is_decode(key):
        return any(k in key for k in ("rankspace", "lowrank", "mla_tma_split"))

    decode = {name[:60]: ms / steps for name, ms in totals.items() if is_decode(name)}
    decode_union = _union_ms((start, end) for name, start, end in device_events
                             if is_decode(name)) / steps
    out = dict(step_ms=step_ms, device_busy_ms_per_step=busy_ms,
               device_idle_share=1.0 - busy_ms / step_ms,
               kernel_sum_ms_per_step=sum(totals.values()) / steps,
               top_kernels_ms_per_step={name[:60]: ms / steps for name, ms in top},
               decode_kernels_ms_per_step=decode,
               decode_kernels_union_ms_per_step=decode_union)
    if trace_dir is not None:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "decode.pt.trace.json"))
        from torch.autograd import DeviceType

        # The totals _profile printed before the shared helper, for phase 13.
        out["op_times_ms"] = totals
        out["key_averages_ms"] = {e.key: e.self_device_time_total / 1e3
                                  for e in prof.key_averages()
                                  if e.device_type == DeviceType.CUDA}
        out["op_counts"] = {name: sum(1 for n, _, _ in device_events if n == name)
                            for name in totals}
    return out


def profile_decode(eng, cache, tok, pos, eager_ms: float, steps: int = 4) -> tuple:
    """(eager, graph) profiles of the decode step on ``cache`` from
    position ``pos``: ``steps`` eager steps against the eager loop's
    ms/token ``eager_ms``; then a graph of the step captured on the same
    cache (``DecodeGraph``, as ``generate`` does), ``steps`` replays timed
    on the host clock and ``steps`` more profiled against that time."""
    import torch

    from xkv_tpu_torch.engine.graphs import DecodeGraph

    state = dict(cache=cache, pos=pos)

    def eager_step():
        _, state["cache"] = eng.decode_step(state["cache"], tok, state["pos"])
        state["pos"] += 1

    eager = _profile(eager_step, steps, eager_ms)
    seg = DecodeGraph(eng, state["cache"], state["pos"], 1 + 2 * steps, first_token=tok)
    seg.warm_up()
    seg.capture()
    torch.cuda.synchronize()
    t0 = time.time()
    seg.replay(steps)
    torch.cuda.synchronize()
    graph_ms = (time.time() - t0) * 1e3 / steps
    graph = _profile(lambda: seg.replay(1), steps, graph_ms)
    graph["capture_ms"] = seg.timing.capture_ms
    return eager, graph


def _leaves(tree, prefix=""):
    """(path, leaf) for every tensor of a params tree of dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


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
    for run, (rope, kw, kernel, tol_decode) in ANCHOR_RUNS.items():
        xkv = generate_consecutive_xkv_config(
            group_size=int(gold["group_size"]), rank_k=int(gold["rank_k"]),
            rank_v=int(gold["rank_v"]), num_layers=cfg.num_layers,
            end_layer=cfg.num_layers - 1,
            extra_kwargs={"svd_method": "exact", "rope_mode": rope})
        eng = InferenceEngine(params, cfg, xkv, mode="factored", tail_max=64, device="cuda",
                              **kw)
        toks = gold[f"tokens_{run}"]
        golden_check(f"anchor {run}", eng, prompt, toks, gold[f"logits_{run}"],
                     {"prefill": TOL_ANCHOR["prefill"], "decode": tol_decode},
                     {"K1": cfg.num_layers, kernel: cfg.num_layers * (len(toks) - 1)})


def golden_check(label, eng, prompt, toks, want, tol, launches) -> dict:
    """``toks`` teacher-forced through ``eng`` (prefill, then one decode
    step a token); each step's logits held against the golden ``want``
    (the prefill step, then the decode steps, each within ``tol``), the
    launches read around it against ``launches`` (the rest 0). Returns
    the errors."""
    import numpy as np
    import torch

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
    log(f"{label}: {len(toks)} steps, max_abs_err prefill step {err['prefill']:.4e} "
        f"(limit {tol['prefill']:.4e}), decode steps {err['decode']:.4e} "
        f"(limit {tol['decode']:.4e}); max |logit| {np.abs(want).max():.4e}; "
        f"launches {counts}")
    if not all(err[k] <= tol[k] for k in err):
        raise AssertionError(f"{label}: logits disagree with the JAX golden")
    want_counts = {key: launches.get(key, 0) for key in COUNTERS}
    if counts != want_counts:
        raise AssertionError(f"{label}: launches {counts}, expected {want_counts}")
    return err


# ------------------------------------------------------------- DeepSeek MLA
# Factored (bf16 factors) against fake, first decode step: twice the reading
# of this seeded run on an H100.
TOL_MLA_FACTORED_VS_FAKE = 2 * 0.2422
# MLA anchor, per-step logits (prefill step and decode steps; max |logit|
# 0.73): twice the readings on an H100.
TOL_MLA_ANCHOR = {"bf16": 2 * 0.005966, "int4": 2 * 0.02129}


def mla_runs():
    """(label, mode, factor dtype, tail_max, new tokens, the decode kernel)."""
    import torch

    bf = torch.bfloat16
    return [
        ("mla none", "none", bf, 128, 32, None),
        ("mla fake", "fake", bf, 128, 32, None),
        ("mla factored bf16", "factored", bf, 128, 32, "K7"),
        ("mla factored int8", "factored", "int8", 128, 32, "K7"),
        ("mla factored int4 refactorize", "factored", "int4", 32, 48, "K8"),
    ]


def mla_path(results):
    """DeepSeek-V2-Lite at full width and depth (27 layers, 64 routed
    experts), random bf16 weights from the seed, one 8192-token prompt, the
    xKV config of ``configs/mla_deepseek_v2_lite.yaml`` (groups of 4,
    rank 512, latent only)."""
    import torch

    from xkv_tpu_torch.configs import XKVConfig
    from xkv_tpu_torch.engine import InferenceEngine
    from xkv_tpu_torch.models import deepseek
    from xkv_tpu_torch.models.config import deepseek_v2_lite_config

    cfg = deepseek_v2_lite_config()
    xkv = XKVConfig.from_yaml(os.path.join(ROOT, "configs", "mla_deepseek_v2_lite.yaml"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    t0 = time.time()
    params = deepseek.init_params(cfg, gen, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    log(f"DeepSeek-V2-Lite params: {sum(nbytes(t) for _, t in _leaves(params)) / 1e9:.2f} GB "
        f"in {time.time() - t0:.1f} s")
    prompt = torch.randint(0, cfg.vocab_size, (1, 8192), generator=gen, device="cuda")
    totals = {key: 0 for key in COUNTERS}
    first_logits = {}
    rows = []
    for label, mode, fdt, tail_max, n_new, kernel in mla_runs():
        eng = InferenceEngine(params, cfg, xkv, mode=mode, tail_max=tail_max, factor_dtype=fdt,
                              prefill_logits="last", device="cuda")
        want = {key: 0 for key in COUNTERS}
        if kernel is not None:
            want[kernel] = cfg.num_layers * (n_new - 1)
        row, counts, first_logits[label] = serve(
            eng, cfg, prompt, label, n_new, want, label == "mla factored bf16")
        for key in totals:
            totals[key] += counts[key]
        rows.append(row)
        del eng
        torch.cuda.empty_cache()
    # Factored and fake hold the same SVD of the latent: fake stores the
    # bf16 reconstruction, factored bf16 factors and decodes in rank space
    # (K7). The first-step logits differ by those bf16 roundings, carried
    # through 27 layers of random weights; none against fake (the
    # truncation) is printed beside it for scale.
    ref = first_logits["mla fake"]
    diff = (first_logits["mla factored bf16"] - ref).abs().max().item()
    trunc = (first_logits["mla none"] - ref).abs().max().item()
    tol = TOL_MLA_FACTORED_VS_FAKE
    log(f"mla factored vs fake first-step logits: max_abs_diff={diff:.4e} (limit {tol:.4e}; "
        f"max |logit| {ref.abs().max().item():.4e}); none vs fake: {trunc:.4e}")
    if not diff <= tol:
        raise AssertionError("MLA factored and fake first-step logits disagree")
    results["mla_runs"] = rows
    spec_counts = speculative_mla(results, params, cfg, xkv, prompt)
    served = {r["run"]: r["decode_ms_per_token_graph"] for r in rows}
    batch_counts = batched_mla(results, params, cfg, xkv, served)
    spec9_counts = batched_spec_mla(results, params, cfg, xkv, prompt)
    for key in totals:
        totals[key] += spec_counts[key] + batch_counts[key] + spec9_counts[key]
    return totals


def mla_anchor():
    """Teacher-force the JAX engine's golden tokens of a small MLA + MoE
    model (``xkv_tpu_torch/testdata/mla_golden.npz``, weights rebuilt from
    its numpy seed) through the port on the card (bf16) and compare each
    step's logits with the golden fp32 ones."""
    import json as _json

    import numpy as np
    import torch

    from xkv_tpu_torch.configs import generate_consecutive_xkv_config
    from xkv_tpu_torch.engine import InferenceEngine
    from xkv_tpu_torch.models import deepseek
    from xkv_tpu_torch.models.ckpt import params_from_numpy
    from xkv_tpu_torch.models.config import ModelConfig

    gold = np.load(os.path.join(ROOT, "xkv_tpu_torch", "testdata", "mla_golden.npz"))
    cfg = ModelConfig(**_json.loads(str(gold["config"])))
    params = params_from_numpy(deepseek.numpy_params(cfg, int(gold["seed"])),
                               torch.bfloat16, "cuda")
    prompt = torch.as_tensor(gold["prompt"], device="cuda")
    xkv = generate_consecutive_xkv_config(
        group_size=int(gold["group_size"]), rank_k=int(gold["rank_k"]), rank_v=None,
        num_layers=cfg.num_layers, end_layer=cfg.num_layers - 1, merge_value=False,
        extra_kwargs={"svd_method": "exact", "int4_rank_frac": float(gold["int4_rank_frac"])})
    for run, (fdt, kernel) in {"bf16": (torch.bfloat16, "K7"), "int4": ("int4", "K8")}.items():
        eng = InferenceEngine(params, cfg, xkv, mode="factored", tail_max=64, factor_dtype=fdt,
                              device="cuda")
        toks = gold[f"tokens_{run}"]
        want = gold[f"logits_{run}"]
        reset_counts()
        logits, cache = eng.prefill(prompt)
        got = [logits[0, -1].float().cpu().numpy()]
        pos = prompt.shape[1]
        for i in range(len(toks) - 1):
            step, cache = eng.decode_step(cache, torch.tensor([[int(toks[i])]], device="cuda"),
                                          pos + i)
            got.append(step[0, -1].float().cpu().numpy())
        err = float(np.abs(np.stack(got) - want).max())
        counts = read_counts()
        log(f"mla anchor {run}: {len(toks)} steps, max_abs_err {err:.4e} "
            f"(limit {TOL_MLA_ANCHOR[run]:.4e}); max |logit| {np.abs(want).max():.4e}; "
            f"launches {counts}")
        if not err <= TOL_MLA_ANCHOR[run]:
            raise AssertionError(f"mla anchor {run}: logits disagree with the JAX golden")
        want_counts = {key: 0 for key in COUNTERS}
        want_counts[kernel] = cfg.num_layers * (len(toks) - 1)
        if counts != want_counts:
            raise AssertionError(f"mla anchor {run}: launches {counts}, expected {want_counts}")


# --------------------------------------------- speculative and staged
# Speculative runs: draft_k, new tokens and tail (so that each run has
# rounds, a top-up and a refactorisation); the near-tie limits below which
# a step's top-2 exact logit gap lets the verify pass (ql = draft_k + 1,
# bf16) break the tie the other way from generate's single-token step:
# twice the agreement readings of each model (PERF.md section 6).
SPEC_K, SPEC_NEW, SPEC_TAIL = 7, 40, 32
GAP_8B, GAP_MLA, GAP_ANCHOR = TOL_FACTORED_VS_FAKE, TOL_MLA_FACTORED_VS_FAKE, TOL_ANCHOR["decode"]
# Copy-induction prompt of the in-repo checkpoint's training
# (scripts/rope_mode_study_production.py make_induction_batch): BOS, noise
# tokens in [2, 1024), a segment x of 64 such tokens, then x's first 4.
COPY_LEN, COPY_M, COPY_SHOWN = 256, 64, 4


def spec_phase_time(results, part: str, seconds: float) -> None:
    results.setdefault("spec_phase_s", {})[part] = seconds
    log(f"speculative-and-staged phase, {part}: {seconds:.1f} s")


def reference_pass(eng, prompt, tokens, schedule, profile_ms=None) -> dict:
    """Two exact references for a speculative run's ``tokens`` (1, n),
    from one prefill of ``eng``, with no decode options (the step of the
    exact configuration's ``generate``, and the verify pass's):
      steps   the exact single-token step teacher-forced over the tokens
              up to the first refactorisation (one captured segment, as
              ``generate`` runs it): exact greedy decoding's log-probs;
      replay  the run's own ``schedule`` (("round", n_out) and ("steps",
              n) in order) re-run eagerly: a round is one exact pass at ql
              = draft_k + 1 from the round's start over its emitted tokens
              (the rows past them, a rejected draft's, are not read) and
              moves the tail by n_out, a top-up the same captured exact
              steps, and a full tail is refactorised where the run did it.
              Its tail rows are written as the run wrote them, so the
              factors refolded at a refactorisation are the run's own.
    Before them, on the fresh cache: with ``profile_ms`` (the run's draft
    and verify replay ms), torch.profiler over replays of a draft and a
    verify graph (``SpecRounds``, its first round run to capture them);
    then one exact pass over the first ``SPEC_K + 1`` tokens, a verify
    pass, held against the steps. Returns both log-prob tables (rows: the
    distribution each token was chosen from, prefill's first), the
    largest |difference| of the verify pass from the steps, the steps'
    device ms per step and the profile."""
    import torch

    from xkv_tpu_torch.engine.graphs import DecodeGraph, SpecRounds
    from xkv_tpu_torch.ops.kernels import _build

    def log_probs(x):
        return torch.log_softmax(x.float(), dim=-1)

    logits, cache = eng.prefill(prompt)
    first = log_probs(logits[0, -1:])
    pos, n, k = prompt.shape[1], tokens.shape[1], SPEC_K
    profile = None
    if profile_ms is not None:
        rounds = SpecRounds(eng, cache, tokens[:, :1], pos, k)
        rounds.round()
        profile = {"draft": _profile(rounds.draft_graph.replay, 3, profile_ms[0]),
                   "verify": _profile(rounds.verify_graph.replay, 2, profile_ms[1])}
        _build.add_counts(rounds.draft_counts, 3)
        _build.add_counts(rounds.verify_counts, 2)
        rounds.close()
        log("spec profile " + json.dumps(profile))
    verify, _ = eng.step(cache, tokens[:, :k + 1], pos, {})
    seg = DecodeGraph(eng, cache, pos, min(n - 1, cache.tail_max),
                      teacher=tokens[:, :min(n - 1, cache.tail_max)], step_kw={})
    lp, _ = seg.run()
    steps = torch.cat([first, log_probs(lp[0])])
    rows = steps[1:1 + k + 1]  # fewer where the run is shorter
    verify_diff = (log_probs(verify[0])[:len(rows)] - rows).abs().max().item()

    replay, i = [first], 0  # tokens[:, i] starts the next round or top-up
    for kind, m in schedule:
        take = min(m, n - 1 - i)
        if take <= 0:
            break
        if cache.tail_count == cache.tail_max:
            cache = eng.refactorize(cache)
        if kind == "round":
            inp = tokens[:, i:i + k + 1]
            inp = torch.cat([inp, inp[:, -1:].expand(1, k + 1 - inp.shape[1])], dim=1)
            out, _ = eng.step(cache, inp, pos, {})
            replay.append(log_probs(out[0, :take]))
            cache = cache.advance(m)
        else:
            top_up = DecodeGraph(eng, cache, pos, take, teacher=tokens[:, i:i + take],
                                 step_kw={})
            out, cache = top_up.run()
            replay.append(log_probs(out[0]))
        pos, i = pos + m, i + m
    return dict(steps=steps, replay=torch.cat(replay), verify_diff=verify_diff,
                step_ms=seg.timing.replay_ms_per_step(), profile=profile)


def speculate(label, spec, prompt, n_new, gap, per_step, first_k1, exact=None,
              generate_ms=None, profiled=False):
    """One speculative run: ``generate_speculative`` with the launch counts
    read around it, which must equal what its rounds imply (``per_step``:
    kernel -> (launches per draft step, per exact step); ``first_k1``:
    prefill's K1); then the same engine's exact references
    (``reference_pass``). In the replay of the run's schedule every
    emitted token's log-prob must be within ``gap`` of its row's top one:
    this holds the captured rounds, top-ups, refactorisations and the
    next segments' graphs to an eager run of the same exact passes. Up to
    the first refactorisation, the same against exact greedy decoding's
    steps, and the tokens must be exact greedy decoding's (the exact
    configuration's ``generate``'s) up to the first step whose top-2 gap
    is below ``gap`` (there the verify pass, ql = draft_k + 1, may break a
    near tie the other way from a single-token step). Past a
    refactorisation the single-token steps are no reference: the run's
    tail rows come from verify passes, whose rounding differs from a
    step's, and the refolded factors follow them (int4 factors quantise
    them anew). The verify pass on the fresh cache must agree with the
    steps within ``gap``. ``generate_ms``: the exact
    configuration's ``generate`` graph ms/token from the served runs of
    the same call; or ``exact``, that configuration's engine, whose
    ``generate`` runs here first (its tokens must equal the run's up to the
    first near tie). Returns (row, launches of the whole run, generate's
    tokens or None)."""
    import torch

    from xkv_tpu_torch.engine.graphs import RoundTiming

    want, gen_counts = None, {key: 0 for key in COUNTERS}
    if exact is not None:
        reset_counts()
        want = exact.generate(prompt, n_new)
        replayed = [t for t in exact.last_timings if t.start is not None]
        generate_ms = (sum(t.replay_ms_per_step() * t.replays for t in replayed)
                       / sum(t.replays for t in replayed))
        gen_counts = read_counts()
    reset_counts()
    t0 = time.time()
    got, stats = spec.generate_speculative(prompt, n_new, draft_k=SPEC_K, return_stats=True)
    torch.cuda.synchronize()
    spec_s = time.time() - t0
    counts = read_counts()
    k, rounds, plain = SPEC_K, stats["rounds"], stats["plain_steps"]
    expect = {key: 0 for key in COUNTERS}
    expect["K1"] = first_k1
    for key, (per_draft, per_exact) in per_step.items():
        expect[key] += per_draft * k * rounds + per_exact * (rounds + plain)
    if counts != expect:
        raise AssertionError(f"{label}: launches {counts}, the rounds imply {expect}")
    if tuple(got.shape) != (1, n_new):
        raise AssertionError(f"{label}: speculative tokens of shape {tuple(got.shape)}")
    segs = [t for t in spec.last_timings if isinstance(t, RoundTiming)]
    top_ups = [t for t in spec.last_timings if not isinstance(t, RoundTiming)]
    for t in segs:  # one capture of each graph per segment, replays after
        if t.draft_capture_ms is None or t.verify_capture_ms is None or \
                len(t.events) != t.rounds - 1:
            raise AssertionError(f"{label}: a segment's graphs were not captured once")
    draft_ms = verify_ms = 0.0
    replayed_rounds = replayed_tokens = 0
    for t in segs:
        d, v, n = t.replayed()
        draft_ms, verify_ms = draft_ms + d, verify_ms + v
        replayed_rounds, replayed_tokens = replayed_rounds + len(t.events), replayed_tokens + n
    # Device ms of one draft replay and of one verify replay (None where
    # every segment ended after its first, capturing round).
    draft_1 = draft_ms / (replayed_rounds * k) if replayed_rounds else None
    verify_1 = verify_ms / replayed_rounds if replayed_rounds else None

    reset_counts()
    t0 = time.time()
    schedule = [("round", m) if isinstance(t, RoundTiming) else ("steps", t.steps)
                for t in spec.last_timings
                for m in (t.emitted if isinstance(t, RoundTiming) else [None])]
    ref = reference_pass(spec, prompt, got.to(spec.device), schedule,
                         (draft_1, verify_1) if profiled and replayed_rounds else None)
    ref_s = time.time() - t0
    ref_counts = read_counts()
    if not ref["verify_diff"] <= gap:
        raise AssertionError(f"{label}: a verify pass's log-probs differ from the exact "
                             f"steps' by {ref['verify_diff']:.4e} (limit {gap:.4e})")
    if tuple(ref["replay"].shape[:1]) != (n_new,):
        raise AssertionError(f"{label}: the replay gave {ref['replay'].shape[0]} rows")
    tok = got[0].to(spec.device)

    def below_top(lp):
        """Each token's log-prob below its row's top; the top-2 gaps."""
        top = lp.topk(2, dim=-1).values
        behind = top[:, 0] - lp.gather(1, tok[:len(lp), None])[:, 0]
        return behind.tolist(), (top[:, 0] - top[:, 1]).tolist()

    replay_behind, _ = below_top(ref["replay"])
    steps_behind, gaps = below_top(ref["steps"])
    n_steps = len(steps_behind)
    tie = next((i for i, g in enumerate(gaps) if i > 0 and g < gap), None)
    n_cmp = n_steps if tie is None else tie
    equal = int((tok[:n_steps] == ref["steps"].argmax(-1)).long().cumprod(0).sum())
    if want is not None:
        equal = min(equal, int((got[0] == want[0].cpu()).long().cumprod(0).sum()))
    worst_r = max(range(n_new), key=lambda i: replay_behind[i])
    worst_s = max(range(n_steps), key=lambda i: steps_behind[i])
    if equal < n_cmp or steps_behind[worst_s] > gap or replay_behind[worst_r] > gap:
        raise AssertionError(
            f"{label}: speculative tokens {got.tolist()} leave exact greedy decoding "
            f"before step {n_cmp} (equal through {equal}), or a token is below its "
            f"top log-prob by more than {gap:.4e}: in the replay of the run "
            f"{replay_behind[worst_r]:.4e} (step {worst_r}), against the exact steps "
            f"{steps_behind[worst_s]:.4e} (step {worst_s})")
    row = dict(
        run=label, tokens_equal_exact_greedy_through_step=equal, first_near_tie_step=tie,
        near_tie_limit=gap, replay_max_logprob_below_top=replay_behind[worst_r],
        replay_at_step=worst_r, steps_compared=n_steps,
        steps_max_logprob_below_top=steps_behind[worst_s], steps_at_step=worst_s,
        verify_vs_steps_max_abs_logprob_diff=ref["verify_diff"], rounds=rounds,
        round_tokens=stats["round_tokens"], plain_steps=plain,
        tokens_per_round=stats["tokens_per_round"], segments=len(segs),
        top_up_segments=len(top_ups), draft_replay_ms=draft_1, verify_replay_ms=verify_1,
        spec_ms_per_token=(draft_ms + verify_ms) / replayed_tokens if replayed_rounds else None,
        exact_graph_ms_per_token=ref["step_ms"], generate_graph_ms_per_token=generate_ms,
        break_even_tokens_per_round=(
            (k * draft_1 + verify_1) / ref["step_ms"] if replayed_rounds else None),
        draft_capture_ms=[t.draft_capture_ms for t in segs],
        verify_capture_ms=[t.verify_capture_ms for t in segs],
        top_up_capture_ms=[t.capture_ms for t in top_ups], launches=counts,
        launches_implied=expect, spec_wall_s=spec_s, reference_wall_s=ref_s)
    if ref["profile"] is not None:
        row["profile"] = ref["profile"]
    log("spec " + json.dumps({k: v for k, v in row.items() if k != "profile"}))
    return row, {key: gen_counts[key] + ref_counts[key] + counts[key] for key in COUNTERS}, want


def check_segments(rows) -> None:
    """Every speculative run of a model refactorised (two segments or more)
    and one of them at least topped its tail up with exact steps."""
    if not all(r["segments"] >= 2 for r in rows) or not any(r["plain_steps"] for r in rows):
        raise AssertionError("speculative runs without a refactorisation or a top-up")


def speculative_8b(results, params, cfg, prompt, engine):
    """Llama-3.1-8B xKV-4, the 8192-token prompt: sparse top-4 post (K4
    drafts, K2 verify), pre (K5, K3) and post int4 sparse-mixed (K6 in the
    exact layers of a draft, the sparse ones on the reference's plain
    sparse x int4 path; K6 verify). Then staged against monolithic
    prefill. Returns the launches."""
    import torch

    t0 = time.time()
    L = cfg.num_layers
    top4 = dict(sparse_topk=4, sparse_block=512)
    n_sp = len([l for l in range(L) if (l + 1) % 4 != 0])
    mixed = dict(top4, sparse_layers=[l for l in range(L) if (l + 1) % 4 != 0])
    # (label, rope, factor dtype, options, launches a draft / exact step,
    # the served run of the exact configuration, phase 3)
    runs = [("8B spec post bf16 sparse top-4", "post", torch.bfloat16, top4,
             {"K4": (L, 0), "K2": (0, L)}, "factored post bf16"),
            ("8B spec pre bf16 sparse top-4", "pre", torch.bfloat16, top4,
             {"K5": (L, 0), "K3": (0, L)}, "factored pre bf16"),
            ("8B spec post int4 sparse-mixed top-4", "post", "int4", mixed,
             {"K6": (L - n_sp, L)}, "factored post int4 refactorize")]
    served = {r["run"]: r["decode_ms_per_token_graph"] for r in results["main_runs"]}
    totals = {key: 0 for key in COUNTERS}
    rows = []
    for label, rope, fdt, kw, per_step, exact_run in runs:
        spec = engine("factored", rope, fdt, SPEC_TAIL, **kw)
        row, counts, _ = speculate(label, spec, prompt, SPEC_NEW, GAP_8B, per_step, L,
                                   generate_ms=served[exact_run],
                                   profiled=rope == "post" and fdt == torch.bfloat16)
        rows.append(row)
        for key in totals:
            totals[key] += counts[key]
        del spec
        torch.cuda.empty_cache()
    check_segments(rows)
    results["spec_runs"] = rows
    staged_counts = staged_8b(results, cfg, prompt, engine)
    for key in totals:
        totals[key] += staged_counts[key]
    spec_phase_time(results, "8B", time.time() - t0)
    return totals


def staged_8b(results, cfg, prompt, engine):
    """Staged against monolithic prefill, 8B factored pre bf16 at 8192
    tokens, ``prefill_logits="last"`` in both: peak allocated memory (reset
    before each prefill), seconds, K1 launches, the last position's logits
    and greedy tokens from each cache (a captured segment of steps, as
    ``generate`` runs)."""
    import torch

    from xkv_tpu_torch.engine.graphs import DecodeGraph

    out = {}
    totals = {key: 0 for key in COUNTERS}
    for name in ("staged", "monolithic"):
        eng = engine("factored", "pre", torch.bfloat16, 128,
                     staged_prefill=name == "staged")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        reset_counts()
        t0 = time.time()
        logits, cache = eng.prefill(prompt)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        peak = torch.cuda.max_memory_allocated()
        k1 = read_counts()["K1"]
        tok = logits[:, -1].argmax(-1)[:, None]
        seg = DecodeGraph(eng, cache, prompt.shape[1], 8, first_token=tok)
        toks, _ = seg.run()
        for key, n in read_counts().items():
            totals[key] += n
        out[name] = dict(prefill_s=seconds, peak_allocated_gb=peak / 1e9,
                         peak_above_start_gb=(peak - before) / 1e9, k1_launches=k1,
                         logits=logits[0, -1].float(), tokens=torch.cat([tok, toks], 1))
        del eng, cache, logits, seg
    st, mo = out["staged"], out["monolithic"]
    diff = (st["logits"] - mo["logits"]).abs().max().item()
    row = {name: {k: v for k, v in rec.items() if k not in ("logits", "tokens")}
           for name, rec in out.items()}
    row.update(last_logits_max_abs_diff=diff, tokens=st["tokens"].tolist(),
               tokens_equal=bool(torch.equal(st["tokens"], mo["tokens"])),
               peak_drop_gb=(mo["peak_allocated_gb"] - st["peak_allocated_gb"]))
    log("staged " + json.dumps(row))
    if not row["tokens_equal"] or not st["k1_launches"] == mo["k1_launches"] == cfg.num_layers:
        raise AssertionError("staged prefill: tokens or K1 launches differ from monolithic")
    if not st["peak_allocated_gb"] < mo["peak_allocated_gb"]:
        raise AssertionError("staged prefill: peak memory not below monolithic")
    results["staged_prefill"] = row
    return totals


def speculative_mla(results, params, cfg, xkv, prompt):
    """DeepSeek-V2-Lite factored, the 8192-token prompt: bf16 drafting at
    draft_rank 128 and 120 (K7 over the factors' first columns, read in
    place), int4 at 120 (K7 over the int8 ranks; K8 verify)."""
    import torch

    from xkv_tpu_torch.engine import InferenceEngine

    t0 = time.time()
    L = cfg.num_layers
    runs = [("V2-Lite spec bf16 draft_rank 128", torch.bfloat16, 128, {"K7": (L, L)},
             "mla factored bf16"),
            ("V2-Lite spec bf16 draft_rank 120", torch.bfloat16, 120, {"K7": (L, L)},
             "mla factored bf16"),
            ("V2-Lite spec int4 draft_rank 120", "int4", 120, {"K7": (L, 0), "K8": (0, L)},
             "mla factored int4 refactorize")]
    served = {r["run"]: r["decode_ms_per_token_graph"] for r in results["mla_runs"]}
    totals = {key: 0 for key in COUNTERS}
    rows = []
    for label, fdt, rank, per_step, exact_run in runs:
        spec = InferenceEngine(params, cfg, xkv, mode="factored", tail_max=SPEC_TAIL,
                               factor_dtype=fdt, prefill_logits="last", device="cuda",
                               draft_rank=rank)
        row, counts, _ = speculate(label, spec, prompt, SPEC_NEW, GAP_MLA, per_step, 0,
                                   generate_ms=served[exact_run], profiled=rank == 128)
        rows.append(row)
        for key in totals:
            totals[key] += counts[key]
        torch.cuda.empty_cache()
    check_segments(rows)
    results["spec_runs_mla"] = rows
    spec_phase_time(results, "V2-Lite", time.time() - t0)
    return totals


def speculative_checkpoint(results):
    """The in-repo trained checkpoint (bf16) in pre and post with the
    anchor's xKV config, sparse top-2 of 64-row chunks drafting: on the
    golden prompt, 8 tokens against the card's exact ``generate`` (and
    beside the golden greedy tokens); then a copy-induction prompt, 32
    tokens, its tokens per round."""
    import numpy as np
    import torch

    from xkv_tpu_torch.configs import generate_consecutive_xkv_config
    from xkv_tpu_torch.engine import InferenceEngine
    from xkv_tpu_torch.models.ckpt import load_checkpoint

    t0 = time.time()
    gold = np.load(os.path.join(ROOT, "xkv_tpu_torch", "testdata",
                                "production_model_golden.npz"))
    params, cfg = load_checkpoint(os.path.join(ROOT, "results", "production_model"),
                                  dtype=torch.bfloat16, device="cuda")
    golden = torch.as_tensor(gold["prompt"], device="cuda")
    rng = np.random.default_rng(SEED)
    x = rng.integers(2, cfg.vocab_size, size=COPY_M)
    noise = rng.integers(2, cfg.vocab_size, size=COPY_LEN - 1 - COPY_M - COPY_SHOWN)
    copy = torch.as_tensor(np.concatenate([[1], noise, x, x[:COPY_SHOWN]])[None],
                           device="cuda")
    L = cfg.num_layers
    totals = {key: 0 for key in COUNTERS}
    rows = []
    for rope, draft, verify in (("pre", "K5", "K3"), ("post", "K4", "K2")):
        xkv = generate_consecutive_xkv_config(
            group_size=int(gold["group_size"]), rank_k=int(gold["rank_k"]),
            rank_v=int(gold["rank_v"]), num_layers=L, end_layer=L - 1,
            extra_kwargs={"svd_method": "exact", "rope_mode": rope})

        def engine(**kw):
            return InferenceEngine(params, cfg, xkv, mode="factored", tail_max=64,
                                   device="cuda", **kw)

        for prompt, name, n_new in ((golden, "golden", 8), (copy, "copy", 32)):
            row, counts, want = speculate(
                f"checkpoint spec {rope} {name}", engine(sparse_topk=2, sparse_block=64),
                prompt, n_new, GAP_ANCHOR, {draft: (L, 0), verify: (0, L)}, L,
                exact=engine())
            want = want[0].cpu().numpy()
            if name == "golden":
                row["exact_tokens_equal_golden"] = bool(np.array_equal(
                    want, gold[f"tokens_{rope}"]))
                log(f"checkpoint spec {rope} golden: the card's exact tokens equal the "
                    f"golden tokens_{rope}: {row['exact_tokens_equal_golden']}")
            else:
                # The share of the copied segment's next tokens greedy decoding gets.
                row["copy_tokens_predicted"] = float(
                    (want == x[COPY_SHOWN:COPY_SHOWN + n_new]).mean())
                log(f"checkpoint spec {rope} copy: tokens per round "
                    f"{row['tokens_per_round']:.3f}, copied tokens predicted "
                    f"{row['copy_tokens_predicted']:.3f}")
            rows.append(row)
            for key in totals:
                totals[key] += counts[key]
    results["spec_runs_checkpoint"] = rows
    spec_phase_time(results, "checkpoint", time.time() - t0)
    return totals


# ------------------------------------------------------ continuous batching
# Phase 2, b = 4: slots of 8192, 5000, 1500 and 0 rows (the last never
# admitted), as a batched step gives K2-K7 ragged lengths. The empty slot
# must output exactly 0 with an lse of a finite -inf (the kernels'
# NEG_INF, -2.4e38, the plain versions' -1e30), which weighs 0 in the
# merge; the other slots are held to the kernel's limit.
BATCH_LENS = (8192, 5000, 1500, 0)


def _hold_slots(key, label, out, ref, lse, lse_ref, worst):
    """``_hold`` over the slots with live keys; the empty last slot's
    output 0 and lse at most -1e29 on both sides."""
    _hold(key, label, out[:-1], ref[:-1], lse[:-1], lse_ref[:-1], worst)
    if out[-1].any() or not bool((lse[-1] <= -1e29).all() and (lse_ref[-1] <= -1e29).all()):
        raise AssertionError(f"{key} {label}: the empty slot's output is not 0 / -inf")


def check_batched_kernels(gen, results):
    """K2-K6 at the 8B xKV-4 shapes and K7 at V2-Lite's, b = 4 over
    ``BATCH_LENS``, bf16 factors (K6: 256 int8 + 256 int4 ranks), one
    query row per head, against their plain versions; each timed beside
    its plain version and its bound over the live rows ("b4" rows of the
    kernel records)."""
    import torch

    from xkv_tpu_torch.cache import vt_layer_slice
    from xkv_tpu_torch.compress.quant import (
        quantize_k_factors_mixed4,
        quantize_v_factors_mixed4,
    )
    from xkv_tpu_torch.ops.kernels import lowrank_attention as k3
    from xkv_tpu_torch.ops.kernels import rankspace_attention as k2
    from xkv_tpu_torch.ops.rope import rope_cos_sin

    dev, bf, b = "cuda", torch.bfloat16, len(BATCH_LENS)
    lengths = torch.tensor(BATCH_LENS, device=dev)
    live = sum(BATCH_LENS)
    worst = {key: {"abs": 0.0, "rel": 0.0, "lse": 0.0} for key in ("K2", "K3", "K4", "K5",
                                                                    "K6", "K7")}
    hq, hkv, hd, s_p, rk, rv = LOWRANK_SHAPES["8B"]
    m, scale, block = hkv * hd, 1.0 / math.sqrt(hd), 512
    us_k = torch.randn((b, s_p, rk), generator=gen, device=dev)
    vt_k = torch.randn((b, rk, 4 * m), generator=gen, device=dev) * 0.05
    us_v = torch.randn((b, s_p, rv), generator=gen, device=dev)
    vt_v = torch.randn((b, rv, 4 * m), generator=gen, device=dev) * 0.05
    sl = lambda x: vt_layer_slice(x, 1, hkv, hd)  # noqa: E731
    k_us, v_us = us_k.to(bf), us_v.to(bf)
    q = torch.randn((b, hq, 1, hd), generator=gen, device=dev).to(bf)
    q_emb = k2._project_q(q, sl(vt_k.to(bf)), hkv, scale, None, bf)
    # Each slot's top-4 among its own chunks (the empty slot's are masked).
    ids = torch.tensor([[0, 5, 11, 15], [0, 3, 7, 9], [0, 1, 2, -1], [0, 1, 2, 3]],
                       dtype=torch.int32, device=dev)
    # The live rows of the selected chunks (what K4 / K5 read).
    sel_rows = sum(max(0, min((i + 1) * block, n) - i * block)
                   for row, n in zip(ids.tolist(), BATCH_LENS) for i in row if i >= 0)
    cos_p, sin_p = rope_cos_sin(torch.arange(s_p, device=dev), hd, 500000.0)
    cos_t, sin_t = rope_cos_sin(lengths[:, None] + 5, hd, 500000.0)
    cos_h, sin_h = k3.half_tables(cos_p, sin_p, bf)
    qab = k3._query_embeds(q, cos_t, sin_t, hkv, scale, None)
    a3 = (qab, k_us, sl(vt_k.to(bf)), v_us, sl(vt_v.to(bf)), cos_h, sin_h, None)
    kw3 = dict(num_q_heads=hq, num_kv_heads=hkv)
    qk = quantize_k_factors_mixed4(us_k, vt_k, 256)
    qv = quantize_v_factors_mixed4(us_v, vt_v, 256)
    q6 = torch.cat([k2._project_q(q, sl(qk.vt8), hkv, scale, sl(qk.out_scale), bf),
                    k2._project_q(q, sl(qk.vt4), hkv, scale, sl(qk.scale4), bf)], dim=2)
    slice_bytes = b * (rk * m + rv * m) * 2
    rows = {
        "K2": (k2.rankspace_kernel, k2.rankspace_kernel_plain, (q_emb, k_us, v_us, lengths),
               live * bytes_per_row(k_us, v_us) + nbytes(q_emb),
               2.0 * hq * live * (rk + rv) / BF16_OPS_PER_S),
        "K4": (k2.sparse_rankspace_kernel, k2.sparse_rankspace_kernel_plain,
               (q_emb, k_us, v_us, ids, block, lengths),
               sel_rows * bytes_per_row(k_us, v_us) + nbytes(q_emb, ids),
               2.0 * hq * sel_rows * (rk + rv) / BF16_OPS_PER_S),
        "K3": (lambda *a: k3.lowrank_kernel(*a, **kw3),
               lambda *a: k3.lowrank_kernel_plain(*a, **kw3), a3 + (lengths, None),
               live * bytes_per_row(k_us, v_us, cos_h, sin_h) + nbytes(qab) + slice_bytes,
               (2.0 * live * rk * m + 2.0 * hq * live * (2 * hd + rv)) / BF16_OPS_PER_S),
        "K5": (lambda *a: k3.sparse_lowrank_kernel(*a, **kw3),
               lambda *a: k3.sparse_lowrank_kernel_plain(*a, **kw3),
               a3 + (ids, block, lengths, None),
               sel_rows * bytes_per_row(k_us, v_us, cos_h, sin_h) + nbytes(qab, ids)
               + slice_bytes,
               (2.0 * sel_rows * rk * m + 2.0 * hq * sel_rows * (2 * hd + rv))
               / BF16_OPS_PER_S),
        "K6": (k2.mixed_rankspace_kernel, k2.mixed_rankspace_kernel_plain,
               (q6, qk.us8, qk.us4p, qv.us8, qv.us4p, lengths),
               live * bytes_per_row(qk.us8, qk.us4p, qv.us8, qv.us4p) + nbytes(q6),
               2.0 * hq * live * (rk + rv) / BF16_OPS_PER_S),
    }
    # K7: V2-Lite's 16 heads, rank 512, RoPE 64, bf16 latent factors.
    nh, rank, rope = 16, 512, 64
    us7 = torch.randn((b, s_p, rank), generator=gen, device=dev).to(bf)
    k_pe = torch.randn((b, s_p, rope), generator=gen, device=dev).to(bf)
    r = torch.rand((b, s_p), generator=gen, device=dev) + 0.5
    qe7 = (torch.randn((b, nh, rank), generator=gen, device=dev) * 1.5 / rank).to(bf)
    qp7 = (torch.randn((b, nh, rope), generator=gen, device=dev) * 0.1).to(bf)
    rows["K7"] = (k2.mla_rankspace_kernel, k2.mla_rankspace_kernel_plain,
                  (qe7, qp7, us7, k_pe, r, lengths),
                  live * (bytes_per_row(us7, k_pe) + 4) + nbytes(qe7, qp7),
                  2.0 * nh * live * (2 * rank + rope) / BF16_OPS_PER_S)
    for key, (run, plain, args, in_bytes, ops_s) in rows.items():
        out, lse = run(*args)
        ref, lse_ref = plain(*args)
        torch.cuda.synchronize()
        _hold_slots(key, f"b4 lengths={list(BATCH_LENS)}", out, ref, lse, lse_ref, worst[key])
        t = dict(ms=cuda_time_ms(lambda: run(*args)),
                 plain_ms=cuda_time_ms(lambda: plain(*args)),
                 bound=bound_ms(in_bytes + nbytes(out, lse), ops_s))
        row = dict(_row(t), lengths=list(BATCH_LENS), max_rel_err=worst[key]["rel"],
                   max_lse_err=worst[key]["lse"])
        log(f"{key} b4 ms: {row}")
        rec = results[key]
        rec["b4"] = row
        rec["max_abs_err"] = max(rec["max_abs_err"], worst[key]["abs"])
        rec["max_rel_err"] = max(rec["max_rel_err"], worst[key]["rel"])
        rec["max_lse_err"] = max(rec["max_lse_err"], worst[key]["lse"])


# Phase 8 requests: (prompt length, new tokens). With 4 slots, 64-row
# tails and s_max 8704 (17 x 512), slots free and refill mid-run and the
# requests of 72 new tokens and more fold once.
BATCH_8B = ((8192, 96), (5000, 40), (3000, 72), (7000, 24), (1500, 128), (8192, 64),
            (2048, 48), (4000, 80))
BATCH_MLA = ((8192, 96), (3000, 40), (6000, 72), (1500, 128), (5000, 24), (8192, 64))
BATCH_ENGINE = dict(num_slots=4, s_max=8704, tail_max=64, prefill_buckets=[2048, 4096, 8192])
# Requests teacher-forced through the single-stream engine: the longest
# (refolded), a ragged one (5000 / 3000 rows, no refold) and a refolded
# short one.
BATCH_REFS = (0, 1, 4)
# Steps of the first run checked against the eager batched step.
BATCH_EAGER_STEPS = 16


def batch_phase_time(results, part: str, seconds: float) -> None:
    results.setdefault("batch_phase_s", {})[part] = seconds
    log(f"batch phase, {part}: {seconds:.1f} s")


def prompt_rows(cache1, s: int, eng):
    """A request's admitted batch-1 cache (``BatchedEngine._compress_kvs``,
    ``bucket`` rows, those past the prompt's ``s`` zero) cut to its ``s``
    rows, with an empty tail of the engine's: the factors the request's
    slot holds, as a single-stream cache. Chunk bounds keep the chunks
    that hold rows below ``s``. A compact SLERP side keeps its first ``s``
    rows, and kept rows past them (zero rows) become repeats of entry 0,
    the largest angle (a row below ``s``), as the slot's padding does."""
    import dataclasses

    import torch

    from xkv_tpu_torch.cache import (
        GroupFactors,
        SlerpCompact,
        XKVCache,
        empty_tail_len,
        init_tail,
    )

    rows = {"k_us", "v_us", "k_us4", "v_us4"}

    def cut(name, x):
        if isinstance(x, SlerpCompact):
            past = (x.keep_idx >= s)[..., None, None]
            return SlerpCompact(
                base=x.base[:, :, :s].contiguous(), norms=x.norms[:, :, :s].contiguous(),
                keep_idx=torch.where(past[..., 0, 0], x.keep_idx[..., :1], x.keep_idx),
                keep_rows=torch.where(past, x.keep_rows[:, :, :1], x.keep_rows))
        if x is None or name not in rows | {"k_rnorm", "k_cmin", "k_cmax"}:
            return x
        if name == "k_rnorm":
            return x[:, :, :s].contiguous()
        if name in rows:
            return x[:, :s].contiguous()
        return x[:, :-(-s // eng.sparse_block)].contiguous()

    groups = tuple(GroupFactors(**{f.name: cut(f.name, getattr(g, f.name))
                                   for f in dataclasses.fields(GroupFactors)})
                   for g in cache1.groups)
    tail_k, tail_v = init_tail(eng.cfg, 1, eng.tail_max, eng.cache_dtype, "cuda")
    return XKVCache(groups=groups,
                    dense_k={l: d[:, :, :s].contiguous() for l, d in cache1.dense_k.items()},
                    dense_v={l: d[:, :, :s].contiguous() for l, d in cache1.dense_v.items()},
                    tail_k=tail_k, tail_v=tail_v, tail_len=empty_tail_len("cuda"))


def teacher_force(label, eng, single, cfg, prompts, gens, admitted, ids, gap,
                  refs=BATCH_REFS):
    """The ``refs`` requests' tokens ``gens`` teacher-forced through
    ``single`` (the same configuration, single-stream, exact steps) over
    each request's own admitted factors (``admitted``: request id ->
    batch-1 cache; the bucket's padding rows cut off, ``prompt_rows``), so
    they read the cache the batched steps read, up to the first refold;
    the first token against the model's prefill at the prompt's exact
    length. Each token must be within ``gap`` of its step's top log-prob.
    Returns (a row per request, the launches)."""
    import torch

    from xkv_tpu_torch.models import deepseek as deepseek_model
    from xkv_tpu_torch.models import llama as llama_model

    model = deepseek_model if eng._mla else llama_model
    ref_rows, ref_counts, bad = [], {key: 0 for key in COUNTERS}, []
    for i in refs:
        tok = torch.as_tensor(gens[i], device="cuda")[None]
        s = int(prompts[i].shape[0])
        reset_counts()
        logits, _ = model.prefill(eng.params, cfg, torch.as_tensor(prompts[i], device="cuda")[None],
                                  logits_position=s - 1)
        n = min(tok.shape[1] - 1, single.tail_max)
        cache = prompt_rows(admitted.pop(ids[i]), s, eng)
        lp, _ = single.score(cache, tok[:, :n], s)
        steps = torch.cat([torch.log_softmax(logits[0, -1:].float(), -1), lp[0]])
        behind = (steps.max(-1).values - steps.gather(1, tok[0, :n + 1, None])[:, 0]).tolist()
        for key, v in read_counts().items():
            ref_counts[key] += v
        worst = max(range(len(behind)), key=lambda j: behind[j])
        ref_rows.append(dict(request=i, prompt=s, steps=n,
                             max_logprob_below_top=behind[worst], at_step=worst,
                             greedy_equal_through=int(
                                 (tok[0, :n + 1] == steps.argmax(-1)).long().cumprod(0).sum())))
        del cache, logits
        if behind[worst] > gap:
            bad.append(f"request {i}'s token {worst} is {behind[worst]:.4e} below its step's "
                       f"top log-prob (limit {gap:.4e})")
    if bad:
        raise AssertionError(f"{label}: {'; '.join(bad)} ({json.dumps(ref_rows)})")
    return ref_rows, ref_counts


def serve_batched(label, eng, single, cfg, requests, kernel, gap, b1_ms, gen,
                  eager_steps=0, refs=BATCH_REFS):
    """One phase-8 run: every request of ``requests`` through ``eng``
    (``BatchedEngine.run``, the captured batched step), admissions and
    refolds timed; then the checks of the module docstring: every
    request's ``max_new_tokens``, the first ``eager_steps`` steps and the
    first step after each refold against the eager batched step on the
    same inputs (tokens equal), launch counts against the
    steps (``kernel`` the decode kernel, None for a step that runs none),
    one capture, and the ``refs`` requests' tokens
    teacher-forced through ``single`` (the same configuration,
    single-stream) up to their first refold, each within ``gap`` of its
    step's top log-prob. The references decode each request's own
    admitted factors (``prompt_rows``): a reference that factorised the
    prompt anew reads other factors (another SVD's rounding, and int4
    codes that move with it: on an H100 an 8B int4 token of a ragged
    request sat 1.625 below such a reference's top, where int4 against
    int8 factors moves the first-step logits by 2.68). Then the step's
    device time under torch.profiler. Returns (row, launches)."""
    import torch

    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen, device="cuda").cpu().numpy()
               for n, _ in requests]
    graph = eng.step_graph
    state = dict(admission_s=0.0, replayed_tokens=0, eager_checked=0, eager_s=0.0,
                 refolds=0, refold_s=0.0, refold_checked=0, refolded=False)
    admit, run_step, refactor = eng._admit, graph.run, eng._refactor

    def timed_admit():
        torch.cuda.synchronize()
        t0 = time.time()
        admit()
        torch.cuda.synchronize()
        state["admission_s"] += time.time() - t0

    def timed_refactor(slot, plen):
        torch.cuda.synchronize()
        t0 = time.time()
        refactor(slot, plen)
        torch.cuda.synchronize()
        state["refold_s"] += time.time() - t0
        state["refolds"] += 1
        state["refolded"] = True

    def checked_run():
        replay, active = graph.graph is not None, len(eng.slot_request)
        if state["eager_checked"] < eager_steps or state["refolded"]:
            # The eager step, then the graph's, on the same inputs: the
            # second writes the same tail rows again. Also the first step
            # after each refold: the graph reads the refolded factors
            # through the addresses bound at capture, the eager step
            # through the tensors as they are.
            torch.cuda.synchronize()
            t0 = time.time()
            eager = graph.run_eager()  # its token read syncs
            state["eager_s"] += time.time() - t0
            got = run_step()
            if not (eager == got).all():
                raise AssertionError(f"{label}: graph tokens {got} differ from the eager "
                                     f"batched step's {eager}")
            state["eager_checked"] += 1
            state["refold_checked"] += state["refolded"]
            state["refolded"] = False
        else:
            got = run_step()
        if replay:
            state["replayed_tokens"] += active
        return got

    ids = [eng.submit(p, n) for p, (_, n) in zip(prompts, requests)]
    admitted = {}  # request id -> its batch-1 admitted cache, for the references
    place = eng._place

    def keep_place(slot, req, cache1, first_token, s):
        if req.request_id in [ids[i] for i in refs]:
            admitted[req.request_id] = cache1
        place(slot, req, cache1, first_token, s)

    eng._admit, eng._place, graph.run = timed_admit, keep_place, checked_run
    eng._refactor = timed_refactor
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    done = {r.request_id: r for r in eng.run()}
    torch.cuda.synchronize()
    wall_s = time.time() - t0
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del eng._admit, eng._place, eng._refactor, graph.run  # the class's own methods again
    gens = [done[i].generated for i in ids]
    if [len(g) for g in gens] != [n for _, n in requests]:
        raise AssertionError(f"{label}: tokens per request {[len(g) for g in gens]}")
    if not all(0 <= t < cfg.vocab_size for g in gens for t in g):
        raise AssertionError(f"{label}: a token out of the vocabulary")
    if not state["refolds"] or state["refold_checked"] < 1:
        raise AssertionError(f"{label}: {state['refolds']} refolds, "
                             f"{state['refold_checked']} steps after one checked")
    replay_ms, replays = graph.replay_ms()
    # One capture, at the first step; every later step a replay.
    if graph.capture_ms is None or replays != graph.steps - 1:
        raise AssertionError(f"{label}: {graph.steps} steps, {replays} replays, "
                             f"capture {graph.capture_ms}")
    L = cfg.num_layers
    want = {key: 0 for key in COUNTERS}
    if kernel is not None:
        want[kernel] = L * (graph.steps + state["eager_checked"])
    if eng.prefill_chunk is None and not eng._mla:
        want["K1"] = L * len(requests)
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, the steps imply {want}")

    t_ref = time.time()
    ref_rows, ref_counts = teacher_force(label, eng, single, cfg, prompts, gens, admitted, ids,
                                         gap, refs)
    # Device time of the captured step (torch.profiler over replays on the
    # run's last inputs).
    profile = _profile(graph.graph.replay, 3, replay_ms / replays)
    ref_s = time.time() - t_ref
    emitted = state["replayed_tokens"]
    step_ms = replay_ms / replays
    row = dict(run=label, requests=len(requests), slots=eng.num_slots, steps=graph.steps,
               replays=replays, replay_ms_per_step=step_ms,
               decode_tokens_per_s=emitted / (replay_ms / 1e3),
               b1_graph_ms_per_token=b1_ms, b1_tokens_per_s=1e3 / b1_ms,
               step_vs_b1=step_ms / b1_ms, admission_s=state["admission_s"],
               refolds=state["refolds"], refold_s=state["refold_s"],
               eager_check_s=state["eager_s"],
               # The wall's rest: the first (capture) step, the host's loop
               # and the steps' token reads (the eager steps' time is
               # eager_check_s, every replay's is in replay_ms).
               other_s=(wall_s - state["admission_s"] - state["refold_s"] - state["eager_s"]
                        - replay_ms / 1e3),
               # Every token after the first of each request, over the
               # whole run's host clock (admissions and refolds included).
               wall_decode_tokens_per_s=sum(len(g) - 1 for g in gens) / wall_s,
               capture_ms=graph.capture_ms, peak_allocated_gb=peak_gb, wall_s=wall_s,
               eager_checked_steps=state["eager_checked"],
               eager_checked_after_refold=state["refold_checked"], launches=counts,
               references=ref_rows, near_tie_limit=gap, reference_wall_s=ref_s,
               profile=profile)
    log("batch " + json.dumps(row))
    return row, {key: counts[key] + ref_counts[key] for key in COUNTERS}


def batched_8b(results, params, cfg, served):
    """Llama-3.1-8B xKV-4 through ``BatchedEngine`` (4 slots): factored pre
    bf16 (K3), post int4 (K6), both admitted monolithically (K1), and
    sparse top-4 post bf16 over 512-row chunks (K4), admitted in
    2048-token chunks. Returns the launches."""
    import torch

    from xkv_tpu_torch.configs import generate_consecutive_xkv_config
    from xkv_tpu_torch.engine import BatchedEngine, InferenceEngine

    t0 = time.time()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 8)
    top4 = dict(sparse_topk=4, sparse_block=512)
    runs = [("8B batch pre bf16", "pre", torch.bfloat16, {}, "K3", "factored pre bf16"),
            ("8B batch post int4", "post", "int4", {}, "K6", "factored post int4 refactorize"),
            ("8B batch post bf16 sparse top-4, chunked admission", "post", torch.bfloat16,
             dict(top4, prefill_chunk=2048), "K4", "factored post bf16 sparse top-4")]
    totals = {key: 0 for key in COUNTERS}
    rows = []
    for label, rope, fdt, kw, kernel, b1_run in runs:
        xkv = generate_consecutive_xkv_config(
            group_size=4, rank_k=512, rank_v=768, num_layers=cfg.num_layers,
            end_layer=cfg.num_layers - 1, extra_kwargs={"rope_mode": rope})
        eng = BatchedEngine(params, cfg, xkv, factor_dtype=fdt, device="cuda",
                            **BATCH_ENGINE, **kw)
        single_kw = {k: v for k, v in kw.items() if k != "prefill_chunk"}
        single = InferenceEngine(params, cfg, xkv, tail_max=BATCH_ENGINE["tail_max"],
                                 factor_dtype=fdt, prefill_logits="last", device="cuda",
                                 **single_kw)
        row, counts = serve_batched(label, eng, single, cfg, BATCH_8B, kernel, GAP_8B,
                                    served[b1_run], gen,
                                    eager_steps=BATCH_EAGER_STEPS if not rows else 0)
        rows.append(row)
        for key in totals:
            totals[key] += counts[key]
        del eng, single
        torch.cuda.empty_cache()
    results["batch_runs"] = rows
    batch_phase_time(results, "8B", time.time() - t0)
    return totals


def batched_mla(results, params, cfg, xkv, served):
    """DeepSeek-V2-Lite factored bf16 (K7) through ``BatchedEngine`` (4
    slots), admitted in 2048-token chunks. Returns the launches."""
    import torch

    from xkv_tpu_torch.engine import BatchedEngine, InferenceEngine

    t0 = time.time()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 9)
    eng = BatchedEngine(params, cfg, xkv, device="cuda", prefill_chunk=2048, **BATCH_ENGINE)
    single = InferenceEngine(params, cfg, xkv, tail_max=BATCH_ENGINE["tail_max"],
                             prefill_logits="last", device="cuda")
    row, counts = serve_batched("V2-Lite batch bf16, chunked admission", eng, single, cfg,
                                BATCH_MLA, "K7", GAP_MLA, served["mla factored bf16"], gen)
    results["batch_runs_mla"] = [row]
    del eng, single
    torch.cuda.empty_cache()
    batch_phase_time(results, "V2-Lite", time.time() - t0)
    return counts


# ------------------------------------------------------ batched speculation
# Phase 9. Kernel holds at the batched round's new shapes: K2 and K3 at b 4
# x ql 8 (the verify pass of 4 slots at speculative_k 7, R 256 a slot) over
# BATCH_LENS, K7 at b 4 x ql 8, and K7 over the factors' first 128 and 120
# columns at b 4 (the batched MLA draft); the empty slot gives 0 / -inf.
BATCH_SPEC_K = 7


def check_batched_spec_kernels(gen, results):
    """K2 and K3 at the 8B xKV-4 shapes and K7 at V2-Lite's, b = 4 over
    ``BATCH_LENS``, bf16 factors: the verify pass (ql 8) and K7's draft
    views, against their plain versions, each timed beside its plain
    version and its bound over the live rows ("b4_ql8" and
    "b4_draft_view_<width>" rows of the kernel records)."""
    import torch
    import torch.nn.functional as F

    from xkv_tpu_torch.cache import vt_layer_slice
    from xkv_tpu_torch.ops.kernels import lowrank_attention as k3
    from xkv_tpu_torch.ops.kernels import rankspace_attention as k2
    from xkv_tpu_torch.ops.rope import rope_cos_sin

    dev, bf, b, ql = "cuda", torch.bfloat16, len(BATCH_LENS), BATCH_SPEC_K + 1
    lengths = torch.tensor(BATCH_LENS, device=dev)
    live = sum(BATCH_LENS)
    worst = {key: {"abs": 0.0, "rel": 0.0, "lse": 0.0} for key in ("K2", "K3", "K7")}
    hq, hkv, hd, s_p, rk, rv = LOWRANK_SHAPES["8B"]
    m, scale = hkv * hd, 1.0 / math.sqrt(hd)
    us_k = torch.randn((b, s_p, rk), generator=gen, device=dev)
    vt_k = torch.randn((b, rk, 4 * m), generator=gen, device=dev) * 0.05
    us_v = torch.randn((b, s_p, rv), generator=gen, device=dev)
    vt_v = torch.randn((b, rv, 4 * m), generator=gen, device=dev) * 0.05
    sl = lambda x: vt_layer_slice(x, 1, hkv, hd)  # noqa: E731
    k_us, v_us = us_k.to(bf), us_v.to(bf)
    q = torch.randn((b, hq, ql, hd), generator=gen, device=dev).to(bf)
    q_emb = k2._project_q(q, sl(vt_k.to(bf)), hkv, scale, None, bf)
    R = q_emb.shape[1]
    # Each slot's queries at positions valid_len + 5 + i.
    cos_p, sin_p = rope_cos_sin(torch.arange(s_p, device=dev), hd, 500000.0)
    cos_t, sin_t = rope_cos_sin(lengths[:, None] + 5 + torch.arange(ql, device=dev)[None], hd,
                                500000.0)
    cos_h, sin_h = k3.half_tables(cos_p, sin_p, bf)
    qab = k3._query_embeds(q, cos_t, sin_t, hkv, scale, None)
    kw3 = dict(num_q_heads=hq, num_kv_heads=hkv)
    slice_bytes = b * (rk * m + rv * m) * 2
    rows = {
        ("K2", "b4_ql8"): (
            k2.rankspace_kernel, k2.rankspace_kernel_plain, (q_emb, k_us, v_us, lengths),
            live * bytes_per_row(k_us, v_us) + nbytes(q_emb),
            2.0 * R * live * (rk + rv) / BF16_OPS_PER_S),
        ("K3", "b4_ql8"): (
            lambda *a: k3.lowrank_kernel(*a, **kw3), lambda *a: k3.lowrank_kernel_plain(*a, **kw3),
            (qab, k_us, sl(vt_k.to(bf)), v_us, sl(vt_v.to(bf)), cos_h, sin_h, None, lengths,
             None),
            live * bytes_per_row(k_us, v_us, cos_h, sin_h) + nbytes(qab) + slice_bytes,
            (2.0 * live * rk * m + 2.0 * R * live * (2 * hd + rv)) / BF16_OPS_PER_S),
    }
    # K7: V2-Lite's 16 heads, rank 512, RoPE 64, bf16 latent factors.
    nh, rank, rope = 16, 512, 64
    us7 = torch.randn((b, s_p, rank), generator=gen, device=dev).to(bf)
    k_pe = torch.randn((b, s_p, rope), generator=gen, device=dev).to(bf)
    r = torch.rand((b, s_p), generator=gen, device=dev) + 0.5
    qe7 = (torch.randn((b, ql * nh, rank), generator=gen, device=dev) * 1.5 / rank).to(bf)
    qp7 = (torch.randn((b, ql * nh, rope), generator=gen, device=dev) * 0.1).to(bf)
    rows[("K7", "b4_ql8")] = (
        k2.mla_rankspace_kernel, k2.mla_rankspace_kernel_plain, (qe7, qp7, us7, k_pe, r, lengths),
        live * (bytes_per_row(us7, k_pe) + 4) + nbytes(qe7, qp7),
        2.0 * ql * nh * live * (2 * rank + rope) / BF16_OPS_PER_S)
    # The batched draft: one query row per head, the factors' first
    # ``width`` columns read in place through their row stride, q_emb zero
    # past ``width`` up to ``rank_width`` (as the wrapper pads it).
    for width in (128, 120):
        view = us7[..., :width]
        qe = F.pad(torch.randn((b, nh, width), generator=gen, device=dev) * 1.5 / width,
                   (0, k2.rank_width(width) - width)).to(bf)
        qp = (torch.randn((b, nh, rope), generator=gen, device=dev) * 0.1).to(bf)
        rows[("K7", f"b4_draft_view_{width}")] = (
            k2.mla_rankspace_kernel, k2.mla_rankspace_kernel_plain,
            (qe, qp, view, k_pe, r, lengths),
            live * (bytes_per_row(view, k_pe) + 4) + nbytes(qe, qp),
            2.0 * nh * live * (2 * width + rope) / BF16_OPS_PER_S)
    for (key, label), (run, plain, args, in_bytes, ops_s) in rows.items():
        out, lse = run(*args)
        ref, lse_ref = plain(*args)
        torch.cuda.synchronize()
        _hold_slots(key, f"{label} lengths={list(BATCH_LENS)}", out, ref, lse, lse_ref,
                    worst[key])
        t = dict(ms=cuda_time_ms(lambda: run(*args)),
                 plain_ms=cuda_time_ms(lambda: plain(*args)),
                 bound=bound_ms(in_bytes + nbytes(out, lse), ops_s))
        row = dict(_row(t), lengths=list(BATCH_LENS), rows_per_slot=args[0].shape[1])
        log(f"{key} {label} ms: {row}")
        results[key][label] = row
    for key in worst:
        rec = results[key]
        rec["max_abs_err"] = max(rec["max_abs_err"], worst[key]["abs"])
        rec["max_rel_err"] = max(rec["max_rel_err"], worst[key]["rel"])
        rec["max_lse_err"] = max(rec["max_lse_err"], worst[key]["lse"])


def spec_phase9_time(results, part: str, seconds: float) -> None:
    results.setdefault("batch_spec_phase_s", {})[part] = seconds
    log(f"batched-speculation and persistence phase, {part}: {seconds:.1f} s")


# Served runs: phase 8's engine and its first five requests (the
# referenced ones among them), speculative_k 7.
BATCH_SPEC_8B = BATCH_8B[:5]
BATCH_SPEC_MLA = BATCH_MLA[:5]
# Replayed rounds checked against an eager round on the same inputs, and
# the first replayed round after each refold.
BATCH_SPEC_EAGER_ROUNDS = 2


def serve_batched_spec(label, eng, single, cfg, requests, draft_kernel, exact_kernel, gap,
                       plain_row, gen):
    """One phase-9 run: every request of ``requests`` through ``eng``
    (``BatchedEngine.run`` with ``speculative_k``: captured draft and
    verify steps, exact top-ups on the captured plain step); every
    request's tokens; the first ``BATCH_SPEC_EAGER_ROUNDS`` replayed rounds
    and the first one after each refold against an eager round on the
    same inputs (n_out and tokens equal); launches against the rounds and
    steps (``draft_kernel`` k a round, ``exact_kernel`` one a round and one
    a top-up, K1 one an admission where it prefills); each graph captured
    once; the ``BATCH_REFS`` requests' tokens teacher-forced through
    ``single`` (exact steps) up to their first refold, each within
    ``gap`` of its step's top log-prob (``teacher_force``). Reports
    rounds, tokens a round, top-ups, draft and verify replay ms, tokens/s
    beside ``plain_row`` (phase 8's plain step), capture ms. Returns (row,
    launches)."""
    import torch

    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen, device="cuda").cpu().numpy()
               for n, _ in requests]
    spec, step = eng.spec_graph, eng.step_graph
    k = eng.speculative_k
    state = dict(admission_s=0.0, refolds=0, refold_s=0.0, checked=0, refold_checked=0,
                 refolded=False, eager_s=0.0, slot_rounds=0)
    admit, refactor, run_round = eng._admit, eng._refactor, spec.run

    def timed_admit():
        torch.cuda.synchronize()
        t0 = time.time()
        admit()
        torch.cuda.synchronize()
        state["admission_s"] += time.time() - t0

    def timed_refactor(slot, plen):
        torch.cuda.synchronize()
        t0 = time.time()
        refactor(slot, plen)
        torch.cuda.synchronize()
        state["refold_s"] += time.time() - t0
        state["refolds"] += 1
        state["refolded"] = True

    def checked_round():
        state["slot_rounds"] += len(eng.slot_request)
        if spec.draft_graph is not None and (state["checked"] < BATCH_SPEC_EAGER_ROUNDS
                                             or state["refolded"]):
            # The round eagerly, then replayed from the same start: the
            # replay writes the same tail rows again.
            torch.cuda.synchronize()
            t0 = time.time()
            for _ in range(k):
                spec._draft()
            spec._verify()
            eager = spec.result.cpu().numpy()
            state["eager_s"] += time.time() - t0
            spec.load(eng.token, eng.pos, eng.prefill_len, eng.tail_len)
            n_out, exact = run_round()
            active = list(eng.slot_request)
            if not ((eager[active, 0] == n_out[active]).all()
                    and all((eager[s, 1:1 + n_out[s]] == exact[s, :n_out[s]]).all()
                            for s in active)):
                raise AssertionError(f"{label}: a replayed round ({n_out}, {exact}) differs "
                                     f"from the eager round ({eager})")
            state["checked"] += 1
            state["refold_checked"] += state["refolded"]
            state["refolded"] = False
            return n_out, exact
        return run_round()

    ids = [eng.submit(p, n) for p, (_, n) in zip(prompts, requests)]
    admitted = {}
    place = eng._place

    def keep_place(slot, req, cache1, first_token, s):
        if req.request_id in [ids[i] for i in BATCH_REFS]:
            admitted[req.request_id] = cache1
        place(slot, req, cache1, first_token, s)

    eng._admit, eng._place, eng._refactor, spec.run = timed_admit, keep_place, timed_refactor, \
        checked_round
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    done = {r.request_id: r for r in eng.run()}
    torch.cuda.synchronize()
    wall_s = time.time() - t0
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del eng._admit, eng._place, eng._refactor, spec.run
    gens = [done[i].generated for i in ids]
    if [len(g) for g in gens] != [n for _, n in requests]:
        raise AssertionError(f"{label}: tokens per request {[len(g) for g in gens]}")
    if not all(0 <= t < cfg.vocab_size for g in gens for t in g):
        raise AssertionError(f"{label}: a token out of the vocabulary")
    stats = dict(eng.spec_stats)
    rounds, plain = stats["rounds"], stats["plain_steps"]
    t = spec.timing
    if (rounds < 2 or t.draft_capture_ms is None or t.verify_capture_ms is None
            or len(t.events) != rounds - 1):
        raise AssertionError(f"{label}: {rounds} rounds, {len(t.events)} replayed, captures "
                             f"{t.draft_capture_ms} / {t.verify_capture_ms}")
    step_ms, step_replays = step.replay_ms()
    if plain and (step.capture_ms is None or step_replays != step.steps - 1):
        raise AssertionError(f"{label}: {step.steps} top-up steps, {step_replays} replays")
    if not state["refolds"] or state["checked"] < BATCH_SPEC_EAGER_ROUNDS:
        raise AssertionError(f"{label}: {state['refolds']} refolds, {state['checked']} rounds "
                             "checked against eager ones")
    L = cfg.num_layers
    checked = state["checked"]
    want = {key: 0 for key in COUNTERS}
    want[draft_kernel] += L * k * (rounds + checked)
    want[exact_kernel] += L * (rounds + checked + plain)
    if eng.prefill_chunk is None and not eng._mla:
        want["K1"] = L * len(requests)
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, the rounds imply {want}")

    t_ref = time.time()
    ref_rows, ref_counts = teacher_force(label, eng, single, cfg, prompts, gens, admitted, ids,
                                         gap)
    draft_ms, verify_ms, round_tokens = t.replayed()
    replayed = len(t.events)
    row = dict(run=label, requests=len(requests), slots=eng.num_slots, speculative_k=k,
               rounds=rounds, round_tokens=stats["round_tokens"], plain_steps=plain,
               tokens_per_round=stats["round_tokens"] / rounds,
               tokens_per_slot_round=stats["round_tokens"] / state["slot_rounds"],
               replayed_rounds=replayed,
               draft_replay_ms=draft_ms / (replayed * k), verify_replay_ms=verify_ms / replayed,
               round_ms=(draft_ms + verify_ms) / replayed,
               round_tokens_per_s=round_tokens / ((draft_ms + verify_ms) / 1e3),
               top_up_replay_ms_per_step=step_ms / step_replays if step_replays else None,
               plain_run=plain_row["run"],
               plain_replay_ms_per_step=plain_row["replay_ms_per_step"],
               plain_decode_tokens_per_s=plain_row["decode_tokens_per_s"],
               draft_capture_ms=t.draft_capture_ms, verify_capture_ms=t.verify_capture_ms,
               top_up_capture_ms=step.capture_ms, admission_s=state["admission_s"],
               refolds=state["refolds"], refold_s=state["refold_s"],
               eager_checked_rounds=checked, eager_checked_after_refold=state["refold_checked"],
               eager_check_s=state["eager_s"],
               wall_decode_tokens_per_s=sum(len(g) - 1 for g in gens) / wall_s,
               wall_s=wall_s, peak_allocated_gb=peak_gb, launches=counts, references=ref_rows,
               near_tie_limit=gap, reference_wall_s=time.time() - t_ref)
    row["round_tokens_per_s_vs_plain"] = row["round_tokens_per_s"] / row[
        "plain_decode_tokens_per_s"]
    log("batch-spec " + json.dumps(row))
    return row, {key: counts[key] + ref_counts[key] for key in COUNTERS}


def batched_spec_8b(results, params, cfg, engine, prompt, beside_persistence=None):
    """Phase 9 on Llama-3.1-8B xKV-4: ``BatchedEngine(speculative_k=7)``
    with sparse top-4 drafts in pre (K5 drafts, K3 verify and top-ups) and
    post (K4, K2), admitted through K1; then prompt-cache persistence of
    the 8192-token factored pre cache. Returns the launches."""
    import torch

    from xkv_tpu_torch.configs import generate_consecutive_xkv_config
    from xkv_tpu_torch.engine import BatchedEngine, InferenceEngine

    t0 = time.time()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 10)
    top4 = dict(sparse_topk=4, sparse_block=512)
    plain = {r["run"]: r for r in results["batch_runs"]}
    runs = [("8B batch-spec pre bf16 sparse top-4", "pre", "K5", "K3", "8B batch pre bf16"),
            ("8B batch-spec post bf16 sparse top-4", "post", "K4", "K2",
             "8B batch post bf16 sparse top-4, chunked admission")]
    totals = {key: 0 for key in COUNTERS}
    rows = []
    for label, rope, draft_kernel, exact_kernel, plain_run in runs:
        xkv = generate_consecutive_xkv_config(
            group_size=4, rank_k=512, rank_v=768, num_layers=cfg.num_layers,
            end_layer=cfg.num_layers - 1, extra_kwargs={"rope_mode": rope})
        eng = BatchedEngine(params, cfg, xkv, device="cuda", speculative_k=BATCH_SPEC_K,
                            **BATCH_ENGINE, **top4)
        single = InferenceEngine(params, cfg, xkv, tail_max=BATCH_ENGINE["tail_max"],
                                 prefill_logits="last", device="cuda")
        row, counts = serve_batched_spec(label, eng, single, cfg, BATCH_SPEC_8B, draft_kernel,
                                         exact_kernel, GAP_8B, plain[plain_run], gen)
        rows.append(row)
        for key in totals:
            totals[key] += counts[key]
        del eng, single
        torch.cuda.empty_cache()
    results["batch_spec_runs"] = rows
    spec_phase9_time(results, "8B served", time.time() - t0)
    t0 = time.time()
    if beside_persistence is not None:
        beside_persistence()
    persist_counts = persistence_8b(results, cfg, engine, prompt)
    for key in totals:
        totals[key] += persist_counts[key]
    spec_phase9_time(results, "8B persistence", time.time() - t0)
    return totals


def persistence_8b(results, cfg, engine, prompt):
    """``save_cache`` / ``load_cache`` of the 8B factored pre cache at 8192
    tokens, bf16 and int8 factors: file MB against ``num_cache_bytes``
    (the factors; the file also holds the 128-row tail), save and load s
    (host clock, the device copies included), every leaf equal bitwise,
    and the first decode step's logits after the load equal to those
    before it, bitwise. The files go under build/ and are removed."""
    import torch

    from xkv_tpu_torch.engine.cache_io import cache_leaves, load_cache, save_cache

    totals = {key: 0 for key in COUNTERS}
    rows = []
    for fdt, name in ((torch.bfloat16, "bf16"), ("int8", "int8")):
        eng = engine("factored", "pre", fdt, 128)
        reset_counts()
        rows.append(persist(eng, prompt, f"8b_pre_{name}", dict(factors=name)))
        for key, n in read_counts().items():
            totals[key] += n
        del eng
        torch.cuda.empty_cache()
    results["persistence"] = rows
    return totals


def persist(eng, prompt, name: str, row: dict) -> dict:
    """``eng``'s prefill cache of ``prompt`` saved (build/cache_io/``name``)
    and loaded: ``row`` with the file MB, ``num_cache_bytes``, save and
    load s, and whether every leaf and the first decode step's logits
    after the load equal those before it, bitwise (it fails otherwise).
    The files are removed."""
    import torch

    from xkv_tpu_torch.engine.cache_io import cache_leaves, load_cache, save_cache

    s = prompt.shape[1]
    logits, cache = eng.prefill(prompt)
    tok = logits[:, -1].argmax(-1)[:, None]
    path = os.path.join(ROOT, "build", "cache_io", name)
    torch.cuda.synchronize()
    t0 = time.time()
    save_cache(cache, path, metadata={"prompt_len": s})
    save_s = time.time() - t0
    before, _ = eng.decode_step(cache, tok, s)
    torch.cuda.synchronize()
    t0 = time.time()
    loaded, meta = load_cache(path, cache)
    torch.cuda.synchronize()
    load_s = time.time() - t0
    after, _ = eng.decode_step(loaded, tok, s)
    same_leaves = all(torch.equal(a, b) for a, b in zip(cache_leaves(cache),
                                                         cache_leaves(loaded)))
    file_bytes = os.path.getsize(path + ".npz")
    row = dict(row, file_mb=file_bytes / 1e6, num_cache_mb=cache.num_cache_bytes() / 1e6,
               file_vs_num_cache_bytes=file_bytes / cache.num_cache_bytes(),
               save_s=save_s, load_s=load_s, leaves_equal=same_leaves,
               first_step_logits_equal=bool(torch.equal(before, after)), metadata=meta)
    log("persist " + json.dumps(row))
    for suffix in (".npz", ".json"):
        os.remove(path + suffix)
    if not (same_leaves and row["first_step_logits_equal"] and meta == {"prompt_len": s}):
        raise AssertionError(f"persistence {name}: the loaded cache differs ({row})")
    return row


def batched_spec_mla(results, params, cfg, xkv, prompt):
    """Phase 9 on DeepSeek-V2-Lite: ``BatchedEngine(speculative_k=7,
    draft_rank=128)`` (K7 drafts over the factors' first 128 columns, K7
    verify and top-ups), admitted in 2048-token chunks; then the legacy
    reconstruct path: the 8192-token factored cache with ``k_rnorm``
    dropped, its first decode step's logits against the rank-space path's
    (K7). Returns the launches."""
    import dataclasses

    import torch

    from xkv_tpu_torch.engine import BatchedEngine, InferenceEngine

    t0 = time.time()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 11)
    eng = BatchedEngine(params, cfg, xkv, device="cuda", prefill_chunk=2048,
                        speculative_k=BATCH_SPEC_K, draft_rank=128, **BATCH_ENGINE)
    single = InferenceEngine(params, cfg, xkv, tail_max=BATCH_ENGINE["tail_max"],
                             prefill_logits="last", device="cuda")
    row, totals = serve_batched_spec("V2-Lite batch-spec bf16 draft_rank 128, chunked admission",
                                     eng, single, cfg, BATCH_SPEC_MLA, "K7", "K7", GAP_MLA,
                                     results["batch_runs_mla"][0], gen)
    results["batch_spec_runs_mla"] = [row]
    del eng
    torch.cuda.empty_cache()
    spec_phase9_time(results, "V2-Lite served", time.time() - t0)

    t0 = time.time()
    reset_counts()
    logits, cache = single.prefill(prompt)
    tok, s = logits[:, -1].argmax(-1)[:, None], prompt.shape[1]
    rank_space, _ = single.decode_step(cache, tok, s)
    legacy_cache = dataclasses.replace(cache, groups=tuple(
        dataclasses.replace(g, k_rnorm=None) for g in cache.groups))
    after_k7 = read_counts()
    legacy, _ = single.decode_step(legacy_cache, tok, s)
    torch.cuda.synchronize()
    counts = read_counts()
    diff = (legacy[0, -1].float() - rank_space[0, -1].float()).abs().max().item()
    legacy_row = dict(first_step_logits_max_abs_diff=diff, limit=GAP_MLA,
                      max_abs_logit=rank_space.abs().max().item(),
                      legacy_step_launches={k: counts[k] - after_k7[k] for k in COUNTERS},
                      seconds=time.time() - t0)
    log("legacy " + json.dumps(legacy_row))
    if not (diff <= GAP_MLA and all(v == 0 for v in legacy_row["legacy_step_launches"].values())
            and bool(torch.isfinite(legacy).all())):
        raise AssertionError(f"MLA legacy reconstruct path: {legacy_row}")
    results["mla_legacy"] = legacy_row
    for key in totals:
        totals[key] += counts[key]
    del single, cache, legacy_cache
    torch.cuda.empty_cache()
    spec_phase9_time(results, "V2-Lite legacy path", time.time() - t0)
    return totals


# ------------------------------------------------------------- MiniCache
# Phase 10: MiniCache SLERP on Llama-3.1-8B (configs/minicache_llama31_8b.yaml:
# layers 16-31 merged in pairs at gamma 0.05, layers 0-15 dense), served on
# phase 3's weights and prompt. Compact storage keeps the CLI's default
# slerp_keep_frac. The SLERP decode reads its prefill segment (dense or
# rebuilt from compact rows) through the plain dense decode attention: no
# decode kernel, K1 at every prefill.
MINICACHE_KEEP = 0.125
# (label, mode, compact storage, tail_max, new tokens, profiled)
MINICACHE_RUNS = (("minicache fake", "fake", False, 128, 32, False),
                  ("minicache factored dense", "factored", False, 128, 32, False),
                  ("minicache factored compact refactorize", "factored", True, 32, 48, True))
# Batched compact slots: phase 8's engine and its first four requests; the
# longest (refolded), a ragged one (5000 rows) and a refolded 3000-row one
# teacher-forced.
MINICACHE_BATCH, MINICACHE_REFS = BATCH_8B[:4], (0, 1, 2)
# Golden runs of minicache_golden.npz (the in-repo checkpoint in SLERP
# pairs): the decode steps' limit, twice the readings on an H100 (the
# prefill step is phase 4's).
TOL_MINICACHE_ANCHOR = {"dense": 2 * 0.1068, "compact": 2 * 0.1170}


def minicache_phase_time(results, part: str, seconds: float) -> None:
    results.setdefault("minicache_phase_s", {})[part] = seconds
    log(f"minicache phase, {part}: {seconds:.1f} s")


def minicache_xkv(compact: bool):
    """The MiniCache config as shipped, with compact storage at
    ``MINICACHE_KEEP`` when ``compact``."""
    from xkv_tpu_torch.configs import XKVConfig

    xkv = XKVConfig.from_yaml(os.path.join(ROOT, "configs", "minicache_llama31_8b.yaml"))
    if compact:
        xkv.extra_kwargs.update(slerp_compact=True, slerp_keep_frac=MINICACHE_KEEP)
    return xkv


def minicache_8b(results, params, cfg, prompt, served):
    """Phase 10 on the 8B: the ``MINICACHE_RUNS`` through ``serve`` (eager
    loop, then ``generate`` on the graph: equal tokens, K1 only); compact
    against dense storage (``minicache_storage``); the compact
    reconstruction's device time per step; ``BatchedEngine`` over compact
    slots; persistence of the compact cache. Returns the launches."""
    import torch

    from xkv_tpu_torch.engine import InferenceEngine

    t0 = time.time()
    L = cfg.num_layers
    totals = {key: 0 for key in COUNTERS}
    rows, first = [], {}
    for label, mode, compact, tail_max, n_new, profiled in MINICACHE_RUNS:
        eng = InferenceEngine(params, cfg, minicache_xkv(compact), mode=mode, tail_max=tail_max,
                              prefill_logits="last", device="cuda")
        want = {key: 0 for key in COUNTERS}
        want["K1"] = L
        row, counts, first[label] = serve(eng, cfg, prompt, label, n_new, want, profiled)
        rows.append(row)
        for key in totals:
            totals[key] += counts[key]
        del eng
        torch.cuda.empty_cache()
    log(f"minicache: {L} K1 launches per prefill and no decode-kernel launch (K2-K8) in "
        f"{len(rows)} served runs")
    graph_ms = {r["run"]: r["decode_ms_per_token_graph"] for r in rows}
    compact_label, dense_label = MINICACHE_RUNS[2][0], MINICACHE_RUNS[1][0]
    diff = (first[compact_label] - first[dense_label]).abs().max().item()
    log(f"minicache compact vs dense storage first-step logits: max_abs_diff={diff:.4e} "
        f"(phase 3's factored-vs-fake limit {TOL_FACTORED_VS_FAKE:.4e}); graph decode "
        f"ms/token {json.dumps(graph_ms)} beside phase 3's none {served['none']:.4f} and "
        f"fake {served['fake pre']:.4f}")
    results["minicache_runs"] = rows
    minicache_phase_time(results, "served", time.time() - t0)

    t0 = time.time()
    reset_counts()
    storage = minicache_storage(cfg, params, prompt)
    storage["first_step_logits_compact_vs_dense"] = diff
    for key, n in read_counts().items():
        totals[key] += n
    results["minicache_storage"] = storage
    minicache_phase_time(results, "storage", time.time() - t0)

    t0 = time.time()
    batch_counts = minicache_batched(results, params, cfg, graph_ms[compact_label])
    minicache_phase_time(results, "batched", time.time() - t0)

    t0 = time.time()
    eng = InferenceEngine(params, cfg, minicache_xkv(True), tail_max=128,
                          prefill_logits="last", device="cuda")
    reset_counts()
    results["minicache_persistence"] = persist(eng, prompt, "8b_minicache_compact",
                                               dict(storage="compact"))
    for key, n in read_counts().items():
        totals[key] += n + batch_counts[key]
    del eng
    torch.cuda.empty_cache()
    minicache_phase_time(results, "persistence", time.time() - t0)
    return totals


def minicache_storage(cfg, params, prompt) -> dict:
    """One prefill's K/V stored dense and compact (``build_cache``, the
    engine's bf16 cache): for each merged side the kept rows of
    ``compact_reconstruct`` against the dense rows (bitwise), the largest
    row-relative error of the other rows, and the rows the merge kept per
    layer (not divergent, ``slerp_merge_rows``) that fell outside the
    budget; ``num_cache_bytes`` and ``compression_ratio`` of both, held to
    the bytes their shapes give; the device time of the reconstructions
    one decode step makes (CUDA events, and device busy time under
    torch.profiler)."""
    import torch

    from xkv_tpu_torch.compress.slerp import compact_reconstruct, slerp_merge_rows
    from xkv_tpu_torch.engine.compression import build_cache
    from xkv_tpu_torch.models import llama as llama_model
    from xkv_tpu_torch.ops.rope import rope_cos_sin

    s, hkv, hd = prompt.shape[1], cfg.num_kv_heads, cfg.head_dim
    _, kvs = llama_model.prefill(params, cfg, prompt, logits_position=s - 1)
    cos_p, sin_p = rope_cos_sin(torch.arange(s, device="cuda"), hd, cfg.rope_theta,
                                cfg.rope_scaling)
    dense_xkv, compact_xkv = minicache_xkv(False), minicache_xkv(True)
    dense = build_cache(kvs, dense_xkv, cfg, cos_p, sin_p, 1)
    compact = build_cache(kvs, compact_xkv, cfg, cos_p, sin_p, 1)
    kept_equal, rest_err, outside, not_divergent = True, 0.0, 0, 0
    for grp, gf in zip(compact_xkv.layer_groups, compact.groups):
        for side, i, store in (("slerp_k", 0, dense.dense_k), ("slerp_v", 1, dense.dense_v)):
            sc = getattr(gf, side)
            _, div, _, _ = slerp_merge_rows(kvs[grp.layers[0]][i].reshape(-1, hd),
                                            kvs[grp.layers[1]][i].reshape(-1, hd),
                                            grp.slerp_t, grp.slerp_gamma)
            div = div.reshape(1, hkv, s)
            kept = torch.zeros_like(div).scatter_(2, sc.keep_idx.long(), True)
            not_divergent += int((~div).sum())
            outside += int((~div & ~kept).sum())
            for pos, layer in enumerate(grp.layers):
                rec, ref = compact_reconstruct(sc, pos).float(), store[layer].float()
                kept_equal &= bool(torch.equal(rec[kept], ref[kept]))
                err = (rec - ref).abs().amax(-1) / ref.abs().amax(-1).clamp_min(1e-30)
                rest_err = max(rest_err, err[~kept].max().item())
    del kvs
    D = compact.groups[0].slerp_k.keep_idx.shape[2]
    n_dense = cfg.num_layers - 2 * len(compact.groups)
    side_bytes = dict(base=hkv * s * hd * 2, norms=hkv * s * 2 * 4, keep_idx=hkv * D * 4,
                      keep_rows=hkv * D * 2 * hd * 2)
    expect = {"dense": 2 * cfg.num_layers * hkv * s * hd * 2,
              "compact": 2 * n_dense * hkv * s * hd * 2
              + 2 * len(compact.groups) * sum(side_bytes.values())}
    got = {"dense": dense.num_cache_bytes(), "compact": compact.num_cache_bytes()}
    ratio = {"dense": dense.compression_ratio(cfg), "compact": compact.compression_ratio(cfg)}
    del dense

    def reconstruct_step():  # the rebuilds of one decode step
        for g in compact.groups:
            for sc in (g.slerp_k, g.slerp_v):
                for pos in (0, 1):
                    compact_reconstruct(sc, pos, torch.bfloat16)

    recon_ms = cuda_time_ms(reconstruct_step, iters=5)
    recon = _profile(reconstruct_step, 3, recon_ms)
    row = dict(budget_rows=D, kept_rows_bitwise=kept_equal,
               max_row_rel_err_rest=rest_err, not_divergent_rows=not_divergent,
               not_divergent_outside_budget=outside,
               num_cache_gb={k: v / 1e9 for k, v in got.items()}, compression_ratio=ratio,
               compact_side_mb={k: v / 1e6 for k, v in side_bytes.items()},
               reconstruct_ms_per_step=recon_ms,
               reconstruct_device_busy_ms_per_step=recon["device_busy_ms_per_step"],
               reconstruct_top_kernels=recon["top_kernels_ms_per_step"])
    log("minicache storage " + json.dumps(row))
    if not kept_equal:
        raise AssertionError("minicache: kept rows differ from the dense-stored rows")
    if got != expect:
        raise AssertionError(f"minicache: cache bytes {got}, the shapes give {expect}")
    return row


def minicache_batched(results, params, cfg, b1_ms: float):
    """``BatchedEngine`` over compact SLERP slots (phase 8's layout, K1
    monolithic admission) through ``serve_batched``: tokens, the captured
    step against the eager one, refolds, one capture, three requests
    teacher-forced; tokens/s beside phase 8's plain step. Returns the
    launches."""
    import torch

    from xkv_tpu_torch.engine import BatchedEngine, InferenceEngine

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 11)
    xkv = minicache_xkv(True)
    eng = BatchedEngine(params, cfg, xkv, device="cuda", **BATCH_ENGINE)
    single = InferenceEngine(params, cfg, xkv, tail_max=BATCH_ENGINE["tail_max"],
                             prefill_logits="last", device="cuda")
    row, counts = serve_batched("8B batch minicache compact", eng, single, cfg,
                                MINICACHE_BATCH, None, GAP_8B, b1_ms, gen, eager_steps=4,
                                refs=MINICACHE_REFS)
    plain = results["batch_runs"][0]
    log(f"minicache batch: {row['decode_tokens_per_s']:.1f} tokens/s, "
        f"{row['replay_ms_per_step']:.4f} ms a step, beside phase 8's {plain['run']}: "
        f"{plain['decode_tokens_per_s']:.1f} tokens/s, {plain['replay_ms_per_step']:.4f} ms")
    results["minicache_batch"] = dict(row, plain_step_run=plain["run"],
                                      plain_step_tokens_per_s=plain["decode_tokens_per_s"])
    del eng, single
    torch.cuda.empty_cache()
    return counts


def minicache_anchor(results):
    """Teacher-force the JAX engine's MiniCache golden tokens
    (minicache_golden.npz: the in-repo checkpoint in SLERP pairs, dense
    and compact storage) through the port on the card (bf16) and compare
    each step's logits with the golden fp32 ones."""
    import numpy as np
    import torch

    from xkv_tpu_torch.configs import generate_consecutive_xkv_config
    from xkv_tpu_torch.engine import InferenceEngine
    from xkv_tpu_torch.models.ckpt import load_checkpoint

    t0 = time.time()
    gold = np.load(os.path.join(ROOT, "xkv_tpu_torch", "testdata", "minicache_golden.npz"))
    params, cfg = load_checkpoint(os.path.join(ROOT, "results", "production_model"),
                                  dtype=torch.bfloat16, device="cuda")
    prompt = torch.as_tensor(gold["prompt"], device="cuda")
    readings = {}
    for run, tol_decode in TOL_MINICACHE_ANCHOR.items():
        xkv = generate_consecutive_xkv_config(
            layer_merge_impl="slerp", group_size=int(gold["group_size"]),
            num_layers=cfg.num_layers, end_layer=cfg.num_layers - 1,
            slerp_gamma=float(gold["gamma"]), rank_k=None, rank_v=None,
            extra_kwargs={"slerp_compact": run == "compact",
                          "slerp_keep_frac": float(gold["keep_frac"])})
        eng = InferenceEngine(params, cfg, xkv, mode="factored", tail_max=64, device="cuda")
        readings[run] = golden_check(f"minicache anchor {run}", eng, prompt,
                                     gold[f"tokens_{run}"], gold[f"logits_{run}"],
                                     {"prefill": TOL_ANCHOR["prefill"], "decode": tol_decode},
                                     {"K1": cfg.num_layers})
    results["minicache_anchor"] = readings
    minicache_phase_time(results, "anchor", time.time() - t0)


# ------------------------------------------------------------ eval (phase 11)
EVAL_GOLDEN = os.path.join(ROOT, "xkv_tpu_torch", "testdata", "eval_golden.npz")
EVAL_MODES = ("none", "xkv4_pre")
EVAL_DATASETS = ("niah_single_2", "vt")
# eval_perplexity on the in-repo checkpoint, the card's bf16 weights against
# the JAX golden's fp32 run on the CPU: |ppl - golden| / golden, twice the
# reading of this seeded run on an H100 in each mode.
TOL_EVAL_PPL = {"none": 2 * 0.001465, "xkv4_pre": 2 * 0.001549}
# What xKV-4 pre moves the perplexity by, against what it moves the golden's
# by: |(xkv - none) - (golden xkv - golden none)| / golden none, twice the
# reading of the same run. The weights' bf16 rounding, which sets most of
# the two limits above, largely cancels here, and the golden's own shift
# (0.001138) stands far outside the limit: a run that left the cache
# uncompressed fails.
TOL_EVAL_PPL_SHIFT = 2 * 0.0000818


def eval_phase_time(results, part: str, seconds: float) -> None:
    results.setdefault("eval_phase_s", {})[part] = seconds
    log(f"eval phase, {part}: {seconds:.1f} s")


def eval_loader(results) -> dict:
    """(a) The safetensors loader at full width: Llama-3.1-8B cut to 2
    layers (128256 x 4096 embeddings and lm_head), random bf16 weights from
    the seed, written by ``save_llama_params`` and read back by
    ``load_params`` onto the card, every tensor bitwise; an engine from
    ``cli.common.build_engine`` (xKV groups of 2, rank 512 / 768, pre)
    scores one 4096-byte synthetic text through ``evaluate_texts``
    (``ByteTokenizer``, prefill_frac 0.5: K1 at prefill, 2047 steps on the
    captured graph through K3), on the loaded weights and on the weights in
    memory: equal perplexities, launches as the path's."""
    import argparse
    import dataclasses
    import random
    import shutil

    import torch

    from xkv_tpu_torch.cli.common import add_common_args, build_engine
    from xkv_tpu_torch.evalharness.perplexity import evaluate_texts
    from xkv_tpu_torch.evalharness.ruler.wordlists import essay_words
    from xkv_tpu_torch.models.config import llama31_8b_config
    from xkv_tpu_torch.models.llama import init_params
    from xkv_tpu_torch.models.loader import load_params, save_llama_params
    from xkv_tpu_torch.utils.tokenizer import ByteTokenizer

    t_phase = time.time()
    cfg = dataclasses.replace(llama31_8b_config(), num_layers=2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = init_params(cfg, gen, torch.bfloat16, "cuda")
    path = os.path.join(ROOT, "build", "eval_loader")
    shutil.rmtree(path, ignore_errors=True)
    torch.cuda.synchronize()
    t0 = time.time()
    save_llama_params(params, cfg, path)
    save_s = time.time() - t0
    file_mb = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)) / 1e6
    t0 = time.time()
    loaded, loaded_cfg = load_params(path, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    load_s = time.time() - t0
    shutil.rmtree(path)
    want, got = dict(_leaves(params)), dict(_leaves(loaded))
    bitwise = sorted(want) == sorted(got) and all(
        got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        and got[k].device == want[k].device and torch.equal(got[k], want[k]) for k in want)
    if not (bitwise and loaded_cfg == cfg):
        raise AssertionError("eval loader: the loaded weights or config differ from the "
                             "written ones")
    args = add_common_args(argparse.ArgumentParser()).parse_args(
        ["--model", path, "--device", "cuda", "--xKV", "--layer_group_size", "2",
         "--rank_k", "512", "--rank_v", "768"])
    text = " ".join(essay_words(random.Random(SEED), approx_words=1200))
    row = dict(layers=cfg.num_layers, file_mb=file_mb, save_s=save_s, load_s=load_s,
               leaves=len(want), bitwise=True)
    counts = {key: 0 for key in COUNTERS}
    ppl = {}
    for name, weights in (("loaded", loaded), ("in_memory", params)):
        eng = build_engine(args, weights, cfg, tail_max=4096)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        res = evaluate_texts(eng, ByteTokenizer(), [text], max_length=4096, prefill_frac=0.5,
                             verbose=False)
        torch.cuda.synchronize()
        wall_s = time.time() - t0
        got_counts = read_counts()
        steps = res["total_tokens"] - 1
        want_counts = dict.fromkeys(COUNTERS, 0) | {"K1": cfg.num_layers,
                                                    "K3": cfg.num_layers * steps}
        if got_counts != want_counts:
            raise AssertionError(f"eval loader {name}: launches {got_counts}, "
                                 f"expected {want_counts}")
        for key in counts:
            counts[key] += got_counts[key]
        timing = eng.last_timings[0]
        ppl[name] = res["perplexity"]
        row[name] = dict(perplexity=res["perplexity"], scored_tokens=res["total_tokens"],
                         wall_ms_per_scored_token=wall_s * 1e3 / res["total_tokens"],
                         graph_ms_per_step=timing.replay_ms_per_step(),
                         capture_ms=timing.capture_ms, launches=got_counts)
        del eng
    log("eval loader " + json.dumps(row))
    if ppl["loaded"] != ppl["in_memory"]:
        raise AssertionError(f"eval loader: perplexity {ppl['loaded']} on the loaded weights, "
                             f"{ppl['in_memory']} on the weights in memory")
    results["eval_loader"] = row
    del params, loaded
    torch.cuda.empty_cache()
    eval_phase_time(results, "loader", time.time() - t_phase)
    return counts


def _checkpoint_layers() -> int:
    with open(os.path.join(ROOT, "results", "production_model", "config.json")) as f:
        return json.load(f)["num_layers"]


def _golden_argv(argv) -> list:
    """The golden's arguments with its repository-relative paths made
    absolute, so the run does not depend on the working directory."""
    out = []
    for a in argv:
        a = str(a)
        if a.startswith("ckpt:"):
            a = "ckpt:" + os.path.join(ROOT, a[len("ckpt:"):])
        elif a.startswith("results/"):
            a = os.path.join(ROOT, a)
        out.append(a)
    return out


def eval_acc_golden(results) -> dict:
    """(b) ``cli.eval_acc.main`` on ``ckpt:results/production_model`` (bf16
    on the card) over two RULER tasks (2 samples each, padded to 2048-token
    buckets), in mode none (K1 at prefill) and xKV-4 pre (K1, then K3 at
    every step): the prediction and results files in the JAX format, each
    sample's tokens equal to the JAX golden's up to its first step whose
    golden gap between the top two log-probs is under the anchor's decode
    limit (``TOL_ANCHOR["decode"]``; the rest reported), the scores beside
    the golden's, launches as the path's."""
    import shutil

    import numpy as np
    import torch

    from xkv_tpu_torch.cli import eval_acc
    from xkv_tpu_torch.engine import InferenceEngine

    t_phase = time.time()
    gold = np.load(EVAL_GOLDEN)
    argv = _golden_argv(gold["acc_argv"]) + ["--device", "cuda"]
    tol = TOL_ANCHOR["decode"]
    generate = InferenceEngine.generate
    generated = []

    def recording(self, tokens, max_new_tokens, eos_token_id=None):
        out = generate(self, tokens, max_new_tokens, eos_token_id=eos_token_id)
        generated.append((out[0].cpu().numpy(), max_new_tokens))
        return out

    counts = {key: 0 for key in COUNTERS}
    rows = []
    InferenceEngine.generate = recording
    try:
        for mode in EVAL_MODES:
            result_dir = os.path.join(ROOT, "build", "eval_acc", mode)
            shutil.rmtree(result_dir, ignore_errors=True)
            generated.clear()
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            eval_acc.main(argv + [str(a) for a in gold[f"mode_argv_{mode}"]]
                          + ["--result_dir", result_dir])
            torch.cuda.synchronize()
            wall_s = time.time() - t0
            got_counts = read_counts()
            row = dict(mode=mode, wall_s=wall_s, launches=got_counts, samples=[])
            steps = 0
            for k, (toks, n_new) in enumerate(generated):
                ds, i = EVAL_DATASETS[k // 2], k % 2
                want = gold[f"tokens_{mode}_{ds}_{i}"]
                gaps = gold[f"gaps_{mode}_{ds}_{i}"]
                ties = np.nonzero(gaps < tol)[0]
                held = int(ties[0]) if len(ties) else len(want)
                if len(toks) < held or not np.array_equal(toks[:held], want[:held]):
                    raise AssertionError(
                        f"eval_acc {mode} {ds} #{i}: tokens {toks[:held].tolist()} differ from "
                        f"the golden's {want[:held].tolist()} before its first near tie "
                        f"(step {held}, limit {tol:.4f})")
                steps += n_new - 1  # generate runs every step, then cuts at EOS
                row["samples"].append(dict(
                    dataset=ds, index=i, held_steps=held, golden_steps=len(want),
                    equal_to_the_end=bool(np.array_equal(toks, want)),
                    min_golden_gap=float(gaps.min())))
            if len(generated) != 4:
                raise AssertionError(f"eval_acc {mode}: {len(generated)} samples generated")
            layers = _checkpoint_layers()
            per = {"K1": layers * 4}
            if mode != "none":
                per["K3"] = layers * steps
            want_counts = dict.fromkeys(COUNTERS, 0) | per
            if got_counts != want_counts:
                raise AssertionError(f"eval_acc {mode}: launches {got_counts}, expected "
                                     f"{want_counts}")
            for key in counts:
                counts[key] += got_counts[key]
            row["scores"], row["golden_scores"] = _check_acc_files(gold, mode, result_dir)
            shutil.rmtree(result_dir)
            log("eval acc " + json.dumps(row))
            rows.append(row)
    finally:
        InferenceEngine.generate = generate
    results["eval_acc"] = rows
    eval_phase_time(results, "eval_acc", time.time() - t_phase)
    return counts


def _check_acc_files(gold, mode: str, result_dir: str):
    """The JAX format: ``{result_dir}/ruler/production_model/ruler_<task>
    _rank0.jsonl`` with one record a sample (the golden's fields and, but
    for prediction and score, its values), and ``ruler/production_model
    .json``, a list of {timestamp, args, results}. Returns (scores, the
    golden's scores) by task."""
    base = os.path.join(result_dir, "ruler")
    scores, golden = {}, {}
    for ds in EVAL_DATASETS:
        with open(os.path.join(base, "production_model", f"ruler_{ds}_rank0.jsonl")) as f:
            got = [json.loads(line) for line in f]
        want = [json.loads(line) for line in str(gold[f"predictions_{mode}_{ds}"]).splitlines()]
        for g, w in zip(got, want):
            if set(g) != set(w) or any(g[k] != w[k] for k in w if k not in ("prediction", "score")):
                raise AssertionError(f"eval_acc {mode} {ds}: record {g} against {w}")
        if len(got) != len(want):
            raise AssertionError(f"eval_acc {mode} {ds}: {len(got)} records")
        golden[ds] = float(gold[f"score_{mode}_{ds}"])
    with open(os.path.join(base, "production_model.json")) as f:
        (entry,) = json.load(f)
    if set(entry) != {"timestamp", "args", "results"}:
        raise AssertionError(f"eval_acc {mode}: results file keys {sorted(entry)}")
    for ds in EVAL_DATASETS:
        res = entry["results"][f"ruler/{ds}"]
        if res["n_samples"] != 2:
            raise AssertionError(f"eval_acc {mode} {ds}: {res}")
        scores[ds] = res["score"]
    return scores, golden


def eval_perplexity_golden(results) -> dict:
    """(c) ``cli.eval_perplexity.main`` on the same checkpoint, two
    synthetic texts, in mode none (K1) and xKV-4 pre (K1, K3 every scored
    step): perplexity against the JAX golden within ``TOL_EVAL_PPL``
    (relative), xKV's shift from mode none against the golden's within
    ``TOL_EVAL_PPL_SHIFT``, the scored tokens equal, launches as the
    path's."""
    import numpy as np
    import torch

    from xkv_tpu_torch.cli import eval_perplexity

    t_phase = time.time()
    gold = np.load(EVAL_GOLDEN)
    argv = _golden_argv(gold["ppl_argv"]) + ["--device", "cuda"]
    counts = {key: 0 for key in COUNTERS}
    rows = []
    for mode in EVAL_MODES:
        out = os.path.join(ROOT, "build", f"eval_ppl_{mode}.json")
        if os.path.exists(out):
            os.remove(out)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        eval_perplexity.main(argv + [str(a) for a in gold[f"mode_argv_{mode}"]]
                             + ["--output", out])
        torch.cuda.synchronize()
        wall_s = time.time() - t0
        got_counts = read_counts()
        with open(out) as f:
            (summary,) = json.load(f)
        os.remove(out)
        want_ppl = float(gold[f"ppl_{mode}"])
        rel = abs(summary["perplexity"] - want_ppl) / want_ppl
        tokens = int(gold[f"ppl_tokens_{mode}"])
        row = dict(mode=mode, perplexity=summary["perplexity"], golden=want_ppl,
                   rel_err=rel, limit=TOL_EVAL_PPL[mode], scored_tokens=summary["total_tokens"],
                   wall_s=wall_s, ms_per_scored_token=wall_s * 1e3 / summary["total_tokens"],
                   launches=got_counts)
        log("eval perplexity " + json.dumps(row))
        if summary["total_tokens"] != tokens or summary["num_texts"] != 2:
            raise AssertionError(f"eval_perplexity {mode}: {summary['total_tokens']} tokens "
                                 f"over {summary['num_texts']} texts, golden {tokens} over 2")
        if not rel <= TOL_EVAL_PPL[mode]:
            raise AssertionError(f"eval_perplexity {mode}: perplexity off the golden's by {rel}")
        layers = _checkpoint_layers()
        per = {"K1": layers * 2}
        if mode != "none":
            per["K3"] = layers * (tokens - 2)
        want_counts = dict.fromkeys(COUNTERS, 0) | per
        if got_counts != want_counts:
            raise AssertionError(f"eval_perplexity {mode}: launches {got_counts}, expected "
                                 f"{want_counts}")
        for key in counts:
            counts[key] += got_counts[key]
        rows.append(row)
    none, xkv = rows
    shift = abs((xkv["perplexity"] - none["perplexity"]) - (xkv["golden"] - none["golden"]))
    shift /= none["golden"]
    log(f"eval perplexity: xKV-4 pre shifts the perplexity by "
        f"{xkv['perplexity'] - none['perplexity']:.6f}, the golden's by "
        f"{xkv['golden'] - none['golden']:.6f}: off by {shift:.4e} of the golden's "
        f"(limit {TOL_EVAL_PPL_SHIFT:.4e})")
    if not shift <= TOL_EVAL_PPL_SHIFT:
        raise AssertionError(f"eval_perplexity: xKV's shift from mode none off the golden's "
                             f"by {shift}")
    results["eval_perplexity"] = dict(modes=rows, shift_rel_err=shift,
                                      shift_limit=TOL_EVAL_PPL_SHIFT)
    eval_phase_time(results, "eval_perplexity", time.time() - t_phase)
    return counts


def eval_path(results, after_loader) -> dict:
    """Phase 11: the evaluation path, (a) the loader, then
    ``after_loader()``, (b) eval_acc and (c) eval_perplexity; returns the
    launch counts."""
    totals = {key: 0 for key in COUNTERS}
    for part in (eval_loader, eval_acc_golden, eval_perplexity_golden):
        if part is eval_acc_golden:
            after_loader()
        counts = part(results)
        for key in totals:
            totals[key] += counts[key]
    log(f"eval phase: {sum(results['eval_phase_s'].values()):.1f} s")
    return totals


# ------------------------------------------------------------ train (phase 12)
# (a) Llama-3.2-1B's compressor run: the reference fork's one recorded run
# (Dual1D, layer and seq stride 2, feature ratio 8: ratio 32).
TRAIN_1B = dict(batch=2, seq=2048, steps=50, lr=1e-3, warmup=5)
TRAIN_1B_DUAL1D = dict(layer_stride=2, seq_stride=2, feature_ratio=8)
# (b) the CLI on the checkpoint.
TRAIN_CLI = dict(steps=10, batch=2, seq=256)
# (c) the accuracy gates' induction model (tests/test_accuracy_gate.py,
# tests/test_rope_post_accuracy.py): M-token segments, 32 prompts, 4 kept.
GATE_M, GATE_N, GATE_KEEP = 24, 32, 4
GATE_SHAPE = dict(vocab_size=64, hidden_size=96, intermediate_size=192, num_layers=3,
                  num_q_heads=4, num_kv_heads=2, head_dim=24)
GATE_FULL_RANK = 2 * 2 * 24  # a group of 2 layers: lossless
# The two equalities of the gates (lossless factorisation, full-coverage
# sparse) hold exactly in fp32 on the CPU; in bf16 on the card rounding may
# flip a near-tied greedy token: at most this many of the 640 scored tokens.
GATE_TIE_TOKENS = 2


def train_phase_time(results, part: str, seconds: float) -> None:
    results.setdefault("train_phase_s", {})[part] = seconds
    log(f"train phase, {part}: {seconds:.1f} s")


def _want(**per) -> dict:
    return dict.fromkeys(COUNTERS, 0) | per


def _hold_counts(label: str, got: dict, want: dict) -> None:
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")


def train_1b(results) -> dict:
    """(a) ``CompressorTrainer`` on Llama-3.2-1B at full width and depth
    (random bf16 weights from the seed): Dual1D at ratio 32, b 2 x 2048
    tokens of the CLI's synthetic text (byte ids), 50 steps at lr 1e-3 (5
    warmup steps). Each step
    collects the K/V through K1 (16 launches) and trains the compressor in
    fp32. Holds: the last loss below 0.9 x the first, K1 16 a step,
    ``save_checkpoint`` then ``load_checkpoint`` bitwise with an equal
    ``eval_step`` loss. Reports step ms (CUDA events), K/V tokens/s, the
    peak allocated GB above what earlier phases hold (weights, compressor,
    optimizer state, activations) and the checkpoint's MB."""
    import random
    import shutil

    import numpy as np
    import torch

    from xkv_tpu_torch.evalharness.ruler.wordlists import essay_words
    from xkv_tpu_torch.models.config import llama32_1b_config
    from xkv_tpu_torch.models.llama import init_params
    from xkv_tpu_torch.train import CompressorTrainer, TrainConfig
    from xkv_tpu_torch.utils.tokenizer import ByteTokenizer

    t_phase = time.time()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # by earlier phases
    cfg, run = llama32_1b_config(), TRAIN_1B
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = init_params(cfg, gen, torch.bfloat16, "cuda")
    # The CLI's token stream (synthetic text, byte ids) in 2048-token chunks,
    # drawn per step: random ids would give K/V with nothing to learn.
    text = " ".join(essay_words(random.Random(SEED), approx_words=50_000))
    ids = np.asarray(ByteTokenizer().encode(text), np.int64)
    n_chunks = len(ids) // run["seq"]
    chunks = torch.from_numpy(ids[: n_chunks * run["seq"]].reshape(n_chunks, run["seq"]))
    draw = np.random.default_rng(SEED).integers(0, n_chunks, size=(run["steps"] + 1, run["batch"]))
    batches = chunks[torch.from_numpy(draw)].to("cuda")
    tcfg = TrainConfig(compressor="dual1d", compressor_kwargs=dict(TRAIN_1B_DUAL1D),
                       learning_rate=run["lr"], warmup_steps=run["warmup"],
                       total_steps=run["steps"], seed=SEED)
    trainer = CompressorTrainer(params, cfg, tcfg, device="cuda")
    kv_shape = trainer.init(batches[0])
    torch.cuda.synchronize()
    reset_counts()
    losses, step_ms = [], []
    for i in range(run["steps"]):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step_row = trainer.train_step(batches[i + 1])
        end.record()
        end.synchronize()
        losses.append(step_row["loss"])
        step_ms.append(start.elapsed_time(end))
    counts = read_counts()
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    _hold_counts("train 1B", counts, _want(K1=cfg.num_layers * run["steps"]))
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < 0.9 * losses[0]):
        raise AssertionError(f"train 1B: the loss did not fall: {losses[0]} -> {losses[-1]}")
    path = os.path.join(ROOT, "build", "train_1b", "dual1d.msgpack")
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    trainer.save_checkpoint(path)
    ckpt_mb = os.path.getsize(path) / 1e6
    loaded = CompressorTrainer.load_checkpoint(path, params, cfg, batches[0], device="cuda")
    shutil.rmtree(os.path.dirname(path))
    bitwise = all(torch.equal(loaded.params[layer][leaf], t)
                  for layer, leaves in trainer.params.items() for leaf, t in leaves.items())
    ev, ev_loaded = trainer.eval_step(batches[0]), loaded.eval_step(batches[0])
    if not (bitwise and loaded.step == run["steps"] and ev == ev_loaded):
        raise AssertionError(f"train 1B: the checkpoint did not load back: bitwise {bitwise}, "
                             f"step {loaded.step}, eval {ev} against {ev_loaded}")
    steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    row = dict(kv_shape=list(kv_shape), compressor="dual1d", ratio=step_row["compression_ratio"],
               steps=run["steps"], first_loss=losses[0], last_loss=losses[-1],
               loss_ratio=losses[-1] / losses[0], first_step_ms=step_ms[0],
               median_step_ms=steady, mean_step_ms=sum(step_ms[1:]) / len(step_ms[1:]),
               kv_tokens_per_s=run["batch"] * run["seq"] * 1e3 / steady, peak_gb=peak_gb,
               checkpoint_mb=ckpt_mb, eval_loss=ev["loss"], launches=counts)
    log("train 1b " + json.dumps(row))
    results["train_1b"] = row
    del trainer, loaded, params, batches
    torch.cuda.empty_cache()
    train_phase_time(results, "1B", time.time() - t_phase)
    return counts


def train_cli(results) -> dict:
    """(b) ``cli.train_compressor.main`` on ``ckpt:results/production_model``
    (bf16 on the card; 4 layers, 8 / 8 heads, head size 128) with
    ``--device cuda``: 10 steps of b 2 x 256 tokens. Holds its files (the
    checkpoint loads back into a trainer, the sidecar's step, the JAX
    trainer's CSV columns and rows) and K1 4 a step (and 4 at init)."""
    import argparse
    import csv
    import shutil

    import torch

    from xkv_tpu_torch.cli import train_compressor
    from xkv_tpu_torch.cli.common import load_model_and_tokenizer
    from xkv_tpu_torch.train import CompressorTrainer

    t_phase = time.time()
    out_dir = os.path.join(ROOT, "build", "train_cli")
    shutil.rmtree(out_dir, ignore_errors=True)
    run = TRAIN_CLI
    model = "ckpt:" + os.path.join(ROOT, "results", "production_model")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    train_compressor.main(["--model", model, "--device", "cuda", "--steps", str(run["steps"]),
                           "--batch", str(run["batch"]), "--seq-len", str(run["seq"]),
                           "--eval-every", "5", "--output-dir", out_dir])
    torch.cuda.synchronize()
    wall_s = time.time() - t0
    counts = read_counts()
    layers = _checkpoint_layers()
    _hold_counts("train CLI", counts, _want(K1=layers * (run["steps"] + 1)))
    with open(os.path.join(out_dir, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    if list(rows[0]) != ["compression_ratio", "loss", "mae", "mse", "step"] or \
            len(rows) != run["steps"]:
        raise AssertionError(f"train CLI: metrics.csv columns {list(rows[0])}, {len(rows)} rows")
    ckpt = os.path.join(out_dir, "dual1d.msgpack")
    args = argparse.Namespace(model=model, seed=0, device="cuda")
    params, cfg, _ = load_model_and_tokenizer(args)
    sample = torch.zeros((1, run["seq"]), dtype=torch.long)
    loaded = CompressorTrainer.load_checkpoint(ckpt, params, cfg, sample, device="cuda")
    if loaded.step != run["steps"] or not math.isfinite(loaded.eval_step(sample)["loss"]):
        raise AssertionError(f"train CLI: the checkpoint loaded at step {loaded.step}")
    row = dict(steps=run["steps"], wall_s=wall_s, checkpoint_mb=os.path.getsize(ckpt) / 1e6,
               first_loss=float(rows[0]["loss"]), last_loss=float(rows[-1]["loss"]),
               launches=counts)
    log("train cli " + json.dumps(row))
    results["train_cli"] = row
    shutil.rmtree(out_dir)
    train_phase_time(results, "CLI", time.time() - t_phase)
    return counts


def _gate_batch(rng, batch: int):
    """tests/test_accuracy_gate.py's ``make_batch``: [bos, x, x], the second
    copy scored."""
    import numpy as np

    x = rng.integers(2, GATE_SHAPE["vocab_size"], size=(batch, GATE_M)).astype(np.int32)
    tokens = np.concatenate([np.ones((batch, 1), np.int32), x, x], axis=1)
    mask = np.zeros_like(tokens, np.float32)
    mask[:, GATE_M + 1:] = 1.0
    return tokens, mask


# The gates' runs: label -> (mode, rank, rope, engine options, decode kernel).
GATE_RUNS = {
    "base": ("none", None, "pre", {}, None),
    "full": ("factored", GATE_FULL_RANK, "pre", {}, "K3"),
    "half": ("factored", GATE_FULL_RANK // 2, "pre", {}, "K3"),
    "rank2": ("factored", 2, "pre", {}, "K3"),
    "half int8": ("factored", GATE_FULL_RANK // 2, "pre", {"factor_dtype": "int8"}, "K3"),
    "sparse all": ("factored", GATE_FULL_RANK, "pre", {"sparse_topk": 4, "sparse_block": 8},
                   "K5"),
    "sparse 3of4": ("factored", GATE_FULL_RANK, "pre", {"sparse_topk": 3, "sparse_block": 8},
                    "K5"),
    "fake half": ("fake", GATE_FULL_RANK // 2, "pre", {}, None),
    "pre rank8": ("factored", 8, "pre", {}, "K3"),
    "post rank8": ("factored", 8, "post", {}, "K2"),
    "pre rank4": ("factored", 4, "pre", {}, "K3"),
    "post rank4": ("factored", 4, "post", {}, "K2"),
    "post rank8 int4": ("factored", 8, "post", {"factor_dtype": "int4"}, "K6"),
}


# The gates' decode calls held against their plain versions on the same
# inputs (random factors at the gates' shapes: b 32, 4 / 2 heads, head size
# 24, 29 rows, 8-row chunks): (kernel, factor dtype, rank, chunks kept).
GATE_KERNEL_CASES = (("K3", "bf16", 96, None), ("K3", "bf16", 48, None), ("K3", "bf16", 8, None),
                     ("K3", "bf16", 4, None), ("K3", "bf16", 2, None), ("K3", "int8", 48, None),
                     ("K5", "bf16", 96, 4), ("K5", "bf16", 96, 3), ("K2", "bf16", 8, None),
                     ("K2", "bf16", 4, None), ("K6", "int4", 8, None))


def check_gate_kernels(results) -> None:
    """Each kernel of the gates' runs at the gates' shapes and ranks, which
    its wrapper zero-pads to the kernel's layout (K3 / K5 key ranks to 64,
    K2 / K6 ranks to 16), against its plain version on the same inputs, to
    the kernels line's limits (``TOL``). Outside the runs' count windows:
    these launches are not the main path's."""
    import torch

    from xkv_tpu_torch.cache import vt_layer_slice
    from xkv_tpu_torch.compress.quant import (
        quantize_k_factors,
        quantize_k_factors_mixed4,
        quantize_v_factors,
        quantize_v_factors_mixed4,
    )
    from xkv_tpu_torch.engine.compression import int4_rank_hi
    from xkv_tpu_torch.ops.kernels import lowrank_attention as k3
    from xkv_tpu_torch.ops.kernels import rankspace_attention as k2
    from xkv_tpu_torch.ops.rope import rope_cos_sin

    b, s_p, block, dev, bf = GATE_N, 1 + GATE_M + GATE_KEEP, 8, "cuda", torch.bfloat16
    hq, hkv, hd = GATE_SHAPE["num_q_heads"], GATE_SHAPE["num_kv_heads"], GATE_SHAPE["head_dim"]
    m, scale = hkv * hd, hd ** -0.5
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    pick = torch.Generator().manual_seed(SEED)
    sl = lambda x: vt_layer_slice(x, 1, hkv, hd)  # noqa: E731 (layer 1 of a group of 2)
    cos_p, sin_p = rope_cos_sin(torch.arange(s_p, device=dev), hd, 10000.0)
    cos_t, sin_t = rope_cos_sin(s_p + torch.arange(1, device=dev)[None], hd, 10000.0)
    worst = {}
    for kernel, dtype, rank, keep in GATE_KERNEL_CASES:
        us_k = torch.randn((b, s_p, rank), generator=gen, device=dev)
        vt_k = torch.randn((b, rank, 2 * m), generator=gen, device=dev) * 0.3
        us_v = torch.randn((b, s_p, rank), generator=gen, device=dev)
        vt_v = torch.randn((b, rank, 2 * m), generator=gen, device=dev) * 0.3
        q = torch.randn((b, hq, 1, hd), generator=gen, device=dev).to(bf)
        label = f"gate shape {dtype} rank {rank}" + (f" top {keep}" if keep else "")
        if kernel == "K6":
            hi = int4_rank_hi(rank, 0.25)
            qk = quantize_k_factors_mixed4(us_k, vt_k, hi)
            qv = quantize_v_factors_mixed4(us_v, vt_v, hi)
            q_emb = torch.cat([k2._project_q(q, sl(qk.vt8), hkv, scale, sl(qk.out_scale), bf),
                               k2._project_q(q, sl(qk.vt4), hkv, scale, sl(qk.scale4), bf)],
                              dim=2)
            args = (q_emb, qk.us8, qk.us4p, qv.us8, qv.us4p)
            out, lse = k2.mixed_rankspace_kernel(*args)
            ref, lse_ref = k2.mixed_rankspace_kernel_plain(*args)
        elif kernel == "K2":
            k_us, v_us = us_k.to(bf), us_v.to(bf)
            q_emb = k2._project_q(q, sl(vt_k.to(bf)), hkv, scale, None, bf)
            out, lse = k2.rankspace_kernel(q_emb, k_us, v_us)
            ref, lse_ref = k2.rankspace_kernel_plain(q_emb, k_us, v_us)
        else:
            if dtype == "int8":
                qk, qv = quantize_k_factors(us_k, vt_k), quantize_v_factors(us_v, vt_v)
                k_us, k_vt, v_us, v_vt = qk.us_q, qk.vt_q, qv.us_q, qv.vt
                k_scale, v_scale = sl(qk.out_scale), qv.rank_scale.to(torch.float32).contiguous()
            else:
                k_us, k_vt, v_us, v_vt = (t.to(bf) for t in (us_k, vt_k, us_v, vt_v))
                k_scale = v_scale = None
            cos_h, sin_h = k3.half_tables(cos_p, sin_p, k_us.dtype)
            qab = k3._query_embeds(q, cos_t, sin_t, hkv, scale, k_scale)
            args = (qab, k_us, sl(k_vt), v_us, sl(v_vt), cos_h, sin_h, v_scale)
            kw = dict(num_q_heads=hq, num_kv_heads=hkv)
            if kernel == "K3":
                out, lse = k3.lowrank_kernel(*args, None, None, **kw)
                ref, lse_ref = k3.lowrank_kernel_plain(*args, None, None, **kw)
            else:
                ids = torch.stack([torch.randperm(-(-s_p // block), generator=pick)[:keep]
                                   for _ in range(b)]).to(device=dev, dtype=torch.int32)
                out, lse = k3.sparse_lowrank_kernel(*args, ids, block, None, None, **kw)
                ref, lse_ref = k3.sparse_lowrank_kernel_plain(*args, ids, block, None, None,
                                                              **kw)
        torch.cuda.synchronize()
        _hold(kernel, label, out, ref, lse, lse_ref,
              worst.setdefault(kernel, {"abs": 0.0, "rel": 0.0, "lse": 0.0}))
    for key, w in worst.items():
        results.setdefault(key, {})["gate_shapes"] = dict(
            max_abs_err=w["abs"], max_rel_err=w["rel"], max_lse_err=w["lse"])
    results["train_gates"]["kernels"] = worst


def train_gates(results) -> dict:
    """(c) The accuracy gates on the card. The induction model of
    tests/test_accuracy_gate.py (3 layers, 4 / 2 heads, head size 24, vocab
    64; random fp32 weights from the seed) trained by ``train_lm`` on the
    card (fp32, plain prefill attention: no kernel in the backward, none
    launched), 300 steps of b 64, lr 2e-3; held to a last loss under 0.05.
    Then served in bf16 (weights, cache, factors: fp32 factors are refused
    on the card) through ``InferenceEngine.generate``: 32 prompts of bos +
    x + x[:4], 20 tokens each, recall = exact-match share of the 640
    scored tokens. Every gate of both JAX files with its threshold: base >
    0.95; half rank >= base - 0.10; rank 2 < base - 0.2; int8 >= base -
    0.12; sparse 3 of 4 >= full - 0.10; |fake - factored| <= 0.05; rank 8
    post >= 0.9 and >= pre - 0.05; rank 4 both < 0.9 and post <= pre +
    0.05; int4 >= rank 8 post - 0.05 (the JAX gate's reference has fp32
    factors, bf16 here). The two equalities (lossless factorisation and
    full-coverage sparse against the runs they must equal) are exact in
    fp32 on the CPU; here each may differ by ``GATE_TIE_TOKENS`` correct
    tokens of the 640. Each run's launches: K1 3 at the prefill, its
    decode kernel (K3, K3 int8, K5, K2, K6) 3 a step over 19 steps. Then
    each decode kernel at the gates' ranks against its plain version
    (``check_gate_kernels``)."""
    import numpy as np
    import torch

    from xkv_tpu_torch.configs import generate_consecutive_xkv_config
    from xkv_tpu_torch.engine import InferenceEngine
    from xkv_tpu_torch.models.config import tiny_llama_config
    from xkv_tpu_torch.models.llama import init_params
    from xkv_tpu_torch.train.lm import train_lm, tree_map

    t_phase = time.time()
    cfg = tiny_llama_config(**GATE_SHAPE)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = init_params(cfg, gen, torch.float32, "cuda")
    rng = np.random.default_rng(0)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    trained, history = train_lm(params, cfg, lambda i: _gate_batch(rng, 64), steps=300,
                                lr=2e-3, log_every=100)
    torch.cuda.synchronize()
    train_s = time.time() - t0
    _hold_counts("gate training", read_counts(), _want())
    if not history[-1] < 0.05:
        raise AssertionError(f"gate training: the induction task did not train: {history}")
    served = tree_map(lambda t: t.to(torch.bfloat16), trained)
    x = np.random.default_rng(123).integers(2, cfg.vocab_size, size=(GATE_N, GATE_M))
    prompts = np.concatenate([np.ones((GATE_N, 1), np.int64), x, x[:, :GATE_KEEP]], axis=1)
    want_toks = x[:, GATE_KEEP:]
    n_new = GATE_M - GATE_KEEP
    L = cfg.num_layers
    totals = {key: 0 for key in COUNTERS}
    correct, runs = {}, {}
    for label, (mode, rank, rope, kw, kernel) in GATE_RUNS.items():
        xkv = None if rank is None else generate_consecutive_xkv_config(
            num_layers=L, end_layer=L - 1, group_size=2, rank_k=rank, rank_v=rank,
            extra_kwargs={"svd_method": "exact", "rope_mode": rope})
        kw = dict(kw)
        kw.setdefault("factor_dtype", torch.bfloat16)
        eng = InferenceEngine(served, cfg, xkv=xkv, mode=mode, tail_max=GATE_M,
                              cache_dtype=torch.bfloat16, device="cuda", **kw)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        out = eng.generate(torch.as_tensor(prompts, device="cuda"), max_new_tokens=n_new)
        got = out.cpu().numpy()
        wall_s = time.time() - t0
        counts = read_counts()
        want = _want(K1=L, **({kernel: L * (n_new - 1)} if kernel else {}))
        _hold_counts(f"gate {label}", counts, want)
        correct[label] = int((got == want_toks).sum())
        runs[label] = dict(recall=correct[label] / want_toks.size, correct=correct[label],
                           wall_s=wall_s, launches=counts)
        for key in totals:
            totals[key] += counts[key]
        del eng
    acc = {label: r["recall"] for label, r in runs.items()}
    gates = {
        "base > 0.95": acc["base"] > 0.95,
        "full == base (ties)": abs(correct["full"] - correct["base"]) <= GATE_TIE_TOKENS,
        "half >= base - 0.10": acc["half"] >= acc["base"] - 0.10,
        "rank2 < base - 0.2": acc["rank2"] < acc["base"] - 0.2,
        "int8 >= base - 0.12": acc["half int8"] >= acc["base"] - 0.12,
        "sparse all == full (ties)":
            abs(correct["sparse all"] - correct["full"]) <= GATE_TIE_TOKENS,
        "sparse 3of4 >= full - 0.10": acc["sparse 3of4"] >= acc["full"] - 0.10,
        "|fake - factored| <= 0.05": abs(acc["fake half"] - acc["half"]) <= 0.05,
        "post rank8 >= 0.9": acc["post rank8"] >= 0.9,
        "post rank8 >= pre - 0.05": acc["post rank8"] >= acc["pre rank8"] - 0.05,
        "rank4 both < 0.9": acc["pre rank4"] < 0.9 and acc["post rank4"] < 0.9,
        "post rank4 <= pre + 0.05": acc["post rank4"] <= acc["pre rank4"] + 0.05,
        "int4 >= post rank8 - 0.05": acc["post rank8 int4"] >= acc["post rank8"] - 0.05,
    }
    row = dict(history=history, train_s=train_s, recall=acc, gates=gates, runs=runs)
    log("train gates " + json.dumps(row))
    results["train_gates"] = row
    failed = [name for name, ok in gates.items() if not ok]
    if failed:
        raise AssertionError(f"accuracy gates failed on the card: {failed}; recall {acc}")
    check_gate_kernels(results)
    train_phase_time(results, "gates", time.time() - t_phase)
    return totals


def train_cka(results) -> dict:
    """(d) ``cli.group_layers.main --model`` on the checkpoint on the card
    (K1 at the 512-token calibration prefill, 4 launches): the YAML it
    writes loads into ``XKVConfig`` over the 4 layers, in contiguous
    groups."""
    import shutil

    from xkv_tpu_torch.cli import group_layers
    from xkv_tpu_torch.configs import XKVConfig

    t_phase = time.time()
    out_dir = os.path.join(ROOT, "build", "train_cka")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    out = os.path.join(out_dir, "grouped.yaml")
    reset_counts()
    group_layers.main(["--model", "ckpt:" + os.path.join(ROOT, "results", "production_model"),
                       "--n_groups", "2", "--rank_k", "128", "--rank_v", "128", "--output", out,
                       "--device", "cuda"])
    counts = read_counts()
    layers = _checkpoint_layers()
    _hold_counts("group_layers", counts, _want(K1=layers))
    cfg = XKVConfig.from_yaml(out)
    groups = [g.layers for g in cfg.layer_groups]
    if cfg.num_layers != layers or [i for g in groups for i in g] != list(range(layers)) or \
            any(g != list(range(g[0], g[-1] + 1)) for g in groups):
        raise AssertionError(f"group_layers: config {cfg.to_dict()}")
    results["train_cka"] = dict(groups=groups, launches=counts)
    log("train cka " + json.dumps(results["train_cka"]))
    shutil.rmtree(out_dir)
    train_phase_time(results, "CKA", time.time() - t_phase)
    return counts


def train_path(results) -> dict:
    """Phase 12: training and CKA grouping, (a) the 1B trainer, (b) the
    CLI, (c) the accuracy gates, (d) CKA; returns the launch counts."""
    totals = {key: 0 for key in COUNTERS}
    for part in (train_1b, train_cli, train_gates, train_cka):
        counts = part(results)
        for key in totals:
            totals[key] += counts[key]
    log(f"train phase: {sum(results['train_phase_s'].values()):.1f} s")
    return totals


# ------------------------------------------------ examples and TP (phase 13)
# Two ranks sharing the card: Llama-3.1-8B's widths cut to 4 layers (one
# xKV-4 group), a 4096-token prompt, 16 new tokens over an 8-row tail.
TP_NPROC = 2
TP_ARGS = ["--device", "cuda", "--layers", "4", "--prompt", "4096", "--new", "16",
           "--tail", "8", "--runs", "pre:bf16,post:bf16,post:int8"]
# The two ranks against the unsharded engine on the card. Both reduce
# every product in fp32: a rank's share of a row-split product (wo,
# w_down) is an fp32 partial, the partials are summed in fp32 and rounded
# to bf16 once, as one device rounds its product once; and cuBLAS keeps
# the split sums of bf16 products in fp32 on both sides
# (``allow_bf16_reduced_precision_reduction`` off). So the two differ by
# the order of fp32 sums, which flips single bf16 roundings of the
# activations and of the logits (bf16 products: one unit in the last
# place is 0.03125 at |logit| 4-8), and from layer 1 of the K/V that the
# group SVD factorises. Limits, twice the readings of these seeded runs
# on an H100:
#  TOL_TP, the same factors: the prefill's logits; each step up to the
#     refold over the ranks' prefill cache, joined and read by one device
#     fed the same tokens; one step past the pass over the ranks' last
#     cache, joined;
#  TOL_TP_STEPS, by factor dtype, each side's own factors (whose SVD
#     inputs differed): each step of the ranks fed one device's tokens,
#     and each greedy token of the ranks against one device's top logit
#     at its step (one device fed the ranks' tokens).
# Tokens: the ranks' greedy tokens (``generate``) equal one device's up
# to the first step whose top two logits lie within twice that step's
# disagreement in the fed pass (a near tie; the prefixes are equal up to
# there). The readings part at gaps of one unit in the last place or less.
# Controls, one device fed the same tokens: mode none (no compression)
# must lie beyond the step limit at every step, and mode fake (the same
# factors read through the plain path, the tail never folded) at every
# step past the refold, so the limit sees compression's and a refold's
# errors.
TOL_TP = 2 * 0.0898
TOL_TP_STEPS = {"bf16": 2 * 0.2188, "int8": 2 * 0.3203}
TP_CONTROLS = ("fake", "none")


def examples_phase(results) -> dict:
    """Phase 13 (a): the port's three examples at their own sizes on the
    card; returns the launch counts."""
    from xkv_tpu_torch.examples import accuracy_demo, quickstart, serving

    totals = {key: 0 for key in COUNTERS}
    t0 = time.time()
    reset_counts()
    rows = quickstart.main("cuda", verbose=False)
    counts = read_counts()
    layers = quickstart.CFG.num_layers
    # Each run prefills twice (its own prefill, generate's); 31 decode steps
    # through K3 (factored pre) and K2 (post int8); none and fake: no kernel.
    _hold_counts("quickstart", counts, _want(K1=4 * 2 * layers, K3=31 * layers, K2=31 * layers))
    for key in totals:
        totals[key] += counts[key]
    results["examples"] = {"quickstart": [
        dict(label=r["label"], ratio=r["ratio"], prefill_s=r["prefill_s"],
             generate_s=r["generate_s"], tokens=r["tokens"][0].tolist()) for r in rows],
        "quickstart_launches": counts}
    log("examples quickstart " + json.dumps(results["examples"]["quickstart"]))
    t1 = time.time()
    reset_counts()
    served = serving.main("cuda", verbose=False)
    counts = read_counts()
    if not (counts["K1"] and counts["K3"] and counts["K5"]):
        raise AssertionError(f"serving: launches {counts}")
    for key in totals:
        totals[key] += counts[key]
    results["examples"]["serving"] = dict(tokens=served["plain"], launches=counts)
    log(f"examples serving: {len(served['plain'])} requests, speculative tokens equal to the "
        f"plain ones; launches {counts}; {time.time() - t1:.1f} s")
    t1 = time.time()
    reset_counts()
    acc = accuracy_demo.main("cuda", verbose=False)
    counts = read_counts()
    if not (counts["K1"] and counts["K3"]):
        raise AssertionError(f"accuracy_demo: launches {counts}")
    if not acc["history"][-1] < 0.5 * acc["history"][0]:
        raise AssertionError(f"accuracy_demo: the loss did not fall: {acc['history']}")
    for key in totals:
        totals[key] += counts[key]
    results["examples"]["accuracy_demo"] = dict(
        loss=acc["history"], baseline=acc["baseline"],
        recall={rank: [ratio, rec] for rank, ratio, rec in acc["ranks"]}, launches=counts)
    log("examples accuracy_demo " + json.dumps(results["examples"]["accuracy_demo"]) +
        f"; {time.time() - t1:.1f} s")
    results["examples_s"] = time.time() - t0
    return totals


def tp_reference(out_dir: str) -> dict:
    """Phase 13 (b)'s unsharded side and (c): the ranks' model on one
    device (the same seed: ``tp_serve.model``), per run the eager greedy
    loop (``tp_serve.forced_pass``: its tokens and each step's logits),
    ``generate``'s tokens (the captured graph: equal), and the controls
    (``TP_CONTROLS``: one device in those modes, which fold no tail, fed
    the same tokens); the
    tokens are written to ``ref_tokens.json`` for the ranks' forced pass.
    Then a traced run of decode replays read back by
    ``device_op_times``."""
    import shutil

    import torch

    from xkv_tpu_torch.engine import InferenceEngine
    from xkv_tpu_torch.engine.graphs import DecodeGraph
    from xkv_tpu_torch.scripts import tp_serve
    from xkv_tpu_torch.utils.profiling import device_op_times

    args = tp_serve.parse_args(TP_ARGS)
    cfg, xkv, params, prompt = tp_serve.model(args)
    ref = {}
    for run in args.runs.split(","):
        rope, fd = run.split(":")

        def engine(mode, tail_max):
            return InferenceEngine(params, cfg, xkv(rope), mode=mode, tail_max=tail_max,
                                   factor_dtype=tp_serve.factor_dtype(fd),
                                   prefill_logits="last", device="cuda")

        eng = engine("factored", args.tail)
        t0 = time.time()
        tokens, logits, prefill_s, step_s, _ = tp_serve.forced_pass(eng, prompt, args.new)
        graph = eng.generate(prompt, args.new).cpu()
        if not torch.equal(graph, tokens):
            raise AssertionError(f"tp reference {run}: generate {graph.tolist()} against the "
                                 f"eager loop's {tokens.tolist()}")
        top2 = logits.topk(2, dim=-1).values
        ref[run] = dict(tokens=tokens, logits=logits, gap=(top2[:, 0] - top2[:, 1]).tolist(),
                        prefill_s=prefill_s, decode_ms_per_token=1e3 * sum(step_s) / len(step_s),
                        seconds=time.time() - t0, control={})
        for mode in TP_CONTROLS:
            # No refold outside mode factored: a tail of every new token.
            _, other, _, _, _ = tp_serve.forced_pass(engine(mode, args.new), prompt, args.new,
                                                     tokens)
            ref[run]["control"][mode] = (other - logits).abs().amax(dim=-1).tolist()
        if run == "pre:bf16":
            logits, cache = eng.prefill(prompt)
            tok = logits[:, -1].argmax(dim=-1)[:, None]
            # (c): 3 replays of a captured step, timed, then 3 traced (the
            # warm-up step and 6 replays fill 7 of the 8 tail rows).
            seg = DecodeGraph(eng, cache, prompt.shape[1], 7, first_token=tok)
            seg.warm_up()
            seg.capture()
            torch.cuda.synchronize()
            t0 = time.time()
            seg.replay(3)
            torch.cuda.synchronize()
            trace_dir = os.path.join(out_dir, "trace")
            prof = _profile(lambda: seg.replay(1), 3, (time.time() - t0) * 1e3 / 3,
                            trace_dir=trace_dir)
            read = device_op_times(trace_dir)
            shutil.rmtree(trace_dir)
            for name, ms in (("profile_op_times", prof["op_times_ms"]),
                             ("key_averages", prof["key_averages_ms"])):
                if set(read) != set(ms):
                    raise AssertionError(f"device_op_times names differ from {name}'s: "
                                         f"{sorted(set(read) ^ set(ms))}")
                # The trace keeps each duration to 1 ns (1e-6 ms).
                worst = max(abs(read[k] - ms[k]) / (1e-6 * prof["op_counts"][k] + 1e-9 * ms[k])
                            for k in read)
                if worst > 1.0:
                    raise AssertionError(f"device_op_times against {name}: {worst}")
            ref["trace"] = dict(ops=len(read), events=sum(prof["op_counts"].values()),
                                max_abs_ms=max(abs(read[k] - prof["key_averages_ms"][k])
                                               for k in read),
                                kernel_sum_ms_per_step=prof["kernel_sum_ms_per_step"],
                                top=dict(list(read.items())[:3]))
            del seg, cache
        del eng
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, "ref_tokens.json"), "w") as f:
        json.dump({run: r["tokens"].tolist() for run, r in ref.items() if run != "trace"}, f)
    ref["model"] = (args, cfg, xkv, params, prompt)
    return ref


def tp_shard_kernels(cfg, params, prompt, joined, tok, rope: str, with_k1: bool) -> dict:
    """Phase 13 (b): rank 0's own kernel calls, held against their plain
    versions at the kernels' limits (``TOL``): K1 of layer 0 over the
    prompt on its 16 query and 4 kv heads (``with_k1``), and K3 (``rope``
    pre) or K2 (post) of layer 0 over its shard of the ranks' cache after
    the forced pass (the replicated us, its kv heads' V^T column block),
    fed ``tok`` (1, 1) at the step past the pass. The operands are built
    as rank 0 builds them: ``shard_params`` and ``shard_group_factors`` of
    the joined cache, the same ops on the same values."""
    import dataclasses

    import torch

    from xkv_tpu_torch.cache import vt_layer_slice
    from xkv_tpu_torch.models.llama import qkv_proj, rms_norm
    from xkv_tpu_torch.ops.kernels import flash_attention as k1
    from xkv_tpu_torch.ops.kernels import lowrank_attention as k3
    from xkv_tpu_torch.ops.kernels import rankspace_attention as k2
    from xkv_tpu_torch.ops.rope import apply_rope, rope_cos_sin
    from xkv_tpu_torch.parallel.mesh import Mesh
    from xkv_tpu_torch.parallel.sharding import shard_group_factors, shard_params

    dev = prompt.device
    mesh = Mesh(data=1, model=TP_NPROC, rank=0)
    layer = shard_params({"layers": params["layers"][:1]}, mesh)["layers"][0]
    scfg = dataclasses.replace(cfg, num_q_heads=cfg.num_q_heads // TP_NPROC,
                               num_kv_heads=cfg.num_kv_heads // TP_NPROC)
    hq, hkv, hd = scfg.num_q_heads, scfg.num_kv_heads, scfg.head_dim
    scale = 1.0 / math.sqrt(hd)

    def tables(positions):
        return rope_cos_sin(positions, hd, cfg.rope_theta, cfg.rope_scaling)

    def qkv(tokens):
        return qkv_proj(layer["attn"], scfg, rms_norm(params["embed"][tokens],
                                                      layer["input_norm"], cfg.rms_norm_eps))

    worst, rec = {"abs": 0.0, "rel": 0.0, "lse": 0.0}, {}
    if with_k1:
        s = prompt.shape[1]
        q, k, v = qkv(prompt)
        cos, sin = tables(torch.arange(s, device=dev)[None])
        q, k = apply_rope(q, cos, sin).contiguous(), apply_rope(k, cos, sin).contiguous()
        out = k1.flash_attention(q, k, v.contiguous(), scale=scale)
        ref = k1.flash_attention_plain(q, k, v.contiguous(), scale=scale)
        torch.cuda.synchronize()
        rel = row_rel_err(out, ref)
        log(f"K1 rank 0's shard ({hq} q / {hkv} kv heads, s={s}): max_abs_err="
            f"{max_abs_err(out, ref):.3e} max_rel_err={rel:.3e} (limit {TOL['K1']:.3e})")
        if not rel <= TOL["K1"]:
            raise AssertionError("K1 disagrees with its plain version on rank 0's shard")
        rec["K1"] = dict(max_abs_err=max_abs_err(out, ref), max_rel_err=rel)
    gf = shard_group_factors(joined.groups[0], 4, mesh)
    s_p = joined.prefill_len
    pos = prompt.shape[1] + int(TP_ARGS[TP_ARGS.index("--new") + 1]) - 1
    q_pre, _, _ = qkv(tok.to(dev))
    cos_t, sin_t = tables(torch.tensor([[pos]], device=dev))
    cos_p, sin_p = tables(torch.arange(s_p, device=dev))
    quantized = gf.k_us.dtype == torch.int8
    k_scale = vt_layer_slice(gf.k_scale, 0, hkv, hd) if quantized else None
    vt_k, vt_v = vt_layer_slice(gf.k_vt, 0, hkv, hd), vt_layer_slice(gf.v_vt, 0, hkv, hd)
    label = f"rank 0's shard ({hq} q / {hkv} kv heads, vt {tuple(vt_k.shape)}, s_p={s_p})"
    if rope == "pre":
        key = "K3"
        cos_h, sin_h = k3.half_tables(cos_p, sin_p, gf.k_us.dtype)
        qab = k3._query_embeds(q_pre, cos_t, sin_t, hkv, scale, k_scale)
        v_scale = gf.v_scale.to(torch.float32).contiguous() if quantized else None
        args = (qab, gf.k_us, vt_k, gf.v_us, vt_v, cos_h, sin_h, v_scale, None, None)
        out, lse = k3.lowrank_kernel(*args, num_q_heads=hq, num_kv_heads=hkv)
        ref, lse_ref = k3.lowrank_kernel_plain(*args, num_q_heads=hq, num_kv_heads=hkv)
    else:
        key = "K2"
        q_emb = k2._project_q(apply_rope(q_pre, cos_t, sin_t), vt_k, hkv, scale, k_scale,
                              k2.compute_dtype_for(gf.k_us.dtype))
        out, lse = k2.rankspace_kernel(q_emb, gf.k_us, gf.v_us, None, None)
        ref, lse_ref = k2.rankspace_kernel_plain(q_emb, gf.k_us, gf.v_us, None, None)
    torch.cuda.synchronize()
    _hold(key, label, out, ref, lse, lse_ref, worst)
    rec[key] = dict(max_abs_err=worst["abs"], max_rel_err=worst["rel"], lse_err=worst["lse"])
    return rec


def tp_phase(results) -> dict:
    """Phase 13: the examples (a); the unsharded side of (b) and (c); the
    ranks of (b); then the comparisons. Returns the launch counts (both
    ranks' included)."""
    import shutil

    import torch

    from xkv_tpu_torch.scripts import tp_serve

    t_phase = time.time()
    totals = examples_phase(results)
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        out_dir = os.path.join(ROOT, "build", "tp_phase")
        shutil.rmtree(out_dir, ignore_errors=True)
        os.makedirs(out_dir)
        t0 = time.time()
        reset_counts()
        ref = tp_reference(out_dir)
        for key, n in read_counts().items():
            totals[key] += n
        results["tp_reference_s"] = time.time() - t0
        t0 = time.time()
        tp_serve.wait(tp_serve.launch(
            TP_ARGS + ["--out", out_dir, "--teacher", os.path.join(out_dir, "ref_tokens.json")],
            TP_NPROC), timeout=300)
        results["tp_ranks_s"] = time.time() - t0
        t0 = time.time()
        rows = tp_compare(ref, out_dir, totals)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    results["tp_compare_s"] = time.time() - t0
    results["tp"] = dict(rows=rows, trace=ref["trace"], tol=TOL_TP, tol_steps=TOL_TP_STEPS)
    log("trace readers " + json.dumps(ref["trace"]))
    shutil.rmtree(out_dir)
    results["tp_phase_s"] = time.time() - t_phase
    log(f"examples-and-tp phase: {results['tp_phase_s']:.1f} s (the examples "
        f"{results['examples_s']:.1f} s, the unsharded side {results['tp_reference_s']:.1f} s, "
        f"the ranks {results['tp_ranks_s']:.1f} s, the comparisons "
        f"{results['tp_compare_s']:.1f} s)")
    return totals


def tp_compare(ref: dict, out_dir: str, totals: dict) -> dict:
    """Phase 13 (b)'s comparisons of the ranks (``out_dir``) with one
    device (``ref``): rank 0's kernel calls (``tp_shard_kernels``), each
    rank's launches on its head shard, then per run the rows that
    ``TOL_TP`` / ``TOL_TP_STEPS`` and the token rule hold, checked once
    every row is printed. Adds the launches of the ranks and of one device
    fed the ranks' tokens to ``totals``."""
    import torch

    from xkv_tpu_torch.engine import InferenceEngine
    from xkv_tpu_torch.scripts import tp_serve

    records = tp_serve.results(out_dir, TP_NPROC)
    got = torch.load(os.path.join(out_dir, "rank0.pt"), map_location="cuda", weights_only=False)
    args, cfg, xkv, params, prompt = ref.pop("model")
    layers = int(TP_ARGS[TP_ARGS.index("--layers") + 1])
    steps = int(TP_ARGS[TP_ARGS.index("--new") + 1])
    shard_kernels = {}
    for i, (run, mine) in enumerate(got.items()):
        shard_kernels[run] = tp_shard_kernels(cfg, params, prompt, mine["joined"],
                                              ref[run]["tokens"][:, -1:], run.split(":")[0],
                                              with_k1=i == 0)
        kernel = "K3" if run.startswith("pre") else "K2"
        for rec in records:
            # Two prefills (generate's, the forced pass's); 15 decode steps
            # each, and the step past the forced pass.
            _hold_counts(f"tp rank {rec['rank']} {run}", rec["runs"][run]["counts"],
                         _want(K1=2 * layers, **{kernel: (2 * (steps - 1) + 1) * layers}))
            if rec["heads"] != [cfg.num_q_heads // TP_NPROC, cfg.num_kv_heads // TP_NPROC]:
                raise AssertionError(f"tp rank {rec['rank']}: heads {rec['heads']}")
            for key in totals:
                totals[key] += rec["runs"][run]["counts"][key]
    rows, fails = {}, []
    reset_counts()
    for run, mine in got.items():
        want = ref[run]
        rope, fd = run.split(":")
        lim = TOL_TP_STEPS[fd]
        for key in ("tokens", "logits", "next_logits"):
            mine[key] = mine[key].cpu()
        err = (mine["logits"] - want["logits"]).abs().amax(dim=-1).tolist()  # a step each
        eng = InferenceEngine(params, cfg, xkv(rope), mode="factored", tail_max=args.tail,
                              factor_dtype=tp_serve.factor_dtype(fd), prefill_logits="last",
                              device="cuda")
        # One device over the ranks' joined cache: the steps up to the
        # refold over the prefill's, fed the same tokens, then one step
        # past the pass over the last.
        same, cache, pos = [err[0]], mine["prefill_joined"], prompt.shape[1]
        for i in range(args.tail):
            out, cache = eng.decode_step(cache, want["tokens"][:, i:i + 1].cuda(), pos + i)
            same.append((out[:, -1].float().cpu() - mine["logits"][i + 1]).abs().max().item())
        nxt, _ = eng.decode_step(mine["joined"], want["tokens"][:, -1:].cuda(),
                                 pos + steps - 1)
        same.append((nxt[:, -1].float().cpu() - mine["next_logits"]).abs().max().item())
        del cache
        # One device fed the ranks' greedy tokens: each one's shortfall
        # from the top logit of its step.
        _, fed, _, _, _ = tp_serve.forced_pass(eng, prompt, steps, mine["tokens"])
        short = (fed.amax(dim=-1) - fed.gather(1, mine["tokens"].T)[:, 0]).tolist()
        del eng
        torch.cuda.empty_cache()
        held = next((i for i in range(steps) if mine["tokens"][0, i] != want["tokens"][0, i]),
                    steps)
        ties = [i for i, g in enumerate(want["gap"]) if g <= 2 * err[i]]
        ctl = want["control"]
        rows[run] = dict(tokens=mine["tokens"][0].tolist(), ref_tokens=want["tokens"][0].tolist(),
                         equal_tokens=held, near_ties=ties,
                         same_factors_err=same, logits_err_by_step=err,
                         tokens_shortfall=short, control_err_by_step=want["control"],
                         ref_gap_by_step=want["gap"],
                         max_abs_logit=want["logits"].abs().max().item(),
                         shard_kernels=shard_kernels[run],
                         one_device=dict(prefill_s=want["prefill_s"],
                                         decode_ms_per_token=want["decode_ms_per_token"]),
                         ranks=[dict(rank=rec["rank"], heads=rec["heads"],
                                     prefill_s=rec["runs"][run]["prefill_s"],
                                     decode_ms_per_token=rec["runs"][run]["decode_ms_per_token"],
                                     launches={k: v for k, v in rec["runs"][run]["counts"].items()
                                               if v})
                                for rec in records])
        log(f"tp {run} " + json.dumps(rows[run]))
        if max(same) > TOL_TP:
            fails.append(f"{run}: prefill, same factors {same} (limit {TOL_TP})")
        if max(err) > lim or max(short) > lim:
            fails.append(f"{run}: steps {err}, the ranks' tokens' shortfall {short} (limit {lim})")
        if held < (ties[0] if ties else steps):
            fails.append(f"{run}: tokens equal up to {held}, near ties at {ties}")
        if not (min(ctl["none"][1:]) > lim and min(ctl["fake"][args.tail + 1:]) > lim):
            fails.append(f"{run}: a control lies within the step limit {lim}: {ctl}")
    # The comparisons' launches (one device over the ranks' tokens).
    for key, n in read_counts().items():
        totals[key] += n
    if fails:
        raise AssertionError("tp against one device: " + "; ".join(fails))
    return rows


# ------------------------------------------------- phase 14: the rest of TP
# Three meshes of ``scripts/tp_serve.py`` ranks sharing the card (gloo),
# each launched beside an earlier phase's host-bound work (``Tp14Ranks``):
# (a) Llama-3.1-8B's widths cut to 4 layers, a model axis of 2 (16 q / 4
# kv heads a rank), sparse top-4 of 512-row chunks post (K4) and pre (K5)
# with per-shard selection, int4 factors (K6), and int4 with sparse top-4
# (selection over every head; no kernel: the plain path, as on one
# device); (b) DeepSeek-V2-Lite's widths cut to 4 layers (the dense first
# layer and 3 MoE layers), a model axis of 2 (8 q heads and 32 experts a
# rank), bf16 (K7) and int4 (K8) latent factors; (c) the 8B widths at data
# 2 x model 2, b = 2, pre bf16 (K3). 4096-token prompts, 16 tokens over
# 8-row tails (one refold).
TP14_COMMON = ["--device", "cuda", "--layers", "4", "--prompt", "4096", "--new", "16",
               "--tail", "8"]
TP14_MESHES = {  # name: (tp_serve options, ranks)
    "a": (TP14_COMMON + ["--runs", "post:bf16:sparse4,pre:bf16:sparse4,post:int4,"
                                   "post:int4:sparse4"], 2),
    "b": (TP14_COMMON + ["--mla"], 2),
    "c": (TP14_COMMON + ["--data", "2", "--batch", "2", "--runs", "pre:bf16"], 4),
}
# Each run's decode kernel on the factored group (None: the plain path).
TP14_KERNEL = {"post:bf16:sparse4": "K4", "pre:bf16:sparse4": "K5", "post:int4": "K6",
               "post:int4:sparse4": None, "mla:bf16": "K7", "mla:int4": "K8",
               "pre:bf16": "K3"}
# Limits, on the card, both sides reducing every product in fp32 (phase
# 13's setting). One device runs over the ranks' joined caches, fed the
# ranks' tokens, at every step: the prefill, the steps up to the refold
# over the joined prefill cache, the steps after it and one past the pass
# over the joined last cache (the refold's factors; its tail refilled).
# K4 / K5 select chunks per shard (the JAX ``*_tp`` wrappers), which one
# device selecting over every head does not compute below full coverage,
# so one device is run with each shard's own selection there
# (``per_shard_selection``). Held per step:
#  the logits: phase 13's same-factor TOL_TP at the 8B widths (int4 and
#     int4 sparse, whose selection is over every head on both sides, and
#     (c)); TOL_TP14_MLA at V2-Lite's; TOL_TP14_SHARD for the per-shard
#     sparse runs; each twice its reading on the card. The int4 runs are
#     held here and not by their tokens against one device over its own
#     factors: those tokens read up to 1.4375 below its top logit, and a
#     wrong path's (one device in mode fake) up to 3.02, below 1.4375 at
#     most steps, so no limit told the two apart;
#  each greedy token of the ranks below one device's top logit at the
#     step that chose it, by at most twice the step's logit limit (the
#     most two sides within that limit can part by), at most phase 13's
#     own-factor step limit TOL_TP_STEPS["bf16"];
#  a sparse run's step over every chunk against one device's exact step:
#     TOL_TP.
TOL_TP14_MLA = 2 * 0.0547
TOL_TP14_SHARD = 2 * 0.1094
# The kernels each run launches on a rank's shard, by (module, name):
# rank 0's first call is recorded and held against its plain version.
TP14_KERNEL_FNS = {"K3": ("lowrank_attention", "lowrank_kernel"),
                   "K4": ("rankspace_attention", "sparse_rankspace_kernel"),
                   "K5": ("lowrank_attention", "sparse_lowrank_kernel"),
                   "K6": ("rankspace_attention", "mixed_rankspace_kernel"),
                   "K7": ("rankspace_attention", "mla_rankspace_kernel"),
                   "K8": ("rankspace_attention", "mla_mixed_rankspace_kernel")}


class RankWaves:
    """A phase's rank processes (``table``: name -> (argv, ranks); each
    name's program ``modules[name]``, ``scripts/tp_serve.py`` by default):
    each launched beside an earlier phase (the card is idle in the
    host-bound ones) and waited for when its results are read; ``stop``
    ends any still running."""

    def __init__(self, phase: str, table: dict, modules: dict = None):
        import shutil

        self.phase, self.table, self.modules = phase, table, modules or {}
        self.root = os.path.join(ROOT, "build", phase)
        shutil.rmtree(self.root, ignore_errors=True)
        self.dirs = {name: os.path.join(self.root, name) for name in table}
        self.procs, self.launched, self.waited = {}, {}, {}

    def launch(self, names, beside: str) -> None:
        from xkv_tpu_torch.scripts import tp_serve

        for name in names:
            argv, world = self.table[name]
            os.makedirs(self.dirs[name])
            self.procs[name] = tp_serve.launch(
                argv + ["--out", self.dirs[name]], world,
                **({"module": self.modules[name]} if name in self.modules else {}))
            self.launched[name] = time.time()
        log(f"{self.phase}: the ranks of {', '.join(names)} launched beside {beside}")

    def wait(self, name: str) -> None:
        """Wait for a wave's ranks; one that failed or hangs stops them all
        and raises."""
        from xkv_tpu_torch.scripts import tp_serve

        t0 = time.time()
        tp_serve.wait(self.procs[name], timeout=600)
        self.waited[name] = self.waited.get(name, 0.0) + time.time() - t0
        log(f"{self.phase}: waited {time.time() - t0:.1f} s for the ranks of {name}")

    def stop(self) -> None:
        for procs in self.procs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


class Tp14Ranks(RankWaves):
    """Phase 14's meshes (``TP14_MESHES``)."""

    def __init__(self):
        super().__init__("tp14", TP14_MESHES)


class _RankZero:
    """Rank 0 of a model axis of 2 with every collective left out: a
    decode step under it calls layer 0's kernels with rank 0's own
    operands (the partial sums come after them)."""
    data, model, rank, model_rank, data_rank = 1, 2, 0, 0, 0

    def all_reduce(self, x):
        return x

    all_max = all_reduce

    def gather(self, x, dim=-1, blocks=1):
        return x


def tp14_shard_kernel(key, cfg, xkv, params, mine, prompt, run, steps) -> dict:
    """Rank 0's first call of ``key`` in a decode step on its shard (the
    joined cache after the pass, sharded again; ``shard_params``), fed the
    pass's last token: held against the plain version at ``TOL[key]``; K7
    / K8 timed there too (R = 8 rows: a rank's 8 q heads at ql 1)."""
    import dataclasses
    import importlib

    import torch

    from xkv_tpu_torch.models import deepseek, llama
    from xkv_tpu_torch.parallel.mesh import Mesh
    from xkv_tpu_torch.parallel.sharding import shard_cache, shard_params
    from xkv_tpu_torch.scripts import tp_serve

    mla = cfg.model_type == "deepseek_v2"
    spec = tp_serve.parse_run(run)
    mesh = Mesh(data=1, model=2, rank=0)
    scfg = dataclasses.replace(cfg, num_q_heads=cfg.num_q_heads // 2,
                               num_kv_heads=cfg.num_kv_heads // 2)
    grp = [len(g.layers) for g in xkv(spec["rope"]).layer_groups]
    cache = shard_cache(mine["joined"], grp, mesh, heads=not mla)
    sp = shard_params({"embed": params["embed"], "layers": params["layers"][:1],
                       "final_norm": params["final_norm"]}, mesh)
    sp["lm_head"] = params["lm_head"][:, :8]  # layer 0's call is all that is read
    mod_name, fn_name = TP14_KERNEL_FNS[key]
    mod = importlib.import_module(f"xkv_tpu_torch.ops.kernels.{mod_name}")
    orig, calls = getattr(mod, fn_name), []

    def record(*a, **kw):
        if not calls:
            calls.append((a, kw))
        return orig(*a, **kw)

    one = dataclasses.replace(scfg, num_layers=1)
    dev = prompt.device
    tok = mine["tokens"][:, -1:].to(dev)
    pos = prompt.shape[1] + steps - 1
    setattr(mod, fn_name, record)
    try:
        if mla:
            deepseek.decode_step(sp, one, xkv(None), cache, tok, pos, mesh=_RankZero())
        else:
            step_kw = {} if spec["sparse"] is None else dict(
                sparse_select=spec["sparse"], sparse_block=tp_serve.SPARSE_BLOCK)
            cos_sin = llama.rope_cos_sin(torch.arange(cache.prefill_len, device=dev),
                                         cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
            llama.decode_step(sp, one, xkv(spec["rope"]), cache, tok, pos, cos_sin,
                              mesh=_RankZero(), **step_kw)
    finally:
        setattr(mod, fn_name, orig)
    a, kw = calls[0]
    out, lse = orig(*a, **kw)
    ref, lse_ref = getattr(mod, fn_name + "_plain")(*a, **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    worst = {"abs": 0.0, "rel": 0.0, "lse": 0.0}
    shapes = [tuple(x.shape) for x in a[:3] if isinstance(x, torch.Tensor)]
    _hold(key, f"rank 0's shard, {run} (operands {shapes})", out, ref, lse, lse_ref, worst)
    rec = dict(max_abs_err=worst["abs"], max_rel_err=worst["rel"], lse_err=worst["lse"])
    if key in ("K7", "K8") and dev.type == "cuda":
        qe, qp, us = a[0], a[1], a[2]
        rows, s_p = qe.shape[1], us.shape[1]
        ops = 2.0 * rows * s_p * (2 * qe.shape[2] + qp.shape[2])
        rec.update(rows=rows, ms=cuda_time_ms(lambda: orig(*a, **kw)),
                   plain_ms=cuda_time_ms(lambda: getattr(mod, fn_name + "_plain")(*a, **kw)))
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            nbytes(*[x for x in a if isinstance(x, torch.Tensor)], out, lse),
            ops / BF16_OPS_PER_S)
    return rec


@contextlib.contextmanager
def per_shard_selection(model: int):
    """One device's Llama decode with the sparse selection of ``model``
    ranks: ``llama._factored_part`` runs on each rank's q and kv heads and
    factor columns (``shard_group_factors``), so each shard's top-k chunks
    are chosen over its own heads' bounds, as K4 / K5 choose them on a
    rank, and the heads are joined after. The rest of the step is one
    device's."""
    import dataclasses

    import torch

    from xkv_tpu_torch.models import llama
    from xkv_tpu_torch.ops.attention import PartialAttention
    from xkv_tpu_torch.parallel.mesh import Mesh
    from xkv_tpu_torch.parallel.sharding import shard_group_factors

    whole = llama._factored_part

    def part(q_pre, q, cos, sin, gf, gpos, li, cfg, *rest, **kw):
        if kw.get("sparse_select") is None:
            return whole(q_pre, q, cos, sin, gf, gpos, li, cfg, *rest, **kw)
        layers = gf.k_vt.shape[-1] // (cfg.num_kv_heads * cfg.head_dim)
        hq = cfg.num_q_heads // model
        scfg = dataclasses.replace(cfg, num_q_heads=hq, num_kv_heads=cfg.num_kv_heads // model)
        parts = [whole(q_pre[:, r * hq:(r + 1) * hq], q[:, r * hq:(r + 1) * hq], cos, sin,
                       shard_group_factors(gf, layers, Mesh(data=1, model=model, rank=r)),
                       gpos, li, scfg, *rest, **kw) for r in range(model)]
        return PartialAttention(out=torch.cat([p.out for p in parts], 1),
                                lse=torch.cat([p.lse for p in parts], 1))

    llama._factored_part = part
    try:
        yield
    finally:
        llama._factored_part = whole


def tp14_same_factors(eng, mine, prompt, tail, steps) -> tuple:
    """One device (``eng``) over the ranks' factors, fed the ranks' tokens:
    the prefill, the ``tail`` steps up to the refold over the joined
    prefill cache, then the steps after the refold and one past the pass
    over the joined last cache with its tail emptied. Returns (max
    |logit difference| a step, every row of the batch; each step's
    largest shortfall of a ranks' token below one device's top logit)."""
    import dataclasses

    import torch

    b, dev = prompt.shape[0], prompt.device
    logits, _ = eng.prefill(prompt)
    ref = [logits[:, -1].float().cpu()]
    last = mine["joined"]
    after = dataclasses.replace(last, tail_k=last.tail_k.clone(), tail_v=last.tail_v.clone(),
                                tail_len=torch.zeros_like(last.tail_len), tail_count=0)
    cache, pos = mine["prefill_joined"], prompt.shape[1]
    for i in range(steps):
        if i == tail:
            cache = after
        step, cache = eng.decode_step(cache, mine["tokens"][:, i:i + 1].to(dev), pos + i)
        ref.append(step[:, -1].float().cpu())
    ref = torch.stack(ref)  # (steps + 1, b, V)
    got = torch.cat([mine["logits"].reshape(steps, b, -1), mine["next_logits"][None]])
    err = (ref - got).abs().amax(dim=(1, 2)).tolist()
    picked = ref[:steps].gather(2, mine["tokens"].T[..., None])[..., 0]
    short = (ref[:steps].amax(dim=-1) - picked).amax(dim=1).tolist()
    return err, short


def tp14_compare(name, out_dir, world, totals, smi, results) -> tuple:
    """One mesh's comparisons with one device (the limits' comments
    above). Returns (its rows, what failed)."""
    import torch

    from xkv_tpu_torch.scripts import tp_serve

    argv, _ = TP14_MESHES[name]
    args = tp_serve.parse_args(argv)
    records = tp_serve.results(out_dir, world)
    dev = torch.device(args.device)
    got = torch.load(os.path.join(out_dir, "rank0.pt"), map_location=dev, weights_only=False)
    cfg, xkv, params, prompt = tp_serve.model(args)
    steps, layers = args.new, args.layers
    rows, fails = {}, []
    for run, mine in got.items():
        for k in ("tokens", "logits", "next_logits", "full_logits"):
            if k in mine:
                mine[k] = mine[k].cpu()
        spec = tp_serve.parse_run(run)
        key = TP14_KERNEL[run]
        # Two prefills (generate's, the forced pass's; K1 in Llama's); per
        # layer the steps of both, the step past the pass, and in a sparse
        # run that step over every chunk.
        n_dec = 2 * (steps - 1) + 1 + (spec["sparse"] is not None)
        want = _want(**({} if spec["rope"] is None else {"K1": 2 * layers}),
                     **({} if key is None else {key: n_dec * layers}))
        for rec in records:
            _hold_counts(f"tp14 {name} rank {rec['rank']} {run}", rec["runs"][run]["counts"],
                         want)
            for k in totals:
                totals[k] += rec["runs"][run]["counts"][k]
        row = dict(tokens=mine["tokens"].tolist())
        if key is not None and key != "K3":
            row["shard_kernel"] = tp14_shard_kernel(key, cfg, xkv, params, mine, prompt, run,
                                                    steps)
            if key in results:
                results[key]["tp14_shard"] = row["shard_kernel"]
        reset_counts()
        eng = tp_serve.engine(args, cfg, xkv, params, run, dev)
        per_shard = spec["sparse"] is not None and spec["fd"] != "int4"
        with per_shard_selection(world // args.data) if per_shard else contextlib.nullcontext():
            row["same_factors_err"], row["tokens_shortfall"] = tp14_same_factors(
                eng, mine, prompt, args.tail, steps)
        if spec["sparse"] is not None:
            exact = tp_serve.engine(args, cfg, xkv, params, run.rsplit(":", 1)[0], dev)
            full, _ = exact.step(mine["joined"], mine["tokens"][:, -1:].to(dev),
                                 prompt.shape[1] + steps - 1, {})
            row["full_coverage_err"] = (full[:, -1].float().cpu()
                                        - mine["full_logits"]).abs().max().item()
            del exact
        for k, n in read_counts().items():
            totals[k] += n
        del eng
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        row["ranks"] = [dict(rank=rec["rank"], coords=rec["coords"], heads=rec["heads"],
                             peak_gb=rec.get("peak_gb"),
                             prefill_s=rec["runs"][run]["prefill_s"],
                             decode_ms_per_token=rec["runs"][run]["decode_ms_per_token"],
                             launches={k: v for k, v in rec["runs"][run]["counts"].items() if v})
                        for rec in records]
        row["card"] = smi
        log(f"tp14 {name} {run} " + json.dumps(row))
        rows[run] = row
        same_lim = (TOL_TP14_MLA if spec["rope"] is None
                    else TOL_TP14_SHARD if per_shard else TOL_TP)
        if max(row["same_factors_err"]) > same_lim:
            fails.append(f"{name} {run}: same factors {row['same_factors_err']} "
                         f"(limit {same_lim})")
        if max(row["tokens_shortfall"]) > 2 * same_lim:
            fails.append(f"{name} {run}: the ranks' tokens' shortfall {row['tokens_shortfall']} "
                         f"(limit {2 * same_lim})")
        if row.get("full_coverage_err", 0.0) > TOL_TP:
            fails.append(f"{name} {run}: every chunk against one device's exact step "
                         f"{row['full_coverage_err']} (limit {TOL_TP})")
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rows, fails


def tp14_phase(results, ranks: Tp14Ranks) -> dict:
    """Phase 14: each mesh's ranks waited for (``ranks`` launched them
    beside earlier phases) and held against one device, (c) first, whose
    ranks ran beside phase 11. Returns the launch counts (every rank's and
    one device's)."""
    import shutil

    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t_phase = time.time()
    totals = {key: 0 for key in COUNTERS}
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    rows, fails = {}, []
    try:
        for name in ("c", "a", "b"):
            ranks.wait(name)
            t0 = time.time()
            rows[name], failed = tp14_compare(name, ranks.dirs[name], TP14_MESHES[name][1],
                                              totals, smi, results)
            fails.extend(failed)
            results[f"tp14_compare_{name}_s"] = time.time() - t0
            log(f"tp14 {name}: launched {t_phase - ranks.launched[name]:.1f} s before the "
                f"phase, waited for {ranks.waited[name]:.1f} s, the comparisons "
                f"{results[f'tp14_compare_{name}_s']:.1f} s")
        if fails:
            raise AssertionError("tp14 against one device: " + "; ".join(fails))
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    shutil.rmtree(ranks.root)
    results["tp14"] = dict(rows=rows, tol_same=TOL_TP, tol_mla=TOL_TP14_MLA,
                           tol_shard=TOL_TP14_SHARD, tol_full=TOL_TP)
    results["tp14_phase_s"] = time.time() - t_phase
    log(f"tp14 phase: {results['tp14_phase_s']:.1f} s (gloo on one card, not tensor "
        f"parallelism's speed; {smi})")
    return totals


# ------------------------------- phase 15: SP, batching and PP under a mesh
# Three waves of ranks sharing the card (gloo), each launched beside an
# earlier phase's host-bound work (``RankWaves``), Llama-3.1-8B's widths
# cut in depth, random bf16 weights from seed 0:
# (a) sequence parallelism (``scripts/tp_serve.py --sequence_parallel``):
#     4 layers (one xKV-4 group, rank 512 / 768), an 8192-token prompt at
#     data 2 x model 2 (ring blocks of 4096 rows, plain as in JAX), pre
#     bf16, 16 tokens over an 8-row tail (one refold): the decode on every
#     data rank through K3;
# (b) ``BatchedEngine`` at data 2 x model 2 (``tp_serve --batched``): 4
#     slots (2 a data row) of 4608 rows, 64-row tails, 6 requests of
#     1000-4096 tokens and 16-24 new; pre bf16 admitted in 512-row chunks
#     (K3), and post bf16 with sparse top-4 of 512-row chunks and
#     speculative_k 3 (K1 admissions, K4 drafts, K2 verify at R 64);
# (c) pipeline parallelism (``scripts/pp_serve.py``): 8 layers (two xKV-4
#     groups, post), 2 stages, b 4 of 2048-token prompts:
#     ``pipelined_forward`` at M 2 (K1), 8 ``pipelined_decode_step``s (4
#     at M 2, 4 at M 4) in bf16 and in int8 (K2).
# Held: each rank's launches; rank 0's first K1-K4 calls against their
# plain versions on the same operands (``TOL``); (a) one device over the
# ranks' joined factors fed their tokens at every step within TOL_TP, each
# token of the ranks at most 2 x TOL_TP below its top logit, the ring
# prefill's last logits against one device's K1 prefill within twice the
# control (one device's plain prefill attention against its K1, read in
# the run); (b) every rank's tokens equal, and each request's tokens
# teacher-forced through one device's exact steps over the factors its
# slot admitted, each within GAP_8B (phases 8 and 9) of its step's top
# log-prob; (c) rank 0 against one device holding every layer and the
# whole cache (the forward's logits, each step's logits and the stages'
# joined tails) within TOL_TP15_PP, the stages' tokens below its top logit.
TP15_COMMON = ["--device", "cuda", "--layers", "4", "--data", "2", "--nproc", "2", "--check"]
TP15 = {  # name: (argv, ranks)
    "a": (TP15_COMMON + ["--sequence_parallel", "--prompt", "8192", "--new", "16",
                         "--tail", "8", "--runs", "pre:bf16"], 4),
    "b": (TP15_COMMON + ["--batched", "--slots", "4", "--s_max", "4608", "--tail", "64",
                         "--runs", "pre:bf16:chunk512,post:bf16:sparse4:spec3"], 4),
    "c": (["--device", "cuda", "--layers", "8", "--stages", "2", "--batch", "4", "--prompt",
           "2048", "--steps", "8", "--check"], 2),
}
TP15_MODULES = {"c": "xkv_tpu_torch.scripts.pp_serve"}
# (b): the kernels each run launches on a rank.
TP15_BATCHED_KERNELS = {"pre:bf16:chunk512": {"K3"},
                        "post:bf16:sparse4:spec3": {"K1", "K2", "K4"}}
# (c): one device against the stages (the same kernels on the same values;
# the stages run b / M rows where one device runs b, through other GEMM
# kernels at M 1 and 2 rows than at 4): twice the readings on an H100 80GB
# HBM3 at 700 W (each step's logits 0.1152-0.1377, the joined tails
# 0.0938-0.1113, bf16 and int8; PERF.md section 6). The forward read 0.0
# (the prefill's row blocks take the same kernels at 2 x 2048 rows as at
# 4 x 2048) and is held at the steps' limit; each of the stages' tokens
# at most twice it below one device's top logit (read 0-0.03125).
TOL_TP15_PP = {"forward": 2 * 0.1377, "logits": 2 * 0.1377, "tail": 2 * 0.1113}


def _hold_calls(label: str, calls: dict, keys, worst: dict) -> dict:
    """Rank 0's recorded first calls (``tp_serve.first_calls``) of ``keys``
    held against their plain versions at ``TOL``; their readings."""
    rec = {}
    for key in keys:
        if key not in calls:
            raise AssertionError(f"{label}: rank 0 made no {key} call")
        c = calls[key]
        w = {"abs": 0.0, "rel": 0.0, "lse": 0.0}
        if key == "K1":
            rel = row_rel_err(c["out"], c["ref"])
            log(f"K1 {label} (operands {c['shapes']}): max_rel_err={rel:.3e} "
                f"(limit {TOL['K1']:.3e})")
            if not rel <= TOL["K1"]:
                raise AssertionError(f"K1 disagrees with its plain version ({label})")
            w.update(abs=max_abs_err(c["out"], c["ref"]), rel=rel)
        else:
            _hold(key, f"{label} (operands {c['shapes']})", c["out"], c["ref"], c["lse"],
                  c["lse_ref"], w)
        rec[key] = dict(max_abs_err=w["abs"], max_rel_err=w["rel"], lse_err=w["lse"],
                        shapes=c["shapes"])
        into = worst.setdefault(key, {"abs": 0.0, "rel": 0.0, "lse": 0.0})
        for k in ("abs", "rel", "lse"):
            into[k] = max(into[k], w[k])
    return rec


def _rank_rows(records, run: str, keys) -> list:
    return [dict(rank=rec["rank"], coords=rec.get("coords"), peak_gb=rec.get("peak_gb"),
                 launches={k: v for k, v in rec["runs"][run]["counts"].items() if v},
                 **{k: rec["runs"][run][k] for k in keys})
            for rec in records]


def tp15_sp(out_dir, totals, smi, results, shared, worst) -> tuple:
    """(a): the ranks' launches, rank 0's K3, one device over their joined
    factors, the ring prefill against one device's K1 and the control."""
    import torch

    from xkv_tpu_torch.models import llama
    from xkv_tpu_torch.ops.kernels.flash_attention import flash_attention_plain
    from xkv_tpu_torch.scripts import tp_serve

    argv, world = TP15["a"]
    args = tp_serve.parse_args(argv)
    records = tp_serve.results(out_dir, world)
    dev = torch.device(args.device)
    got = torch.load(os.path.join(out_dir, "rank0.pt"), map_location=dev, weights_only=False)
    calls = torch.load(os.path.join(out_dir, "kernels.pt"), weights_only=False)
    cfg, xkv, params, prompt = tp_serve.model(args)
    shared.update(cfg=cfg, xkv=xkv, params=params)
    steps, layers, fails = args.new, args.layers, []
    run = "pre:bf16"
    mine = got[run]
    for k in ("tokens", "logits", "next_logits"):
        mine[k] = mine[k].cpu()
    # The ring runs no K1; every decode step K3 a layer (generate's, the
    # forced pass's and the step past it).
    want = _want(K3=(2 * (steps - 1) + 1) * layers)
    for rec in records:
        _hold_counts(f"tp15 a rank {rec['rank']}", rec["runs"][run]["counts"], want)
        for k in totals:
            totals[k] += rec["runs"][run]["counts"][k]
    row = dict(tokens=mine["tokens"].tolist(),
               shard_kernels=_hold_calls("tp15 a rank 0's shard", calls[run], ("K3",), worst))
    reset_counts()
    eng = tp_serve.engine(args, cfg, xkv, params, run, dev)
    row["same_factors_err"], row["tokens_shortfall"] = tp14_same_factors(
        eng, mine, prompt, args.tail, steps)
    s = prompt.shape[1]
    k1, _ = llama.prefill(params, cfg, prompt, logits_position=s - 1)
    plain, _ = llama.prefill(params, cfg, prompt, logits_position=s - 1,
                             attention=flash_attention_plain)
    row["control_plain_vs_k1"] = (k1 - plain).abs().max().item()
    row["ring_prefill_err"] = row["same_factors_err"][0]
    for k, n in read_counts().items():
        totals[k] += n
    del eng, k1, plain
    row["ranks"] = _rank_rows(records, run, ("prefill_s", "decode_ms_per_token"))
    row["card"] = smi
    row["limits"] = dict(prefill=2 * row["control_plain_vs_k1"], steps=TOL_TP,
                         shortfall=2 * TOL_TP)
    log(f"tp15 a {run} " + json.dumps(row))
    if row["ring_prefill_err"] > row["limits"]["prefill"]:
        fails.append(f"a: the ring prefill {row['ring_prefill_err']} from one device's K1 "
                     f"(limit {row['limits']['prefill']})")
    if max(row["same_factors_err"][1:]) > TOL_TP:
        fails.append(f"a: same factors {row['same_factors_err']} (limit {TOL_TP})")
    if max(row["tokens_shortfall"]) > 2 * TOL_TP:
        fails.append(f"a: the ranks' tokens' shortfall {row['tokens_shortfall']} "
                     f"(limit {2 * TOL_TP})")
    return {run: row}, fails


def tp15_batched(out_dir, totals, smi, results, shared, worst) -> tuple:
    """(b): every rank's tokens equal; each request's tokens teacher-forced
    through one device's exact steps over its admitted factors; the runs'
    kernels launched; rank 0's first K1-K4 calls."""
    import glob
    from types import SimpleNamespace

    import torch

    from xkv_tpu_torch.engine import InferenceEngine
    from xkv_tpu_torch.scripts import tp_serve

    argv, world = TP15["b"]
    args = tp_serve.parse_args(argv)
    records = tp_serve.results(out_dir, world)
    calls = torch.load(os.path.join(out_dir, "kernels.pt"), weights_only=False)
    cfg, xkv, params = shared["cfg"], shared["xkv"], shared["params"]
    prompts = tp_serve.batched_prompts(args, cfg)
    n_req = len(prompts)
    rows, fails = {}, []
    for run in args.runs.split(","):
        spec = tp_serve.parse_run(run)
        tokens = [rec["runs"][run]["tokens"] for rec in records]
        row = dict(tokens=tokens[0])
        if any(t != tokens[0] for t in tokens):
            fails.append(f"b {run}: the ranks' tokens differ")
        for rec in records:
            launched = {k for k, v in rec["runs"][run]["counts"].items() if v}
            if launched != TP15_BATCHED_KERNELS[run]:
                fails.append(f"b {run} rank {rec['rank']}: launched {sorted(launched)}, "
                             f"expected {sorted(TP15_BATCHED_KERNELS[run])}")
            for k in totals:
                totals[k] += rec["runs"][run]["counts"][k]
        row["shard_kernels"] = _hold_calls(f"tp15 b {run} rank 0", calls[run],
                                           sorted(TP15_BATCHED_KERNELS[run]), worst)
        admitted = {}
        for f in glob.glob(os.path.join(out_dir, f"admitted_{run.replace(':', '_')}_*.pt")):
            admitted.update(tp_serve.to_device(torch.load(f, weights_only=False), "cuda"))
        reset_counts()
        single = InferenceEngine(params, cfg, xkv(spec["rope"]), tail_max=args.tail,
                                 factor_dtype=tp_serve.factor_dtype(spec["fd"]),
                                 prefill_logits="last", device="cuda")
        view = SimpleNamespace(params=params, _mla=False, sparse_block=tp_serve.SPARSE_BLOCK,
                               cfg=cfg, tail_max=args.tail, cache_dtype=params["embed"].dtype)
        row["references"], counts = teacher_force(
            f"tp15 b {run}", view, single, cfg, prompts, tokens[0], admitted,
            list(range(n_req)), GAP_8B, refs=range(n_req))
        for k, n in counts.items():
            totals[k] += n
        del single, admitted
        row["ranks"] = _rank_rows(records, run, ("run_s", "admission_s", "steps", "step_ms",
                                                 "spec_stats"))
        row["card"] = smi
        row["limit"] = GAP_8B
        log(f"tp15 b {run} " + json.dumps(row))
        rows[run] = row
    return rows, fails


def tp15_pipeline(out_dir, totals, smi, results, shared, worst) -> tuple:
    """(c): the stages' launches; rank 0's K1 and K2 calls; its readings
    against one device."""
    import torch

    from xkv_tpu_torch.scripts import tp_serve

    argv, world = TP15["c"]
    records = tp_serve.results(out_dir, world)
    calls = torch.load(os.path.join(out_dir, "kernels.pt"), weights_only=False)
    fails = []
    steps = int(argv[argv.index("--steps") + 1])
    lp = int(argv[argv.index("--layers") + 1]) // world
    for rec in records:
        _hold_counts(f"tp15 c stage {rec['stage']} forward", rec["forward_counts"],
                     _want(K1=2 * lp))
        for k in totals:
            totals[k] += rec["forward_counts"][k]
        for run, r in rec["runs"].items():
            _hold_counts(f"tp15 c stage {rec['stage']} {run}", r["counts"],
                         _want(K2=lp * (2 * (steps // 2) + 4 * (steps - steps // 2))))
            for k in totals:
                totals[k] += r["counts"][k]
    readings = records[0]["readings"]
    row = dict(readings=readings, limits=TOL_TP15_PP, card=smi,
               shard_kernels=_hold_calls("tp15 c stage 0 forward", calls, ("K1",), worst))
    for run in ("bf16", "int8"):
        row["shard_kernels"][run] = _hold_calls(f"tp15 c stage 0 {run}", calls[run], ("K2",),
                                                worst)
    row["stages"] = [dict(stage=rec["stage"], layers=rec["layers"], peak_gb=rec.get("peak_gb"),
                          forward_s=rec["forward_s"],
                          ms_per_step={run: r["ms_per_step"] for run, r in rec["runs"].items()})
                     for rec in records]
    log("tp15 c " + json.dumps(row))
    worst_step = {k: max(x[k] for run in ("bf16", "int8") for x in readings[run])
                  for k in ("logits_err", "tail_err", "shortfall")}
    for k, got, lim in (("forward", readings["forward_err"], TOL_TP15_PP["forward"]),
                        ("logits", worst_step["logits_err"], TOL_TP15_PP["logits"]),
                        ("tail", worst_step["tail_err"], TOL_TP15_PP["tail"]),
                        ("shortfall", worst_step["shortfall"], 2 * TOL_TP15_PP["logits"])):
        if got > lim:
            fails.append(f"c: {k} {got} from one device (limit {lim})")
    for run in ("bf16", "int8"):
        if any(x["tail_count"][0] != x["tail_count"][1] for x in readings[run]):
            fails.append(f"c {run}: the stages' tail fill differs from one device's")
    return {"pipeline": row}, fails


TP15_COMPARE = {"a": tp15_sp, "b": tp15_batched, "c": tp15_pipeline}


def tp15_phase(results, ranks: RankWaves, order=("c", "a", "b")) -> dict:
    """Phase 15: each wave's ranks waited for (``ranks`` launched them
    beside earlier phases) and held against one device. Returns the launch
    counts (every rank's and one device's)."""
    import shutil

    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t_phase = time.time()
    totals = {key: 0 for key in COUNTERS}
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    rows, fails, shared, worst = {}, [], {}, {}
    try:
        for name in order:
            ranks.wait(name)
            t0 = time.time()
            rows[name], failed = TP15_COMPARE[name](ranks.dirs[name], totals, smi, results,
                                                    shared, worst)
            fails.extend(failed)
            results[f"tp15_compare_{name}_s"] = time.time() - t0
            log(f"tp15 {name}: launched {t_phase - ranks.launched[name]:.1f} s before the "
                f"phase, waited for {ranks.waited[name]:.1f} s, the comparisons "
                f"{results[f'tp15_compare_{name}_s']:.1f} s")
        if fails:
            raise AssertionError("tp15 against one device: " + "; ".join(fails))
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
        shared.clear()
    shutil.rmtree(ranks.root)
    for key, w in worst.items():
        results[key]["tp15_shard"] = w
    results["tp15"] = dict(rows=rows, tol_steps=TOL_TP, tol_pp=TOL_TP15_PP, gap=GAP_8B)
    results["tp15_phase_s"] = time.time() - t_phase
    log(f"tp15 phase: {results['tp15_phase_s']:.1f} s (gloo on one card, not sequence, "
        f"data or pipeline parallelism's speed; {smi})")
    return totals


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from xkv_tpu_torch.ops.kernels import _build

    t_start = time.time()
    marks = {}  # each section's end, s from the start: the run's breakdown

    def mark(name: str) -> None:
        marks[name] = round(time.time() - t_start, 1)

    t0 = time.time()
    lib_path = _build.build()
    _build.load()
    mark("build")
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
    check_flash(gen, results, build_log if os.path.exists(build_log) else None)
    bl = build_log if os.path.exists(build_log) else None
    check_decode(gen, results, bl)
    check_sparse_and_mixed(gen, results, bl)
    t0 = time.time()
    check_chunk_widths(gen, results)
    check_head_sizes(gen, results)
    log(f"chunk-width and head-size phase: {time.time() - t0:.1f} s")
    check_mla(gen, results)
    check_batched_kernels(gen, results)
    t0 = time.time()
    check_batched_spec_kernels(gen, results)
    spec_phase9_time(results, "kernels", time.time() - t0)
    t0 = time.time()
    check_wide(gen, results)
    log(f"wide-rank phase: {time.time() - t0:.1f} s")
    mark("kernels")
    t0 = time.time()
    k3_int8_ms = check_variants(gen, results)
    check_ablation(gen, results, k3_int8_ms)
    check_probe(results)
    tool_counts = tools_path(results)
    log(f"tools phase: {time.time() - t0:.1f} s")
    mark("tools")
    # Phase 15's waves run beside host-bound work, one wave at a time (the
    # card holds ~20-34 GB a wave beside the main process): (a) beside
    # phase 8's admissions, (b) from phase 9's persistence on, (c) beside
    # the 1B, tiny-engine and anchor phases; each is waited for before the
    # next is launched, and (c) before V2-Lite, which needs the card's
    # memory. Phase 12's timed steps keep the card to themselves.
    waves = RankWaves("tp15", TP15, TP15_MODULES)
    ranks = Tp14Ranks()

    def beside_persistence():
        waves.wait("a")
        waves.launch(("b",), "phase 9's persistence")

    try:
        totals = main_path(results, {
            "batching": lambda: waves.launch(("a",), "phase 8's admissions"),
            "persistence": beside_persistence})
        mark("main path")
        torch.cuda.empty_cache()
        waves.wait("b")
        waves.launch(("c",), "the 1B, tiny-engine and anchor phases")
        counts_1b = llama_1b_path(results)
        mark("1B")
        t0 = time.time()
        counts_small = small_engine_path(results)
        log(f"tiny-engine phase: {time.time() - t0:.1f} s")
        for key in totals:
            totals[key] += tool_counts[key] + counts_1b[key] + counts_small[key]
        mark("tiny")
        anchor()
        minicache_anchor(results)
        mark("anchors")
        waves.wait("c")
        torch.cuda.empty_cache()
        mla_totals = mla_path(results)
        for key in totals:
            totals[key] += mla_totals[key]
        mla_anchor()
        mark("V2-Lite")
        ckpt_counts = speculative_checkpoint(results)
        for key in totals:
            totals[key] += ckpt_counts[key]
        torch.cuda.empty_cache()
        # Phase 14's ranks run beside phase 11's host-bound eval_acc and
        # eval_perplexity ((c)) and beside phase 13 ((a), (b)); phase 12's
        # timed steps run with the card to themselves.
        eval_counts = eval_path(
            results, lambda: ranks.launch(("c",), "eval_acc and eval_perplexity"))
        for key in totals:
            totals[key] += eval_counts[key]
        ranks.wait("c")
        mark("eval")
        torch.cuda.empty_cache()
        train_counts = train_path(results)
        for key in totals:
            totals[key] += train_counts[key]
        mark("train")
        gc.collect()
        torch.cuda.empty_cache()
        ranks.launch(("a", "b"), "phase 13")
        tp_counts = tp_phase(results)
        for key in totals:
            totals[key] += tp_counts[key]
        mark("examples and tp")
        gc.collect()
        torch.cuda.empty_cache()
        tp14_counts = tp14_phase(results, ranks)
        for key in totals:
            totals[key] += tp14_counts[key]
        mark("tp14")
        gc.collect()
        torch.cuda.empty_cache()
        tp15_counts = tp15_phase(results, waves)
    finally:
        ranks.stop()
        waves.stop()
    for key in totals:
        totals[key] += tp15_counts[key]
    mark("tp15")
    log(f"speculative-and-staged phase: {sum(results['spec_phase_s'].values()):.1f} s")
    log(f"batch phase: {sum(results['batch_phase_s'].values()):.1f} s")
    log(f"batched-speculation and persistence phase: "
        f"{sum(results['batch_spec_phase_s'].values()):.1f} s")
    log(f"minicache phase: {sum(results['minicache_phase_s'].values()):.1f} s")
    log(f"eval phase: {sum(results['eval_phase_s'].values()):.1f} s")
    log(f"train phase: {sum(results['train_phase_s'].values()):.1f} s")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"total {time.time() - t_start:.1f} s; sections end at (s) {json.dumps(marks)}")
    log(smi)
    kernels = []
    for key in COUNTERS:
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
