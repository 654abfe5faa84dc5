"""Perplexity evaluation with the compressed cache ("RNN mode").

Counterpart of the reference's `eval_perplexity_rnn.py:38-275`. One
deliberate difference: the reference feeds tokens one at a time from the
start, which means its prefill-merge branch never fires (its attention patch
requires q_len > 1 to enter 'prefill' mode, `xKV/attn_patch/llama.py:38`) —
the compressed cache is never actually exercised there. Here the first
``prefill_frac`` of each sequence is prefilled + compressed, and the
remainder is scored token-by-token through the factored cache, so the
perplexity delta actually measures compression quality.

A copy of ``xkv_tpu/evalharness/perplexity.py`` kept inside the port. The
first continuation token is scored from the prefill's last logits
(``log_softmax`` in fp32); the rest from ``engine.score``, which on a CUDA
device replays the captured decode step once per token.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch


def score_text_tokens(
    engine,
    input_ids: np.ndarray,
    prefill_frac: float = 0.5,
    min_prefill: int = 8,
) -> Dict[str, float]:
    """Per-token NLL of one tokenized sequence (1, s) through the engine."""
    input_ids = np.asarray(input_ids, dtype=np.int32).reshape(1, -1)
    seq_len = input_ids.shape[1]
    if seq_len < min_prefill + 2:
        raise ValueError(f"sequence too short: {seq_len}")

    split = max(min_prefill, int(seq_len * prefill_frac))
    split = min(split, seq_len - 2)
    prefill_ids = input_ids[:, :split]
    rest = input_ids[:, split:]

    logits, cache = engine.prefill(prefill_ids)
    # Score the first continuation token from prefill logits.
    first = torch.as_tensor(rest[:, :1], dtype=torch.long, device=logits.device)
    logp_first = torch.log_softmax(logits[:, -1].float(), dim=-1).gather(-1, first)
    logp_first = logp_first.cpu().numpy()
    # Feed rest[:-1]; each step scores the next token.
    feed = rest[:, :-1]
    logprobs, _ = engine.score(cache, feed, split)
    targets = rest[:, 1:]
    picked = torch.as_tensor(targets, dtype=torch.long, device=logprobs.device)
    logp = logprobs.gather(-1, picked[:, :, None]).squeeze(-1).cpu().numpy()

    total_ll = float(logp_first.sum() + logp.sum())
    n_tokens = 1 + targets.shape[1]
    avg = total_ll / n_tokens
    return {
        "perplexity": float(np.exp(-avg)),
        "avg_log_likelihood": avg,
        "total_tokens": n_tokens,
        "sequence_length": seq_len,
        "prefill_tokens": split,
    }


def score_text_sliding_window(
    engine,
    input_ids: np.ndarray,
    max_length: int,
    stride: int,
    prefill_frac: float = 0.5,
) -> Dict[str, float]:
    """Sliding-window perplexity for sequences longer than ``max_length``
    (reference `eval_perplexity_rnn.py:138-181`): score each
    ``max_length``-token window independently (token-weighted aggregate),
    stepping by ``stride``. Windows overlap when stride < max_length; like
    the reference, overlapping tokens are simply re-scored in their new
    window context."""
    input_ids = np.asarray(input_ids, dtype=np.int32).reshape(1, -1)
    seq_len = input_ids.shape[1]
    total_ll, total_tokens = 0.0, 0
    for begin in range(0, seq_len, stride):
        end = min(begin + max_length, seq_len)
        window = input_ids[:, begin:end]
        res = score_text_tokens(engine, window, prefill_frac=prefill_frac)
        total_ll += res["avg_log_likelihood"] * res["total_tokens"]
        total_tokens += res["total_tokens"]
        if end == seq_len:
            break
    avg = total_ll / max(total_tokens, 1)
    return {
        "perplexity": float(np.exp(-avg)),
        "avg_log_likelihood": avg,
        "total_tokens": total_tokens,
        "sequence_length": seq_len,
    }


def evaluate_texts(
    engine,
    tokenizer,
    texts: List[str],
    max_length: Optional[int] = None,
    prefill_frac: float = 0.5,
    verbose: bool = True,
    stride: Optional[int] = None,
) -> Dict[str, float]:
    """Aggregate perplexity over texts (token-weighted, like the reference's
    dataset summary `eval_perplexity_rnn.py:183-275`).

    stride: when set, sequences longer than ``max_length`` are scored with
    the sliding-window variant instead of truncated (reference
    `eval_perplexity_rnn.py:66-71`)."""
    total_ll, total_tokens, per_text = 0.0, 0, []
    for i, text in enumerate(texts):
        ids = tokenizer.encode(text, add_special_tokens=True)
        use_window = (
            stride is not None
            and max_length is not None
            and len(ids) > max_length
        )
        if max_length is not None and not use_window:
            ids = ids[:max_length]
        if len(ids) < 10:
            continue
        try:
            if use_window:
                res = score_text_sliding_window(
                    engine, np.asarray(ids)[None, :], max_length, stride,
                    prefill_frac=prefill_frac,
                )
            else:
                res = score_text_tokens(
                    engine, np.asarray(ids)[None, :], prefill_frac=prefill_frac
                )
        except ValueError:
            continue
        per_text.append(res)
        total_ll += res["avg_log_likelihood"] * res["total_tokens"]
        total_tokens += res["total_tokens"]
        if verbose:
            print(
                f"[{i + 1}/{len(texts)}] ppl={res['perplexity']:.3f} "
                f"tokens={res['total_tokens']}",
                flush=True,
            )
    avg = total_ll / max(total_tokens, 1)
    return {
        "perplexity": float(np.exp(-avg)),
        "total_tokens": total_tokens,
        "num_texts": len(per_text),
        "per_text": per_text,
    }
