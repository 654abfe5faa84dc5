"""Automated sparse-layer probe: which layers need EXACT cache reads?

Quest-bound informativeness is layer-dependent (docs/RULER_OFFLINE.md:
the study model's retrieval layer ranked the needle chunk at the sink for
every head while layer 0 ranked it first) — so production sparse decode
should run per-layer sparse/dense mixing (`sparse_layers`). The round-4
guidance was a manual "force-include sweep (~10 lines)"; this module is
that sweep as a harness command (VERDICT r4 #9).

Method (label-free — works on any prompts, no task answers needed):
  1. Generate greedily with the EXACT factored engine (the reference
     output).
  2. Leave-one-out: for each layer l, generate with every layer sparse
     EXCEPT l; score per-layer gain = agreement(all-sparse-except-l) -
     agreement(all-sparse) against the exact output.
  3. Rank layers by gain and prefix-scan: make the top-1, top-2, ...
     ranked layers exact until agreement >= threshold. The smallest
     such exact set is the recommendation.

Cost: <= 2*L + 2 generation runs over the probe prompts. Agreement is
mean exact-prefix-token match — the quantity speculative decoding
optimizes and a tight proxy for greedy-output fidelity.

CLI: ``python -m xkv_tpu_torch.cli.eval_acc --probe_sparse_layers ...`` runs
this over the first samples of the requested dataset and prints the
recommended ``--sparse_layers`` value.

A copy of ``xkv_tpu/evalharness/sparse_probe.py`` kept inside the port; its
engines are the port's ``InferenceEngine`` on the device that
``engine_kwargs["device"]`` names (the card by default).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def _agreement(ref_rows: List[np.ndarray], got_rows: List[np.ndarray]) -> float:
    """Mean fraction of greedily-matching prefix tokens across prompts."""
    scores = []
    for r, g in zip(ref_rows, got_rows):
        n = min(len(r), len(g))
        if n == 0:
            scores.append(1.0 if len(r) == len(g) else 0.0)
            continue
        match = 0
        for i in range(n):
            if r[i] != g[i]:
                break
            match += 1
        scores.append(match / max(len(r), 1))
    return float(np.mean(scores)) if scores else 1.0


def probe_sparse_layers(
    params,
    cfg,
    xkv,
    prompts: Sequence[np.ndarray],  # each (1, s) int32
    sparse_topk: int,
    sparse_block: int = 1024,
    gen_len: int = 16,
    threshold: float = 0.95,
    engine_kwargs: Optional[dict] = None,
) -> Dict:
    """Run the leave-one-out sweep; returns
    {"recommended_sparse_layers": [...], "agreement_all_sparse": a0,
     "agreement_final": a, "per_layer_gain": {l: gain},
     "prefix_agreements": [(exact_set, agreement)]}.

    ``recommended_sparse_layers`` is the set to pass as ``sparse_layers``
    (the layers that STAY sparse); its complement reads exactly.
    """
    from xkv_tpu_torch.engine import InferenceEngine

    engine_kwargs = dict(engine_kwargs or {})
    engine_kwargs.setdefault("mode", "factored")
    engine_kwargs.setdefault("tail_max", gen_len + 8)
    engine_kwargs.setdefault("prefill_logits", "last")
    L = cfg.num_layers
    all_layers = frozenset(range(L))

    def gen(sparse_layers):
        eng = InferenceEngine(
            params, cfg, xkv=xkv,
            sparse_topk=sparse_topk, sparse_block=sparse_block,
            sparse_layers=sparse_layers, **engine_kwargs,
        )
        rows = []
        for p in prompts:
            out = eng.generate(np.asarray(p), max_new_tokens=gen_len)
            rows.append(out[0].cpu().numpy())
        del eng
        return rows

    # reference: exact factored decode (sparse_topk=None)
    eng_exact = InferenceEngine(params, cfg, xkv=xkv, **engine_kwargs)
    ref = []
    for p in prompts:
        out = eng_exact.generate(np.asarray(p), max_new_tokens=gen_len)
        ref.append(out[0].cpu().numpy())
    del eng_exact

    a0 = _agreement(ref, gen(all_layers))
    result = {
        "agreement_all_sparse": a0,
        "per_layer_gain": {},
        "prefix_agreements": [],
    }
    if a0 >= threshold:
        result["recommended_sparse_layers"] = sorted(all_layers)
        result["agreement_final"] = a0
        return result

    # leave-one-out gains
    gains = {}
    for l in range(L):
        a_l = _agreement(ref, gen(all_layers - {l}))
        gains[l] = a_l - a0
    result["per_layer_gain"] = gains

    # prefix-scan the ranked layers (ties -> deeper layers first: the
    # study's retrieval layer was its model's deepest)
    ranked = sorted(range(L), key=lambda l: (-gains[l], -l))
    exact: set = set()
    a = a0
    for l in ranked:
        if a >= threshold:
            break
        exact.add(l)
        a = _agreement(ref, gen(all_layers - exact))
        result["prefix_agreements"].append((sorted(exact), a))
    result["recommended_sparse_layers"] = sorted(all_layers - exact)
    result["agreement_final"] = a
    return result
