"""Ring attention: sequence-parallel attention over a mesh axis.

Port of ``xkv_tpu/ops/ring_attention.py``. Each rank of the ring (the
ranks along ``axis_name`` of a ``parallel.mesh.Mesh``) holds its s / n rows
of Q, K and V (for its heads, under a model axis):

  * each of the n steps attends the rank's Q rows to the K/V block it holds
    (masked by *global* positions: causal, sliding window) and merges the
    partial (max, sum, output) into its running online softmax in fp32;
  * then the K/V block moves to the ring's next rank (``Mesh.shift``), so
    after n steps every query has seen every key, with each block crossing
    one link a step.

A causal ring skips a block strictly in the rank's future, and a windowed
one a block wholly behind the window: n(n+1)/2 of the n^2 block products
run, with no host sync, since a block's origin is a Python int. The K/V
still travel every step (the last step's shift, which only brings each
block home, is left out). The block body is plain torch, as the JAX one is
plain ``jnp`` (it reaches no Pallas kernel): a kernel for it (K1 with q/k
offsets and an lse output) is a later pass (ROADMAP queue 2).
"""

from __future__ import annotations

from typing import Optional

import torch

from xkv_tpu_torch.ops.attention import NEG_INF

# Block products run (``ring_attention`` adds one a computed block); the
# tests read it to see the causal skip.
COUNTS = {"blocks": 0}
# Query rows a block product takes at once: its fp32 scores are (b, hq,
# ROWS, s / n), not (b, hq, s / n, s / n). Rows are independent, so the
# split changes no value.
ROWS = 1024


def _local_block_attention(q, k, v, scale, q_start, k_start, s_total, window, causal=True):
    """Partial attention of a local Q block against one K/V block, masked by
    global positions. q: (b, hkv, qpk, sq, hd); k / v: (b, hkv, sk, hd).
    Returns (m, l, acc), fp32: the rows' max score, the sum of their
    exponentials and the unnormalised output. Products of the inputs'
    dtype, summed in fp32 (the JAX ``preferred_element_type``); the
    probabilities are rounded to V's dtype before their product, as in
    JAX."""
    sq, sk = q.shape[3], k.shape[2]
    dev = q.device
    scores = torch.einsum("bgnqd,bgkd->bgnqk", q.float(), k.float()) * scale
    rows = q_start + torch.arange(sq, device=dev)[:, None]
    cols = k_start + torch.arange(sk, device=dev)[None, :]
    mask = cols < s_total
    if causal:
        mask = mask & (cols <= rows)
    if window is not None:
        mask = mask & (cols > rows - window)
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bgnqk,bgkd->bgnqd", p.to(v.dtype).float(), v.float())
    return m, l, acc


def ring_attention(
    q: torch.Tensor,  # (b, hq, s / n, hd): this rank's rows
    k: torch.Tensor,  # (b, hkv, s / n, hd)
    v: torch.Tensor,  # (b, hkv, s / n, hd)
    *,
    mesh,
    axis_name: str = "data",
    scale: float,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Sequence-parallel attention (causal by default; ``causal=False`` runs
    the full bidirectional mask) over the ranks along ``axis_name``, rank
    i of the axis holding rows [i * s / n, (i + 1) * s / n) of the sequence.
    Returns this rank's rows of the output, (b, hq, s / n, hd) in q's
    dtype. Every rank of the axis must call it."""
    b, hq, s_local, hd = q.shape
    hkv = k.shape[1]
    n = mesh.shape[axis_name]
    s = s_local * n  # the caller splits s, which n divides (``llama.prefill``)
    idx = mesh.axis_ranks(axis_name).index(mesh.rank)
    qg = q.reshape(b, hkv, hq // hkv, s_local, hd)
    q_start = idx * s_local
    m = torch.full((b, hkv, hq // hkv, s_local, 1), float("-inf"), device=q.device)
    l = torch.zeros((b, hkv, hq // hkv, s_local, 1), device=q.device)
    acc = torch.zeros((b, hkv, hq // hkv, s_local, hd), device=q.device)
    k_cur, v_cur = k, v
    for i in range(n):
        # The block held now arrived from the rank (idx - i) mod n.
        src = (idx - i) % n
        k_start = src * s_local
        needed = True
        if causal:
            # A block strictly in this rank's future is wholly masked; a
            # windowed one also once its newest key falls behind the window.
            needed = src <= idx
            if window is not None:
                needed = needed and k_start + s_local - 1 > q_start - window
        if needed:
            COUNTS["blocks"] += 1
            parts = [_local_block_attention(qg[:, :, :, r:r + ROWS], k_cur, v_cur, scale,
                                            q_start + r, k_start, s, window, causal=causal)
                     for r in range(0, s_local, ROWS)]
            m_c, l_c, acc_c = (torch.cat(x, dim=3) for x in zip(*parts))
            m_next = torch.maximum(m, m_c)
            alpha = torch.exp(m - m_next)
            beta = torch.exp(m_c - m_next)
            l = alpha * l + beta * l_c
            acc = acc * alpha + acc_c * beta
            m = m_next
        if i < n - 1:
            k_cur, v_cur = mesh.shift([k_cur, v_cur], axis_name)
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(b, hq, s_local, hd).to(q.dtype)
