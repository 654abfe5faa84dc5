"""The port's MiniCache SLERP ops (``xkv_tpu_torch/compress/slerp.py``)
against ``xkv_tpu/compress/slerp.py``, on the CPU.

Inputs are made from numpy seeds and handed to both. Tolerance 1e-5 (fp32:
the two frameworks round ``arccos``, ``sin`` and the norms' sums
differently). Kept rows (``keep_idx``) are compared where every angle is
exact (a full budget, exact ties); at a partial budget over merged rows,
whose angles are rounding noise (~1e-4), the packages may keep other rows
among those near-parallel ones, so the reconstructions are compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xkv_tpu.compress import slerp as jslerp
from xkv_tpu_torch.compress import slerp as tslerp

TOL = 1e-5


def pair(seed, shape, parallel_rows=()):
    """Two random tensors; rows ``parallel_rows`` (on the second-to-last
    axis) of both lie on one coordinate axis, the second's 1.5 times the
    first's: their angle is exactly 0 in both packages (a general pair of
    parallel rows gives an angle of rounding noise, ~3e-4, on either side
    of the parallel branch's 1e-7)."""
    rng = np.random.default_rng(seed)
    x1 = rng.standard_normal(shape).astype(np.float32)
    x2 = rng.standard_normal(shape).astype(np.float32)
    for r in parallel_rows:
        x1[..., r, :] = 0.0
        x1[..., r, r % shape[-1]] = 2.0 + r
        x2[..., r, :] = x1[..., r, :] * np.float32(1.5)
    return x1, x2


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("valid", [None, "prefix"])
def test_slerp_merge_rows(valid):
    """Merged rows, the divergence mask and the norms, the parallel branch
    included (rows 0 and 3 exactly parallel; row 5 zero in both)."""
    x1, x2 = pair(0, (12, 8), parallel_rows=(0, 3))
    x1[5] = x2[5] = 0.0
    v = None if valid is None else np.arange(12) < 9
    want = jslerp.slerp_merge_rows(jnp.asarray(x1), jnp.asarray(x2), t=0.4, gamma=0.3,
                                   valid=None if v is None else jnp.asarray(v))
    got = tslerp.slerp_merge_rows(torch.from_numpy(x1), torch.from_numpy(x2), t=0.4,
                                  gamma=0.3, valid=None if v is None else torch.from_numpy(v))
    for g, w in zip(got, want):
        close(g, w)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("valid_len", [None, 11, "per_batch"])
def test_minicache_merge_heads(valid_len):
    """(b, nh, s, hd) merge with the threshold global over (b, nh, s);
    ``valid_len`` as a scalar or (b,), rows past it zero (right padding)."""
    x1, x2 = pair(1, (2, 3, 16, 8), parallel_rows=(2,))
    vl = valid_len
    if valid_len == "per_batch":
        vl = np.array([16, 9], np.int32)
    if vl is not None:
        rows = np.arange(16)[None, :] < np.reshape(vl, (-1, 1))
        x1 = x1 * rows[:, None, :, None]
        x2 = x2 * rows[:, None, :, None]
    want = jslerp.minicache_merge_heads(jnp.asarray(x1), jnp.asarray(x2), t=0.5, gamma=0.05,
                                        valid_len=None if vl is None else jnp.asarray(vl))
    got = tslerp.minicache_merge_heads(torch.from_numpy(x1), torch.from_numpy(x2), t=0.5,
                                       gamma=0.05,
                                       valid_len=None if vl is None else torch.as_tensor(vl))
    for g, w in zip(got, want):
        close(g, w)


def test_gamma_one_returns_inputs():
    """gamma 1: the threshold is the largest angle, no row diverges, and
    both layers come back as they were."""
    x1, x2 = pair(2, (1, 2, 10, 8))
    t1, t2 = torch.from_numpy(x1), torch.from_numpy(x2)
    e1, e2 = tslerp.minicache_merge_heads(t1, t2, gamma=1.0)
    assert torch.equal(e1, t1) and torch.equal(e2, t2)
    j1, j2 = jslerp.minicache_merge_heads(jnp.asarray(x1), jnp.asarray(x2), gamma=1.0)
    close(e1, j1)
    close(e2, j2)


def compacts(x1, x2, keep):
    j = jslerp.compact_pair(jnp.asarray(x1), jnp.asarray(x2), keep)
    t = tslerp.compact_pair(torch.from_numpy(np.array(x1)), torch.from_numpy(np.array(x2)),
                            keep)
    return j, t


def test_compact_full_budget():
    """At keep == s every row is stored exactly; ``keep_idx`` equals JAX's,
    ties included (parallel rows, angle 0, and zero rows: the lower row
    first)."""
    x1, x2 = pair(3, (2, 3, 16, 8), parallel_rows=(1, 4, 7))
    x1[..., 10, :] = x2[..., 10, :] = 0.0
    j, t = compacts(x1, x2, 16)
    np.testing.assert_array_equal(t.keep_idx.numpy(), np.asarray(j.keep_idx))
    for name in ("base", "norms", "keep_rows"):
        close(getattr(t, name), getattr(j, name))
    for pos, x in enumerate((x1, x2)):
        close(tslerp.compact_reconstruct(t, pos), x)
        close(tslerp.compact_reconstruct(t, pos), jslerp.compact_reconstruct(j, pos))


def test_compact_partial_budget_on_merged_rows():
    """A MiniCache-merged pair at a budget of a quarter of its rows: the
    merged rows are parallel up to rounding, so the two packages may keep
    different ones among them; the reconstructions agree, and the rows
    the merge kept per layer (the largest angles) are exact."""
    x1, x2 = pair(4, (1, 2, 32, 8))
    m1, m2 = jslerp.minicache_merge_heads(jnp.asarray(x1), jnp.asarray(x2), gamma=0.3)
    m1, m2 = np.asarray(m1), np.asarray(m2)
    j, t = compacts(m1, m2, 8)
    for pos, m in enumerate((m1, m2)):
        got = tslerp.compact_reconstruct(t, pos, torch.float32)
        close(got, jslerp.compact_reconstruct(j, pos, jnp.float32))
        close(got, m)
    assert t.keep_idx.shape == (1, 2, 8) and t.keep_rows.shape == (1, 2, 8, 2, 8)


def test_compact_dtype_and_repeated_indices():
    """bf16 rows stay bf16 in ``base`` / ``keep_rows`` (``norms`` fp32); a
    budget padded by repeating entry 0 (batched admission) rebuilds the
    same rows."""
    x1, x2 = pair(5, (1, 2, 8, 4))
    t = tslerp.compact_pair(torch.from_numpy(x1).bfloat16(), torch.from_numpy(x2).bfloat16(), 3)
    assert (t.base.dtype, t.norms.dtype, t.keep_idx.dtype, t.keep_rows.dtype) == (
        torch.bfloat16, torch.float32, torch.int32, torch.bfloat16)
    padded = tslerp.SlerpCompact(
        base=t.base, norms=t.norms,
        keep_idx=torch.cat([t.keep_idx, t.keep_idx[:, :, :1].expand(-1, -1, 4)], dim=2),
        keep_rows=torch.cat([t.keep_rows, t.keep_rows[:, :, :1].expand(-1, -1, 4, -1, -1)],
                            dim=2))
    for pos in (0, 1):
        assert torch.equal(tslerp.compact_reconstruct(padded, pos),
                           tslerp.compact_reconstruct(t, pos))
