"""``InferenceEngine.score`` (teacher-forced log-probs, run through
``engine/graphs.py``'s ``DecodeGraph`` eagerly on the CPU) against the JAX
engine's ``score`` and the full-forward oracle, on the in-repo checkpoint
``results/production_model/`` (4 layers, head_dim 128, fp32; prompts from
numpy seeds, exact SVD; the models of ``tests/_torch_compiled_common.py``).
Torch runs on one thread (``tests/_torch_threads.py``).

Tolerances: fp32 log-probs within 1e-3 of JAX's, 3e-2 with int8 factors
(the tolerances of ``test_torch_engine.py::test_greedy_tokens_match_jax_
fp32``: the two frameworks sum in another order, and an int8 factor entry
near a rounding boundary quantises to the neighbouring integer); against
the full-forward oracle 2e-4 (``tests/test_engine.py``'s).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_compiled_common import ckpt, jax_llama, port_llama, tokens  # noqa: F401
from _torch_threads import one_thread  # noqa: F401


# ---------------------------------------------------------------- score
@pytest.mark.parametrize("mode,rope,factor", [("none", "pre", "fp32"),
                                              ("factored", "pre", "fp32"),
                                              ("factored", "post", "fp32"),
                                              ("factored", "post", "int8")])
def test_score_matches_jax(ckpt, mode, rope, factor):
    """Teacher-forced log-probs of 6 steps, b = 2, against JAX
    ``InferenceEngine.score``; then the cache's tail holds the 6 rows and a
    second call scores on from there."""
    j = jax_llama(ckpt, mode, rope, "int8" if factor == "int8" else jnp.float32)
    t = port_llama(ckpt, mode, rope, "int8" if factor == "int8" else torch.float32)
    prompt = tokens(40, ckpt[1].vocab_size, seed=11, b=2)
    cont = tokens(9, ckpt[1].vocab_size, seed=12, b=2)
    _, jc = j.prefill(prompt)
    _, tc = t.prefill(prompt)
    want, jc = j.score(jc, jnp.asarray(cont[:, :6]), jnp.asarray(40, jnp.int32))
    got, tc = t.score(tc, cont[:, :6], 40)
    tol = 3e-2 if factor == "int8" else 1e-3
    assert got.shape == (2, 6, ckpt[1].vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
    assert int(tc.tail_len) == tc.tail_count == 6 == int(jc.tail_len)
    want2, _ = j.score(jc, jnp.asarray(cont[:, 6:]), jnp.asarray(46, jnp.int32))
    got2, tc = t.score(tc, cont[:, 6:], torch.tensor(46))
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), rtol=tol, atol=tol)
    assert tc.tail_count == 9


def test_score_matches_full_forward_oracle(ckpt):
    """Scoring in mode none equals the log-softmax of one prefill over the
    whole sequence (``tests/test_engine.py``'s oracle, for the port)."""
    eng = port_llama(ckpt, "none", "pre")
    seq = tokens(24, ckpt[1].vocab_size, seed=13, b=2)
    _, cache = eng.prefill(seq[:, :16])
    got, _ = eng.score(cache, seq[:, 16:], 16)
    full, _ = eng.prefill(seq)
    want = torch.log_softmax(full[:, 16:], dim=-1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)
