"""The port's ``examples/accuracy_demo.py`` against the JAX package's, on
the CPU at a cut size: 3 training steps and two ranks of the sweep (the
full example takes ~2 min on the CPU). The JAX side runs the example's own
``init_params``, ``train_lm``, ``make_batch``, ``accuracy`` and engine as
its ``main()`` does; its initial weights go to the port's ``main()``
through ``params_from_numpy``.

Tolerances: ``make_batch`` is equal bit for bit; each recall (640 greedy
tokens of a model 3 steps from its fp32 init, served in fp32) is equal, and
the compression ratios agree to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_examples import jax_example, to_port
from _torch_threads import one_thread  # noqa: F401
from xkv_tpu_torch.examples import accuracy_demo


def test_accuracy_demo_matches_jax():
    mod = jax_example("accuracy_demo")
    steps, ranks = 3, (mod.FULL_RANK, 8)
    assert accuracy_demo.FULL_RANK == mod.FULL_RANK and accuracy_demo.M == mod.M
    for seed in (0, 3):
        for a, b in zip(accuracy_demo.make_batch(np.random.default_rng(seed), 5),
                        mod.make_batch(np.random.default_rng(seed), 5)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)

    # The JAX example's main, at the cut size.
    rng = np.random.default_rng(0)
    init = mod.init_params(mod.CFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    params, _ = mod.train_lm(init, mod.CFG, lambda i: mod.make_batch(rng, 64), steps=steps,
                             lr=2e-3, log_every=100)
    kw = dict(tail_max=mod.M, donate_cache=False, cache_dtype=jnp.float32,
              factor_dtype=jnp.float32)
    want = {"baseline": mod.accuracy(mod.InferenceEngine(params, mod.CFG, mode="none", **kw))}
    for rank in ranks:
        xkv = mod.generate_consecutive_xkv_config(
            num_layers=mod.CFG.num_layers, end_layer=-1, group_size=2, rank_k=rank,
            rank_v=rank, extra_kwargs={"svd_method": "exact"})
        eng = mod.InferenceEngine(params, mod.CFG, xkv=xkv, mode="factored", **kw)
        _, cache = eng.prefill(np.ones((1, 2 * mod.M + 1), np.int32))
        want[rank] = (cache.compression_ratio(mod.CFG), mod.accuracy(eng))

    got = accuracy_demo.main("cpu", steps=steps, ranks=ranks, params=to_port(init),
                             verbose=False)
    assert got["baseline"] == want["baseline"]
    for rank, ratio, acc in got["ranks"]:
        assert ratio == pytest.approx(want[rank][0], rel=1e-6)
        assert acc == want[rank][1], rank


def test_accuracy_matches_jax_function_on_one_engine():
    """The port's ``accuracy`` and the JAX example's, on one port engine."""
    mod = jax_example("accuracy_demo")
    from xkv_tpu_torch.engine import InferenceEngine
    from xkv_tpu_torch.models.llama import init_params

    params = init_params(accuracy_demo.CFG, torch.Generator().manual_seed(1),
                         dtype=torch.float32, device="cpu")
    eng = InferenceEngine(params, accuracy_demo.CFG, mode="none", tail_max=accuracy_demo.M,
                          cache_dtype=torch.float32, device="cpu")
    for n, keep, seed in ((8, 4, 7), (4, 10, 2)):
        assert accuracy_demo.accuracy(eng, n, keep, seed) == mod.accuracy(eng, n, keep, seed)
