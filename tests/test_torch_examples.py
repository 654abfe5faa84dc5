"""The port's examples (``xkv_tpu_torch/examples/``) against the JAX
package's (``examples/``), on the CPU at a cut size.

``examples/`` is not a package: each JAX example is imported by its file
path, and its ``main()`` runs with the engine class it calls swapped for a
subclass that records what it serves and cuts the sizes (64-token prompts,
8 new tokens; quickstart's model to 4 of its 8 layers, one xKV-4 group,
on both sides); its ``init_params`` is swapped for one that records the
weights, which ``params_from_numpy`` carries to the port's ``main()``.

Tolerances: quickstart's tokens and serving's are equal. Both sides run
quickstart in fp32 (weights, cache, factors; the int8 run's factors
int8): in the example's bf16 the frameworks round at other points, and its
random weights leave near ties that such roundings flip (the JAX run's own
factored and fake tokens part at the 8th token). Serving runs fp32, as the
example does. ``tests/test_torch_accuracy_demo.py`` holds the third
example.
"""

import dataclasses

import numpy as np
import torch

from _jax_examples import jax_example, to_port
from _torch_threads import one_thread  # noqa: F401
from xkv_tpu_torch.examples import quickstart, serving

PROMPT, NEW = 64, 8
LAYERS = 4  # quickstart's cut depth


def recording_init(mod, seen: dict, **force):
    """Swap ``mod.init_params`` for one that keeps the weights it made
    (with the keyword arguments ``force`` in place of the caller's)."""
    inner = mod.init_params

    def init_params(*args, **kw):
        seen["params"] = inner(*args, **{**kw, **force})
        return seen["params"]

    mod.init_params = init_params


def test_quickstart_matches_jax(capsys, monkeypatch):
    import jax.numpy as jnp

    mod = jax_example("quickstart")
    seen = {"runs": []}
    recording_init(mod, seen, dtype=jnp.float32)
    config = mod.tiny_llama_config
    mod.tiny_llama_config = lambda **kw: config(**{**kw, "num_layers": LAYERS})
    monkeypatch.setattr(quickstart, "CFG", dataclasses.replace(quickstart.CFG, num_layers=LAYERS))

    class Engine(mod.InferenceEngine):
        def __init__(self, *args, factor_dtype=jnp.float32, **kw):
            super().__init__(*args, cache_dtype=jnp.float32, factor_dtype=factor_dtype, **kw)

        def prefill(self, tokens):
            return super().prefill(tokens[:, :PROMPT])

        def generate(self, tokens, max_new_tokens):
            seen["prompt"] = np.asarray(tokens[:, :PROMPT])
            out = super().generate(tokens[:, :PROMPT], max_new_tokens=NEW)
            seen["runs"].append(np.asarray(out))
            return out

    mod.InferenceEngine = Engine
    mod.main()
    rows = quickstart.main("cpu", prompt_len=PROMPT, new_tokens=NEW,
                           params=to_port(seen["params"]), prompt=seen["prompt"],
                           dtype=torch.float32)
    assert [r["label"] for r in rows] == ["none", "factored", "fake", "rope=post int8"]
    for row, want in zip(rows, seen["runs"]):
        assert row["tokens"].shape == (1, NEW)
        np.testing.assert_array_equal(row["tokens"].numpy(), want, err_msg=row["label"])
    ratios = [r["ratio"] for r in rows]
    assert ratios[0] == ratios[2] == 1.0 and ratios[3] > ratios[1]
    assert "mode=rope=post int8" in capsys.readouterr().out


def test_serving_matches_jax():
    mod = jax_example("serving")
    seen = {"runs": [], "submitted": []}
    recording_init(mod, seen)

    class Engine(mod.BatchedEngine):
        def submit(self, tokens, max_new_tokens):
            seen["submitted"].append((np.asarray(tokens)[:PROMPT].tolist(),
                                      min(max_new_tokens, NEW)))
            return super().submit(np.asarray(tokens)[:PROMPT], min(max_new_tokens, NEW))

        def run(self):
            done = super().run()
            seen["runs"].append({r.request_id: r.generated for r in done})
            return done

    mod.BatchedEngine = Engine
    mod.main()
    got = serving.main("cpu", max_prompt=PROMPT, max_new=NEW, params=to_port(seen["params"]))
    reqs = serving.requests(serving.CFG.vocab_size, max_prompt=PROMPT, max_new=NEW)
    assert [(p.tolist(), n) for p, n in reqs] == seen["submitted"][:serving.N_REQUESTS]
    assert got["plain"] == seen["runs"][0]
    assert got["spec"] == seen["runs"][1] == got["plain"]
