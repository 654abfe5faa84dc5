"""Loading the JAX package's examples (``examples/``, not a package) by
file path, and carrying their weights to the port, for the example tests."""

import importlib.util
import os

import jax
import numpy as np

from xkv_tpu_torch.models.ckpt import params_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def to_port(jax_params):
    """JAX weights as the port's tree on the CPU (``params_from_numpy``)."""
    return params_from_numpy(jax.tree.map(np.asarray, jax_params), device="cpu")
