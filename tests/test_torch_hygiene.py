"""The port stands alone: importing every module of ``xkv_tpu_torch`` and
what ``chip_smoke.py`` imports loads neither ``jax`` nor the JAX package
``xkv_tpu``, nor any optional package that the evaluation path imports
where it needs it (``safetensors``, ``transformers``, ``datasets``,
``tiktoken``, ``sentencepiece``, ``rouge``, ``jieba``, ``scipy``), nor what
the JAX training path uses and the card's machine lacks (``msgpack``,
``sklearn``, ``flax``, ``optax``), nor ``matplotlib``, which the plots of
``evalharness/viz.py`` import where they draw. Checked in a fresh interpreter, since
this test process imports them."""

import os
import pkgutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, pkgutil, sys
import xkv_tpu_torch
names = [m.name for m in pkgutil.walk_packages(xkv_tpu_torch.__path__, "xkv_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # its top level, then what its phases import
for name in ("xkv_tpu_torch.configs", "xkv_tpu_torch.engine",
             "xkv_tpu_torch.models.ckpt", "xkv_tpu_torch.models.llama",
             "xkv_tpu_torch.models.deepseek"):
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "xkv_tpu" or m.startswith("xkv_tpu."))
optional = sorted(m for m in sys.modules if m.split(".")[0] in (
    "safetensors", "transformers", "datasets", "tiktoken", "sentencepiece", "rouge",
    "jieba", "scipy", "msgpack", "sklearn", "flax", "optax", "matplotlib"))
print(len(names), bad, optional, sep="|")
"""


@pytest.fixture(scope="module")
def probe():
    """(modules imported, JAX modules loaded, optional packages loaded)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    n_modules, bad, optional = res.stdout.strip().split("|")
    return int(n_modules), bad, optional


def test_port_imports_neither_jax_nor_the_jax_package(probe):
    n_modules, bad, _ = probe
    assert n_modules >= 15
    assert bad == "[]", bad


def test_port_imports_no_optional_package(probe):
    _, _, optional = probe
    assert optional == "[]", optional


def test_every_port_module_is_found():
    import xkv_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(xkv_tpu_torch.__path__, "xkv_tpu_torch.")}
    for want in ("xkv_tpu_torch.ops.kernels.flash_attention",
                 "xkv_tpu_torch.ops.kernels.rankspace_attention",
                 "xkv_tpu_torch.ops.kernels.lowrank_attention",
                 "xkv_tpu_torch.engine.engine", "xkv_tpu_torch.cache",
                 "xkv_tpu_torch.models.deepseek",
                 "xkv_tpu_torch.ops.kernels.kernel_variants",
                 "xkv_tpu_torch.ops.kernels.kernel_ablation",
                 "xkv_tpu_torch.ops.kernels.probe_int4",
                 "xkv_tpu_torch.scripts.timing", "xkv_tpu_torch.scripts.bench_kernel",
                 "xkv_tpu_torch.scripts.kernel_variants",
                 "xkv_tpu_torch.scripts.kernel_ablation",
                 "xkv_tpu_torch.scripts.probe_int4",
                 "xkv_tpu_torch.utils.tokenizer", "xkv_tpu_torch.utils.profiling",
                 "xkv_tpu_torch.evalharness.metrics", "xkv_tpu_torch.evalharness.dataset",
                 "xkv_tpu_torch.evalharness.evaluator", "xkv_tpu_torch.evalharness.perplexity",
                 "xkv_tpu_torch.evalharness.sparse_probe",
                 "xkv_tpu_torch.evalharness.longbench_templates",
                 "xkv_tpu_torch.evalharness.ruler.wordlists",
                 "xkv_tpu_torch.evalharness.ruler.tasks",
                 "xkv_tpu_torch.evalharness.ruler.generators",
                 "xkv_tpu_torch.evalharness.ruler.generate", "xkv_tpu_torch.models.loader",
                 "xkv_tpu_torch.cli.common", "xkv_tpu_torch.cli.eval_acc",
                 "xkv_tpu_torch.cli.eval_perplexity", "xkv_tpu_torch.train.compressors",
                 "xkv_tpu_torch.train.serialization", "xkv_tpu_torch.train.collector",
                 "xkv_tpu_torch.train.lm", "xkv_tpu_torch.train.trainer",
                 "xkv_tpu_torch.utils.data_utils", "xkv_tpu_torch.evalharness.cka",
                 "xkv_tpu_torch.cli.train_compressor", "xkv_tpu_torch.cli.group_layers",
                 "xkv_tpu_torch.examples.quickstart", "xkv_tpu_torch.examples.serving",
                 "xkv_tpu_torch.examples.accuracy_demo", "xkv_tpu_torch.parallel.distributed",
                 "xkv_tpu_torch.parallel.mesh", "xkv_tpu_torch.parallel.sharding",
                 "xkv_tpu_torch.evalharness.viz", "xkv_tpu_torch.utils.duo_attention"):
        assert want in names
