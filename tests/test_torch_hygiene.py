"""The port stands alone: importing every module of ``xkv_tpu_torch`` and
what ``chip_smoke.py`` imports loads neither ``jax`` nor the JAX package
``xkv_tpu``. Checked in a fresh interpreter, since this test process
imports both."""

import os
import pkgutil
import subprocess
import sys

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
print(len(names), bad)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    n_modules, bad = res.stdout.split(" ", 1)
    assert int(n_modules) >= 15
    assert bad.strip() == "[]", bad


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
                 "xkv_tpu_torch.scripts.probe_int4"):
        assert want in names
