"""Native checkpoint format: ``params.npz`` plus ``config.json``.

Reads what ``xkv_tpu/models/ckpt.py:save_checkpoint`` writes: the parameter
tree flattened into '/'-joined paths (list items as ``#i``) in one ``.npz``,
and the ``ModelConfig`` as json.

The port keeps the JAX package's weight layout: every projection is stored
(in, out) and applied as ``x @ W``. No weight is transposed on the way in.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from xkv_tpu_torch.models.config import ModelConfig


def _unflatten(flat: Dict[str, np.ndarray]):
    root: dict = {}
    for path, arr in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            return [fix(node[f"#{i}"]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def params_from_numpy(
    np_params,
    dtype: Optional[torch.dtype] = None,
    device: str | torch.device = "cuda",
):
    """Turn a parameter tree of numpy arrays (the JAX package's layout:
    nested dicts and lists) into the port's tree of torch tensors.

    Floating arrays are cast to ``dtype`` when it is given; the (in, out)
    layout of every weight is kept as it is. This is the one function that
    carries weights from the JAX package to the port.
    """
    if isinstance(np_params, dict):
        return {k: params_from_numpy(v, dtype, device) for k, v in np_params.items()}
    if isinstance(np_params, (list, tuple)):
        return [params_from_numpy(v, dtype, device) for v in np_params]
    arr = np.asarray(np_params)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def load_checkpoint(
    path: str,
    dtype: Optional[torch.dtype] = None,
    device: str | torch.device = "cuda",
) -> Tuple[dict, ModelConfig]:
    """Load ``path/params.npz`` and ``path/config.json`` into torch tensors
    on ``device``."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = ModelConfig(**json.load(f))
    with np.load(os.path.join(path, "params.npz")) as z:
        flat = {k: z[k] for k in z.files}
    return params_from_numpy(_unflatten(flat), dtype, device), cfg
