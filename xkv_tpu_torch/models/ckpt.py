"""Native checkpoint format: ``params.npz`` plus ``config.json``.

Reads and writes what ``xkv_tpu/models/ckpt.py`` does: the parameter tree
flattened into '/'-joined paths (list items as ``#i``) in one compressed
``.npz``, and the ``ModelConfig`` as json. A bf16 tensor is stored as numpy
stores the JAX package's bfloat16 arrays, raw 2-byte void (``|V2``), and
read back by its bits.

The port keeps the JAX package's weight layout: every projection is stored
(in, out) and applied as ``x @ W``. No weight is transposed on the way in.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from xkv_tpu_torch.models.config import ModelConfig


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}/"))
    else:
        t = torch.as_tensor(tree).detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            out[prefix[:-1]] = t.view(torch.int16).numpy().view(np.dtype("V2"))
        else:
            out[prefix[:-1]] = t.numpy()
    return out


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
    arr = np.ascontiguousarray(np_params)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:  # bfloat16 by its bits
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def save_checkpoint(path: str, params, cfg: ModelConfig) -> None:
    """Write ``params`` (torch tensors on any device) and ``cfg`` in the
    format ``load_checkpoint`` reads, each tensor in its own dtype."""
    os.makedirs(path, exist_ok=True)
    np.savez_compressed(os.path.join(path, "params.npz"), **_flatten(params))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)


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
