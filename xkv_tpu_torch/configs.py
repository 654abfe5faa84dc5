"""Merge-plan configuration for xKV-style cross-layer KV compression.

A copy of ``xkv_tpu/configs.py`` kept inside the port, which imports
nothing of the JAX package.

The YAML schema is kept compatible with the reference implementation
(`xKV/configurations.py:162-231` in the reference repo): a top-level
``xKV_config`` key holding global defaults plus a ``layer_groups`` list.
Configs written by the reference load here unchanged and vice versa.

Semantics mirrored from the reference (`xKV/configurations.py:91-160`):
  * ``layer_merge_impl`` is ``"svd"`` or ``"slerp"``.
  * Each group is *finalized* at construction: missing per-group params are
    filled from the global defaults and the irrelevant scheme's params are
    nulled out.
  * A layer may belong to at most one group; group layer indices must be
    < ``num_layers`` when ``num_layers`` is declared.

On top of the reference schema this adds engine-specific knobs in
``extra_kwargs`` (e.g. ``svd_method``: "exact" | "randomized").
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import yaml


@dataclass
class LayerGroup:
    """A group of decoder layers whose K/V are merged together.

    After ``XKVConfig`` finalization, only the fields relevant to the chosen
    ``layer_merge_impl`` are populated; the others are ``None``
    (reference: ``xKV/configurations.py:27-50``).
    """

    layers: List[int] = field(default_factory=list)

    # SVD scheme
    rank_k: Optional[int] = None
    rank_v: Optional[int] = None

    # SLERP scheme (MiniCache)
    slerp_t: Optional[float] = None
    slerp_gamma: Optional[float] = None

    def __post_init__(self):
        if not self.layers:
            raise ValueError("LayerGroup must have at least one layer index.")
        if sorted(self.layers) != self.layers:
            raise ValueError(f"LayerGroup layers must be ascending, got {self.layers}")

    @property
    def size(self) -> int:
        return len(self.layers)

    @property
    def last_layer(self) -> int:
        return self.layers[-1]


@dataclass
class XKVConfig:
    """Declarative merge plan (reference: ``xKV/configurations.py:53-250``).

    ``svd``: global defaults ``rank_k``/``rank_v``, per-group overridable.
    ``slerp``: global defaults ``slerp_t``/``slerp_gamma``, per-group
    overridable; groups must have exactly 2 layers.
    """

    num_layers: Optional[int] = None
    layer_merge_impl: str = "svd"

    # Global SVD defaults
    rank_k: Optional[int] = None
    rank_v: Optional[int] = None

    # Global SLERP defaults
    slerp_t: float = 0.5
    slerp_gamma: float = 1.0

    merge_key: bool = True
    merge_value: bool = True

    layer_groups: List[LayerGroup] = field(default_factory=list)

    # Catch-all for forward-compat / engine-specific knobs
    extra_kwargs: dict = field(default_factory=dict)

    _layer_map: Dict[int, LayerGroup] = field(init=False, default_factory=dict, repr=False)

    def __post_init__(self):
        if self.layer_merge_impl not in ("svd", "slerp"):
            raise ValueError(
                f"Invalid layer_merge_impl {self.layer_merge_impl!r}; must be 'svd' or 'slerp'."
            )

        if self.layer_merge_impl == "svd":
            for grp in self.layer_groups:
                grp.rank_k = grp.rank_k if grp.rank_k is not None else self.rank_k
                grp.rank_v = grp.rank_v if grp.rank_v is not None else self.rank_v
                grp.slerp_t = None
                grp.slerp_gamma = None
                if self.merge_key and grp.rank_k is None:
                    raise ValueError(f"Group {grp.layers}: rank_k unset and merge_key=True")
                if self.merge_value and grp.rank_v is None:
                    raise ValueError(f"Group {grp.layers}: rank_v unset and merge_value=True")
        else:
            for grp in self.layer_groups:
                grp.slerp_t = grp.slerp_t if grp.slerp_t is not None else self.slerp_t
                grp.slerp_gamma = (
                    grp.slerp_gamma if grp.slerp_gamma is not None else self.slerp_gamma
                )
                grp.rank_k = None
                grp.rank_v = None
                if grp.size != 2:
                    raise ValueError(
                        f"SLERP groups must have exactly 2 layers, got {grp.layers}"
                    )

        self._layer_map = self._build_layer_to_group_map()

        if self.num_layers is not None:
            for grp in self.layer_groups:
                for lyr in grp.layers:
                    if lyr >= self.num_layers:
                        raise ValueError(
                            f"Group layer index {lyr} exceeds num_layers={self.num_layers}"
                        )

    def _build_layer_to_group_map(self) -> Dict[int, LayerGroup]:
        layer_map: Dict[int, LayerGroup] = {}
        for grp in self.layer_groups:
            for lyr in grp.layers:
                if lyr in layer_map:
                    raise ValueError(f"Layer {lyr} appears in multiple groups")
                layer_map[lyr] = grp
        return layer_map

    def get_group_for_layer(self, layer_idx: int) -> Optional[LayerGroup]:
        return self._layer_map.get(layer_idx)

    def is_grouped(self, layer_idx: int) -> bool:
        return layer_idx in self._layer_map

    def is_group_last(self, layer_idx: int) -> bool:
        grp = self.get_group_for_layer(layer_idx)
        return grp is not None and grp.last_layer == layer_idx

    # ---------------------------------------------------------- YAML I/O
    @classmethod
    def from_yaml(cls, path: str) -> "XKVConfig":
        """Load the reference-compatible YAML schema (key ``xKV_config``)."""
        with open(path, "r") as f:
            raw = yaml.safe_load(f)
        return cls.from_dict(raw.get("xKV_config", {}))

    @classmethod
    def from_dict(cls, conf_data: dict) -> "XKVConfig":
        conf_data = dict(conf_data)
        group_data = conf_data.pop("layer_groups", [])
        groups = [LayerGroup(**gd) for gd in group_data]
        known = {f.name for f in dataclasses.fields(cls) if f.init}
        extra = conf_data.pop("extra_kwargs", {}) or {}
        for k in list(conf_data):
            if k not in known:
                extra[k] = conf_data.pop(k)
        return cls(layer_groups=groups, extra_kwargs=extra, **conf_data)

    def to_dict(self) -> dict:
        d = {
            "num_layers": self.num_layers,
            "layer_merge_impl": self.layer_merge_impl,
            "rank_k": self.rank_k,
            "rank_v": self.rank_v,
            "slerp_t": self.slerp_t,
            "slerp_gamma": self.slerp_gamma,
            "merge_key": self.merge_key,
            "merge_value": self.merge_value,
        }
        d.update(self.extra_kwargs)
        group_list = []
        for grp in self.layer_groups:
            gd: dict = {"layers": list(grp.layers)}
            for name in ("rank_k", "rank_v", "slerp_t", "slerp_gamma"):
                val = getattr(grp, name)
                if val is not None:
                    gd[name] = val
            group_list.append(gd)
        d["layer_groups"] = group_list
        return d

    def to_yaml(self, path: str):
        with open(path, "w") as f:
            yaml.safe_dump({"xKV_config": self.to_dict()}, f, sort_keys=False)

    # ---------------------------------------------------------- engine knobs
    @property
    def svd_method(self) -> str:
        """"exact" (torch.linalg.svd) or "randomized" (sketch + subspace iter)."""
        return self.extra_kwargs.get("svd_method", "randomized")

    @property
    def svd_oversample(self) -> int:
        return int(self.extra_kwargs.get("svd_oversample", 16))

    @property
    def svd_iters(self) -> int:
        return int(self.extra_kwargs.get("svd_iters", 2))

    @property
    def svd_seed(self) -> int:
        return int(self.extra_kwargs.get("svd_seed", 0))

    @property
    def rope_mode(self) -> str:
        """Domain of the factored keys: "pre" (default) or "post".

        "pre": reference semantics — the group SVD runs over PRE-RoPE keys
        and rotation is applied after reconstruction at read time
        (reference `xKV/attn_patch/llama.py:38-53`,
        `fake_layer_merge_dynamic_cache.py:142-152`).

        "post": rank-space decode scheme — keys are rotated at their
        prefill positions BEFORE the cross-layer SVD, so the factors store
        the post-RoPE keys directly and decode attention never
        reconstructs: scores = (q_rot . V^T) . US^T run entirely in rank
        space (ops/kernels/rankspace_attention.py). ~10x fewer decode FLOPs
        than the pre-RoPE kernel's per-step reconstruction; the accuracy
        trade (rotation raises the stacked matrix's effective rank) is
        measured by tests/test_rope_post.py's induction-retrieval gate.

        MLA latents are RoPE-free; the mode has no effect there.
        """
        mode = self.extra_kwargs.get("rope_mode", "pre")
        if mode not in ("pre", "post"):
            raise ValueError(f"rope_mode must be 'pre' or 'post', got {mode!r}")
        if mode == "post" and self.layer_merge_impl != "svd":
            raise ValueError("rope_mode='post' applies to the svd scheme only")
        return mode

    @property
    def int4_rank_frac(self) -> float:
        """Mixed int8+int4 factors (factor_dtype="int4"): fraction of each
        group's ranks kept at int8 (the top singular directions); the tail
        drops to packed int4 (compress/quant.py, SVDq-style)."""
        return float(self.extra_kwargs.get("int4_rank_frac", 0.25))

    @property
    def slerp_compact(self) -> bool:
        """Store slerp-merged layers compactly (shared direction + norms +
        exception rows) instead of dense — the memory saving the reference's
        fake MiniCache path never realizes."""
        return bool(self.extra_kwargs.get("slerp_compact", False))

    @property
    def slerp_keep_frac(self) -> float:
        """Fraction of rows whose exact per-layer values are kept (budget
        for the non-divergent rows MiniCache leaves unmerged)."""
        return float(self.extra_kwargs.get("slerp_keep_frac", 0.125))


def generate_consecutive_layer_groups(
    start_layer: int, end_layer: int, group_size: int
) -> List[LayerGroup]:
    """Chunk [start_layer..end_layer] (inclusive) into consecutive groups
    (reference: ``xKV/configurations.py:254-273``)."""
    groups = []
    current = start_layer
    while current <= end_layer:
        grp_end = min(current + group_size - 1, end_layer)
        groups.append(LayerGroup(layers=list(range(current, grp_end + 1))))
        current = grp_end + 1
    return groups


def generate_consecutive_xkv_config(
    layer_merge_impl: str = "svd",
    start_layer: int = 0,
    end_layer: int = 31,
    num_layers: Optional[int] = None,
    group_size: int = 2,
    rank_k: Optional[int] = 256,
    rank_v: Optional[int] = 768,
    slerp_t: float = 0.5,
    slerp_gamma: float = 1.0,
    merge_key: bool = True,
    merge_value: bool = True,
    extra_kwargs: Optional[dict] = None,
) -> XKVConfig:
    """Build an XKVConfig with consecutive groups
    (reference: ``xKV/configurations.py:276-323``)."""
    if end_layer == -1:
        if num_layers is None:
            raise ValueError("Must provide num_layers if end_layer is -1.")
        end_layer = num_layers - 1
    return XKVConfig(
        num_layers=num_layers,
        layer_merge_impl=layer_merge_impl,
        rank_k=rank_k,
        rank_v=rank_v,
        slerp_t=slerp_t,
        slerp_gamma=slerp_gamma,
        merge_key=merge_key,
        merge_value=merge_value,
        layer_groups=generate_consecutive_layer_groups(start_layer, end_layer, group_size),
        extra_kwargs=extra_kwargs or {},
    )
