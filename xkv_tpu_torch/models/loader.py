"""Load HF-format weights (local safetensors) into the port's parameter tree.

The port's counterpart of ``xkv_tpu/models/loader.py``: the same HF name
maps for the Llama family (Llama, Mistral, Qwen2 with its attention bias)
and DeepSeek-V2 (MLA + MoE), the same routing by ``model_type``. No network
access: the model directory must be local.

Name mapping (HF -> ours):
  model.embed_tokens.weight                    embed
  model.layers.{i}.self_attn.{q,k,v,o}_proj    layers[i].attn.w{q,k,v,o} (transposed)
  model.layers.{i}.mlp.{gate,up,down}_proj     layers[i].mlp.w_{gate,up,down} (transposed)
  model.layers.{i}.input_layernorm             layers[i].input_norm
  model.layers.{i}.post_attention_layernorm    layers[i].post_norm
  model.norm.weight                            final_norm
  lm_head.weight                               lm_head (transposed; absent if tied)

The port reads and writes the safetensors format itself, so it needs no
``safetensors`` package: an 8-byte little-endian header length, a JSON
header (each tensor's dtype, shape and ``data_offsets`` into the data that
follows) and the raw little-endian bytes. A file is mapped with ``mmap``
and each tensor is moved to ``device`` as it is read, so loading a large
model never holds a second full copy of it in host memory. BF16 is taken
by its bits. Every ``*.safetensors`` file of the directory is read, in
sorted order; an index json is not needed. HF stores each projection
(out, in); the port keeps (in, out) (``models/ckpt.py``), so projections
are transposed (and made contiguous) on the way in and out.

``save_llama_params`` / ``save_deepseek_params`` write one shard and an HF
``config.json``, each tensor in its own dtype (the JAX package's writers
store fp32); tests and ``chip_smoke.py`` make local checkpoints with them.
"""

from __future__ import annotations

import contextlib
import glob
import json
import mmap
import os
import struct
from typing import Dict, Iterator, List, Tuple

import torch

from xkv_tpu_torch.models.config import ModelConfig

# safetensors dtype names and the torch dtypes they map to.
_DTYPES: Dict[str, torch.dtype] = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


class SafetensorsFile:
    """One ``.safetensors`` file, mapped copy-on-write (the mapping is
    never written; it lets ``torch.frombuffer`` take it without a copy)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        header.pop("__metadata__", None)
        self._base = 8 + n
        self._header = header

    def keys(self) -> List[str]:
        return list(self._header)

    def get_tensor(self, name: str, device="cpu") -> torch.Tensor:
        """The tensor in the file's dtype, copied to ``device``: the result
        never shares memory with the mapping."""
        info = self._header[name]
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{self.path}: {name} has unsupported dtype {info['dtype']}")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        itemsize = torch.empty((), dtype=dtype).element_size()
        count = (end - begin) // itemsize
        numel = 1
        for d in shape:
            numel *= d
        if count != numel or end - begin != count * itemsize:
            raise ValueError(f"{self.path}: {name} holds {end - begin} bytes for shape {shape}")
        if numel == 0:
            return torch.empty(shape, dtype=dtype, device=device)
        offset = self._base + begin
        if offset % itemsize:  # unaligned data: copy its bytes out first
            buf = bytearray(self._mm[offset:offset + end - begin])
            t = torch.frombuffer(buf, dtype=dtype, count=count)
        else:
            t = torch.frombuffer(self._mm, dtype=dtype, count=count, offset=offset)
        t = t.reshape(shape)
        device = torch.device(device)
        return t.clone() if device.type == "cpu" else t.to(device)

    def close(self):
        self._mm.close()


@contextlib.contextmanager
def _open_shards(model_dir: str) -> Iterator[Tuple[List[SafetensorsFile], Dict[str, int]]]:
    paths = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if not paths:
        raise FileNotFoundError(f"no .safetensors files in {model_dir}")
    handles: List[SafetensorsFile] = []
    try:
        for p in paths:
            handles.append(SafetensorsFile(p))
        index: Dict[str, int] = {}
        for i, h in enumerate(handles):
            for k in h.keys():
                index[k] = i
        yield handles, index
    finally:
        for h in handles:
            h.close()


def _readers(handles, index, dtype, device):
    """(dense, vec): readers of HF (out, in) projections, returned (in,
    out), and of tensors kept as stored, each cast to ``dtype`` on
    ``device``."""

    def vec(name: str) -> torch.Tensor:
        return handles[index[name]].get_tensor(name, device).to(dtype)

    def dense(name: str) -> torch.Tensor:
        # HF stores (out, in); our matmuls are x @ w with w (in, out).
        return vec(name).T.contiguous()

    return dense, vec


def load_llama_params(model_dir: str, dtype=torch.bfloat16, device="cuda"):
    """Load a local HF Llama/Mistral/Qwen2 checkpoint onto ``device``.

    Returns (params, ModelConfig).
    """
    cfg = ModelConfig.from_pretrained(model_dir)
    with _open_shards(model_dir) as (handles, index):
        dense, vec = _readers(handles, index, dtype, device)
        layers = []
        for i in range(cfg.num_layers):
            p = f"model.layers.{i}"
            attn = {
                "wq": dense(f"{p}.self_attn.q_proj.weight"),
                "wk": dense(f"{p}.self_attn.k_proj.weight"),
                "wv": dense(f"{p}.self_attn.v_proj.weight"),
                "wo": dense(f"{p}.self_attn.o_proj.weight"),
            }
            if cfg.attention_bias:
                attn["bq"] = vec(f"{p}.self_attn.q_proj.bias")
                attn["bk"] = vec(f"{p}.self_attn.k_proj.bias")
                attn["bv"] = vec(f"{p}.self_attn.v_proj.bias")
            layers.append(
                {
                    "attn": attn,
                    "mlp": {
                        "w_gate": dense(f"{p}.mlp.gate_proj.weight"),
                        "w_up": dense(f"{p}.mlp.up_proj.weight"),
                        "w_down": dense(f"{p}.mlp.down_proj.weight"),
                    },
                    "input_norm": vec(f"{p}.input_layernorm.weight"),
                    "post_norm": vec(f"{p}.post_attention_layernorm.weight"),
                }
            )
        params = {
            "embed": vec("model.embed_tokens.weight"),
            "layers": layers,
            "final_norm": vec("model.norm.weight"),
        }
        if not cfg.tie_word_embeddings:
            params["lm_head"] = dense("lm_head.weight")
    return params, cfg


def save_safetensors(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` as one safetensors file, each in its own dtype.
    Tensors are copied to the host one at a time; the data is laid out by
    decreasing element size, so every tensor is aligned to its type."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header, offset = {}, 0
    for name in order:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            t = tensors[name].detach().contiguous().cpu()
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy())


def _writer(tensors: Dict[str, torch.Tensor]):
    def put_dense(name, w):
        tensors[name] = w.T  # a view: made contiguous one tensor at a time

    def put_vec(name, w):
        tensors[name] = w

    return put_dense, put_vec


def save_llama_params(params, cfg: ModelConfig, model_dir: str):
    """Write params in HF layout (single shard, each tensor in its dtype) +
    config.json. Used by tests and ``chip_smoke.py`` to make local
    checkpoints."""
    os.makedirs(model_dir, exist_ok=True)
    tensors: Dict[str, torch.Tensor] = {}
    put_dense, put_vec = _writer(tensors)

    tensors["model.embed_tokens.weight"] = params["embed"]
    for i, layer in enumerate(params["layers"]):
        p = f"model.layers.{i}"
        put_dense(f"{p}.self_attn.q_proj.weight", layer["attn"]["wq"])
        put_dense(f"{p}.self_attn.k_proj.weight", layer["attn"]["wk"])
        put_dense(f"{p}.self_attn.v_proj.weight", layer["attn"]["wv"])
        put_dense(f"{p}.self_attn.o_proj.weight", layer["attn"]["wo"])
        if "bq" in layer["attn"]:
            put_vec(f"{p}.self_attn.q_proj.bias", layer["attn"]["bq"])
            put_vec(f"{p}.self_attn.k_proj.bias", layer["attn"]["bk"])
            put_vec(f"{p}.self_attn.v_proj.bias", layer["attn"]["bv"])
        put_dense(f"{p}.mlp.gate_proj.weight", layer["mlp"]["w_gate"])
        put_dense(f"{p}.mlp.up_proj.weight", layer["mlp"]["w_up"])
        put_dense(f"{p}.mlp.down_proj.weight", layer["mlp"]["w_down"])
        put_vec(f"{p}.input_layernorm.weight", layer["input_norm"])
        put_vec(f"{p}.post_attention_layernorm.weight", layer["post_norm"])
    put_vec("model.norm.weight", params["final_norm"])
    if "lm_head" in params:
        put_dense("lm_head.weight", params["lm_head"])

    save_safetensors(tensors, os.path.join(model_dir, "model.safetensors"))
    hf_config = {
        "model_type": cfg.model_type,
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_q_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim,
        "rms_norm_eps": cfg.rms_norm_eps,
        "rope_theta": cfg.rope_theta,
        "rope_scaling": cfg.rope_scaling,
        "max_position_embeddings": cfg.max_position_embeddings,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "sliding_window": cfg.sliding_window,
    }
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(hf_config, f, indent=2)


def load_deepseek_params(model_dir: str, dtype=torch.bfloat16, device="cuda"):
    """Load a local HF DeepSeek-V2(-Lite) checkpoint (MLA + MoE) onto
    ``device``. HF name mapping:
      self_attn.q_proj | q_a_proj/q_a_layernorm/q_b_proj  (q-LoRA optional)
      self_attn.kv_a_proj_with_mqa -> attn.kv_a_proj
      self_attn.kv_a_layernorm     -> attn.kv_a_norm
      self_attn.kv_b_proj          -> attn.kv_b_proj
      mlp.gate (router), mlp.experts.{e}.*, mlp.shared_experts.*
    """
    cfg = ModelConfig.from_pretrained(model_dir)
    if cfg.model_type != "deepseek_v2":
        raise ValueError(f"not a deepseek_v2 checkpoint: {cfg.model_type}")
    with _open_shards(model_dir) as (handles, index):
        dense, vec = _readers(handles, index, dtype, device)
        layers = []
        for i in range(cfg.num_layers):
            p = f"model.layers.{i}"
            a = f"{p}.self_attn"
            attn = {
                "kv_a_proj": dense(f"{a}.kv_a_proj_with_mqa.weight"),
                "kv_a_norm": vec(f"{a}.kv_a_layernorm.weight"),
                "kv_b_proj": dense(f"{a}.kv_b_proj.weight"),
                "o_proj": dense(f"{a}.o_proj.weight"),
            }
            if cfg.q_lora_rank:
                attn["q_a_proj"] = dense(f"{a}.q_a_proj.weight")
                attn["q_a_norm"] = vec(f"{a}.q_a_layernorm.weight")
                attn["q_b_proj"] = dense(f"{a}.q_b_proj.weight")
            else:
                attn["q_proj"] = dense(f"{a}.q_proj.weight")

            use_moe = (
                cfg.n_routed_experts is not None and i >= cfg.first_k_dense_replace
            )
            if use_moe:
                E = cfg.n_routed_experts
                mlp = {
                    "router": dense(f"{p}.mlp.gate.weight"),
                    "experts": {
                        w: torch.stack([dense(f"{p}.mlp.experts.{e}.{hf}_proj.weight")
                                        for e in range(E)])
                        for w, hf in (("w_gate", "gate"), ("w_up", "up"), ("w_down", "down"))
                    },
                }
                if cfg.n_shared_experts:
                    mlp["shared"] = {
                        "w_gate": dense(f"{p}.mlp.shared_experts.gate_proj.weight"),
                        "w_up": dense(f"{p}.mlp.shared_experts.up_proj.weight"),
                        "w_down": dense(f"{p}.mlp.shared_experts.down_proj.weight"),
                    }
            else:
                mlp = {
                    "w_gate": dense(f"{p}.mlp.gate_proj.weight"),
                    "w_up": dense(f"{p}.mlp.up_proj.weight"),
                    "w_down": dense(f"{p}.mlp.down_proj.weight"),
                }
            layers.append(
                {
                    "attn": attn,
                    "mlp": mlp,
                    "input_norm": vec(f"{p}.input_layernorm.weight"),
                    "post_norm": vec(f"{p}.post_attention_layernorm.weight"),
                }
            )
        params = {
            "embed": vec("model.embed_tokens.weight"),
            "layers": layers,
            "final_norm": vec("model.norm.weight"),
        }
        if not cfg.tie_word_embeddings:
            params["lm_head"] = dense("lm_head.weight")
    return params, cfg


def save_deepseek_params(params, cfg: ModelConfig, model_dir: str):
    """Write DeepSeek params in HF layout (single shard, each tensor in its
    dtype) + config.json — used by tests to make local checkpoints."""
    os.makedirs(model_dir, exist_ok=True)
    tensors: Dict[str, torch.Tensor] = {}
    put_dense, put_vec = _writer(tensors)

    tensors["model.embed_tokens.weight"] = params["embed"]
    for i, layer in enumerate(params["layers"]):
        p = f"model.layers.{i}"
        a = f"{p}.self_attn"
        attn = layer["attn"]
        put_dense(f"{a}.kv_a_proj_with_mqa.weight", attn["kv_a_proj"])
        put_vec(f"{a}.kv_a_layernorm.weight", attn["kv_a_norm"])
        put_dense(f"{a}.kv_b_proj.weight", attn["kv_b_proj"])
        put_dense(f"{a}.o_proj.weight", attn["o_proj"])
        if "q_b_proj" in attn:
            put_dense(f"{a}.q_a_proj.weight", attn["q_a_proj"])
            put_vec(f"{a}.q_a_layernorm.weight", attn["q_a_norm"])
            put_dense(f"{a}.q_b_proj.weight", attn["q_b_proj"])
        else:
            put_dense(f"{a}.q_proj.weight", attn["q_proj"])
        mlp = layer["mlp"]
        if "router" in mlp:
            put_dense(f"{p}.mlp.gate.weight", mlp["router"])
            for e in range(mlp["experts"]["w_gate"].shape[0]):
                put_dense(f"{p}.mlp.experts.{e}.gate_proj.weight",
                          mlp["experts"]["w_gate"][e])
                put_dense(f"{p}.mlp.experts.{e}.up_proj.weight",
                          mlp["experts"]["w_up"][e])
                put_dense(f"{p}.mlp.experts.{e}.down_proj.weight",
                          mlp["experts"]["w_down"][e])
            if "shared" in mlp:
                put_dense(f"{p}.mlp.shared_experts.gate_proj.weight",
                          mlp["shared"]["w_gate"])
                put_dense(f"{p}.mlp.shared_experts.up_proj.weight",
                          mlp["shared"]["w_up"])
                put_dense(f"{p}.mlp.shared_experts.down_proj.weight",
                          mlp["shared"]["w_down"])
        else:
            put_dense(f"{p}.mlp.gate_proj.weight", mlp["w_gate"])
            put_dense(f"{p}.mlp.up_proj.weight", mlp["w_up"])
            put_dense(f"{p}.mlp.down_proj.weight", mlp["w_down"])
        put_vec(f"{p}.input_layernorm.weight", layer["input_norm"])
        put_vec(f"{p}.post_attention_layernorm.weight", layer["post_norm"])
    put_vec("model.norm.weight", params["final_norm"])
    if "lm_head" in params:
        put_dense("lm_head.weight", params["lm_head"])

    save_safetensors(tensors, os.path.join(model_dir, "model.safetensors"))
    hf_config = {
        "model_type": "deepseek_v2",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_q_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "rms_norm_eps": cfg.rms_norm_eps,
        "rope_theta": cfg.rope_theta,
        "max_position_embeddings": cfg.max_position_embeddings,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "q_lora_rank": cfg.q_lora_rank,
        "kv_lora_rank": cfg.kv_lora_rank,
        "qk_rope_head_dim": cfg.qk_rope_head_dim,
        "qk_nope_head_dim": cfg.qk_nope_head_dim,
        "v_head_dim": cfg.v_head_dim,
        "n_routed_experts": cfg.n_routed_experts,
        "n_shared_experts": cfg.n_shared_experts,
        "num_experts_per_tok": cfg.num_experts_per_tok,
        "moe_intermediate_size": cfg.moe_intermediate_size,
        "first_k_dense_replace": cfg.first_k_dense_replace,
        "routed_scaling_factor": cfg.routed_scaling_factor,
        "norm_topk_prob": cfg.norm_topk_prob,
    }
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(hf_config, f, indent=2)


def load_params(model_dir: str, dtype=torch.bfloat16, device="cuda"):
    """Model-type-routed loader (the reference's single from_pretrained
    entry point): llama-family -> load_llama_params, deepseek_v2 ->
    load_deepseek_params."""
    cfg = ModelConfig.from_pretrained(model_dir)
    if cfg.model_type == "deepseek_v2":
        return load_deepseek_params(model_dir, dtype=dtype, device=device)
    return load_llama_params(model_dir, dtype=dtype, device=device)
