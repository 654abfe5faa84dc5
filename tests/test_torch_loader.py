"""The port's safetensors loader and native checkpoint writer against the
JAX package's, on the CPU, bit for bit.

Both ways: the JAX package's ``save_*_params`` read by the port's
``load_params``, and the port's ``save_*_params`` read by the JAX
package's, for Llama, Qwen2 (attention bias, tied embeddings) and
DeepSeek-V2 dense and MoE with q-LoRA (the variants of
``tests/test_model_families.py``), in bf16 and fp32. The port's reader
against ``safetensors.safe_open`` on a two-shard directory; the port's
loader and writer in a process where ``import safetensors`` fails; the
port's ``save_checkpoint`` read by the JAX package's ``load_checkpoint``
and the other way round.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_deepseek_mla import CFG as MLA_CFG
from tests.test_deepseek_mla import MOE_CFG
from xkv_tpu.models import deepseek as jdeepseek
from xkv_tpu.models import llama as jllama
from xkv_tpu.models import loader as jloader
from xkv_tpu.models.ckpt import load_checkpoint as jax_load_checkpoint
from xkv_tpu.models.ckpt import save_checkpoint as jax_save_checkpoint
from xkv_tpu.models.config import ModelConfig as JaxModelConfig
from xkv_tpu.models.config import tiny_llama_config as jax_tiny
from xkv_tpu_torch.models import loader as tloader
from xkv_tpu_torch.models.ckpt import load_checkpoint, params_from_numpy, save_checkpoint
from xkv_tpu_torch.models.config import ModelConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODELS = {
    "llama": jax_tiny(num_layers=2),
    "qwen2_bias_tied": jax_tiny(num_layers=2, model_type="qwen2", attention_bias=True,
                                tie_word_embeddings=True),
    "deepseek_dense": JaxModelConfig(**{**MLA_CFG.__dict__, "num_layers": 2}),
    "deepseek_moe_qlora": JaxModelConfig(**{**MOE_CFG.__dict__, "num_layers": 2,
                                            "q_lora_rank": 24}),
}
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "fp32": (jnp.float32, torch.float32)}


def _jax_params(name, jdt):
    cfg = MODELS[name]
    family = jdeepseek if cfg.model_type == "deepseek_v2" else jllama
    params = family.init_params(cfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    if cfg.tie_word_embeddings:
        params.pop("lm_head", None)
    # every norm and bias off 1 / 0, so a swapped or dropped tensor shows
    params = jax.tree.map(
        lambda a: a + 0.01 * jax.random.normal(jax.random.PRNGKey(a.size), a.shape), params)
    return jax.tree.map(lambda a: a.astype(jdt), params), cfg


def _bits(x) -> np.ndarray:
    """An array's bits (bf16 as uint16) from a jax array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 \
            else t.numpy()
    a = np.asarray(x)
    is_bf16 = str(a.dtype) == "bfloat16" or a.dtype == np.dtype("V2")
    return a.view(np.uint16) if is_bf16 else a


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _assert_same_tree(port, jax_tree, want_dtype: str):
    p, j = _flat(port), _flat(jax_tree)
    assert sorted(p) == sorted(j)
    for k in p:
        pb, jb = _bits(p[k]), _bits(j[k])
        assert str(p[k].dtype).endswith(want_dtype), (k, p[k].dtype)
        assert pb.dtype == jb.dtype and pb.shape == jb.shape, k
        assert np.array_equal(pb, jb), k
        assert p[k].is_contiguous(), k


def _same_cfg(port_cfg: ModelConfig, jax_cfg: JaxModelConfig):
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)


def _save_jax(params, cfg, path):
    if cfg.model_type == "deepseek_v2":
        jloader.save_deepseek_params(params, cfg, path)
    else:
        jloader.save_llama_params(params, cfg, path)


def _save_port(params, cfg, path):
    if cfg.model_type == "deepseek_v2":
        tloader.save_deepseek_params(params, cfg, path)
    else:
        tloader.save_llama_params(params, cfg, path)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(MODELS))
def test_jax_writer_port_reader(name, dt, tmp_path):
    jdt, tdt = DTYPES[dt]
    params, cfg = _jax_params(name, jdt)
    _save_jax(params, cfg, str(tmp_path))
    want, want_cfg = jloader.load_params(str(tmp_path), dtype=jdt)
    got, got_cfg = tloader.load_params(str(tmp_path), dtype=tdt, device="cpu")
    _same_cfg(got_cfg, want_cfg)
    _assert_same_tree(got, want, "bfloat16" if dt == "bf16" else "float32")


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(MODELS))
def test_port_writer_jax_reader(name, dt, tmp_path):
    jdt, tdt = DTYPES[dt]
    params, cfg = _jax_params(name, jdt)
    port_params = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    _save_port(port_params, ModelConfig(**dataclasses.asdict(cfg)), str(tmp_path))
    # the file keeps the dtype: bf16 stays BF16
    with tloader._open_shards(str(tmp_path)) as (handles, index):
        emb = handles[0].get_tensor("model.embed_tokens.weight")
        assert emb.dtype == tdt
    got, got_cfg = jloader.load_params(str(tmp_path), dtype=jdt)
    _same_cfg(ModelConfig(**dataclasses.asdict(got_cfg)), cfg)
    _assert_same_tree(port_params, got, "bfloat16" if dt == "bf16" else "float32")
    # and the port reads its own file back unchanged
    again, _ = tloader.load_params(str(tmp_path), dtype=tdt, device="cpu")
    _assert_same_tree(again, got, "bfloat16" if dt == "bf16" else "float32")


def test_reader_matches_safe_open_on_two_shards(tmp_path):
    """A checkpoint split over two files (and an index json, which the
    reader ignores): every tensor, dtypes mixed, against
    ``safetensors.safe_open``; the whole model against the JAX loader."""
    from safetensors import safe_open
    from safetensors.torch import save_file

    params, cfg = _jax_params("llama", jnp.float32)
    jloader.save_llama_params(params, cfg, str(tmp_path))
    one = os.path.join(str(tmp_path), "model.safetensors")
    with safe_open(one, framework="pt") as f:
        tensors = {k: f.get_tensor(k) for k in f.keys()}
    os.remove(one)
    names = sorted(tensors)
    # mixed dtypes: bf16 and fp16 copies, int8 and int64 extras
    extra = {"extra.bf16": tensors[names[0]].to(torch.bfloat16),
             "extra.f16": tensors[names[1]].to(torch.float16),
             "extra.i8": torch.arange(-5, 7, dtype=torch.int8).reshape(3, 4),
             "extra.i64": torch.arange(5, dtype=torch.int64),
             "extra.bool": torch.tensor([True, False, True]),
             "extra.empty": torch.zeros(0, 4)}
    half = len(names) // 2
    shards = [dict({k: tensors[k] for k in names[:half]}, **extra),
              {k: tensors[k] for k in names[half:]}]
    for i, shard in enumerate(shards):
        save_file(shard, os.path.join(str(tmp_path), f"model-0000{i + 1}-of-00002.safetensors"))
    with open(os.path.join(str(tmp_path), "model.safetensors.index.json"), "w") as f:
        f.write("{}")
    with tloader._open_shards(str(tmp_path)) as (handles, index):
        assert sorted(index) == sorted(names + list(extra))
        for i, shard in enumerate(shards):
            path = os.path.join(str(tmp_path), f"model-0000{i + 1}-of-00002.safetensors")
            with safe_open(path, framework="pt") as ref:
                for k in ref.keys():
                    got, want = handles[index[k]].get_tensor(k), ref.get_tensor(k)
                    assert got.dtype == want.dtype and got.shape == want.shape, k
                    assert torch.equal(got, want), k
    want, _ = jloader.load_params(str(tmp_path), dtype=jnp.float32)
    got, _ = tloader.load_params(str(tmp_path), dtype=torch.float32, device="cpu")
    _assert_same_tree(got, want, "float32")


NO_SAFETENSORS = textwrap.dedent("""
    import sys
    sys.modules["safetensors"] = None
    import torch
    from xkv_tpu_torch.models.config import tiny_llama_config
    from xkv_tpu_torch.models.llama import init_params
    from xkv_tpu_torch.models.loader import load_params, save_llama_params
    cfg = tiny_llama_config(num_layers=2)
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, torch.bfloat16, "cpu")
    save_llama_params(params, cfg, sys.argv[1])
    loaded, _ = load_params(sys.argv[1], dtype=torch.bfloat16, device="cpu")
    same = all(torch.equal(a, b) for a, b in zip(
        [loaded["embed"], loaded["lm_head"], loaded["layers"][1]["attn"]["wq"]],
        [params["embed"], params["lm_head"], params["layers"][1]["attn"]["wq"]]))
    try:
        import safetensors  # noqa: F401
        print("safetensors importable")
    except ImportError:
        print("equal" if same else "differ")
""")


def test_loader_works_without_safetensors(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", NO_SAFETENSORS, str(tmp_path)], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "equal"


def test_missing_directory_and_wrong_family_refused(tmp_path):
    with pytest.raises(FileNotFoundError):
        tloader.load_llama_params(str(tmp_path), device="cpu")
    params, cfg = _jax_params("llama", jnp.float32)
    jloader.save_llama_params(params, cfg, str(tmp_path))
    with pytest.raises(ValueError, match="not a deepseek_v2 checkpoint"):
        tloader.load_deepseek_params(str(tmp_path), device="cpu")


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_checkpoint_both_ways(dt, tmp_path):
    jdt, tdt = DTYPES[dt]
    params, cfg = _jax_params("llama", jdt)
    port_params = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    save_checkpoint(str(tmp_path / "port"), port_params, ModelConfig(**dataclasses.asdict(cfg)))
    # JAX reads the port's file: bf16 arrives as raw 2-byte void (|V2), as
    # it does from the JAX package's own bf16 checkpoints
    got, got_cfg = jax_load_checkpoint(str(tmp_path / "port"))
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(cfg)
    _assert_same_tree(port_params, got, "bfloat16" if dt == "bf16" else "float32")
    if dt == "fp32":
        got32, _ = jax_load_checkpoint(str(tmp_path / "port"), dtype=jnp.float32)
        _assert_same_tree(port_params, got32, "float32")
    # the port reads the JAX package's file, bf16 by its bits
    jax_save_checkpoint(str(tmp_path / "jax"), params, cfg)
    back, back_cfg = load_checkpoint(str(tmp_path / "jax"), device="cpu")
    _same_cfg(back_cfg, cfg)
    _assert_same_tree(back, params, "bfloat16" if dt == "bf16" else "float32")
