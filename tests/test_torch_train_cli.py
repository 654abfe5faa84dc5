"""The port's ``train_compressor`` CLI against the JAX CLI on the CPU, on
``tiny:4x64`` (the weights differ: each package draws its own): the
printed K/V shape, the token batches each trainer is handed (the same
text, chunks and numpy draws), and the files: a checkpoint whose tree
(names, shapes, dtypes) equals flax's, the sidecar JSON's keys and the
CSV's columns."""

import json

import numpy as np
import pytest
import torch
from flax import serialization as flax_ser

from _torch_threads import one_thread  # noqa: F401
import xkv_tpu.train as jax_train
import xkv_tpu_torch.train as port_train
from xkv_tpu.cli import train_compressor as jax_cli
from xkv_tpu_torch.cli import train_compressor as port_cli
from xkv_tpu_torch.train import serialization


def run(cli, trainer_cls, monkeypatch, capsys, out_dir, kind):
    """Run one CLI; returns (its stdout lines, the batches handed to
    train_step)."""
    seen = []
    step = trainer_cls.train_step

    def recording(self, tokens):
        seen.append(np.asarray(tokens).copy())
        return step(self, tokens)

    monkeypatch.setattr(trainer_cls, "train_step", recording)
    argv = ["--model", "tiny:4x64", "--compressor", kind, "--steps", "3", "--eval-every", "2",
            "--batch", "2", "--seq-len", "64", "--output-dir", str(out_dir), "--seed", "3"]
    if cli is port_cli:
        argv += ["--device", "cpu"]
    cli.main(argv)
    return capsys.readouterr().out.splitlines(), seen


def tree_shapes(tree):
    return {k: {l: (tuple(np.shape(a)), str(np.asarray(a).dtype)) for l, a in v.items()}
            for k, v in tree.items()}


@pytest.mark.parametrize("kind", ["dual1d", "vae"])
def test_cli_matches_jax(kind, tmp_path, monkeypatch, capsys):
    jax_out, jax_batches = run(jax_cli, jax_train.CompressorTrainer, monkeypatch, capsys,
                               tmp_path / "jax", kind)
    out, batches = run(port_cli, port_train.CompressorTrainer, monkeypatch, capsys,
                       tmp_path / "port", kind)
    assert out[0] == jax_out[0] == "KV tensor shape per batch: (2, 4, 64, 64)"
    assert len(out) == len(jax_out) and out[-1].endswith(f"{kind}.msgpack")
    assert len(batches) == len(jax_batches) == 3
    for got, want in zip(batches, jax_batches):
        assert np.array_equal(got, want)
    ckpt = f"{kind}.msgpack"
    want = flax_ser.msgpack_restore((tmp_path / "jax" / ckpt).read_bytes())
    got = serialization.from_bytes((tmp_path / "port" / ckpt).read_bytes())
    assert tree_shapes({k: {l: a.numpy() for l, a in v.items()} for k, v in got.items()}) \
        == tree_shapes(want)
    meta = json.loads((tmp_path / "port" / (ckpt + ".json")).read_text())
    jmeta = json.loads((tmp_path / "jax" / (ckpt + ".json")).read_text())
    assert sorted(meta) == sorted(jmeta) and meta["step"] == jmeta["step"] == 3
    assert meta["compressor_kwargs"] == jmeta["compressor_kwargs"]
    header = (tmp_path / "port" / "metrics.csv").read_text().splitlines()[0]
    assert header == (tmp_path / "jax" / "metrics.csv").read_text().splitlines()[0]
