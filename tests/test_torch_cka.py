"""The port's CKA grouping tool against the JAX package on the CPU:
``linear_cka_centered`` and ``cka_matrix`` on the same features (fp32:
1e-5), ``collect_kv_features`` on the same weights, the port's average
linkage against ``sklearn``'s ``AgglomerativeClustering`` (which the JAX
function calls) on seeded matrices, and the two ``group_layers`` CLIs on
one similarity matrix writing the same YAML."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from xkv_tpu.cli import group_layers as jax_cli
from xkv_tpu.evalharness import cka as jax_cka
from xkv_tpu.models.config import tiny_llama_config as jax_tiny
from xkv_tpu.models.llama import init_params as jax_init
from xkv_tpu_torch.cli import group_layers as port_cli
from xkv_tpu_torch.configs import XKVConfig
from xkv_tpu_torch.evalharness import cka
from xkv_tpu_torch.models.ckpt import params_from_numpy
from xkv_tpu_torch.models.config import tiny_llama_config


def features(seed, n_layers=6, rows=40, width=24):
    """Per-layer features that drift from layer to layer (neighbours alike)."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((rows, width)).astype(np.float32)
    out = []
    for _ in range(n_layers):
        base = base + 0.6 * rng.standard_normal((rows, width)).astype(np.float32)
        out.append(base.copy())
    return out


def test_linear_cka_and_matrix_match_jax():
    feats = features(0)
    for x, y in ((feats[0], feats[1]), (feats[2], feats[5][:, :10])):
        want = float(jax_cka.linear_cka_centered(jnp.asarray(x), jnp.asarray(y)))
        got = float(cka.linear_cka_centered(torch.from_numpy(x), torch.from_numpy(y)))
        np.testing.assert_allclose(got, want, rtol=1e-5)
    want = jax_cka.cka_matrix([jnp.asarray(f) for f in feats])
    got = cka.cka_matrix([torch.from_numpy(f) for f in feats])
    assert got.dtype == np.float64 and got.shape == (6, 6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.diag(got), 1.0, rtol=1e-5)


@pytest.mark.parametrize("which", ["k", "v"])
def test_collect_kv_features_match_jax(which):
    """The same fp32 weights: each layer's pre-RoPE K (or V), (seq,
    hkv * hd), within 1e-5."""
    jp = jax_init(jax_tiny(), jax.random.PRNGKey(1), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.array, jp), device="cpu")
    tokens = np.random.default_rng(2).integers(0, 256, size=(1, 48)).astype(np.int32)
    want = jax_cka.collect_kv_features(jp, jax_tiny(), jnp.asarray(tokens), which=which)
    got = cka.collect_kv_features(tp, tiny_llama_config(), torch.from_numpy(tokens).long(),
                                  which=which)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape == (48, 32)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


def similarity(seed, n):
    """A seeded symmetric similarity in [0, 1] with unit diagonal."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 1.0, size=(n, n))
    sim = (a + a.T) / 2
    np.fill_diagonal(sim, 1.0)
    return sim


@pytest.mark.parametrize("scale", [None, 2.0, 8.0])
def test_group_layers_match_sklearn(scale):
    """Seeded matrices of 4-32 layers cut into 1 to n groups, with and
    without index-distance weighting: the same groups as the JAX function
    (``sklearn`` average linkage), on random matrices and on a real CKA
    matrix."""
    cases = [(similarity(seed, n), g) for seed, n in enumerate((4, 8, 16, 32))
             for g in sorted({1, 2, 3, n // 2, n - 1, n})]
    real = cka.cka_matrix([torch.from_numpy(f) for f in features(3, n_layers=12)])
    cases += [(real, g) for g in (2, 4, 6)]
    for sim, g in cases:
        want = jax_cka.group_layers_from_cka(sim, g, index_distance_scale=scale)
        got = cka.group_layers_from_cka(sim, g, index_distance_scale=scale)
        assert got == want, (sim.shape[0], g)
        assert sorted(i for grp in got for i in grp) == list(range(sim.shape[0]))


def test_average_linkage_refuses_bad_counts():
    with pytest.raises(ValueError, match="clusters"):
        cka.average_linkage(np.zeros((3, 3)), 4)
    with pytest.raises(ValueError, match="clusters"):
        cka.average_linkage(np.zeros((3, 3)), 0)


def test_group_layers_cli_writes_the_jax_yaml(tmp_path, capsys):
    """``group_layers --similarity``: the port's YAML equals the JAX CLI's
    byte for byte, and loads into the port's ``XKVConfig``."""
    sim = similarity(11, 16)
    np.save(tmp_path / "sim.npy", sim)
    argv = ["--similarity", str(tmp_path / "sim.npy"), "--n_groups", "5", "--rank_k", "64",
            "--rank_v", "96", "--index_distance_scale", "4.0"]
    jax_cli.main(argv + ["--output", str(tmp_path / "jax.yaml")])
    want_out = capsys.readouterr().out
    port_cli.main(argv + ["--output", str(tmp_path / "port.yaml")])
    got_out = capsys.readouterr().out
    assert (tmp_path / "port.yaml").read_text() == (tmp_path / "jax.yaml").read_text()
    assert got_out.splitlines()[0] == want_out.splitlines()[0]
    cfg = XKVConfig.from_yaml(str(tmp_path / "port.yaml"))
    assert cfg.num_layers == 16 and sum(len(g.layers) for g in cfg.layer_groups) == 16


def test_group_layers_cli_from_a_model(tmp_path):
    """``group_layers --model tiny:4x64 --device cpu``: a config over the
    model's 4 layers in at most 2 groups per cluster, contiguous."""
    out = tmp_path / "grouped.yaml"
    port_cli.main(["--model", "tiny:4x64", "--n_groups", "2", "--rank_k", "16",
                   "--rank_v", "16", "--calib_len", "64", "--output", str(out),
                   "--device", "cpu"])
    cfg = XKVConfig.from_yaml(str(out))
    layers = [i for g in cfg.layer_groups for i in g.layers]
    assert layers == [0, 1, 2, 3] and cfg.num_layers == 4
    assert all(g.layers == list(range(g.layers[0], g.layers[-1] + 1)) for g in cfg.layer_groups)
