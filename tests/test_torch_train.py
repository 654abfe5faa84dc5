"""The port's training path against the JAX package on the CPU: the
compressor zoo against flax ``apply`` (parameters carried by
``params_from_flax``), the schedule against optax, ``collect_kv``,
``CompressorTrainer`` and ``train_lm`` after a few optimizer steps, the
checkpoint bytes both ways, the CSV columns and the calibration samplers.

Tolerances (fp32): a forward 1e-5 of the output's scale; losses and
parameters after 3-5 AdamW steps 1e-4 (the two sides sum in other orders,
and Adam divides by the root of small second moments); the schedule 1e-6
of the peak (optax computes it in fp32).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization as flax_ser

from _torch_threads import one_thread  # noqa: F401
from xkv_tpu.models.config import tiny_llama_config as jax_tiny
from xkv_tpu.models.llama import init_params as jax_init
from xkv_tpu.train import CompressorTrainer as JaxTrainer
from xkv_tpu.train import TrainConfig as JaxTrainConfig
from xkv_tpu.train import compressors as jax_comp
from xkv_tpu.train.collector import collect_kv as jax_collect
from xkv_tpu.train.lm import train_lm as jax_train_lm
from xkv_tpu.utils.data_utils import get_calib_data as jax_calib
from xkv_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer
from xkv_tpu_torch.models.ckpt import params_from_numpy
from xkv_tpu_torch.models.config import tiny_llama_config
from xkv_tpu_torch.ops.kernels import _build
from xkv_tpu_torch.train import CompressorTrainer, TrainConfig, compressors, serialization
from xkv_tpu_torch.train.collector import collect_kv
from xkv_tpu_torch.train.lm import lm_loss, train_lm, warmup_cosine_decay_schedule
from xkv_tpu_torch.utils.data_utils import get_calib_data
from xkv_tpu_torch.utils.tokenizer import ByteTokenizer

JAX_CFG, CFG = jax_tiny(), tiny_llama_config()
STEPS = 3
# (kind, compressor kwargs) of the trainer runs; the VAE's noise differs
# between the packages, so it is held at a given eps.
TRAINER_RUNS = {"dual1d": {}, "conv": {}, "enhanced": {"features": 16, "latent_features": 4},
                "vae": {}}


def to_np(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.fixture(scope="module")
def base():
    """(JAX params, the same as the port's fp32 CPU tree, token batches)."""
    jp = jax_init(JAX_CFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, CFG.vocab_size, size=(2, 32)).astype(np.int32)
               for _ in range(STEPS + 1)]
    return jp, params_from_numpy(to_np(jp), device="cpu"), batches


@pytest.fixture(scope="module")
def jax_runs(base):
    """Per kind: the JAX trainer's init parameters, its rows after STEPS
    steps, its trained parameters, and the trainer."""
    jp, _, batches = base
    out = {}
    for kind, kw in TRAINER_RUNS.items():
        tr = JaxTrainer(jp, JAX_CFG, JaxTrainConfig(compressor=kind, compressor_kwargs=kw,
                                                    learning_rate=3e-3, warmup_steps=1,
                                                    total_steps=10))
        tr.init(jnp.asarray(batches[0]))
        init = to_np(tr.params)
        rows = [tr.train_step(b) for b in batches[1:]]
        out[kind] = dict(init=init, rows=rows, params=to_np(tr.params), trainer=tr)
    return out


def port_trainer(kind, port_params, **cfg_kw):
    kw = dict(compressor=kind, compressor_kwargs=TRAINER_RUNS.get(kind, {}), learning_rate=3e-3,
              warmup_steps=1, total_steps=10)
    kw.update(cfg_kw)
    return CompressorTrainer(port_params, CFG, TrainConfig(**kw), device="cpu")


def assert_trees_close(got, want, tol):
    assert sorted(got) == sorted(want)
    for layer in want:
        assert sorted(got[layer]) == sorted(want[layer])
        for leaf in want[layer]:
            g = np.asarray(got[layer][leaf])
            np.testing.assert_allclose(g, want[layer][leaf], atol=tol, rtol=tol,
                                       err_msg=f"{layer}.{leaf}")


# ----------------------------------------------------------- the zoo
@pytest.mark.parametrize("kind,kw", [("conv", {}), ("dual1d", {}), ("identity", {}),
                                     ("enhanced", {"features": 16, "latent_features": 4}),
                                     ("dual1d", {"layer_stride": 4, "seq_stride": 4,
                                                 "activation": "silu"}),
                                     ("vae", {})])
def test_compressor_matches_flax(kind, kw):
    """Each compressor at tiny_llama_config's K/V shape (4 layers, 32 rows,
    2 * 2 heads * 16 features) and at a ragged one (3 layers, 31 rows),
    with flax's parameters: forward within 1e-5. The VAE in training with
    the same eps on both sides, and its KL term."""
    rng = np.random.default_rng(1)
    for shape in ((2, 4, 32, 64), (2, 3, 31, 64)):
        x = rng.standard_normal(shape).astype(np.float32)
        jc = jax_comp.make_compressor(kind, **kw)
        tc = compressors.make_compressor(kind, shape[-1], **kw)
        if kind == "vae":
            v = jc.init({"params": jax.random.PRNGKey(0), "reparam": jax.random.PRNGKey(1)},
                        jnp.asarray(x), train=True)
            key = jax.random.PRNGKey(7)
            recon, mu, logvar = jc.apply(v, jnp.asarray(x), train=True, rng_key=key)
            eps = torch.from_numpy(np.array(jax.random.normal(key, mu.shape)))
            compressors.params_from_flax(tc, to_np(v["params"]))
            got = tc(torch.from_numpy(x), train=True, eps=eps)
            for g, w in zip(got, (recon, mu, logvar)):
                np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(compressors.kl_divergence(got[1], got[2]).item(),
                                       float(jax_comp.kl_divergence(mu, logvar)), rtol=1e-5)
            continue
        v = jc.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
        want = np.asarray(jc.apply(v, jnp.asarray(x), train=False))
        compressors.params_from_flax(tc, to_np(v.get("params", {})))
        got = tc(torch.from_numpy(x)).detach().numpy()
        assert got.shape == x.shape
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_compressor_init_has_flax_distributions():
    """The port's own init: the same tree as flax's (names, shapes), zero
    biases, kernels of flax's lecun-normal spread (std 1 / sqrt(fan_in),
    within 10% over ~24k draws) cut at two standard deviations."""
    x = np.zeros((2, 4, 32, 64), np.float32)
    flax_tree = to_np(jax_comp.make_compressor("dual1d").init(jax.random.PRNGKey(0),
                                                                jnp.asarray(x))["params"])
    tc = compressors.make_compressor("dual1d", 64)
    gen = torch.Generator()
    gen.manual_seed(0)
    tc.reset_parameters(gen)
    tree = compressors.params_to_flax(tc)
    assert {k: {l: a.shape for l, a in v.items()} for k, v in tree.items()} == \
        {k: {l: a.shape for l, a in v.items()} for k, v in flax_tree.items()}
    for layer, leaves in tree.items():
        assert not leaves["bias"].any()
        k = leaves["kernel"].numpy()
        std = 1.0 / np.sqrt(np.prod(k.shape[:-1]))
        assert abs(k.std() / std - 1.0) < 0.1, layer
        assert np.abs(k).max() <= 2 * std / 0.87962566103423978 + 1e-7


# ----------------------------------------------------------- schedule
@pytest.mark.parametrize("peak,warmup,decay", [(1e-3, 10, 1000), (3e-3, 1, 5), (2e-3, 31, 300),
                                               (1e-3, 5, 50), (1e-3, 0, 20)])
def test_schedule_matches_optax(peak, warmup, decay):
    """warmup_cosine_decay_schedule(0, peak, warmup, decay) at every count
    from 0 past the end (train_lm's: warmup min(50, steps // 10 + 1))."""
    mine = warmup_cosine_decay_schedule(0.0, peak, warmup, decay)
    ref = optax.warmup_cosine_decay_schedule(0.0, peak, warmup, decay)
    counts = np.arange(decay + 5)
    got = np.array([mine(int(c)) for c in counts])
    want = np.array([float(ref(c)) for c in counts])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * peak)
    assert got[0] == 0.0 or warmup == 0


# ----------------------------------------------------------- collector
def test_collect_kv_matches_jax(base):
    jp, tp, batches = base
    want = np.asarray(jax_collect(jp, JAX_CFG, jnp.asarray(batches[0])))
    got = collect_kv(tp, CFG, torch.from_numpy(batches[0]).long())
    assert tuple(got.shape) == want.shape == (2, CFG.num_layers, 32,
                                              2 * CFG.num_kv_heads * CFG.head_dim)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


# ----------------------------------------------------------- trainer
@pytest.mark.parametrize("kind", ["dual1d", "conv", "enhanced"])
def test_trainer_matches_jax(kind, base, jax_runs):
    """From the JAX trainer's init parameters, STEPS steps: every row (loss,
    mse, mae, compression ratio) and the trained parameters within 1e-4."""
    _, tp, batches = base
    run = jax_runs[kind]
    tr = port_trainer(kind, tp)
    shape = tr.init(batches[0])
    assert shape == (2, CFG.num_layers, 32, 64)
    compressors.params_from_flax(tr.compressor, run["init"])
    rows = [tr.train_step(b) for b in batches[1:]]
    for got, want in zip(rows, run["rows"]):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert_trees_close(tr.params, run["params"], 1e-4)
    ev, jev = tr.eval_step(batches[0]), run["trainer"].eval_step(batches[0])
    assert sorted(ev) == sorted(jev)
    np.testing.assert_allclose(ev["loss"], jev["loss"], rtol=1e-4)


def test_vae_trainer_eval_matches_jax_at_given_eps(base, jax_runs):
    """The VAE's noise streams differ, so its trained parameters are carried
    over and the loss held at one eps on both sides: mse + kl_weight * kl
    within 1e-5; the port's own training steps are finite and their rows
    carry the JAX columns."""
    _, tp, batches = base
    run = jax_runs["vae"]
    jtr = run["trainer"]
    kv = jax_collect(jtr.base_params, JAX_CFG, jnp.asarray(batches[0])).astype(jnp.float32)
    key = jax.random.PRNGKey(3)
    recon, mu, logvar = jtr.compressor.apply({"params": jtr.params}, kv, train=True,
                                             rng_key=key)
    want = float(jnp.mean((recon - kv) ** 2) + jtr.cfg.kl_weight
                 * jax_comp.kl_divergence(mu, logvar))
    tr = port_trainer("vae", tp)
    tr.init(batches[0])
    compressors.params_from_flax(tr.compressor, run["params"])
    eps = torch.from_numpy(np.array(jax.random.normal(key, mu.shape)))
    got = tr.eval_step(batches[0], eps=eps)
    np.testing.assert_allclose(got["loss"], want, rtol=1e-5)
    assert sorted(got) == sorted(jtr.eval_step(batches[0]))
    rows = [tr.train_step(b) for b in batches[1:]]
    assert all(np.isfinite(r["loss"]) for r in rows)
    assert [sorted(r) for r in rows] == [sorted(r) for r in run["rows"]]


def test_trainer_checkpoint_both_ways(base, jax_runs, tmp_path):
    """The port's checkpoint read by flax (``from_bytes`` onto the JAX
    trainer's tree) bitwise, and its bytes equal to flax's for the same
    parameters; the JAX trainer's checkpoint read by the port bitwise; each
    holds the compressor only; a loaded trainer evaluates as the saved."""
    jp, tp, batches = base
    run = jax_runs["conv"]
    tr = port_trainer("conv", tp)
    tr.init(batches[0])
    tr.train_step(batches[1])
    path = str(tmp_path / "port" / "comp.msgpack")
    tr.save_checkpoint(path)
    with open(path, "rb") as f:
        blob = f.read()
    restored = flax_ser.from_bytes(run["trainer"].params, blob)
    assert_trees_close(to_np(restored), compressors.params_to_flax(tr.compressor), 0.0)
    assert blob == flax_ser.to_bytes(restored)
    base_bytes = sum(np.asarray(x).nbytes for x in jax.tree_util.tree_leaves(jp))
    assert os.path.getsize(path) < base_bytes / 2
    loaded = CompressorTrainer.load_checkpoint(path, tp, CFG, batches[0], device="cpu")
    assert loaded.step == 1
    assert_trees_close(loaded.params, compressors.params_to_flax(tr.compressor), 0.0)
    assert loaded.eval_step(batches[0]) == tr.eval_step(batches[0])

    jpath = str(tmp_path / "jax" / "comp.msgpack")
    run["trainer"].save_checkpoint(jpath)
    from_jax = CompressorTrainer.load_checkpoint(jpath, tp, CFG, batches[0], device="cpu")
    assert_trees_close(from_jax.params, run["params"], 0.0)
    assert from_jax.step == STEPS


def test_metrics_csv_columns(base, jax_runs, tmp_path):
    """write_metrics_csv: the JAX trainer's header and rows."""
    _, tp, batches = base
    for kind in ("dual1d", "vae"):
        tr = port_trainer(kind, tp)
        tr.init(batches[0])
        for b in batches[1:]:
            tr.train_step(b)
        tr.write_metrics_csv(str(tmp_path / f"{kind}.csv"))
        jax_runs[kind]["trainer"].write_metrics_csv(str(tmp_path / f"{kind}_jax.csv"))
        got = (tmp_path / f"{kind}.csv").read_text().splitlines()
        want = (tmp_path / f"{kind}_jax.csv").read_text().splitlines()
        assert got[0] == want[0] and len(got) == len(want) == STEPS + 1


def test_serialization_refuses_chunked_leaves(monkeypatch):
    """A leaf over flax's MAX_CHUNK_SIZE is refused both ways: flax would
    have written it in chunks."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    with pytest.raises(ValueError, match="MAX_CHUNK_SIZE"):
        serialization.to_bytes({"a": {"kernel": np.zeros(17, np.float32)}})
    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 64)
    blob = flax_ser.to_bytes({"a": {"kernel": np.zeros(40, np.float32)}})
    with pytest.raises(ValueError, match="chunks"):
        serialization.from_bytes(blob)


# ----------------------------------------------------------- train_lm
def induction_batch(rng, batch, m=6, vocab=256):
    x = rng.integers(2, vocab, size=(batch, m)).astype(np.int32)
    tokens = np.concatenate([np.ones((batch, 1), np.int32), x, x], axis=1)
    mask = np.zeros_like(tokens, np.float32)
    mask[:, m + 1:] = 1.0
    return tokens, mask


def test_train_lm_matches_jax(base):
    """5 steps of train_lm (AdamW, weight decay 1e-4, warmup 1): every
    step's loss and every trained parameter within 1e-4 of JAX's."""
    jp, tp, _ = base
    data = [induction_batch(np.random.default_rng(i), 4) for i in range(5)]
    jparams, jhist = jax_train_lm(jp, JAX_CFG, lambda i: data[i], steps=5, lr=3e-3,
                                  log_every=1)
    params, hist = train_lm(tp, CFG, lambda i: data[i], steps=5, lr=3e-3, log_every=1)
    np.testing.assert_allclose(hist, jhist, rtol=1e-4)
    want = params_from_numpy(to_np(jparams), device="cpu")
    got_leaves, want_leaves = [], []
    for tree, out in ((params, got_leaves), (want, want_leaves)):
        jax.tree_util.tree_map(lambda t: out.append(t), tree)
    for g, w in zip(got_leaves, want_leaves):
        assert not g.requires_grad
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4, rtol=1e-4)


def test_train_lm_trains_attention_weights(base):
    """Gradients reach wq, wk and wv through the plain prefill attention,
    and train_lm moves them far past what weight decay alone would."""
    _, tp, _ = base
    tokens, mask = induction_batch(np.random.default_rng(0), 4)
    attn = {k: v.clone().requires_grad_(True) for k, v in tp["layers"][0]["attn"].items()}
    trial = dict(tp, layers=[dict(tp["layers"][0], attn=attn)] + tp["layers"][1:])
    lm_loss(trial, CFG, torch.from_numpy(tokens), torch.from_numpy(mask)).backward()
    for name in ("wq", "wk", "wv"):
        assert attn[name].grad is not None and attn[name].grad.abs().max() > 0, name
    params, _ = train_lm(tp, CFG, lambda i: (tokens, mask), steps=5, lr=3e-3, log_every=1)
    for name in ("wq", "wk", "wv"):
        old = tp["layers"][0]["attn"][name]
        moved = (params["layers"][0]["attn"][name] - old).abs().max().item()
        decay_only = 5 * 3e-3 * 1e-4 * old.abs().max().item()
        assert moved > 100 * decay_only, name


def test_kernel_operands_that_require_grad_are_refused():
    """No kernel has a backward, so the wrappers' operand check refuses a
    tensor that autograd would differentiate (K1-K11 share it); under
    torch.no_grad, or detached, it passes."""
    t = torch.zeros(4, requires_grad=True)
    with pytest.raises(ValueError, match="requires grad"):
        _build.require_no_grad(t, "q")
    with torch.no_grad():
        _build.require_no_grad(t, "q")
    _build.require_no_grad(t.detach(), "q")


# ----------------------------------------------------------- calibration data
def test_calib_data_matches_jax(tmp_path):
    """get_calib_data: the same cache file name and token chunks as the JAX
    package's, synthetic and from a file, and read back from the cache."""
    text = tmp_path / "calib.txt"
    text.write_text("the quick brown fox jumps over the lazy dog. " * 40)
    for name, kw in (("synthetic", {}), ("file", {"text_file": str(text)})):
        want = jax_calib(name, JaxByteTokenizer(), nsamples=3, seqlen=64, seed=5,
                         cache_dir=str(tmp_path / "jax"), **kw)
        got = get_calib_data(name, ByteTokenizer(), nsamples=3, seqlen=64, seed=5,
                             cache_dir=str(tmp_path / "port"), **kw)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
        assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
        again = get_calib_data(name, None, nsamples=3, seqlen=64, seed=5,
                               cache_dir=str(tmp_path / "port"), **kw)
        assert np.array_equal(again, want)
    with pytest.raises(ValueError, match="unknown calib set"):
        get_calib_data("nope", ByteTokenizer(), cache_dir=str(tmp_path / "port"))


def test_calib_data_names_the_missing_package(tmp_path, monkeypatch):
    """wikitext2 / c4 import ``datasets`` where they need it; without it
    they raise ImportError naming it (the card's machine has none)."""
    monkeypatch.setitem(sys.modules, "datasets", None)
    for name in ("wikitext2", "c4"):
        with pytest.raises(ImportError, match="'datasets'"):
            get_calib_data(name, ByteTokenizer(), cache_dir=str(tmp_path))
