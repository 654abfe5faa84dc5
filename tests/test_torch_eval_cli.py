"""The port's evaluation CLIs against the JAX package's, on the CPU.

A tiny Llama checkpoint (2 layers, JAX's init scaled by 5 so that greedy
choices are not near ties) written by the JAX package's
``save_checkpoint``, read by both as ``ckpt:`` (fp32 on the CPU):
``eval_acc`` over a ``jsonl:`` dataset of three generated RULER prompts in
mode none and factored pre with fp32 factors (the prediction jsonl equal
byte for byte, the results json equal but for its timestamp and the port's
``--device``); ``eval_perplexity`` truncated and with ``--stride``
(perplexity within 1e-5 relative); ``--probe_sparse_layers`` (the same JSON
line); the refusals, each before any weight is loaded.

``python tests/test_torch_eval_cli.py`` regenerates
``xkv_tpu_torch/testdata/eval_golden.npz`` from the JAX CLIs on the in-repo
checkpoint: ``eval_acc`` on two RULER tasks (``GOLDEN_ACC``) in mode none
and xKV-4 pre, with each sample's generated tokens and each step's gap
between its top two log-probs (teacher-forced through the same JAX engine),
and ``eval_perplexity`` on two synthetic texts (``GOLDEN_PPL``).
``chip_smoke.py`` holds the port's CLIs on the card against it.
"""

import contextlib
import io
import json
import os
import random
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_threads import one_thread  # noqa: F401
from xkv_tpu.cli import eval_acc as jax_acc
from xkv_tpu.cli import eval_perplexity as jax_ppl
from xkv_tpu.models.ckpt import save_checkpoint as jax_save_checkpoint
from xkv_tpu.models.config import tiny_llama_config as jax_tiny
from xkv_tpu.models.llama import init_params as jax_init
from xkv_tpu_torch.cli import common
from xkv_tpu_torch.cli import eval_acc as port_acc
from xkv_tpu_torch.cli import eval_perplexity as port_ppl
from xkv_tpu_torch.evalharness.ruler.generators import generate_task, write_jsonl
from xkv_tpu_torch.evalharness.ruler.wordlists import essay_words

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "xkv_tpu_torch", "testdata", "eval_golden.npz")
# Exact SVD: the randomized range finder draws its Gaussian from each
# package's own generator, so the two would factor with different draws.
XKV4_PRE = ["--xKV", "--layer_group_size", "4", "--rank_k", "512", "--rank_v", "768",
            "--svd_method", "exact"]
# The golden runs (paths relative to the repository's root), per mode.
GOLDEN_MODES = {"none": [], "xkv4_pre": XKV4_PRE}
GOLDEN_ACC = ["--model", "ckpt:results/production_model", "--datasets", "ruler/niah_single_2",
              "ruler/vt", "--datalen", "8192", "--num_samples", "2", "--pad_to", "2048",
              "--data_dir", "results/ruler_e2e_8k/data"]
GOLDEN_PPL = ["--model", "ckpt:results/production_model", "--synthetic", "2",
              "--max_length", "4096", "--prefill_frac", "0.5"]
XKV_FP32 = ["--xKV", "--layer_group_size", "2", "--rank_k", "16", "--rank_v", "16",
            "--factor_dtype", "fp32", "--svd_method", "exact"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(model argument, jsonl dataset argument) of a 2-layer checkpoint and
    three RULER vt prompts cut to their last 480 bytes."""
    root = tmp_path_factory.mktemp("evalcli")
    cfg = jax_tiny(vocab_size=259, num_layers=2)
    params = jax_init(cfg, jax.random.PRNGKey(0), dtype=jnp.float32, scale=0.1)
    jax_save_checkpoint(str(root / "model"), params, cfg)
    rows = generate_task("vt", max_seq_length=1024, num_samples=3)
    for r in rows:
        r["input"] = r["input"][-480:]
    write_jsonl(rows, str(root / "vt.jsonl"))
    return "ckpt:" + str(root / "model"), "jsonl:" + str(root / "vt.jsonl")


def _outputs(result_dir):
    """{relative path: text} of a CLI's result files; the directory is
    emptied after, so the next run writes the same paths afresh."""
    out = {}
    for dirpath, _, files in os.walk(result_dir):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path) as f:
                out[os.path.relpath(path, result_dir)] = f.read()
    shutil.rmtree(result_dir)
    return out


@pytest.mark.parametrize("mode", ["none", "factored_pre_fp32"])
def test_eval_acc_matches_jax(tiny, tmp_path, mode):
    model, data = tiny
    argv = ["--model", model, "--datasets", data, "--datalen", "8192", "--gen_len", "16",
            "--result_dir", str(tmp_path / "results")]
    if mode != "none":
        argv += XKV_FP32
    jax_acc.main(argv)
    want = _outputs(str(tmp_path / "results"))
    port_acc.main(argv + ["--device", "cpu"])
    got = _outputs(str(tmp_path / "results"))
    assert sorted(got) == sorted(want)
    preds = [k for k in want if k.endswith("_rank0.jsonl")]
    assert len(preds) == 1 and got[preds[0]] == want[preds[0]]
    assert len(want[preds[0]].splitlines()) == 3
    summary = next(k for k in want if k.endswith(".json"))
    (w,), (g,) = json.loads(want[summary]), json.loads(got[summary])
    assert g["args"].pop("device") == "cpu"
    assert g["args"] == w["args"] and g["results"] == w["results"]
    assert set(g) == set(w) == {"timestamp", "args", "results"}


@pytest.mark.parametrize("extra", [["--synthetic", "2"], ["--stride", "192"] + XKV_FP32],
                         ids=["none_truncated", "factored_fp32_stride"])
def test_eval_perplexity_matches_jax(tiny, tmp_path, extra):
    model, _ = tiny
    argv = ["--model", model, "--max_length", "256"] + extra
    if "--stride" in extra:
        # one 600-byte text: windows at 0, 192 and 384
        words = essay_words(random.Random(5), approx_words=200)
        text = " ".join(words)[:600]
        (tmp_path / "text.txt").write_text(text)
        argv += ["--text-file", str(tmp_path / "text.txt")]
    jax_ppl.main(argv + ["--output", str(tmp_path / "jax.json")])
    port_ppl.main(argv + ["--device", "cpu", "--output", str(tmp_path / "port.json")])
    with open(tmp_path / "jax.json") as f:
        (w,) = json.load(f)
    with open(tmp_path / "port.json") as f:
        (g,) = json.load(f)
    assert (g["total_tokens"], g["num_texts"]) == (w["total_tokens"], w["num_texts"])
    # truncated: half of each 256-token text scored; strided: three windows
    # of the 601 ids (BOS + 600 bytes), each scored past its half
    want_tokens = 128 + 128 + (217 - 217 // 2) if "--stride" in extra else 256
    assert w["total_tokens"] == want_tokens
    np.testing.assert_allclose(g["perplexity"], w["perplexity"], rtol=1e-5)
    assert g["args"].pop("device") == "cpu"
    assert g["args"].pop("output") != w["args"].pop("output")
    assert g["args"] == w["args"]


def test_probe_sparse_layers_matches_jax(tiny):
    model, data = tiny
    argv = ["--model", model, "--datasets", data, "--datalen", "8192", "--num_samples", "1",
            "--gen_len", "8", "--probe_sparse_layers", "--sparse_topk", "2",
            "--sparse_block", "64", "--xKV", "--layer_group_size", "2", "--rank_k", "32",
            "--rank_v", "32", "--svd_method", "exact"]
    lines = []
    for main, extra in ((jax_acc.main, []), (port_acc.main, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv + extra)
        lines.append(buf.getvalue().strip().splitlines()[-1])
    assert lines[1] == lines[0]
    assert json.loads(lines[0])["flag"].startswith("--sparse_layers")


REFUSED = [(["--mesh_model", "2"], "ROADMAP item 17"),
           (["--sequence_parallel"], "ROADMAP item 17"),
           (["--xKV", "--factor_dtype", "fp32", "--device", "cuda"], "bf16, int8 or int4")]


@pytest.mark.parametrize("flags,reason", REFUSED, ids=["mesh_model", "sequence_parallel",
                                                       "fp32_factors_on_the_card"])
def test_refusals_before_any_weight_loads(tiny, monkeypatch, capsys, flags, reason):
    model, data = tiny

    def no_load(*a, **k):
        raise AssertionError("weights loaded before the refusal")

    import xkv_tpu_torch.models.ckpt as ckpt

    monkeypatch.setattr(ckpt, "load_checkpoint", no_load)
    monkeypatch.setattr(port_acc, "load_model_and_tokenizer", no_load)
    monkeypatch.setattr(port_ppl, "load_model_and_tokenizer", no_load)
    for main, argv in ((port_acc.main, ["--datasets", data, "--datalen", "8192"]),
                       (port_ppl.main, ["--synthetic", "1"])):
        with pytest.raises(SystemExit) as exc:
            main(["--model", model] + argv + flags)
        assert exc.value.code == 2
        assert reason in capsys.readouterr().err
    args = common.add_common_args(__import__("argparse").ArgumentParser()).parse_args(
        ["--model", model] + flags)
    with pytest.raises(ValueError, match=reason):
        common.build_engine(args, {}, jax_tiny(), tail_max=8)


def test_golden_matches_its_recorded_runs():
    """The golden file holds the runs this module names, and its tokens
    are what the JAX CLI scored: each sample's prediction is the bytes of
    its tokens."""
    from xkv_tpu_torch.utils.tokenizer import ByteTokenizer

    gold = np.load(GOLDEN)
    assert list(gold["acc_argv"]) == GOLDEN_ACC and list(gold["ppl_argv"]) == GOLDEN_PPL
    tok = ByteTokenizer()
    for mode in GOLDEN_MODES:
        assert list(gold[f"mode_argv_{mode}"]) == GOLDEN_MODES[mode]
        for ds in ("niah_single_2", "vt"):
            preds = [json.loads(line)["prediction"]
                     for line in str(gold[f"predictions_{mode}_{ds}"]).splitlines()]
            assert len(preds) == 2
            for i, pred in enumerate(preds):
                toks, gaps = gold[f"tokens_{mode}_{ds}_{i}"], gold[f"gaps_{mode}_{ds}_{i}"]
                assert toks.shape == gaps.shape and (gaps >= 0).all()
                assert tok.decode(toks) == pred
        assert np.isfinite(gold[f"ppl_{mode}"])


def write_golden(modes) -> int:
    """Run the JAX CLIs on the in-repo checkpoint in each of ``modes`` (one
    file under build/ a mode, so modes can run in processes of their own),
    then write GOLDEN from every mode's file."""
    os.chdir(ROOT)
    for mode in modes:
        part = _golden_run(mode)
        np.savez(_part_path(mode), **part)
    out = {"acc_argv": np.array(GOLDEN_ACC), "ppl_argv": np.array(GOLDEN_PPL)}
    missing = [m for m in GOLDEN_MODES if not os.path.exists(_part_path(m))]
    if missing:
        print(f"modes still to run: {missing}")
        return 0
    for mode in GOLDEN_MODES:
        with np.load(_part_path(mode)) as part:
            out.update({k: part[k] for k in part.files})
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN}: {sorted(out)}")
    return 0


def _part_path(mode: str) -> str:
    return os.path.join(ROOT, "build", f"eval_golden_{mode}.npz")


def _golden_run(mode: str) -> dict:
    """One mode's golden: the generated tokens and gaps of each sample, the
    prediction files and scores, the perplexity."""
    from xkv_tpu.engine import InferenceEngine

    flags = GOLDEN_MODES[mode]
    out = {f"mode_argv_{mode}": np.array(flags)}
    generate = InferenceEngine.generate
    runs = []

    def recording(self, tokens, max_new_tokens, eos_token_id=None):
        res = generate(self, tokens, max_new_tokens, eos_token_id=eos_token_id)
        runs.append((self, np.asarray(tokens), np.asarray(res[0]).reshape(-1)))
        return res

    InferenceEngine.generate = recording
    try:
        result_dir = os.path.join(ROOT, "build", f"eval_golden_{mode}")
        shutil.rmtree(result_dir, ignore_errors=True)
        jax_acc.main(GOLDEN_ACC + flags + ["--result_dir", result_dir])
    finally:
        InferenceEngine.generate = generate
    files = _outputs(result_dir)
    assert len(runs) == 4, len(runs)
    for k, (eng, prompt, toks) in enumerate(runs):
        ds, i = ("niah_single_2", "vt")[k // 2], k % 2
        out[f"tokens_{mode}_{ds}_{i}"] = toks.astype(np.int32)
        out[f"gaps_{mode}_{ds}_{i}"] = _gaps(eng, prompt, toks)
    (summary,) = json.loads(files["ruler/production_model.json"])
    for ds in ("niah_single_2", "vt"):
        name = next(k for k in files if k.endswith(f"ruler_{ds}_rank0.jsonl"))
        out[f"predictions_{mode}_{ds}"] = np.array(files[name])
        out[f"score_{mode}_{ds}"] = np.float64(summary["results"][f"ruler/{ds}"]["score"])
    path = os.path.join(ROOT, "build", f"eval_golden_ppl_{mode}.json")
    if os.path.exists(path):
        os.remove(path)
    jax_ppl.main(GOLDEN_PPL + flags + ["--output", path])
    with open(path) as f:
        (ppl,) = json.load(f)
    out[f"ppl_{mode}"] = np.float64(ppl["perplexity"])
    out[f"ppl_tokens_{mode}"] = np.int64(ppl["total_tokens"])
    return out


def _gaps(eng, prompt, toks) -> np.ndarray:
    """Each generated token's step teacher-forced through ``eng``: the gap
    between the step's two largest log-probs, fp32. The argmax must be the
    generated token."""
    logits, cache = eng.prefill(prompt)
    rows = [np.asarray(jax.nn.log_softmax(logits[0, -1].astype(jnp.float32)))]
    if len(toks) > 1:
        logprobs, _ = eng.score(cache, toks[None, :-1], jnp.asarray(prompt.shape[1], jnp.int32))
        rows.extend(np.asarray(logprobs[0], np.float32))
    rows = np.stack(rows)
    assert (rows.argmax(-1) == toks).all(), "teacher-forced argmax differs from generate"
    top2 = np.sort(rows, axis=-1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]).astype(np.float32)


if __name__ == "__main__":
    # python tests/test_torch_eval_cli.py [mode ...]: run the given modes
    # (all by default), then write the golden once every mode has run
    jax.config.update("jax_platforms", "cpu")
    sys.exit(write_golden(sys.argv[1:] or list(GOLDEN_MODES)))
