"""The port's trace readers (``utils/profiling.py`` ``trace``,
``device_op_times``), plots (``evalharness/viz.py``) and DuoAttention
patterns (``utils/duo_attention.py``) against the JAX package's.

Tolerances: the device-op totals of the same synthetic events, read from a
JAX-layout trace and from a torch Chrome trace, agree to 1e-9 ms (the same
sums of the same durations); what each figure draws (every image's array,
every line's points, the tick labels, the titles) is equal; the head
patterns, sparsities and masks are equal.
"""

import gzip
import json
import os

import numpy as np
import pytest
import torch
from matplotlib.figure import Figure

from xkv_tpu.evalharness import viz as jax_viz
from xkv_tpu.utils import duo_attention as jax_duo
from xkv_tpu.utils.profiling import device_op_times as jax_device_op_times
from xkv_tpu_torch.evalharness import viz
from xkv_tpu_torch.utils import duo_attention as duo
from xkv_tpu_torch.utils.profiling import device_op_times, op_totals, trace

# (name, duration us) of synthetic device events: repeated names, one
# zero-length event.
EVENTS = [("lowrank_tma_split_kernel<bf16>", 41.5), ("merge_chunk_kernel", 3.25),
          ("lowrank_tma_split_kernel<bf16>", 40.0), ("Memcpy DtoD", 1.125),
          ("flash_fwd_kernel", 812.0), ("merge_chunk_kernel", 0.0)]


def write_jax_trace(trace_dir):
    """The layout ``jax.profiler.trace`` writes: the device's ``X`` events
    under the process named ``/device:TPU:0``, beside a host process's."""
    run = trace_dir / "plugins" / "profile" / "2026_01_01_00_00_00"
    run.mkdir(parents=True)
    events = [{"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "/host:CPU"}},
              {"ph": "M", "name": "process_name", "pid": 7,
               "args": {"name": "/device:TPU:0"}},
              {"ph": "X", "name": "host_op", "pid": 1, "ts": 0, "dur": 99.0}]
    t = 10.0
    for name, dur in EVENTS:
        events.append({"ph": "X", "name": name, "pid": 7, "ts": t, "dur": dur})
        t += dur + 1
    with gzip.open(run / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)


def write_torch_trace(trace_dir, gz=False):
    """A torch Chrome trace: the device's events in categories ``kernel``
    and ``gpu_memcpy``, beside CPU ops and runtime calls."""
    trace_dir.mkdir(parents=True, exist_ok=True)
    events = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 11, "tid": 11,
               "ts": 0, "dur": 99.0},
              {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 11,
               "tid": 11, "ts": 1, "dur": 5.0}]
    t = 10.0
    for name, dur in EVENTS:
        cat = "gpu_memcpy" if name.startswith("Memcpy") else "kernel"
        events.append({"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": t,
                       "dur": dur})
        t += dur + 1
    path = trace_dir / ("w.1.pt.trace.json" + (".gz" if gz else ""))
    with (gzip.open(path, "wt") if gz else open(path, "w")) as f:
        json.dump({"traceEvents": events}, f)


@pytest.mark.parametrize("gz", [False, True], ids=["json", "json.gz"])
def test_device_op_times_equal_the_jax_reader(tmp_path, gz):
    write_jax_trace(tmp_path / "jax")
    write_torch_trace(tmp_path / "torch", gz=gz)
    want = jax_device_op_times(str(tmp_path / "jax"))
    got = device_op_times(str(tmp_path / "torch"))
    assert list(got) == list(want)  # the same names, largest first
    for name in want:
        assert got[name] == pytest.approx(want[name], abs=1e-9)
    assert list(got)[0] == "flash_fwd_kernel" and got["merge_chunk_kernel"] == 3.25e-3
    assert op_totals(EVENTS) == got


def test_device_op_times_raises_where_the_jax_reader_does(tmp_path):
    for reader in (jax_device_op_times, device_op_times):
        with pytest.raises(FileNotFoundError, match="no trace files"):
            reader(str(tmp_path))


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with trace(str(tmp_path / "t")) as prof:
        x = torch.randn(32, 32)
        (x @ x).sum()
    files = os.listdir(tmp_path / "t")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(tmp_path / "t" / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names
    assert device_op_times(str(tmp_path / "t")) == {}  # no device here
    assert prof.events()


# ------------------------------------------------------------------ viz
def drawn(fig):
    """What a figure draws, axis by axis."""
    out = []
    for ax in fig.axes:
        out.append(dict(
            title=ax.get_title(), xlabel=ax.get_xlabel(), ylabel=ax.get_ylabel(),
            xticks=[t.get_text() for t in ax.get_xticklabels()],
            yticks=[t.get_text() for t in ax.get_yticklabels()],
            images=[np.ma.filled(im.get_array().astype(float), np.nan) for im in ax.images],
            lines=[(line.get_label(), line.get_xydata()) for line in ax.lines]))
    return fig._suptitle.get_text() if fig._suptitle else None, out


@pytest.fixture
def figures(monkeypatch):
    saved = []
    original = Figure.savefig

    def savefig(self, path, *args, **kw):
        saved.append(drawn(self))
        return original(self, path, *args, **kw)

    monkeypatch.setattr(Figure, "savefig", savefig)
    return saved


def same_drawing(a, b):
    assert a[0] == b[0]
    assert len(a[1]) == len(b[1])
    for x, y in zip(a[1], b[1]):
        for key in ("title", "xlabel", "ylabel", "xticks", "yticks"):
            assert x[key] == y[key], key
        assert len(x["images"]) == len(y["images"]) and len(x["lines"]) == len(y["lines"])
        for p, q in zip(x["images"], y["images"]):
            np.testing.assert_array_equal(p, q)
        for (lp, dp), (lq, dq) in zip(x["lines"], y["lines"]):
            assert lp == lq
            np.testing.assert_array_equal(dp, dq)


def niah_records(n=60, seed=0):
    rng = np.random.default_rng(seed)
    return [{"score": float(rng.uniform()), "depth_pct": float(rng.uniform(0, 100)),
             "ctx_len": int(rng.integers(1000, 9000))} for _ in range(n)]


def test_needle_heatmap_draws_what_jax_draws(tmp_path, figures):
    recs = niah_records()
    for mod in (jax_viz, viz):
        out = str(tmp_path / f"{mod.__name__}.png")
        assert mod.plot_needle_viz(recs, out, title="niah", depth_buckets=5,
                                   length_buckets=4) == out
        assert os.path.getsize(out) > 0
    same_drawing(*figures)
    assert np.isfinite(figures[0][1][0]["images"][0]).any()
    # from a jsonl file, with prompt_len in place of ctx_len
    path = tmp_path / "r.jsonl"
    path.write_text("\n".join(json.dumps({"score": r["score"], "depth_pct": r["depth_pct"],
                                          "prompt_len": r["ctx_len"]}) for r in recs) + "\n\n")
    for mod in (jax_viz, viz):
        mod.plot_needle_viz_from_jsonl(str(path), str(tmp_path / "j.png"))
    same_drawing(*figures[2:])


def test_kv_stats_draw_what_jax_draws(tmp_path, figures):
    kv = np.random.default_rng(1).standard_normal((2, 3, 16, 8)).astype(np.float32)
    jax_viz.plot_kv_stats(kv, str(tmp_path / "a.png"), title="kv")
    viz.plot_kv_stats(torch.from_numpy(kv).to(torch.bfloat16), str(tmp_path / "b.png"),
                      title="kv")
    viz.plot_kv_stats(kv, str(tmp_path / "c.png"), title="kv")
    assert os.path.getsize(tmp_path / "b.png") > 0
    same_drawing(figures[0], figures[2])  # numpy in
    # a bf16 tensor is read as fp32 on the host: the JAX plot of the same values
    jax_viz.plot_kv_stats(torch.from_numpy(kv).to(torch.bfloat16).float().numpy(),
                          str(tmp_path / "d.png"), title="kv")
    same_drawing(figures[1], figures[3])


def test_singular_value_spectrum_draws_what_jax_draws(tmp_path, figures):
    rng = np.random.default_rng(2)
    kvs = [(rng.standard_normal((1, 2, 24, 8)).astype(np.float32), None) for _ in range(3)]
    jax_viz.plot_singular_value_spectrum(kvs, str(tmp_path / "a.png"), max_layers=2)
    viz.plot_singular_value_spectrum([(torch.from_numpy(k), v) for k, v in kvs],
                                     str(tmp_path / "b.png"), max_layers=2)
    assert os.path.getsize(tmp_path / "b.png") > 0
    same_drawing(*figures)
    assert len(figures[0][1][0]["lines"]) == 2


# --------------------------------------------------------- DuoAttention
@pytest.mark.parametrize("kw", [dict(threshold=0.5), dict(sparsity=0.3), dict(sparsity=0.0),
                                dict(sparsity=1.0), dict(threshold=0.5, seed=3)],
                         ids=["threshold", "sparsity", "none-sparse", "all-sparse", "seed"])
def test_sparsify_matches_jax(kw):
    scores = np.random.default_rng(0).uniform(size=(4, 8))
    heads, sparsity = duo.sparsify_attention_heads(torch.from_numpy(scores), **kw)
    want, want_sparsity = jax_duo.sparsify_attention_heads(scores, **kw)
    assert isinstance(heads, torch.Tensor) and heads.dtype == torch.float64
    np.testing.assert_array_equal(heads.numpy(), want)
    assert sparsity == want_sparsity


def test_sparsify_needs_a_threshold_or_a_sparsity():
    for fn in (jax_duo.sparsify_attention_heads, duo.sparsify_attention_heads):
        with pytest.raises(ValueError, match="threshold or sparsity"):
            fn(np.ones((2, 2)))


def test_load_attn_pattern_matches_jax(tmp_path):
    scores = np.random.default_rng(4).uniform(-0.5, 1.5, size=(3, 4))
    np.savetxt(tmp_path / "full_attention_heads.tsv", scores, delimiter="\t")
    (tmp_path / "config.json").write_text(json.dumps({"sink_size": 4, "recent_size": 16}))
    heads, sink, recent = duo.load_attn_pattern(str(tmp_path))
    want, want_sink, want_recent = jax_duo.load_attn_pattern(str(tmp_path))
    np.testing.assert_array_equal(heads.numpy(), want)
    assert (sink, recent) == (want_sink, want_recent) == (4, 16)
    assert heads.min() >= 0 and heads.max() <= 1


@pytest.mark.parametrize("shape", [(5, 12, 2, 3, 7), (1, 40, 4, 8, 39), (6, 6, 0, 2, 0)])
def test_streaming_head_mask_matches_jax(shape):
    q_len, kv_len, sink, recent, offset = shape
    got = duo.streaming_head_mask(q_len, kv_len, sink, recent, q_offset=offset)
    want = jax_duo.streaming_head_mask(q_len, kv_len, sink, recent, q_offset=offset)
    assert got.dtype == torch.bool and got.shape == (q_len, kv_len)
    np.testing.assert_array_equal(got.numpy(), want)
