"""The port's evaluation harness against the JAX package's, on the CPU.

Pure Python and numpy on both sides, so everything must be equal: every
metric on a table of prediction / ground-truth pairs (zh, rouge and
classification included); ``generate_task`` rows for every RULER task;
``essay_words``; ``Dataset`` over the ``ruler/``, ``jsonl:`` and
``long_bench_local/`` routes (prompt arrays, ground truths, classes,
generation length, metric); the port's LongBench fixtures byte for byte;
``Evaluator`` records, summary and table with an echo ``generate_fn``; the
summary gathered over two gloo processes against the JAX package's
single-process summary of the same shards; the tokenizer surface; and
``peak_memory_bytes`` on the CPU.
"""

import json
import os
import random
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from xkv_tpu.evalharness import metrics as jm
from xkv_tpu.evalharness.dataset import Dataset as JaxDataset
from xkv_tpu.evalharness.evaluator import Evaluator as JaxEvaluator
from xkv_tpu.evalharness.ruler import generators as jgen
from xkv_tpu.evalharness.ruler import wordlists as jwords
from xkv_tpu.evalharness.ruler.tasks import SYNTHETIC_TASKS
from xkv_tpu.utils import tokenizer as jtok
from xkv_tpu_torch.evalharness import metrics as tm
from xkv_tpu_torch.evalharness.dataset import Dataset as TorchDataset
from xkv_tpu_torch.evalharness.evaluator import Evaluator as TorchEvaluator
from xkv_tpu_torch.evalharness.ruler import generators as tgen
from xkv_tpu_torch.evalharness.ruler import wordlists as twords
from xkv_tpu_torch.utils import tokenizer as ttok
from xkv_tpu_torch.utils.profiling import PhaseTimer, peak_memory_bytes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FIXTURES = os.path.join(ROOT, "xkv_tpu", "evalharness", "long_bench_fixtures")
PORT_FIXTURES = os.path.join(ROOT, "xkv_tpu_torch", "evalharness", "long_bench_fixtures")

# (metric name, prediction, ground truth, keyword arguments)
CLASSES = ["LOC:city", "LOC:other", "HUM:desc", "DESC:def"]
METRIC_CASES = [
    ("needle_score", "The special magic number is 2867825.", "2867825", {}),
    ("needle_score", " 2867825 is it</s>", "2867825", {}),
    ("needle_score", "no idea", "2867825", {}),
    ("string_match_part", "Paris, France", ["paris", "lyon"], {}),
    ("string_match_part", "par", ["Paris"], {}),
    ("string_match_part", "Berlin", "Paris", {}),
    ("multi_number", "values 12, 7 and 99", ["12", "99", "5"], {}),
    ("multi_words", "QAHFT rxcka, FNAFQ.", ["QAHFT", "RXCKA", "FNAFQ", "OFPVA"], {}),
    ("qa_f1_score", "The quick brown fox", "a quick fox jumped", {}),
    ("qa_f1_score", "nothing", "something else", {}),
    ("qa_f1_zh_score", "北京是中国的首都。", "中国的首都是北京", {}),
    ("rouge_score", "the cat sat on the mat", "a cat was sitting on the mat", {}),
    ("rouge_score", "", "reference text", {}),
    ("rouge_zh_score", "会议讨论了预算问题", "会议主要讨论预算", {}),
    ("classification_score", "Type: LOC:city", "LOC:city", {"all_classes": CLASSES}),
    ("classification_score", "maybe LOC:other or HUM:desc", "HUM:desc", {"all_classes": CLASSES}),
    ("classification_score", "location city", "LOC:city", {"all_classes": CLASSES}),
    ("count_score", "There are 4 unique paragraphs, not 5.", "4", {}),
    ("count_score", "none", "4", {}),
    ("retrieval_score", "Paragraph 12 and maybe 3", "Paragraph 12", {}),
    ("retrieval_zh_score", "段落7", "段落7", {}),
    ("code_sim_score", "# comment\n    return x + 1\n", "    return x + 1", {}),
    ("code_sim_score", "```\nfoo(bar)", "foo(baz)", {}),
]


@pytest.mark.parametrize("name,pred,gt,kw", METRIC_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(METRIC_CASES)])
def test_metrics_equal(name, pred, gt, kw):
    assert getattr(tm, name)(pred, gt, **kw) == getattr(jm, name)(pred, gt, **kw)


def test_normalizers_equal():
    for s in ("The  Quick, brown fox!", "An apple a day", "  x\ty\n"):
        assert tm.normalize_answer(s) == jm.normalize_answer(s)
        assert tm.postprocess_pred(s + "<|eot_id|>\x01") == jm.postprocess_pred(s + "<|eot_id|>\x01")
    assert tm.normalize_zh_answer("北京，是 首都！") == jm.normalize_zh_answer("北京，是 首都！")
    assert tm.fuzz_ratio("abcd", "abce") == jm.fuzz_ratio("abcd", "abce")


@pytest.mark.parametrize("task", sorted(SYNTHETIC_TASKS))
def test_generate_task_rows_equal(task):
    length = 2048 if task in ("vt", "niah_single_1") else 1024
    kw = dict(max_seq_length=length, num_samples=2, random_seed=7)
    assert tgen.generate_task(task, **kw) == jgen.generate_task(task, **kw)


def test_generate_task_with_a_tokenizer_and_a_chat_template():
    kw = dict(tokenizer=jtok.ByteTokenizer(), max_seq_length=4096, num_samples=2,
              model_template_type="llama-3")
    want = jgen.generate_task("niah_multikey_2", **kw)
    kw["tokenizer"] = ttok.ByteTokenizer()
    assert tgen.generate_task("niah_multikey_2", **kw) == want


def test_essay_words_and_word_lists_equal():
    assert (twords.essay_words(random.Random(3), approx_words=2000)
            == jwords.essay_words(random.Random(3), approx_words=2000))
    assert twords.word_list() == jwords.word_list()
    assert twords.key_words() == jwords.key_words()


def test_fixtures_are_byte_copies():
    names = sorted(os.listdir(JAX_FIXTURES))
    assert sorted(os.listdir(PORT_FIXTURES)) == names
    for name in names:
        with open(os.path.join(JAX_FIXTURES, name), "rb") as a, \
                open(os.path.join(PORT_FIXTURES, name), "rb") as b:
            assert a.read() == b.read(), name


def _same_dataset(t, j):
    assert len(t) == len(j) and t.num_samples == j.num_samples
    for (tp, tg), (jp, jg) in zip((t[i] for i in range(len(t))), (j[i] for i in range(len(j)))):
        assert tp.dtype == np.int32 and tp.shape == jp.shape
        np.testing.assert_array_equal(tp, jp)
        assert tg == jg
    assert t.classes == j.classes
    assert t.gen_len == j.gen_len
    assert t.metric.__name__ == j.metric.__name__
    assert str(t) == str(j)


@pytest.fixture(scope="module")
def ruler_dir(tmp_path_factory):
    """Three RULER tasks written in the generator's layout, base family."""
    root = tmp_path_factory.mktemp("ruler")
    for task in ("niah_multivalue", "vt", "cwe"):
        rows = jgen.generate_task(task, max_seq_length=1024, num_samples=3)
        jgen.write_jsonl(rows, os.path.join(str(root), "base", "8192", task, "validation.jsonl"))
    return str(root)


@pytest.mark.parametrize("task", ["niah_multivalue", "vt", "cwe"])
def test_ruler_route_equal(ruler_dir, task):
    kw = dict(num_samples=2, data_dir=ruler_dir)
    _same_dataset(TorchDataset(f"ruler/{task}", ttok.ByteTokenizer(), 8192, **kw),
                  JaxDataset(f"ruler/{task}", jtok.ByteTokenizer(), 8192, **kw))


def test_jsonl_route_and_shard_equal(ruler_dir):
    name = "jsonl:" + os.path.join(ruler_dir, "base", "8192", "vt", "validation.jsonl")
    t = TorchDataset(name, ttok.ByteTokenizer(), 1000, gen_len=12)
    j = JaxDataset(name, jtok.ByteTokenizer(), 1000, gen_len=12)
    _same_dataset(t, j)
    t.shard(1, 2)
    j.shard(1, 2)
    _same_dataset(t, j)


@pytest.mark.parametrize("task", sorted(n[:-len(".jsonl")] for n in os.listdir(JAX_FIXTURES)))
def test_long_bench_local_route_equal(task, tmp_path):
    # an empty data_dir: both read their own copy of the fixture
    kw = dict(data_dir=str(tmp_path))
    t = TorchDataset(f"long_bench_local/{task}", ttok.ByteTokenizer(), 8192, **kw)
    j = JaxDataset(f"long_bench_local/{task}", jtok.ByteTokenizer(), 8192, **kw)
    _same_dataset(t, j)


def test_unknown_routes_refused_alike():
    for bad in ("wikitext/x", "long_bench_local/no_such_task"):
        with pytest.raises(Exception) as jerr:
            JaxDataset(bad, jtok.ByteTokenizer(), 8192)
        with pytest.raises(type(jerr.value)):
            TorchDataset(bad, ttok.ByteTokenizer(), 8192)
    with pytest.raises(ValueError, match="datalen 1000 unsupported"):
        TorchDataset("ruler/vt", ttok.ByteTokenizer(), 1000)


def _echo(prompt, gen_len):
    """Token rows that depend on the prompt: its last gen_len ids."""
    return np.asarray(prompt).reshape(-1)[-gen_len:][None, :]


def _run_evaluator(cls, tok, datasets, out_dir):
    ev = cls(_echo, lambda ids: tok.decode(ids), rank=0, world_size=1)
    summaries = []
    for ds in datasets:
        path = os.path.join(out_dir, ds.dataset_name.replace("/", "_") + ".jsonl")
        summaries.append(ev.test(ds, output_path=path, verbose=False))
    return ev, summaries


def test_evaluator_records_summary_and_table_equal(ruler_dir, tmp_path):
    names = ["ruler/niah_multivalue", "ruler/vt", "long_bench_local/trec",
             "long_bench_local/passage_retrieval_en"]
    runs = {}
    for side, cls, ds_cls, tok in (("jax", JaxEvaluator, JaxDataset, jtok.ByteTokenizer()),
                                   ("torch", TorchEvaluator, TorchDataset, ttok.ByteTokenizer())):
        datasets = [ds_cls(n, tok, 8192, data_dir=ruler_dir, gen_len=40) for n in names]
        out = tmp_path / side
        ev, summaries = _run_evaluator(cls, tok, datasets, str(out))
        files = {p.name: p.read_text() for p in sorted(out.iterdir())}
        for s in summaries:
            s.pop("elapsed_s")
        runs[side] = (files, summaries, ev.summarize(), ev.markdown_table())
    assert runs["torch"] == runs["jax"]
    assert any(s["score"] > 0 for s in runs["torch"][1])  # the echo scores somewhere


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


GLOO_RANK = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch.distributed as dist
    from xkv_tpu_torch.evalharness.dataset import Dataset
    from xkv_tpu_torch.evalharness.evaluator import Evaluator
    from xkv_tpu_torch.utils.tokenizer import ByteTokenizer
    port, rank, data_dir, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    tok = ByteTokenizer()
    ev = Evaluator(lambda p, n: np.asarray(p).reshape(-1)[-n:][None, :],
                   lambda ids: tok.decode(ids), rank=rank, world_size=2)
    for name in ("ruler/niah_multivalue", "ruler/vt"):
        ev.test(Dataset(name, tok, 8192, data_dir=data_dir, gen_len=40), verbose=False)
    summary = ev.summarize()
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(summary, f)
""")


def test_summarize_over_two_gloo_processes(ruler_dir, tmp_path):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    outs = [str(tmp_path / f"rank{r}.json") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", GLOO_RANK, str(port), str(r), ruler_dir,
                               outs[r]], cwd=ROOT, env=env, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    gathered = [json.load(open(o)) for o in outs]
    # JAX, one process: the same two shards of each dataset, summarized
    tok = jtok.ByteTokenizer()
    ev = JaxEvaluator(_echo, lambda ids: tok.decode(ids))
    for name in ("ruler/niah_multivalue", "ruler/vt"):
        for rank in range(2):
            ds = JaxDataset(name, tok, 8192, data_dir=ruler_dir, gen_len=40)
            ds.shard(rank, 2)
            ev.test(ds, verbose=False)
    assert gathered[0] == ev.summarize()
    assert gathered[1] == {}


def test_evaluator_needs_a_process_group_for_several_ranks():
    with pytest.raises(RuntimeError, match="process group"):
        TorchEvaluator(_echo, str, rank=1, world_size=2)


def test_tokenizer_surface():
    t, j = ttok.ByteTokenizer(), jtok.ByteTokenizer()
    text = "héllo, wörld"
    assert t.encode(text) == j.encode(text)
    assert t.encode(text, add_special_tokens=True) == j.encode(text, add_special_tokens=True)
    assert t(text) == j(text)
    ids = [1, 2, 0, 3 + 104, 300, 1023, 3 + 105, 258]
    assert t.decode(ids) == j.decode(ids) == "hi"
    for attr in ("pad_token_id", "bos_token_id", "eos_token_id", "vocab_size", "name_or_path"):
        assert getattr(t, attr) == getattr(j, attr)
    for kind in ("byte", "bytes"):
        assert isinstance(ttok.select_tokenizer(kind), ttok.ByteTokenizer)
    assert isinstance(ttok.load_tokenizer("byte-tokenizer"), ttok.ByteTokenizer)
    for kind in ("gemini", "no-such-kind"):
        with pytest.raises(ValueError) as jerr:
            jtok.select_tokenizer(kind)
        with pytest.raises(ValueError) as terr:
            ttok.select_tokenizer(kind)
        assert str(terr.value) == str(jerr.value)


MISSING = textwrap.dedent("""
    import sys
    sys.modules["transformers"] = None
    sys.modules["sentencepiece"] = None
    from xkv_tpu_torch.utils.tokenizer import SentencePieceTokenizer, load_tokenizer
    for call, arg in ((load_tokenizer, "some/hf/dir"), (SentencePieceTokenizer, "m.model")):
        try:
            call(arg)
        except ImportError as e:
            print(type(e).__name__, e)
""")


def test_missing_tokenizer_packages_raise_import_error_naming_them():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", MISSING], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 2
    assert "'transformers'" in lines[0] and "'sentencepiece'" in lines[1]


def test_peak_memory_is_none_on_the_cpu_and_phase_timer_counts():
    assert peak_memory_bytes("cpu") is None
    assert peak_memory_bytes() is None  # no CUDA device here
    timer = PhaseTimer()
    import torch

    with timer.phase("a", result={"x": torch.zeros(2)}):
        pass
    timer.mark("a", 1.0)
    s = timer.summary()["a"]
    assert s["count"] == 2 and s["total_s"] >= 1.0
