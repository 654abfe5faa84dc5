"""Dataset loading/routing for the evaluation harness.

A copy of ``xkv_tpu/evalharness/dataset.py`` kept inside the port; its
``long_bench_local/`` fixtures and ``default_data_dir()`` are the port's own.

Behavioral port of the reference's `evaluate/data/dataset.py:62-293`:
  * name routing: ``ruler/<task>`` -> local jsonl produced by the RULER
    generator pipeline; ``long_bench/<task>`` -> HF hub (needs network);
    plus a ``jsonl:<path>`` escape hatch for arbitrary local data.
  * per-task metric and generation-length tables.
  * chat-template wrapping per tokenizer family.
  * rank sharding for data-parallel evaluation.

Prompts are tokenized to numpy int32 arrays (not torch tensors).
"""

from __future__ import annotations

import json
import os
from typing import Callable, List, Optional

import numpy as np

from xkv_tpu_torch.evalharness import metrics as M

METRICS_FN = {
    "niah": M.needle_score,
    "multi": M.multi_number,
    "vt": M.multi_words,
    "cwe": M.multi_words,
    "fwe": M.multi_words,
    "qa": M.string_match_part,
    "long_bench/narrativeqa": M.qa_f1_score,
    "long_bench/qasper": M.qa_f1_score,
    "long_bench/multifieldqa_en": M.qa_f1_score,
    "long_bench/multifieldqa_zh": M.qa_f1_zh_score,
    "long_bench/hotpotqa": M.qa_f1_score,
    "long_bench/2wikimqa": M.qa_f1_score,
    "long_bench/musique": M.qa_f1_score,
    "long_bench/dureader": M.rouge_zh_score,
    "long_bench/gov_report": M.rouge_score,
    "long_bench/qmsum": M.rouge_score,
    "long_bench/multi_news": M.rouge_score,
    "long_bench/vcsum": M.rouge_zh_score,
    "long_bench/trec": M.classification_score,
    "long_bench/triviaqa": M.qa_f1_score,
    "long_bench/samsum": M.rouge_score,
    "long_bench/lsht": M.classification_score,
    "long_bench/passage_count": M.count_score,
    "long_bench/passage_retrieval_en": M.retrieval_score,
    "long_bench/passage_retrieval_zh": M.retrieval_zh_score,
    "long_bench/lcc": M.code_sim_score,
    "long_bench/repobench-p": M.code_sim_score,
}

GEN_LEN = {
    "niah": 64,
    "vt": 30,
    "cwe": 120,
    "fwe": 50,
    "qa": 32,
    "long_bench/narrativeqa": 128,
    "long_bench/qasper": 128,
    "long_bench/multifieldqa_en": 64,
    "long_bench/multifieldqa_zh": 64,
    "long_bench/hotpotqa": 32,
    "long_bench/2wikimqa": 32,
    "long_bench/musique": 32,
    "long_bench/dureader": 128,
    "long_bench/gov_report": 512,
    "long_bench/qmsum": 512,
    "long_bench/multi_news": 512,
    "long_bench/vcsum": 512,
    "long_bench/trec": 64,
    "long_bench/triviaqa": 32,
    "long_bench/samsum": 128,
    "long_bench/lsht": 64,
    "long_bench/passage_count": 32,
    "long_bench/passage_retrieval_en": 32,
    "long_bench/passage_retrieval_zh": 32,
    "long_bench/lcc": 64,
    "long_bench/repobench-p": 64,
}

SUPPORTED_DATALENS = [8 * 1024, 16 * 1024, 32 * 1024, 64 * 1024, 128 * 1024, 256 * 1024]

# Chat templates per tokenizer family (reference `dataset.py:122-131`).
TEMPLATES = {
    "base": "{ctx}",
    "llama-3": (
        "<|start_header_id|>system<|end_header_id|>You are a helpful assistant"
        "<|eot_id|><|start_header_id|>user<|end_header_id|>{ctx}<|eot_id|>"
        "<|start_header_id|>assistant<|end_header_id|>"
    ),
    "qwen": (
        "<|im_start|>system\nYou are a helpful assistant<|im_end|>\n"
        "<|im_start|>user\n{ctx}<|im_end|>\n<|im_start|>assistant\n"
    ),
    "deepseek": "<｜begin▁of▁sentence｜>User: {task_template}\n\nAssistant:",
}


def tokenizer_family(name_or_path: str) -> str:
    """Sniff the tokenizer family from its name (reference `dataset.py:221-236`)."""
    lowered = name_or_path.lower()
    for fam in ("llama-3", "yi", "lwm", "glm", "qwen", "phi", "deepseek"):
        if fam in lowered:
            return fam
    return "base"


def default_data_dir() -> str:
    return os.environ.get(
        "XKV_RULER_DATA", os.path.join(os.path.dirname(__file__), "ruler", "data")
    )


class Dataset:
    """Name-routed evaluation dataset (reference `dataset.py:133-293`).

    dataset_name:
      ``ruler/<task>``        local jsonl at {data_dir}/{family}/{datalen}/{task}/validation.jsonl
      ``long_bench/<task>``   HF hub THUDM/LongBench (requires network)
      ``long_bench_local/<task>`` reference-format local jsonl at
                              {data_dir}/long_bench/{task}.jsonl (offline;
                              same templates / gen_len / metric routing as
                              the hub route — fixtures under
                              evalharness/long_bench_fixtures/)
      ``jsonl:<path>``        any local jsonl with input/outputs fields
    """

    def __init__(
        self,
        dataset_name: str,
        tokenizer,
        datalen: int,
        num_samples: int = -1,
        data_dir: Optional[str] = None,
        gen_len: Optional[int] = None,
    ):
        self.dataset_name = dataset_name
        self.tokenizer = tokenizer
        self.datalen = datalen
        self.num_samples = num_samples
        self.data_dir = data_dir or default_data_dir()
        self.is_sharded = False
        self.classes: Optional[List] = None

        self._load()
        self.num_samples = len(self.tokenized_prompts)
        self.gen_len = gen_len if gen_len is not None else self._get_gen_len()
        self.metric = self._get_metric()

    # ------------------------------------------------------------------ dunder
    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        return self.tokenized_prompts[idx], self.gt[idx]

    def __str__(self):
        return (
            f"Dataset: {self.dataset_name}, Num Samples: {self.num_samples}, "
            f"Gen Len: {self.gen_len}, DataLen: {self.datalen}"
        )

    __repr__ = __str__

    # ------------------------------------------------------------------ shard
    def shard(self, rank: int, world_size: int):
        """Contiguous rank sharding; last rank takes the remainder
        (reference `dataset.py:163-173`)."""
        if world_size > 1:
            shard_size = self.num_samples // world_size
            start = rank * shard_size
            end = start + shard_size if rank != world_size - 1 else self.num_samples
            self.tokenized_prompts = self.tokenized_prompts[start:end]
            self.gt = self.gt[start:end]
            if self.classes is not None:
                self.classes = self.classes[start:end]
            self.num_samples = len(self.tokenized_prompts)
        self.is_sharded = True

    # ------------------------------------------------------------------ tables
    def _get_gen_len(self) -> int:
        name = self.dataset_name.replace("long_bench_local/", "long_bench/")
        if name == "niah":
            return 10
        for key in ("niah", "vt", "cwe", "fwe", "qa"):
            if key in name:
                return 128 if key == "niah" and name != "niah" else GEN_LEN[key]
        if name in GEN_LEN:
            return GEN_LEN[name]
        raise ValueError(f"Gen len not found for {name}")

    def _get_metric(self) -> Callable:
        name = self.dataset_name.replace("long_bench_local/", "long_bench/")
        if "long_bench" in name and name in METRICS_FN:
            return METRICS_FN[name]
        if "multiquery" in name or "multivalue" in name:
            return METRICS_FN["multi"]
        for key in ("niah", "vt", "cwe", "fwe", "qa"):
            if key in name:
                return METRICS_FN[key]
        raise ValueError(f"Metric not found for {name}")

    # ------------------------------------------------------------------ loading
    def _encode(self, text: str, add_special_tokens: bool = False) -> np.ndarray:
        ids = self.tokenizer.encode(text, add_special_tokens=add_special_tokens)
        return np.asarray(ids, dtype=np.int32)[None, :]

    def _take(self, n_available: int) -> int:
        if self.num_samples > 0:
            return min(self.num_samples, n_available)
        return n_available

    def _load(self):
        name = self.dataset_name
        if name.startswith("jsonl:"):
            self._load_jsonl(name[len("jsonl:") :])
        elif "ruler" in name:
            task = name.split("/")[-1]
            if self.datalen not in SUPPORTED_DATALENS:
                raise ValueError(
                    f"datalen {self.datalen} unsupported; choose {SUPPORTED_DATALENS}"
                )
            family = tokenizer_family(getattr(self.tokenizer, "name_or_path", "base"))
            path = os.path.join(
                self.data_dir, family, str(self.datalen), task, "validation.jsonl"
            )
            self._load_jsonl(path)
        elif "long_bench_local" in name:
            self._load_longbench_local(name.split("/")[-1])
        elif "long_bench" in name:
            self._load_longbench(name.split("/")[-1])
        else:
            raise ValueError(
                f"Dataset {name} not found; choose ruler/<task>, long_bench/<task>, jsonl:<path>"
            )

    def _load_jsonl(self, path: str):
        rows = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    rows.append(json.loads(line))
        n = self._take(len(rows))
        self.tokenized_prompts = [self._encode(r["input"]) for r in rows[:n]]
        self.gt = [r["outputs"] for r in rows[:n]]

    def _load_longbench_local(self, task: str):
        """Offline LongBench: reference-format rows (context/input/answers/
        all_classes — the fields `dataset.py:254-291` reads from the hub)
        from a local jsonl. Falls back to the in-repo one-sample-per-family
        fixtures when {data_dir}/long_bench/ has no file for the task."""
        from xkv_tpu_torch.evalharness.longbench_templates import LONG_BENCH_TEMPLATE

        path = os.path.join(self.data_dir, "long_bench", f"{task}.jsonl")
        if not os.path.exists(path):
            fixture = os.path.join(
                os.path.dirname(__file__), "long_bench_fixtures",
                f"{task}.jsonl",
            )
            if not os.path.exists(fixture):
                raise FileNotFoundError(
                    f"no local LongBench data for {task}: neither {path} "
                    f"nor the in-repo fixture exists"
                )
            path = fixture
        rows = []
        with open(path) as f:
            for line in f:
                if line.strip():
                    rows.append(json.loads(line))
        n = self._take(len(rows))
        template = LONG_BENCH_TEMPLATE[task]
        self.tokenized_prompts, self.gt = [], []
        classes = []
        for r in rows[:n]:
            text = template.format(**{k: v for k, v in r.items()
                                      if k not in ("answers", "all_classes")})
            self.tokenized_prompts.append(
                self._encode(text, add_special_tokens=True)
            )
            self.gt.append(r["answers"])
            classes.append(r.get("all_classes"))
        if any(c is not None for c in classes):
            self.classes = classes

    def _load_longbench(self, task: str):
        from datasets import load_dataset as hf_load_dataset

        from xkv_tpu_torch.evalharness.longbench_templates import LONG_BENCH_TEMPLATE

        dataset = hf_load_dataset("THUDM/LongBench", task, split="test")
        n = self._take(len(dataset))
        template = LONG_BENCH_TEMPLATE[task]
        self.tokenized_prompts, self.gt, self.classes = [], [], []
        for i in range(n):
            text = template.format(**dataset[i])
            self.tokenized_prompts.append(self._encode(text, add_special_tokens=True))
            self.gt.append(dataset[i]["answers"])
            self.classes.append(dataset[i]["all_classes"])
