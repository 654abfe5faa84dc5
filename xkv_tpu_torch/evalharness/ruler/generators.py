"""RULER synthetic task generators (niah, vt, cwe, fwe, qa).

A copy of ``xkv_tpu/evalharness/ruler/generators.py`` kept inside the port:
the same arguments give the same rows.

Behavioral port of the five generator scripts under the reference's
`evaluate/data/ruler/synthetic/` — same task semantics, needle formats,
context-sizing loop (grow the haystack until the tokenized prompt fills
``max_seq_length``), 40-bucket depth sampling, and jsonl output schema
(index/input/outputs/length) — restructured as one module with a shared
sizing loop instead of five argparse scripts.

Differences (documented): offline word/essay sources (see wordlists.py);
qa uses local SQuAD/HotpotQA json when XKV_QA_JSON_DIR points at the
reference-format files (`synthetic/json/download_qa_dataset.sh`), else a
synthetic offline corpus with the same gold-doc + distractor structure.
"""

from __future__ import annotations

import json
import os
import random
import string
import uuid
from typing import Dict, List, Tuple

import numpy as np

from xkv_tpu_torch.evalharness.ruler import wordlists
from xkv_tpu_torch.evalharness.ruler.tasks import SYNTHETIC_TASKS, TASKS, build_template

# 40 depth buckets (reference `niah.py:99`).
DEPTHS = list(np.round(np.linspace(0, 100, num=40, endpoint=True)).astype(int))

NEEDLE = "One of the special magic {type_needle_v} for {key} is: {value}."
NOISE_SENTENCE = (
    "The grass is green. The sky is blue. The sun is yellow. Here we go. "
    "There and back again."
)


class TokenCounter:
    """len(tokenizer(text)) with a cheap whitespace fallback."""

    def __init__(self, tokenizer=None):
        self.tokenizer = tokenizer

    def __call__(self, text: str) -> int:
        if self.tokenizer is None:
            return max(1, len(text) // 4)
        return len(self.tokenizer.encode(text, add_special_tokens=False))


# ------------------------------------------------------------------- niah
def _gen_value(kind: str, rng: random.Random, keys: List[str]) -> str:
    if kind == "numbers":
        return str(rng.randint(10**6, 10**7 - 1))
    if kind == "words":
        return rng.choice(keys)
    if kind == "uuids":
        return str(uuid.UUID(int=rng.getrandbits(128), version=4))
    raise NotImplementedError(kind)


def generate_niah_sample(
    rng: random.Random,
    num_haystack: int,
    template: str,
    *,
    type_haystack: str = "essay",
    type_needle_k: str = "words",
    type_needle_v: str = "numbers",
    num_needle_k: int = 1,
    num_needle_v: int = 1,
    num_needle_q: int = 1,
    essay: List[str] = None,
    key_pool: List[str] = None,
) -> Tuple[str, List[str]]:
    """One sample (input_text, answers); reference `niah.py:124-194`."""
    num_needle_k = max(num_needle_k, num_needle_q)
    keys, values, needles = [], [], []
    for _ in range(num_needle_k):
        keys.append(_gen_value(type_needle_k, rng, key_pool))
        value = []
        for _ in range(num_needle_v):
            value.append(_gen_value(type_needle_v, rng, key_pool))
            needles.append(
                NEEDLE.format(
                    type_needle_v=type_needle_v, key=keys[-1], value=value[-1]
                )
            )
        values.append(value)
    rng.shuffle(needles)

    if type_haystack == "essay":
        text = " ".join(essay[:num_haystack])
        sents = [s.strip() for s in text.split(". ") if s.strip()]
        positions = (
            [0]
            + sorted(
                int(len(sents) * (d / 100)) for d in rng.sample(DEPTHS, len(needles))
            )
            + [len(sents)]
        )
        parts = []
        for i in range(1, len(positions)):
            parts.append(". ".join(sents[positions[i - 1] : positions[i]]))
            if i - 1 < len(needles):
                parts.append(needles[i - 1])
        context = " ".join(parts)
    else:
        if type_haystack == "repeat":
            sentences = [NOISE_SENTENCE] * num_haystack
        elif type_haystack == "needle":
            sentences = [
                NEEDLE.format(
                    type_needle_v=type_needle_v,
                    key=_gen_value(type_needle_k, rng, key_pool),
                    value=_gen_value(type_needle_v, rng, key_pool),
                )
                for _ in range(num_haystack)
            ]
        else:
            raise NotImplementedError(type_haystack)
        indexes = sorted(rng.sample(range(num_haystack), len(needles)), reverse=True)
        for index, element in zip(indexes, needles):
            sentences.insert(index, element)
        context = "\n".join(sentences)

    indices = rng.sample(range(num_needle_k), num_needle_q)
    queries = [keys[i] for i in indices]
    answers = [a for i in indices for a in values[i]]
    query = (
        ", ".join(queries[:-1]) + ", and " + queries[-1]
        if len(queries) > 1
        else queries[0]
    )

    type_v = type_needle_v
    if num_needle_q * num_needle_v == 1:
        # Singular phrasing (reference `niah.py:182-188`).
        template = (
            template.replace("Some", "A")
            .replace("are all", "is")
            .replace("are", "is")
            .replace("answers", "answer")
        )
        type_v = type_v[:-1]

    return template.format(type_needle_v=type_v, context=context, query=query), answers


# ------------------------------------------------------------------- vt
def generate_vt_sample(
    rng: random.Random,
    num_noises: int,
    template: str,
    *,
    num_chains: int = 1,
    num_hops: int = 4,
) -> Tuple[str, List[str]]:
    """Variable-assignment chain tracking; reference
    `variable_tracking.py:68-128`."""
    total = (num_hops + 1) * num_chains
    vars_all: List[str] = []
    while len(set(vars_all)) < total:
        vars_all.append("".join(rng.choices(string.ascii_uppercase, k=5)))
    vars_all = list(dict.fromkeys(vars_all))[:total]

    vars_ret, chains = [], []
    for i in range(0, total, num_hops + 1):
        this_vars = vars_all[i : i + num_hops + 1]
        vars_ret.append(this_vars)
        chain = [f"VAR {this_vars[0]} = {rng.randint(10000, 99999)}"]
        for j in range(num_hops):
            chain.append(f"VAR {this_vars[j + 1]} = VAR {this_vars[j]} ")
        chains.append(chain)

    sentences = [NOISE_SENTENCE + "\n"] * num_noises
    if len(sentences) <= len(chains[0]):
        sentences = [
            n + "." if len(n.strip()) > 0 else n
            for noise in sentences
            for n in noise.split(".")
        ]
        chains = [c[: max(1, len(sentences) - 1)] for c in chains]
    for chain in chains:
        positions = sorted(rng.sample(range(len(sentences)), len(chain)))
        for pi, j in zip(positions, range(len(chain))):
            sentences.insert(pi + j, chain[j])
    context = " ".join(sentences).replace(". \n", ".\n")

    value = chains[0][0].split("=")[-1].strip()
    input_text = template.format(context=context, query=value, num_v=num_hops + 1)
    return input_text, vars_ret[0]


# ------------------------------------------------------------------- cwe
def generate_cwe_sample(
    rng: random.Random,
    num_words: int,
    template: str,
    *,
    freq_cw: int = 30,
    freq_ucw: int = 3,
    num_cw: int = 10,
    max_seq_length: int = 65536,
    word_pool: List[str] = None,
) -> Tuple[str, List[str]]:
    """Common-words extraction; reference `common_words_extraction.py:72-104`."""

    def example(n, common_rep, uncommon_rep, common_n):
        full = rng.sample(word_pool, min(n, len(word_pool)))
        common, uncommon = full[:common_n], full[common_n:]
        word_list = common * int(common_rep) + uncommon * int(uncommon_rep)
        rng.shuffle(word_list)
        ctx = " ".join(f"{i + 1}. {w}" for i, w in enumerate(word_list))
        return ctx, common

    if max_seq_length < 4096:
        ctx_ex, ans_ex = example(20, 3, 1, num_cw)
        ctx, answer = example(num_words, 6, 1, num_cw)
    else:
        ctx_ex, ans_ex = example(40, 10, 3, num_cw)
        ctx, answer = example(num_words, freq_cw, freq_ucw, num_cw)

    input_example = template.format(context=ctx_ex, query="") + " ".join(
        f"{i + 1}. {w}" for i, w in enumerate(ans_ex)
    )
    input_text = template.format(context=ctx, query="")
    return input_example + "\n" + input_text, answer


# ------------------------------------------------------------------- fwe
def generate_fwe_sample(
    rng: random.Random,
    num_words: int,
    template: str,
    *,
    alpha: float = 2.0,
    coded_wordlen: int = 6,
    vocab_size: int = 2000,
) -> Tuple[str, List[str]]:
    """Zipf-sampled coded-word frequency extraction; reference
    `freq_words_extraction.py:68-97`."""
    from scipy.special import zeta

    vocab = set()
    while len(vocab) < vocab_size:
        vocab.add("".join(rng.choices(string.ascii_lowercase, k=coded_wordlen)))
    vocab = sorted(vocab)
    rng.shuffle(vocab)
    vocab[0] = "..."  # top-ranked treated as noise

    k = np.arange(1, len(vocab) + 1)
    counts = (num_words * (k ** -alpha) / zeta(alpha)).astype(int)
    sampled = [w for w, c in zip(vocab, counts) for _ in range(c)]
    rng.shuffle(sampled)
    return template.format(context=" ".join(sampled), query=""), vocab[1:4]


# ------------------------------------------------------------------- qa
def synthetic_qa_corpus(
    rng: random.Random, n_docs: int = 400, n_qas: int = 200
) -> Tuple[List[dict], Dict[int, str]]:
    """Offline fallback corpus: documents of filler sentences, each carrying
    one stated fact; questions ask for that fact. Preserves the qa task's
    structure (gold doc + distractors) without the downloaded SQuAD json."""
    docs: Dict[int, str] = {}
    qas: List[dict] = []
    key_pool = wordlists.key_words()
    for i in range(n_docs):
        subject = rng.choice(key_pool)
        value = str(rng.randint(10**6, 10**7 - 1))
        filler = " ".join(
            wordlists.essay_words(random.Random(rng.randint(0, 1 << 30)),
                                  approx_words=60)
        )
        docs[i] = (
            f"{filler} The registration code of the {subject} is {value}. "
        )
        if len(qas) < n_qas:
            qas.append(
                {
                    "query": f"What is the registration code of the {subject}?",
                    "outputs": [value],
                    "context": [i],
                }
            )
    return qas, docs


def load_qa_corpus(dataset: str, json_dir: str) -> Tuple[List[dict], Dict[int, str]]:
    """Load SQuAD/HotpotQA from local json (reference `qa.py:68-108`; the
    files come from the reference's download_qa_dataset.sh). Without the
    json files, a synthetic offline corpus with the same structure is used
    (documented deviation; set XKV_QA_JSON_DIR for the real corpora)."""
    path = os.path.join(json_dir, f"{dataset}.json") if json_dir else ""
    if not path or not os.path.exists(path):
        return synthetic_qa_corpus(random.Random(42))
    raw = json.load(open(path))
    if dataset == "squad":
        total_docs, total_qas = [], []
        for item in raw["data"]:
            for para in item["paragraphs"]:
                if para["context"] not in total_docs:
                    total_docs.append(para["context"])
                idx = total_docs.index(para["context"])
                for qa in para["qas"]:
                    if not qa.get("is_impossible", False):
                        total_qas.append(
                            {
                                "query": qa["question"],
                                "outputs": [a["text"] for a in qa["answers"]],
                                "context": [idx],
                            }
                        )
        docs = {i: d for i, d in enumerate(total_docs)}
        return total_qas, docs
    if dataset == "hotpotqa":
        total_docs, total_qas = [], []
        seen = {}
        for item in raw:
            golds = []
            for title, sents in item["context"]:
                doc = f"{title}\n{''.join(sents)}"
                if doc not in seen:
                    seen[doc] = len(total_docs)
                    total_docs.append(doc)
                golds.append(seen[doc])
            total_qas.append(
                {
                    "query": item["question"],
                    "outputs": [item["answer"]],
                    "context": golds,
                }
            )
        docs = {i: d for i, d in enumerate(total_docs)}
        return total_qas, docs
    raise ValueError(dataset)


def generate_qa_sample(
    rng: random.Random,
    num_docs: int,
    template: str,
    *,
    qas: List[dict],
    docs: Dict[int, str],
) -> Tuple[str, List[str]]:
    """Gold docs + distractors to fill the context; reference `qa.py:120-143`."""
    qa = rng.choice(qas)
    gold = list(qa["context"])
    distractors = rng.sample(
        [i for i in docs if i not in gold], max(0, num_docs - len(gold))
    )
    all_ids = gold + distractors
    rng.shuffle(all_ids)
    context = "\n\n".join(
        f"Document {i + 1}:\n{docs[d]}" for i, d in enumerate(all_ids)
    )
    return template.format(context=context, query=qa["query"]), qa["outputs"]


# ------------------------------------------------- sizing + generation loop
def generate_task(
    task_name: str,
    *,
    tokenizer=None,
    max_seq_length: int = 65536,
    num_samples: int = 96,
    random_seed: int = 42,
    model_template_type: str = "base",
    qa_json_dir: str = None,
) -> List[dict]:
    """Generate one RULER task's jsonl rows (index/input/outputs/length).

    Mirrors the reference pipeline: build the wrapped template, grow the
    haystack size until the tokenized prompt fills ``max_seq_length``
    (reference `niah.py:197-229`), then emit ``num_samples`` samples.
    """
    if task_name not in SYNTHETIC_TASKS:
        raise ValueError(f"unknown task {task_name}; options {list(SYNTHETIC_TASKS)}")
    spec = SYNTHETIC_TASKS[task_name]
    base_task = spec["task"]
    task_args = dict(spec["args"])
    template = build_template(base_task, model_template_type)
    tokens_to_generate = TASKS[base_task]["tokens_to_generate"]
    count = TokenCounter(tokenizer)
    rng = random.Random(random_seed)
    np_rng = np.random.default_rng(random_seed)
    del np_rng

    if base_task == "niah":
        essay = (
            wordlists.essay_words(random.Random(random_seed))
            if task_args.get("type_haystack") == "essay"
            else None
        )
        key_pool = wordlists.key_words()
        incremental = (
            500
            if task_args.get("type_haystack") == "essay"
            else (5 if max_seq_length < 4096 else 25)
        )

        def make(n, r):
            return generate_niah_sample(
                r, n, template, essay=essay, key_pool=key_pool, **task_args
            )

    elif base_task == "variable_tracking":
        incremental = 10

        def make(n, r):
            return generate_vt_sample(r, n, template, **task_args)

    elif base_task == "common_words_extraction":
        pool = wordlists.word_list()
        incremental = 10

        def make(n, r):
            return generate_cwe_sample(
                r, n, template, max_seq_length=max_seq_length,
                word_pool=pool, **task_args,
            )

    elif base_task == "freq_words_extraction":
        incremental = 10
        vocab_size = max(10, max_seq_length // 50)

        def make(n, r):
            return generate_fwe_sample(
                r, n, template, vocab_size=vocab_size, **task_args
            )

    elif base_task == "qa":
        json_dir = qa_json_dir or os.environ.get("XKV_QA_JSON_DIR", "")
        qas, docs = load_qa_corpus(task_args["dataset"], json_dir)
        incremental = 1

        def make(n, r):
            return generate_qa_sample(r, n, template, qas=qas, docs=docs)

    else:
        raise NotImplementedError(base_task)

    # Exponential-then-linear sizing: find the largest haystack that fits.
    size = incremental
    best = size
    prev_total = -1
    while True:
        text, answer = make(size, random.Random(random_seed))
        total = count(text + " " + " ".join(map(str, answer))) + tokens_to_generate
        if total > max_seq_length:
            break
        if total == prev_total:
            # Saturated: the generator's corpus caps the text (e.g. cwe's
            # finite word pool) below max_seq_length — growing the unit
            # count further would loop forever.
            size = best
            break
        prev_total = total
        best = size
        size += max(incremental, size)  # exponential growth: fewer probes
    lo, hi = best, size
    while hi - lo > incremental:
        mid = (lo + hi) // 2
        text, answer = make(mid, random.Random(random_seed))
        total = count(text + " " + " ".join(map(str, answer))) + tokens_to_generate
        if total > max_seq_length:
            hi = mid
        else:
            lo = mid
    num_units = max(incremental, lo)

    rows = []
    for index in range(num_samples):
        used = num_units
        while True:
            sample_rng = random.Random(random_seed + index)
            text, answer = make(used, sample_rng)
            length = count(text) + tokens_to_generate
            if length <= max_seq_length:
                break
            used = max(1, used - incremental)
        rows.append(
            {"index": index, "input": text, "outputs": answer, "length": length}
        )
    return rows


def write_jsonl(rows: List[dict], path: str):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
