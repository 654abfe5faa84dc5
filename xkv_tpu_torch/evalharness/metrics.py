"""Scoring metrics for RULER / LongBench evaluation.

A copy of ``xkv_tpu/evalharness/metrics.py`` kept inside the port.

Behavioral port of the reference's metric surface
(`evaluate/data/metrics.py:29-222`): same normalization, same scoring
semantics, so accuracy numbers are comparable. fuzzywuzzy is replaced by
difflib's SequenceMatcher ratio (not installed here; same 2M/T ratio
definition); jieba/rouge are imported lazily and gated.
"""

from __future__ import annotations

import difflib
import re
import string
from collections import Counter
from typing import List, Union


def normalize_answer(s: str) -> str:
    """Lower text and remove punctuation, articles and extra whitespace
    (reference `metrics.py:29-45`)."""

    def remove_articles(text):
        return re.sub(r"\b(a|an|the)\b", " ", text)

    def white_space_fix(text):
        return " ".join(text.split())

    def remove_punc(text):
        exclude = set(string.punctuation)
        return "".join(ch for ch in text if ch not in exclude)

    return white_space_fix(remove_articles(remove_punc(s.lower())))


def normalize_zh_answer(s: str) -> str:
    cn_punctuation = (
        "！？｡。＂＃＄％＆＇（）＊＋，－／：；＜＝＞＠［＼］＾＿｀｛｜｝～｟｠｢｣､、〃》「」"
        "『』【】〔〕〖〗〘〙〚〛〜〝〞〟〰〾〿–—‘’‛“”„‟…‧﹏."
    )
    all_punct = set(string.punctuation + cn_punctuation)
    s = "".join(ch for ch in s.lower() if ch not in all_punct)
    return "".join(s.split())


def postprocess_pred(predict_str: str) -> str:
    """Strip special tokens and non-printables (reference `metrics.py:64-72`)."""
    predict_str = (
        predict_str.strip()
        .replace("<|eot_id|>", "")
        .replace("</s>", "")
        .replace("</s", "")
        .replace("</", "")
    )
    return re.compile(r"[\x00-\x1f]").sub("\n", predict_str).strip()


# --------------------------------------------------------------------- RULER
def string_match_part(preds: str, refs: Union[str, List[str]]) -> float:
    """Bidirectional substring match (reference `metrics.py:74-81`)."""
    preds = postprocess_pred(preds)
    if isinstance(refs, str):
        refs = [refs]
    score_ref_in_pred = max(1.0 if r.lower() in preds.lower() else 0.0 for r in refs)
    score_pred_in_ref = max(1.0 if preds.lower() in r.lower() else 0.0 for r in refs)
    return round(max(score_ref_in_pred, score_pred_in_ref), 2)


def multi_number(prediction: str, ground_truth: list) -> float:
    """Hit rate of ground-truth numbers in the prediction
    (reference `metrics.py:83-91`)."""
    prediction = normalize_answer(prediction)
    prediction_list = re.findall(r"\d+", prediction)
    hits = [item for item in ground_truth if item in prediction_list]
    return len(hits) / len(ground_truth)


def multi_words(prediction: str, ground_truth: list) -> float:
    """Hit rate of ground-truth words in the prediction
    (reference `metrics.py:93-100`)."""
    prediction = prediction.lower()
    ground_truth = [gt.lower() for gt in ground_truth]
    prediction_list = re.findall(r"\b\w+\b", prediction)
    hits = [item for item in ground_truth if item in prediction_list]
    return len(hits) / len(ground_truth)


def needle_score(prediction: str, ground_truth: str) -> float:
    """Prefix match or word membership (reference `metrics.py:102-112`)."""
    prediction = normalize_answer(postprocess_pred(prediction))
    ground_truth = normalize_answer(ground_truth)
    min_length = len(ground_truth)
    score = float(prediction[:min_length] == ground_truth[:min_length])
    return max(float(ground_truth in prediction.split()), score)


# ----------------------------------------------------------------- LongBench
def count_score(prediction: str, ground_truth, **kwargs) -> float:
    numbers = re.findall(r"\d+", prediction)
    right = sum(1 for n in numbers if str(n) == str(ground_truth))
    return 0.0 if not numbers else right / len(numbers)


def retrieval_score(prediction: str, ground_truth: str, classes=None) -> float:
    matches = re.findall(r"Paragraph (\d+)", ground_truth)
    gt_id = matches[0]
    numbers = re.findall(r"\d+", prediction)
    right = sum(1 for n in numbers if str(n) == str(gt_id))
    return 0.0 if not numbers else right / len(numbers)


def retrieval_zh_score(prediction: str, ground_truth: str, **kwargs) -> float:
    matches = re.findall(r"段落(\d+)", ground_truth)
    gt_id = matches[0]
    numbers = re.findall(r"\d+", prediction)
    right = sum(1 for n in numbers if str(n) == str(gt_id))
    return 0.0 if not numbers else right / len(numbers)


def fuzz_ratio(a: str, b: str) -> float:
    """SequenceMatcher-based ratio in [0, 100] (fuzzywuzzy.fuzz.ratio
    replacement; same 2M/T definition)."""
    return 100.0 * difflib.SequenceMatcher(None, a, b).ratio()


def code_sim_score(prediction: str, ground_truth: str, classes=None) -> float:
    """First non-comment line fuzzy similarity (reference `metrics.py:148-155`)."""
    all_lines = prediction.lstrip("\n").split("\n")
    prediction = ""
    for line in all_lines:
        if ("`" not in line) and ("#" not in line) and ("//" not in line):
            prediction = line
            break
    return fuzz_ratio(prediction, ground_truth) / 100


def classification_score(prediction: str, ground_truth: str, **kwargs) -> float:
    """Exact-class match with fuzzy fallback (reference `metrics.py:157-180`)."""
    all_classes = kwargs["all_classes"]
    em_match_list = [c for c in all_classes if c in prediction]
    for match_term in list(em_match_list):
        if match_term in ground_truth and match_term != ground_truth:
            em_match_list.remove(match_term)
    if em_match_list:
        return (1.0 / len(em_match_list)) if ground_truth in em_match_list else 0.0
    best_match, highest = None, 0.0
    for cls in all_classes:
        sim = difflib.SequenceMatcher(None, cls, prediction).ratio()
        if sim > highest:
            highest, best_match = sim, cls
    return float(best_match == ground_truth)


def rouge_score(prediction: str, ground_truth: str, **kwargs) -> float:
    try:
        from rouge import Rouge

        scores = Rouge().get_scores([prediction], [ground_truth], avg=True)
        return scores["rouge-l"]["f"]
    except Exception:
        return 0.0


def rouge_zh_score(prediction: str, ground_truth: str, **kwargs) -> float:
    import jieba

    prediction = " ".join(jieba.cut(prediction, cut_all=False))
    ground_truth = " ".join(jieba.cut(ground_truth, cut_all=False))
    return rouge_score(prediction, ground_truth)


def f1_score(prediction, ground_truth) -> float:
    common = Counter(prediction) & Counter(ground_truth)
    num_same = sum(common.values())
    if num_same == 0:
        return 0.0
    precision = num_same / len(prediction)
    recall = num_same / len(ground_truth)
    return (2 * precision * recall) / (precision + recall)


def qa_f1_score(prediction: str, ground_truth: str, classes=None) -> float:
    return f1_score(
        normalize_answer(prediction).split(), normalize_answer(ground_truth).split()
    )


def qa_f1_zh_score(prediction: str, ground_truth: str, **kwargs) -> float:
    import jieba

    pred = [normalize_zh_answer(t) for t in jieba.cut(prediction, cut_all=False)]
    gt = [normalize_zh_answer(t) for t in jieba.cut(ground_truth, cut_all=False)]
    return f1_score([t for t in pred if t], [t for t in gt if t])
