"""Greedy-generation evaluator with data-parallel sharding.

Behavioral port of the reference `evaluate/evaluator.py:30-144`:
  * shards the dataset over ranks, greedy-generates per sample,
  * scores with the dataset's metric (LongBench classes variant included),
  * streams per-sample predictions to jsonl (resumable, append-only),
  * ``summarize()`` computes sample-weighted means across ranks.

A copy of ``xkv_tpu/evalharness/evaluator.py`` kept inside the port. With
``world_size > 1`` the per-rank summaries are gathered by
``parallel.distributed.allgather_obj`` (the reference's ``gather_object``),
as the JAX package gathers them: a process group of that size must exist,
and the constructor refuses to start without one.
Single-process runs gather nothing.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from xkv_tpu_torch.utils.profiling import peak_memory_bytes


class Evaluator:
    def __init__(
        self,
        generate_fn: Callable[[np.ndarray, int], List[np.ndarray]],
        decode_fn: Callable[[np.ndarray], str],
        rank: int = 0,
        world_size: int = 1,
    ):
        """generate_fn(prompt_ids (1, s), gen_len) -> token rows;
        decode_fn(token_row) -> text."""
        if world_size > 1:
            import torch.distributed as dist

            if not (dist.is_available() and dist.is_initialized()):
                raise RuntimeError(
                    f"world_size={world_size} needs a torch.distributed process "
                    "group (init_process_group) to gather the summaries")
            if dist.get_world_size() != world_size or dist.get_rank() != rank:
                raise ValueError(
                    f"rank {rank} of {world_size} does not match the process "
                    f"group's rank {dist.get_rank()} of {dist.get_world_size()}")
        self.generate_fn = generate_fn
        self.decode_fn = decode_fn
        self.rank = rank
        self.world_size = world_size
        self.results: List[Dict] = []

    def test(self, dataset, output_path: Optional[str] = None, verbose: bool = True):
        if not dataset.is_sharded:
            dataset.shard(self.rank, self.world_size)

        scores = []
        records = []
        t_start = time.time()
        for idx in range(len(dataset)):
            prompt, gt = dataset[idx]
            out_tokens = self.generate_fn(prompt, dataset.gen_len)
            pred = self.decode_fn(np.asarray(out_tokens).reshape(-1))
            if dataset.classes is not None:
                score = dataset.metric(pred, gt[0], all_classes=dataset.classes[idx])
            else:
                score = self._score(dataset.metric, pred, gt)
            scores.append(score)
            rec = {
                "index": idx,
                "rank": self.rank,
                "prediction": pred,
                "ground_truth": gt,
                "score": score,
                "prompt_len": int(prompt.shape[-1]),
            }
            records.append(rec)
            if output_path:
                os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
                with open(output_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            if verbose:
                avg = sum(scores) / len(scores)
                mem = peak_memory_bytes()
                mem_s = f" peak_mem={mem / 2**30:.2f}GiB" if mem else ""
                print(
                    f"[rank {self.rank}] {dataset.dataset_name} "
                    f"{idx + 1}/{len(dataset)} score={score:.3f} avg={avg:.3f}"
                    f"{mem_s}",
                    flush=True,
                )

        elapsed = time.time() - t_start
        summary = {
            "dataset": dataset.dataset_name,
            "n_samples": len(scores),
            "score": float(np.mean(scores)) if scores else 0.0,
            "elapsed_s": elapsed,
        }
        peak = peak_memory_bytes()
        if peak:
            # Reference tracks max GPU memory per sample (evaluator.py:79-80).
            # NOTE: like the reference, the allocator stat is never reset, so
            # this is the PROCESS-lifetime high-water mark at the time this
            # dataset finished — not a per-dataset peak (ADVICE r1). The
            # field name says so.
            summary["peak_memory_gib_process"] = round(peak / 2**30, 3)
        self.results.append(summary)
        return summary

    @staticmethod
    def _score(metric, pred: str, gt) -> float:
        """RULER ground truths are lists for multi-* tasks, else a list of
        acceptable strings — mirror the reference's per-metric call shapes."""
        from xkv_tpu_torch.evalharness import metrics as M

        if metric in (M.multi_number, M.multi_words):
            return metric(pred, gt)
        if metric is M.string_match_part:
            return metric(pred, gt)  # handles a list of refs itself
        # single-string metrics (needle, LongBench qa-F1/rouge/count/
        # retrieval/code): best score over the acceptable answers
        # (reference `evaluator.py:61-75` takes max over ground truths)
        gts = gt if isinstance(gt, list) else [gt]
        return max(metric(pred, g) for g in gts)

    def summarize(self) -> Dict:
        """Sample-weighted mean per dataset across ranks
        (reference `evaluator.py:109-144`)."""
        all_results = self.results
        if self.world_size > 1:
            from xkv_tpu_torch.parallel.distributed import allgather_obj

            gathered = allgather_obj(self.results)
            if self.rank == 0:
                all_results = [r for rows in gathered for r in rows]
            else:
                return {}

        by_dataset: Dict[str, List[Dict]] = {}
        for r in all_results:
            by_dataset.setdefault(r["dataset"], []).append(r)
        summary = {}
        for name, rows in by_dataset.items():
            total_n = sum(r["n_samples"] for r in rows)
            weighted = (
                sum(r["score"] * r["n_samples"] for r in rows) / total_n
                if total_n
                else 0.0
            )
            summary[name] = {"score": weighted, "n_samples": total_n}
        return summary

    def markdown_table(self) -> str:
        summary = self.summarize()
        lines = ["| dataset | score | n |", "|---|---|---|"]
        for name, row in summary.items():
            lines.append(f"| {name} | {row['score']:.4f} | {row['n_samples']} |")
        return "\n".join(lines)
