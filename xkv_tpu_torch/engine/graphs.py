"""The decode step of one tail segment, captured as a CUDA graph.

Port of the JAX engine's compiled decode (``xkv_tpu/engine/engine.py``:
``_generate_impl`` and ``_score_impl``, a ``lax.scan`` whose body is one
decode step). ``DecodeGraph`` owns the step's inputs as static buffers (the
token, the position, the step index) and its output buffer, and runs the
engine's eager ``decode_step`` as its body: one decode step, then, greedy,
the argmax written into the token buffer and the output row, or, scoring,
the step's log-softmax written into the output row; the tail and its
``tail_len`` are updated in place and the position moves on by one.

On a CUDA device the segment's first step runs eagerly on a side stream
(the warm-up ``torch.cuda.graph`` asks for), then one step is captured
(recorded, not run) and the graph is replayed once for each remaining
step: no Python and no host sync between steps. The kernels' launch
counters count a captured launch once per replay (``_build.capture_counts``).
A capture that fails raises; nothing falls back to the eager loop. On the
CPU the same object runs the body eagerly every step.

A graph is bound to the buffers it was captured on: the tail, the factors
(whose TMA descriptors the kernels encode with their addresses at capture)
and the static buffers. So one is captured per (cache, segment); after a
refactorisation the factors are new and the next segment captures again.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from xkv_tpu_torch.cache import XKVCache
from xkv_tpu_torch.models.llama import position_tensor
from xkv_tpu_torch.ops.kernels import _build


@dataclass
class SegmentTiming:
    """A segment's steps, its capture's host time (None on the CPU) and
    CUDA events around its last run of replays (None when nothing was
    replayed)."""

    steps: int
    capture_ms: Optional[float] = None
    replays: int = 0
    start: Optional[torch.cuda.Event] = None
    end: Optional[torch.cuda.Event] = None

    def replay_ms_per_step(self) -> Optional[float]:
        """Device time from the first replay's start to the last one's end,
        per replay (waits for the last replay)."""
        if self.start is None:
            return None
        self.end.synchronize()
        return self.start.elapsed_time(self.end) / self.replays


class DecodeGraph:
    """``steps`` decode steps over ``cache`` from position ``pos``: greedy
    from ``first_token`` (b, 1), or teacher-forced over ``teacher`` (b,
    steps), exactly one of them. ``run`` returns (tokens (b, steps), or
    log-probs (b, steps, V) fp32; the cache ``steps`` rows on). The
    caller's cache keeps its ``tail_len`` tensor; its tail buffers are
    written."""

    def __init__(self, engine, cache: XKVCache, pos, steps: int,
                 first_token: Optional[torch.Tensor] = None,
                 teacher: Optional[torch.Tensor] = None):
        if (first_token is None) == (teacher is None):
            raise ValueError("give exactly one of first_token and teacher")
        if cache.tail_count + steps > cache.tail_max:
            raise ValueError(f"tail overflow: {cache.tail_count} + {steps} > {cache.tail_max}")
        dev = cache.tail_k.device
        self.engine = engine
        self.steps = steps
        self.graphed = dev.type == "cuda"
        # The segment's own tail_len, which every step updates in place.
        self.cache = dataclasses.replace(cache, tail_len=cache.tail_len.clone())
        self.pos = position_tensor(pos, dev).clone()
        self.step = torch.zeros((1,), dtype=torch.long, device=dev)
        self.teacher = None if teacher is None else teacher.to(dev, torch.long).contiguous()
        b = cache.tail_k.shape[1]
        if teacher is None:
            self.token = first_token.to(dev, torch.long).reshape(b, 1).clone()
            self.out = torch.empty((b, steps), dtype=torch.long, device=dev)
        else:
            self.out = torch.empty((b, steps, engine.cfg.vocab_size), dtype=torch.float32,
                                   device=dev)
        self.done = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.counts: Optional[dict] = None
        self.timing = SegmentTiming(steps)

    def _body(self) -> None:
        tok = self.token if self.teacher is None else self.teacher.index_select(1, self.step)
        logits, stepped = self.engine.decode_step(self.cache, tok, self.pos)
        last = logits[:, -1]
        if self.teacher is None:
            nxt = last.argmax(dim=-1)[:, None]
            self.token.copy_(nxt)
            self.out.index_copy_(1, self.step, nxt)
        else:
            self.out.index_copy_(1, self.step, torch.log_softmax(last, dim=-1)[:, None])
        self.cache.tail_len.copy_(stepped.tail_len)
        self.pos.add_(1)
        self.step.add_(1)

    def warm_up(self) -> None:
        """The segment's first step, eager (on a side stream on CUDA)."""
        if self.graphed:
            main = torch.cuda.current_stream(self.pos.device)
            side = torch.cuda.Stream(self.pos.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                self._body()
            main.wait_stream(side)
        else:
            self._body()
        self.done += 1

    def capture(self) -> None:
        """Capture one step; its launches are counted once per replay."""
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        with _build.capture_counts() as counts:
            with torch.cuda.graph(self.graph):
                self._body()
        self.counts = counts
        self.timing.capture_ms = (time.perf_counter() - t0) * 1e3

    def replay(self, n: int) -> None:
        """Replay the captured step ``n`` times, timed by CUDA events."""
        self.timing.replays = n
        self.timing.start = torch.cuda.Event(enable_timing=True)
        self.timing.end = torch.cuda.Event(enable_timing=True)
        self.timing.start.record()
        for _ in range(n):
            self.graph.replay()
        self.timing.end.record()
        _build.add_counts(self.counts, n)
        self.done += n

    def run(self) -> Tuple[torch.Tensor, XKVCache]:
        if self.steps > 0:
            self.warm_up()
        rest = self.steps - self.done
        if self.graphed and rest > 0:
            self.capture()
            self.replay(rest)
        else:
            for _ in range(rest):
                self._body()
                self.done += 1
        self.graph = None  # frees the graph's memory pool
        return self.out, dataclasses.replace(self.cache,
                                             tail_count=self.cache.tail_count + self.done)
