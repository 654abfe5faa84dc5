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

``SpecRounds`` is the speculative round of the JAX engine
(``_spec_round_impl``) on the same machinery: a draft step (one token,
the engine's draft options) and a verify step (``k + 1`` tokens, exact)
captured once per factor segment and replayed every round, ``k`` draft
replays and one verify replay, over static device buffers that carry the
round's start (tail length, position, token) from one round to the next.

``BatchedStep`` is the continuous-batching step (the JAX
``BatchedEngine``'s ``_step_jit``): one decode step of every slot of an
s_max-row slot cache, captured once per engine and replayed every step.
``BatchedSpecRound`` is its speculative round (``_spec_step_jit``): a
draft step of every slot and a verify step of every slot, each captured
once per engine on ``SpecRounds``' machinery (``_CapturedRounds``).
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from xkv_tpu_torch.cache import XKVCache
from xkv_tpu_torch.models.llama import position_tensor
from xkv_tpu_torch.ops.kernels import _build


def run_on_side_stream(body, device: torch.device) -> None:
    """Run ``body`` eagerly on a side stream (the warm-up that
    ``torch.cuda.graph`` asks for before a capture)."""
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        body()
    main.wait_stream(side)


def capture_step(body) -> Tuple[torch.cuda.CUDAGraph, dict, float]:
    """Capture ``body`` (recorded, not run) as a CUDA graph. Returns (the
    graph, its launch counts, to add once per replay; the capture's host
    ms). A capture that fails raises."""
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    with _build.capture_counts() as counts:
        with torch.cuda.graph(graph):
            body()
    return graph, counts, (time.perf_counter() - t0) * 1e3


def refuse_mesh(engine, what: str) -> None:
    """A graph of a step under a mesh is refused: the gloo backend's
    collectives (what ranks sharing one card use) cannot be captured in a
    CUDA graph, and a captured tensor-parallel step on NCCL needs a card a
    rank (ROADMAP item 17). Under a mesh ``InferenceEngine.generate`` and
    ``BatchedEngine.step`` run their steps eagerly."""
    if getattr(engine, "mesh", None) is not None:
        raise ValueError(f"{what} under a mesh: a captured tensor-parallel step is not "
                         "ported yet (ROADMAP item 17); the engines decode eagerly there")


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
                 teacher: Optional[torch.Tensor] = None,
                 step_kw: Optional[dict] = None):
        refuse_mesh(engine, "DecodeGraph")
        if (first_token is None) == (teacher is None):
            raise ValueError("give exactly one of first_token and teacher")
        if cache.tail_count + steps > cache.tail_max:
            raise ValueError(f"tail overflow: {cache.tail_count} + {steps} > {cache.tail_max}")
        dev = cache.tail_k.device
        self.engine = engine
        # The step's decode options: the engine's own (its sparse top-k)
        # unless given ({} is the exact step).
        self.step_kw = engine.step_kw if step_kw is None else step_kw
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
        logits, stepped = self.engine.step(self.cache, tok, self.pos, self.step_kw)
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
            run_on_side_stream(self._body, self.pos.device)
        else:
            self._body()
        self.done += 1

    def capture(self) -> None:
        """Capture one step; its launches are counted once per replay."""
        self.graph, self.counts, self.timing.capture_ms = capture_step(self._body)

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


@dataclass
class RoundTiming:
    """The speculative rounds of one factor segment: the tokens each round
    emitted, the host ms of the draft and verify captures (None on the
    CPU), and CUDA events around each replayed round's draft replays and
    its verify replay (every round but the first, which captures)."""

    draft_k: int
    emitted: List[int] = dataclasses.field(default_factory=list)
    draft_capture_ms: Optional[float] = None
    verify_capture_ms: Optional[float] = None
    events: List[Tuple[torch.cuda.Event, torch.cuda.Event, torch.cuda.Event]] = \
        dataclasses.field(default_factory=list)

    @property
    def rounds(self) -> int:
        return len(self.emitted)

    def replayed(self) -> Tuple[float, float, int]:
        """Over the replayed rounds: (device ms of the draft replays, of the
        verify replays, tokens emitted); waits for the last round."""
        if not self.events:
            return 0.0, 0.0, 0
        self.events[-1][2].synchronize()
        draft = sum(a.elapsed_time(b) for a, b, _ in self.events)
        verify = sum(b.elapsed_time(c) for _, b, c in self.events)
        return draft, verify, sum(self.emitted[-len(self.events):])


class _CapturedRounds:
    """The round machinery that ``SpecRounds`` and ``BatchedSpecRound``
    share: a subclass gives ``_draft`` (one draft step) and ``_verify``
    (the exact pass over the drafts), each over its own static buffers.
    ``_run_round`` runs one round: on the CPU eagerly; on CUDA the first
    round runs a warm-up draft, captures the draft step, replays it for the
    other drafts, then runs a warm-up verify and captures it; every later
    round replays both (``k`` draft replays, one verify replay), timed by
    CUDA events."""

    def _init_rounds(self, draft_k: int, device: torch.device) -> None:
        self.k = draft_k
        self.graphed = device.type == "cuda"
        self.draft_graph = self.verify_graph = None
        self.draft_counts = self.verify_counts = None
        self.timing = RoundTiming(draft_k)

    def _first_round(self, dev: torch.device) -> None:
        run_on_side_stream(self._draft, dev)
        self.draft_graph, self.draft_counts, self.timing.draft_capture_ms = capture_step(
            self._draft)
        for _ in range(self.k - 1):
            self.draft_graph.replay()
        _build.add_counts(self.draft_counts, self.k - 1)
        run_on_side_stream(self._verify, dev)
        self.verify_graph, self.verify_counts, self.timing.verify_capture_ms = capture_step(
            self._verify)

    def _replayed_round(self) -> None:
        start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        start.record()
        for _ in range(self.k):
            self.draft_graph.replay()
        mid.record()
        self.verify_graph.replay()
        end.record()
        _build.add_counts(self.draft_counts, self.k)
        _build.add_counts(self.verify_counts, 1)
        self.timing.events.append((start, mid, end))

    def _run_round(self, dev: torch.device) -> None:
        if not self.graphed:
            for _ in range(self.k):
                self._draft()
            self._verify()
        elif self.draft_graph is None:
            self._first_round(dev)
        else:
            self._replayed_round()


class SpecRounds(_CapturedRounds):
    """Speculative rounds over one factor segment of ``cache``: each drafts
    ``draft_k`` tokens with the engine's draft options (``draft_kw``),
    verifies them with one exact pass at ``ql = draft_k + 1`` from the
    round's start t0, accepts the matching prefix (``n_acc``) and emits
    ``n_out = n_acc + 1`` tokens, the last the verify's own
    (``exact[n_acc]``). The verify re-appends exact K/V over the draft's
    tail rows, so after a round the tail holds what exact decoding of the
    emitted tokens writes, and it is ``t0 + n_out`` rows long.

    Device state (static buffers): the round's start token, position and
    tail length; the draft steps' own token, position and tail length; the
    drafts; the verify's tokens and ``n_out``. The verify step ends by
    writing the next round's start into both. The graphs are captured at
    the segment's first round (``_CapturedRounds``). ``round`` reads
    ``n_out`` and the tokens on the host once. The caller's cache keeps
    its ``tail_len`` tensor; its tail buffers are written. Every round
    needs ``draft_k + 1`` free tail rows (the caller tops the tail up and
    refactorises before that)."""

    def __init__(self, engine, cache: XKVCache, token: torch.Tensor, pos, draft_k: int):
        refuse_mesh(engine, "SpecRounds")
        dev = cache.tail_k.device
        self.engine = engine
        self._init_rounds(draft_k, dev)
        self.cache = dataclasses.replace(cache, tail_len=cache.tail_len.clone())
        self.pos = position_tensor(pos, dev).clone()
        self.token = token.to(dev, torch.long).reshape(1, 1).clone()
        self.draft_len = self.cache.tail_len.clone()
        self.draft_pos = self.pos.clone()
        self.draft_token = self.token.clone()
        self.slot = torch.zeros((1,), dtype=torch.long, device=dev)
        self.drafts = torch.zeros((1, draft_k), dtype=torch.long, device=dev)
        # n_out, then the verify's k + 1 tokens: read on the host at once.
        self.result = torch.zeros((draft_k + 2,), dtype=torch.long, device=dev)

    def _draft(self) -> None:
        # The round's room was checked for all its rows (``round``).
        step_cache = dataclasses.replace(self.cache, tail_len=self.draft_len)
        logits, stepped = self.engine.step(step_cache, self.draft_token, self.draft_pos,
                                           self.engine.draft_kw)
        nxt = logits[:, -1].argmax(dim=-1)[:, None]
        self.draft_token.copy_(nxt)
        self.drafts.index_copy_(1, self.slot, nxt)
        self.draft_len.copy_(stepped.tail_len)
        self.draft_pos.add_(1)
        self.slot.add_(1)

    def _verify(self) -> None:
        k = self.k
        inputs = torch.cat([self.token, self.drafts], dim=1)
        logits, _ = self.engine.step(self.cache, inputs, self.pos, {})
        exact = logits.argmax(dim=-1)  # (1, k + 1)
        n_acc = (self.drafts == exact[:, :k]).long().cumprod(dim=1).sum(dim=1)  # (1,)
        n_out = n_acc + 1
        self.result[:1].copy_(n_out)
        self.result[1:].copy_(exact[0])
        # The next round's start, for both steps.
        self.cache.tail_len.add_(n_out[0].to(self.cache.tail_len.dtype))
        self.pos.add_(n_out[0])
        self.token.copy_(exact.gather(1, n_acc[:, None]))
        self.draft_len.copy_(self.cache.tail_len)
        self.draft_pos.copy_(self.pos)
        self.draft_token.copy_(self.token)
        self.slot.zero_()

    def round(self) -> List[int]:
        """One round; returns its ``n_out`` tokens (host ints) and moves the
        cache's host ``tail_count`` by as many."""
        if self.cache.tail_count + self.k + 1 > self.cache.tail_max:
            raise ValueError(f"tail overflow: {self.cache.tail_count} + {self.k + 1} > "
                             f"{self.cache.tail_max}")
        self._run_round(self.pos.device)
        res = self.result.tolist()
        n = res[0]
        self.cache = dataclasses.replace(self.cache, tail_count=self.cache.tail_count + n)
        self.timing.emitted.append(n)
        return res[1:1 + n]

    def close(self) -> Tuple[torch.Tensor, XKVCache]:
        """(the next round's start token (1, 1), the cache); frees the graphs."""
        self.draft_graph = self.verify_graph = None
        return self.token, self.cache


class BatchedStep:
    """The decode step of every slot of a ``BatchedEngine``, captured once
    (the JAX engine's ``self._step_jit``). The slot cache has static
    shapes, and admission, insertion and refolds write into it in place,
    so one capture serves the engine's whole life.

    Device buffers: ``inputs`` (4, B) int64, the rows token, position,
    prefill length and tail length of each slot, copied in from the
    host's numpy twins once a step (``load``); ``next_tok`` (B,), the
    step's greedy tokens, read by the host once a step (``run``): that
    read is the step's one sync. On CUDA the first ``run`` is the
    warm-up step, eager on a side stream, and then captures the step;
    every later ``run`` replays it, timed by CUDA events. A capture that
    fails raises. On the CPU every ``run`` is the eager step. A mesh is
    refused (``refuse_mesh``)."""

    def __init__(self, engine):
        refuse_mesh(engine, "BatchedStep")
        dev = engine.device
        B = engine.num_slots
        self.engine = engine
        self.graphed = dev.type == "cuda"
        self.inputs = torch.zeros((4, B), dtype=torch.long, device=dev)
        self._staged = torch.zeros((4, B), dtype=torch.long,
                                   pin_memory=dev.type == "cuda")
        self.next_tok = torch.zeros((B,), dtype=torch.long, device=dev)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.counts: Optional[dict] = None
        self.capture_ms: Optional[float] = None
        self.steps = 0
        # (start, end) CUDA events around each replay.
        self.events: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []

    def load(self, token, pos, prefill_len, tail_len) -> None:
        """Copy the host's (B,) arrays into the step's input buffer."""
        for row, arr in zip(self._staged, (token, pos, prefill_len, tail_len)):
            row.copy_(torch.as_tensor(arr))
        self.inputs.copy_(self._staged, non_blocking=True)

    def _body(self) -> None:
        token, pos, prefill_len, tail_len = self.inputs
        logits = self.engine.step_logits(token, pos, prefill_len, tail_len)
        self.next_tok.copy_(logits.argmax(dim=-1))

    def run_eager(self) -> np.ndarray:
        """The step on the loaded inputs, eagerly; its tokens (B,)."""
        self._body()
        return self.next_tok.cpu().numpy()

    def run(self) -> np.ndarray:
        """The step on the loaded inputs; its tokens (B,) on the host."""
        self.steps += 1
        if not self.graphed:
            return self.run_eager()
        if self.graph is None:
            run_on_side_stream(self._body, self.inputs.device)
            self.graph, self.counts, self.capture_ms = capture_step(self._body)
        else:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            self.graph.replay()
            end.record()
            _build.add_counts(self.counts)
            self.events.append((start, end))
        return self.next_tok.cpu().numpy()

    def replay_ms(self) -> Tuple[float, int]:
        """(device ms summed over the replays, their number)."""
        if not self.events:
            return 0.0, 0
        self.events[-1][1].synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events), len(self.events)


class BatchedSpecRound(_CapturedRounds):
    """One batched speculative round of a ``BatchedEngine`` (the JAX
    engine's ``_spec_step_jit``): every slot drafts ``speculative_k``
    tokens with the engine's draft options, one exact pass at ``ql = k +
    1`` verifies every slot's drafts, and each slot accepts its own
    matching prefix: ``n_out = n_acc + 1`` tokens, the last the verify's
    own. The verify re-appends exact K/V over each slot's tail rows [t0,
    t0 + k + 1), so a slot's tail holds what exact decoding of its emitted
    tokens writes.

    Device buffers: ``state`` (7, B) int64, the rows token, position,
    prefill length and tail length of each slot at the round's start, then
    the draft steps' own token, position and tail length, which the drafts
    move on the device; the drafts (B, k); ``result`` (B, k + 2), each
    slot's ``n_out`` and the verify's k + 1 tokens, read by the host once
    a round (``run``). ``load`` copies the host's round start in. The slot
    cache has static shapes and is written only in place, so the draft
    and the verify step are captured once per engine, at its first round
    (``_CapturedRounds``), and replayed by every later one. A capture that
    fails raises. On the CPU every round runs eagerly. A mesh is refused
    (``refuse_mesh``)."""

    def __init__(self, engine):
        refuse_mesh(engine, "BatchedSpecRound")
        dev = engine.device
        B, k = engine.num_slots, engine.speculative_k
        self.engine = engine
        self._init_rounds(k, dev)
        self.state = torch.zeros((7, B), dtype=torch.long, device=dev)
        self._staged = torch.zeros((7, B), dtype=torch.long, pin_memory=dev.type == "cuda")
        self.slot = torch.zeros((1,), dtype=torch.long, device=dev)
        self.drafts = torch.zeros((B, k), dtype=torch.long, device=dev)
        self.result = torch.zeros((B, k + 2), dtype=torch.long, device=dev)

    def load(self, token, pos, prefill_len, tail_len) -> None:
        """Copy the host's (B,) round start into the state buffer; the
        drafts start from it."""
        for row, arr in zip(self._staged, (token, pos, prefill_len, tail_len, token, pos,
                                            tail_len)):
            row.copy_(torch.as_tensor(arr))
        self.state.copy_(self._staged, non_blocking=True)
        self.slot.zero_()

    def _draft(self) -> None:
        tok, pos, tail = self.state[4], self.state[5], self.state[6]
        logits = self.engine.step_logits(tok, pos, self.state[2], tail, self.engine.draft_kw)
        nxt = logits.argmax(dim=-1)
        tok.copy_(nxt)
        self.drafts.index_copy_(1, self.slot, nxt[:, None])
        pos.add_(1)
        tail.add_(1)
        self.slot.add_(1)

    def _verify(self) -> None:
        token, pos, prefill_len, tail_len = self.state[:4]
        inputs = torch.cat([token[:, None], self.drafts], dim=1)  # (B, k + 1)
        exact = self.engine.step_logits(inputs, pos, prefill_len, tail_len, {}).argmax(dim=-1)
        n_acc = (self.drafts == exact[:, :self.k]).long().cumprod(dim=1).sum(dim=1)
        self.result[:, 0].copy_(n_acc + 1)
        self.result[:, 1:].copy_(exact)

    def run(self) -> Tuple[np.ndarray, np.ndarray]:
        """The round from the loaded start; (n_out (B,), the verify's
        tokens (B, k + 1)) on the host."""
        self._run_round(self.state.device)
        res = self.result.cpu().numpy()
        return res[:, 0], res[:, 1:]
