"""Asynchronous local-mapping executor — tracking/mapping overlap.

The reference runs LocalMapping on its own thread so per-keyframe map
refinement never touches frame latency (`/root/reference/src/System.cc:138`,
`LocalMapping::Run` consuming `mlNewKeyFrames`). A thread mutating
device state underneath jitted programs is not the design here; instead the
mapping pass is SLICED: `LocalMapper`'s five stages (prepare/cull,
triangulate, fuse, local BA, maintain — the exact order of
`LocalMapping.cc:117-280`) run one per frame tick from the tracking
loop, each stage a bounded set of async device dispatches. A pass for
keyframe k therefore completes ~5 frames after k's insertion while every
frame in between pays only ~1/5 of the mapping cost — the same lag
semantics as the reference's queue (tracking reads the map as-of the
last completed mutation; `Tracking.cc:1081` map-change epochs).

At most one pass is in flight; further keyframes queue, exactly like
`mlNewKeyFrames`. `interrupt()` is `LocalMapping::InterruptBA`: the
current pass skips its local-BA stage so the queue drains faster.
Downstream consumers (loop closing, multi-map) fire when a PASS
completes — the reference's LocalMapping -> LoopClosing hand-off
(`LocalMapping.cc:280`), not at insertion time.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, List, Optional


class AsyncMapper:
    def __init__(self, mapper, downstream: Optional[List[Callable]] = None):
        self.mapper = mapper
        if not hasattr(mapper, "interrupt_ba"):
            mapper.interrupt_ba = False
        self.downstream = downstream if downstream is not None else []
        self.queue: deque = deque()
        self._cur: Optional[tuple] = None  # (kf_id, next_stage_idx)
        self.n_completed = 0
        self.n_interrupted = 0

    # -- producer side (Tracking) ---------------------------------------
    def submit(self, kf_id: int, initial: bool = False, preint=None):
        """`LocalMapping::InsertKeyFrame` (`LocalMapping.cc:336`)."""
        if preint is not None:
            # Preintegration must be recorded at insertion time — the
            # tracker resets its accumulator immediately after.
            self.mapper.preints[kf_id] = preint
        if initial:
            # Map bootstrap (initial 2-KF BA) gates tracking itself:
            # run synchronously, after draining anything outstanding.
            self.flush()
            self.mapper.process_keyframe(kf_id, initial=True)
            for d in self.downstream:
                d(kf_id)
            return
        self.queue.append(kf_id)

    def idle(self) -> bool:
        """`LocalMapping::AcceptKeyFrames` analog: nothing in flight."""
        return self._cur is None and not self.queue

    def queue_len(self) -> int:
        """`LocalMapping::KeyframesInQueue` (`LocalMapping.h:104`)."""
        return len(self.queue) + (1 if self._cur is not None else 0)

    def interrupt(self):
        """`LocalMapping::InterruptBA`: the current pass (and queued
        passes started before the next clear) skip local BA."""
        self.mapper.interrupt_ba = True
        self.n_interrupted += 1

    # -- consumer side (ticked once per tracked frame) -------------------
    def tick(self):
        """Advance the in-flight pass by ONE stage (or start the next
        queued pass). Each stage's device work is dispatched async; the
        host returns while XLA executes."""
        if self._cur is None:
            if not self.queue:
                return
            self._cur = (self.queue.popleft(), 0)
        # Normally one stage per tick; with an interrupt pending, drain the
        # pass's remaining stages NOW (its BA stage no-ops under
        # interrupt_ba) so the mapper frees up within one tick — otherwise
        # `InterruptBA` would leave Tracking's mono insert path starved for
        # the rest of the pass, which the reference's threaded mapper never
        # does (`LocalMapping.cc:InterruptBA` aborts the solve immediately).
        while True:
            kf_id, stage_idx = self._cur
            stages = self.mapper.STAGES
            stages[stage_idx](self.mapper, kf_id)
            stage_idx += 1
            if stage_idx >= len(stages):
                self._cur = None
                self.mapper.interrupt_ba = False
                self.n_completed += 1
                for d in self.downstream:
                    d(kf_id)
                return
            self._cur = (kf_id, stage_idx)
            if not self.mapper.interrupt_ba:
                return

    def flush(self):
        """Drain every queued pass (System::Shutdown / end of replay —
        the reference joins its mapping thread the same way)."""
        while not self.idle():
            self.tick()

    def abort(self):
        """Active map was reset/swapped: in-flight kf ids are stale."""
        self.queue.clear()
        self._cur = None
        self.mapper.interrupt_ba = False
