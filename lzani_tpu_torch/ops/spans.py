"""Spans of one ``all2all_cuda`` call: intervals of the engine's main
thread, of its replay pool and of each work unit's stages on the device,
all in ``time.perf_counter()`` seconds; or of one ``all2all_jax`` call
(the automaton backend), whose work unit is a reference row.

A span is a tuple ``(name, unit, t0, t1, thread)``. `unit` is the work
unit's index (the row's, in ``all2all_jax``), shared by every span of
that unit, and None for the engine's own spans. `thread` is the name of
the host thread that ran the span, or the device's name (``"cuda:0"``)
for a device span.

Device spans come from pairs of timing CUDA events recorded on the
device's current stream around a stage. One anchor per device puts them
on the host's clock: an event recorded on the drained stream between two
host clock reads, taken as their midpoint. An event's time is the anchor
plus its elapsed time from the anchor event. The elapsed times are read
only after a sync that the engine makes anyway (``Spans.resolve``), so
recording adds no sync per unit. On the CPU no event is made and only
host spans are recorded.

``OFF`` stands for a call that records nothing: its methods do nothing,
make no event and keep no list.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

_NULL = contextlib.nullcontext()


def requested() -> bool:
    """Spans are recorded while a torch profiler is recording: a plain
    module flag that ``torch.profiler.profile`` sets (private to torch;
    ``tests/test_torch_spans.py`` fails if it goes away)."""
    return bool(getattr(torch.autograd.profiler, "_is_profiler_enabled",
                        False))


class Spans:
    """The span list of one call (``spans``) and its devices' anchors."""

    def __init__(self):
        self.spans: list[tuple] = []
        self._anchor: dict = {}      # device -> (anchor event, its time)
        self._pending: dict = {}     # device -> [(name, unit, ev0, ev1)]

    def host(self, name: str, unit, t0: float, t1: float | None = None):
        """Record [t0, t1) on the calling thread (t1 None: now); returns
        t1."""
        if t1 is None:
            t1 = time.perf_counter()
        self.spans.append((name, unit, t0, t1,
                           threading.current_thread().name))
        return t1

    def anchor(self, devices) -> None:
        """One anchor per CUDA device among `devices` (one sync each)."""
        for dev in dict.fromkeys(devices):
            if dev.type != "cuda" or dev in self._anchor:
                continue
            stream = torch.cuda.current_stream(dev)
            stream.synchronize()
            ev = torch.cuda.Event(enable_timing=True)
            t_a = time.perf_counter()
            ev.record(stream)
            ev.synchronize()
            t_b = time.perf_counter()
            self._anchor[dev] = (ev, 0.5 * (t_a + t_b))
            self._pending[dev] = []

    def _event(self, dev):
        """A timing event recorded now on `dev`'s current stream, or None
        where `dev` has no anchor (the CPU)."""
        if dev not in self._anchor:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(dev))
        return ev

    def resolve(self, dev) -> None:
        """Put the device stages recorded on `dev` on the host's clock.
        Call it after a sync of `dev`'s stream that followed them."""
        todo = self._pending.get(dev)
        if not todo:
            return
        ev_a, t_a = self._anchor[dev]
        for name, unit, ev0, ev1 in todo:
            self.spans.append((name, unit,
                               t_a + 1e-3 * ev_a.elapsed_time(ev0),
                               t_a + 1e-3 * ev_a.elapsed_time(ev1),
                               str(dev)))
        todo.clear()


class UnitSpans:
    """The spans of work unit `k` on device `dev`; the engine passes one
    down to the index build, the prep, the launch and the download."""

    __slots__ = ("sp", "k", "dev", "own")

    def __init__(self, sp: Spans, k: int, dev):
        self.sp, self.k, self.dev = sp, k, dev
        #: the event recorded right after the unit's kernel launch
        self.own = None

    def host(self, name: str, t0: float, t1: float | None = None):
        return self.sp.host(name, self.k, t0, t1)

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span of the block."""
        t0 = time.perf_counter()
        yield
        self.sp.host(name, self.k, t0)

    @contextlib.contextmanager
    def stage(self, name: str):
        """A device span of the work the block queues on the unit's
        device (nothing on the CPU)."""
        ev0 = self.sp._event(self.dev)
        yield
        if ev0 is not None:
            ev1 = self.sp._event(self.dev)
            self.sp._pending[self.dev].append((name, self.k, ev0, ev1))
            if name == "dev.kernel":
                self.own = ev1

    def wait_own(self, t0: float) -> float:
        """Wait for the unit's own kernel (on a card), recording the wait
        from `t0` as ``unit.sync_own``; returns when the wait ended (`t0`
        where there is nothing to wait on)."""
        if self.own is None:
            return t0
        self.own.synchronize()
        return self.sp.host("unit.sync_own", self.k, t0)

    def resolve(self) -> None:
        """``Spans.resolve`` of the unit's device: call it after the
        unit's download, whose copy synchronised the stream."""
        self.sp.resolve(self.dev)

    def queue(self, t_submit: float, t0: float) -> None:
        """The unit's wait in the replay pool's queue, from its submission
        to the start of its task on a pool thread (``unit.queue``)."""
        self.sp.host("unit.queue", self.k, t_submit, t0)

    def replay(self, t0: float, t1: float) -> None:
        """The unit's native replay call on its pool thread, from the end
        of its ``unit.queue`` (``unit.replay``)."""
        self.sp.host("unit.replay", self.k, t0, t1)


class _Off:
    """A unit whose spans are not recorded."""

    queue = replay = None

    def host(self, name, t0, t1=None):
        pass

    def span(self, name):
        return _NULL

    stage = span

    def wait_own(self, t0):
        return t0

    def resolve(self):
        pass


OFF = _Off()
