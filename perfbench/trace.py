"""The traced slice of a run, and its reduction to device numbers.

A traced run profiles a bounded slice of one search, chosen by counts:
the search streams its progress (``progress_every`` from the mix's
``trace``), and each chunk the engine finishes calls back once.  A slice
``{"phase", "engine", "start_after", "callbacks", "steps"}`` starts
``torch.profiler`` in the ``start_after``-th call and stops it
``callbacks`` calls later; ``steps`` is the number of epochs or
generations in between, and ``engine`` the tag of the ``search.chunk``
spans that run the same steps unprofiled in the window.  Each call comes
after the chunk's history has been read back, so the device is idle at
both ends of a slice.

From each slice: the wall time between start and stop (host clock), the
kernels' time and count by name, the union of the device's intervals
(kernels, copies and fills: the time at least one ran), and the idle
gaps labelled by the outermost host operation the profiler saw over
each gap's middle.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Dict, List, Tuple


@dataclasses.dataclass
class Slice:
    phase: str
    engine: str
    steps: int
    wall_s: float
    busy_s: float
    kernels: Dict[str, Tuple[int, float]]   # name -> (count, seconds)
    gaps: Dict[str, float]                   # host label -> idle seconds


def merged(spans):
    """Sorted (start, end) intervals merged where they overlap (the union
    ``chip_smoke.py``'s ``_span_union`` measures)."""
    out = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _events(prof):
    """(is_device, name, start_ns, end_ns) of every event of a trace."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        yield e.device_type() == cuda, e.name(), s, s + e.duration_ns()


def reduce_slice(phase: str, engine: str, steps: int, wall_s: float,
                 prof) -> Slice:
    dev, host, kernels = [], [], {}
    for is_dev, name, s, e in _events(prof):
        if is_dev:
            dev.append((s, e))
            n, t = kernels.get(name, (0, 0.0))
            kernels[name] = (n + 1, t + (e - s) * 1e-9)
        else:
            host.append((s, e, name))
    dev.sort()
    busy = merged(dev)
    gaps: Dict[str, float] = {}
    host.sort()
    # A sweep over the gaps' middles (increasing): the host operations
    # begun so far in a heap by length, those ended dropped from its top.
    i, heap = 0, []
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) / 2
        while i < len(host) and host[i][0] <= mid:
            s, e, name = host[i]
            heapq.heappush(heap, (s - e, e, name))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        label = f"{phase}: {heap[0][2] if heap else 'host, no profiled op'}"
        gaps[label] = gaps.get(label, 0.0) + (b - a) * 1e-9
    return Slice(phase, engine, steps, wall_s,
                 sum(b - a for a, b in busy) * 1e-9, kernels, gaps)


class SliceProfiler:
    """A progress callback that profiles the mix's slices of one search."""

    def __init__(self, slices: List[dict]):
        self.plan = sorted(slices, key=lambda s: s["start_after"])
        self.calls = 0
        self.active = None
        self.done = []

    def __call__(self, _trial) -> None:
        self.calls += 1
        if self.active is not None:
            spec, prof, t0 = self.active
            if self.calls == spec["start_after"] + spec["callbacks"]:
                wall = time.perf_counter() - t0
                prof.stop()
                self.done.append((spec, wall, prof))
                self.active = None
        if self.active is None:
            for spec in self.plan:
                if spec["start_after"] == self.calls:
                    self.active = (spec, self._start(), time.perf_counter())
                    break

    @staticmethod
    def _start():
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
        return prof

    def slices(self) -> List[Slice]:
        """The finished slices, reduced (a slice the search never reached
        is left out)."""
        return [reduce_slice(spec["phase"], spec["engine"],
                             int(spec["steps"]), wall, prof)
                for spec, wall, prof in self.done]


def top(items: Dict[str, float], n: int = 10):
    return [[k[:120], v] for k, v in sorted(items.items(),
                                             key=lambda kv: -kv[1])[:n]]


def breakdown(slices: List[Slice]) -> dict:
    ops: Dict[str, float] = {}
    gaps: Dict[str, float] = {}
    for s in slices:
        for name, (_, t) in s.kernels.items():
            ops[name] = ops.get(name, 0.0) + t
        for name, t in s.gaps.items():
            gaps[name] = gaps.get(name, 0.0) + t
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}
