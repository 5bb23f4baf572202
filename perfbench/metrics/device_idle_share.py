"""device_idle_share: the share of the stages' unprofiled time in which
no operation ran on the device.

Each traced slice gives the device's busy time a step (the union of its
kernel, copy and fill intervals, over the slice's steps); the window's
``search.chunk`` spans of the same engine give the stage's steps and
their wall time, which no profiler stretches.  The share is
1 - sum(busy a step x the window's steps) / sum(the window's chunk time),
over the stages the slices cover: each stage weighs by its share of the
window's time.  The driver's time between chunks (``driver_ms``) is not
in it.  The profiler's timestamps lengthen short kernels a little, so
the busy time is an upper bound and the share a lower bound of the idle
share without the profiler.
"""


def read(run):
    busy = wall = 0.0
    chunks = [c for _, cs in run.search_spans() for c in cs]
    for s in run.slices:
        own = [c for c in chunks
               if c.get("attrs", {}).get("engine") == s.engine]
        steps = sum(int(c["attrs"]["steps"]) for c in own)
        if steps and s.steps > 0:
            busy += s.busy_s / s.steps * steps
            wall += sum(c["dur_us"] for c in own) * 1e-6
    return 100.0 * (1.0 - busy / wall) if wall > 0 else None
