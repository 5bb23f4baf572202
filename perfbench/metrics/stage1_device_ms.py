"""stage1_device_ms: the device's ms a stage-1 epoch without a profiler:
the ``device_us`` counters of the ``search.chunk`` spans tagged
``engine="reinforce"`` (each replay of the epoch graph bracketed by a
pair of CUDA events, their times summed), over those chunks' epochs.  A
bracket starts when its event reaches the device, so where the device
waited for the host it holds the graph launch's latency too: an upper
bound of the device's busy time an epoch."""


def read(run):
    chunks = [c for _, cs in run.search_spans() for c in cs
              if c.get("attrs", {}).get("engine") == "reinforce"
              and "device_us" in c["attrs"]]
    steps = sum(int(c["attrs"]["steps"]) for c in chunks)
    return (sum(c["attrs"]["device_us"] for c in chunks) / steps / 1e3
            if steps else None)
