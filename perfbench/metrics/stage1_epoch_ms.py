"""stage1_epoch_ms: ms a stage-1 epoch, from the ``search.chunk`` spans
tagged ``engine="reinforce"`` over their epochs.  A chunk ends with its
history read back, so it holds the epochs' device time."""


def read(run):
    chunks = [c for _, cs in run.search_spans() for c in cs
              if c.get("attrs", {}).get("engine") == "reinforce"]
    steps = sum(int(c["attrs"]["steps"]) for c in chunks)
    return sum(c["dur_us"] for c in chunks) / steps / 1e3 if steps else None
