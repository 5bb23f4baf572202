"""stage2_gen_ms: ms a stage-2 (local GA) generation, from the
``search.chunk`` spans tagged ``engine="local_ga"`` over their
generations."""


def read(run):
    chunks = [c for _, cs in run.search_spans() for c in cs
              if c.get("attrs", {}).get("engine") == "local_ga"]
    steps = sum(int(c["attrs"]["steps"]) for c in chunks)
    return sum(c["dur_us"] for c in chunks) / steps / 1e3 if steps else None
