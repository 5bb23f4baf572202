"""stage2_evolve_ms: host ms a stage-2 (local GA) generation spends in
its evolve call (selection, crossover and mutation), from the
``evolve_us`` counters of the ``search.chunk`` spans tagged
``engine="local_ga"``, over those chunks' generations."""


def read(run):
    chunks = [c for _, cs in run.search_spans() for c in cs
              if c.get("attrs", {}).get("engine") == "local_ga"
              and "evolve_us" in c["attrs"]]
    steps = sum(int(c["attrs"]["steps"]) for c in chunks)
    return (sum(c["attrs"]["evolve_us"] for c in chunks) / steps / 1e3
            if steps else None)
