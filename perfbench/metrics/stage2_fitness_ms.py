"""stage2_fitness_ms: host ms a stage-2 (local GA) generation spends in
its fitness call (decoding the population and launching the cost
kernel), from the ``fitness_us`` counters of the ``search.chunk`` spans
tagged ``engine="local_ga"``, over those chunks' generations."""


def read(run):
    chunks = [c for _, cs in run.search_spans() for c in cs
              if c.get("attrs", {}).get("engine") == "local_ga"
              and "fitness_us" in c["attrs"]]
    steps = sum(int(c["attrs"]["steps"]) for c in chunks)
    return (sum(c["attrs"]["fitness_us"] for c in chunks) / steps / 1e3
            if steps else None)
