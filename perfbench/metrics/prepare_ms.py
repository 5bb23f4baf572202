"""prepare_ms: ms a search in set-up outside the graph capture, from the
``search.prepare`` spans inside each ``search.run`` span (same thread,
inside its interval): the env's tables (``part="env"``), the policy and
its optimizer state (``"policy"``), the local GA's engine and first
population (``"ga"``).  A part of ``driver_ms``; averaged over the
window's searches."""


def read(run):
    searches = [s for s in run.spans if s["name"] == "search.run"]
    inside = [c["dur_us"] for r in searches for c in run.spans
              if c["name"] == "search.prepare" and c["tid"] == r["tid"]
              and r["ts_us"] <= c["ts_us"]
              and c["ts_us"] + c["dur_us"] <= r["ts_us"] + r["dur_us"]]
    return sum(inside) / len(searches) / 1e3 if inside else None
