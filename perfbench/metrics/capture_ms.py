"""capture_ms: ms a search in CUDA-graph capture, from the
``graph.capture`` spans inside each ``search.run`` span (same thread,
inside its interval): the eager warm-up calls, the capture and the
graph's instantiation of stage 1's epoch graph.  A part of
``driver_ms``; averaged over the window's searches."""


def read(run):
    searches = [s for s in run.spans if s["name"] == "search.run"]
    inside = [c["dur_us"] for r in searches for c in run.spans
              if c["name"] == "graph.capture" and c["tid"] == r["tid"]
              and r["ts_us"] <= c["ts_us"]
              and c["ts_us"] + c["dur_us"] <= r["ts_us"] + r["dur_us"]]
    return sum(inside) / len(searches) / 1e3 if inside else None
