"""driver_ms: the API and two-stage driver's self time a search: each
``search.run`` span less the ``search.chunk`` spans inside it (env
building, ``EpochRunner`` construction and graph capture, the outcome),
averaged over the window's searches."""


def read(run):
    searches = run.search_spans()
    if not searches:
        return None
    self_us = sum(r["dur_us"] - sum(c["dur_us"] for c in chunks)
                  for r, chunks in searches)
    return self_us / len(searches) / 1e3
