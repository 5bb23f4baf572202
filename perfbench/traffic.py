"""The one generator of search requests: a traffic mix's parameters and a
configuration in, ``SearchRequest`` objects out.

A mix file (``traffic/<name>.json``) holds:

* ``method``, ``eps`` and ``options``: the request as a client sends it;
  the configuration adds its policy width as ``options["policy"]``;
* ``warmup``: what the set-up's search changes (``eps``, ``options``,
  ``env``), at the same shapes: an unlimited budget, say, so that a short
  stage 1 surely hands stage 2 a feasible point to warm up on;
* ``trace``: the bounded slice a traced run profiles (see
  :mod:`perfbench.trace`);
* ``checks``: the numbers of :mod:`perfbench.check` that apply.

The requests of a run are a pure function of the run's seed: search k of
a run gets ``base + k``, the warm-up ``base + WARMUP_OFFSET``.
"""
from __future__ import annotations

import copy

import numpy as np

# Seeds a run owns: [base, base + SEEDS_PER_RUN).
SEEDS_PER_RUN = 256
WARMUP_OFFSET = 192


def merge(base: dict, over: dict) -> dict:
    """``base`` updated by ``over``, dicts merged key by key."""
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def base_seed(seed: int) -> int:
    """The first of the seeds a run of ``--seed seed`` owns (any integer,
    negative or past 64 bits, maps into a generator's range)."""
    return (int(seed) % 2 ** 55) * SEEDS_PER_RUN


def search_seed(seed: int, k: int) -> int:
    if k >= WARMUP_OFFSET:
        raise ValueError(f"search {k} of a run would use a seed past the "
                         f"run's own ({WARMUP_OFFSET} a run)")
    return base_seed(seed) + k


def warmup_seed(seed: int) -> int:
    return base_seed(seed) + WARMUP_OFFSET


def request(api, config: dict, traffic: dict, seed: int, device,
            warmup: bool = False, **extra):
    """The ``SearchRequest`` of one search of ``traffic`` on ``config``;
    ``api`` is the program's ``api`` module, ``extra`` further fields
    (``on_progress``, ``progress_every``)."""
    spec = {k: traffic[k] for k in ("method", "eps", "options")}
    spec["env"] = config["env"]
    if warmup:
        spec = merge(spec, traffic.get("warmup", {}))
    options = merge(spec["options"], {"policy": config["policy"]})
    return api.SearchRequest(
        workload=np.asarray(config["layers"], np.int32),
        env=api.EnvConfig(**spec["env"]), eps=int(spec["eps"]),
        seed=int(seed), method=spec["method"], options=options,
        device=device, **extra)
