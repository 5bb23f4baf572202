"""Unified optimizer API of the PyTorch port: one registry, one schema.

    from repro_torch import api

    out = api.run_search(api.SearchRequest(
        workload="mobilenet_v2", env=api.EnvConfig(platform="iot"),
        eps=5000, method="two_stage", device="cuda"))
    print(out.best_value, out.samples_to_convergence)

Registered methods: random, grid, sa, bo (alias bayes), ga, nsga2
(pareto, moo), relaxed (oneshot, gradient), reinforce (rl, conx_global),
two_stage (conx, confuciux), a2c, ppo2 (ppo), the seed-parallel wrapper
fanout and episode-parallel dist_reinforce
(``repro_torch.distributed.dist_search``).
"""
from repro_torch.api.registry import (Optimizer, get_optimizer,
                                      list_optimizers, register, run_search)
from repro_torch.api.types import (SearchOutcome, SearchRequest, Trial,
                                   samples_to_convergence)
from repro_torch.core.env import EnvConfig

__all__ = [
    "EnvConfig",
    "Optimizer",
    "SearchOutcome",
    "SearchRequest",
    "Trial",
    "get_optimizer",
    "list_optimizers",
    "register",
    "run_search",
    "samples_to_convergence",
]
