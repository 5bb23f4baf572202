"""The shapes a cell's searches run at, from its configuration and mix:
what the metrics reckon operations and bytes from."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Shapes:
    layers: int          # N, rollout steps an episode
    episodes: int        # E, the batch of every policy and rollout call
    obs_dim: int         # I
    hidden: int          # H
    levels: int          # L, outputs of each action head
    heads: int           # 2, or 3 where the policy also picks the dataflow
    population: int      # the stage-2 GA's population


def of(cell) -> Shapes:
    cfg, opts = cell.config, cell.traffic["options"]
    mix = bool(cfg["env"].get("mix", False))
    return Shapes(
        layers=len(cfg["layers"]),
        episodes=int(opts.get("episodes_per_epoch", 1)),
        obs_dim=11 if mix else 10,
        hidden=int(cfg["policy"].get("hidden", 128)),
        levels=int(cfg["env"]["levels"]),
        heads=3 if mix else 2,
        population=int(opts.get("ga", {}).get("population", 20)))
