"""The interactive environment (SIII-F): workload + constraints + objective.

Port of ``repro.core.env``.  Every array of the environment is a tensor on
the search's device, so a whole rollout runs there without host syncs.

Observation (Eq. 1): O_t = (K,C,Y,X,R,S,T, A^PE_{t-1}, A^Buf_{t-1}, t),
every dimension normalized to [-1, 1]; the static 7-dim layer part is
precomputed here, the rollout appends the dynamic part.

Platform constraints (Table II): budget = frac * C_max, where C_max is the
constraint consumption of the whole model under the uniform maximum action
pair (p_12th, b_12th).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.costmodel import dataflows as dfl
from repro_torch.costmodel import maestro
from repro_torch.costmodel.layers import NUM_FIELDS, layers_to_array
from repro_torch.kernels import ops
from repro_torch.obs import trace as obs_trace

PLATFORM_FRACTIONS = {
    "unlimited": float("inf"),
    "cloud": 0.50,
    "iot": 0.10,
    "iotx": 0.05,
}

# "blend" scalarizes total_lat**w * total_en**(1-w) (w = blend_weight); it
# is whole-model only, so the per-layer RL reward path rejects it.
OBJECTIVES = ("latency", "energy", "blend")
CONSTRAINTS = ("area", "power")


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on; raises if it is missing.

    A CUDA request without a usable card raises: nothing falls back to the
    CPU.  Matrix products stay in full float32 on the card: TF32 is turned
    off for cuBLAS and cuDNN, or the LSTM's 1e-5 agreement cannot hold.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not "
                               "available; pass device='cpu' to run on the "
                               "CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static environment configuration."""

    objective: str = "latency"
    constraint: str = "area"
    platform: str = "iot"
    scenario: str = "LP"
    dataflow: int = dfl.DLA    # ignored when mix=True
    mix: bool = False
    levels: int = 12
    blend_weight: float = 0.5  # only read when objective == "blend"

    def __post_init__(self):
        if self.objective not in OBJECTIVES:
            raise ValueError(f"objective {self.objective!r}")
        if self.constraint not in CONSTRAINTS:
            raise ValueError(f"constraint {self.constraint!r}")
        if self.platform not in PLATFORM_FRACTIONS:
            raise ValueError(f"platform {self.platform!r}")
        if self.scenario not in ("LP", "LS"):
            raise ValueError(f"scenario {self.scenario!r}")
        if not 0.0 <= self.blend_weight <= 1.0:
            raise ValueError(f"blend_weight {self.blend_weight}")

    @property
    def obs_dim(self) -> int:
        return 11 if self.mix else 10


class EnvArrays(NamedTuple):
    """Environment state: tensors on one device."""

    layers: torch.Tensor      # (N, NUM_FIELDS) f32
    layers_t: torch.Tensor    # (NUM_FIELDS, N) f32 contiguous: the cost table
    static_obs: torch.Tensor  # (N, 7) normalized layer observation
    pe_table: torch.Tensor    # (L,) f32
    kt_table: torch.Tensor    # (L,) f32
    budget: torch.Tensor      # () f32 (inf for unlimited)

    @property
    def num_layers(self) -> int:
        return self.layers.shape[0]

    @property
    def device(self) -> torch.device:
        return self.layers.device


def _normalize_obs(arr: np.ndarray) -> np.ndarray:
    """Per-model max-normalization of (K,C,Y,X,R,S,type) into [-1, 1]."""
    obs = arr[:, :7].astype(np.float64)
    maxes = np.maximum(obs.max(axis=0), 1.0)
    return (2.0 * obs / maxes - 1.0).astype(np.float32)


def _layers_array(workload) -> np.ndarray:
    if isinstance(workload, (list, tuple)):
        arr = layers_to_array(workload)
    else:
        arr = np.asarray(workload)
    if arr.ndim != 2 or arr.shape[1] != NUM_FIELDS:
        raise ValueError(f"workload array must be (N, {NUM_FIELDS}), got "
                         f"{arr.shape}")
    return arr


def max_constraint(layers, cfg: EnvConfig) -> float:
    """C_max: whole-model consumption at the uniform max action (Table II).

    ``layers`` is an (N, NUM_FIELDS) tensor; the evaluation runs on its
    device, as one (1, N) batch through the cost kernel.
    """
    N = layers.shape[0]
    pe_max = float(dfl.pe_levels(cfg.levels)[-1])
    kt_max = float(dfl.kt_levels(cfg.levels)[-1])
    df = cfg.dataflow if not cfg.mix else dfl.DLA
    full = torch.full((1, N), pe_max, device=layers.device)
    lat, en, area, pw = ops.batched_cost(layers, full, kt_max, float(df))
    val = area if cfg.constraint == "area" else pw
    val = torch.sum(val, dim=-1) if cfg.scenario == "LP" else torch.amax(
        val, dim=-1)
    return float(val[0])


def make_env(workload, cfg: EnvConfig, device="cuda") -> EnvArrays:
    """Build the Env from a workload (list of LayerSpec or (N, 8) array).

    With telemetry on, one ``search.prepare`` span (``part="env"``)."""
    with obs_trace.span("search.prepare", part="env"):
        dev = resolve_device(device)
        arr = _layers_array(workload)
        layers = torch.as_tensor(arr, dtype=torch.float32, device=dev)
        frac = PLATFORM_FRACTIONS[cfg.platform]
        budget = (np.float32(np.inf) if np.isinf(frac)
                  else np.float32(frac * max_constraint(layers, cfg)))
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                        device=dev)
        return EnvArrays(
            layers=layers,
            layers_t=layers.T.contiguous(),
            static_obs=f32(_normalize_obs(arr)),
            pe_table=f32(dfl.pe_levels(cfg.levels)),
            kt_table=f32(dfl.kt_levels(cfg.levels)),
            budget=f32(budget),
        )


def layer_cost(env: EnvArrays, cfg: EnvConfig, t, pe, kt, df):
    """Per-layer (objective value, constraint consumption) at step t, by
    the model (``maestro.evaluate``) on layer t's row."""
    if cfg.objective == "blend":
        raise ValueError(
            "objective='blend' is a whole-model scalarization; the per-layer"
            " RL reward path cannot decompose it per step -- use a"
            " population/sampling method (random/grid/sa/ga/bo/relaxed) or"
            " the native multi-objective engine (nsga2) instead")
    out = maestro.evaluate(env.layers[t], pe, kt, df)
    perf = out.latency if cfg.objective == "latency" else out.energy
    cons = out.area if cfg.constraint == "area" else out.power
    return perf, cons


def action_tables(cfg: EnvConfig):
    """The (PE, tile) level tables of ``cfg.levels`` levels, as numpy."""
    return dfl.pe_levels(cfg.levels), dfl.kt_levels(cfg.levels)


def select_objective(total_lat, total_en, cfg: EnvConfig):
    """Whole-model objective from the aggregated (latency, energy) pair."""
    if cfg.objective == "latency":
        return total_lat
    if cfg.objective == "energy":
        return total_en
    w = float(np.float32(cfg.blend_weight))
    return total_lat ** w * total_en ** float(np.float32(1.0) - np.float32(w))


def aggregate_costs_multi(lat, en, area, pw, cfg: EnvConfig, budget):
    """Per-layer costs (..., N) -> whole-model
    (total_lat, total_en, total_area, total_pw, feasible).

    Objectives sum over layers; constraints sum (LP: one partition per
    layer) or max (LS: one shared design); feasible iff the configured
    constraint fits the platform budget (``total_cons <= budget``).
    """
    total_lat = torch.sum(lat, dim=-1)
    total_en = torch.sum(en, dim=-1)
    if cfg.scenario == "LP":
        total_area = torch.sum(area, dim=-1)
        total_pw = torch.sum(pw, dim=-1)
    else:
        total_area = torch.amax(area, dim=-1)
        total_pw = torch.amax(pw, dim=-1)
    total_cons = total_area if cfg.constraint == "area" else total_pw
    return total_lat, total_en, total_area, total_pw, total_cons <= budget


def stacked_costs_multi(lat, en, area, pw, cfg: EnvConfig, budget):
    """Per-layer costs (..., N) -> (..., 4) whole-model (lat, en, area, pw):
    NSGA-II's fitness, whichever kernel made the per-layer costs."""
    tl, te, ta, tp, _ = aggregate_costs_multi(lat, en, area, pw, cfg, budget)
    return torch.stack([tl, te, ta, tp], dim=-1)


def aggregate_costs(lat, en, area, pw, cfg: EnvConfig, budget):
    """Per-layer costs (..., N) -> whole-model (objective, constraint,
    feasible): the single-objective view of :func:`aggregate_costs_multi`."""
    tl, te, ta, tp, feas = aggregate_costs_multi(lat, en, area, pw, cfg,
                                                 budget)
    total_perf = select_objective(tl, te, cfg)
    total_cons = ta if cfg.constraint == "area" else tp
    return total_perf, total_cons, feas


def _per_layer_costs(env: EnvArrays, pe, kt, df):
    """Cost kernel on (..., N) assignments; returns four (..., N) tensors."""
    dev = env.device
    pe = torch.as_tensor(pe, dtype=torch.float32, device=dev)
    N = env.num_layers
    shape = torch.broadcast_shapes(pe.shape, (N,))
    flat = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev
                                     ).expand(shape).reshape(-1, N)
    outs = ops.table_cost(env.layers_t, flat(pe), flat(kt), flat(df))
    return tuple(o.reshape(shape) for o in outs)


def genome_cost(env: EnvArrays, cfg: EnvConfig, pe, kt, df):
    """Whole-model (objective, constraint, feasible) for per-layer arrays.

    pe/kt: (..., N) raw values; df: scalar or (..., N).
    """
    return aggregate_costs(*_per_layer_costs(env, pe, kt, df), cfg,
                           env.budget)


def genome_costs_multi(env: EnvArrays, cfg: EnvConfig, pe, kt, df):
    """Whole-model (total_lat, total_en, total_area, total_pw, feasible)."""
    return aggregate_costs_multi(*_per_layer_costs(env, pe, kt, df), cfg,
                                 env.budget)


def feasibility_mask(env: EnvArrays, cfg: EnvConfig, pe, kt, df):
    """(...,) bool: True where the aggregated platform constraint fits."""
    return genome_costs_multi(env, cfg, pe, kt, df)[4]
