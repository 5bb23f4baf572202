"""ConfuciuX two-stage orchestration (Fig. 3): RL global search -> GA local
fine-tune, plus the LS per-layer analysis of SIV-B.

Port of ``repro.core.search``: ``confuciux_search``, ``per_layer_optima``,
Fig. 5's ``heuristic_a`` / ``heuristic_b``, and the scalarized frontier
sweep NSGA-II is measured against.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core import env as env_lib
from repro_torch.core import ga as ga_lib
from repro_torch.core import policy as policy_lib
from repro_torch.core import reinforce
from repro_torch.costmodel import workloads as workloads_lib
from repro_torch.kernels import ops as kops


@dataclasses.dataclass
class SearchResult:
    best_value: float                 # objective after both stages
    stage1_value: float               # after global RL search
    initial_valid_value: float        # first feasible value seen (Table VII)
    pe: np.ndarray                    # (N,) raw per-layer PE assignment
    kt: np.ndarray                    # (N,) raw per-layer tile counts
    df: np.ndarray                    # (N,) per-layer dataflow style
    history: Dict[str, np.ndarray]    # stage-1 convergence traces
    ga_history: np.ndarray            # stage-2 best-so-far trace
    wall_seconds: float
    epochs: int
    stage1_pe: np.ndarray             # (N,) stage 1's assignment, where
    stage1_kt: np.ndarray             # stage 2 starts
    stage1_df: np.ndarray


def _np(t):
    return t.detach().cpu().numpy()


def confuciux_search(workload, ecfg: env_lib.EnvConfig,
                     rcfg: reinforce.ReinforceConfig = None,
                     gcfg: ga_lib.LocalGAConfig = None,
                     pcfg: policy_lib.PolicyConfig = None,
                     fine_tune: bool = True,
                     chunk: int = 500,
                     on_chunk=None,
                     ga_chunk: Optional[int] = None,
                     ga_on_chunk=None,
                     device="cuda") -> SearchResult:
    """Run the full two-stage ConfuciuX pipeline on a workload.

    chunk / on_chunk stream stage-1 progress; ga_chunk / ga_on_chunk do the
    same for the stage-2 local-GA fine-tune.
    """
    if isinstance(workload, str):
        workload = workloads_lib.get_workload(workload)
    rcfg = rcfg or reinforce.ReinforceConfig()
    gcfg = gcfg or ga_lib.LocalGAConfig()
    t0 = time.time()

    env = env_lib.make_env(workload, ecfg, device)
    state, hist = reinforce.run_search(workload, ecfg, rcfg, pcfg,
                                       chunk=chunk, on_chunk=on_chunk,
                                       env=env)
    pe1, kt1, df1 = (_np(a) for a in reinforce.solution_arrays(state, env))
    stage1 = float(state.best_value)
    finite = hist["best_value"][np.isfinite(hist["best_value"])]
    initial_valid = float(finite[0]) if len(finite) else float("inf")

    pe, kt, df, best = pe1, kt1, df1, stage1
    ga_hist = np.asarray([])
    if fine_tune and np.isfinite(stage1):
        ga_state, ga_hist = ga_lib.run_local_ga(
            workload, ecfg, pe1, kt1, df1, gcfg, chunk=ga_chunk,
            on_chunk=ga_on_chunk, env=env)
        if float(ga_state.best_val) < stage1:
            genome = _np(ga_state.best_genome).astype(np.float32)
            pe, kt, best = genome[..., 0], genome[..., 1], float(
                ga_state.best_val)

    return SearchResult(
        best_value=best, stage1_value=stage1,
        initial_valid_value=initial_valid,
        pe=pe, kt=kt, df=df, history=hist, ga_history=np.asarray(ga_hist),
        wall_seconds=time.time() - t0, epochs=rcfg.epochs,
        stage1_pe=pe1, stage1_kt=kt1, stage1_df=df1)


def per_layer_optima(workload, ecfg: env_lib.EnvConfig, device="cuda"):
    """SIV-B LS study: the full (L x L) action-pair sweep for every layer.

    Returns dict with the (N, L, L) latency/energy/area grids and per-layer
    argmin pairs -- the data behind Fig. 5's heatmaps.  One cost-kernel
    launch at (L*L, N) evaluates all N * L * L cells.
    """
    if isinstance(workload, str):
        workload = workloads_lib.get_workload(workload)
    env = env_lib.make_env(workload, ecfg, device)
    N = env.num_layers
    L = ecfg.levels
    pe_g, kt_g = torch.meshgrid(env.pe_table, env.kt_table, indexing="ij")
    # (L*L, N) design batch: same pair applied to each layer independently.
    pe = pe_g.reshape(-1, 1).expand(L * L, N)
    kt = kt_g.reshape(-1, 1).expand(L * L, N)
    lat, en, area, _ = kops.table_cost(env.layers_t, pe, kt,
                                       float(ecfg.dataflow))
    grid = lambda a: _np(a).reshape(L, L, N).transpose(2, 0, 1)
    lat, en, area = grid(lat), grid(en), grid(area)
    feasible = area <= float(env.budget)
    masked_lat = np.where(feasible, lat, np.inf)
    masked_en = np.where(feasible, en, np.inf)
    opt_lat = np.array([np.unravel_index(np.argmin(m), m.shape)
                        for m in masked_lat])
    opt_en = np.array([np.unravel_index(np.argmin(m), m.shape)
                       for m in masked_en])
    return {"latency": lat, "energy": en, "area": area,
            "optima_latency": opt_lat, "optima_energy": opt_en,
            "pe_table": _np(env.pe_table), "kt_table": _np(env.kt_table)}


def heuristic_a(workload, ecfg: env_lib.EnvConfig,
                device="cuda") -> Dict[str, Any]:
    """Fig. 5 'Heuristic A': tune on the most compute-intensive layer, apply
    that (PE, Buf) pair to every layer."""
    if isinstance(workload, str):
        workload = workloads_lib.get_workload(workload)
    grids = per_layer_optima(workload, ecfg, device)
    hot = int(np.argmax([l.macs() for l in workload]))
    key = "optima_latency" if ecfg.objective == "latency" else "optima_energy"
    pi, ki = grids[key][hot]
    env = env_lib.make_env(workload, ecfg, device)
    N = env.num_layers
    pe = env.pe_table[pi].expand(N)
    kt = env.kt_table[ki].expand(N)
    perf, _, feas = env_lib.genome_cost(env, ecfg, pe, kt,
                                        float(ecfg.dataflow))
    return {"value": float(perf) if bool(feas) else float("inf"),
            "pe": _np(pe), "kt": _np(kt), "hot_layer": hot}


def heuristic_b(workload, ecfg: env_lib.EnvConfig,
                device="cuda") -> Dict[str, Any]:
    """Fig. 5 'Heuristic B': the single uniform (PE, Buf) pair that optimizes
    the end-to-end whole-model objective (one cost-kernel launch at
    (L*L, N))."""
    if isinstance(workload, str):
        workload = workloads_lib.get_workload(workload)
    env = env_lib.make_env(workload, ecfg, device)
    N = env.num_layers
    L = ecfg.levels
    pe_g, kt_g = torch.meshgrid(env.pe_table, env.kt_table, indexing="ij")
    pe = pe_g.reshape(-1, 1).expand(L * L, N)
    kt = kt_g.reshape(-1, 1).expand(L * L, N)
    perf, _, feas = env_lib.genome_cost(env, ecfg, pe, kt,
                                        float(ecfg.dataflow))
    fit = _np(torch.where(feas, perf, torch.inf))
    i = int(fit.argmin())
    return {"value": float(fit[i]), "pe": _np(pe[i]), "kt": _np(kt[i])}


def scalarized_frontier_sweep(workload, ecfg: env_lib.EnvConfig,
                              eps: int, weights=(0.0, 0.25, 0.5, 0.75, 1.0),
                              method: str = "ga", seed: int = 0,
                              options: Optional[Dict[str, Any]] = None,
                              device="cuda"):
    """Approximate the latency-energy frontier with k scalarized searches.

    The eval budget is split across ``len(weights)`` single-objective runs
    of ``method`` on ``device``, each minimizing ``lat^w * en^(1-w)`` (a
    weighted sum in log space: every minimizer is Pareto-optimal); the
    feasible (lat, en, area, pw) points the winners realize are collected.
    This is the baseline NSGA-II is scored against at equal budget.

    Returns ``{"points": (k', 4) array, "weights", "outcomes"}`` with one
    row per feasible winner (k' <= k).
    """
    from repro_torch import api   # lazy: the api imports this module

    if isinstance(workload, str):
        workload = workloads_lib.get_workload(workload)
    env = env_lib.make_env(workload, ecfg, device)
    per_run = max(eps // len(weights), 1)
    points, outcomes = [], []
    for w in weights:
        wcfg = dataclasses.replace(ecfg, objective="blend", blend_weight=w)
        out = api.run_search(api.SearchRequest(
            workload=workload, env=wcfg, eps=per_run, seed=seed,
            method=method, options=dict(options or {}), device=device))
        outcomes.append(out)
        if not out.feasible:
            continue
        tl, te, ta, tp, feas = env_lib.genome_costs_multi(
            env, wcfg, out.pe, out.kt, out.df)
        if bool(feas):
            points.append([float(tl), float(te), float(ta), float(tp)])
    pts = (np.asarray(points, np.float64) if points
           else np.empty((0, 4), np.float64))
    return {"points": pts, "weights": list(weights), "outcomes": outcomes}
