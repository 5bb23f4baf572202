"""NSGA-II: constrained multi-objective search over (latency, energy).

Port of ``repro.core.nsga2``.  The same genome space as the baseline GA --
per-layer (PE, Buf) level indices plus the dataflow gene for MIX -- with
NSGA-II's selection machinery (Deb et al. 2002), every tensor of it on the
state's device:

  * **constrained dominance**: a lower-violation point dominates a
    higher-violation one; at equal violation (0 == feasible included)
    Pareto dominance on (total latency, total energy) decides;
  * **non-dominated sorting** by front peeling over an (M, M) dominance
    matrix.  The reference runs M iterations in a ``lax.fori_loop``; here
    the loop stops once every point has a rank (the remaining iterations
    change nothing), checking every ``FRONT_CHECK_EVERY`` iterations, since
    each check waits for the device;
  * **crowding distance** from same-front masks (no data-dependent sort),
    front boundary points at +inf;
  * a fixed-capacity **Pareto archive** of the feasible non-dominated
    points evaluated so far (objective-space dedup, one-shot crowding
    truncation), so the frontier is there at every chunk boundary.

Sorts are stable, as JAX's are, and every ranking, crowding and archive
step computes the reference's float32 values in the reference's order:
on the same costs both packages select the same indices.  Random draws
come from the state's ``torch.Generator`` through :func:`_draws`, one call
a generation; JAX threefry streams cannot be matched, so the tests replay
the reference's draws through that one function.

The engine fills the :class:`repro_torch.core.ga.GAEngine` contract with a
(P, 4) multi-cost fitness (one table-kernel launch at (P, N)), so
:func:`repro_torch.core.ga.run_chunked_engine` drives it: chunked,
resumable, and ``eval_fn``-injectable (the adapter's default, and the
search service's batcher, evaluate through the per-row kernel; the two
kernels give the same bits per point, so every path gives the same bytes).

The numpy Pareto helpers (``non_dominated_mask``, ``pareto_insert``,
``hypervolume_2d``) are the port's own copy of the reference semantics.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import env as env_lib
from repro_torch.core import ga as ga_lib
from repro_torch.costmodel import dataflows as dfl
from repro_torch.kernels import ops

_BIG = 1e30   # finite stand-in for +inf crowding in sort keys (as float32)

# Front peeling checks for an early end every this many iterations: each
# check is a host sync, each iteration a few small launches.  On one H100
# (700 W) at M = 128 (45-65 fronts), over two runs of chip_smoke.py phase
# 6c: every 16 took 2.8-4.7 ms a call (every 8 within noise of it), every
# iteration 4.3-7.8, never 7.1-8.9.
FRONT_CHECK_EVERY = 16


# ---------------------------------------------------------------------------
# Pure Pareto helpers (numpy reference semantics; minimization throughout).
# ---------------------------------------------------------------------------
def pareto_dominates(a, b) -> bool:
    """True iff point ``a`` Pareto-dominates ``b`` (<= everywhere, < once)."""
    a = np.asarray(a, float)
    b = np.asarray(b, float)
    return bool(np.all(a <= b) and np.any(a < b))


def non_dominated_mask(costs) -> np.ndarray:
    """(M, k) cost points -> (M,) bool mask of the non-dominated subset."""
    c = np.asarray(costs, float)
    if c.size == 0:
        return np.zeros((0,), bool)
    le = np.all(c[:, None, :] <= c[None, :, :], axis=-1)
    lt = np.any(c[:, None, :] < c[None, :, :], axis=-1)
    dom = le & lt                 # dom[i, j]: i dominates j
    return ~dom.any(axis=0)


def pareto_insert(front, point):
    """Insert ``point`` into a non-dominated ``front`` (list of points).

    Returns the new front: unchanged when ``point`` is dominated by -- or
    equal to -- a member; otherwise ``point`` joins and every member it
    dominates leaves.
    """
    pt = np.asarray(point, float)
    front = [np.asarray(p, float) for p in front]
    for p in front:
        if np.array_equal(p, pt) or pareto_dominates(p, pt):
            return front
    return [p for p in front if not pareto_dominates(pt, p)] + [pt]


def hypervolume_2d(points, ref) -> float:
    """Dominated hypervolume of 2-D minimization points w.r.t. ``ref``.

    Points not strictly dominating the reference point contribute nothing.
    Monotone under set union.
    """
    ref = np.asarray(ref, float)
    pts = np.asarray(points, float).reshape(-1, 2)
    pts = pts[np.all(np.isfinite(pts), axis=1)]
    pts = pts[np.all(pts < ref, axis=1)]
    if len(pts) == 0:
        return 0.0
    pts = pts[non_dominated_mask(pts)]
    order = np.argsort(pts[:, 0], kind="stable")
    pts = pts[order]                      # x ascending => y descending
    hv = 0.0
    for i, (x, y) in enumerate(pts):
        x_next = pts[i + 1, 0] if i + 1 < len(pts) else ref[0]
        hv += (x_next - x) * (ref[1] - y)
    return float(hv)


# ---------------------------------------------------------------------------
# Selection machinery (torch, on the costs' device).
# ---------------------------------------------------------------------------
def _violation(costs, cons_col: int, budget):
    """(M, 4) aggregated costs -> (M,) constraint violation (0 = feasible)."""
    cons = costs[:, cons_col]
    return torch.where(cons <= budget, 0.0, cons - budget)


def _pareto(obj):
    """(M, 2) objectives -> (M, M) bool [i, j]: i Pareto-dominates j."""
    le = (obj[:, None, :] <= obj[None, :, :]).all(-1)
    lt = (obj[:, None, :] < obj[None, :, :]).any(-1)
    return le & lt


def _constrained_dominance(costs, viol):
    """(M, 4) costs + (M,) violation -> (M, M) bool [i, j]: i dominates j.

    Strictly smaller violation dominates; equal violation (both feasible
    included) falls back to Pareto dominance on (latency, energy).
    """
    v_lt = viol[:, None] < viol[None, :]
    v_eq = viol[:, None] == viol[None, :]
    return v_lt | (v_eq & _pareto(costs[:, :2]))


def _front_ranks(dom, check_every: int = FRONT_CHECK_EVERY):
    """(M, M) dominance matrix -> (M,) front index (0 = non-dominated).

    Front peeling: at iteration r every unranked point whose dominators are
    all ranked joins front r.  A ranked point's count of unranked
    dominators is set to M + 1, and no later front dominates it, so it
    never joins again.  Constrained dominance is a strict partial order, so
    every point is ranked within M iterations; once all are, the rest of
    the reference's M iterations are no-ops, and the loop ends at the next
    check.  Counts are float32 (exact below 2**24): freeing is one
    vector-matrix product.
    """
    M = dom.shape[0]
    big = float(M + 1)
    dom_f = dom.to(torch.float32)
    rem = dom_f.sum(0)                    # unranked dominators per point
    rank = torch.full((M,), M + 1, dtype=torch.int64, device=dom.device)
    for r in range(M):
        if r and r % check_every == 0 and not bool((rem < big).any()):
            break
        front = rem == 0
        rank.masked_fill_(front, r)
        rem = rem - front.to(torch.float32) @ dom_f
        rem.masked_fill_(front, big)
    return rank


def _crowding(obj, rank):
    """(M, 2) objectives + (M,) front ranks -> (M,) crowding distance.

    A point's gap along one objective is (nearest strictly larger value) -
    (nearest strictly smaller value) within its front, over the front's
    span; front boundary points get +inf.
    """
    same = rank[:, None] == rank[None, :]
    inf = torch.tensor(torch.inf, device=obj.device)
    tiny = torch.tensor(1e-12, dtype=torch.float32, device=obj.device)
    d = torch.zeros(obj.shape[0], dtype=torch.float32, device=obj.device)
    for k in range(obj.shape[1]):
        v = obj[:, k]
        row, col = v[None, :], v[:, None]
        vmax = torch.where(same, row, -inf).amax(1)
        vmin = torch.where(same, row, inf).amin(1)
        span = torch.maximum(vmax - vmin, tiny)
        upper = torch.where(same & (row > col), row, inf).amin(1)
        lower = torch.where(same & (row < col), row, -inf).amax(1)
        interior = torch.isfinite(upper) & torch.isfinite(lower)
        d = d + torch.where(interior, (upper - lower) / span, inf)
    return d


def _finite_crowding(crowd):
    return torch.where(torch.isfinite(crowd), crowd, _BIG)


def _select_best(rank, crowd, n):
    """Indices of the n best by (rank asc, crowding desc, index asc):
    ``jnp.lexsort((-crowd, rank))`` as two stable sorts."""
    order = torch.argsort(-_finite_crowding(crowd), stable=True)
    order = order[torch.argsort(rank[order], stable=True)]
    return order[:n]


def _tournament(i, j, rank, crowd):
    """Winners of binary tournaments between candidates ``i`` and ``j``
    ((n,) each) on (rank, crowding); a full tie goes to the lower index."""
    crowd_f = _finite_crowding(crowd)
    ci, cj = crowd_f[i], crowd_f[j]
    ri, rj = rank[i], rank[j]
    i_wins = ((ri < rj) | ((ri == rj) & (ci > cj))
              | ((ri == rj) & (ci == cj) & (i <= j)))
    return torch.where(i_wins, i, j)


def _update_archive(arch_genomes, arch_costs, pop, fit, cons_col, budget):
    """Archive + newly evaluated pop -> the non-dominated feasible top-A."""
    A = arch_costs.shape[0]
    pool_g = torch.cat([arch_genomes, pop], dim=0)      # (A+P, N, genes)
    pool_c = torch.cat([arch_costs, fit], dim=0)        # (A+P, 4)
    viol = _violation(pool_c, cons_col, budget)
    valid = (viol == 0) & torch.isfinite(pool_c[:, 0])
    obj = torch.where(valid[:, None], pool_c[:, :2], torch.inf)
    dominated = (_pareto(obj) & valid[:, None]).any(0)
    # Dedup identical objective pairs (keep the lowest index).
    idx = torch.arange(obj.shape[0], device=obj.device)
    eq = (obj[:, None, :] == obj[None, :, :]).all(-1)
    dup = (eq & (idx[None, :] < idx[:, None])).any(1)
    keep = valid & ~dominated & ~dup
    # One-shot crowding truncation to A slots (rank 0 = the keepers).
    crowd = _crowding(obj, (~keep).to(torch.int64))
    score = torch.where(keep, -_finite_crowding(crowd), torch.inf)
    sel = torch.argsort(score, stable=True)[:A]
    kept = keep[sel]
    new_g = torch.where(kept[:, None, None], pool_g[sel], 0)
    new_c = torch.where(kept[:, None], pool_c[sel], torch.inf)
    return new_g, new_c


# ---------------------------------------------------------------------------
# The engine.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class NSGA2Config:
    population: int = 64
    generations: int = 50
    mutation_rate: float = 0.05
    crossover_rate: float = 0.5   # per-gene uniform-crossover swap prob
    archive: int = 128            # Pareto-archive capacity (frontier slots)
    seed: int = 0


class NSGA2State(NamedTuple):
    """Everything a resumed run needs.

    ``pop`` leads, as in :class:`~repro_torch.core.ga.GAState`: it holds
    the candidates awaiting evaluation; ``parents`` / ``parent_costs`` hold
    the current survivors (costs +inf before the first generation: the
    sentinels lose every constrained-dominance comparison against an
    evaluated point, so the first survival keeps the first population).
    """

    pop: torch.Tensor            # (P, N, genes) int64 candidates to evaluate
    parents: torch.Tensor        # (P, N, genes) int64 current survivors
    parent_costs: torch.Tensor   # (P, 4) f32 (lat, en, area, pw) aggregated
    best_val: torch.Tensor       # () f32 best feasible primary objective
    best_genome: torch.Tensor    # (N, genes) int64
    arch_genomes: torch.Tensor   # (A, N, genes) int64 Pareto archive
    arch_costs: torch.Tensor     # (A, 4) f32; +inf latency = empty slot
    generator: torch.Generator
    generation: torch.Tensor     # () int64 generations completed


class Draws(NamedTuple):
    """One generation's random draws (see :func:`_draws`)."""

    tour_a: torch.Tensor     # (2, P) candidate pairs of the first parents
    tour_b: torch.Tensor     # (2, P) ... and of the second parents
    cross: torch.Tensor      # (P, N, genes) U[0, 1): take the second parent
    mutate: torch.Tensor     # (P, N, genes) U[0, 1): replace the gene
    levels: torch.Tensor     # (P, N, genes) replacement levels in [0, L)
    dataflows: Optional[torch.Tensor]   # (P, N) in [0, 3) under MIX


def _draws(gen: torch.Generator, P: int, N: int, genes: int, levels: int,
           mix: bool) -> Draws:
    """Every random number one generation consumes, from ``gen``.

    Under MIX the dataflow gene's replacements come from [0, 3), apart from
    the level draws (the reference's ``fold_in``).
    """
    dev = gen.device
    ints = lambda hi, shape: torch.randint(0, hi, shape, generator=gen,
                                           device=dev)
    unif = lambda shape: torch.rand(shape, generator=gen, device=dev)
    return Draws(
        tour_a=ints(P, (2, P)), tour_b=ints(P, (2, P)),
        cross=unif((P, N, genes)), mutate=unif((P, N, genes)),
        levels=ints(levels, (P, N, genes)),
        dataflows=ints(dfl.NUM_DATAFLOWS, (P, N)) if mix else None)


def _multi_costs(env: env_lib.EnvArrays, ecfg: env_lib.EnvConfig,
                 pe, kt, df):
    """(P, N) raw assignment -> (P, 4) aggregated whole-model costs: one
    table-kernel launch at (P, N), then the whole-model reduction over its
    (4, P, N) block."""
    return env_lib.stacked_costs_multi(
        *ops.table_cost(env.layers_t, pe, kt, df), ecfg, env.budget)


def make_nsga2_engine(env: env_lib.EnvArrays, ecfg: env_lib.EnvConfig,
                      cfg: NSGA2Config) -> ga_lib.GAEngine:
    """NSGA-II as a :class:`~repro_torch.core.ga.GAEngine`: the same
    contract as the GAs, with a (P, 4) fitness."""
    N = env.num_layers
    P = cfg.population
    A = cfg.archive
    L = ecfg.levels
    genes = 3 if ecfg.mix else 2
    cons_col = 2 if ecfg.constraint == "area" else 3
    dev = env.device

    def decode(genome):
        pe = env.pe_table[genome[..., 0]]
        kt = env.kt_table[genome[..., 1]]
        df = (genome[..., 2].to(torch.float32) if ecfg.mix
              else float(ecfg.dataflow))
        return pe, kt, df

    def fitness(pop):
        return _multi_costs(env, ecfg, *decode(pop))     # (P, 4)

    def evolve(state: NSGA2State, fit):
        # 1. Environmental selection over parents + evaluated children.
        cand = torch.cat([state.parents, state.pop], dim=0)      # (2P, ...)
        costs = torch.cat([state.parent_costs, fit], dim=0)      # (2P, 4)
        viol = _violation(costs, cons_col, env.budget)
        rank = _front_ranks(_constrained_dominance(costs, viol))
        crowd = _crowding(costs[:, :2], rank)
        sel = _select_best(rank, crowd, P)
        parents, parent_costs = cand[sel], costs[sel]
        # 2. Scalar best-so-far: the env's primary objective over feasible
        #    children (the unified history / best_value contract).
        child_viol = _violation(fit, cons_col, env.budget)
        child_obj = env_lib.select_objective(fit[:, 0], fit[:, 1], ecfg)
        child_val = torch.where(child_viol == 0, child_obj, torch.inf)
        i_best = torch.argmin(child_val)
        better = child_val[i_best] < state.best_val
        best_val = torch.where(better, child_val[i_best], state.best_val)
        best_genome = torch.where(better, state.pop[i_best],
                                  state.best_genome)
        # 3. Pareto archive update from the newly evaluated points.
        arch_genomes, arch_costs = _update_archive(
            state.arch_genomes, state.arch_costs, state.pop, fit, cons_col,
            env.budget)
        # 4. Breed the next candidates: binary tournaments on the
        #    survivors' (rank, crowding), uniform crossover, mutation.
        d = _draws(state.generator, P, N, genes, L, ecfg.mix)
        rank_p, crowd_p = rank[sel], crowd[sel]
        pa = _tournament(d.tour_a[0], d.tour_a[1], rank_p, crowd_p)
        pb = _tournament(d.tour_b[0], d.tour_b[1], rank_p, crowd_p)
        children = torch.where(d.cross < cfg.crossover_rate, parents[pb],
                               parents[pa])
        rand = d.levels
        if ecfg.mix:
            rand = torch.cat([rand[..., :2], d.dataflows[..., None]], dim=-1)
        children = torch.where(d.mutate < cfg.mutation_rate, rand, children)
        return NSGA2State(children, parents, parent_costs, best_val,
                          best_genome, arch_genomes, arch_costs,
                          state.generator, state.generation + 1), best_val

    def init_carry(seed) -> NSGA2State:
        gen = ga_lib._generator(seed, dev)
        pop = ga_lib._randint(gen, 0, L, (P, N, genes), dev)
        if ecfg.mix:
            pop[..., 2] = ga_lib._randint(gen, 0, dfl.NUM_DATAFLOWS, (P, N),
                                          dev)
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.int64,
                                           device=dev)
        infs = lambda *shape: torch.full(shape, torch.inf, device=dev)
        return NSGA2State(
            pop=pop, parents=zeros(P, N, genes), parent_costs=infs(P, 4),
            best_val=torch.tensor(torch.inf, device=dev),
            best_genome=zeros(N, genes), arch_genomes=zeros(A, N, genes),
            arch_costs=infs(A, 4), generator=gen, generation=zeros())

    return ga_lib.GAEngine(init_carry, decode, fitness, evolve)


def run_nsga2_search(workload, ecfg: env_lib.EnvConfig,
                     cfg: NSGA2Config = NSGA2Config(),
                     state: Optional[NSGA2State] = None,
                     chunk: Optional[int] = None,
                     on_chunk=None,
                     eval_fn=None,
                     env: Optional[env_lib.EnvArrays] = None,
                     device="cuda"):
    """Chunked, resumable NSGA-II.  Returns (NSGA2State, (gens,) history).

    The lifecycle of :func:`repro_torch.core.ga.run_ga_search`: runs
    ``cfg.generations`` more generations from ``state`` (fresh when None)
    in ``chunk``-sized pieces, firing ``on_chunk(state, hist, gens_done)``
    between them; ``eval_fn(pe, kt, df) -> (P, 4) aggregated costs`` moves
    the fitness to the host (:func:`repro_torch.serving.batcher.
    make_local_costs_eval`, or the search service's batcher).  Chunk
    boundaries and the eval path never change the result.
    """
    if env is None:
        env = env_lib.make_env(workload, ecfg, device)
    engine = make_nsga2_engine(env, ecfg, cfg)
    if state is None:
        state = engine.init_carry(cfg.seed)
    return ga_lib.run_chunked_engine(engine, state, cfg.generations, chunk,
                                     on_chunk, eval_fn, engine_name="nsga2")


def frontier_points(state: NSGA2State) -> np.ndarray:
    """The archive's live frontier as an (F, 4) float array sorted by
    latency (the per-chunk snapshot of the outcome's frontier trace)."""
    costs = state.arch_costs.cpu().numpy().astype(np.float64)
    costs = costs[np.isfinite(costs[:, 0])]
    return costs[np.argsort(costs[:, 0], kind="stable")]


def nsga2_frontier(env: env_lib.EnvArrays, ecfg: env_lib.EnvConfig,
                   state: NSGA2State) -> Dict[str, np.ndarray]:
    """Decode the final archive: the non-dominated feasible designs.

    Returns arrays sorted by latency -- ``lat``/``en``/``area``/``pw`` of
    shape (F,) plus the raw per-layer assignments ``pe``/``kt``/``df`` of
    shape (F, N) that realize each point.
    """
    costs = state.arch_costs.cpu().numpy().astype(np.float64)
    genomes = state.arch_genomes.cpu().numpy()
    valid = np.isfinite(costs[:, 0])
    costs, genomes = costs[valid], genomes[valid]
    order = np.argsort(costs[:, 0], kind="stable")
    costs, genomes = costs[order], genomes[order]
    pe = env.pe_table.cpu().numpy()[genomes[..., 0]]
    kt = env.kt_table.cpu().numpy()[genomes[..., 1]]
    if ecfg.mix:
        df = genomes[..., 2].astype(np.int32)
    else:
        df = np.full(genomes.shape[:2], ecfg.dataflow, np.int32)
    return {"lat": costs[:, 0], "en": costs[:, 1], "area": costs[:, 2],
            "pw": costs[:, 3], "pe": pe, "kt": kt, "df": df}


def nsga2_solution(env: env_lib.EnvArrays, ecfg: env_lib.EnvConfig,
                   state: NSGA2State):
    """Decode the best-primary-objective genome to raw (pe, kt, df)."""
    return ga_lib.ga_solution(env, ecfg, state)
