"""Genetic algorithms: the stage-2 local fine-tuner (SIII-G) and the
general-GA baseline (SIV-A3).

Port of ``repro.core.ga`` (the in-graph path).  Both operate on genomes of
per-layer (PE, Buf) genes plus a dataflow gene for MIX.  The baseline GA
works in the coarse L-level space; the local fine-tuner works in the raw
integer space around the stage-1 solution with the paper's conservative
operators (local mutation within +-step, crossover that swaps the
(PE, Buf) pairs of two layers inside one genome).

Fitness = whole-model objective, +inf when the platform constraint is
violated; one generation is one batched cost-kernel launch at (P, N).
Sorting is stable, like ``jnp.argsort``, so the many +inf ties keep their
order.  Random draws come from a ``torch.Generator`` on the population's
device; every value of a generation stays there, and a chunk's history
goes to the host once, at its end.

The baseline GA takes an ``eval_fn(pe, kt, df) -> (P,) fitness`` that
moves the fitness half of a generation to the host (the search service
injects its cross-request batcher there): the population is decoded on
the device, handed over as numpy arrays, and its fitness comes back to the
same ``evolve``.  The loop is the same either way and draws the same
numbers in the same order, so both paths give the same bytes when the
fitness values are the same.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import chunk as chunk_lib
from repro_torch.core import env as env_lib
from repro_torch.core import graph as graph_lib
from repro_torch.costmodel import dataflows as dfl
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class GAConfig:
    population: int = 100
    generations: int = 50
    mutation_rate: float = 0.05
    crossover_rate: float = 0.05
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class LocalGAConfig:
    population: int = 20
    generations: int = 2000
    mutation_rate: float = 0.05
    crossover_rate: float = 0.2
    mutation_step: int = 4       # raw-space +-step (PE); kt uses step 1
    seed: int = 0


class GAState(NamedTuple):
    """Everything a resumed GA run needs."""

    pop: torch.Tensor             # (P, N, genes) int64
    best_val: torch.Tensor        # () f32 best feasible objective so far
    best_genome: torch.Tensor     # (N, genes) int64
    generator: torch.Generator
    generation: torch.Tensor      # () int64 generations completed


class GAEngine(NamedTuple):
    """Building blocks of one GA run: a generation is
    ``evolve(state, fitness(state.pop))``."""

    init_carry: Callable         # seed -> GAState
    decode: Callable             # genome -> (pe, kt, df) raw
    fitness: Callable            # pop -> (P,) objective-or-inf
    evolve: Callable             # (GAState, fit) -> (GAState, best_val)


def _fitness(env, ecfg, pe, kt, df):
    """(P,) objective of (P, N) assignments, +inf where infeasible."""
    lat, en, area, pw = ops.table_cost(env.layers_t, pe, kt, df)
    perf, _, feas = env_lib.aggregate_costs(lat, en, area, pw, ecfg,
                                            env.budget)
    return torch.where(feas, perf, torch.inf)


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _randint(gen, lo, hi, shape, device):
    return torch.randint(lo, hi, shape, generator=gen, device=device)


def _rand(gen, shape, device):
    return torch.rand(shape, generator=gen, device=device)


def _select(state: GAState, fit):
    """Sort by fitness (stable) and update the best-so-far."""
    order = torch.argsort(fit, stable=True)
    pop, fit = state.pop[order], fit[order]
    better = fit[0] < state.best_val
    best_val = torch.where(better, fit[0], state.best_val)
    best_genome = torch.where(better, pop[0], state.best_genome)
    return pop, best_val, best_genome


# ---------------------------------------------------------------------------
# Baseline GA (coarse level space).
# ---------------------------------------------------------------------------
def make_ga_engine(env: env_lib.EnvArrays, ecfg: env_lib.EnvConfig,
                   cfg: GAConfig) -> GAEngine:
    """The baseline GA's :class:`GAEngine` for one environment."""
    N = env.num_layers
    P = cfg.population
    L = ecfg.levels
    genes = 3 if ecfg.mix else 2
    dev = env.device

    def decode(genome):
        pe = env.pe_table[genome[..., 0]]
        kt = env.kt_table[genome[..., 1]]
        df = (genome[..., 2].to(torch.float32) if ecfg.mix
              else float(ecfg.dataflow))
        return pe, kt, df

    def fitness(pop):
        return _fitness(env, ecfg, *decode(pop))   # (P,)

    def evolve(state: GAState, fit):
        pop, best_val, best_genome = _select(state, fit)
        # Elitist half survives; children from random parent pairs.
        half = P // 2
        gen = state.generator
        pa = _randint(gen, 0, half, (P - half,), dev)
        pb = _randint(gen, 0, half, (P - half,), dev)
        cx_mask = _rand(gen, (P - half, N, genes), dev) < cfg.crossover_rate
        children = torch.where(cx_mask, pop[pb], pop[pa])
        mut_mask = _rand(gen, children.shape, dev) < cfg.mutation_rate
        rand = _randint(gen, 0, L, children.shape, dev)
        if ecfg.mix:
            rand[..., 2] = _randint(gen, 0, dfl.NUM_DATAFLOWS,
                                    children.shape[:-1], dev)
        children = torch.where(mut_mask, rand, children)
        pop = torch.cat([pop[:half], children], dim=0)
        return GAState(pop, best_val, best_genome, gen,
                       state.generation + 1), best_val

    def init_carry(seed) -> GAState:
        gen = _generator(seed, dev)
        pop = _randint(gen, 0, L, (P, N, genes), dev)
        if ecfg.mix:
            pop[..., 2] = _randint(gen, 0, dfl.NUM_DATAFLOWS, (P, N), dev)
        return GAState(pop, torch.tensor(torch.inf, device=dev),
                       torch.zeros((N, genes), dtype=torch.int64, device=dev),
                       gen, torch.zeros((), dtype=torch.int64, device=dev))

    return GAEngine(init_carry, decode, fitness, evolve)


def host_fitness(decode: Callable, eval_fn: Callable,
                 fixed_df=None) -> Callable:
    """``fitness(pop)`` through a host-side ``eval_fn(pe, kt, df) -> (P,)``.

    The population is decoded on its device; ``eval_fn`` gets numpy arrays
    (``df`` a float32 scalar when the dataflow is fixed, or ``fixed_df``
    itself when given) and its fitness goes back to the population's
    device as float32.
    """
    def as_np(v):
        return v.cpu().numpy() if torch.is_tensor(v) else np.float32(v)

    def fitness(pop):
        pe, kt, df = decode(pop)
        df = as_np(df) if fixed_df is None else fixed_df
        fit = np.asarray(eval_fn(as_np(pe), as_np(kt), df), np.float32)
        return torch.as_tensor(fit, device=pop.device)

    return fitness


def run_chunked_engine(engine: GAEngine, state: GAState, generations: int,
                       chunk: Optional[int], on_chunk, eval_fn=None,
                       fixed_df=None, engine_name: str = "ga"):
    """Chunk loop of a population engine.  Returns (state, (gens,)
    history of the best-so-far).

    Each generation is ``evolve(state, fitness(state.pop))``; with
    ``eval_fn`` the fitness goes through :func:`host_fitness`, and nothing
    else changes.  ``engine_name`` tags each chunk's telemetry: one hard
    eval per population member per generation.
    """
    fitness = (engine.fitness if eval_fn is None
               else host_fitness(engine.decode, eval_fn, fixed_df))
    pop_size = int(state.pop.shape[0])

    def run_chunk(state, n):
        hist = []
        for _ in range(n):
            state, bv = engine.evolve(state, fitness(state.pop))
            hist.append(bv)
        return state, torch.stack(hist).cpu().numpy()

    state, hist = chunk_lib.drive(state, generations, chunk, run_chunk,
                                  on_chunk, engine=engine_name,
                                  evals_per_step=pop_size)
    return state, chunk_lib.concat_hist(hist)


def run_ga_search(workload, ecfg: env_lib.EnvConfig,
                  cfg: GAConfig = GAConfig(),
                  state: Optional[GAState] = None,
                  chunk: Optional[int] = None,
                  on_chunk=None,
                  eval_fn=None,
                  env: Optional[env_lib.EnvArrays] = None,
                  device="cuda"):
    """Chunked, resumable baseline GA.  Returns (GAState, (gens,) history).

    Runs ``cfg.generations`` more generations from ``state`` (fresh run
    when None), in chunks of ``chunk`` generations (default: one chunk).
    ``eval_fn(pe, kt, df) -> (P,) fitness`` moves each generation's fitness
    to the host (see :func:`run_chunked_engine`).
    """
    if env is None:
        env = env_lib.make_env(workload, ecfg, device)
    engine = make_ga_engine(env, ecfg, cfg)
    if state is None:
        state = engine.init_carry(cfg.seed)
    return run_chunked_engine(engine, state, cfg.generations, chunk, on_chunk,
                              eval_fn)


def clone_ga_state(state: GAState) -> GAState:
    """A copy of ``state`` that shares no tensor and no generator with it."""
    gen = torch.Generator(device=state.generator.device)
    gen.set_state(state.generator.get_state())
    c = lambda t: t.detach().clone()
    return GAState(c(state.pop), c(state.best_val), c(state.best_genome), gen,
                   c(state.generation))


class GenerationRunner:
    """Generations of ``engine`` in place on ``state``, which it owns (its
    tensors and generator are the static buffers): the counterpart of
    :class:`repro_torch.core.reinforce.EpochRunner` for a GA.

    One generation (``evolve(state, fitness(state.pop))``, the in-graph
    fitness) writes the new population, best and generation count back
    into ``state`` and its best-so-far into column ``slot`` of a (1,
    capacity) history on the device, then moves ``slot`` on, modulo the
    capacity.  On the card that generation is captured once as a CUDA
    graph, after warm-up generations on a copy of the state, and
    :meth:`step` replays it; on the CPU :meth:`step` runs it eagerly.  The
    same bits as :func:`run_chunked_engine` without ``eval_fn``.
    """

    def __init__(self, engine: GAEngine, state: GAState, capacity: int):
        dev = state.pop.device
        self.engine = engine
        self.state = state
        self.hist = torch.zeros((1, max(capacity, 1)), device=dev)
        self.slot = torch.zeros((), dtype=torch.int64, device=dev)
        self.graph = None
        if dev.type == "cuda":
            scratch = clone_ga_state(state)
            scratch_hist = torch.zeros_like(self.hist)
            scratch_slot = torch.zeros_like(self.slot)
            self.graph = graph_lib.CapturedStep(
                lambda: self._generation(state, self.hist, self.slot),
                lambda: self._generation(scratch, scratch_hist,
                                         scratch_slot),
                dev, generators=(state.generator,))

    def _generation(self, state: GAState, hist, slot):
        new, best_val = self.engine.evolve(state,
                                           self.engine.fitness(state.pop))
        with torch.no_grad():
            for old, val in zip((state.pop, state.best_val,
                                 state.best_genome, state.generation),
                                (new.pop, new.best_val, new.best_genome,
                                 new.generation)):
                old.copy_(val)
            hist.index_copy_(1, slot.view(1), best_val.view(1, 1))
            torch.remainder(slot + 1, hist.shape[1], out=slot)

    def step(self):
        """One generation: a replay of the graph on the card, eager on the
        CPU."""
        if self.graph is None:
            self._generation(self.state, self.hist, self.slot)
        else:
            self.graph.replay()


class GAResult(NamedTuple):
    """A finished GA run (:func:`baseline_ga`, :func:`local_ga`)."""

    best_value: torch.Tensor      # () objective; inf if nothing feasible
    best_pe: torch.Tensor         # (N,) raw PE counts
    best_kt: torch.Tensor         # (N,) raw tile counts
    best_df: torch.Tensor         # (N,) dataflow ids
    history: torch.Tensor         # (generations,) best-so-far trace
    evals: int


def baseline_ga(workload, ecfg: env_lib.EnvConfig,
                cfg: GAConfig = GAConfig(), device="cuda") -> GAResult:
    """A whole baseline-GA run (:func:`run_ga_search`) and its best
    design, decoded to raw values."""
    env = env_lib.make_env(workload, ecfg, device)
    state, hist = run_ga_search(workload, ecfg, cfg, env=env)
    pe, kt, df = ga_solution(env, ecfg, state)
    return GAResult(state.best_val, pe, kt, df, hist,
                    cfg.population * cfg.generations)


def ga_solution(env: env_lib.EnvArrays, ecfg: env_lib.EnvConfig,
                state: GAState):
    """Decode a baseline-GA state's best genome to raw (pe, kt, df)."""
    pe = env.pe_table[state.best_genome[..., 0]]
    kt = env.kt_table[state.best_genome[..., 1]]
    df = (state.best_genome[..., 2] if ecfg.mix
          else torch.full((env.num_layers,), ecfg.dataflow,
                          dtype=torch.int64, device=env.device))
    return pe, kt, df


# ---------------------------------------------------------------------------
# Stage-2 local GA (fine-grained raw space, seeded by the RL solution).
# ---------------------------------------------------------------------------
def make_local_ga_engine(env: env_lib.EnvArrays, ecfg: env_lib.EnvConfig,
                         init_pe, init_kt, init_df,
                         cfg: LocalGAConfig) -> GAEngine:
    """The fine-tuner's :class:`GAEngine`: raw-space genomes, fixed df."""
    N = env.num_layers
    P = cfg.population
    dev = env.device
    as_i64 = lambda v: torch.as_tensor(v, device=dev).to(torch.int64)
    init_genome = torch.stack([as_i64(init_pe), as_i64(init_kt)], dim=-1)
    df = as_i64(init_df).expand(N).to(torch.float32)   # fixed in stage 2
    lo = torch.tensor([dfl.PE_MIN, dfl.KT_MIN], device=dev)
    hi = torch.tensor([dfl.PE_MAX, dfl.KT_MAX], device=dev)

    def mutate(children, gen):
        """Each gene moves by at most +-step (PE) / +-1 (kt) at the rate."""
        C = children.shape[0]
        mask = _rand(gen, children.shape, dev) < cfg.mutation_rate
        step = torch.stack([
            _randint(gen, -cfg.mutation_step, cfg.mutation_step + 1, (C, N),
                     dev),
            _randint(gen, -1, 2, (C, N), dev)], dim=-1)
        out = torch.where(mask, children + step, children)
        return torch.clamp(out, lo, hi)

    def self_crossover(children, gen):
        """Swap the (PE, Buf) pairs of two random layers (SIII-G)."""
        C = children.shape[0]
        i = _randint(gen, 0, N, (C,), dev)
        j = _randint(gen, 0, N, (C,), dev)
        do = _rand(gen, (C,), dev) < cfg.crossover_rate
        rows = torch.arange(C, device=dev)
        gi, gj = children[rows, i], children[rows, j]
        swapped = children.clone()
        swapped[rows, i] = gj
        swapped[rows, j] = gi
        return torch.where(do[:, None, None], swapped, children)

    def decode(genome):
        return (genome[..., 0].to(torch.float32),
                genome[..., 1].to(torch.float32), df)

    def fitness(pop):
        pe, kt, _ = decode(pop)
        return _fitness(env, ecfg, pe, kt, df)

    def evolve(state: GAState, fit):
        pop, best_val, best_genome = _select(state, fit)
        half = P // 2
        gen = state.generator
        parents = pop[_randint(gen, 0, half, (P - half,), dev)]
        children = mutate(self_crossover(parents, gen), gen)
        pop = torch.cat([pop[:half], children], dim=0)
        return GAState(pop, best_val, best_genome, gen,
                       state.generation + 1), best_val

    def init_carry(seed) -> GAState:
        pop = init_genome.expand(P, N, 2).clone()
        return GAState(pop, torch.tensor(torch.inf, device=dev),
                       init_genome.clone(), _generator(seed, dev),
                       torch.zeros((), dtype=torch.int64, device=dev))

    return GAEngine(init_carry, decode, fitness, evolve)


def run_local_ga(workload, ecfg: env_lib.EnvConfig,
                 init_pe, init_kt, init_df,
                 cfg: LocalGAConfig = LocalGAConfig(),
                 state: Optional[GAState] = None,
                 chunk: Optional[int] = None,
                 on_chunk=None,
                 eval_fn=None,
                 env: Optional[env_lib.EnvArrays] = None,
                 device="cuda"):
    """Chunked, resumable stage-2 fine-tune; same contract as run_ga_search.

    The dataflow assignment is frozen at ``init_df`` (stage 2 fine-tunes
    only the budget split), so ``eval_fn`` always receives that fixed array
    (``np.asarray(init_df, np.float32)``).
    """
    if env is None:
        env = env_lib.make_env(workload, ecfg, device)
    engine = make_local_ga_engine(env, ecfg, init_pe, init_kt, init_df, cfg)
    if state is None:
        state = engine.init_carry(cfg.seed)
    fixed_df = (np.asarray(torch.as_tensor(init_df).cpu(), np.float32)
                if eval_fn is not None else None)
    return run_chunked_engine(engine, state, cfg.generations, chunk, on_chunk,
                              eval_fn, fixed_df=fixed_df,
                              engine_name="local_ga")


def local_ga(workload, ecfg: env_lib.EnvConfig, init_pe, init_kt, init_df,
             cfg: LocalGAConfig = LocalGAConfig(), device="cuda") -> GAResult:
    """A whole stage-2 fine-tune (:func:`run_local_ga`) from the given
    design, and its best one (the dataflows stay ``init_df``)."""
    env = env_lib.make_env(workload, ecfg, device)
    state, hist = run_local_ga(workload, ecfg, init_pe, init_kt, init_df, cfg,
                               env=env)
    df = torch.as_tensor(init_df, dtype=torch.int64, device=env.device)
    return GAResult(state.best_val,
                    state.best_genome[..., 0].to(torch.float32),
                    state.best_genome[..., 1].to(torch.float32),
                    df, hist, cfg.population * cfg.generations)
