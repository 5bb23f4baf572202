"""Classic optimization baselines (SII-E / SIV-A3): grid, random, simulated
annealing, Bayesian optimization.

Port of ``repro.core.baselines``.  All report the best *feasible*
whole-model objective after a fixed sample budget Eps (one epoch = one
whole-model evaluation for these methods), or +inf ("NAN" in the paper's
tables) if no feasible point was found.

Evaluations run on the environment's device.  Each method takes an
``eval_fn`` that moves them elsewhere (the search service injects its
cross-request batcher); the loops draw the same numbers in the same order
either way, so a run gives the same bytes whenever the fitness values do.
Random draws come from a ``torch.Generator`` on the environment's device
(random, SA) or from ``np.random.default_rng`` (BO, as in the reference);
grid is deterministic.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import chunk as chunk_lib
from repro_torch.core import env as env_lib
from repro_torch.obs import instrument as obs_instrument


class BaselineResult(NamedTuple):
    best_value: float
    best_pe: np.ndarray
    best_kt: np.ndarray
    history: np.ndarray      # best-so-far per evaluation (Eps,)
    evals: int


def _decode_and_eval(env, ecfg, genome):
    """genome: (..., N, 2) int64 levels on the env's device ->
    (objective-or-inf, pe, kt)."""
    pe = env.pe_table[genome[..., 0]]
    kt = env.kt_table[genome[..., 1]]
    perf, _, feas = env_lib.genome_cost(env, ecfg, pe, kt, ecfg.dataflow)
    return torch.where(feas, perf, torch.inf), pe, kt


def _eval_batch_fn(env, ecfg, eval_fn):
    """The genome-batch evaluator the host-loop baselines iterate on.

    Takes (b, N, 2) int64 levels on the env's device and returns numpy
    ``(fit (b,), pe (b, N), kt (b, N))``.  ``eval_fn(genomes)``, given the
    levels as a numpy array and returning the same triple, overrides the
    built-in evaluation -- the search service injects its cross-request
    batcher here; results must be bit-identical to the default path (see
    :mod:`repro_torch.serving.batcher`).
    """
    if eval_fn is not None:
        def evaluate(genomes):
            fit, pe, kt = eval_fn(genomes.cpu().numpy())
            return np.asarray(fit), np.asarray(pe), np.asarray(kt)
    else:
        def evaluate(genomes):
            return tuple(t.cpu().numpy()
                         for t in _decode_and_eval(env, ecfg, genomes))
    return evaluate


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _levels(genomes, device):
    return torch.as_tensor(np.asarray(genomes), dtype=torch.int64,
                           device=device)


# ---------------------------------------------------------------------------
def random_search(workload, ecfg: env_lib.EnvConfig, eps: int = 5000,
                  seed: int = 0, batch: int = 512, eval_fn=None,
                  device="cuda") -> BaselineResult:
    env = env_lib.make_env(workload, ecfg, device)
    N = env.num_layers
    gen = _generator(seed, env.device)
    best, best_pe, best_kt = np.inf, None, None
    hist = []
    eval_b = _eval_batch_fn(env, ecfg, eval_fn)
    done = 0
    while done < eps:
        n = min(batch, eps - done)
        genomes = torch.randint(0, ecfg.levels, (n, N, 2), generator=gen,
                                device=env.device)
        fit, pe, kt = eval_b(genomes)
        obs_instrument.hard_evals("random", n)
        # Seed the trace with the best *before* this batch so no sample is
        # credited ahead of being drawn.
        hist.append(np.minimum(np.minimum.accumulate(fit), best))
        i = int(fit.argmin())
        if fit[i] < best:
            best, best_pe, best_kt = float(fit[i]), pe[i], kt[i]
        done += n
    return BaselineResult(best, best_pe, best_kt, np.concatenate(hist), eps)


# ---------------------------------------------------------------------------
def grid_search(workload, ecfg: env_lib.EnvConfig, eps: int = 5000,
                stride: int = 1, batch: int = 512, eval_fn=None,
                device="cuda") -> BaselineResult:
    """Lexicographic sweep with stride over the per-layer level space.

    For an N-layer model the space is L^(2N); Eps samples only scratch the
    first couple of genes (everything else pinned at level 0), which is why
    grid search performs so poorly in Table IV.
    """
    env = env_lib.make_env(workload, ecfg, device)
    N = env.num_layers
    base = int(np.ceil(ecfg.levels / stride))
    eval_b = _eval_batch_fn(env, ecfg, eval_fn)
    best, best_pe, best_kt = np.inf, None, None
    hist = []
    done = 0
    while done < eps:
        n = min(batch, eps - done)
        idx = np.arange(done, done + n, dtype=np.int64)
        digits = np.zeros((n, 2 * N), dtype=np.int32)
        rem = idx.copy()
        for d in range(2 * N):          # last gene varies fastest
            digits[:, 2 * N - 1 - d] = (rem % base) * stride
            rem //= base
            if not rem.any():
                break
        genomes = np.minimum(digits.reshape(n, N, 2), ecfg.levels - 1)
        fit, pe, kt = eval_b(_levels(genomes, env.device))
        obs_instrument.hard_evals("grid", n)
        hist.append(np.minimum(np.minimum.accumulate(fit), best))
        i = int(fit.argmin())
        if fit[i] < best:
            best, best_pe, best_kt = float(fit[i]), pe[i], kt[i]
        done += n
    return BaselineResult(best, best_pe, best_kt, np.concatenate(hist), eps)


# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SAConfig:
    temperature: float = 10.0   # the paper's setting
    step: int = 1
    decay: float = 0.999
    seed: int = 0


class SAState(NamedTuple):
    """Everything a resumed annealing run needs."""

    genome: torch.Tensor       # (N, 2) int64 levels
    cur_fit: torch.Tensor      # () f32 current point's objective-or-inf
    best_fit: torch.Tensor     # () f32 best seen
    best_genome: torch.Tensor  # (N, 2) int64
    temp: torch.Tensor         # () f32 annealing temperature
    generator: torch.Generator
    step: torch.Tensor         # () int64 annealing steps completed


class SAEngine(NamedTuple):
    """One annealing step split at the cost evaluation:
    ``accept(state, cand, eval_one(cand), u)`` with ``cand, u =
    propose(state)``.  ``propose`` draws every random number of the step,
    so a host-side ``eval_fn`` can own the evaluation without changing the
    draws."""

    init_genome: Callable     # seed -> (genome, generator)
    propose: Callable         # SAState -> (cand, u)
    accept: Callable          # (SAState, cand, cand_fit, u) ->
    #                           (SAState, best_fit)
    eval_one: Callable        # (N, 2) genome -> () fitness


def make_sa_engine(env: env_lib.EnvArrays, ecfg: env_lib.EnvConfig,
                   cfg: SAConfig) -> SAEngine:
    N = env.num_layers
    L = ecfg.levels
    dev = env.device

    def eval_one(genome):
        fit, _, _ = _decode_and_eval(env, ecfg, genome[None])
        return fit[0]

    def propose(state: SAState):
        """Move one gene by +-step; also draw the acceptance uniform."""
        gen = state.generator
        i = torch.randint(0, N, (1,), generator=gen, device=dev)
        j = torch.randint(0, 2, (1,), generator=gen, device=dev)
        r, u = torch.rand((2,), generator=gen, device=dev).unbind(0)
        delta = torch.where(r < 0.5, -cfg.step, cfg.step)
        cand = state.genome.clone()
        cand[i, j] = torch.clamp(state.genome[i, j] + delta, 0, L - 1)
        return cand, u

    def accept(state: SAState, cand, cand_fit, u):
        # Metropolis on finite fitness; +inf candidates only accepted if the
        # current point is also infeasible (pure exploration).
        d = cand_fit - state.cur_fit
        x = d / torch.clamp_min(state.cur_fit, 1.0) * 100.0 / state.temp
        prob = torch.where(d <= 0, 1.0, torch.exp(
            -torch.minimum(x, torch.full_like(x, 50.0))))
        prob = torch.where(torch.isnan(prob),
                           torch.isinf(state.cur_fit).to(prob.dtype), prob)
        take = u < prob
        better = cand_fit < state.best_fit
        best_fit = torch.where(better, cand_fit, state.best_fit)
        return SAState(
            torch.where(take, cand, state.genome),
            torch.where(take, cand_fit, state.cur_fit),
            best_fit,
            torch.where(better, cand, state.best_genome),
            state.temp * cfg.decay, state.generator,
            state.step + 1), best_fit

    def init_genome(seed):
        gen = _generator(seed, dev)
        return torch.randint(0, L, (N, 2), generator=gen, device=dev), gen

    return SAEngine(init_genome, propose, accept, eval_one)


def run_sa_search(workload, ecfg: env_lib.EnvConfig, eps: int = 5000,
                  cfg: SAConfig = SAConfig(),
                  state: Optional[SAState] = None,
                  chunk: Optional[int] = None,
                  on_chunk=None,
                  eval_fn=None,
                  env: Optional[env_lib.EnvArrays] = None,
                  device="cuda"):
    """Chunked, resumable simulated annealing.  Returns (SAState, history).

    Runs ``eps`` more annealing steps from ``state`` (fresh run when None)
    in chunks of ``chunk`` steps (default: one chunk); ``on_chunk(state,
    chunk_hist, steps_done)`` fires between chunks.  ``eval_fn(pe, kt, df)
    -> (1,) fitness`` moves the candidate evaluation to the host (numpy
    (1, N) arrays and a float32 dataflow); every step is the same
    ``propose`` -> evaluate -> ``accept`` either way.
    """
    if env is None:
        env = env_lib.make_env(workload, ecfg, device)
    engine = make_sa_engine(env, ecfg, cfg)
    dev = env.device

    if eval_fn is None:
        evaluate = engine.eval_one
    else:
        pe_table = env.pe_table.cpu().numpy()
        kt_table = env.kt_table.cpu().numpy()

        def evaluate(genome):
            g = genome.cpu().numpy()
            fit = np.asarray(eval_fn(pe_table[g[:, 0]][None],
                                     kt_table[g[:, 1]][None],
                                     np.float32(ecfg.dataflow)), np.float32)
            return torch.as_tensor(fit[0], device=dev)

    if state is None:
        genome, gen = engine.init_genome(cfg.seed)
        cur = evaluate(genome)
        state = SAState(genome, cur, cur, genome,
                        torch.tensor(cfg.temperature, dtype=torch.float32,
                                     device=dev), gen,
                        torch.zeros((), dtype=torch.int64, device=dev))

    def run_chunk(state, n):
        hist = []
        for _ in range(n):
            cand, u = engine.propose(state)
            state, bf = engine.accept(state, cand, evaluate(cand), u)
            hist.append(bf)
        return state, torch.stack(hist).cpu().numpy()

    state, hist = chunk_lib.drive(state, eps, chunk, run_chunk, on_chunk,
                                  engine="sa")
    return state, chunk_lib.concat_hist(hist)


def sa_solution(env: env_lib.EnvArrays, state: SAState):
    """Decode an SA state's best genome to raw (pe, kt) numpy arrays."""
    pe = env.pe_table[state.best_genome[:, 0]]
    kt = env.kt_table[state.best_genome[:, 1]]
    return pe.cpu().numpy(), kt.cpu().numpy()


def simulated_annealing(workload, ecfg: env_lib.EnvConfig, eps: int = 5000,
                        cfg: SAConfig = SAConfig(), eval_fn=None,
                        device="cuda") -> BaselineResult:
    env = env_lib.make_env(workload, ecfg, device)
    state, hist = run_sa_search(workload, ecfg, eps, cfg, eval_fn=eval_fn,
                                env=env)
    pe, kt = sa_solution(env, state)
    return BaselineResult(float(state.best_fit), pe, kt, hist, eps)


# ---------------------------------------------------------------------------
def bayes_opt(workload, ecfg: env_lib.EnvConfig, eps: int = 5000,
              seed: int = 0, n_candidates: int = 64, gamma: float = 0.15,
              init_random: int = 64, batch: int = 16, eval_fn=None,
              device="cuda") -> BaselineResult:
    """Tree-Parzen-Estimator Bayesian optimization (surrogate + acquisition).

    The paper uses a GP-based BO [54]; a GP over a 2N-dim discrete space with
    5000 observations is O(n^3)-infeasible here, so this is the standard TPE
    formulation (per-dimension categorical good/bad densities, expected-
    improvement-equivalent l/g acquisition).  Under IoTx the surrogate never
    observes a feasible point and the result is NAN, as in Table IV.  The
    surrogate runs in numpy on the host with the reference's draws; only
    the evaluations run on the device.
    """
    rng = np.random.default_rng(seed)
    env = env_lib.make_env(workload, ecfg, device)
    N = env.num_layers
    L = ecfg.levels
    eval_b = _eval_batch_fn(env, ecfg, eval_fn)

    X = rng.integers(0, L, size=(min(init_random, eps), N, 2)).astype(np.int32)
    fit, _, _ = eval_b(_levels(X, env.device))
    obs_instrument.hard_evals("bo", len(X))
    y = np.asarray(fit, dtype=np.float64)
    hist = list(np.minimum.accumulate(np.where(np.isinf(y), np.inf, y)))

    while len(y) < eps:
        # Rank: feasible by value, infeasible last.
        order = np.argsort(np.where(np.isfinite(y), y, np.inf))
        n_good = max(4, int(gamma * len(y)))
        good = X[order[:n_good]]
        # Per-dimension categorical densities with Laplace smoothing.
        counts = np.ones((N, 2, L))
        for g in good:
            for d in range(2):
                counts[np.arange(N), d, g[:, d]] += 1.0
        pg = counts / counts.sum(-1, keepdims=True)
        counts_all = np.ones((N, 2, L))
        for g in X[order[n_good:]][: 4 * n_good]:
            for d in range(2):
                counts_all[np.arange(N), d, g[:, d]] += 1.0
        pb = counts_all / counts_all.sum(-1, keepdims=True)

        # Sample candidates from l(x), score by l/g, evaluate the best few.
        cand = np.zeros((n_candidates, N, 2), dtype=np.int32)
        for d in range(2):
            cum = pg[:, d].cumsum(-1)
            u = rng.random((n_candidates, N, 1))
            cand[:, :, d] = (u > cum[None]).sum(-1)
        li = np.take_along_axis(pg[None], cand[..., None], axis=-1)
        gi = np.take_along_axis(pb[None], cand[..., None], axis=-1)
        score = np.log(li + 1e-12).sum((1, 2, 3)) - np.log(
            gi + 1e-12).sum((1, 2, 3))
        # Clamp the final batch to the remaining budget: the best must be
        # found within eps samples.
        pick = cand[np.argsort(-score)[:min(batch, eps - len(y))]]
        fit, _, _ = eval_b(_levels(pick, env.device))
        obs_instrument.hard_evals("bo", len(pick))
        fit = np.asarray(fit, dtype=np.float64)
        X = np.concatenate([X, pick], axis=0)
        y = np.concatenate([y, fit])
        prev_best = hist[-1] if hist else np.inf
        hist.extend(np.minimum(
            np.minimum.accumulate(fit), prev_best).tolist())

    i = int(np.argmin(np.where(np.isfinite(y), y, np.inf)))
    best = float(y[i]) if np.isfinite(y[i]) else float("inf")
    pe = env.pe_table.cpu().numpy()[X[i, :, 0]]
    kt = env.kt_table.cpu().numpy()[X[i, :, 1]]
    return BaselineResult(best, pe, kt, np.asarray(hist[:eps]), eps)
