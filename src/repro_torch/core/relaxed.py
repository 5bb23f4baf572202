"""One-shot relaxed search: gradient descent through the soft cost model.

Port of ``repro.core.relaxed``.  The discrete per-layer assignment space
(PE count, per-PE tile ``kt``, dataflow style) is relaxed to a continuous
one -- ``(pe, kt)`` become boxed reals via a sigmoid reparameterization and
the dataflow choice a softmax simplex -- and the engine descends the soft
MAESTRO twin (:func:`repro_torch.costmodel.maestro.soft_model_cost`) by
autograd, every layer's variables jointly.

Anatomy of a run (``eps`` counts whole-model *hard* evaluations):

  * ``restarts`` replicas descend the soft landscape with Adam, hand-rolled
    on the ``(R, N)``, ``(R, N)``, ``(R, N, 3)`` triple with the
    reference's bias correction; the soft objective is ``log(objective)``
    plus a softplus penalty on relative budget violation.
  * The temperature ``tau`` anneals geometrically each round.
  * Every round (``steps_per_eval`` gradient steps) the replica with the
    best soft loss is rounded to integers and scored by the *hard* model:
    the table cost kernel at (1, N) (``env.genome_cost``), or an injected
    ``eval_fn`` -- the search service's batcher, whose per-row kernel gives
    the same bits.  That score is the round's one host read.
  * The final ``topk`` budget re-scores floor/ceil rounding variants of the
    best replica's continuous point.

The descent is plain PyTorch autograd on the env's device, as the
reference's is plain ``jnp``.  The state keeps the descent (params, Adam
moments, ``tau``, gradient steps) and the best rounded assignment on that
device, and the best fitness and the evaluation count on the host, so a
round reads the device once.  A run never changes the state it was given:
``state`` resumes, ``chunk`` + ``on_chunk`` stream between chunks, and
chunk boundaries and ``eval_fn`` leave the bytes of the result alone.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import chunk as chunk_lib
from repro_torch.core import env as env_lib
from repro_torch.costmodel import dataflows as dfl
from repro_torch.costmodel import maestro
from repro_torch.costmodel import primitives as prim_lib


@dataclasses.dataclass(frozen=True)
class RelaxedConfig:
    """Knobs of the one-shot relaxed engine."""

    lr: float = 0.05               # Adam step size on the relaxed params
    steps_per_eval: int = 25       # gradient steps bought per hard probe
    restarts: int = 4              # parallel replicas
    tau_start: float = 1.0         # initial surrogate temperature
    tau_min: float = 0.05          # annealing floor (high-fidelity regime)
    tau_decay: float = 0.92        # geometric decay per round
    penalty: float = 10.0          # constraint-violation penalty weight
    topk: int = 4                  # final rounding-variant re-scores (<= 4)
    init_scale: float = 0.5        # stddev of the logit init (replica 0 = 0)
    seed: int = 0


class RelaxedState(NamedTuple):
    """Descent carry: everything a resumed run needs.

    ``params``/``m``/``v`` are ``(theta_pe, theta_kt, theta_df)`` triples of
    shape ``(R, N)`` / ``(R, N)`` / ``(R, N, 3)`` on the env's device, Adam
    moments included so that a resume continues the same trajectory.
    """

    params: tuple
    m: tuple
    v: tuple
    tau: torch.Tensor          # () f32 current surrogate temperature
    gstep: torch.Tensor        # () int32 gradient steps completed
    best_fit: torch.Tensor     # () f32 on the host: best hard fitness
    best_pe: torch.Tensor      # (N,) f32 rounded assignment of the best
    best_kt: torch.Tensor      # (N,) f32
    best_df: torch.Tensor      # (N,) f32
    evals: torch.Tensor        # () int64 on the host: hard evaluations


# Rounding variants tried in the final re-scoring pass, in order: the
# floor/ceil corners of the continuous point's cell.
_VARIANTS = ((torch.floor, torch.floor), (torch.ceil, torch.ceil),
             (torch.floor, torch.ceil), (torch.ceil, torch.floor))


def _decode(params, mix: bool, dataflow: int):
    """Relaxed params -> continuous (pe, kt, df_weights), (R, N[, 3]).

    Sigmoid box constraints keep ``(pe, kt)`` inside the fine search
    bounds (1..160 x 1..16); the dataflow simplex is a softmax, pinned to
    the env's one-hot when the search does not mix dataflows.
    """
    th_pe, th_kt, th_df = params
    pe = dfl.PE_MIN + (dfl.PE_MAX - dfl.PE_MIN) * torch.sigmoid(th_pe)
    kt = dfl.KT_MIN + (dfl.KT_MAX - dfl.KT_MIN) * torch.sigmoid(th_kt)
    if mix:
        df_w = torch.softmax(th_df, dim=-1)
    else:
        one_hot = torch.zeros((dfl.NUM_DATAFLOWS,), device=th_df.device)
        one_hot[dataflow] = 1.0
        df_w = one_hot.expand(th_df.shape)
    return pe, kt, df_w


def _soft_loss(params, tau, env: env_lib.EnvArrays, ecfg: env_lib.EnvConfig,
               cfg: RelaxedConfig):
    """Per-replica soft objective: log-objective + budget penalty, (R,)."""
    pe, kt, df_w = _decode(params, ecfg.mix, ecfg.dataflow)
    mc = maestro.soft_model_cost(env.layers, pe, kt, df_w, tau, ecfg.scenario)
    obj = mc.latency if ecfg.objective == "latency" else mc.energy
    cons = mc.area if ecfg.constraint == "area" else mc.power
    loss = torch.log(obj + 1.0)
    # Penalty on *relative* violation, zero-gated for the unlimited
    # platform (budget = inf).
    rel = cons / env.budget - 1.0
    pen = cfg.penalty * 0.05 * prim_lib.softplus(rel / 0.05)
    return loss + torch.where(torch.isfinite(env.budget), pen, 0.0)


def _round_candidate(pe, kt, df_w, mix: bool, dataflow: int,
                     round_pe=torch.round, round_kt=torch.round):
    """Continuous point -> integer (pe, kt, df) inside the search bounds."""
    pe_i = torch.clamp(round_pe(pe), dfl.PE_MIN, dfl.PE_MAX)
    kt_i = torch.clamp(round_kt(kt), dfl.KT_MIN, dfl.KT_MAX)
    if mix:
        df = torch.argmax(df_w, dim=-1).to(torch.float32)
    else:
        df = torch.full(pe_i.shape, float(dataflow), device=pe_i.device)
    return pe_i, kt_i, df


def _row(x, r):
    """x[r] for a 0-d index tensor on the device, without a host read."""
    return torch.index_select(x, 0, r.reshape(1))[0]


def _init_state(env: env_lib.EnvArrays, cfg: RelaxedConfig) -> RelaxedState:
    N = env.num_layers
    R = max(int(cfg.restarts), 1)
    dev = env.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    draw = lambda shape: cfg.init_scale * torch.randn(shape, generator=gen,
                                                      device=dev)
    params = (draw((R, N)), draw((R, N)), draw((R, N, dfl.NUM_DATAFLOWS)))
    # Replica 0 starts at the exact box center: a deterministic mid-range
    # point that is feasible on most platforms and anchors the ensemble.
    for t in params:
        t[0] = 0.0
    zeros = tuple(torch.zeros_like(t) for t in params)
    nan = torch.full((N,), float("nan"), device=dev)
    return RelaxedState(
        params=params, m=zeros, v=zeros,
        tau=torch.tensor(cfg.tau_start, dtype=torch.float32, device=dev),
        gstep=torch.zeros((), dtype=torch.int32, device=dev),
        best_fit=torch.tensor(float("inf")),
        best_pe=nan, best_kt=nan.clone(), best_df=nan.clone(),
        evals=torch.zeros((), dtype=torch.int64))


def relaxed_state_from_jax(state, device="cpu") -> RelaxedState:
    """The port's state holding a reference ``RelaxedState`` whose fields
    are numpy arrays (``jax.tree.map(np.asarray, state)``): the
    counterpart of ``policy.params_from_jax`` for this engine."""
    dev = torch.device(device)
    on = lambda a, dt=torch.float32, d=dev: torch.as_tensor(
        np.array(a), dtype=dt, device=d)
    trip = lambda ts: tuple(on(t) for t in ts)
    return RelaxedState(
        params=trip(state.params), m=trip(state.m), v=trip(state.v),
        tau=on(state.tau), gstep=on(state.gstep, torch.int32),
        best_fit=on(state.best_fit, d="cpu"),
        best_pe=on(state.best_pe), best_kt=on(state.best_kt),
        best_df=on(state.best_df),
        evals=on(state.evals, torch.int64, "cpu"))


def make_round_fn(env: env_lib.EnvArrays, ecfg: env_lib.EnvConfig,
                  cfg: RelaxedConfig):
    """One round of descent: ``steps_per_eval`` Adam steps + anneal.

    Returns ``round_fn(state) -> (state, pe_i, kt_i, df)``, the integer
    arrays being the rounded candidate of the replica with the best soft
    loss (hard scoring stays outside, so an ``eval_fn`` can own it), and
    ``best_continuous(state) -> (pe, kt, df_w)`` of that replica.  Neither
    reads the device from the host.
    """
    b1, b2, eps_adam = 0.9, 0.999, 1e-8
    lr = cfg.lr

    def grad_fn(params, tau):
        leaves = [p.detach().requires_grad_() for p in params]
        with torch.enable_grad():
            total = torch.sum(_soft_loss(leaves, tau, env, ecfg, cfg))
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        # theta_df has no gradient when the dataflow is fixed: zeros, as
        # jax.grad gives.
        return tuple(torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, grads))

    def round_fn(state: RelaxedState):
        params, m, v, t = state.params, state.m, state.v, state.gstep
        for _ in range(cfg.steps_per_eval):
            g = grad_fn(params, state.tau)
            t = t + 1
            m = tuple(b1 * a + (1 - b1) * b for a, b in zip(m, g))
            v = tuple(b2 * a + (1 - b2) * b * b for a, b in zip(v, g))
            tf = t.to(torch.float32)
            scale = torch.sqrt(1.0 - b2 ** tf) / (1.0 - b1 ** tf)
            params = tuple(p - lr * scale * mi / (torch.sqrt(vi) + eps_adam)
                           for p, mi, vi in zip(params, m, v))
        tau = torch.clamp_min(state.tau * cfg.tau_decay, cfg.tau_min)
        with torch.no_grad():
            losses = _soft_loss(params, tau, env, ecfg, cfg)
            r = torch.argmin(losses)
            pe, kt, df_w = _decode(params, ecfg.mix, ecfg.dataflow)
            pe_i, kt_i, df = _round_candidate(
                _row(pe, r), _row(kt, r), _row(df_w, r), ecfg.mix,
                ecfg.dataflow)
        return (state._replace(params=params, m=m, v=v, tau=tau, gstep=t),
                pe_i, kt_i, df)

    @torch.no_grad()
    def best_continuous(state: RelaxedState):
        losses = _soft_loss(state.params, state.tau, env, ecfg, cfg)
        r = torch.argmin(losses)
        pe, kt, df_w = _decode(state.params, ecfg.mix, ecfg.dataflow)
        return _row(pe, r), _row(kt, r), _row(df_w, r)

    return round_fn, best_continuous


def run_relaxed_search(workload, ecfg: env_lib.EnvConfig, eps: int = 100,
                       cfg: RelaxedConfig = RelaxedConfig(),
                       state: Optional[RelaxedState] = None,
                       chunk: Optional[int] = None,
                       on_chunk=None,
                       eval_fn=None,
                       env: Optional[env_lib.EnvArrays] = None,
                       device="cuda"):
    """Chunked, resumable one-shot relaxed search.  Returns (state, history).

    Spends ``eps`` *more* hard evaluations from ``state`` (fresh descent
    when None): ``eps - topk`` descent rounds, then ``topk`` rounding-variant
    re-scores of the best replica.  ``on_chunk(state, chunk_hist,
    evals_done)`` fires between chunks.  ``eval_fn(pe, kt, df) -> (1,)
    fitness`` takes numpy (1, N) arrays (and a float32 dataflow when the
    search does not mix dataflows): the search service's batcher.
    """
    if env is None:
        env = env_lib.make_env(workload, ecfg, device)
    round_fn, best_continuous = make_round_fn(env, ecfg, cfg)

    def score(pe, kt, df):
        """The candidate's hard fitness: the round's one host read."""
        if eval_fn is None:
            perf, _, feas = env_lib.genome_cost(env, ecfg, pe[None],
                                                kt[None], df[None])
            return float(torch.where(feas, perf, torch.inf)[0])
        host = torch.stack([pe, kt, df]).cpu().numpy()
        df_arg = (np.float32(ecfg.dataflow) if not ecfg.mix
                  else host[2][None])
        return float(np.asarray(eval_fn(host[0][None], host[1][None],
                                        df_arg), np.float32)[0])

    def absorb(state, fit, pe, kt, df):
        if fit < float(state.best_fit):
            state = state._replace(best_fit=torch.tensor(fit), best_pe=pe,
                                   best_kt=kt, best_df=df)
        return state._replace(evals=state.evals + 1)

    if state is None:
        state = _init_state(env, cfg)

    n_var = min(max(int(cfg.topk), 0), len(_VARIANTS), eps - 1)
    rounds = eps - n_var

    def run_round_chunk(state, n):
        h = np.empty((n,), np.float32)
        for s in range(n):
            state, pe_i, kt_i, df = round_fn(state)
            state = absorb(state, score(pe_i, kt_i, df), pe_i, kt_i, df)
            h[s] = np.float32(state.best_fit)
        return state, h

    state, hist = chunk_lib.drive(state, rounds, chunk, run_round_chunk,
                                  on_chunk, engine="relaxed")
    if n_var:
        # Final budget: hard-score the floor/ceil rounding variants of the
        # best replica's continuous point, as one chunk offset past the
        # descent rounds.
        pe_c, kt_c, df_w = best_continuous(state)

        def run_variant_chunk(state, n):
            h = np.empty((n,), np.float32)
            for i in range(n):
                rp, rk = _VARIANTS[i]
                pe_i, kt_i, df = _round_candidate(
                    pe_c, kt_c, df_w, ecfg.mix, ecfg.dataflow, rp, rk)
                state = absorb(state, score(pe_i, kt_i, df), pe_i, kt_i, df)
                h[i] = np.float32(state.best_fit)
            return state, h

        state, vhist = chunk_lib.drive(
            state, rounds + n_var, n_var, run_variant_chunk, on_chunk,
            engine="relaxed", start=rounds)
        hist.extend(vhist)
    return state, chunk_lib.concat_hist(hist)


def relaxed_solution(state: RelaxedState):
    """Best rounded assignment seen: raw (pe, kt, df) numpy arrays (NaN =
    none)."""
    return tuple(t.cpu().numpy() for t in (state.best_pe, state.best_kt,
                                           state.best_df))
