"""Built-in optimizer adapters: the ported search methods behind one API.

Port of the adapters of ``repro.api.optimizers``: ``random``, ``grid``,
``sa``, ``bo``, ``ga``, ``nsga2``, ``relaxed``, ``reinforce``,
``two_stage``, ``a2c`` and ``ppo2`` (the seed-parallel ``fanout`` lives in
:mod:`repro_torch.distributed.dist_search`).  Each translates a ``SearchRequest`` into the
engine's config, runs it on ``request.device`` and normalizes the result
into ``SearchOutcome`` (trace length == eps, monotone best-so-far,
per-layer (pe, kt, df) arrays; ``nsga2`` adds the frontier).  ``random``,
``grid``, ``bo``, ``sa``, ``ga``, ``nsga2`` and ``relaxed`` pass
``options["eval_fn"]`` on to their engine: the search service's batcher
comes in there.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.api import types
from repro_torch.api.registry import register
from repro_torch.api.types import SearchOutcome, SearchRequest, Trial
from repro_torch.core import baselines
from repro_torch.core import env as env_lib
from repro_torch.core import ga as ga_lib
from repro_torch.core import nsga2 as nsga2_lib
from repro_torch.core import policy as policy_lib
from repro_torch.core import reinforce
from repro_torch.core import relaxed as relaxed_lib
from repro_torch.core import rl_baselines
from repro_torch.core import search as search_lib

_outcome = types.build_outcome


def _np(t):
    return t.detach().cpu().numpy()


def _policy_config(ecfg: env_lib.EnvConfig, opts) -> policy_lib.PolicyConfig:
    pol = dict(opts.get("policy", {}))
    return policy_lib.PolicyConfig(
        obs_dim=ecfg.obs_dim, mix=ecfg.mix, levels=ecfg.levels,
        hidden=pol.get("hidden", policy_lib.HIDDEN),
        kind=pol.get("kind", "rnn"))


# ---------------------------------------------------------------------------
# Classic baselines (random/grid/bo: single-shot; sa: chunked).
# ---------------------------------------------------------------------------
@register("random")
class RandomOptimizer:
    name = "random"

    def run(self, request: SearchRequest) -> SearchOutcome:
        t0 = time.time()
        opts = request.options
        res = baselines.random_search(
            request.resolve_workload(), request.env, eps=request.eps,
            seed=request.seed, batch=opts.get("batch", 512),
            eval_fn=opts.get("eval_fn"), device=request.device)
        return _outcome(request, self.name, res.best_value, res.best_pe,
                        res.best_kt, None, res.history, t0)


@register("grid")
class GridOptimizer:
    name = "grid"

    def run(self, request: SearchRequest) -> SearchOutcome:
        t0 = time.time()
        opts = request.options
        res = baselines.grid_search(
            request.resolve_workload(), request.env, eps=request.eps,
            stride=opts.get("stride", 1), batch=opts.get("batch", 512),
            eval_fn=opts.get("eval_fn"), device=request.device)
        return _outcome(request, self.name, res.best_value, res.best_pe,
                        res.best_kt, None, res.history, t0)


@register("sa")
class SimulatedAnnealingOptimizer:
    """Chunked annealing: streams live, resumes, and accepts an injected
    ``eval_fn`` so the search service batches its candidate evaluations."""

    name = "sa"

    def run(self, request: SearchRequest) -> SearchOutcome:
        t0 = time.time()
        opts = request.options
        cfg = baselines.SAConfig(
            temperature=opts.get("temperature", 10.0),
            step=opts.get("step", 1),
            decay=opts.get("decay", 0.999),
            seed=request.seed)
        wl = request.resolve_workload()
        env = env_lib.make_env(wl, request.env, request.device)
        if request.on_progress is None:
            chunk, on_chunk = None, None
        else:
            def on_chunk(state, hist, steps_done):
                request.on_progress(Trial(
                    min(steps_done, request.eps),
                    float(np.min(hist)), float(state.best_fit)))

            chunk = max(request.progress_every, 1)
        state, hist = baselines.run_sa_search(
            wl, request.env, eps=request.eps, cfg=cfg, chunk=chunk,
            on_chunk=on_chunk, eval_fn=opts.get("eval_fn"), env=env)
        pe, kt = baselines.sa_solution(env, state)
        return _outcome(request, self.name, float(state.best_fit), pe, kt,
                        None, hist, t0,
                        extras={"steps": int(state.step)},
                        streamed=request.on_progress is not None)


@register("bo", aliases=("bayes",))
class BayesOptOptimizer:
    name = "bo"

    def run(self, request: SearchRequest) -> SearchOutcome:
        t0 = time.time()
        opts = request.options
        res = baselines.bayes_opt(
            request.resolve_workload(), request.env, eps=request.eps,
            seed=request.seed,
            n_candidates=opts.get("n_candidates", 64),
            gamma=opts.get("gamma", 0.15),
            init_random=opts.get("init_random", 64),
            batch=opts.get("batch", 16),
            eval_fn=opts.get("eval_fn"), device=request.device)
        return _outcome(request, self.name, res.best_value, res.best_pe,
                        res.best_kt, None, res.history, t0)


def _ga_cfg(request: SearchRequest) -> ga_lib.GAConfig:
    opts = request.options
    pop = int(opts.get("population", 100))
    gens = int(opts.get("generations", 0)) or max(request.eps // pop, 1)
    return ga_lib.GAConfig(
        population=pop, generations=gens,
        mutation_rate=opts.get("mutation_rate", 0.05),
        crossover_rate=opts.get("crossover_rate", 0.05),
        seed=request.seed)


@register("ga")
class GeneticAlgorithmOptimizer:
    """Baseline GA; ``eps`` buys population * generations individuals."""

    name = "ga"

    def run(self, request: SearchRequest) -> SearchOutcome:
        t0 = time.time()
        cfg = _ga_cfg(request)
        wl = request.resolve_workload()
        env = env_lib.make_env(wl, request.env, request.device)
        if request.on_progress is None:
            chunk, on_chunk = None, None
        else:
            def on_chunk(state, hist, gens_done):
                request.on_progress(Trial(
                    min(gens_done * cfg.population, request.eps),
                    float(np.min(hist)), float(state.best_val)))

            chunk = max(request.progress_every // cfg.population, 1)
        state, hist = ga_lib.run_ga_search(
            wl, request.env, cfg, chunk=chunk, on_chunk=on_chunk,
            eval_fn=request.options.get("eval_fn"), env=env)
        pe, kt, df = ga_lib.ga_solution(env, request.env, state)
        trace = types.expand_trace(hist, cfg.population)
        return _outcome(request, self.name, float(state.best_val),
                        _np(pe), _np(kt), _np(df), trace, t0,
                        extras={"generations": cfg.generations,
                                "population": cfg.population},
                        streamed=request.on_progress is not None)


def _nsga2_cfg(request: SearchRequest) -> nsga2_lib.NSGA2Config:
    opts = request.options
    pop = int(opts.get("population", 64))
    gens = int(opts.get("generations", 0)) or max(request.eps // pop, 1)
    return nsga2_lib.NSGA2Config(
        population=pop, generations=gens,
        mutation_rate=opts.get("mutation_rate", 0.05),
        crossover_rate=opts.get("crossover_rate", 0.5),
        archive=int(opts.get("archive", 128)),
        seed=request.seed)


@register("nsga2", aliases=("pareto", "moo"))
class NSGA2Optimizer:
    """Constrained multi-objective NSGA-II over (latency, energy).

    Chunked like GA: ``eps`` buys population * generations evaluations,
    generations run in ``progress_every``-sized chunks when a callback is
    set, and an injected ``eval_fn(pe, kt, df) -> (P, 4) costs`` routes
    whole populations through the search service's batcher -- the same
    bytes either way, since without one the run evaluates through
    :func:`~repro_torch.serving.batcher.make_local_costs_eval`, the
    batcher's own programs.

    ``best_value``/``history`` follow the single-objective contract (the
    env's primary objective, feasible points only); the trade-off curve
    lands in ``SearchOutcome.frontier`` and its per-chunk snapshots in
    ``extras["frontier_trace"]``.
    """

    name = "nsga2"

    def run(self, request: SearchRequest) -> SearchOutcome:
        from repro_torch.serving import batcher as batcher_lib

        t0 = time.time()
        cfg = _nsga2_cfg(request)
        wl = request.resolve_workload()
        env = env_lib.make_env(wl, request.env, request.device)
        snapshots = []
        user_cb = request.on_progress

        def on_chunk(state, hist, gens_done):
            snapshots.append(nsga2_lib.frontier_points(state))
            if user_cb is not None:
                user_cb(Trial(
                    min(gens_done * cfg.population, request.eps),
                    float(np.min(hist)), float(state.best_val)))

        chunk = (max(request.progress_every // cfg.population, 1)
                 if user_cb is not None else None)
        eval_fn = request.options.get("eval_fn")
        if eval_fn is None:
            eval_fn = batcher_lib.make_local_costs_eval(env, request.env)
        state, hist = nsga2_lib.run_nsga2_search(
            wl, request.env, cfg, chunk=chunk, on_chunk=on_chunk,
            eval_fn=eval_fn, env=env)
        pe, kt, df = nsga2_lib.nsga2_solution(env, request.env, state)
        trace = types.expand_trace(hist, cfg.population)
        frontier = nsga2_lib.nsga2_frontier(env, request.env, state)
        return _outcome(request, self.name, float(state.best_val),
                        _np(pe), _np(kt), _np(df), trace, t0,
                        extras={"generations": cfg.generations,
                                "population": cfg.population,
                                "archive": cfg.archive,
                                "frontier_size": len(frontier["lat"]),
                                "frontier_trace": snapshots},
                        streamed=user_cb is not None, frontier=frontier)


@register("relaxed", aliases=("oneshot", "gradient"))
class RelaxedOptimizer:
    """One-shot gradient descent through the differentiable soft cost model.

    Chunked like SA: descent rounds stream live through ``on_chunk`` (the
    search service's cancellation point), and an injected ``eval_fn``
    routes the per-round hard probes through the batcher -- byte-identical
    outcomes either way.  ``eps`` counts hard evaluations; the gradient
    steps in between ride on the soft model.
    """

    name = "relaxed"

    def run(self, request: SearchRequest) -> SearchOutcome:
        t0 = time.time()
        opts = request.options
        cfg = relaxed_lib.RelaxedConfig(
            lr=opts.get("lr", 0.05),
            steps_per_eval=opts.get("steps_per_eval", 25),
            restarts=opts.get("restarts", 4),
            tau_start=opts.get("tau_start", 1.0),
            tau_min=opts.get("tau_min", 0.05),
            tau_decay=opts.get("tau_decay", 0.92),
            penalty=opts.get("penalty", 10.0),
            topk=opts.get("topk", 4),
            seed=request.seed)
        wl = request.resolve_workload()
        env = env_lib.make_env(wl, request.env, request.device)
        if request.on_progress is None:
            chunk, on_chunk = None, None
        else:
            def on_chunk(state, hist, evals_done):
                request.on_progress(Trial(
                    min(evals_done, request.eps),
                    float(np.min(hist)), float(state.best_fit)))

            chunk = max(request.progress_every, 1)
        state, hist = relaxed_lib.run_relaxed_search(
            wl, request.env, eps=request.eps, cfg=cfg, chunk=chunk,
            on_chunk=on_chunk, eval_fn=opts.get("eval_fn"), env=env)
        pe, kt, df = relaxed_lib.relaxed_solution(state)
        feasible = bool(np.isfinite(float(state.best_fit)))
        return _outcome(request, self.name, float(state.best_fit),
                        pe if feasible else None, kt if feasible else None,
                        df if feasible else None, hist, t0,
                        extras={"gradient_steps": int(state.gstep),
                                "hard_evals": int(state.evals),
                                "final_tau": float(state.tau)},
                        streamed=request.on_progress is not None)


# ---------------------------------------------------------------------------
# RL family (chunked engines; stream live through on_chunk).
# ---------------------------------------------------------------------------
def _reinforce_cfg(request: SearchRequest):
    opts = request.options
    E = int(opts.get("episodes_per_epoch", 1))
    epochs = max(request.eps // E, 1)
    rcfg = reinforce.ReinforceConfig(
        epochs=epochs, episodes_per_epoch=E,
        lr=opts.get("lr", 3e-3),
        discount=opts.get("discount", 0.9),
        entropy_coef=opts.get("entropy_coef", 0.0),
        seed=request.seed)
    return rcfg, E


def _chunk_args(request: SearchRequest, E: int):
    """(chunk, on_chunk) for the stage-1 engine: stream live when asked."""
    if request.on_progress is None:
        return 500, None

    def on_chunk(state, hist, epochs_done):
        request.on_progress(Trial(
            min(epochs_done * E, request.eps),
            float(np.min(hist["best_value"])), float(state.best_value)))

    return max(request.progress_every // E, 1), on_chunk


@register("reinforce", aliases=("rl", "conx_global"))
class ReinforceOptimizer:
    """Stage-1 ConfuciuX: REINFORCE global search (no GA fine-tune)."""

    name = "reinforce"

    def run(self, request: SearchRequest) -> SearchOutcome:
        t0 = time.time()
        wl = request.resolve_workload()
        rcfg, E = _reinforce_cfg(request)
        pcfg = _policy_config(request.env, request.options)
        chunk, on_chunk = _chunk_args(request, E)
        env = env_lib.make_env(wl, request.env, request.device)
        state, hist = reinforce.run_search(wl, request.env, rcfg, pcfg,
                                           chunk=chunk, on_chunk=on_chunk,
                                           env=env)
        pe, kt, df = reinforce.solution_arrays(state, env)
        trace = types.expand_trace(hist["best_value"], E)
        return _outcome(
            request, self.name, float(state.best_value), _np(pe), _np(kt),
            _np(df), trace, t0,
            extras={"epochs": rcfg.epochs, "history": hist},
            streamed=request.on_progress is not None)


@register("two_stage", aliases=("conx", "confuciux"))
class TwoStageOptimizer:
    """The full ConfuciuX pipeline: RL global search -> local-GA fine-tune.

    ``extras`` adds stage 1's value, its first feasible value, its epoch
    history, the GA's trace, and stage 1's assignment (``stage1_pe``,
    ``stage1_kt``, ``stage1_df``), where the GA starts.
    """

    name = "two_stage"

    def run(self, request: SearchRequest) -> SearchOutcome:
        t0 = time.time()
        wl = request.resolve_workload()
        opts = request.options
        rcfg, E = _reinforce_cfg(request)
        ga = dict(opts.get("ga", {}))
        gcfg = ga_lib.LocalGAConfig(
            population=ga.get("population", 20),
            generations=ga.get("generations", 2000),
            mutation_rate=ga.get("mutation_rate", 0.05),
            crossover_rate=ga.get("crossover_rate", 0.2),
            mutation_step=ga.get("mutation_step", 4),
            seed=request.seed)
        pcfg = _policy_config(request.env, opts)
        chunk, on_chunk = _chunk_args(request, E)
        if request.on_progress is None:
            ga_chunk, ga_on_chunk = None, None
        else:
            # Stage-2 evaluations run past the eps budget, so its Trials
            # stay pinned at step == eps.
            def ga_on_chunk(state, hist, gens_done):
                request.on_progress(Trial(
                    request.eps, float(np.min(hist)),
                    min(float(state.best_val), seen_best[0])))

            seen_best = [float("inf")]
            user_on_chunk = on_chunk

            def on_chunk(state, hist, epochs_done):  # noqa: F811
                seen_best[0] = min(seen_best[0], float(state.best_value))
                user_on_chunk(state, hist, epochs_done)

            ga_chunk = max(request.progress_every // gcfg.population, 1)
        res = search_lib.confuciux_search(
            wl, request.env, rcfg, gcfg, pcfg,
            fine_tune=opts.get("fine_tune", True),
            chunk=chunk, on_chunk=on_chunk,
            ga_chunk=ga_chunk, ga_on_chunk=ga_on_chunk,
            device=request.device)
        # Stage-2's gain is reflected at the trace's final sample so
        # history[-1] equals the post-fine-tune best.
        trace = types.expand_trace(res.history["best_value"], E)
        if len(trace):
            trace[-1] = min(trace[-1], float(res.best_value))
        return _outcome(
            request, self.name, res.best_value, res.pe, res.kt, res.df,
            trace, t0,
            extras={"stage1_value": float(res.stage1_value),
                    "initial_valid_value": float(res.initial_valid_value),
                    "ga_history": np.asarray(res.ga_history),
                    "history": res.history, "epochs": rcfg.epochs,
                    "stage1_pe": res.stage1_pe, "stage1_kt": res.stage1_kt,
                    "stage1_df": res.stage1_df},
            streamed=request.on_progress is not None)


class _ActorCriticOptimizer:
    """A2C / PPO2 on the stage-1 environment and LSTM trunk plus a critic.
    ``episodes_per_epoch`` defaults to 1 here (``ACConfig``'s is 4), as in
    the reference's adapter."""

    algo = "a2c"
    name = "a2c"

    def run(self, request: SearchRequest) -> SearchOutcome:
        t0 = time.time()
        wl = request.resolve_workload()
        opts = request.options
        E = int(opts.get("episodes_per_epoch", 1))
        epochs = max(request.eps // E, 1)
        acfg = rl_baselines.ACConfig(
            algo=self.algo, epochs=epochs, episodes_per_epoch=E,
            lr=opts.get("lr", 1e-3),
            discount=opts.get("discount", 0.9),
            gae_lambda=opts.get("gae_lambda", 0.95),
            clip_eps=opts.get("clip_eps", 0.2),
            ppo_updates=opts.get("ppo_updates", 4),
            value_coef=opts.get("value_coef", 0.5),
            entropy_coef=opts.get("entropy_coef", 0.01),
            seed=request.seed)
        pcfg = _policy_config(request.env, opts)
        chunk, on_chunk = _chunk_args(request, E)
        env = env_lib.make_env(wl, request.env, request.device)
        state, hist = rl_baselines.run_ac_search(
            wl, request.env, acfg, pcfg, chunk=chunk, on_chunk=on_chunk,
            env=env)
        pe, kt, df = reinforce.solution_arrays(state, env)
        trace = types.expand_trace(hist["best_value"], E)
        return _outcome(
            request, self.name, float(state.best_value), _np(pe), _np(kt),
            _np(df), trace, t0,
            extras={"epochs": epochs, "history": hist},
            streamed=request.on_progress is not None)


@register("a2c")
class A2COptimizer(_ActorCriticOptimizer):
    algo = "a2c"
    name = "a2c"


@register("ppo2", aliases=("ppo",))
class PPO2Optimizer(_ActorCriticOptimizer):
    algo = "ppo2"
    name = "ppo2"
