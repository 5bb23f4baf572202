"""Distributed ConfuciuX search: episode-parallel REINFORCE
(``dist_reinforce``) and the seed-parallel fanout of any registered
optimizer (``fanout``).

Port of ``repro.distributed.dist_search``; its meshes and reductions live
in :mod:`repro_torch.distributed.collectives`.

Episode-parallel REINFORCE: every device of a mesh runs E episodes and
computes the gradient of its mean policy-gradient loss; the gradients meet
in a masked hierarchical mean (f32 within a pod, optionally int8 across the
``pod`` axis; dead shards contribute nothing and the mean is over the live
ones), and every device applies the same Adam step.  The best point is the
global first argmin over all episodes, dead shards' included.

  * On a :class:`~repro_torch.distributed.collectives.VirtualMesh` an epoch
    is one batched rollout of n x E episodes, shard-major, through the
    LSTM and table-cost kernels, then one backward pass of the masked mean
    of the per-device losses (one pass per pod when the pod hop is
    compressed, since the int8 hop is not linear).  On the card the epoch
    is captured once as a CUDA graph and replayed (``EpochRunner``), the
    counterpart of the reference's ``jax.jit(one_epoch)``.
  * On a :class:`~repro_torch.distributed.collectives.ProcessMesh` each
    rank rolls out its own E episodes from its own generator and the
    reductions run as ``all_reduce`` / ``all_gather`` over the mesh's
    groups; this path stays eager.

Fanout: n shards run the inner method with seeds ``seed + s`` and the full
``eps`` each, and their outcomes merge (best value wins, the first shard on
a tie; the trace is the elementwise min, the wall-clock view of the
parallel ensemble).  Three execution backends give the same bytes:

  * ``serial``  -- the in-process loop;
  * ``threads`` -- one host thread per shard, running the inner optimizer
    unchanged; on the card each thread works on a CUDA stream of its own;
  * ``device``  -- the whole fleet driven from one thread, for the inners
    whose search lives on the device (``DEVICE_INNERS``).  The reference
    runs one shard per JAX device as one shard_map'd program; here every
    shard lives on the one card: each has its own state, generator and
    captured CUDA graph (a stage-1 epoch, or a GA generation), and the
    graphs replay in turn, each on its own stream, so the shards' small
    launches overlap on the card.  On the CPU the shards step in lockstep,
    eagerly.

Live progress streams merged and shard-tagged through the unified API.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.api import registry as api_registry
from repro_torch.api import types as api_types
from repro_torch.core import chunk as chunk_lib
from repro_torch.core import env as env_lib
from repro_torch.core import ga as ga_lib
from repro_torch.core import policy as policy_lib
from repro_torch.core import reinforce
from repro_torch.distributed import collectives
from repro_torch.training import optim


# ---------------------------------------------------------------------------
# Episode-parallel REINFORCE.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DistConfig:
    episodes_per_device: int = 4
    compress_pod_axis: bool = False   # int8 reduction across 'pod'
    # Kept only to match the reference's DistConfig, which reads it
    # nowhere either: every draw comes from ReinforceConfig.seed (the
    # state's generator, and the ranks' generators derived from it).
    seed: int = 0


POD_AXIS = "pod"
# The metrics of a distributed epoch, in the order of its history.
DIST_METRICS = ("best_value", "feasible_frac")


def _virtual_reduce(mesh: collectives.VirtualMesh, alive: torch.Tensor,
                    compress: bool):
    """reduce(losses, params) -> grads on a virtual mesh: the masked mean
    of the per-device gradients without forming them.  Uncompressed, one
    backward pass of sum_s alive_s L_s / n_alive; compressed, one pass per
    pod for the pods' f32 sums, then the int8 hop across the pods."""
    n_alive = torch.clamp_min(alive.sum(), 1.0)
    if not compress:
        def reduce(losses, params):
            total = (alive * losses).sum() / n_alive
            return torch.autograd.grad(total, params)
        return reduce
    d = mesh.axis_names.index(POD_AXIS)
    P = mesh.shape[d]
    inner = int(np.prod(mesh.shape[d + 1:]))
    pod_of = (torch.arange(mesh.size, device=mesh.device) // inner) % P
    weights = alive * (pod_of[None, :] == torch.arange(
        P, device=mesh.device)[:, None])                     # (P, n)
    pods = collectives.VirtualMesh((P,), (POD_AXIS,), mesh.device)

    def reduce(losses, params):
        pod_losses = (weights * losses).sum(dim=1)
        sums = [torch.autograd.grad(pod_losses[p], params,
                                    retain_graph=p < P - 1)
                for p in range(P)]
        stacked = {i: torch.stack([s[i] for s in sums])
                   for i in range(len(params))}
        hop = collectives.psum_int8(pods, stacked, POD_AXIS)
        return [hop[i][0] / n_alive for i in range(len(params))]

    return reduce


def make_distributed_grads(ecfg: env_lib.EnvConfig,
                           pcfg: policy_lib.PolicyConfig,
                           rcfg: reinforce.ReinforceConfig,
                           env: env_lib.EnvArrays, mesh: collectives.Mesh,
                           alive: torch.Tensor,
                           dcfg: DistConfig = DistConfig()):
    """Build grads_fn(state, actions=None) -> (grads, rolls): this device's
    (a virtual mesh's: all devices') E episodes, shard-major, and the
    masked hierarchical mean of the per-device gradients over every mesh
    axis, as a dict by parameter name, the same on every device.
    ``actions`` replaces the sampled actions (the tests replay the
    reference's draws through it)."""
    rollout = reinforce.make_rollout(ecfg, pcfg, env)
    E = dcfg.episodes_per_device
    rows = E * (mesh.size if mesh.lead else 1)
    axes = mesh.axis_names
    if mesh.lead:
        reduce = _virtual_reduce(
            mesh, alive, dcfg.compress_pod_axis and POD_AXIS in axes)
    else:
        def reduce(losses, params):
            grads = dict(enumerate(torch.autograd.grad(losses, params)))
            grads = collectives.masked_hierarchical_psum(
                mesh, grads, alive, axes, POD_AXIS, dcfg.compress_pod_axis)
            return [grads[i] for i in range(len(params))]

    def grads_fn(state: reinforce.SearchState, actions=None):
        named = dict(state.params.named_parameters())
        rolls = rollout(state.params, state.pmin, state.generator, rows,
                        actions)
        # Each device's loss: the mean of its E episodes' policy-gradient
        # terms (the reference's local_loss: no entropy term).
        pg, _ = reinforce.policy_gradient_terms(rolls, rcfg.discount)
        losses = pg.view(*mesh.lead, E).mean(dim=-1)
        return dict(zip(named, reduce(losses, list(named.values())))), rolls

    return grads_fn


def make_distributed_epoch(ecfg: env_lib.EnvConfig,
                           pcfg: policy_lib.PolicyConfig,
                           rcfg: reinforce.ReinforceConfig,
                           env: env_lib.EnvArrays, opt: optim.Adam,
                           mesh: collectives.Mesh, alive: torch.Tensor,
                           dcfg: DistConfig = DistConfig()):
    """Build epoch_fn(state, actions=None) -> (state', metrics): one
    episode-parallel epoch on ``mesh`` (``alive``: the per-device flags,
    :func:`~repro_torch.distributed.collectives.alive_flags`).  The params
    are updated in place with the reduced gradient; pmin is the global
    min, the best point the global first argmin over every device's
    episodes, and ``feasible_frac`` the mean over all devices -- dead
    shards' episodes count in all three.  Metrics (:data:`DIST_METRICS`)
    are 0-d device tensors."""
    grads_fn = make_distributed_grads(ecfg, pcfg, rcfg, env, mesh, alive,
                                      dcfg)
    E = dcfg.episodes_per_device
    axes = mesh.axis_names
    N = env.num_layers

    def epoch_fn(state: reinforce.SearchState, actions=None):
        grads, rolls = grads_fn(state, actions)
        values = torch.where(rolls.feasible, rolls.model_value, torch.inf)
        feas = rolls.feasible.to(torch.float32).view(*mesh.lead, E).mean(-1)
        i = torch.argmin(values)        # the first minimum
        if mesh.lead:                   # every device's episodes are here
            pmin = torch.amin(rolls.pmin)
            best_i = reinforce._pick(values, i)
            acts = reinforce._pick(rolls.actions, i)
            feasible_frac = feas.mean()
        else:
            pmin = mesh.pmin(torch.amin(rolls.pmin), axes)
            mine = torch.cat([reinforce._pick(values, i).view(1),
                              reinforce._pick(rolls.actions, i).reshape(-1)
                              .to(torch.float32)])
            everyone = mesh.all_gather(mine)            # rank order
            row = reinforce._pick(everyone, torch.argmin(everyone[:, 0]))
            best_i, acts = row[0], row[1:].view(N, 3).to(torch.int64)
            feasible_frac = mesh.psum(feas, axes) / mesh.size
        new_state = reinforce.next_state(state, opt, grads, pmin, best_i,
                                         acts)
        return new_state, {"best_value": new_state.best_value,
                           "feasible_frac": feasible_frac}

    return epoch_fn


def make_inplace_distributed_epoch(*args, **kw):
    """:func:`make_distributed_epoch` written back in place: epoch_(state,
    metrics) updates ``state``'s own tensors and writes the
    :data:`DIST_METRICS` into ``metrics`` (the form a CUDA graph
    captures, as :func:`~repro_torch.core.reinforce.make_inplace_epoch_fn`
    is for stage 1).  The same bits as the epoch it wraps."""
    epoch_fn = make_distributed_epoch(*args, **kw)

    def epoch_(state: reinforce.SearchState, metrics: torch.Tensor):
        new, m = epoch_fn(state)       # updates the params in place
        with torch.no_grad():
            for old, val in zip(reinforce.state_tensors(state),
                                reinforce.state_tensors(new)):
                old.copy_(val)
            metrics.copy_(torch.stack([m[k] for k in DIST_METRICS]))

    return epoch_


def _rank_generator(seed: int, rank: int, device) -> torch.Generator:
    """Rank ``rank``'s generator for its rollouts, derived from the seed
    and the rank; rank 0 draws from the state's own generator (the one a
    virtual mesh draws from), so this is for ranks >= 1."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([seed, rank]).generate_state(
        1, np.uint64)[0]))
    return gen


def run_distributed_search(workload, ecfg: env_lib.EnvConfig,
                           mesh: collectives.Mesh,
                           rcfg: reinforce.ReinforceConfig,
                           dcfg: DistConfig = DistConfig(),
                           pcfg: Optional[policy_lib.PolicyConfig] = None,
                           straggler_mask: Optional[Sequence[bool]] = None,
                           env: Optional[env_lib.EnvArrays] = None):
    """Full distributed stage-1 search on ``mesh``.  Returns (state,
    history dict of (epochs,) arrays of :data:`DIST_METRICS`).

    ``straggler_mask``: n bools in flattened device order; False marks a
    dead or slow shard whose gradient is dropped.  The state comes from
    ``reinforce.init_search`` (identical on every rank), and the epochs
    run as one chunk.  On a virtual mesh they run in place through
    ``EpochRunner`` (one CUDA graph on the card); on ranks they run
    eagerly, and the params are checked to be bit-identical across the
    ranks before and after.
    """
    if env is None:
        env = env_lib.make_env(workload, ecfg, mesh.device)
    pcfg = pcfg or policy_lib.PolicyConfig(obs_dim=ecfg.obs_dim, mix=ecfg.mix,
                                           levels=ecfg.levels)
    opt = optim.Adam(lr=rcfg.lr)
    state = reinforce.init_search(env, ecfg, pcfg, rcfg, opt)
    alive = collectives.alive_flags(mesh, straggler_mask)
    args = (ecfg, pcfg, rcfg, env, opt, mesh, alive, dcfg)
    if rcfg.epochs <= 0:
        return state, {}
    if mesh.lead:
        runner = reinforce.EpochRunner(
            state, make_inplace_distributed_epoch(*args), rcfg.epochs,
            names=DIST_METRICS)

        def run_chunk(_, n):
            return runner.state, runner.run(n)
    else:
        if mesh.rank:
            state = state._replace(generator=_rank_generator(
                rcfg.seed, mesh.rank, mesh.device))
        mesh.check_replicated(list(state.params.parameters()),
                              "initial params")
        epoch_fn = make_distributed_epoch(*args)

        def run_chunk(state, n):
            ms = []
            for _ in range(n):
                state, m = epoch_fn(state)
                ms.append(torch.stack([m[k] for k in DIST_METRICS]))
            h = torch.stack(ms, dim=1).to("cpu", copy=True).numpy()
            return state, {k: h[i] for i, k in enumerate(DIST_METRICS)}

    state, chunks = chunk_lib.drive(
        state, rcfg.epochs, 0, run_chunk, None, engine="dist_reinforce",
        evals_per_step=dcfg.episodes_per_device * mesh.size)
    if not mesh.lead:
        mesh.check_replicated(list(state.params.parameters()), "params")
    return state, chunk_lib.concat_hist_dict(chunks)


# Inner methods whose whole search runs on the device, so the device
# backend can drive n seeds of them as one fleet (bit-identical to the
# serial loop: each shard runs exactly the single-shard steps).
DEVICE_INNERS = ("reinforce", "ga")
FANOUT_BACKENDS = ("auto", "device", "threads", "serial")


class _MergedProgress:
    """Thread-safe merge of per-shard progress into one tagged stream.

    Each shard's Trials are re-emitted with ``shard=s`` and the *ensemble*
    best-so-far (min over everything any shard has reported).  ``step`` is
    the shard-local sample index, so every shard's sub-stream stays monotone;
    how the sub-streams interleave depends on the backend's scheduling.
    """

    def __init__(self, cb: Optional[api_types.ProgressFn], n_shards: int):
        self._cb = cb
        self._lock = threading.Lock()
        self._best = [float("inf")] * n_shards

    def shard_cb(self, s: int) -> Optional[api_types.ProgressFn]:
        if self._cb is None:
            return None

        def cb(trial: api_types.Trial) -> None:
            with self._lock:
                self._best[s] = min(self._best[s], trial.best_value)
                ensemble = min(self._best)
                self._cb(api_types.Trial(trial.step, trial.value,
                                         ensemble, shard=s))

        return cb


def _np(t):
    return t.detach().cpu().numpy()


class _Fleet:
    """Steps a list of runners (``EpochRunner`` / ``GenerationRunner``:
    ``step()``, a (k, capacity) ``hist`` and its ``slot``) round-robin, one
    step of each in turn.  On the card each runner replays on its own
    stream; on the CPU they run eagerly in lockstep."""

    def __init__(self, runners, device):
        self.runners = runners
        self.device = torch.device(device)
        self.streams = ([torch.cuda.Stream(self.device) for _ in runners]
                        if self.device.type == "cuda" else None)

    def run(self, n: int) -> np.ndarray:
        """``n`` steps of every runner; the (shards, k, n) history, read
        back to the host in one sync."""
        rs, streams = self.runners, self.streams
        if streams is None:
            for r in rs:
                r.slot.zero_()
            for _ in range(n):
                for r in rs:
                    r.step()
        else:
            main = torch.cuda.current_stream(self.device)
            for r, st in zip(rs, streams):
                st.wait_stream(main)
                with torch.cuda.stream(st):
                    r.slot.zero_()
            for _ in range(n):
                for r, st in zip(rs, streams):
                    with torch.cuda.stream(st):
                        r.step()
            for st in streams:
                main.wait_stream(st)
        return torch.stack([r.hist[:, :n] for r in rs]).to(
            "cpu", copy=True).numpy()


def reinforce_fleet(subs, capacity: int):
    """Each shard's env and :class:`~repro_torch.core.reinforce.EpochRunner`
    (history ``capacity`` epochs), built as the serial adapter builds them
    -- its env, its state and generator seeded with its own seed -- and
    the :class:`_Fleet` that steps them.  Returns (envs, runners, fleet)."""
    from repro_torch.api import optimizers as api_optimizers

    req0 = subs[0]
    wl = req0.resolve_workload()
    ecfg = req0.env
    pcfg = api_optimizers._policy_config(ecfg, req0.options)
    envs, runners = [], []
    for sub in subs:
        rcfg = api_optimizers._reinforce_cfg(sub)[0]
        env = env_lib.make_env(wl, ecfg, req0.device)
        opt = optim.Adam(lr=rcfg.lr)
        runners.append(reinforce.EpochRunner(
            reinforce.init_search(env, ecfg, pcfg, rcfg, opt),
            reinforce.make_inplace_epoch_fn(ecfg, pcfg, rcfg, env, opt),
            capacity))
        envs.append(env)
    return envs, runners, _Fleet(runners, envs[0].device)


def _fanout_reinforce_device(subs) -> List[api_types.SearchOutcome]:
    """All shards' REINFORCE searches as one fleet of epoch graphs
    (:func:`reinforce_fleet`): shard s's outcome is bit-identical to
    ``get_optimizer("reinforce").run(subs[s])``.  The fleet runs in chunks
    (one when nothing streams), each shard's history read back once a
    chunk.
    """
    from repro_torch.api import optimizers as api_optimizers

    req0 = subs[0]
    n_shards = len(subs)
    rcfg, E = api_optimizers._reinforce_cfg(req0)
    epochs = rcfg.epochs
    streaming = req0.on_progress is not None
    chunk = max(req0.progress_every // E, 1) if streaming else epochs
    envs, runners, fleet = reinforce_fleet(subs, min(chunk, epochs))
    t0 = time.time()

    def on_chunk(_, h, done):
        if not streaming:
            return
        best = h[:, reinforce.METRICS.index("best_value")]   # (shards, n)
        for s, sub in enumerate(subs):
            sub.on_progress(api_types.Trial(
                min(done * E, sub.eps), float(np.min(best[s])),
                float(best[s, -1])))

    _, chunks = chunk_lib.drive(
        None, epochs, chunk, lambda _, n: (None, fleet.run(n)), on_chunk,
        engine="fanout_reinforce", evals_per_step=E * n_shards)
    hist = np.concatenate(chunks, axis=2)

    outcomes = []
    for s, sub in enumerate(subs):
        state = runners[s].state
        pe, kt, df = reinforce.solution_arrays(state, envs[s])
        h = {k: hist[s, i] for i, k in enumerate(reinforce.METRICS)}
        trace = api_types.expand_trace(h["best_value"], E)
        outcomes.append(api_types.build_outcome(
            sub, "reinforce", float(state.best_value), _np(pe), _np(kt),
            _np(df), trace, t0, extras={"epochs": epochs, "history": h},
            streamed=streaming))
    return outcomes


def _fanout_ga_device(subs) -> List[api_types.SearchOutcome]:
    """All shards' GA runs as one fleet of generation graphs.

    Each shard has its env, its seeded population and generator, and a
    :class:`~repro_torch.core.ga.GenerationRunner`; its outcome is
    bit-identical to ``get_optimizer("ga").run(subs[s])``.  Every
    generation of every shard is one cost-kernel launch at (P, N), as in
    the serial run.  Like the reference's, this backend does not stream:
    each shard's trace is emitted when the fleet ends.
    """
    from repro_torch.api import optimizers as api_optimizers

    req0 = subs[0]
    wl = req0.resolve_workload()
    ecfg = req0.env
    cfg = api_optimizers._ga_cfg(req0)
    pop, gens = cfg.population, cfg.generations
    envs, runners = [], []
    for sub in subs:
        env = env_lib.make_env(wl, ecfg, req0.device)
        engine = ga_lib.make_ga_engine(env, ecfg, cfg)
        runners.append(ga_lib.GenerationRunner(
            engine, engine.init_carry(sub.seed), gens))
        envs.append(env)
    fleet = _Fleet(runners, envs[0].device)
    t0 = time.time()
    hist = fleet.run(gens)[:, 0]                # (shards, gens)

    outcomes = []
    for s, sub in enumerate(subs):
        state = runners[s].state
        pe, kt, df = ga_lib.ga_solution(envs[s], ecfg, state)
        trace = api_types.expand_trace(hist[s], pop)
        outcomes.append(api_types.build_outcome(
            sub, "ga", float(state.best_val), _np(pe), _np(kt), _np(df),
            trace, t0, extras={"generations": gens, "population": pop}))
    return outcomes


_DEVICE_ENGINES = {"reinforce": _fanout_reinforce_device,
                   "ga": _fanout_ga_device}


def _run_threads(inner: str, subs) -> List[api_types.SearchOutcome]:
    """One worker thread per shard, each with a fresh inner optimizer; on
    the card each worker's device work goes to a stream of its own, so
    the shards' launches are not serialized on one stream."""
    dev = env_lib.resolve_device(subs[0].device)
    streams = ([torch.cuda.Stream(dev) for _ in subs]
               if dev.type == "cuda" else [None] * len(subs))

    def run(sub, stream):
        opt = api_registry.get_optimizer(inner)
        if stream is None:
            return opt.run(sub)
        with torch.cuda.stream(stream):
            return opt.run(sub)

    with ThreadPoolExecutor(max_workers=len(subs)) as pool:
        futures = [pool.submit(run, sub, st) for sub, st in zip(subs,
                                                                streams)]
        return [f.result() for f in futures]


@api_registry.register("fanout")
class FanoutOptimizer:
    """Seed-parallel fan-out of any registered optimizer.

    options:
      ``inner``          registry name of the inner method (default
                         "reinforce")
      ``n_shards``       number of parallel searches (default 4)
      ``inner_options``  options dict passed to every shard
      ``backend``        "auto" | "device" | "threads" | "serial" (see the
                         module docstring and :func:`_resolve_backend`)

    Each shard keeps the full ``eps`` budget -- this models n workers
    searching in parallel, so the merged trace is the wall-clock best-so-far
    of the ensemble and total samples are ``n_shards * eps`` (reported in
    extras).  Shards are merged in shard-index order, so every backend
    returns identical outcomes for the same seeds.  Where every shard's
    outcome has an epoch history (``extras["history"]``: reinforce,
    two_stage, a2c, ppo2), ``extras["shard_histories"]`` holds them in
    shard order, each metric a list of floats.

    Progress streams through ``request.on_progress`` as shard-tagged Trials
    (``Trial.shard``) whose ``best_value`` is the ensemble best-so-far; each
    shard's sub-stream is monotone in ``step``, while the interleaving
    across shards follows the backend's scheduling.
    """

    name = "fanout"

    def run(self, request: api_types.SearchRequest
            ) -> api_types.SearchOutcome:
        t0 = time.time()
        opts = request.options
        inner = opts.get("inner", "reinforce")
        n_shards = int(opts.get("n_shards", 4))
        inner_opts = dict(opts.get("inner_options", {}))
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        inner_impl = api_registry.get_optimizer(inner)
        if isinstance(inner_impl, FanoutOptimizer):
            raise ValueError("fanout cannot nest itself as the inner method")
        backend = _resolve_backend(opts.get("backend", "auto"),
                                   inner_impl.name, request.device)
        merger = _MergedProgress(request.on_progress, n_shards)
        subs = [dataclasses.replace(
                    request, method=inner_impl.name, options=inner_opts,
                    seed=request.seed + s, on_progress=merger.shard_cb(s))
                for s in range(n_shards)]

        # Each shard gets a fresh optimizer instance so stateful custom
        # optimizers never share one object across concurrent threads.
        if backend == "device":
            shards = _DEVICE_ENGINES[inner_impl.name](subs)
        elif backend == "threads":
            shards = _run_threads(inner, subs)
        else:
            shards = [api_registry.get_optimizer(inner).run(sub)
                      for sub in subs]

        best = min(shards, key=lambda o: o.best_value)
        trace = np.min(np.stack([o.history for o in shards]), axis=0)
        extras = {"inner": inner_impl.name, "n_shards": n_shards,
                  "backend": backend,
                  "total_samples": n_shards * request.eps,
                  "shard_best_values": [o.best_value for o in shards],
                  "best_seed": best.seed}
        if all("history" in o.extras for o in shards):
            extras["shard_histories"] = [
                {k: np.asarray(v).tolist()
                 for k, v in o.extras["history"].items()} for o in shards]
        return api_types.build_outcome(
            request, self.name, best.best_value, best.pe, best.kt, best.df,
            trace, t0, extras=extras,
            streamed=request.on_progress is not None)


def _resolve_backend(backend: str, inner_name: str, device="cuda") -> str:
    """The backend a fanout request runs on.

    * ``auto``   -- ``device`` when the inner is in :data:`DEVICE_INNERS`
      and the request runs on the card, else ``threads``.
    * ``device`` -- only for the inners of :data:`DEVICE_INNERS` (another
      raises).  Unlike the reference, which needs one JAX device a shard,
      it takes any number of shards: one card holds every shard, and on
      the CPU they run in lockstep.
    * ``threads`` / ``serial`` -- any inner.
    """
    if backend == "auto":
        return ("device" if inner_name in DEVICE_INNERS
                and torch.device(device).type == "cuda" else "threads")
    if backend == "device":
        if inner_name not in DEVICE_INNERS:
            raise ValueError(
                f"backend='device' supports the inner methods whose search "
                f"runs on the device {DEVICE_INNERS}, not {inner_name!r}; "
                f"use backend='threads'")
        return backend
    if backend not in FANOUT_BACKENDS:
        raise ValueError(f"unknown fanout backend {backend!r}; expected one "
                         f"of {FANOUT_BACKENDS}")
    return backend


@api_registry.register("dist_reinforce")
class DistributedReinforceOptimizer:
    """Episode-parallel REINFORCE across every device of a mesh.

    options: ``mesh`` (a :class:`~repro_torch.distributed.collectives
    .VirtualMesh` or ``ProcessMesh``; default
    :func:`~repro_torch.distributed.collectives.default_mesh`: the world's
    ranks when ``torch.distributed`` is initialised, else one virtual
    device on the request's device), ``episodes_per_device`` (1),
    ``compress_pod_axis``, ``straggler_mask`` (n bools in flattened device
    order), ``lr`` (3e-3).  One epoch consumes ``episodes_per_device *
    n_devices`` samples; like the reference's, the run is one chunk and
    streams no live progress.
    """

    name = "dist_reinforce"

    def run(self, request: api_types.SearchRequest
            ) -> api_types.SearchOutcome:
        t0 = time.time()
        opts = request.options
        mesh = opts.get("mesh")
        if mesh is None:
            mesh = collectives.default_mesh(request.device)
        if mesh.device.type != torch.device(request.device).type:
            raise ValueError(f"the mesh {mesh} is not on the request's "
                             f"device {request.device!r}")
        n_dev = mesh.size
        E = int(opts.get("episodes_per_device", 1))
        per_epoch = max(E * n_dev, 1)
        rcfg = reinforce.ReinforceConfig(
            epochs=max(request.eps // per_epoch, 1),
            lr=opts.get("lr", 3e-3), seed=request.seed)
        dcfg = DistConfig(
            episodes_per_device=E,
            compress_pod_axis=bool(opts.get("compress_pod_axis", False)),
            seed=request.seed)
        wl = request.resolve_workload()
        env = env_lib.make_env(wl, request.env, mesh.device)
        state, hist = run_distributed_search(
            wl, request.env, mesh, rcfg, dcfg,
            straggler_mask=opts.get("straggler_mask"), env=env)
        pe, kt, df = reinforce.solution_arrays(state, env)
        trace = api_types.expand_trace(hist["best_value"], per_epoch)
        return api_types.build_outcome(
            request, self.name, float(state.best_value), _np(pe), _np(kt),
            _np(df), trace, t0,
            extras={"epochs": rcfg.epochs, "devices": n_dev,
                    "history": hist})
