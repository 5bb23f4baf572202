"""ConfuciuX stage 1: REINFORCE global search (SIII-A..F).

Port of ``repro.core.reinforce``.  Faithful elements (paper section in
brackets):
  * LSTM(128) policy, one (PE, Buf) action pair per layer [III-A2, III-C]
  * observation Eq. (1), normalized to [-1, 1]                       [III-B]
  * reward  R = P_t - P_min  with the global running minimum P_min
    tracked across all time-steps and epochs (P = -objective)        [III-E]
  * violation penalty = -(accumulated episode reward), episode ends  [III-E]
  * discount d = 0.9; per-episode reward standardization             [III-E]
  * MIX: optional third per-layer action choosing the dataflow style [IV-D]

Episodes of one epoch run as a batch of E rows.  The rollout is a Python
loop over the N layers whose every value -- ``alive``, ``budget_left``,
``pmin``, the best-so-far -- stays a tensor on the device: nothing syncs
with the host until a chunk's history goes to numpy.  Each step scores its
E actions with one cost-kernel launch at shape (E, 1) and steps the policy
with one LSTM-kernel launch; the backward runs one LSTM backward-kernel
launch per step.

Unlike the reference, whose parameters are immutable, the policy module is
updated in place by each epoch.  :func:`run_search` goes further: it runs
the epoch in place on one state (:func:`make_inplace_epoch_fn`), and on
the card captures that epoch once as a CUDA graph and replays it for every
epoch (:class:`EpochRunner`), the counterpart of the reference's jitted
scan over epochs.  On the CPU it runs the same epoch eagerly.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import chunk as chunk_lib
from repro_torch.core import env as env_lib
from repro_torch.core import graph as graph_lib
from repro_torch.core import policy as policy_lib
from repro_torch.kernels import ops
from repro_torch.obs import trace as obs_trace
from repro_torch.training import optim


@dataclasses.dataclass(frozen=True)
class ReinforceConfig:
    epochs: int = 5000
    episodes_per_epoch: int = 1   # 1 == the paper's setting
    lr: float = 3e-3
    discount: float = 0.9         # the paper's d
    entropy_coef: float = 0.0     # 0.0 == faithful
    seed: int = 0


class SearchState(NamedTuple):
    params: policy_lib.Policy
    opt_state: optim.OptState
    pmin: torch.Tensor        # () running min of P_t across steps & epochs
    best_value: torch.Tensor  # () best feasible objective so far
    best_pe_lvl: torch.Tensor  # (N,) int64
    best_kt_lvl: torch.Tensor  # (N,) int64
    best_df: torch.Tensor      # (N,) int64
    generator: torch.Generator
    epoch: torch.Tensor        # () int64


class RolloutOut(NamedTuple):
    rewards: torch.Tensor   # (E, N)
    logps: torch.Tensor     # (E, N), carries the policy's graph
    entropy: torch.Tensor   # (E, N)
    mask: torch.Tensor      # (E, N) 1.0 while alive at step entry
    perf: torch.Tensor      # (E, N) raw objective per layer (positive)
    actions: torch.Tensor   # (E, N, 3) int64 (pe_lvl, kt_lvl, df)
    feasible: torch.Tensor  # (E,) bool -- never violated
    model_value: torch.Tensor  # (E,) sum of per-layer objective
    pmin: torch.Tensor      # (E,) updated running min
    obs: Optional[torch.Tensor] = None     # (E, N, obs_dim) with a critic
    values: Optional[torch.Tensor] = None  # (E, N) with a critic


class EnvCarry(NamedTuple):
    """What a batched episode carries from one layer to the next, (E,)
    each: the last actions as the observation normalizes them, the LP
    budget left, alive, the accumulated reward and the running pmin."""

    prev_pe: torch.Tensor
    prev_kt: torch.Tensor
    prev_df: torch.Tensor
    budget_left: torch.Tensor
    alive: torch.Tensor
    acc_r: torch.Tensor
    pmin_run: torch.Tensor


class EnvStep(NamedTuple):
    start: Callable     # (E, pmin) -> EnvCarry
    observe: Callable   # (t, carry) -> (E, obs_dim) observation
    advance: Callable   # (t, carry, a_pe, a_kt, a_df) ->
    #                     (carry', reward, alive_f, perf)


def make_env_step(ecfg: env_lib.EnvConfig, pcfg: policy_lib.PolicyConfig,
                  env: env_lib.EnvArrays) -> EnvStep:
    """The environment side of a batched rollout, shared by REINFORCE and
    the actor-critic baselines: Eq. (1)'s observation, and one layer's
    actions scored with one cost-kernel launch at (E, 1), the reward
    R = P_t - P_min, the violation penalty and the end of the episode."""
    if ecfg.objective == "blend":
        raise ValueError("objective='blend' is a whole-model scalarization; "
                         "the per-layer RL reward path cannot use it")
    N = env.num_layers
    dev = env.device
    t_norm = 2.0 * torch.arange(N, dtype=torch.float32, device=dev) / max(
        N - 1, 1) - 1.0
    Lm1 = max(pcfg.levels - 1, 1)
    # The cost kernel's inputs that do not change between steps: each
    # layer's (NUM_FIELDS, 1) row, and a dataflow fixed for the whole run,
    # which goes to the kernel by value.
    rows = [env.layers[t][:, None] for t in range(N)]
    fixed_df_value = float(ecfg.dataflow)
    # The rows of the kernel's (4, E) output that the reward reads, of
    # latency, energy, area, power.
    perf_row = 0 if ecfg.objective == "latency" else 1
    cons_row = 2 if ecfg.constraint == "area" else 3

    def start(E: int, pmin) -> EnvCarry:
        minus1 = torch.full((E,), -1.0, device=dev)
        return EnvCarry(minus1, minus1, minus1, env.budget.expand(E),
                        torch.ones((E,), dtype=torch.bool, device=dev),
                        torch.zeros((E,), device=dev), pmin.expand(E))

    def observe(t: int, c: EnvCarry):
        E = c.alive.shape[0]
        dyn = [c.prev_pe, c.prev_kt] + ([c.prev_df] if ecfg.mix else [])
        return torch.cat([env.static_obs[t].expand(E, 7),
                          torch.stack(dyn, dim=-1),
                          t_norm[t].expand(E, 1)], dim=-1)

    def advance(t: int, c: EnvCarry, a_pe, a_kt, a_df):
        E = c.alive.shape[0]
        pe = env.pe_table[a_pe]
        kt = env.kt_table[a_kt]
        costs = ops.table_cost(
            rows[t], pe[:, None], kt[:, None],
            a_df.to(torch.float32)[:, None] if ecfg.mix
            else fixed_df_value).view(4, E)
        perf_pos = costs[perf_row]
        cons = costs[cons_row]
        P_t = -perf_pos  # higher is better
        alive, budget_left = c.alive, c.budget_left
        if ecfg.scenario == "LP":
            budget_left = budget_left - cons
            viol = alive & (budget_left < 0)
        else:  # LS: the single design must fit the budget at every layer
            viol = alive & (cons > env.budget)
        pmin_run = torch.where(alive, torch.minimum(c.pmin_run, P_t),
                               c.pmin_run)
        r_ok = P_t - pmin_run                    # >= 0 by construction
        alive_f = alive.to(torch.float32)
        r = torch.where(viol, -c.acc_r, r_ok) * alive_f
        acc_r = c.acc_r + torch.where(alive & ~viol, r, 0.0)
        carry = EnvCarry(2.0 * a_pe / Lm1 - 1.0, 2.0 * a_kt / Lm1 - 1.0,
                         a_df.to(torch.float32) - 1.0, budget_left,
                         alive & ~viol, acc_r, pmin_run)
        return carry, r, alive_f, perf_pos

    return EnvStep(start, observe, advance)


def make_rollout(ecfg: env_lib.EnvConfig, pcfg: policy_lib.PolicyConfig,
                 env: env_lib.EnvArrays, critic: Optional[Callable] = None):
    """Build rollout(params, pmin, generator, E, actions=None) -> RolloutOut.

    ``actions`` (E, N, 3), when given, replaces the sampled actions (the
    tests replay the reference's draws through it); log-probs and entropies
    are then those of the given actions under the policy.  ``critic(params,
    obs, policy_state)``, when given, is a value head: the rollout then
    also records each step's observation and value (``obs``, ``values``).
    """
    envstep = make_env_step(ecfg, pcfg, env)
    N = env.num_layers
    dev = env.device

    def rollout(params, pmin, generator, E: int,
                actions: Optional[torch.Tensor] = None) -> RolloutOut:
        pstate = policy_lib.init_state(pcfg, (E,), dev)
        carry = envstep.start(E, pmin)
        fixed_df = torch.full((E,), ecfg.dataflow, dtype=torch.int64,
                              device=dev)
        zero = torch.zeros((E,), device=dev)
        outs = []
        for t in range(N):
            obs = envstep.observe(t, carry)
            logits, pstate = policy_lib.step(params, pcfg, obs, pstate)
            if actions is None:
                a_pe, lp_pe, ent_pe = policy_lib.sample_action(
                    generator, logits[0])
                a_kt, lp_kt, ent_kt = policy_lib.sample_action(
                    generator, logits[1])
                if ecfg.mix:
                    a_df, lp_df, ent_df = policy_lib.sample_action(
                        generator, logits[2])
            else:
                a_pe, a_kt = actions[:, t, 0], actions[:, t, 1]
                lp_pe, ent_pe = policy_lib.log_prob_entropy(logits[0], a_pe)
                lp_kt, ent_kt = policy_lib.log_prob_entropy(logits[1], a_kt)
                if ecfg.mix:
                    a_df = actions[:, t, 2]
                    lp_df, ent_df = policy_lib.log_prob_entropy(logits[2],
                                                                a_df)
            if not ecfg.mix:
                a_df, lp_df, ent_df = fixed_df, zero, zero
            carry, r, alive_f, perf_pos = envstep.advance(t, carry, a_pe,
                                                          a_kt, a_df)
            outs.append((r, lp_pe + lp_kt + lp_df, ent_pe + ent_kt + ent_df,
                         alive_f, perf_pos,
                         torch.stack([a_pe, a_kt, a_df], dim=-1))
                        + (() if critic is None
                           else (obs, critic(params, obs, pstate))))
        r, logps, ents, mask, perf, acts, *recorded = (
            torch.stack(z, dim=1) for z in zip(*outs))
        return RolloutOut(
            rewards=r, logps=logps, entropy=ents, mask=mask, perf=perf,
            actions=acts, feasible=carry.alive,
            model_value=torch.sum(perf * mask, dim=1), pmin=carry.pmin_run,
            **dict(zip(("obs", "values"), recorded)))

    return rollout


def _discounted_returns(rewards, discount):
    """G_t = r_t + d * G_{t+1} along the last axis of (E, N) rewards."""
    g = torch.zeros_like(rewards[..., 0])
    G = []
    for t in range(rewards.shape[-1] - 1, -1, -1):
        g = rewards[..., t] + discount * g
        G.append(g)
    return torch.stack(G[::-1], dim=-1)


def policy_gradient_terms(rolls: RolloutOut, discount: float):
    """(pg, G): each episode's policy-gradient term -sum_t logp_t G_std_t
    (E,), with the discounted returns G (E, N) standardized over the
    episode's live steps and held constant."""
    G = _discounted_returns(rolls.rewards * rolls.mask, discount)
    n_valid = torch.clamp_min(rolls.mask.sum(dim=1), 1.0)
    mean = (G * rolls.mask).sum(dim=1) / n_valid
    var = (torch.square(G - mean[:, None]) * rolls.mask).sum(
        dim=1) / n_valid
    G_std = (G - mean[:, None]) / (torch.sqrt(var)[:, None] + 1e-8)
    return -(rolls.logps * G_std.detach() * rolls.mask).sum(dim=1), G


def make_loss_fn(ecfg: env_lib.EnvConfig, pcfg: policy_lib.PolicyConfig,
                 rcfg: ReinforceConfig, env: env_lib.EnvArrays):
    """Build loss_fn(params, pmin, generator, actions=None)
    -> (loss, rolls, returns): E episodes -> the policy-gradient loss."""
    rollout = make_rollout(ecfg, pcfg, env)
    E = rcfg.episodes_per_epoch

    def loss_fn(params, pmin, generator, actions=None):
        rolls = rollout(params, pmin, generator, E, actions)
        pg, G = policy_gradient_terms(rolls, rcfg.discount)
        ent = (rolls.entropy * rolls.mask).sum(dim=1)
        loss = torch.mean(pg) - rcfg.entropy_coef * torch.mean(ent)
        return loss, rolls, G

    return loss_fn


def _pick(values, i):
    """values[i] along dim 0 for a 0-d index tensor, without a host sync."""
    return torch.index_select(values, 0, i.reshape(1))[0]


def next_state(state: SearchState, opt: optim.Adam, grads, pmin, best,
               acts) -> SearchState:
    """The state after an epoch: the Adam step of ``grads`` (a dict by
    parameter name) applied to the params in place, the running ``pmin``,
    and the epoch's best value ``best`` with its (N, 3) actions ``acts``
    taken where it beats the best so far."""
    named = dict(state.params.named_parameters())
    new_params, opt_state = opt.update(
        grads, state.opt_state, {k: p.detach() for k, p in named.items()})
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(new_params[k])
    better = best < state.best_value
    pick = lambda new, old: torch.where(better, new, old)
    return SearchState(
        params=state.params, opt_state=opt_state, pmin=pmin,
        best_value=pick(best, state.best_value),
        best_pe_lvl=pick(acts[:, 0], state.best_pe_lvl),
        best_kt_lvl=pick(acts[:, 1], state.best_kt_lvl),
        best_df=pick(acts[:, 2], state.best_df),
        generator=state.generator, epoch=state.epoch + 1)


def make_epoch_fn(ecfg: env_lib.EnvConfig, pcfg: policy_lib.PolicyConfig,
                  rcfg: ReinforceConfig, env: env_lib.EnvArrays,
                  opt: optim.Adam):
    """Build epoch_fn(state, actions=None) -> (state', metrics): E episodes,
    then one policy-gradient Adam step.  Metrics are 0-d device tensors."""
    loss_fn = make_loss_fn(ecfg, pcfg, rcfg, env)

    def epoch_fn(state: SearchState, actions=None):
        named = dict(state.params.named_parameters())
        loss, rolls, _ = loss_fn(state.params, state.pmin, state.generator,
                                 actions)
        grads = dict(zip(named, torch.autograd.grad(loss, list(
            named.values()))))
        # Track the best feasible whole-model solution seen so far.
        values = torch.where(rolls.feasible, rolls.model_value,
                             torch.inf)
        i = torch.argmin(values)        # the first minimum
        new_state = next_state(state, opt, grads, torch.amin(rolls.pmin),
                               _pick(values, i), _pick(rolls.actions, i))
        metrics = {
            "loss": loss.detach(),
            "best_value": new_state.best_value,
            "mean_value": torch.mean(rolls.model_value),
            "feasible_frac": torch.mean(rolls.feasible.to(torch.float32)),
            "mean_return": torch.mean(
                (rolls.rewards * rolls.mask).sum(dim=1)),
        }
        return new_state, metrics

    return epoch_fn


def init_search(env: env_lib.EnvArrays, ecfg: env_lib.EnvConfig,
                pcfg: policy_lib.PolicyConfig, rcfg: ReinforceConfig,
                opt: optim.Adam) -> SearchState:
    """A fresh stage-1 state: the policy seeded from ``rcfg.seed``, Adam's
    state, no best yet.  With telemetry on, one ``search.prepare`` span
    (``part="policy"``)."""
    with obs_trace.span("search.prepare", part="policy"):
        dev = env.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(rcfg.seed)
        params = policy_lib.init_params(pcfg, gen, dev)
        N = env.num_layers
        return SearchState(
            params=params,
            opt_state=opt.init({k: p.detach()
                                for k, p in params.named_parameters()}),
            pmin=torch.tensor(torch.inf, device=dev),
            best_value=torch.tensor(torch.inf, device=dev),
            best_pe_lvl=torch.zeros((N,), dtype=torch.int64, device=dev),
            best_kt_lvl=torch.zeros((N,), dtype=torch.int64, device=dev),
            best_df=torch.full((N,), ecfg.dataflow, dtype=torch.int64,
                               device=dev),
            generator=gen,
            epoch=torch.zeros((), dtype=torch.int64, device=dev))


# The metrics of an epoch, in the order of the in-place epoch's buffer.
METRICS = ("loss", "best_value", "mean_value", "feasible_frac",
           "mean_return")


def state_tensors(state: SearchState):
    """Every tensor of ``state`` but the params and the generator, in a
    fixed order."""
    opt = state.opt_state
    return ([opt.step, *(opt.mu[k] for k in sorted(opt.mu)),
             *(opt.nu[k] for k in sorted(opt.nu)), state.pmin,
             state.best_value, state.best_pe_lvl, state.best_kt_lvl,
             state.best_df, state.epoch])


def make_inplace_epoch_fn(ecfg: env_lib.EnvConfig,
                          pcfg: policy_lib.PolicyConfig,
                          rcfg: ReinforceConfig, env: env_lib.EnvArrays,
                          opt: optim.Adam):
    """Build epoch_(state, metrics): the epoch of :func:`make_epoch_fn`
    written back in place -- the new params, Adam state, pmin, best value,
    best actions and epoch into ``state``'s own tensors, the
    :data:`METRICS` into the (5,) float32 tensor ``metrics`` -- so that
    every epoch reads and writes the same buffers.  The same bits as
    :func:`make_epoch_fn`."""
    epoch_fn = make_epoch_fn(ecfg, pcfg, rcfg, env, opt)

    def epoch_(state: SearchState, metrics: torch.Tensor):
        new, m = epoch_fn(state)       # updates the params in place
        with torch.no_grad():
            for old, val in zip(state_tensors(state), state_tensors(new)):
                old.copy_(val)
            metrics.copy_(torch.stack([m[k] for k in METRICS]))

    return epoch_


def clone_state(state: SearchState) -> SearchState:
    """A copy of ``state`` that shares no tensor and no generator with it."""
    gen = torch.Generator(device=state.generator.device)
    gen.set_state(state.generator.get_state())
    opt = state.opt_state
    c = lambda t: t.detach().clone()
    return SearchState(
        params=copy.deepcopy(state.params),
        opt_state=optim.OptState(
            c(opt.step), {k: c(v) for k, v in opt.mu.items()},
            {k: c(v) for k, v in opt.nu.items()}),
        pmin=c(state.pmin), best_value=c(state.best_value),
        best_pe_lvl=c(state.best_pe_lvl), best_kt_lvl=c(state.best_kt_lvl),
        best_df=c(state.best_df), generator=gen, epoch=c(state.epoch))


class EpochRunner:
    """Stage-1 epochs in place on ``state``, which it owns (its tensors
    and generator are the static buffers).

    One epoch (:func:`make_inplace_epoch_fn`, or another in-place epoch
    whose metrics are ``names``) also writes its metrics into column
    ``slot`` of a (len(names), capacity) history on the device and moves
    ``slot`` on, modulo the capacity.  On the card that epoch is captured
    once as a CUDA graph, after warm-up epochs on a copy of the state (so
    the run's own generator does not move), and :meth:`step` replays it;
    on the CPU :meth:`step` runs it eagerly.
    """

    def __init__(self, state: SearchState, epoch_, capacity: int,
                 names=METRICS):
        dev = state.pmin.device
        self.state = state
        self.names = tuple(names)
        self._epoch = epoch_
        self.metrics = torch.zeros((len(self.names),), device=dev)
        self.hist = torch.zeros((len(self.names), max(capacity, 1)),
                                device=dev)
        self.slot = torch.zeros((), dtype=torch.int64, device=dev)
        self.graph = None
        self._events = []
        if dev.type == "cuda":
            scratch = clone_state(state)
            scratch_metrics = torch.zeros_like(self.metrics)
            self.graph = graph_lib.CapturedStep(
                self._one, lambda: epoch_(scratch, scratch_metrics), dev,
                generators=(state.generator,))

    def _one(self):
        self._epoch(self.state, self.metrics)
        self.hist.index_copy_(1, self.slot.view(1), self.metrics.view(-1, 1))
        torch.remainder(self.slot + 1, self.hist.shape[1], out=self.slot)

    def step(self):
        """One epoch: a replay of the graph on the card, eager on the CPU."""
        if self.graph is None:
            self._one()
        else:
            self.graph.replay()

    def run(self, n: int):
        """``n`` epochs (at most the capacity); their history, read back to
        the host in one sync, as a dict of (n,) float32 arrays.

        On the card with telemetry on, a pair of CUDA events brackets each
        replay, and two counters go on the innermost open span (the
        ``search.chunk`` around this call) once the history's readback has
        waited for the events: ``device_us``, the sum of the replays' own
        times, and ``stream_us``, from the first replay's start to the last
        one's end.  ``stream_us - device_us`` is the time the stream spent
        between replays.  A start event is stamped when it reaches the
        device, so where the device was already waiting for the host a
        replay's time holds the graph launch's own latency: ``device_us``
        bounds the busy time from above, the difference the idle time
        from below."""
        self.slot.zero_()
        span = obs_trace.current()
        marks = (self._marks(n) if self.graph is not None
                 and span is not obs_trace.NULL_SPAN else None)
        if marks is None:
            for _ in range(n):
                self.step()
        else:
            for start, end in marks:
                start.record()
                self.graph.replay()
                end.record()
        h = self.hist[:, :n].to("cpu", copy=True).numpy()
        if marks:
            span.set(
                device_us=round(sum(s.elapsed_time(e) for s, e in marks)
                                * 1e3, 3),
                stream_us=round(marks[0][0].elapsed_time(marks[-1][1])
                                * 1e3, 3))
        return {k: h[i] for i, k in enumerate(self.names)}

    def _marks(self, n: int):
        """``n`` (start, end) pairs of timing events, made once and kept."""
        while len(self._events) < n:
            self._events.append(tuple(torch.cuda.Event(enable_timing=True)
                                      for _ in range(2)))
        return self._events[:n]


def run_search(workload, ecfg: env_lib.EnvConfig,
               rcfg: ReinforceConfig = ReinforceConfig(),
               pcfg: Optional[policy_lib.PolicyConfig] = None,
               state: Optional[SearchState] = None,
               chunk: int = 500,
               on_chunk=None,
               device="cuda",
               env: Optional[env_lib.EnvArrays] = None):
    """Full stage-1 search.  Returns (state, history dict of (epochs,) arrays).

    Runs in chunks of ``chunk`` epochs; ``on_chunk(state, chunk_history,
    epochs_done)`` fires after each chunk.  The history of a chunk is read
    back to the host once, at its end.  The epochs run in place on a copy
    of ``state`` (a fresh state if None), through one CUDA graph on the
    card (:class:`EpochRunner`); ``on_chunk`` and the result get copies,
    and a run resumed from one gives the bits of an uninterrupted run.
    """
    if env is None:
        env = env_lib.make_env(workload, ecfg, device)
    pcfg = pcfg or policy_lib.PolicyConfig(obs_dim=ecfg.obs_dim, mix=ecfg.mix,
                                           levels=ecfg.levels)
    opt = optim.Adam(lr=rcfg.lr)
    state = (init_search(env, ecfg, pcfg, rcfg, opt) if state is None
             else clone_state(state))
    if rcfg.epochs <= 0:
        return state, {}
    runner = EpochRunner(
        state, make_inplace_epoch_fn(ecfg, pcfg, rcfg, env, opt),
        min(max(int(chunk), 1), rcfg.epochs) if chunk else rcfg.epochs)

    def run_chunk(_, n):
        hist = runner.run(n)
        return clone_state(runner.state), hist

    state, history = chunk_lib.drive(
        state, rcfg.epochs, chunk, run_chunk, on_chunk,
        engine="reinforce", evals_per_step=rcfg.episodes_per_epoch)
    return state, chunk_lib.concat_hist_dict(history)


def solution_arrays(state: SearchState, env: env_lib.EnvArrays):
    """Decode the best solution's raw (pe, kt, df) arrays."""
    pe = env.pe_table[state.best_pe_lvl]
    kt = env.kt_table[state.best_kt_lvl]
    return pe, kt, state.best_df
