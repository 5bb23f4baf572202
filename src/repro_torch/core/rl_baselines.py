"""Actor-critic RL baselines: A2C [47] and PPO2 [66] (discrete variants).

Port of ``repro.core.rl_baselines``: the paper's Table V baselines, on the
same environment, observation, reward shaping and LSTM trunk as the
REINFORCE agent, plus a linear value head (the critic, ``head_v``).

An epoch runs E episodes as a batch of E rows (:func:`make_ac_rollout`):
each of the N steps is one LSTM-kernel launch and one cost-kernel launch
at (E, 1), under ``torch.no_grad()`` (the reference never differentiates
its rollout; PPO's old log-probs come from it).  The losses re-run the
policy over the stored observations (:func:`eval_sequence`): one LSTM
forward at (E, obs_dim, H) a step through ``LSTMCellFn``, so the backward
kernel runs once a step at B = E.  A2C takes one clipped Adam step an
epoch; PPO2 takes ``ppo_updates``, each a fresh :func:`eval_sequence`.

As in :mod:`repro_torch.core.reinforce`, the policy module is updated in
place; :func:`run_ac_search` runs on a copy of the state it is given and
hands ``on_chunk`` copies, so a resumed run gives the bits of an
uninterrupted one.  The epochs run eagerly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import chunk as chunk_lib
from repro_torch.core import env as env_lib
from repro_torch.core import policy as policy_lib
from repro_torch.core import reinforce
from repro_torch.training import optim


@dataclasses.dataclass(frozen=True)
class ACConfig:
    algo: str = "a2c"            # "a2c" | "ppo2"
    epochs: int = 5000
    episodes_per_epoch: int = 4
    lr: float = 1e-3
    discount: float = 0.9
    gae_lambda: float = 0.95
    clip_eps: float = 0.2        # PPO clip
    ppo_updates: int = 4         # PPO inner epochs
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    seed: int = 0


def init_ac_params(pcfg: policy_lib.PolicyConfig,
                   generator: torch.Generator, device="cpu"):
    """Policy + critic params: the policy's init, then ``head_v.w`` as
    N(0, 1) x 0.01 and a zero bias."""
    return policy_lib.init_params(pcfg, generator, device, critic=True)


def _value(params, feat):
    return (feat @ params.head_v["w"] + params.head_v["b"])[..., 0]


def _check_critic(pcfg: policy_lib.PolicyConfig):
    # The critic reads h' for the RNN and the observation for the MLP, as
    # in the reference, whose MLP variant then fails on the product's
    # shapes unless obs_dim == hidden.
    if pcfg.kind != "rnn" and pcfg.obs_dim != pcfg.hidden:
        raise ValueError(
            f"a2c/ppo2 with kind={pcfg.kind!r}: the critic (hidden, 1) reads "
            f"the {pcfg.obs_dim}-dim observation; the reference fails there "
            "too (use kind='rnn')")


def make_ac_rollout(ecfg: env_lib.EnvConfig, pcfg: policy_lib.PolicyConfig,
                    env: env_lib.EnvArrays):
    """Build rollout(params, pmin, generator, E, actions=None) ->
    ``reinforce.RolloutOut``: the REINFORCE rollout with the critic, so it
    also records the observations and values, run under
    ``torch.no_grad()``.  ``actions`` (E, N, 3), when given, replaces the
    sampled actions (the tests replay the reference's draws).
    """
    _check_critic(pcfg)
    rnn = pcfg.kind == "rnn"
    return torch.no_grad()(reinforce.make_rollout(
        ecfg, pcfg, env,
        critic=lambda params, obs, ps: _value(params, ps.h if rnn else obs)))


def eval_sequence(params, pcfg: policy_lib.PolicyConfig, obs_seq, actions):
    """Re-run the policy over stored observations for E episodes at once.

    obs_seq (E, N, obs_dim), actions (E, N, 3) -> per-step (log-prob,
    value, entropy), each (E, N), differentiable in ``params``.
    """
    E, N = obs_seq.shape[:2]
    steps = obs_seq.transpose(0, 1).contiguous()     # (N, E, obs_dim)
    pstate = policy_lib.init_state(pcfg, (E,), obs_seq.device)
    lps, vs, ents = [], [], []
    for t in range(N):
        obs = steps[t]
        logits, pstate = policy_lib.step(params, pcfg, obs, pstate)
        vs.append(_value(params, pstate.h if pcfg.kind == "rnn" else obs))
        lp, ent = 0.0, 0.0
        for idx, lg in enumerate(logits):
            logp_all = torch.log_softmax(lg, dim=-1)
            lp = lp + torch.gather(logp_all, -1,
                                   actions[:, t, idx, None])[..., 0]
            ent = ent - torch.sum(torch.exp(logp_all) * logp_all, dim=-1)
        lps.append(lp)
        ents.append(ent)
    return (torch.stack(lps, dim=1), torch.stack(vs, dim=1),
            torch.stack(ents, dim=1))


def _gae(rewards, values, mask, gamma, lam):
    """Generalized advantage estimation along the last axis of (E, N)
    masked episodes: a reversed scan."""
    adv_next = torch.zeros_like(rewards[..., 0])
    v_next = torch.zeros_like(rewards[..., 0])
    advs = []
    for t in range(rewards.shape[-1] - 1, -1, -1):
        r, v, m = rewards[..., t], values[..., t], mask[..., t]
        delta = r + gamma * v_next * m - v
        adv_next = delta + gamma * lam * adv_next * m
        v_next = v
        advs.append(adv_next)
    return torch.stack(advs[::-1], dim=-1)


def advantages(rolls: reinforce.RolloutOut, acfg: ACConfig):
    """(normalized advantages, returns) of a rollout, both (E, N): GAE on
    the masked rewards and values, returns = adv + masked values, and the
    advantages normalized over the valid steps of all E episodes."""
    adv = _gae(rolls.rewards * rolls.mask, rolls.values * rolls.mask,
               rolls.mask, acfg.discount, acfg.gae_lambda)
    ret = adv + rolls.values * rolls.mask
    nv = torch.clamp_min(rolls.mask.sum(), 1.0)
    am = (adv * rolls.mask).sum() / nv
    astd = torch.sqrt((torch.square(adv - am) * rolls.mask).sum() / nv)
    adv = (adv - am) / (astd + 1e-8) * rolls.mask
    return adv, ret


def make_losses(pcfg: policy_lib.PolicyConfig, acfg: ACConfig):
    """(a2c_loss(params, rolls, adv, ret), ppo_loss(params, rolls, adv,
    ret, logp_old)): the reference's two losses, scalars with the graph."""
    def _common(params, rolls, ret):
        lps, vs, ents = eval_sequence(params, pcfg, rolls.obs, rolls.actions)
        vl = torch.mean((torch.square(vs - ret) * rolls.mask).sum(dim=1))
        el = torch.mean((ents * rolls.mask).sum(dim=1))
        return lps, acfg.value_coef * vl - acfg.entropy_coef * el

    def a2c_loss(params, rolls, adv, ret):
        lps, rest = _common(params, rolls, ret)
        pl = -torch.mean((lps * adv.detach() * rolls.mask).sum(dim=1))
        return pl + rest

    def ppo_loss(params, rolls, adv, ret, logp_old):
        lps, rest = _common(params, rolls, ret)
        ratio = torch.exp(lps - logp_old)
        adv_sg = adv.detach()
        un = ratio * adv_sg
        cl = torch.clamp(ratio, 1 - acfg.clip_eps, 1 + acfg.clip_eps) * adv_sg
        pl = -torch.mean((torch.minimum(un, cl) * rolls.mask).sum(dim=1))
        return pl + rest

    return a2c_loss, ppo_loss


def init_ac_search(env: env_lib.EnvArrays, ecfg: env_lib.EnvConfig,
                   pcfg: policy_lib.PolicyConfig, acfg: ACConfig,
                   opt: optim.Adam) -> reinforce.SearchState:
    """Fresh A2C/PPO2 search state (policy + critic params, empty best)."""
    dev = env.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(acfg.seed)
    params = init_ac_params(pcfg, gen, dev)
    N = env.num_layers
    return reinforce.SearchState(
        params=params,
        opt_state=opt.init({k: p.detach()
                            for k, p in params.named_parameters()}),
        pmin=torch.tensor(torch.inf, device=dev),
        best_value=torch.tensor(torch.inf, device=dev),
        best_pe_lvl=torch.zeros((N,), dtype=torch.int64, device=dev),
        best_kt_lvl=torch.zeros((N,), dtype=torch.int64, device=dev),
        best_df=torch.full((N,), ecfg.dataflow, dtype=torch.int64,
                           device=dev),
        generator=gen, epoch=torch.zeros((), dtype=torch.int64, device=dev))


def make_ac_epoch_fn(ecfg: env_lib.EnvConfig, pcfg: policy_lib.PolicyConfig,
                     acfg: ACConfig, env: env_lib.EnvArrays,
                     opt: optim.Adam):
    """Build epoch_fn(state, actions=None) -> (state', metrics): E episodes,
    GAE, then one A2C step or ``ppo_updates`` PPO steps; the params are
    updated in place.  Metrics are 0-d device tensors."""
    rollout = make_ac_rollout(ecfg, pcfg, env)
    a2c_loss, ppo_loss = make_losses(pcfg, acfg)
    E = acfg.episodes_per_epoch
    if acfg.algo not in ("a2c", "ppo2"):
        raise ValueError(f"unknown actor-critic algo {acfg.algo!r}")

    def step(state, opt_state, loss):
        named = dict(state.params.named_parameters())
        grads = dict(zip(named, torch.autograd.grad(loss, list(
            named.values()))))
        new_params, opt_state = opt.update(
            grads, opt_state, {k: p.detach() for k, p in named.items()})
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(new_params[k])
        return opt_state

    def epoch_fn(state: reinforce.SearchState, actions=None):
        rolls = rollout(state.params, state.pmin, state.generator, E,
                        actions)
        adv, ret = advantages(rolls, acfg)
        opt_state = state.opt_state
        if acfg.algo == "a2c":
            opt_state = step(state, opt_state,
                             a2c_loss(state.params, rolls, adv, ret))
        else:
            for _ in range(acfg.ppo_updates):
                opt_state = step(state, opt_state, ppo_loss(
                    state.params, rolls, adv, ret, rolls.logps))
        values = torch.where(rolls.feasible, rolls.model_value, torch.inf)
        i = torch.argmin(values)
        best_i = reinforce._pick(values, i)
        better = best_i < state.best_value
        acts = reinforce._pick(rolls.actions, i)
        pick = lambda new, old: torch.where(better, new, old)
        new_state = reinforce.SearchState(
            params=state.params, opt_state=opt_state,
            pmin=torch.amin(rolls.pmin),
            best_value=torch.where(better, best_i, state.best_value),
            best_pe_lvl=pick(acts[:, 0], state.best_pe_lvl),
            best_kt_lvl=pick(acts[:, 1], state.best_kt_lvl),
            best_df=pick(acts[:, 2], state.best_df),
            generator=state.generator, epoch=state.epoch + 1)
        metrics = {
            "best_value": new_state.best_value,
            "mean_value": torch.mean(rolls.model_value),
            "feasible_frac": torch.mean(rolls.feasible.to(torch.float32)),
        }
        return new_state, metrics

    return epoch_fn


def run_ac_search(workload, ecfg: env_lib.EnvConfig,
                  acfg: ACConfig = ACConfig(),
                  pcfg: Optional[policy_lib.PolicyConfig] = None,
                  state: Optional[reinforce.SearchState] = None,
                  chunk: int = 500,
                  on_chunk=None,
                  device="cuda",
                  env: Optional[env_lib.EnvArrays] = None):
    """A2C / PPO2 search with the interface of ``reinforce.run_search``.

    Returns (state, history dict of (epochs,) arrays).  Runs on a copy of
    ``state`` (a fresh state if None) in chunks of ``chunk`` epochs;
    ``on_chunk(state, chunk_history, epochs_done)`` gets a copy after each
    chunk.  A chunk's history is read back to the host once, at its end.
    """
    if env is None:
        env = env_lib.make_env(workload, ecfg, device)
    pcfg = pcfg or policy_lib.PolicyConfig(obs_dim=ecfg.obs_dim, mix=ecfg.mix,
                                           levels=ecfg.levels)
    opt = optim.Adam(lr=acfg.lr, clip_norm=1.0)
    state = (init_ac_search(env, ecfg, pcfg, acfg, opt) if state is None
             else reinforce.clone_state(state))
    epoch_fn = make_ac_epoch_fn(ecfg, pcfg, acfg, env, opt)
    live = [state]

    def run_chunk(_, n):
        metrics = []
        for _ in range(n):
            live[0], m = epoch_fn(live[0])
            metrics.append(torch.stack(list(m.values())))
        h = torch.stack(metrics, dim=1).cpu().numpy()
        return (reinforce.clone_state(live[0]),
                {k: h[i] for i, k in enumerate(m)})

    state, history = chunk_lib.drive(
        state, acfg.epochs, chunk, run_chunk, on_chunk,
        engine=acfg.algo, evals_per_step=acfg.episodes_per_epoch)
    return state, chunk_lib.concat_hist_dict(history)
