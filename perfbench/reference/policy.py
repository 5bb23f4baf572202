"""The first epochs of ConfuciuX's stage 1 (REINFORCE), in plain PyTorch.

A second, independent statement of the search's policy step, written
from the paper and the program's documented semantics: the LSTM(128)
policy with its two L-way heads, Eq. (1)'s observation, the reward
R = P_t - P_min with the violation penalty, the discounted and
standardised returns, the policy-gradient loss and one Adam step an
epoch.  It imports nothing of the program.

Both sides start from the search's seed alone.  A search draws, from one
``torch.Generator`` seeded with it, the glorot-normal weights (``randn``
of head_pe.w, head_kt.w, [head_df.w,] lstm.wx, lstm.wh, in that order),
then two ``rand((E, L))`` uniforms a layer (PE head, then buffer head),
turned into actions by Gumbel-max.  So the reference, on the same device,
draws the same numbers and can follow the program's first epochs exactly,
as long as no draw falls within rounding of a tie: the smallest Gumbel-max
margin (and the smallest distance of the budget left from 0) of each
epoch is returned, and the comparison stops before an epoch that comes
within :data:`TIE` of one.

``mode="tf32"`` computes every product with operands rounded to TF32
(10-bit mantissa, float32 accumulation), forward and backward: the
control, the precision just below the configurations' float32 with TF32
off.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import costmodel

# A Gumbel-max margin, or a relative distance of the budget left from 0,
# under which rounding could decide the draw: the comparison stops there.
TIE = 1e-4


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest TF32 value (ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a, b = _tf32(a), _tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _tf32(g)
        return g @ b.T, a.T @ g


def _matmul(mode):
    if mode == "f32":
        return torch.matmul
    if mode == "tf32":
        return _TF32MatMul.apply
    raise ValueError(f"unknown mode {mode!r}")


def static_obs(layers_np: np.ndarray) -> np.ndarray:
    """The 7 layer features of Eq. (1), each divided by its largest value
    in the model (at least 1), scaled to [-1, 1]."""
    obs = layers_np[:, :7].astype(np.float64)
    maxes = np.maximum(obs.max(axis=0), 1.0)
    return (2.0 * obs / maxes - 1.0).astype(np.float32)


def init_params(gen, obs_dim, hidden, levels, mix, device):
    """Glorot-normal weights drawn in the program's order; zero biases and
    a forget-gate bias of 1."""
    H, L = hidden, levels
    shapes = [("head_pe.w", (H, L)), ("head_kt.w", (H, L))]
    if mix:
        shapes.append(("head_df.w", (H, 3)))
    shapes += [("lstm.wx", (obs_dim, 4 * H)), ("lstm.wh", (H, 4 * H))]
    p = {}
    for name, shape in shapes:
        scale = float(np.sqrt(2.0 / (shape[0] + shape[-1])))
        p[name] = torch.randn(shape, generator=gen, device=device) * scale
    p["head_pe.b"] = torch.zeros((L,), device=device)
    p["head_kt.b"] = torch.zeros((L,), device=device)
    if mix:
        p["head_df.b"] = torch.zeros((3,), device=device)
    b = torch.zeros((4 * H,), device=device)
    b[H:2 * H] = 1.0
    p["lstm.b"] = b
    return {k: v.requires_grad_(True) for k, v in p.items()}


def _sample(gen, logits):
    """Gumbel-max action, its log-probability and entropy, and the margin
    between the two largest perturbed logits."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    tiny = torch.finfo(torch.float32).tiny
    v = logits.detach() - torch.log(-torch.log(u.clamp_min(tiny)))
    a = torch.argmax(v, dim=-1)
    top2 = torch.topk(v, 2, dim=-1).values
    logp = torch.log_softmax(logits, dim=-1)
    lp = torch.gather(logp, -1, a[..., None])[..., 0]
    ent = -torch.sum(torch.exp(logp) * logp, dim=-1)
    return a, lp, ent, torch.amin(top2[..., 0] - top2[..., 1])


def replay(config: dict, seed: int, epochs: int = 3, episodes: int = 1,
           lr: float = 3e-3, discount: float = 0.9, device="cpu",
           mode: str = "f32"):
    """The first ``epochs`` epochs of a stage-1 search with ``seed`` on a
    configuration (its layer table, env, budget fraction and policy).

    Returns a list, an entry an epoch, of dicts: ``loss``, ``mean_value``
    (the mean over the episodes of the objective summed over the layers
    each reached), ``best_value`` (best feasible whole-model objective so
    far, inf if none), ``loss_scale`` (the sum of the loss terms' absolute
    values, the scale its rounding is judged against), ``margin`` (the
    smallest Gumbel-max margin of the epoch's draws) and
    ``budget_margin`` (the smallest distance of an episode's budget left
    from 0, over the budget).
    """
    layers_np = np.asarray(config["layers"], np.int64)
    env, policy = config["env"], config["policy"]
    if env["objective"] not in ("latency", "energy"):
        raise ValueError("the per-layer reward needs a per-layer objective")
    mm = _matmul(mode)
    dev = torch.device(device)
    mix = bool(env.get("mix", False))
    levels = int(env["levels"])
    H = int(policy.get("hidden", 128))
    obs_dim = 11 if mix else 10
    E = int(episodes)
    N = layers_np.shape[0]
    layers = torch.as_tensor(layers_np, dtype=torch.float32, device=dev)
    sobs = torch.as_tensor(static_obs(layers_np), device=dev)
    t_norm = 2.0 * torch.arange(N, dtype=torch.float32, device=dev) / max(
        N - 1, 1) - 1.0
    pe_table = torch.as_tensor(costmodel.pe_levels(levels),
                               dtype=torch.float32, device=dev)
    kt_table = torch.as_tensor(costmodel.kt_levels(levels),
                               dtype=torch.float32, device=dev)
    budget = torch.tensor(np.float32(costmodel.budget(
        layers, env, config["budget"]["platform_fraction"])), device=dev)
    finite_budget = bool(torch.isfinite(budget))
    Lm1 = max(levels - 1, 1)
    lp_ = env["scenario"] == "LP"

    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    params = init_params(gen, obs_dim, H, levels, mix, dev)
    names = list(params)
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    step = torch.zeros((), dtype=torch.int32, device=dev)
    pmin = torch.tensor(math.inf, device=dev)
    best = torch.tensor(math.inf, device=dev)
    out = []
    for _ in range(epochs):
        h = torch.zeros((E, H), device=dev)
        c = torch.zeros((E, H), device=dev)
        minus1 = torch.full((E,), -1.0, device=dev)
        prev = [minus1, minus1] + ([minus1] if mix else [])
        left = budget.expand(E)
        alive = torch.ones((E,), dtype=torch.bool, device=dev)
        acc_r = torch.zeros((E,), device=dev)
        pmin_run = pmin.expand(E)
        inf = torch.tensor(math.inf, device=dev)
        margin, budget_margin = inf, inf
        rs, lps, masks, perfs = [], [], [], []
        for t in range(N):
            x = torch.cat([sobs[t].expand(E, 7), torch.stack(prev, -1),
                           t_norm[t].expand(E, 1)], dim=-1)
            gates = (mm(x, params["lstm.wx"]) + mm(h, params["lstm.wh"])
                     + params["lstm.b"])
            i = torch.sigmoid(gates[:, :H])
            f = torch.sigmoid(gates[:, H:2 * H])
            g = torch.tanh(gates[:, 2 * H:3 * H])
            o = torch.sigmoid(gates[:, 3 * H:])
            c = f * c + i * g
            h = o * torch.tanh(c)
            heads = ["pe", "kt"] + (["df"] if mix else [])
            acts, lp = [], 0.0
            for head in heads:
                logits = mm(h, params[f"head_{head}.w"]) + params[
                    f"head_{head}.b"]
                a, lp_h, _, m = _sample(gen, logits)
                acts.append(a)
                lp = lp + lp_h
                margin = torch.minimum(margin, m)
            a_pe, a_kt = acts[0], acts[1]
            a_df = (acts[2] if mix else torch.full(
                (E,), int(env["dataflow"]), dtype=torch.int64, device=dev))
            cost = costmodel.layer_costs(layers[t], pe_table[a_pe],
                                         kt_table[a_kt],
                                         a_df.to(torch.float32))
            perf = cost.latency if env["objective"] == "latency" \
                else cost.energy
            cons = cost.area if env["constraint"] == "area" else cost.power
            P_t = -perf
            if lp_:
                left = left - cons
                viol = alive & (left < 0)
                dist = torch.abs(left)
            else:
                viol = alive & (cons > budget)
                dist = torch.abs(cons - budget)
            if finite_budget:
                budget_margin = torch.minimum(budget_margin, torch.amin(
                    torch.where(alive, dist, math.inf)) / budget)
            pmin_run = torch.where(alive, torch.minimum(pmin_run, P_t),
                                   pmin_run)
            alive_f = alive.to(torch.float32)
            r = torch.where(viol, -acc_r, P_t - pmin_run) * alive_f
            acc_r = acc_r + torch.where(alive & ~viol, r, 0.0)
            prev = [2.0 * a_pe / Lm1 - 1.0, 2.0 * a_kt / Lm1 - 1.0] + (
                [a_df.to(torch.float32) - 1.0] if mix else [])
            alive = alive & ~viol
            rs.append(r)
            lps.append(lp)
            masks.append(alive_f)
            perfs.append(perf)
        rew, logps = torch.stack(rs, 1), torch.stack(lps, 1)
        mask, perf = torch.stack(masks, 1), torch.stack(perfs, 1)
        gret, G = torch.zeros_like(rew[:, 0]), []
        for t in range(N - 1, -1, -1):
            gret = rew[:, t] * mask[:, t] + discount * gret
            G.append(gret)
        G = torch.stack(G[::-1], 1)
        n = torch.clamp_min(mask.sum(1), 1.0)
        mean = (G * mask).sum(1) / n
        var = (torch.square(G - mean[:, None]) * mask).sum(1) / n
        G_std = ((G - mean[:, None]) / (torch.sqrt(var)[:, None] + 1e-8)
                 ).detach()
        terms = logps * G_std * mask
        loss = torch.mean(-terms.sum(1))
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        model_value = torch.sum(perf * mask, 1).detach()
        values = torch.where(alive, model_value, math.inf)
        best = torch.minimum(best, torch.amin(values))
        pmin = torch.amin(pmin_run).detach()
        with torch.no_grad():
            step = step + 1
            tt = step.to(torch.float32)
            bc1, bc2 = 1 - 0.9 ** tt, 1 - 0.999 ** tt
            for k, gk in zip(names, grads):
                mu[k] = 0.9 * mu[k] + (1 - 0.9) * gk
                nu[k] = 0.999 * nu[k] + (1 - 0.999) * gk * gk
                upd = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + 1e-8)
                params[k] = (params[k] - lr * upd).requires_grad_(True)
        out.append({"loss": float(loss.detach()),
                    "mean_value": float(torch.mean(model_value)),
                    "best_value": float(best),
                    "loss_scale": float(torch.mean(
                        terms.detach().abs().sum(1))),
                    "margin": float(margin),
                    "budget_margin": float(budget_margin)})
    return out
