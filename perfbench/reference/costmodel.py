"""The hard MAESTRO-style cost model of ConfuciuX, in plain PyTorch.

A frozen copy of the arithmetic of the port's hard path
(``repro_torch.costmodel.maestro.core_cost`` with
``primitives.HARD`` and ``dataflows.l1_bytes_formula``), written out
again so that the benchmark holds the program to an independent
statement of the model.  It imports nothing of the program.

Every function takes a ``dtype``: ``torch.float32`` is the precision the
configurations state; ``torch.bfloat16`` is the control, the next
precision below, which the comparison must reject.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# Layer descriptor columns: (K, C, Y, X, R, S, type, repeat).
NUM_FIELDS = 8
DWCONV = 1
DLA, EYE, SHI = 0, 1, 2

# Hardware constants, as the model states them.
E_MAC, E_L1, E_L2, E_DRAM = 1.0, 1.0, 6.0, 200.0
L1_ACC_PER_MAC = 3.0
P_MAC_MW, P_L1_MW_B, P_L2_MW_B, P_NOC_MW_PE = 1.0, 0.005, 0.002, 0.1
LEAK_PE_MW, LEAK_L1_MW_B = 0.05, 0.001
A_MAC_UM2, A_L1_UM2_B, A_L2_UM2_B, A_NOC_UM2_PE = 2000.0, 50.0, 25.0, 300.0
DRAM_BW, L2_BW_BASE, L2_BW_SQRT, FILL_CYCLES = 16.0, 8.0, 8.0, 20.0

# The paper's Table I action levels.
PE_LEVELS = {10: [1, 2, 4, 8, 16, 24, 32, 48, 64, 128],
             12: [1, 2, 4, 8, 12, 16, 24, 32, 48, 64, 96, 128],
             14: [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128]}


class Costs(NamedTuple):
    latency: torch.Tensor
    energy: torch.Tensor
    area: torch.Tensor
    power: torch.Tensor


def pe_levels(levels: int):
    return PE_LEVELS[levels]


def kt_levels(levels: int):
    return list(range(1, levels + 1))


def _cdiv(a, b):
    return torch.ceil(a / torch.clamp_min(b, 1.0))


def _clip(x, lo, hi):
    return torch.clamp_max(torch.clamp_min(x, lo), hi)


def _factorize(pe, d1, d2):
    p1 = _clip(pe, 1.0, torch.clamp_min(d1, 1.0))
    p2 = _clip(torch.floor(pe / p1), 1.0, torch.clamp_min(d2, 1.0))
    return p1, p2


def layer_costs(layers: torch.Tensor, pe, kt, df,
                dtype=torch.float32) -> Costs:
    """Per-layer costs of the assignment (pe, kt, df), each broadcast
    against the (..., NUM_FIELDS) ``layers``; values include the layer's
    ``repeat``.  Computed in ``dtype`` throughout."""
    cast = lambda v: torch.as_tensor(v, device=layers.device).to(dtype)
    K, C, Y, X, R, S, ltype, repeat = (cast(layers[..., i])
                                       for i in range(NUM_FIELDS))
    pe = torch.clamp_min(cast(pe), 1.0)
    kt = torch.clamp_min(cast(kt), 1.0)
    df = cast(df)
    is_dla, is_eye, is_shi = ((df == v).to(dtype) for v in (DLA, EYE, SHI))
    dw = (ltype == DWCONV).to(dtype) > 0
    rs = R * S
    l1_bytes = torch.where(df == DLA, kt * rs + rs + kt,
                           torch.where(df == EYE, kt * S + S + kt,
                                       rs + 2 * kt))

    Yp = torch.clamp_min(Y - R + 1.0, 1.0)
    Xp = torch.clamp_min(X - S + 1.0, 1.0)
    C_red = torch.where(dw, torch.ones_like(C), C)
    K_out = torch.where(dw, C, K)
    macs = K_out * C_red * Yp * Xp * R * S
    W_u = K_out * C_red * R * S
    A_u = C * Y * X
    O_u = K_out * Yp * Xp

    Ku = _cdiv(K_out, kt)
    # dla: parallel over (Ku, C_red), weight-stationary.
    p1d, p2d = _factorize(pe, Ku, C_red)
    t1d, t2d = _cdiv(Ku, p1d), _cdiv(C_red, p2d)
    kt_eff_d = torch.clamp_max(kt, _cdiv(K_out, p1d * t1d))
    comp_dla = t1d * t2d * kt_eff_d * R * S * Yp * Xp
    a_passes_dla = torch.where(dw, torch.ones_like(t1d), t1d)
    l2_dla = W_u + A_u * a_passes_dla + O_u * p2d
    # eye: parallel over (Y', R), row-stationary.
    p1e, p2e = _factorize(pe, Yp, R)
    t1e, t2e = _cdiv(Yp, p1e), _cdiv(R, p2e)
    kt_eff_e = torch.clamp_max(kt, K_out)
    comp_eye = t1e * t2e * C_red * Ku * kt_eff_e * S * Xp
    halo_e = (p1e + R - 1.0) / torch.clamp_min(p1e, 1.0)
    a_passes_eye = torch.where(dw, torch.ones_like(Ku), Ku)
    l2_eye = W_u * t1e + A_u * a_passes_eye * halo_e + O_u * p2e
    # shi: parallel over (Y', X'), output-stationary.
    p1s, p2s = _factorize(pe, Yp, Xp)
    t1s, t2s = _cdiv(Yp, p1s), _cdiv(Xp, p2s)
    kt_eff_s = torch.clamp_max(kt, K_out)
    comp_shi = t1s * t2s * C_red * Ku * kt_eff_s * R * S
    halo_s = ((p1s + R - 1.0) * (p2s + S - 1.0)) / torch.clamp_min(
        p1s * p2s, 1.0)
    l2_shi = W_u * t1s * t2s + A_u * halo_s + O_u

    comp = is_dla * comp_dla + is_eye * comp_eye + is_shi * comp_shi
    l2 = is_dla * l2_dla + is_eye * l2_eye + is_shi * l2_shi
    passes_w = is_dla * 1.0 + is_eye * t1e + is_shi * (t1s * t2s)
    passes_a = is_dla * a_passes_dla + is_eye * a_passes_eye + is_shi * 1.0

    l2_bytes = 2.0 * pe * l1_bytes
    spill_w = _clip(1.0 - l2_bytes / torch.clamp_min(W_u, 1.0), 0.0, 1.0)
    spill_a = _clip(1.0 - l2_bytes / torch.clamp_min(A_u, 1.0), 0.0, 1.0)
    dram = (W_u * (1.0 + (passes_w - 1.0) * spill_w)
            + A_u * (1.0 + (passes_a - 1.0) * spill_a) + O_u)
    l2_bw = L2_BW_BASE + L2_BW_SQRT * torch.sqrt(pe)
    lat = (torch.maximum(torch.maximum(comp, l2 / l2_bw), dram / DRAM_BW)
           + torch.sqrt(pe) + FILL_CYCLES)
    leak = LEAK_PE_MW * pe + LEAK_L1_MW_B * l1_bytes * pe
    energy = (E_MAC * macs + E_L1 * (L1_ACC_PER_MAC * macs + l2)
              + E_L2 * l2 + E_DRAM * dram + leak * lat)
    area = (A_MAC_UM2 * pe + A_L1_UM2_B * l1_bytes * pe
            + A_L2_UM2_B * l2_bytes + A_NOC_UM2_PE * pe)
    power = (P_MAC_MW * pe + P_L1_MW_B * l1_bytes * pe
             + P_L2_MW_B * l2_bytes + P_NOC_MW_PE * pe)
    return Costs(lat * repeat, (energy * repeat) * 1e-3, area * repeat,
                 power * repeat)


def budget(layers: torch.Tensor, env: dict, fraction: float,
           dtype=torch.float32) -> float:
    """Table II's budget: the platform's ``fraction`` of the whole model's
    constraint at the largest PE and tile levels on every layer."""
    frac = float(fraction)
    if frac == float("inf"):
        return frac
    levels = env["levels"]
    df = DLA if env.get("mix") else env["dataflow"]
    c = layer_costs(layers, float(pe_levels(levels)[-1]),
                    float(kt_levels(levels)[-1]), float(df), dtype)
    cons = c.area if env["constraint"] == "area" else c.power
    total = cons.sum(-1) if env["scenario"] == "LP" else cons.amax(-1)
    return float(frac * float(total))


def whole_model(layers: torch.Tensor, env: dict, pe, kt, df,
                dtype=torch.float32):
    """(objective, constraint) of one assignment, summed (or, for the
    constraint under LS, maxed) over the layers in float64."""
    c = layer_costs(layers, pe, kt, df, dtype)
    perf = c.latency if env["objective"] == "latency" else c.energy
    cons = c.area if env["constraint"] == "area" else c.power
    perf = perf.double().sum(-1)
    cons = (cons.double().sum(-1) if env["scenario"] == "LP"
            else cons.double().amax(-1))
    return float(perf), float(cons)
