"""MAESTRO-style analytical cost model in PyTorch, hard and soft.

The port of ``repro.costmodel.maestro``: given a layer descriptor, a
dataflow style and a design point (#PEs ``pe``, per-PE tile count ``kt``
which sets the L1 buffer), it returns latency / energy / area / power.
The operations and their order follow the reference line by line, so the
plain version here agrees with it to float32 rounding; the CUDA kernel
(``kernels/csrc/costmodel_eval.cu``) repeats the hard path's arithmetic.

One model body (:func:`_gated_cost`) serves two sets of primitives:

  * the **hard** path (:func:`core_cost` / :func:`evaluate` /
    :func:`model_cost`) with the exact ops of ``primitives.HARD``;
  * the **soft** path (:func:`soft_core_cost` / :func:`soft_evaluate` /
    :func:`soft_model_cost`) with ``primitives.soft(tau)`` and a dataflow
    simplex, differentiable by autograd in ``pe``, ``kt`` and the
    dataflow weights -- the relaxed engine (:mod:`repro_torch.core.relaxed`)
    descends it.  It is plain PyTorch, as the reference's is plain
    ``jnp``: no kernel of either package computes it.

Every function is branch-free and broadcasts over leading dims.  Inputs
are float32 tensors; all of them must lie on one device.
"""
from __future__ import annotations

import functools
import hashlib
import os
from typing import NamedTuple

import torch

from repro_torch.costmodel import primitives as prim_lib
from repro_torch.costmodel.dataflows import (
    DLA,
    EYE,
    SHI,
    l1_bytes_by_style,
    l1_bytes_formula,
)
from repro_torch.costmodel.layers import (
    DWCONV,
    F_C,
    F_K,
    F_R,
    F_REPEAT,
    F_S,
    F_TYPE,
    F_X,
    F_Y,
)

HARD = prim_lib.HARD

# ---------------------------------------------------------------------------
# Hardware constants (45nm-era, order-of-magnitude; units documented).
# ---------------------------------------------------------------------------
E_MAC = 1.0          # pJ / MAC
E_L1 = 1.0           # pJ / L1 access (element)
E_L2 = 6.0           # pJ / L2 access (element)
E_DRAM = 200.0       # pJ / DRAM access (element)
L1_ACC_PER_MAC = 3.0  # weight + act read + psum rmw

P_MAC_MW = 1.0       # mW / PE (dynamic, peak)
P_L1_MW_B = 0.005    # mW / L1 byte
P_L2_MW_B = 0.002    # mW / L2 byte
P_NOC_MW_PE = 0.1    # mW / PE of NoC

LEAK_PE_MW = 0.05    # mW leakage / PE
LEAK_L1_MW_B = 0.001  # mW leakage / L1 byte

A_MAC_UM2 = 2000.0   # um^2 / PE (MAC + control)
A_L1_UM2_B = 50.0    # um^2 / L1 byte
A_L2_UM2_B = 25.0    # um^2 / L2 byte
A_NOC_UM2_PE = 300.0  # um^2 / PE of NoC

DRAM_BW = 16.0       # elements / cycle
L2_BW_BASE = 8.0     # elements / cycle
L2_BW_SQRT = 8.0     # + L2_BW_SQRT * sqrt(pe)
FILL_CYCLES = 20.0   # pipeline fill


class CostOut(NamedTuple):
    """Per-layer (or aggregated) cost estimates."""

    latency: torch.Tensor   # cycles
    energy: torch.Tensor    # nJ
    area: torch.Tensor      # um^2
    power: torch.Tensor     # mW (peak)
    l1_bytes: torch.Tensor  # per-PE L1 buffer
    l2_bytes: torch.Tensor  # shared L2
    macs: torch.Tensor      # true MACs of the layer
    util: torch.Tensor      # MACs / (latency * pe)


def _factorize(pe, d1, d2, prims=HARD):
    """Split ``pe`` PEs over two parallel dims (d1 outer): p1*p2 <= pe."""
    p1 = prims.clip(pe, 1.0, prims.maximum(d1, 1.0))
    p2 = prims.clip(prims.floor_div(pe, p1), 1.0, prims.maximum(d2, 1.0))
    return p1, p2


def _dataflow_terms(df_is, is_dw, K_out, C_red, Yp, Xp, R, S, pe, kt,
                    W_u, A_u, O_u, prims=HARD):
    """Compute cycles + (W, A, O) L2 traffic for the selected style.

    ``df_is`` are weights over (dla, eye, shi): exact one-hots on the hard
    path, a simplex on the soft one; returns (compute_cycles, l2_traffic,
    passes_w, passes_a).
    """
    is_dla, is_eye, is_shi = df_is
    cdiv = prims.ceil_div
    Ku = cdiv(K_out, kt)

    # ---- dla: parallel (Ku, C_red) --------------------------------------
    p1d, p2d = _factorize(pe, Ku, C_red, prims)
    t1d = cdiv(Ku, p1d)
    t2d = cdiv(C_red, p2d)
    kt_eff_d = prims.minimum(kt, cdiv(K_out, p1d * t1d))
    comp_dla = t1d * t2d * kt_eff_d * R * S * Yp * Xp
    a_passes_dla = prims.blend(is_dw, 1.0, t1d)     # disjoint dw channels
    l2_dla = (W_u                      # weight-stationary: once
              + A_u * a_passes_dla     # activation multicast / K-iteration
              + O_u * p2d)             # psum collection width

    # ---- eye: parallel (Y', R); temporal over C and Ku -------------------
    p1e, p2e = _factorize(pe, Yp, R, prims)
    t1e = cdiv(Yp, p1e)
    t2e = cdiv(R, p2e)
    kt_eff_e = prims.minimum(kt, K_out)
    comp_eye = t1e * t2e * C_red * Ku * kt_eff_e * S * Xp
    halo_e = (p1e + R - 1.0) / prims.maximum(p1e, 1.0)
    a_passes_eye = prims.blend(is_dw, 1.0, Ku)      # disjoint dw channels
    l2_eye = (W_u * t1e                # rows re-staged per temporal block
              + A_u * a_passes_eye * halo_e  # per filter-group + row halo
              + O_u * p2e)

    # ---- shi: parallel (Y', X'); temporal over C and Ku ------------------
    p1s, p2s = _factorize(pe, Yp, Xp, prims)
    t1s = cdiv(Yp, p1s)
    t2s = cdiv(Xp, p2s)
    kt_eff_s = prims.minimum(kt, K_out)
    comp_shi = t1s * t2s * C_red * Ku * kt_eff_s * R * S
    halo_s = ((p1s + R - 1.0) * (p2s + S - 1.0)) / prims.maximum(
        p1s * p2s, 1.0)
    l2_shi = (W_u * t1s * t2s          # weights streamed per output tile
              + A_u * halo_s           # neighbour-shift reuse, halo only
              + O_u)

    comp = is_dla * comp_dla + is_eye * comp_eye + is_shi * comp_shi
    l2 = is_dla * l2_dla + is_eye * l2_eye + is_shi * l2_shi
    passes_w = is_dla * 1.0 + is_eye * t1e + is_shi * (t1s * t2s)
    passes_a = is_dla * a_passes_dla + is_eye * a_passes_eye + is_shi * 1.0
    return comp, l2, passes_w, passes_a


def _gated_cost(K, C, Y, X, R, S, repeat, pe, kt, df_w, is_dw, l1_bytes,
                prims):
    """The model body below the gates: one set of dataflow-term math."""
    Yp = torch.clamp_min(Y - R + 1.0, 1.0)
    Xp = torch.clamp_min(X - S + 1.0, 1.0)
    C_red = prims.blend(is_dw, 1.0, C)       # reduction channels
    K_out = prims.blend(is_dw, C, K)         # independent output dims

    macs = K_out * C_red * Yp * Xp * R * S
    W_u = K_out * C_red * R * S              # unique weights
    A_u = C * Y * X                          # unique activations
    O_u = K_out * Yp * Xp                    # unique outputs

    comp, l2_traffic, passes_w, passes_a = _dataflow_terms(
        df_w, is_dw, K_out, C_red, Yp, Xp, R, S, pe, kt,
        W_u, A_u, O_u, prims)

    l2_bytes = 2.0 * pe * l1_bytes

    # DRAM refetch: an outer pass re-reads its tensor from DRAM only for the
    # fraction that spilled out of L2.
    spill_w = prims.clip01(1.0 - l2_bytes / torch.clamp_min(W_u, 1.0))
    spill_a = prims.clip01(1.0 - l2_bytes / torch.clamp_min(A_u, 1.0))
    dram_traffic = (W_u * (1.0 + (passes_w - 1.0) * spill_w)
                    + A_u * (1.0 + (passes_a - 1.0) * spill_a)
                    + O_u)
    l2_bw = L2_BW_BASE + L2_BW_SQRT * torch.sqrt(pe)
    lat = (prims.max3(comp, l2_traffic / l2_bw, dram_traffic / DRAM_BW)
           + torch.sqrt(pe) + FILL_CYCLES)

    leak_mw = LEAK_PE_MW * pe + LEAK_L1_MW_B * l1_bytes * pe
    energy_pj = (E_MAC * macs
                 + E_L1 * (L1_ACC_PER_MAC * macs + l2_traffic)
                 + E_L2 * l2_traffic
                 + E_DRAM * dram_traffic
                 + leak_mw * lat)            # 1 mW * 1 cycle @1GHz = 1 pJ

    area = (A_MAC_UM2 * pe + A_L1_UM2_B * l1_bytes * pe
            + A_L2_UM2_B * l2_bytes + A_NOC_UM2_PE * pe)
    power = (P_MAC_MW * pe + P_L1_MW_B * l1_bytes * pe
             + P_L2_MW_B * l2_bytes + P_NOC_MW_PE * pe)

    return CostOut(
        latency=lat * repeat,
        energy=(energy_pj * repeat) * 1e-3,  # pJ -> nJ
        area=area * repeat,
        power=power * repeat,
        l1_bytes=l1_bytes,
        l2_bytes=l2_bytes,
        macs=macs * repeat,
        util=macs / prims.maximum(comp * pe, 1.0),
    )


def core_cost(K, C, Y, X, R, S, ltype, repeat, pe, kt, df):
    """The HARD model core on unpacked float32 field tensors (broadcastable).

    The plain version of the CUDA cost kernel: ``kernels/ref.py`` and the
    CPU path call exactly this.
    """
    pe = torch.clamp_min(pe, 1.0)
    kt = torch.clamp_min(kt, 1.0)
    gate = HARD.eq_gate
    df_w = (gate(df, DLA), gate(df, EYE), gate(df, SHI))
    is_dw = gate(ltype, DWCONV)
    l1_bytes = l1_bytes_formula(df, kt, R, S)
    return _gated_cost(K, C, Y, X, R, S, repeat, pe, kt, df_w, is_dw,
                       l1_bytes, HARD)


def soft_core_cost(K, C, Y, X, R, S, ltype, repeat, pe, kt, df_weights, tau):
    """The SOFT model core: smooth surrogates + a dataflow simplex.

    ``df_weights``: (..., 3) weights over (dla, eye, shi), any convex
    combination (an exact one-hot for a fixed-dataflow relaxation).
    ``tau`` is the surrogate temperature (a 0-d tensor or a number).
    Gradients w.r.t. ``pe``, ``kt`` and ``df_weights`` are finite and
    non-zero everywhere, including on the hard model's plateaus.
    """
    prims = prim_lib.soft(tau)
    pe = prims.maximum(pe, 1.0)
    kt = prims.maximum(kt, 1.0)
    df_weights = torch.as_tensor(df_weights, dtype=torch.float32)
    df_w = tuple(torch.movedim(df_weights, -1, 0))
    is_dw = prims.eq_gate(ltype, DWCONV)
    dla_b, eye_b, shi_b = l1_bytes_by_style(kt, R, S)
    l1_bytes = df_w[0] * dla_b + df_w[1] * eye_b + df_w[2] * shi_b
    return _gated_cost(K, C, Y, X, R, S, repeat, pe, kt, df_w, is_dw,
                       l1_bytes, prims)


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def evaluate(layers, pe, kt, dataflow):
    """Evaluate design points against layers.  Fully broadcastable.

    layers: (..., NUM_FIELDS) tensor of layer descriptors; pe, kt,
    dataflow: (...,) tensors or scalars.  Returns a CostOut of the
    broadcast shape; values include the ``repeat`` multiplicity.
    """
    layers = torch.as_tensor(layers)
    dev = layers.device
    f = lambda i: layers[..., i].to(torch.float32)
    return core_cost(
        f(F_K), f(F_C), f(F_Y), f(F_X), f(F_R), f(F_S),
        f(F_TYPE), f(F_REPEAT),
        _f32(pe, dev), _f32(kt, dev), _f32(dataflow, dev))


def aggregate(out: CostOut, scenario: str) -> CostOut:
    """Whole-model reduction over the last (layer) axis; see model_cost."""
    lat = torch.sum(out.latency, dim=-1)
    en = torch.sum(out.energy, dim=-1)
    if scenario == "LP":
        area = torch.sum(out.area, dim=-1)
        power = torch.sum(out.power, dim=-1)
    elif scenario == "LS":
        area = torch.amax(out.area, dim=-1)
        power = torch.amax(out.power, dim=-1)
    else:
        raise ValueError(f"unknown scenario {scenario!r}")
    return CostOut(lat, en, area, power,
                   torch.amax(out.l1_bytes, dim=-1),
                   torch.amax(out.l2_bytes, dim=-1),
                   torch.sum(out.macs, dim=-1),
                   torch.mean(out.util, dim=-1))


def model_cost(layers, pe, kt, dataflow, scenario: str = "LP"):
    """Aggregate whole-model cost for a per-layer assignment.

    "LP": every layer is its own partition -> everything sums over layers.
    "LS": one shared accelerator -> latency/energy sum, area/power max.
    """
    return aggregate(evaluate(layers, pe, kt, dataflow), scenario)


# ---------------------------------------------------------------------------
# Soft (differentiable) evaluators -- same core, smooth primitives.
# ---------------------------------------------------------------------------
def soft_evaluate(layers, pe, kt, df_weights, tau=1.0):
    """Differentiable twin of :func:`evaluate`.

    layers: (..., NUM_FIELDS) descriptors (data, not smoothed); pe, kt:
    (...,) continuous design variables; df_weights: (..., 3) dataflow
    simplex weights; tau: surrogate temperature (``tau -> 0`` recovers the
    hard model away from the staircase jumps).  Returns a :class:`CostOut`
    smooth in ``pe``, ``kt`` and ``df_weights``.
    """
    layers = torch.as_tensor(layers)
    dev = layers.device
    f = lambda i: layers[..., i].to(torch.float32)
    return soft_core_cost(
        f(F_K), f(F_C), f(F_Y), f(F_X), f(F_R), f(F_S),
        f(F_TYPE), f(F_REPEAT), _f32(pe, dev), _f32(kt, dev),
        _f32(df_weights, dev), tau)


def soft_model_cost(layers, pe, kt, df_weights, tau=1.0,
                    scenario: str = "LP"):
    """Differentiable twin of :func:`model_cost`.

    Objectives sum over layers in both scenarios; the LS constraint's max
    over layers becomes the scale-invariant smooth maximum, so constraint
    gradients reach every layer's variables.
    """
    out = soft_evaluate(layers, pe, kt, df_weights, tau)
    lat = torch.sum(out.latency, dim=-1)
    en = torch.sum(out.energy, dim=-1)
    if scenario == "LP":
        area = torch.sum(out.area, dim=-1)
        power = torch.sum(out.power, dim=-1)
    elif scenario == "LS":
        p = 12.0 / torch.clamp(torch.as_tensor(tau, dtype=torch.float32),
                               1e-3, 1.0)
        area = prim_lib.smooth_amax(out.area, p)
        power = prim_lib.smooth_amax(out.power, p)
    else:
        raise ValueError(f"unknown scenario {scenario!r}")
    return CostOut(lat, en, area, power,
                   torch.amax(out.l1_bytes, dim=-1),
                   torch.amax(out.l2_bytes, dim=-1),
                   torch.sum(out.macs, dim=-1),
                   torch.mean(out.util, dim=-1))


@functools.lru_cache(maxsize=1)
def content_hash() -> str:
    """Content hash of the port's cost-model definition (16 hex chars).

    Covers every source that participates in a cost value: this file, the
    plateau primitives, the dataflow tables, the layer packing and the CUDA
    cost kernel.  It hashes the port's own files, so cache shards written by
    the two packages can never mix.
    """
    import repro_torch.costmodel.dataflows as _dataflows
    import repro_torch.costmodel.layers as _layers
    import repro_torch.costmodel.primitives as _primitives

    here = os.path.dirname(os.path.abspath(__file__))
    kernel = os.path.join(os.path.dirname(here), "kernels", "csrc",
                          "costmodel_eval.cu")
    h = hashlib.sha256()
    for path in (os.path.abspath(__file__), _primitives.__file__,
                 _dataflows.__file__, _layers.__file__, kernel):
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]
