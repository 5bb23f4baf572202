"""Dataflow styles and the coarse (L-level) action tables.

Three dataflow styles from the paper (SII, SIV-A2): NVDLA-style ``dla``
(weight-stationary), Eyeriss-style ``eye`` (row-stationary) and
ShiDianNao-style ``shi`` (output-stationary).  The coarse action space is
the paper's Table I: L=12 level values for PEs and for the per-PE tile
count ``kt``; Table IX ablates L in {10, 12, 14}.
"""
from __future__ import annotations

import numpy as np
import torch

DLA = 0
EYE = 1
SHI = 2
NUM_DATAFLOWS = 3
DATAFLOW_NAMES = ("dla", "eye", "shi")

_PE_TABLES = {
    10: [1, 2, 4, 8, 16, 24, 32, 48, 64, 128],
    # Paper Table I.
    12: [1, 2, 4, 8, 12, 16, 24, 32, 48, 64, 96, 128],
    14: [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128],
}


def pe_levels(L: int = 12) -> np.ndarray:
    """PE count at each of the L coarse action levels."""
    if L not in _PE_TABLES:
        raise ValueError(f"unsupported action-level count L={L}")
    return np.asarray(_PE_TABLES[L], dtype=np.int32)


def kt_levels(L: int = 12) -> np.ndarray:
    """Per-PE tile count (filters resident per PE) at each level: 1..L."""
    if L not in _PE_TABLES:
        raise ValueError(f"unsupported action-level count L={L}")
    return np.arange(1, L + 1, dtype=np.int32)


PE_LEVELS = pe_levels(12)
KT_LEVELS = kt_levels(12)

# Fine-grained (second-stage GA) bounds: raw integers, SIII-G.
PE_MIN, PE_MAX = 1, 160
KT_MIN, KT_MAX = 1, 16


def l1_bytes_by_style(kt, R, S):
    """Per-style L1 buffer bytes per PE: ``(dla, eye, shi)`` formulas.

    dla: kt*R*S + R*S + kt;  eye: kt*S + S + kt;  shi: R*S + 2*kt.
    """
    rs = R * S
    dla_b = kt * rs + rs + kt
    eye_b = kt * S + S + kt
    shi_b = rs + 2 * kt
    return dla_b, eye_b, shi_b


def l1_bytes_formula(dataflow, kt, R, S):
    """L1 buffer bytes per PE for an integer dataflow id (hard selection).

    ``dataflow`` is a tensor broadcastable against ``kt``/``R``/``S``.
    """
    dla_b, eye_b, shi_b = l1_bytes_by_style(kt, R, S)
    return torch.where(dataflow == DLA, dla_b,
                       torch.where(dataflow == EYE, eye_b, shi_b))
