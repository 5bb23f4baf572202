"""Layer (workload) descriptors for the cost model.

A layer is described exactly as in the paper's observation space (SIII-B):

    (K, C, Y, X, R, S, type)

  * CONV    : K output channels, C input channels, YxX input activation,
              RxS filter kernel.
  * DWCONV  : depth-wise convolution; K == C groups, each group is a single
              2-D convolution (no channel reduction).
  * GEMM    : an (M, N, Kg) matmul -- (M,Kg) x (Kg,N) -> (M,N) -- encoded per
              the paper's footnote 3.  We map it onto the conv descriptor as
                  K  = N   (output features ~ filters)
                  C  = Kg  (reduction dim  ~ input channels)
                  Y  = M   (tokens / rows  ~ activation rows), X = 1
                  R  = S = 1
              so Y' = M, X' = 1 and total MACs = M*N*Kg.

We additionally carry a ``repeat`` field: the number of *identical* hardware
instances of this layer (e.g. the E experts of an MoE block, or consecutive
identical transformer blocks).  One RL action covers the whole group; latency,
energy, area and power scale by ``repeat`` (each instance receives the same
(PE, Buf) assignment -- this keeps episode lengths tractable for 90+ layer
LLMs while remaining faithful to the paper's per-layer formulation, where
every group member *is* the same layer shape).
"""
from __future__ import annotations

import dataclasses

import numpy as np

# Layer types.
CONV = 0
DWCONV = 1
GEMM = 2

# Descriptor array column layout.
F_K, F_C, F_Y, F_X, F_R, F_S, F_TYPE, F_REPEAT = range(8)
NUM_FIELDS = 8


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Host-side layer descriptor (converted to an int array for the Env)."""

    K: int
    C: int
    Y: int
    X: int
    R: int
    S: int
    type: int = CONV
    repeat: int = 1
    name: str = ""

    @staticmethod
    def conv(K: int, C: int, Y: int, X: int, R: int, S: int, *, repeat: int = 1,
             name: str = "") -> "LayerSpec":
        return LayerSpec(K, C, Y, X, R, S, CONV, repeat, name)

    @staticmethod
    def dwconv(C: int, Y: int, X: int, R: int, S: int, *, repeat: int = 1,
               name: str = "") -> "LayerSpec":
        # K == C for depth-wise.
        return LayerSpec(C, C, Y, X, R, S, DWCONV, repeat, name)

    @staticmethod
    def gemm(M: int, N: int, Kg: int, *, repeat: int = 1,
             name: str = "") -> "LayerSpec":
        """(M,Kg) x (Kg,N): K=N, C=Kg, Y=M, X=1, R=S=1."""
        return LayerSpec(N, Kg, M, 1, 1, 1, GEMM, repeat, name)

    def macs(self) -> int:
        yp = max(self.Y - self.R + 1, 1)
        xp = max(self.X - self.S + 1, 1)
        if self.type == DWCONV:
            return self.C * yp * xp * self.R * self.S * self.repeat
        return self.K * self.C * yp * xp * self.R * self.S * self.repeat

    def as_row(self) -> np.ndarray:
        return np.array(
            [self.K, self.C, self.Y, self.X, self.R, self.S, self.type,
             self.repeat],
            dtype=np.int32,
        )


def layers_to_array(layers) -> np.ndarray:
    """Stack LayerSpecs into an (N, NUM_FIELDS) int32 array."""
    if len(layers) == 0:
        raise ValueError("empty workload")
    return np.stack([l.as_row() for l in layers], axis=0)


def total_macs(layers) -> int:
    return int(sum(l.macs() for l in layers))
