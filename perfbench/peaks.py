"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity), at the full 700 W power limit.  A card set to a
lower limit runs slower under load; the run prints its limit beside every
share."""

F32_FLOP_PER_S = 67e12          # float32 outside the tensor cores
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float,
                  flop_per_s: float = F32_FLOP_PER_S) -> float:
    """The least time a call could take on the card: the larger of its
    operations over the peak rate and its bytes over the memory's."""
    return max(flops / flop_per_s, nbytes / HBM_BYTES_PER_S)
