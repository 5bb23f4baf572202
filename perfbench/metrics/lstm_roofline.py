"""lstm_roofline: the LSTM kernels' share of their roofline in the traced
slices: the least time of every forward and backward call, reckoned
below from the algorithm's shapes, over the calls' summed device time.

Each input byte is read once and each output byte written once, whatever
a kernel reads again; float32 throughout.  Forward, one step of B rows:
x (B, I), h and c (B, H), wx (I, 4H), wh (H, 4H), b (4H) in; h', c' and
the five gates the backward reads, (7, B, H), out.  Backward: x, h, c,
wx, wh, the five gates, dh' and dc' in; dx, dh, dc, dwx, dwh, db out.
"""
from perfbench import peaks, shapes

F32 = 4
FORWARD = "lstm_cell_kernel"          # names as the profiler shows them
BACKWARD = "lstm_cell_bwd"            # the single-pass and tiled kernels


def forward(B, I, H):
    """(flops, bytes) of one forward call."""
    flops = 2 * B * (I + H) * 4 * H + 13 * B * H
    nbytes = F32 * (B * I + 2 * B * H + (I + H) * 4 * H + 4 * H + 7 * B * H)
    return flops, nbytes


def backward(B, I, H):
    """(flops, bytes) of one backward call."""
    flops = 4 * B * (I + H) * 4 * H + 19 * B * H
    nbytes = F32 * ((B * I + 2 * B * H + (I + H) * 4 * H + 7 * B * H)
                    + (B * I + 2 * B * H + (I + H) * 4 * H + 4 * H))
    return flops, nbytes


def kind(name):
    if BACKWARD in name:
        return "backward"
    if FORWARD in name:
        return "forward"
    return None


def read(run):
    s = shapes.of(run.cell)
    B, I, H = s.episodes, s.obs_dim, s.hidden
    least = {"forward": peaks.least_seconds(*forward(B, I, H)),
             "backward": peaks.least_seconds(*backward(B, I, H))}
    bound = device = 0.0
    for sl in run.slices:
        for name, (n, t) in sl.kernels.items():
            k = kind(name)
            if k is not None:
                bound += n * least[k]
                device += t
    return 100.0 * bound / device if device > 0 else None
