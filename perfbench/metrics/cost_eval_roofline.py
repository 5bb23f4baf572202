"""cost_eval_roofline: the cost kernel's share of its roofline in the
traced slices: the least time of every call, reckoned below at the shape
each call site uses, over the calls' summed device time.

Call sites: a rollout step scores its E actions on one layer, (E, 1):
the layer's row (8 values), pe and kt (E each) in, the dataflow by
value, (4, E) out; a stage-2 generation scores its population P on all N
layers, (P, N): the layer table (8, N), pe and kt (P, N) and the
dataflows (N) in, (4, P, N) out.  Each input byte read once, each output
byte written once; float32.
"""
from perfbench import peaks, shapes

F32 = 4
KERNEL = "cost_eval_kernel"            # not the per-row cost_eval_multi
# Operations of the hard model for one layer at one design point, counted
# from its arithmetic (each add, multiply, division, square root,
# rounding, comparison and select one): the dataflow terms of all three
# styles, traffic, latency, energy, area and power.
FLOPS_PER_POINT = 224
# The phase of a traced slice -> the call site its cost calls come from.
SITES = {"stage1": "rollout", "stage2": "generation"}


def rollout_call(E):
    """(flops, bytes) of a rollout step's call."""
    return FLOPS_PER_POINT * E, F32 * (8 + 2 * E + 4 * E)


def generation_call(P, N):
    """(flops, bytes) of a stage-2 generation's call."""
    return FLOPS_PER_POINT * P * N, F32 * (8 * N + 2 * P * N + N
                                           + 4 * P * N)


def read(run):
    s = shapes.of(run.cell)
    least = {"rollout": peaks.least_seconds(*rollout_call(s.episodes)),
             "generation": peaks.least_seconds(
                 *generation_call(s.population, s.layers))}
    bound = device = 0.0
    for sl in run.slices:
        site = SITES.get(sl.phase)
        for name, (n, t) in sl.kernels.items():
            if KERNEL in name and "multi" not in name and site:
                bound += n * least[site]
                device += t
    return 100.0 * bound / device if device > 0 else None
