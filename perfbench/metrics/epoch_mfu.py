"""epoch_mfu: the whole stage-1 epoch's share of the card's float32 peak
(67 TFLOP/s, no tensor cores: the port keeps TF32 off): the policy's
FLOPs (LSTM forward and backward, the action heads' products forward and
backward) and the cost model's, for every epoch, over the epochs' time
in the window's stage-1 ``search.chunk`` spans, which no profiler
slows."""
from perfbench import peaks, shapes
from perfbench.metrics import cost_eval_roofline, lstm_roofline


def epoch_flops(s) -> float:
    """FLOPs of one epoch of one search."""
    B, I, H = s.episodes, s.obs_dim, s.hidden
    heads = 3 * 2 * B * H * s.levels * s.heads     # forward + backward
    step = (lstm_roofline.forward(B, I, H)[0]
            + lstm_roofline.backward(B, I, H)[0] + heads
            + cost_eval_roofline.rollout_call(B)[0])
    return s.layers * step


def read(run):
    s = shapes.of(run.cell)
    chunks = [c for _, cs in run.search_spans() for c in cs
              if c.get("attrs", {}).get("engine") == "reinforce"]
    epochs = sum(int(c["attrs"]["steps"]) for c in chunks)
    seconds = sum(c["dur_us"] for c in chunks) * 1e-6
    if not epochs or seconds <= 0:
        return None
    flops = epochs * epoch_flops(s)
    return 100.0 * flops / seconds / peaks.F32_FLOP_PER_S
