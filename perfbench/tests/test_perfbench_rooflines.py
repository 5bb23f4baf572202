"""The operations and bytes the rooflines and epoch_mfu reckon, at the
cells' shapes, and the readers on made-up slices."""
import pytest

from perfbench import harness, peaks, shapes
from perfbench.metrics import (cost_eval_roofline, device_idle_share,
                               epoch_mfu, lstm_roofline)
from perfbench.tests.tiny import REPO
from perfbench.trace import Slice


def test_lstm_call_at_the_policy_shape():
    # B = 1 episode, I = 10 observation features, H = 128.
    f, b = lstm_roofline.forward(1, 10, 128)
    assert f == 2 * 138 * 512 + 13 * 128
    assert b == 4 * (10 + 256 + 138 * 512 + 512 + 7 * 128)
    f, b = lstm_roofline.backward(1, 10, 128)
    assert f == 4 * 138 * 512 + 19 * 128
    assert b == 4 * ((10 + 256 + 138 * 512 + 7 * 128)
                     + (10 + 256 + 138 * 512 + 512))
    # Both calls are bound by their bytes: the weights, once each way.
    assert peaks.least_seconds(*lstm_roofline.forward(1, 10, 128)) == \
        pytest.approx(289320 / peaks.HBM_BYTES_PER_S)


def test_cost_calls_at_each_site():
    assert cost_eval_roofline.rollout_call(1) == (224, 4 * (8 + 2 + 4))
    f, b = cost_eval_roofline.generation_call(20, 53)
    assert f == 224 * 20 * 53
    assert b == 4 * (8 * 53 + 2 * 20 * 53 + 53 + 4 * 20 * 53)


@pytest.mark.parametrize("cell,layers", [
    ("mobilenet_v2.two_stage", 53), ("resnet50.two_stage", 54)])
def test_epoch_flops_at_the_cells_shapes(cell, layers):
    s = shapes.of(harness.resolve(REPO, cell))
    assert (s.layers, s.episodes, s.obs_dim, s.hidden, s.levels, s.heads,
            s.population) == (layers, 1, 10, 128, 12, 2, 20)
    step = (2 * 138 * 512 + 13 * 128) + (4 * 138 * 512 + 19 * 128) \
        + 3 * 2 * 128 * 12 * 2 + 224
    assert epoch_mfu.epoch_flops(s) == layers * step
    # About 23 MFLOP an epoch of one search.
    assert 22e6 < epoch_mfu.epoch_flops(s) < 25e6


class _Run:
    def __init__(self, cell, slices):
        self.cell = harness.resolve(REPO, cell)
        self.slices = slices


def test_readers_on_made_up_slices():
    # 20 epochs of 53 steps: a forward at 3 us, a backward at 2 us and a
    # cost call at 2 us each; then a generation slice of 20 calls at 2 us.
    k = {"lstm_cell_kernel(float const*)": (1060, 1060 * 3e-6),
         "void lstm_cell_bwd_untiled_kernel<1, 4>(float const*)":
             (1060, 1060 * 2e-6),
         "cost_eval_kernel(float const*)": (1060, 1060 * 2e-6),
         "void at::native::add_kernel()": (5000, 5e-3)}
    s1 = Slice("stage1", "reinforce", 20, 0.2, 0.15, k,
               {"stage1: cudaGraphLaunch": 0.05})
    s2 = Slice("stage2", "local_ga", 20, 0.02, 0.002,
               {"cost_eval_kernel(float const*)": (20, 20 * 2e-6)},
               {"stage2: aten::where": 0.018})
    run = _Run("mobilenet_v2.two_stage", [s1, s2])
    f = peaks.least_seconds(*lstm_roofline.forward(1, 10, 128))
    b = peaks.least_seconds(*lstm_roofline.backward(1, 10, 128))
    assert lstm_roofline.read(run) == pytest.approx(
        100 * (f + b) / 5e-6)
    r = peaks.least_seconds(*cost_eval_roofline.rollout_call(1))
    g = peaks.least_seconds(*cost_eval_roofline.generation_call(20, 53))
    assert cost_eval_roofline.read(run) == pytest.approx(
        100 * (1060 * r + 20 * g) / (1080 * 2e-6))
    assert 0 < lstm_roofline.read(run) < 100


def _spans(run):
    """One two-stage search of the window: 1,000 epochs in 8 s (two chunks
    of 500), then 2,000 generations in 2 s; and another thread's chunk,
    which is no chunk of this search."""
    search = {"name": "search.run", "ts_us": 0.0, "dur_us": 1.05e7,
              "tid": 1, "attrs": {"method": "two_stage"}}
    chunks = [{"name": "search.chunk", "ts_us": t, "dur_us": d, "tid": tid,
               "attrs": {"engine": e, "steps": n}}
              for t, d, tid, e, n in ((2e5, 4e6, 1, "reinforce", 500),
                                      (4.2e6, 4e6, 1, "reinforce", 500),
                                      (8.4e6, 2e6, 1, "local_ga", 2000),
                                      (2e5, 4e6, 2, "reinforce", 500))]
    run.spans = [search] + chunks
    run.search_spans = lambda: harness.RunData.search_spans(run)


def test_epoch_mfu_from_the_windows_chunk_spans():
    run = _Run("mobilenet_v2.two_stage", [])
    _spans(run)
    s = shapes.of(run.cell)
    assert epoch_mfu.read(run) == pytest.approx(
        100 * 1000 * epoch_mfu.epoch_flops(s) / 8.0
        / peaks.F32_FLOP_PER_S)


def test_idle_share_weighs_each_stage_by_its_unprofiled_time():
    # Profiled: 7.5 ms busy an epoch (whatever the slice's wall), 75 us
    # a generation.  Unprofiled: 8 ms an epoch, 1 ms a generation.
    s1 = Slice("stage1", "reinforce", 20, 0.3, 0.15, {}, {})
    s2 = Slice("stage2", "local_ga", 20, 0.04, 0.0015, {}, {})
    run = _Run("mobilenet_v2.two_stage", [s1, s2])
    _spans(run)
    busy = 1000 * 7.5e-3 + 2000 * 75e-6
    assert device_idle_share.read(run) == pytest.approx(
        100 * (1 - busy / 10.0))
    # A slice whose stage the window never ran weighs nothing.
    run.slices = [s1, Slice("stage3", "other", 5, 1.0, 0.0, {}, {})]
    assert device_idle_share.read(run) == pytest.approx(
        100 * (1 - 7.5 / 8.0))


def test_readers_find_nothing_without_slices():
    run = _Run("mobilenet_v2.two_stage", [])
    assert lstm_roofline.read(run) is None
    assert cost_eval_roofline.read(run) is None
    run.spans = []
    run.search_spans = lambda: []
    assert epoch_mfu.read(run) is None
    assert device_idle_share.read(run) is None
