"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need an NVIDIA card and nvcc, and skip without them
(the CPU tests hold the plain versions against the JAX package).  On a
machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.costmodel import layers as layers_lib
from repro_torch.costmodel import workloads
from repro_torch.kernels import (costmodel_eval, flash_decode, lstm_cell, ops,
                                 ref)
from repro_torch.serving import SearchService, ServiceConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("B", [1, 20, 144])
def test_cost_kernel_matches_plain(dev, B):
    arr = layers_lib.layers_to_array(workloads.get_workload("mobilenet_v2"))
    N = arr.shape[0]
    rng = np.random.default_rng(B)
    f = lambda lo, hi: torch.tensor(rng.integers(lo, hi, (B, N)),
                                    dtype=torch.float32, device=dev)
    layers = torch.as_tensor(arr, dtype=torch.float32, device=dev)
    pe, kt, df = f(1, 161), f(1, 17), f(0, 3)
    before = ops.launch_counts()["cost_eval"]
    got = ops.batched_cost(layers, pe, kt, df)
    assert ops.launch_counts()["cost_eval"] == before + 1
    want = ref.cost_eval_ref(layers.T.contiguous(), pe, kt, df)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("B,I,H", [(1, 10, 128), (8, 11, 128),
                                   (3, 10, 256)])
def test_lstm_kernel_and_gradient_match_plain(dev, B, I, H):
    gen = torch.Generator(device=dev).manual_seed(B + I)
    f = lambda *s: torch.randn(s, generator=gen, device=dev) * 0.1
    args = [f(B, I), f(B, H), f(B, H), f(I, 4 * H), f(H, 4 * H), f(4 * H)]
    a1 = [a.clone().requires_grad_() for a in args]
    a2 = [a.clone().requires_grad_() for a in args]
    out1 = ops.lstm_step(*a1)
    out2 = ref.lstm_cell_ref(*a2)
    for g, w in zip(out1, out2):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
    up = [torch.randn_like(o) for o in out1]
    for g, w in zip(torch.autograd.grad(out1, a1, up),
                    torch.autograd.grad(out2, a2, up)):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


# Phase 4 of chip_smoke.py: the search's step, a batch of 64 (several
# forward blocks and several backward chunks), ragged I, a wide I, H = 256.
LSTM_SHAPES = [(1, 10, 128), (64, 10, 128), (8, 11, 128), (16, 130, 128),
               (3, 10, 256)]


def _lstm_args(B, I, H, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    f = lambda *s, scale=0.1: torch.randn(s, generator=gen,
                                          device=dev) * scale
    return ([f(B, I, scale=1.0), f(B, H), f(B, H), f(I, 4 * H),
             f(H, 4 * H), f(4 * H)], f(B, H, scale=1.0), f(B, H, scale=1.0))


@pytest.mark.parametrize("B,I,H", LSTM_SHAPES)
def test_lstm_backward_kernel_matches_plain(dev, B, I, H):
    """The forward's saved gates and the backward kernel against their
    plain versions (atol 1e-5); one launch each; a second call gives the
    same bits."""
    args, dh, dc = _lstm_args(B, I, H, dev, seed=B * I + H)
    ops.reset_launch_counts()
    out = lstm_cell.lstm_cell(*args)
    h2, c2, gates = out[0], out[1], out[2:]
    want_h, want_c, want_gates = ref.lstm_cell_saved_ref(*args)
    for g, w in ((h2, want_h), (c2, want_c), (gates, want_gates)):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
    got = lstm_cell.lstm_cell_bwd(*args[:5], gates, dh, dc)
    again = lstm_cell.lstm_cell_bwd(*args[:5], gates, dh, dc)
    counts = ops.launch_counts()
    assert counts["lstm_cell"] == 1 and counts["lstm_cell_bwd"] == 2
    saved = ref.lstm_cell_bwd_saved_ref(*args[:5], gates, dh, dc)
    recomputed = ref.lstm_cell_bwd_ref(*args, dh, dc)
    torch.cuda.synchronize()
    for name, g, a, w, r in zip(("dx", "dh", "dc", "dwx", "dwh", "db"), got,
                                again, saved, recomputed):
        assert g.shape == w.shape, name
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0, msg=name)
        torch.testing.assert_close(g, r, atol=1e-5, rtol=0, msg=name)
        assert torch.equal(g, a), name


@pytest.mark.parametrize("B,I,H", [
    (2, lstm_cell.MAX_K - 128, 128),    # the forward's rows past 48 KB
    (5, 10, 700),                       # backward: tiles of H, chunks of B
    (3, 10, lstm_cell.MAX_K - 10),      # I + H at the limit, H tiled
])
def test_lstm_kernels_up_to_the_size_limit(dev, B, I, H):
    """Every I + H up to ``MAX_K``, the limit of the port's first LSTM
    kernel, runs: forward and backward against their plain versions
    computed in float64 on the same inputs (at these sizes the float32
    plain version's own rounding is of the order of the tolerance), atol
    and rtol 1e-5; a second backward call gives the same bits."""
    args, dh, dc = _lstm_args(B, I, H, dev, seed=B + I + H)
    f64 = lambda ts: [t.double() for t in ts]
    out = lstm_cell.lstm_cell(*args)
    want = ref.lstm_cell_saved_ref(*f64(args))
    for g, w in zip((out[0], out[1], out[2:]), want):
        torch.testing.assert_close(g.double(), w, atol=1e-5, rtol=1e-5)
    gates = out[2:]
    got = lstm_cell.lstm_cell_bwd(*args[:5], gates, dh, dc)
    again = lstm_cell.lstm_cell_bwd(*args[:5], gates, dh, dc)
    saved = ref.lstm_cell_bwd_saved_ref(*f64(args[:5] + [gates, dh, dc]))
    torch.cuda.synchronize()
    for name, g, a, w in zip(("dx", "dh", "dc", "dwx", "dwh", "db"), got,
                             again, saved):
        torch.testing.assert_close(g.double(), w, atol=1e-5, rtol=1e-5,
                                   msg=lambda m, name=name: f"{name}: {m}")
        assert torch.equal(g, a), name


def test_lstm_autograd_runs_one_backward_launch_per_step(dev):
    """Three chained steps under autograd: three forward and three backward
    launches, and no plain version on the card."""
    args, _, _ = _lstm_args(1, 10, 128, dev, seed=3)
    leaves = [a.requires_grad_() for a in args]
    ops.reset_launch_counts()
    x, h, c, wx, wh, b = leaves
    for _ in range(3):
        h, c = ops.lstm_step(x, h, c, wx, wh, b)
    grads = torch.autograd.grad(h.sum(), leaves)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert ops.launch_counts()["lstm_cell"] == 3
    assert ops.launch_counts()["lstm_cell_bwd"] == 3
    assert all(v == 0 for v in ref.cuda_calls.values())


@pytest.mark.parametrize("B,H", [(1, 128), (3, 614), (3, 615), (2, 700),
                                 (33, 128)])
def test_lstm_backward_paths_match_plain_and_each_other(dev, B, H):
    """The single-pass backward (where ``single_pass`` takes the shape: up
    to 4H = 2,560 gate columns and 32 batch rows) and the tiled one
    against the plain version computed in float64 on the same inputs
    (atol 1e-5) and against each other (atol 1e-5); two calls of each give
    the same bits; one launch per call."""
    I = 10
    args, dh, dc = _lstm_args(B, I, H, dev, seed=B * H)
    gates = lstm_cell.lstm_cell(*args)[2:]
    inputs = (*args[:5], gates, dh, dc)
    want = ref.lstm_cell_bwd_saved_ref(*(t.double() for t in inputs))
    ops.reset_launch_counts()
    auto = lstm_cell.lstm_cell_bwd(*inputs)
    tiled = lstm_cell.lstm_cell_bwd(*inputs, tiled=True)
    again = (lstm_cell.lstm_cell_bwd(*inputs),
             lstm_cell.lstm_cell_bwd(*inputs, tiled=True))
    torch.cuda.synchronize()
    assert ops.launch_counts()["lstm_cell_bwd"] == 4
    assert lstm_cell.single_pass(B, H) == (B <= 32 and H <= 640)
    for name, a, t, a2, t2, w in zip(("dx", "dh", "dc", "dwx", "dwh", "db"),
                                     auto, tiled, *again, want):
        for got in (a, t):
            torch.testing.assert_close(
                got.double(), w, atol=1e-5, rtol=0,
                msg=lambda m, name=name: f"{name}: {m}")
        torch.testing.assert_close(a, t, atol=1e-5, rtol=0)
        assert torch.equal(a, a2) and torch.equal(t, t2), name


def test_cost_kernel_reads_strided_and_broadcast_operands(dev):
    """Columns, rows, stride-0 views, strided slices, 0-d tensors and
    Python numbers give the bits of the same values as contiguous (B, N)
    tensors, with one launch each and no copy."""
    arr = layers_lib.layers_to_array(workloads.get_workload("mobilenet_v2"))
    N = arr.shape[0]
    lt = torch.as_tensor(arr, dtype=torch.float32, device=dev).T.contiguous()
    rng = np.random.default_rng(7)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    B = 20
    pe, kt = t(rng.integers(1, 161, (B, N))), t(rng.integers(1, 17, (B, N)))
    pe_col, kt_col = pe[:, :1], kt[:, :1]
    row = t(rng.integers(0, 3, (N,)))
    wide = t(np.repeat(pe.cpu().numpy(), 3, axis=1))
    cases = [
        ((pe_col, kt_col, 2.0), (pe_col.expand(B, N), kt_col.expand(B, N),
                                 torch.full((B, N), 2.0, device=dev))),
        ((pe, kt, row), (pe, kt, row.expand(B, N))),
        ((wide[:, ::3], kt.T.contiguous().T, 1), (pe, kt,
                                                 torch.ones_like(pe))),
        ((t(5.0), kt, t([[0.0]])), (torch.full_like(pe, 5.0), kt,
                                    torch.zeros_like(pe))),
    ]
    for forms, dense in cases:
        dense = [d.contiguous() for d in dense]
        before = ops.launch_counts()["cost_eval"]
        got = costmodel_eval.cost_eval(lt, *forms)
        assert ops.launch_counts()["cost_eval"] == before + 1
        want = costmodel_eval.cost_eval(lt, *dense)
        plain = ref.cost_eval_ref(lt, *dense)
        torch.cuda.synchronize()
        for g, w, p in zip(got, want, plain):
            assert g.shape == (B, N)
            assert torch.equal(g, w)
            assert torch.equal(g, p)


def test_cost_and_lstm_wrappers_refuse_bad_inputs(dev):
    """A wrong dtype, a tensor off the card, a shape that does not
    broadcast, and a negative stride (which no torch tensor has; the stride
    helper refuses it) all raise before any launch."""
    lt = torch.ones((8, 5), device=dev)
    pe = torch.ones((2, 5), device=dev)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="float32"):
        costmodel_eval.cost_eval(lt, pe.double(), pe, 0.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        costmodel_eval.cost_eval(lt, pe, pe.cpu(), 0.0)
    with pytest.raises(ValueError, match="does not broadcast"):
        costmodel_eval.cost_eval(lt, pe, torch.ones((3, 5), device=dev), 0.0)
    with pytest.raises(ValueError, match="negative stride"):
        costmodel_eval.broadcast_strides((2, 5), (-5, 1), 2, 5, "pe")
    args, dh, dc = _lstm_args(2, 10, 128, dev, seed=0)
    gates = torch.zeros((5, 2, 128), device=dev)
    with pytest.raises(ValueError, match="float32"):
        lstm_cell.lstm_cell_bwd(*args[:5], gates.double(), dh, dc)
    with pytest.raises(ValueError, match="CUDA tensor"):
        lstm_cell.lstm_cell_bwd(*args[:5], gates, dh.cpu(), dc)
    with pytest.raises(ValueError, match="shape"):
        lstm_cell.lstm_cell_bwd(*args[:5], gates[:4], dh, dc)
    with pytest.raises(ValueError, match="not contiguous"):
        lstm_cell.lstm_cell(args[0], args[1], args[2],
                            args[3].T.contiguous().T, args[4], args[5])
    assert all(v == 0 for v in ops.launch_counts().values())


def test_batched_cost_rejects_cpu_layers_with_cuda_points(dev):
    """A CPU layer table with points on the card raises: the evaluation is
    neither moved to the CPU nor run by the plain version."""
    layers = torch.as_tensor(
        layers_lib.layers_to_array(workloads.get_workload("ncf")),
        dtype=torch.float32)
    N = layers.shape[0]
    pe = torch.ones((2, N), device=dev)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="more than one device"):
        ops.batched_cost(layers, pe, pe, 0.0)
    with pytest.raises(ValueError, match="more than one device"):
        ops.batched_cost(layers.to(dev), pe, pe.cpu(), 0.0)
    assert ref.cuda_calls["cost_eval_ref"] == 0
    assert ops.launch_counts()["cost_eval"] == 0


def test_wrappers_reject_bad_inputs(dev):
    x = torch.zeros(2, 10, device=dev)
    h = torch.zeros(2, 128, device=dev)
    w = torch.zeros(10, 512, device=dev)
    with pytest.raises(ValueError, match="float32"):
        lstm_cell.lstm_cell(x.double(), h, h, w, torch.zeros(128, 512,
                                                             device=dev),
                            torch.zeros(512, device=dev))
    with pytest.raises(ValueError, match="shape"):
        lstm_cell.lstm_cell(x, h, h, w[:9], torch.zeros(128, 512, device=dev),
                            torch.zeros(512, device=dev))


def _paper_rows(names, rng, draws):
    """Ragged paper workloads padded with repeat = 0 rows, ``draws`` times,
    with random level points: (B, N, 8) layers, (B, N) pe/kt/df, and the
    mask of real (unpadded) positions."""
    packs = [layers_lib.layers_to_array(workloads.get_workload(n))
             for n in names]
    N = max(len(p) for p in packs)
    pad = dataclasses.replace(layers_lib.LayerSpec.gemm(1, 1, 1),
                              repeat=0).as_row()
    rows = np.stack([np.concatenate([p, np.tile(pad, (N - len(p), 1))])
                     for p in packs]).astype(np.float32)
    rows = np.tile(rows, (draws, 1, 1))
    real = np.tile(np.arange(N)[None] < np.array(
        [len(p) for p in packs])[:, None], (draws, 1))
    B = rows.shape[0]
    pe = rng.choice([1, 2, 4, 8, 16, 32, 64, 128], (B, N)).astype(np.float32)
    kt = rng.integers(1, 17, (B, N)).astype(np.float32)
    df = rng.integers(0, 3, (B, N)).astype(np.float32)
    return rows, pe, kt, df, real


def test_cost_multi_kernel_matches_plain_and_pads_zero(dev):
    rng = np.random.default_rng(5)
    rows, pe, kt, df, real = _paper_rows(workloads.workload_names(), rng, 4)
    args = [torch.as_tensor(a, device=dev) for a in (rows, pe, kt, df)]
    before = ops.launch_counts()["cost_eval_multi"]
    got = ops.batched_cost_multi(*args)
    assert ops.launch_counts()["cost_eval_multi"] == before + 1
    want = ref.cost_eval_multi_ref(args[0].reshape(-1, 8),
                                   *(a.reshape(-1) for a in args[1:]))
    pad = torch.as_tensor(~real, device=dev)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w.reshape(g.shape), rtol=1e-5,
                                   atol=1e-2)
        assert bool((g[pad] == 0).all())


@pytest.mark.parametrize("name", ["mobilenet_v2", "ncf", "resnet50"])
def test_cost_multi_kernel_bit_equal_to_table_kernel(dev, name):
    """Points of one workload get the same bits from either kernel: the
    service's byte identity with serial runs rests on it."""
    arr = layers_lib.layers_to_array(workloads.get_workload(name))
    B, N = 100, arr.shape[0]
    rng = np.random.default_rng(N)
    f = lambda lo, hi: torch.tensor(rng.integers(lo, hi, (B, N)),
                                    dtype=torch.float32, device=dev)
    pe, kt, df = f(1, 161), f(1, 17), f(0, 3)
    layers = torch.as_tensor(arr, dtype=torch.float32, device=dev)
    table = ops.batched_cost(layers, pe, kt, df)
    per_row = ops.batched_cost_multi(layers.expand(B, N, 8), pe, kt, df)
    for a, b in zip(table, per_row):
        assert torch.equal(a, b)


def test_cost_multi_wrapper_rejects_bad_inputs(dev):
    M = 4
    good = dict(layers=torch.ones((M, 8), device=dev),
                pe=torch.ones(M, device=dev), kt=torch.ones(M, device=dev),
                df=torch.zeros(M, device=dev))
    with pytest.raises(ValueError, match="CUDA tensor"):
        costmodel_eval.cost_eval_multi(**{**good, "kt": good["kt"].cpu()})
    with pytest.raises(ValueError, match="shape"):
        costmodel_eval.cost_eval_multi(**{**good,
                                          "layers": good["layers"][:, :7]})
    with pytest.raises(ValueError, match="float32"):
        costmodel_eval.cost_eval_multi(**{**good, "pe": good["pe"].double()})
    with pytest.raises(ValueError, match="more than one device"):
        ops.batched_cost_multi(good["layers"].cpu()[None], good["pe"][None],
                               good["kt"][None], good["df"][None])


def test_service_on_card_byte_identical_to_serial(dev):
    """ga, random, sa and reinforce through the service on the card equal
    their serial runs byte for byte; the per-row kernel ran, and no plain
    version ran on the card."""
    ecfg = api.EnvConfig(platform="cloud")
    cases = [("ga", {"population": 40}), ("random", {}), ("sa", {}),
             ("reinforce", {})]
    reqs = lambda: [api.SearchRequest(workload="ncf", env=ecfg,
                                      eps=40 if m == "reinforce" else 400,
                                      seed=2, method=m, options=dict(o))
                    for m, o in cases]
    serial = [api.run_search(r) for r in reqs()]
    ops.reset_launch_counts()
    with SearchService(ServiceConfig(max_workers=4)) as svc:
        outs = svc.run_all(reqs())
        dispatches = svc.stats()["dispatches"]
    for got, want in zip(outs, serial):
        assert got.best_value == want.best_value
        assert got.history.tobytes() == want.history.tobytes()
        assert got.pe.tobytes() == want.pe.tobytes()
        assert got.kt.tobytes() == want.kt.tobytes()
    assert 1 <= ops.launch_counts()["cost_eval_multi"] <= dispatches
    assert all(v == 0 for v in ref.cuda_calls.values())


@pytest.mark.parametrize("inner,eps,opts", [("reinforce", 24, {}),
                                            ("ga", 400, {"population": 20})])
def test_fanout_device_backend_equals_serial_on_card(dev, inner, eps, opts):
    """fanout's device backend (each shard's CUDA graph on its own stream)
    and its threads backend give serial's bytes and launches on the card,
    and no plain version runs there."""
    def run(backend):
        ops.reset_launch_counts()
        out = api.run_search(api.SearchRequest(
            workload="ncf", env=api.EnvConfig(platform="cloud"), eps=eps,
            seed=1, method="fanout",
            options={"inner": inner, "n_shards": 3, "backend": backend,
                     "inner_options": dict(opts)}))
        torch.cuda.synchronize()
        return out, ops.launch_counts()

    serial, c_serial = run("serial")
    for backend in ("device", "threads"):
        got, c = run(backend)
        assert got.extras["backend"] == backend
        assert got.best_value == serial.best_value
        assert got.history.tobytes() == serial.history.tobytes()
        for k in ("pe", "kt", "df"):
            assert getattr(got, k).tobytes() == getattr(serial, k).tobytes()
        assert got.extras["shard_best_values"] == \
            serial.extras["shard_best_values"]
        assert c == c_serial, backend
    N = len(workloads.get_workload("ncf"))
    want_cost = 3 * (1 + (N * eps if inner == "reinforce"
                          else eps // opts["population"]))
    assert c_serial["cost_eval"] == want_cost
    assert all(v == 0 for v in ref.cuda_calls.values())


def _multi_forms(form, rng, dev, M=300):
    """Dense (M, 8) and (M,) inputs of the per-row kernel, and the same
    values in one operand form: ``row_block`` the columns of one packed
    (M, 11) block (the service's upload), ``broadcast`` one (N, 8) table
    under (B, N) pe, a (B, 1) kt column and a (1, N) df row, ``by_value``
    pe and df as numbers, ``views_3d`` (B, N) views of a (B, N, 11)
    block."""
    arr = layers_lib.layers_to_array(workloads.get_workload("mobilenet_v2"))
    N = arr.shape[0]
    B = -(-M // N)
    f = lambda lo, hi, *s: torch.tensor(rng.integers(lo, hi, s),
                                        dtype=torch.float32, device=dev)
    table = torch.as_tensor(arr, dtype=torch.float32, device=dev)
    if form == "broadcast":
        pe, kt, df = f(1, 161, B, N), f(1, 17, B, 1), f(0, 3, 1, N)
        forms = (table, pe, kt, df)
    elif form == "by_value":
        pe, kt, df = 64.0, f(1, 17, B, N), 2.0
        forms = (table.expand(B, N, 8), pe, kt, df)
    else:
        pe, kt, df = f(1, 161, B, N), f(1, 17, B, N), f(0, 3, B, N)
        block = torch.cat([table.expand(B, N, 8), pe[..., None],
                           kt[..., None], df[..., None]], -1)
        if form == "row_block":
            block = block.reshape(B * N, 11)
        forms = (block[..., :8], block[..., 8], block[..., 9],
                 block[..., 10])
    dense = (table.repeat(B, 1),
             *(torch.as_tensor(v, dtype=torch.float32, device=dev).expand(
                 B, N).reshape(-1).contiguous() for v in (pe, kt, df)))
    return forms, dense, (B, N)


@pytest.mark.parametrize("layout", ["planar", "interleaved"])
@pytest.mark.parametrize("form", ["row_block", "broadcast", "by_value",
                                  "views_3d"])
def test_cost_multi_kernel_forms_and_layouts_bit_equal(dev, form, layout):
    """Every operand form, through ops.batched_cost_multi as four planes
    or as (..., 4) rows, gives the bits of the wrapper's contiguous call,
    which holds to the plain version; the row block also straight
    through the wrapper, in one launch."""
    forms, dense, (B, N) = _multi_forms(form, np.random.default_rng(7), dev)
    want = costmodel_eval.cost_eval_multi(*dense)
    torch.testing.assert_close(want, torch.stack(ref.cost_eval_multi_ref(
        *dense), -1), rtol=1e-5, atol=1e-2)
    before = ops.launch_counts()["cost_eval_multi"]
    if layout == "interleaved":
        got = ops.batched_cost_multi(*forms, interleaved=True)
    else:
        got = torch.stack(ops.batched_cost_multi(*forms), -1)
    assert ops.launch_counts()["cost_eval_multi"] == before + 1
    assert torch.equal(got.reshape(-1, 4), want)
    if form == "row_block":
        assert torch.equal(costmodel_eval.cost_eval_multi(*forms), want)


def test_cost_multi_wrapper_refuses_fields_apart(dev):
    """The per-row wrapper reads a point's fields side by side: layers
    whose fields lie apart raise before anything is launched, and
    ops.batched_cost_multi hands the kernel a copy of them instead."""
    M = 4
    layers_t = torch.rand((8, M), device=dev) * 10 + 1
    pe = torch.full((M,), 8.0, device=dev)
    before = ops.launch_counts()["cost_eval_multi"]
    with pytest.raises(ValueError, match="side by side"):
        costmodel_eval.cost_eval_multi(layers_t.T, pe, pe, pe)
    assert ops.launch_counts()["cost_eval_multi"] == before
    got = ops.batched_cost_multi(layers_t.T, pe, pe, pe, interleaved=True)
    want = costmodel_eval.cost_eval_multi(layers_t.T.contiguous(), pe, pe,
                                          pe)
    assert torch.equal(got, want)


def test_eval_point_rows_on_card_reads_the_rows_in_place(dev):
    """The batcher's fresh-point call: one launch on packed (M, 11) rows,
    (M, 4) costs back, bit-equal to the wrapper's contiguous call."""
    from repro_torch.serving import batcher

    forms, dense, _ = _multi_forms("row_block", np.random.default_rng(8),
                                   dev)
    rows = torch.cat([dense[0], *(v[:, None] for v in dense[1:])], 1)
    before = ops.launch_counts()["cost_eval_multi"]
    got = batcher.eval_point_rows(rows.cpu().numpy(), dev,
                                  batcher._DeviceIO(dev))
    assert ops.launch_counts()["cost_eval_multi"] == before + 1
    want = costmodel_eval.cost_eval_multi(*dense).cpu().numpy()
    assert got.shape == want.shape and got.tobytes() == want.tobytes()


def test_dispatch_on_card_syncs_at_most_twice(dev):
    """One dispatch of items of two workloads and two objectives, some
    fresh and some cached: each fitness equals serial genome_cost byte
    for byte; two host syncs with fresh points, one without."""
    import warnings

    from repro_torch.core import baselines
    from repro_torch.core import env as env_lib
    from repro_torch.serving import CostEvalBatcher
    from repro_torch.serving.batcher import _Item, pack_point_rows

    rng = np.random.default_rng(9)
    cases = []
    for wl, objective in (("ncf", "latency"), ("mobilenet_v2", "energy")):
        ecfg = api.EnvConfig(objective=objective, platform="cloud")
        env = env_lib.make_env(workloads.get_workload(wl), ecfg, device=dev)
        for b in (3, 5):
            g = torch.as_tensor(rng.integers(0, ecfg.levels,
                                             (b, env.num_layers, 2)),
                                device=dev)
            cases.append((env, ecfg, *baselines._decode_and_eval(env, ecfg,
                                                                 g)))

    def items(sel):
        return [_Item(pack_point_rows(env.layers.cpu().numpy(),
                                      pe.cpu().numpy(), kt.cpu().numpy(),
                                      np.float32(ecfg.dataflow)),
                      tuple(pe.shape), ecfg,
                      np.float32(env.budget.cpu().numpy()))
                for env, ecfg, _, pe, kt in (cases[i] for i in sel)]

    def dispatch(its):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                b._dispatch(its)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return [(w.filename, w.lineno) for w in caught
                if "synchronizing CUDA operation" in str(w.message)]

    b = CostEvalBatcher(window_ms=0.0, device=dev)
    try:
        syncs = dispatch(items([0, 2]))            # all fresh
        assert len(syncs) <= 2, syncs
        mixed = items(range(4))                    # 0, 2 cached; 1, 3 not
        syncs = dispatch(mixed)
        assert len(syncs) <= 2, syncs
        syncs = dispatch(items([1, 3]))            # all cached
        assert len(syncs) == 1, syncs
    finally:
        b.close()
    for it, (_, _, want, _, _) in zip(mixed, cases):
        assert it.fit.tobytes() == want.cpu().numpy().tobytes()


def test_service_raises_when_the_per_row_kernel_fails(dev, monkeypatch):
    """A launch the card refuses (more threads per block than it takes)
    fails the request: nothing falls back to the plain version."""
    from repro_torch.serving import CostEvalBatcher

    monkeypatch.setattr(costmodel_eval, "MULTI_THREADS", 4096)
    layers = layers_lib.layers_to_array(workloads.get_workload("ncf"))
    pe = np.full((2, len(layers)), 8, np.float32)
    plain = dict(ref.cuda_calls)
    b = CostEvalBatcher(window_ms=0.0, device=dev)
    try:
        with pytest.raises(RuntimeError, match="launch failed"):
            b.evaluate(layers, pe, pe, np.float32(0),
                       api.EnvConfig(platform="cloud"), np.float32(1e18))
    finally:
        b.close()
    assert ref.cuda_calls == plain


# ---------------------------------------------------------------------------
# Flash-decode kernel and the LM decode step.
# ---------------------------------------------------------------------------
def _attn_inputs(B, Hq, Hkv, D, T, dt, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed + T + D)
    f = lambda *s: torch.randn(s, generator=gen, device=dev).to(dt)
    return f(B, Hq, D), f(B, T, Hkv, D), f(B, T, Hkv, D)


# Both versions read the same bf16 (or f32) values and compute in float32,
# so the one tolerance, atol 1e-4 (the reference's own), holds for both.
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,D,T", [
    (1, 4, 4, 128, 512), (2, 8, 2, 128, 1024), (2, 16, 2, 128, 2048),
    (1, 8, 1, 256, 512),                       # the reference's shapes
    (8, 16, 2, 128, 520), (2, 8, 2, 128, 1), (3, 8, 2, 128, 37),
    (2, 8, 2, 128, 700),                       # ragged T
    (2, 4, 4, 16, 37), (2, 16, 16, 64, 65), (1, 32, 2, 256, 129),
    # Split edges: a split of one key (T = 513), one tile + 1 key, T just
    # over a whole number of splits, and B * Hkv large enough for S = 1.
    (8, 16, 2, 128, 513), (2, 8, 2, 128, 33), (8, 16, 2, 128, 2049),
    (144, 8, 2, 64, 100), (2, 24, 2, 128, 300),
])
def test_flash_decode_kernel_matches_plain(dev, dt, B, Hq, Hkv, D, T):
    q, k, v = _attn_inputs(B, Hq, Hkv, D, T, dt, dev)
    S, per = flash_decode.plan_splits(
        B, Hkv, T, torch.cuda.get_device_properties(dev).multi_processor_count)
    ops.reset_launch_counts()
    got = ops.decode_attention(q, k, v)
    assert ops.launch_counts()["flash_decode"] == 1
    assert ops.launch_counts()["flash_decode_combine"] == int(S > 1)
    assert ref.cuda_calls["flash_decode_ref"] == 0
    want = ref.flash_decode_ref(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (B, Hq, D)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    torch.testing.assert_close(
        got, ref.flash_decode_split_ref(q, k, v, per * flash_decode.TILE),
        rtol=0, atol=1e-5)
    assert torch.equal(got, ops.decode_attention(q, k, v))   # same bits


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_at_decode_32k_batch(dev, dt):
    """The reference's decode_32k batch and length (128, 32768): 4.3 GB of
    bf16 cache; the split plan still holds the result to the plain
    version, and two calls give the same bits."""
    B, Hq, Hkv, D, T = 128, 16, 2, 128, 32768
    q, k, v = _attn_inputs(B, Hq, Hkv, D, T, dt, dev, seed=5)
    got = flash_decode.flash_decode(q, k, v)
    again = flash_decode.flash_decode(q, k, v)
    want = ref.flash_decode_ref(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_decode_reads_a_strided_cache_view(dev, dt):
    """cache[:, :L] of a longer cache is read in place and gives the result
    of its contiguous copy."""
    B, Hq, Hkv, D, Tmax = 4, 16, 2, 128, 1024
    q, k, v = _attn_inputs(B, Hq, Hkv, D, Tmax, dt, dev, seed=1)
    for L in (1, 300, 513):
        got = flash_decode.flash_decode(q, k[:, :L], v[:, :L])
        want = flash_decode.flash_decode(q, k[:, :L].contiguous(),
                                         v[:, :L].contiguous())
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
        torch.testing.assert_close(
            got, ref.flash_decode_ref(q, k[:, :L], v[:, :L]), rtol=0,
            atol=1e-4)


def test_flash_decode_wrapper_rejects_bad_inputs(dev):
    q, k, v = _attn_inputs(2, 8, 2, 64, 10, torch.float32, dev)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_decode.flash_decode(q.cpu(), k, v)
    with pytest.raises(ValueError, match="is torch.bfloat16"):
        flash_decode.flash_decode(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="dtype"):
        flash_decode.flash_decode(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head dim"):
        flash_decode.flash_decode(*_attn_inputs(2, 8, 2, 32, 10,
                                                torch.float32, dev))
    with pytest.raises(ValueError, match="whole number"):
        flash_decode.flash_decode(*_attn_inputs(1, 34, 2, 64, 10,
                                                torch.float32, dev))
    with pytest.raises(ValueError, match="rows must be contiguous"):
        flash_decode.flash_decode(q, k.transpose(1, 2).contiguous()
                                  .transpose(1, 2), v)
    with pytest.raises(ValueError, match="more than one device"):
        ops.decode_attention(q, k.cpu(), v)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,D,T,width", [
    (8, 16, 2, 128, 512, 16), (8, 16, 2, 128, 1, 4), (2, 8, 2, 128, 37, 1),
    (2, 8, 2, 64, 700, 8), (1, 32, 2, 256, 129, 64), (3, 8, 2, 128, 0, 2),
])
def test_flash_decode_partials_and_combine_match_plain(dev, dt, B, Hq, Hkv,
                                                       D, T, width):
    """The split kernel alone (partials of at most ``width`` splits, one
    launch; none for T = 0, the neutral partial) against the plain
    partials of the same split plan, and the combine kernel alone against
    the plain combine; padded with neutral partials, the combine's bits
    do not move, and two calls give the same bits."""
    q, k, v = _attn_inputs(B, Hq, Hkv, D, max(T, 1), dt, dev, seed=T)
    k, v = k[:, :T], v[:, :T]
    ops.reset_launch_counts()
    parts = flash_decode.flash_decode_partials(q, k, v, width)
    assert ops.launch_counts()["flash_decode_partials"] == int(T > 0)
    S = parts.shape[2]
    assert parts.shape == (B, Hq, S, D + 2) and 1 <= S <= width
    if T == 0:
        assert torch.equal(parts, ref.neutral_partials(B, Hq, 1, D, dev))
        return
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan, per = flash_decode.plan_splits(B, Hkv, T, sms, width)
    assert S == plan
    want = ref.flash_decode_partials_ref(q, k, v, per * flash_decode.TILE)
    torch.testing.assert_close(parts, want, rtol=0, atol=1e-4)
    out = flash_decode.flash_decode_combine(parts)
    assert ops.launch_counts()["flash_decode_combine"] == 1
    torch.testing.assert_close(out, ref.flash_decode_combine_ref(parts),
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(out, ref.flash_decode_ref(q, k, v), rtol=0,
                               atol=1e-4)
    padded = ops.decode_attention_partials(q, k, v, 1,
                                           width * flash_decode.TILE)
    assert padded.shape[2] == width and torch.equal(padded[:, :, :S], parts)
    assert torch.equal(padded[:, :, S:], ref.neutral_partials(
        B, Hq, width - S, D, dev))
    assert torch.equal(flash_decode.flash_decode_combine(padded), out)
    assert torch.equal(flash_decode.flash_decode_combine(parts), out)
    if S == flash_decode.plan_splits(B, Hkv, T, sms)[0]:
        # The split plan of flash_decode: the same bits.
        assert torch.equal(out, flash_decode.flash_decode(q, k, v))


def test_sharded_decode_attention_over_virtual_shards(dev):
    """A bf16 cache (8, 1024, 2, 128) cut into m in {2, 4, 8} contiguous
    shards at positions 0, 100, 511 and 1023: each shard's partials (the
    neutral one where it holds no valid row), side by side in shard order
    and combined, agree with ``flash_decode`` and the plain version on the
    valid rows within 1e-5, with the same bits on a second call."""
    B, Hq, Hkv, D, T = 8, 16, 2, 128, 1024
    q, k, v = _attn_inputs(B, Hq, Hkv, D, T, torch.bfloat16, dev, seed=3)

    def combined(pos, m):
        Tl = T // m
        parts = [ops.decode_attention_partials(
            q, k[:, r * Tl:r * Tl + n], v[:, r * Tl:r * Tl + n], m, Tl)
            for r in range(m)
            for n in (min(Tl, max(0, pos + 1 - r * Tl)),)]
        return ops.decode_attention_combine(torch.cat(parts, dim=2))

    for m in (2, 4, 8):
        for pos in (0, 100, 511, 1023):
            got = combined(pos, m)
            torch.testing.assert_close(
                got, flash_decode.flash_decode(q, k[:, :pos + 1],
                                               v[:, :pos + 1]),
                rtol=0, atol=1e-5)
            torch.testing.assert_close(
                got, ref.flash_decode_ref(q, k[:, :pos + 1], v[:, :pos + 1]),
                rtol=0, atol=1e-5)
            assert torch.equal(got, combined(pos, m))


def test_decode_step_on_card_matches_cpu(dev):
    """Six f32 decode steps of the qwen2.5 smoke model on the card (every
    attention through the kernel) against the same steps on the CPU (the
    plain version): logits within atol/rtol 1e-4."""
    from repro_torch import configs
    from repro_torch.core import env as env_lib
    from repro_torch.models import lm

    env_lib.resolve_device(dev)               # float32 products, TF32 off
    cfg = dataclasses.replace(configs.get_smoke("qwen2p5_3b"),
                              param_dtype="float32",
                              compute_dtype="float32")
    cpu_model = lm.init_params(cfg, torch.Generator().manual_seed(0))
    card_model = lm.init_params(cfg, torch.Generator().manual_seed(0)
                                ).to(dev)
    tokens = torch.randint(0, cfg.vocab_size, (6, 3),
                           generator=torch.Generator().manual_seed(1))
    c_cpu = lm.init_cache(cfg, 3, 8)
    c_dev = lm.init_cache(cfg, 3, 8, device=dev)
    ops.reset_launch_counts()
    for t in range(6):
        want, c_cpu = lm.decode_step(cpu_model, cfg, c_cpu, tokens[t])
        got, c_dev = lm.decode_step(card_model, cfg, c_dev, tokens[t].to(dev))
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    assert ops.launch_counts()["flash_decode"] == 6 * cfg.num_layers
    assert ref.cuda_calls["flash_decode_ref"] == 0


# ---------------------------------------------------------------------------
# The stage-1 epoch as a CUDA graph.
# ---------------------------------------------------------------------------
def test_captured_kernel_calls_replay_the_eager_bits(dev):
    """One cost_eval, one lstm_cell and one lstm_cell_bwd call captured in
    a CUDA graph (ctypes launches of libraries built with nvcc's static
    runtime) and replayed on new inputs give the bits of eager calls on
    those inputs; the warm-up and the capture count no launch, each
    replay counts one of each."""
    from repro_torch.core import graph as graph_lib

    arr = layers_lib.layers_to_array(workloads.get_workload("mobilenet_v2"))
    lt = torch.as_tensor(arr, dtype=torch.float32, device=dev).T.contiguous()
    N = lt.shape[1]
    pe, kt = (torch.ones((20, N), device=dev) for _ in range(2))
    args, dh, dc = _lstm_args(1, 10, 128, dev, seed=5)
    out = {}

    def calls():
        out["cost"] = costmodel_eval.cost_eval(lt, pe, kt, 0.0)
        out["fwd"] = lstm_cell.lstm_cell(*args)
        out["bwd"] = lstm_cell.lstm_cell_bwd(*args[:5], out["fwd"][2:], dh,
                                             dc)

    ops.reset_launch_counts()
    step = graph_lib.CapturedStep(calls, calls, dev)
    assert all(v == 0 for v in ops.launch_counts().values())
    rng = np.random.default_rng(0)
    for replay in range(2):
        pe.copy_(torch.as_tensor(rng.integers(1, 161, (20, N)),
                                 dtype=torch.float32))
        kt.copy_(torch.as_tensor(rng.integers(1, 17, (20, N)),
                                 dtype=torch.float32))
        for t in (*args, dh, dc):
            t.copy_(torch.randn_like(t) * 0.1)
        step.replay()
        cost = costmodel_eval.cost_eval(lt, pe, kt, 0.0)
        fwd = lstm_cell.lstm_cell(*args)
        bwd = lstm_cell.lstm_cell_bwd(*args[:5], fwd[2:], dh, dc)
        torch.cuda.synchronize()
        assert torch.equal(out["cost"], cost)
        assert torch.equal(out["fwd"], fwd)
        assert all(torch.equal(a, b) for a, b in zip(out["bwd"], bwd))
    counts = ops.launch_counts()
    assert (counts["cost_eval"], counts["lstm_cell"],
            counts["lstm_cell_bwd"]) == (4, 4, 4)


def _stage1(dev, epochs, name="mobilenet_v2"):
    from repro_torch.core import env as env_lib
    from repro_torch.core import policy as policy_lib
    from repro_torch.core import reinforce

    wl = workloads.get_workload(name)
    ecfg = api.EnvConfig(platform="iot")
    pcfg = policy_lib.PolicyConfig(obs_dim=ecfg.obs_dim)
    rcfg = reinforce.ReinforceConfig(epochs=epochs, seed=0)
    return wl, ecfg, pcfg, rcfg, env_lib.make_env(wl, ecfg, dev)


def test_graphed_stage1_gives_the_bits_of_eager_epochs(dev):
    """``run_search`` on the card (one CUDA graph, replayed in chunks)
    against ``make_epoch_fn`` run eagerly from the same seed: every metric
    of every epoch and the final state (params, Adam state, best,
    generator) bit-equal."""
    from repro_torch.core import reinforce
    from repro_torch.training import optim

    wl, ecfg, pcfg, rcfg, env = _stage1(dev, 12)
    got, hist = reinforce.run_search(wl, ecfg, rcfg, pcfg, chunk=5, env=env)
    opt = optim.Adam(lr=rcfg.lr)
    st = reinforce.init_search(env, ecfg, pcfg, rcfg, opt)
    epoch_fn = reinforce.make_epoch_fn(ecfg, pcfg, rcfg, env, opt)
    metrics = []
    for _ in range(rcfg.epochs):
        st, m = epoch_fn(st)
        metrics.append(m)
    for k in reinforce.METRICS:
        want = torch.stack([m[k] for m in metrics]).cpu().numpy()
        assert hist[k].tobytes() == want.tobytes(), k
    assert all(torch.equal(a, b) for a, b in zip(got.params.parameters(),
                                                 st.params.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(
        reinforce.state_tensors(got), reinforce.state_tensors(st)))
    assert torch.equal(got.generator.get_state(), st.generator.get_state())


def test_graph_replays_count_launches(dev):
    """Stage 1 through the graph counts every replay's launches, and the
    warm-up and capture none: one cost, one forward and one backward
    launch per layer and epoch (plus make_env's cost launch), no plain
    version on the card."""
    from repro_torch.core import reinforce

    wl, ecfg, pcfg, rcfg, _ = _stage1(dev, 7, name="ncf")
    ops.reset_launch_counts()
    reinforce.run_search(wl, ecfg, rcfg, pcfg, chunk=3, device=dev)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    N = len(wl)
    assert counts["cost_eval"] == 1 + N * rcfg.epochs
    assert counts["lstm_cell"] == counts["lstm_cell_bwd"] == N * rcfg.epochs
    assert all(v == 0 for v in ref.cuda_calls.values())


def test_captured_two_stage_records_its_capture_and_device_time(dev):
    """A traced two_stage search on the card: one ``graph.capture`` span a
    search (stage 1's epoch graph, inside ``search.run``), with the
    capture's launches; every ``reinforce`` chunk carries its replays'
    summed device time from CUDA events, above 0 and within the stream's
    time from the first replay to the last, which is within the chunk's
    wall time; and the outcome equals the untraced one."""
    from repro_torch import obs

    req = lambda: api.SearchRequest(
        workload="ncf", env=api.EnvConfig(platform="cloud"), eps=12, seed=3,
        method="two_stage", options={"ga": {"generations": 10}},
        device="cuda", progress_every=5, on_progress=lambda t: None)
    plain = api.run_search(req())
    obs.enable(trace=True)
    obs.reset()
    try:
        traced = api.run_search(req())
        api.run_search(req())
        spans = obs.tracer().spans()
    finally:
        obs.disable()
        obs.reset()
    assert plain.history.tobytes() == traced.history.tobytes()
    assert plain.extras["ga_history"].tobytes() == \
        traced.extras["ga_history"].tobytes()
    captures = [s for s in spans if s["name"] == "graph.capture"]
    assert len(captures) == 2
    N = len(workloads.get_workload("ncf"))
    for s in captures:
        assert s["parent"] == "search.run"
        assert 0 < s["attrs"]["warmup_us"] < s["dur_us"]
        # One cost, one LSTM forward and one backward launch a layer.
        assert s["attrs"]["launches"] == 3 * N
    chunks = [s for s in spans if s["name"] == "search.chunk"
              and s["attrs"]["engine"] == "reinforce"]
    assert len(chunks) == 2 * 3            # 12 epochs in chunks of 5
    for c in chunks:
        a = c["attrs"]
        assert 0 < a["device_us"] <= a["stream_us"] <= c["dur_us"]


@pytest.mark.parametrize("compress", [False, True])
def test_graphed_dist_reinforce_gives_the_bits_of_eager_epochs(dev,
                                                               compress):
    """``dist_reinforce`` on a (2, 2) pod x data virtual mesh, E = 2,
    shard 1 dead: 20 epochs through ``run_distributed_search`` (one CUDA
    graph, replayed) against 20 eager epochs of ``make_distributed_epoch``
    from the same seed, every metric and the final state bit-equal; the
    graph's launches exact: per epoch N table-cost and N LSTM-forward
    launches at B = 8, and N LSTM-backward launches a backward pass (one
    pass, or one a pod with the int8 hop)."""
    from repro_torch.core import reinforce
    from repro_torch.distributed import collectives, dist_search
    from repro_torch.training import optim

    wl, ecfg, pcfg, rcfg, env = _stage1(dev, 20, name="ncf")
    mesh = collectives.VirtualMesh((2, 2), ("pod", "data"), dev)
    dcfg = dist_search.DistConfig(episodes_per_device=2,
                                  compress_pod_axis=compress)
    mask = [True, False, True, True]
    ops.reset_launch_counts()
    got, hist = dist_search.run_distributed_search(
        wl, ecfg, mesh, rcfg, dcfg, pcfg, straggler_mask=mask, env=env)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    N, passes = len(wl), 2 if compress else 1
    assert counts["cost_eval"] == counts["lstm_cell"] == N * rcfg.epochs
    assert counts["lstm_cell_bwd"] == passes * N * rcfg.epochs
    assert all(v == 0 for v in ref.cuda_calls.values())

    opt = optim.Adam(lr=rcfg.lr)
    st = reinforce.init_search(env, ecfg, pcfg, rcfg, opt)
    epoch_fn = dist_search.make_distributed_epoch(
        ecfg, pcfg, rcfg, env, opt, mesh,
        collectives.alive_flags(mesh, mask), dcfg)
    metrics = []
    for _ in range(rcfg.epochs):
        st, m = epoch_fn(st)
        metrics.append(m)
    for k in dist_search.DIST_METRICS:
        want = torch.stack([m[k] for m in metrics]).cpu().numpy()
        assert hist[k].tobytes() == want.tobytes(), k
    assert all(torch.equal(a, b) for a, b in zip(got.params.parameters(),
                                                 st.params.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(
        reinforce.state_tensors(got), reinforce.state_tensors(st)))
    assert torch.equal(got.generator.get_state(), st.generator.get_state())


def test_concurrent_stage1_captures_give_their_serial_bits(dev):
    """Two stage-1 searches and a GA through the service at once: both
    searches capture and replay their graphs in worker threads while the
    other threads use the card, and every outcome equals its serial run
    byte for byte."""
    ecfg = api.EnvConfig(platform="cloud")
    cases = [("reinforce", "ncf", 1), ("reinforce", "mnasnet", 2),
             ("ga", "ncf", 3)]
    reqs = lambda: [api.SearchRequest(workload=wl, env=ecfg,
                                      eps=30 if m == "reinforce" else 400,
                                      seed=seed, method=m)
                    for m, wl, seed in cases]
    serial = [api.run_search(r) for r in reqs()]
    with SearchService(ServiceConfig(max_workers=3)) as svc:
        outs = svc.run_all(reqs())
    for got, want in zip(outs, serial):
        assert got.best_value == want.best_value
        assert got.history.tobytes() == want.history.tobytes()
        assert got.pe.tobytes() == want.pe.tobytes()
        assert got.kt.tobytes() == want.kt.tobytes()


def test_a_capture_waits_for_another_threads_capture(dev):
    """A thread that starts a capture while another thread's capture is
    under way (the first thread's step pauses mid-capture) waits for it:
    both graphs capture, and both replay the bits of eager calls."""
    import threading
    import time

    from repro_torch.core import graph as graph_lib

    args, dh, dc = _lstm_args(1, 10, 128, dev, seed=9)
    started = threading.Event()
    outs, steps, errors = {}, {}, []

    def first():
        outs["a"] = lstm_cell.lstm_cell(*args)
        if torch.cuda.is_current_stream_capturing():
            started.set()
            time.sleep(0.5)
        outs["a2"] = lstm_cell.lstm_cell_bwd(*args[:5], outs["a"][2:], dh,
                                             dc)

    def second():
        outs["b"] = lstm_cell.lstm_cell(*args)

    def run(name, fn, wait):
        try:
            if wait:
                started.wait(timeout=30)
            steps[name] = graph_lib.CapturedStep(fn, fn, dev)
        except Exception as e:          # reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=("a", first, False)),
               threading.Thread(target=run, args=("b", second, True))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert started.is_set()
    for step in steps.values():
        step.replay()
    want = lstm_cell.lstm_cell(*args)
    bwd = lstm_cell.lstm_cell_bwd(*args[:5], want[2:], dh, dc)
    torch.cuda.synchronize()
    assert torch.equal(outs["a"], want) and torch.equal(outs["b"], want)
    assert all(torch.equal(a, b) for a, b in zip(outs["a2"], bwd))


def _to(state, dev):
    """A copy of an A2C/PPO2 search state on ``dev`` (generator aside)."""
    from repro_torch.core import reinforce
    from repro_torch.training import optim

    c = reinforce.clone_state(state)
    mv = lambda t: t.to(dev)
    return c._replace(
        params=c.params.to(dev),
        opt_state=optim.OptState(mv(c.opt_state.step),
                                 {k: mv(v) for k, v in c.opt_state.mu.items()},
                                 {k: mv(v) for k, v in c.opt_state.nu.items()}),
        pmin=mv(c.pmin), best_value=mv(c.best_value),
        best_pe_lvl=mv(c.best_pe_lvl), best_kt_lvl=mv(c.best_kt_lvl),
        best_df=mv(c.best_df), generator=torch.Generator(device=dev),
        epoch=mv(c.epoch))


@pytest.mark.parametrize("algo", ["a2c", "ppo2"])
def test_actor_critic_epoch_on_card_matches_the_cpu(dev, algo):
    """One A2C / PPO2 epoch (E = 4, mobilenet_v2, LSTM(128)) through the
    kernels against the same epoch on the CPU's plain versions, the CPU
    rollout's actions replayed: rewards exact to the cost model's bound,
    the post-Adam params within 1e-5 per update; each kernel launched as
    the epoch implies, and no plain version on the card."""
    from repro_torch.core import env as env_lib
    from repro_torch.core import policy as policy_lib
    from repro_torch.core import rl_baselines as rl
    from repro_torch.training import optim

    wl = workloads.get_workload("mobilenet_v2")
    ecfg = api.EnvConfig(platform="cloud")
    pcfg = policy_lib.PolicyConfig(obs_dim=ecfg.obs_dim)
    acfg = rl.ACConfig(algo=algo, epochs=1, episodes_per_epoch=4, seed=0)
    opt = optim.Adam(lr=acfg.lr, clip_norm=1.0)
    envs = {d: env_lib.make_env(wl, ecfg, d) for d in ("cpu", dev)}
    cpu = rl.init_ac_search(envs["cpu"], ecfg, pcfg, acfg, opt)
    card = _to(cpu, dev)
    rolls = rl.make_ac_rollout(ecfg, pcfg, envs["cpu"])(
        cpu.params, cpu.pmin, cpu.generator, 4)
    new_cpu, _ = rl.make_ac_epoch_fn(ecfg, pcfg, acfg, envs["cpu"], opt)(
        cpu, rolls.actions)
    ops.reset_launch_counts()
    new_card, _ = rl.make_ac_epoch_fn(ecfg, pcfg, acfg, envs[dev], opt)(
        card, rolls.actions.to(dev))
    torch.cuda.synchronize()
    N, updates = len(wl), 1 if algo == "a2c" else acfg.ppo_updates
    counts = ops.launch_counts()
    assert (counts["cost_eval"], counts["lstm_cell"],
            counts["lstm_cell_bwd"]) == (N, N * (1 + updates), N * updates)
    assert all(v == 0 for v in ref.cuda_calls.values())
    for (k, a), b in zip(new_card.params.named_parameters(),
                         new_cpu.params.parameters()):
        torch.testing.assert_close(a.cpu(), b, atol=1e-5 * updates, rtol=0,
                                   msg=k)
    torch.testing.assert_close(new_card.best_value.cpu(), new_cpu.best_value,
                               rtol=1e-5, atol=0)


def test_relaxed_round_on_card_matches_the_cpu(dev):
    """One relaxed round (4 restarts, 25 Adam steps through the soft model
    on mobilenet_v2) on the card against the CPU from the same state:
    params within 1e-4, the same rounded candidate; no kernel runs in the
    descent."""
    from repro_torch.core import env as env_lib
    from repro_torch.core import relaxed

    wl = workloads.get_workload("mobilenet_v2")
    ecfg = api.EnvConfig(platform="iot")
    cfg = relaxed.RelaxedConfig(seed=0)
    envs = {d: env_lib.make_env(wl, ecfg, d) for d in ("cpu", dev)}
    st = relaxed._init_state(envs["cpu"], cfg)
    mv = lambda ts: tuple(t.to(dev) for t in ts)
    card = st._replace(params=mv(st.params), m=mv(st.m), v=mv(st.v),
                       tau=st.tau.to(dev), gstep=st.gstep.to(dev),
                       best_pe=st.best_pe.to(dev), best_kt=st.best_kt.to(dev),
                       best_df=st.best_df.to(dev))
    want, *cand_cpu = relaxed.make_round_fn(envs["cpu"], ecfg, cfg)[0](st)
    ops.reset_launch_counts()
    got, *cand = relaxed.make_round_fn(envs[dev], ecfg, cfg)[0](card)
    torch.cuda.synchronize()
    assert all(v == 0 for v in ops.launch_counts().values())
    for a, b in zip(got.params, want.params):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)
    for a, b in zip(cand, cand_cpu):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("mix", [False, True])
def test_nsga2_in_graph_fitness_equals_flat_path_on_card(dev, mix):
    """On the card the engine's fitness (the table kernel at (P, N)) and
    the adapter's default (the per-row kernel on packed rows, then the
    batcher's aggregation) give the same bits, so whole runs by both paths
    are byte-identical; each generation launches one kernel."""
    from repro_torch.core import env as env_lib
    from repro_torch.core import nsga2
    from repro_torch.serving import batcher

    ecfg = env_lib.EnvConfig(platform="iot", mix=mix)
    env = env_lib.make_env(workloads.get_workload("mobilenet_v2"), ecfg,
                           dev)
    cfg = nsga2.NSGA2Config(population=64, generations=6, seed=3)
    eval_fn = batcher.make_local_costs_eval(env, ecfg)
    engine = nsga2.make_nsga2_engine(env, ecfg, cfg)
    state = engine.init_carry(cfg.seed)
    for _ in range(cfg.generations):
        before = ops.launch_counts()
        in_graph = engine.fitness(state.pop)
        after = ops.launch_counts()
        assert after["cost_eval"] == before["cost_eval"] + 1
        flat = eval_fn(*(v.cpu().numpy() if torch.is_tensor(v)
                         else np.float32(v)
                         for v in engine.decode(state.pop)))
        assert ops.launch_counts()["cost_eval_multi"] == (
            after["cost_eval_multi"] + 1)
        assert in_graph.cpu().numpy().tobytes() == flat.tobytes()
        state, _ = engine.evolve(state, in_graph)
    s1, h1 = nsga2.run_nsga2_search(None, ecfg, cfg, env=env)
    s2, h2 = nsga2.run_nsga2_search(None, ecfg, cfg, env=env,
                                    eval_fn=eval_fn)
    assert h1.tobytes() == h2.tobytes()
    for a, b in zip(s1, s2):
        if torch.is_tensor(a):
            assert torch.equal(a, b)
    assert torch.equal(s1.generator.get_state(), s2.generator.get_state())


def test_nsga2_selection_on_card_matches_the_cpu(dev):
    """Selection on the card (front peeling, crowding, survivors, the
    archive) gives the CPU's bits on the same costs."""
    from repro_torch.core import nsga2

    rng = np.random.default_rng(4)
    c = rng.integers(1, 40, (128, 4)).astype(np.float32) * 1.5
    c[:64] = np.inf
    budget = np.float32(30.0)
    out = {}
    for d in ("cpu", dev):
        costs, b = torch.tensor(c, device=d), torch.tensor(budget, device=d)
        viol = nsga2._violation(costs, 2, b)
        rank = nsga2._front_ranks(nsga2._constrained_dominance(costs, viol))
        crowd = nsga2._crowding(costs[:, :2], rank)
        sel = nsga2._select_best(rank, crowd, 64)
        g = torch.arange(128 * 3 * 2, device=d).reshape(128, 3, 2)
        arch = nsga2._update_archive(g[:32], costs[96:], g[32:96],
                                     costs[64:].flip(0), 2, b)
        out[str(d)] = [t.cpu() for t in (rank, crowd, sel, *arch)]
    for a, b in zip(out["cpu"], out[str(dev)]):
        assert torch.equal(a, b)
