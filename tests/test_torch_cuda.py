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
from repro_torch.kernels import costmodel_eval, lstm_cell, ops, ref
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
