"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need an NVIDIA card and nvcc, and skip without them
(the CPU tests hold the plain versions against the JAX package).  On a
machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.costmodel import layers as layers_lib
from repro_torch.costmodel import workloads
from repro_torch.kernels import lstm_cell, ops, ref

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
