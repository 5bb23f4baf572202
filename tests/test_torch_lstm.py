"""The port's LSTM step and its gradient against the JAX package, on the CPU.

Inputs are made with numpy from a seed.  The JAX side runs both of its
paths: the Pallas kernel in interpret mode and the jnp reference.
Tolerance: atol 1e-5, the bound the reference holds its own LSTM kernel to
(tests/test_kernels.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import costmodel_eval, lstm_cell
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

SHAPES = [(1, 10, 128), (5, 10, 128), (8, 11, 128), (16, 130, 128),
          (3, 10, 256)]


def _inputs(B, I, H, seed=0):
    rng = np.random.default_rng(seed + B + I + H)
    f = lambda *s, scale=0.1: (rng.standard_normal(s) * scale).astype(
        np.float32)
    return (f(B, I, scale=1.0), f(B, H), f(B, H), f(I, 4 * H), f(H, 4 * H),
            f(4 * H))


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("B,I,H", SHAPES)
def test_lstm_step_matches_reference(B, I, H, use_kernel):
    args = _inputs(B, I, H)
    h_t, c_t = tops.lstm_step(*(torch.from_numpy(a) for a in args))
    h_j, c_j = jops.lstm_step(*args, use_kernel=use_kernel)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=1e-5)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-5)


@pytest.mark.parametrize("B,I,H", SHAPES)
def test_lstm_bwd_ref_matches_jax_vjp(B, I, H):
    """The backward formula against jax.vjp of the reference's jnp step."""
    args = _inputs(B, I, H, seed=1)
    rng = np.random.default_rng(99)
    dh = rng.standard_normal((B, H)).astype(np.float32)
    dc = rng.standard_normal((B, H)).astype(np.float32)
    _, vjp = jax.vjp(jref.lstm_cell_ref, *(jnp.asarray(a) for a in args))
    want = vjp((jnp.asarray(dh), jnp.asarray(dc)))
    got = tref.lstm_cell_bwd_ref(*(torch.from_numpy(a) for a in args),
                                 torch.from_numpy(dh), torch.from_numpy(dc))
    for name, g, w in zip(("dx", "dh", "dc", "dwx", "dwh", "db"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   err_msg=name)


def test_lstm_bwd_ref_matches_torch_autograd():
    """The formula equals autograd through the plain forward."""
    args = [torch.from_numpy(a).requires_grad_()
            for a in _inputs(4, 10, 128, seed=2)]
    h2, c2 = tops.lstm_step(*args)
    gen = torch.Generator().manual_seed(0)
    dh = torch.randn(h2.shape, generator=gen)
    dc = torch.randn(c2.shape, generator=gen)
    want = torch.autograd.grad((h2, c2), args, (dh, dc))
    got = tref.lstm_cell_bwd_ref(*(a.detach() for a in args), dh, dc)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


@pytest.mark.parametrize("B,I,H", [(1, 10, 128), (8, 11, 128),
                                   (3, 10, 256)])
def test_lstm_bwd_saved_ref_matches_jax_vjp(B, I, H):
    """The backward kernel's plain version, in the kernel's signature (the
    gates saved by the forward's plain version), against jax.vjp of the
    reference's jnp step."""
    x, h, c, wx, wh, b = _inputs(B, I, H, seed=3)
    rng = np.random.default_rng(98)
    dh = rng.standard_normal((B, H)).astype(np.float32)
    dc = rng.standard_normal((B, H)).astype(np.float32)
    _, vjp = jax.vjp(jref.lstm_cell_ref,
                     *(jnp.asarray(a) for a in (x, h, c, wx, wh, b)))
    want = vjp((jnp.asarray(dh), jnp.asarray(dc)))
    t = [torch.from_numpy(a) for a in (x, h, c, wx, wh, b)]
    h2, c2, gates = tref.lstm_cell_saved_ref(*t)
    assert gates.shape == (5, B, H)
    got = tref.lstm_cell_bwd_saved_ref(*t[:5], gates, torch.from_numpy(dh),
                                       torch.from_numpy(dc))
    for name, g, w in zip(("dx", "dh", "dc", "dwx", "dwh", "db"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("B,I,H", SHAPES)
def test_lstm_saved_refs_match_the_recomputing_refs(B, I, H):
    """The forward's plain version with saved gates gives lstm_cell_ref's
    (h', c'), and the backward from those gates gives lstm_cell_bwd_ref's
    six gradients."""
    t = [torch.from_numpy(a) for a in _inputs(B, I, H, seed=4)]
    gen = torch.Generator().manual_seed(B + H)
    dh, dc = (torch.randn((B, H), generator=gen) for _ in range(2))
    h2, c2, gates = tref.lstm_cell_saved_ref(*t)
    for g, w in zip((h2, c2), tref.lstm_cell_ref(*t)):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    got = tref.lstm_cell_bwd_saved_ref(*t[:5], gates, dh, dc)
    for g, w in zip(got, tref.lstm_cell_bwd_ref(*t, dh, dc)):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=0)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers raise on a CPU tensor instead of computing, and
    count no launch."""
    tops.reset_launch_counts()
    x = torch.zeros(1, 10)
    h = torch.zeros(1, 128)
    w = (torch.zeros(10, 512), torch.zeros(128, 512))
    with pytest.raises(ValueError, match="CUDA tensor"):
        lstm_cell.lstm_cell(x, h, h, *w, torch.zeros(512))
    with pytest.raises(ValueError, match="CUDA tensor"):
        lstm_cell.lstm_cell_bwd(x, h, h, *w, torch.zeros(5, 1, 128), h, h)
    with pytest.raises(ValueError, match="CUDA tensor"):
        lstm_cell.LSTMCellFn.apply(x, h, h, *w, torch.zeros(512))
    pe = torch.ones(2, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        costmodel_eval.cost_eval(torch.ones(8, 3), pe, pe, pe)
    assert all(v == 0 for v in tops.launch_counts().values())


def test_lstm_wrappers_refuse_sizes_past_the_limit():
    """I + H past ``MAX_K`` raises a ValueError that names the limit, before
    any tensor is read, in both kernels' wrappers."""
    tops.reset_launch_counts()
    x = torch.zeros(1, lstm_cell.MAX_K - 127)
    h = torch.zeros(1, 128)
    with pytest.raises(ValueError, match=f"limit of {lstm_cell.MAX_K}"):
        lstm_cell.lstm_cell(x, h, h, None, None, None)
    with pytest.raises(ValueError, match=f"limit of {lstm_cell.MAX_K}"):
        lstm_cell.lstm_cell_bwd(x, h, h, None, None, None, h, h)
    assert all(v == 0 for v in tops.launch_counts().values())


def test_cpu_path_uses_plain_versions_and_counts_no_launch():
    tops.reset_launch_counts()
    args = [torch.from_numpy(a) for a in _inputs(2, 10, 128)]
    tops.lstm_step(*args)
    tops.batched_cost(torch.ones(3, 8), torch.ones(2, 3), 1.0, 0.0)
    tops.batched_cost_multi(torch.ones(2, 3, 8), torch.ones(2, 3), 1.0, 0.0)
    tops.decode_attention(torch.ones(1, 4, 16), torch.ones(1, 5, 2, 16),
                          torch.ones(1, 5, 2, 16))
    assert tops.launch_counts() == {"cost_eval": 0, "cost_eval_multi": 0,
                                    "lstm_cell": 0, "lstm_cell_bwd": 0,
                                    "flash_decode": 0,
                                    "flash_decode_combine": 0,
                                    "flash_decode_partials": 0}
    assert tref.cuda_calls == {"cost_eval_ref": 0, "cost_eval_multi_ref": 0,
                               "lstm_cell_ref": 0, "lstm_cell_saved_ref": 0,
                               "lstm_cell_bwd_ref": 0,
                               "lstm_cell_bwd_saved_ref": 0,
                               "flash_decode_ref": 0,
                               "flash_decode_partials_ref": 0,
                               "flash_decode_combine_ref": 0}


def test_lstm_step_cpu_gradient_route_counts_no_launch():
    """On the CPU the step and its gradient go through autograd over the
    plain version: no forward or backward kernel launch is counted, and no
    plain version counts a call on the card."""
    tops.reset_launch_counts()
    args = [torch.from_numpy(a).requires_grad_()
            for a in _inputs(3, 10, 128, seed=5)]
    h2, c2 = tops.lstm_step(*args)
    grads = torch.autograd.grad((h2.sum() + c2.sum()), args)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert tops.launch_counts()["lstm_cell"] == 0
    assert tops.launch_counts()["lstm_cell_bwd"] == 0
    assert all(v == 0 for v in tref.cuda_calls.values())
