"""The port's decode attention against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages.  On CPU
tensors the port runs the kernel's plain version
(``ref.flash_decode_ref``); the JAX side runs its Pallas flash-decode
kernel in interpret mode where it takes the shape (T % 512 == 0) and its
jnp reference elsewhere.  Tolerance: atol 1e-4, the bound the reference
holds its own kernel to (tests/test_kernels.py).
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_decode
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _inputs(B, Hq, Hkv, D, T, seed=0):
    rng = np.random.default_rng(seed + 7 * T + D)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(B, Hq, D), f(B, T, Hkv, D), f(B, T, Hkv, D)


def _port(q, k, v):
    return tops.decode_attention(*(torch.from_numpy(a) for a in (q, k, v)))


# The reference's own kernel test shapes (tests/test_kernels.py).
@pytest.mark.parametrize("B,Hq,Hkv,D,T", [
    (1, 4, 4, 128, 512), (2, 8, 2, 128, 1024), (2, 16, 2, 128, 2048),
    (1, 8, 1, 256, 512),
])
def test_decode_attention_matches_reference_kernel(B, Hq, Hkv, D, T):
    q, k, v = _inputs(B, Hq, Hkv, D, T)
    got = _port(q, k, v)
    want = jops.decode_attention(q, k, v, use_kernel=True)
    assert got.dtype == torch.float32 and got.shape == (B, Hq, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("T", [1, 37, 700])
@pytest.mark.parametrize("B,Hq,Hkv,D", [(2, 8, 2, 64), (1, 16, 1, 16)])
def test_decode_attention_ragged_matches_reference_oracle(B, Hq, Hkv, D, T):
    q, k, v = _inputs(B, Hq, Hkv, D, T, seed=1)
    got = _port(q, k, v)
    want = jref.flash_decode_ref(q, k, v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_decode_attention_bf16_computes_in_f32():
    """bf16 inputs are cast to float32 (as the reference wrapper casts):
    the result equals the oracle on the bf16-rounded values in float32."""
    q, k, v = _inputs(2, 8, 2, 64, 37, seed=2)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = tops.decode_attention(*bf)
    want = jref.flash_decode_ref(*(t.float().numpy() for t in bf))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_strided_cache_view_equals_contiguous_copy():
    """A view cache[:, :L] of a longer cache, as the decode step passes,
    gives the result of its contiguous copy (atol 1e-6: only the memory
    layout differs)."""
    B, Hq, Hkv, D, Tmax, L = 3, 8, 2, 64, 64, 23
    q, k, v = _inputs(B, Hq, Hkv, D, Tmax, seed=3)
    kc, vc = torch.from_numpy(k), torch.from_numpy(v)
    qt = torch.from_numpy(q)
    view = tops.decode_attention(qt, kc[:, :L], vc[:, :L])
    copy = tops.decode_attention(qt, kc[:, :L].contiguous(),
                                 vc[:, :L].contiguous())
    assert not kc[:, :L].is_contiguous()
    torch.testing.assert_close(view, copy, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        view.numpy(), np.asarray(jref.flash_decode_ref(q, k[:, :L],
                                                       v[:, :L])),
        atol=1e-4)


def test_cpu_path_counts_no_launch_and_kernel_wrapper_rejects_cpu():
    tops.reset_launch_counts()
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 16, 5))
    tops.decode_attention(q, k, v)
    assert tops.launch_counts()["flash_decode"] == 0
    assert tref.cuda_calls["flash_decode_ref"] == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_decode.flash_decode(q, k, v)


def test_decode_attention_rejects_mixed_devices():
    """Tensors on two devices raise ("meta" stands in for the card)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 16, 5))
    with pytest.raises(ValueError, match="more than one device"):
        tops.decode_attention(q, k.to("meta"), v)
