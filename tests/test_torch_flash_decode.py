"""The port's decode attention against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages.  On CPU
tensors the port runs the kernel's plain version
(``ref.flash_decode_ref``); the JAX side runs its Pallas flash-decode
kernel in interpret mode where it takes the shape (T % 512 == 0) and its
jnp reference elsewhere.  Tolerance: atol 1e-4, the bound the reference
holds its own kernel to (tests/test_kernels.py).  The CUDA kernel's split
plan (``flash_decode.plan_splits``) and its split-and-combine algorithm
(``ref.flash_decode_split_ref``) are held to the same references here;
the kernel itself runs only on the card (tests/test_torch_cuda.py).
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


# ---------------------------------------------------------------------------
# The split plan and the split-and-combine algorithm of the CUDA kernel.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sms", [132, 16])
@pytest.mark.parametrize("B,Hkv", [(1, 1), (8, 2), (2, 16), (128, 2),
                                   (144, 2), (300, 4)])
@pytest.mark.parametrize("T", [1, 31, 32, 33, 100, 513, 520, 2049, 32768,
                               10**6])
def test_plan_splits_covers_the_cache_in_tiles(B, Hkv, T, sms):
    S, per = flash_decode.plan_splits(B, Hkv, T, sms)
    keys = per * flash_decode.TILE
    tiles = -(-T // flash_decode.TILE)
    bh = B * Hkv
    starts = [s * keys for s in range(S)]
    ends = [min(T, st + keys) for st in starts]
    # In order, tile-aligned, each split non-empty, together exactly [0, T).
    assert starts[0] == 0 and ends[-1] == T
    assert all(e == s2 for e, s2 in zip(ends, starts[1:]))
    assert all(st % flash_decode.TILE == 0 for st in starts)
    assert all(e > st for st, e in zip(starts, ends))
    # Bounded: at most one split per tile and MAX_SPLITS; a split walks at
    # most MAX_SPLIT_TILES tiles unless MAX_SPLITS splits cannot hold T so;
    # the blocks stay within ~BLOCKS_PER_SM waves, or within that cap's count.
    assert 1 <= S <= min(tiles, flash_decode.MAX_SPLITS)
    assert per <= max(flash_decode.MAX_SPLIT_TILES,
                      -(-tiles // flash_decode.MAX_SPLITS))
    assert bh * S <= max(flash_decode.BLOCKS_PER_SM * sms + bh,
                         bh * -(-tiles // flash_decode.MAX_SPLIT_TILES))
    if T <= flash_decode.TILE:
        assert S == 1
    if bh >= 2 * sms and tiles <= flash_decode.MAX_SPLIT_TILES:
        assert S == 1


def test_plan_splits_at_the_paths_shapes():
    """One H100 (132 SMs): one tile per split at the LM path's cache of
    520 keys, and 32 splits of 1,024 keys at a 32k cache."""
    assert flash_decode.plan_splits(8, 2, 520, 132) == (17, 1)
    assert flash_decode.plan_splits(8, 2, 32768, 132) == (32, 32)
    assert flash_decode.plan_splits(128, 2, 32768, 132) == (32, 32)
    assert flash_decode.plan_splits(144, 2, 100, 132) == (1, 4)
    with pytest.raises(ValueError, match="T >= 1"):
        flash_decode.plan_splits(1, 2, 0, 132)


def _split_ref(q, k, v, keys_per_split):
    return tref.flash_decode_split_ref(
        *(torch.from_numpy(a) for a in (q, k, v)), keys_per_split)


# The reference kernel's own test shapes, against its Pallas kernel.
@pytest.mark.parametrize("B,Hq,Hkv,D,T", [
    (1, 4, 4, 128, 512), (2, 8, 2, 128, 1024), (2, 16, 2, 128, 2048),
    (1, 8, 1, 256, 512),
])
def test_split_and_combine_matches_reference_kernel(B, Hq, Hkv, D, T):
    q, k, v = _inputs(B, Hq, Hkv, D, T)
    want = np.asarray(jops.decode_attention(q, k, v, use_kernel=True))
    S, per = flash_decode.plan_splits(B, Hkv, T, 132)
    for keys in {per * flash_decode.TILE, flash_decode.TILE, 96, T}:
        got = _split_ref(q, k, v, keys)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("T", [1, 33, 37, 513, 700])
@pytest.mark.parametrize("B,Hq,Hkv,D", [(2, 8, 2, 64), (1, 16, 1, 16),
                                        (3, 12, 1, 64)])
def test_split_and_combine_ragged_matches_reference_oracle(B, Hq, Hkv, D, T):
    q, k, v = _inputs(B, Hq, Hkv, D, T, seed=4)
    want = np.asarray(jref.flash_decode_ref(q, k, v))
    _, per = flash_decode.plan_splits(B, Hkv, T, 132)
    got = _split_ref(q, k, v, per * flash_decode.TILE)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    # A last split of one key (T - 1 keys before it) changes nothing.
    if T > 1:
        got1 = _split_ref(q, k, v, T - 1)
        np.testing.assert_allclose(got1.numpy(), want, atol=1e-4)


def test_partials_hold_each_splits_max_and_sum():
    """One split's partial is the whole softmax's: acc / l is the output,
    m the largest scaled logit, l the sum of exp(logit - m)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 8, 2, 64, 50, seed=5))
    parts = tref.flash_decode_partials_ref(q, k, v, 64)
    assert parts.shape == (2, 8, 1, 66) and parts.dtype == torch.float32
    D = 64
    logits = torch.einsum("bhgd,bthd->bhgt", q.reshape(2, 2, 4, D), k) / 8.0
    m = logits.amax(-1).reshape(2, 8)
    torch.testing.assert_close(parts[:, :, 0, D], m)
    torch.testing.assert_close(
        parts[:, :, 0, D + 1],
        torch.exp(logits - logits.amax(-1, keepdim=True)).sum(-1)
        .reshape(2, 8))
    torch.testing.assert_close(parts[:, :, 0, :D] / parts[:, :, 0, D + 1:],
                               tref.flash_decode_ref(q, k, v), rtol=0,
                               atol=1e-6)
    assert torch.equal(tref.flash_decode_combine_ref(parts),
                       tref.flash_decode_combine_ref(parts.clone()))


def _ref_step_attention(q, k, v, pos):
    """The attention of the reference's ``decode_attention_step``: scores
    of all Tmax rows, rows past ``pos`` masked with -1e30, softmax in
    float32 (``repro.models.common``)."""
    import jax
    import jax.numpy as jnp
    from repro.models import common as jcommon

    B, H, D = q.shape
    s = jcommon._gqa_scores(jnp.asarray(q)[:, None], jnp.asarray(k),
                            1.0 / np.sqrt(D)).astype(jnp.float32)
    valid = (jnp.arange(k.shape[1]) <= pos)[None, None, None, None, :]
    w = jax.nn.softmax(jnp.where(valid, s, -1e30), axis=-1)
    return np.asarray(jnp.einsum("bkgts,bskd->btkgd", w, jnp.asarray(v))
                      ).reshape(B, H, D)


@pytest.mark.parametrize("shards", [1, 2, 8, 300])
@pytest.mark.parametrize("rows", [1, 32, 33, 1024, 32768])
def test_shard_width_fits_every_ranks_partials_in_one_combine(shards, rows):
    """Each rank's width: at least one partial, at most one split a tile
    of its slice, and all the ranks' partials within one combine (one a
    rank where there are more ranks than the combine takes)."""
    w = flash_decode.shard_width(shards, rows)
    assert 1 <= w <= -(-rows // flash_decode.TILE)
    assert shards * w <= max(flash_decode.MAX_SPLITS, shards)
    if shards * -(-rows // flash_decode.TILE) <= flash_decode.MAX_SPLITS:
        assert w == -(-rows // flash_decode.TILE)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("pos", [0, 5, 7, 8, 30, 31])
def test_shard_partials_with_empty_shards_then_combine(m, pos):
    """A cache of 32 rows cut into m contiguous shards, as a sequence-
    sharded cache lies on m ranks: each shard's partials over its valid
    rows (a shard past ``pos`` has none and gives the neutral partial),
    laid side by side in shard order and combined, equal the attention
    over rows [0, pos] -- the plain version's and the reference decode
    step's masked softmax -- and neutral partials, as a rank on the card
    pads its splits with, add exact zeros."""
    B, Hq, Hkv, D, T = 2, 8, 2, 64, 32
    q, k, v = _inputs(B, Hq, Hkv, D, T, seed=9)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    Tl = T // m
    parts = []
    for r in range(m):
        n = min(Tl, max(0, pos + 1 - r * Tl))
        p = tops.decode_attention_partials(qt, kt[:, r * Tl:r * Tl + n],
                                           vt[:, r * Tl:r * Tl + n], m, Tl)
        assert p.shape == (B, Hq, 1, D + 2)
        if n == 0:
            assert torch.equal(p, tref.neutral_partials(B, Hq, 1, D, "cpu"))
        parts.append(p)
    got = tops.decode_attention_combine(torch.cat(parts, dim=2))
    assert torch.isfinite(got).all()
    want = tref.flash_decode_ref(qt, kt[:, :pos + 1], vt[:, :pos + 1])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.flash_decode_ref(
            q, k[:, :pos + 1], v[:, :pos + 1])), atol=1e-5)
    np.testing.assert_allclose(got.numpy(),
                               _ref_step_attention(q, k, v, pos), atol=1e-5)
    # Each shard padded with neutral partials gives the same bits, and so
    # do the non-neutral partials alone.
    pad = tref.neutral_partials(B, Hq, 2, D, "cpu")
    padded = torch.cat([torch.cat([p, pad], dim=2) for p in parts], dim=2)
    assert torch.equal(tops.decode_attention_combine(padded), got)
    live = torch.cat([p for p in parts if torch.isfinite(p[:, :, 0, D]).all()],
                     dim=2)
    assert torch.equal(tref.flash_decode_combine_ref(live), got)
    # T = 0 of the plain version, and an all-neutral row is NaN (the
    # combine relies on a shard holding row 0).
    empty = tref.flash_decode_partials_ref(qt, kt[:, :0], vt[:, :0])
    assert torch.equal(empty, tref.neutral_partials(B, Hq, 1, D, "cpu"))
    assert torch.isnan(tref.flash_decode_combine_ref(empty)).all()
