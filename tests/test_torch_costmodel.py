"""The port's cost model against the JAX package's, on the CPU.

Same inputs, made with numpy from a seed, go through both packages.  The
JAX side runs as its own tests run it: the Pallas kernel in interpret mode
(``use_kernel=True``) and the jnp path (``use_kernel=False``).  Tolerance
for per-point costs: rtol 1e-5, atol 1e-2, the bound the reference holds
its own Pallas kernel to (tests/test_kernels.py).
"""
import numpy as np
import pytest
import torch

from repro.core import env as jenv
from repro.costmodel import layers as jlayers
from repro.costmodel import maestro as jmaestro
from repro.costmodel import workloads as jworkloads
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import env as tenv
from repro_torch.costmodel import dataflows as tdfl
from repro_torch.costmodel import layers as tlayers
from repro_torch.costmodel import maestro as tmaestro
from repro_torch.costmodel import workloads as tworkloads
from repro_torch.kernels import costmodel_eval
from repro_torch.kernels import ops as tops

PAPER = ["gnmt", "mnasnet", "mobilenet_v2", "ncf", "resnet50", "transformer"]
RTOL, ATOL = 1e-5, 1e-2


def _arr(name):
    return tlayers.layers_to_array(tworkloads.get_workload(name))


def _rand_layers(rng, n):
    """Random conv / dwconv / gemm rows, as tests/test_kernels.py draws."""
    out = []
    for _ in range(n):
        t = rng.integers(0, 3)
        if t == 2:
            out.append(tlayers.LayerSpec.gemm(*(int(v) for v in
                                                rng.integers(1, 512, 3))))
        elif t == 1:
            out.append(tlayers.LayerSpec.dwconv(
                int(rng.integers(1, 256)), int(rng.integers(7, 64)),
                int(rng.integers(7, 64)), 3, 3))
        else:
            out.append(tlayers.LayerSpec.conv(
                int(rng.integers(1, 256)), int(rng.integers(1, 256)),
                int(rng.integers(7, 64)), int(rng.integers(7, 64)), 3, 3))
    return tlayers.layers_to_array(out)


def _compare(layers, pe, kt, df, use_kernel):
    got = tops.batched_cost(torch.from_numpy(layers), torch.from_numpy(pe),
                            torch.from_numpy(kt), torch.from_numpy(df))
    want = jops.batched_cost(layers, pe, kt, df, use_kernel=use_kernel)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("name", PAPER)
def test_workload_arrays_equal_reference(name):
    ref = jworkloads.get_workload(name)
    got = tworkloads.get_workload(name)
    np.testing.assert_array_equal(tlayers.layers_to_array(got),
                                  jlayers.layers_to_array(ref))
    assert [l.name for l in got] == [l.name for l in ref]
    assert tlayers.total_macs(got) == jlayers.total_macs(ref)


def test_workload_names_are_the_paper_six():
    """The paper's six first, then the ten assigned architectures: the
    reference's ``workload_names``, each name resolving as it does there;
    an unknown name raises."""
    names = tworkloads.workload_names()
    assert names == jworkloads.workload_names()
    assert names[:6] == PAPER
    for name in names[6:]:
        np.testing.assert_array_equal(
            tlayers.layers_to_array(tworkloads.get_workload(name)),
            jlayers.layers_to_array(jworkloads.get_workload(name)))
    with pytest.raises(ValueError, match="unknown architecture"):
        tworkloads.get_workload("no_such_workload")


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("name", PAPER)
def test_batched_cost_level_grid(name, use_kernel):
    """Every paper workload x 3 dataflows x the L=12 level grid."""
    layers = _arr(name)
    N = layers.shape[0]
    pe_g, kt_g = np.meshgrid(tdfl.pe_levels(12), tdfl.kt_levels(12),
                             indexing="ij")
    pe = np.tile(pe_g.reshape(-1, 1), (1, N)).astype(np.float32)
    kt = np.tile(kt_g.reshape(-1, 1), (1, N)).astype(np.float32)
    for df in range(3):
        _compare(layers, pe, kt, np.full_like(pe, df), use_kernel)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("B,N", [(1, 1), (3, 7), (13, 53)])
def test_batched_cost_random_raw_points(B, N, use_kernel):
    """Random raw points: PE in 1..160, KT in 1..16, df in 0..2."""
    rng = np.random.default_rng(B * 100 + N)
    layers = _rand_layers(rng, N)
    pe = rng.integers(1, 161, (B, N)).astype(np.float32)
    kt = rng.integers(1, 17, (B, N)).astype(np.float32)
    df = rng.integers(0, 3, (B, N)).astype(np.float32)
    _compare(layers, pe, kt, df, use_kernel)


@pytest.mark.parametrize("scenario", ["LP", "LS"])
@pytest.mark.parametrize("name", ["mobilenet_v2", "ncf", "transformer"])
def test_model_cost(name, scenario):
    layers = _arr(name)
    N = layers.shape[0]
    rng = np.random.default_rng(7)
    pe = rng.integers(1, 161, (4, N)).astype(np.float32)
    kt = rng.integers(1, 17, (4, N)).astype(np.float32)
    for df in range(3):
        got = tmaestro.model_cost(torch.from_numpy(layers),
                                  torch.from_numpy(pe), torch.from_numpy(kt),
                                  df, scenario)
        want = jmaestro.model_cost(layers, pe, kt, df, scenario)
        for field in ("latency", "energy", "area", "power", "l1_bytes",
                      "l2_bytes", "macs", "util"):
            np.testing.assert_allclose(
                getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                rtol=RTOL, err_msg=field)


@pytest.mark.parametrize("platform", ["unlimited", "cloud", "iot", "iotx"])
@pytest.mark.parametrize("name", PAPER)
def test_make_env_budget(name, platform):
    """The Table II budget agrees within rtol 1e-6: both are an f32 sum over
    the layers, taken in another order, so an ulp may differ."""
    wl = tworkloads.get_workload(name)
    for constraint, scenario in (("area", "LP"), ("power", "LS")):
        kw = dict(platform=platform, constraint=constraint,
                  scenario=scenario)
        got = tenv.make_env(wl, tenv.EnvConfig(**kw), device="cpu")
        want = jenv.make_env(jworkloads.get_workload(name),
                             jenv.EnvConfig(**kw))
        np.testing.assert_allclose(float(got.budget), float(want.budget),
                                   rtol=1e-6)
        np.testing.assert_array_equal(got.static_obs.numpy(),
                                      np.asarray(want.static_obs))
        np.testing.assert_array_equal(got.layers.numpy(),
                                      np.asarray(want.layers))


def test_genome_cost_and_feasibility_match_reference():
    name = "mobilenet_v2"
    ecfg = dict(platform="iot")
    env_t = tenv.make_env(tworkloads.get_workload(name),
                          tenv.EnvConfig(**ecfg), device="cpu")
    env_j = jenv.make_env(jworkloads.get_workload(name),
                          jenv.EnvConfig(**ecfg))
    rng = np.random.default_rng(3)
    pe = rng.integers(1, 40, (6, env_t.num_layers)).astype(np.float32)
    kt = rng.integers(1, 8, (6, env_t.num_layers)).astype(np.float32)
    got = tenv.genome_cost(env_t, tenv.EnvConfig(**ecfg),
                           torch.from_numpy(pe), torch.from_numpy(kt), 0)
    want = jenv.genome_cost(env_j, jenv.EnvConfig(**ecfg), pe, kt, 0)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=RTOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(
        tenv.feasibility_mask(env_t, tenv.EnvConfig(**ecfg),
                              torch.from_numpy(pe), torch.from_numpy(kt),
                              0).numpy(),
        np.asarray(want[2]))


def test_content_hash_is_the_ports_own():
    h = tmaestro.content_hash()
    assert len(h) == 16 and int(h, 16) >= 0
    assert h != jmaestro.content_hash()


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tenv.make_env(tworkloads.get_workload("ncf"), tenv.EnvConfig())


@pytest.mark.parametrize("other", ["layers", "kt", "df"])
def test_batched_cost_rejects_tensors_on_two_devices(other):
    """The wrapper takes one device from its tensors and never moves one of
    them to another: a tensor elsewhere raises.  ("meta" stands in for a
    second device here.)"""
    args = dict(layers=torch.from_numpy(_arr("ncf")),
                pe=torch.ones(2, 5), kt=torch.ones(2, 5),
                df=torch.zeros(2, 5))
    args[other] = args[other].to("meta")
    with pytest.raises(ValueError, match="more than one device"):
        tops.batched_cost(**args)


def test_table_cost_on_env_table_and_row_view_matches_batched_cost():
    """The searches' two ways into the kernel: the environment's stored
    (NUM_FIELDS, N) table, and one layer's row as a (NUM_FIELDS, 1) view."""
    env = tenv.make_env(tworkloads.get_workload("mobilenet_v2"),
                        tenv.EnvConfig(), device="cpu")
    torch.testing.assert_close(env.layers_t, env.layers.T, rtol=0, atol=0)
    assert env.layers_t.is_contiguous()
    rng = np.random.default_rng(11)
    N = env.num_layers
    pe = torch.from_numpy(rng.integers(1, 161, (5, N)).astype(np.float32))
    kt = torch.from_numpy(rng.integers(1, 17, (5, N)).astype(np.float32))
    want = tops.batched_cost(env.layers, pe, kt, 1.0)
    got = tops.table_cost(env.layers_t, pe, kt, 1.0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    t = 17
    row = env.layers[t][:, None]
    assert row.is_contiguous() and row.shape == (tlayers.NUM_FIELDS, 1)
    got = tops.table_cost(row, pe[:, t:t + 1].contiguous(),
                          kt[:, t:t + 1].contiguous(), 1.0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w[:, t:t + 1], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The per-row cost model (the search service's fused dispatch).
# ---------------------------------------------------------------------------
def _ragged_paper_rows(rng, draws=2):
    """The six paper workloads as ragged rows padded with repeat = 0 rows,
    with random level points; also the mask of real positions."""
    import dataclasses

    packs = [_arr(n) for n in PAPER]
    N = max(len(p) for p in packs)
    pad = dataclasses.replace(tlayers.LayerSpec.gemm(1, 1, 1),
                              repeat=0).as_row()
    rows = np.stack([np.concatenate([p, np.tile(pad, (N - len(p), 1))])
                     for p in packs]).astype(np.float32)
    rows = np.tile(rows, (draws, 1, 1))
    real = np.tile(np.arange(N)[None] < np.array([len(p) for p in packs])[
        :, None], (draws, 1))
    B = rows.shape[0]
    pe = tdfl.pe_levels(12)[rng.integers(0, 12, (B, N))].astype(np.float32)
    kt = tdfl.kt_levels(12)[rng.integers(0, 12, (B, N))].astype(np.float32)
    df = rng.integers(0, 3, (B, N)).astype(np.float32)
    return rows, pe, kt, df, real


def _multi_inputs(B, N, seed):
    rng = np.random.default_rng(seed)
    layers = _rand_layers(rng, B * N).reshape(B, N, -1)
    pe = rng.integers(1, 161, (B, N)).astype(np.float32)
    kt = rng.integers(1, 17, (B, N)).astype(np.float32)
    df = rng.integers(0, 3, (B, N)).astype(np.float32)
    return layers, pe, kt, df


def _compare_multi(layers, pe, kt, df, use_kernel, forms=None):
    """The port on ``forms`` (default: the numpy inputs as tensors)
    against the JAX package on the (B, N) numpy inputs."""
    got = tops.batched_cost_multi(*(forms or (torch.from_numpy(a)
                                              for a in (layers, pe, kt, df))))
    want = jops.batched_cost_multi(layers, pe, kt, df, use_kernel=use_kernel)
    for g, w in zip(got, want):
        assert g.shape == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    return got


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("B,N", [(1, 1), (3, 7), (9, 130), (16, 128)])
def test_batched_cost_multi_random_rows_match_reference(B, N, use_kernel):
    """Each point with its own random layer row, against the JAX package's
    per-row Pallas kernel (interpret mode) and its jnp path."""
    _compare_multi(*_multi_inputs(B, N, B * 1000 + N), use_kernel)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_batched_cost_multi_ragged_paper_rows_match_reference(use_kernel):
    rows, pe, kt, df, real = _ragged_paper_rows(np.random.default_rng(4))
    got = _compare_multi(rows, pe, kt, df, use_kernel)
    for g in got:                       # repeat = 0 padding is exactly 0
        assert np.all(g.numpy()[~real] == 0.0)


def test_batched_cost_multi_one_workload_equals_batched_cost_bitwise():
    """Rows that all carry one workload give the single-table path's bits:
    what the service's byte identity with serial runs rests on."""
    layers = _arr("mobilenet_v2")
    rng = np.random.default_rng(8)
    B, N = 12, layers.shape[0]
    pe, kt, df = (torch.from_numpy(rng.integers(lo, hi, (B, N)).astype(
        np.float32)) for lo, hi in ((1, 161), (1, 17), (0, 3)))
    want = tops.batched_cost(torch.from_numpy(layers), pe, kt, df)
    got = tops.batched_cost_multi(
        torch.from_numpy(layers).expand(B, N, layers.shape[1]), pe, kt, df)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # A flat (1, B*N) call -- the batcher's shape -- gives the same bits.
    flat = tops.batched_cost_multi(
        torch.from_numpy(np.tile(layers, (B, 1)))[None], pe.reshape(1, -1),
        kt.reshape(1, -1), df.reshape(1, -1))
    for g, w in zip(flat, want):
        assert torch.equal(g.reshape(B, N), w)


def test_batched_cost_multi_rejects_bad_shapes_and_two_devices():
    layers, pe, kt, df = (torch.from_numpy(a) for a in _multi_inputs(2, 3, 0))
    with pytest.raises(ValueError, match="expected"):
        tops.batched_cost_multi(layers[..., :7], pe, kt, df)
    with pytest.raises(ValueError, match="more than one device"):
        tops.batched_cost_multi(layers, pe, kt.to("meta"), df)


def _multi_views(case, seed, B=4, N=9):
    """Dense (B, N, 8) layers and (B, N) pe / kt / df as numpy, and the
    same values as ``ops.batched_cost_multi`` takes them in place:
    ``row_block`` views of one packed (B * N, 11) block (the service's
    upload: stride 11) as a flat list, ``views_3d`` (B, N) views of a
    (B, N, 11) block, ``broadcast`` one (N, 8) table, a (B, 1) pe column,
    a (1, N) kt row and an expanded df, ``number_df`` a Python-number df
    and a 0-d kt."""
    rng = np.random.default_rng(seed)
    layers, pe, kt, df = _multi_inputs(B, N, seed)
    if case == "broadcast":
        table = _rand_layers(rng, N)
        layers = np.ascontiguousarray(np.broadcast_to(table, (B, N, 8)))
        pe = np.repeat(pe[:, :1], N, axis=1)
        kt = np.repeat(kt[:1], B, axis=0)
        df = np.full((B, N), df[0, 0], np.float32)
        forms = (torch.from_numpy(table), torch.from_numpy(pe[:, :1]),
                 torch.from_numpy(kt[:1]),
                 torch.from_numpy(df[:1, :1]).expand(B, N))
    elif case == "number_df":
        kt = np.full((B, N), kt[0, 0], np.float32)
        df = np.full((B, N), 1.0, np.float32)
        forms = (torch.from_numpy(layers), torch.from_numpy(pe),
                 torch.tensor(kt[0, 0]), 1.0)
    else:
        block = torch.from_numpy(np.concatenate(
            [layers, pe[..., None], kt[..., None], df[..., None]], -1))
        if case == "row_block":
            block = block.reshape(B * N, 11)
        forms = (block[..., :8], block[..., 8], block[..., 9],
                 block[..., 10])
    return (layers, pe, kt, df), forms


MULTI_VIEWS = ["row_block", "views_3d", "broadcast", "number_df"]


@pytest.mark.parametrize("case", MULTI_VIEWS)
def test_batched_cost_multi_views_equal_contiguous_bitwise(case):
    """ops.batched_cost_multi on strided, broadcast and by-value inputs
    gives the bits of the same values as contiguous (B, N) arrays, in
    both output layouts: each point's (4,) row interleaved equals its
    four planes."""
    dense, forms = _multi_views(case, MULTI_VIEWS.index(case))
    B, N = dense[1].shape
    want = tops.batched_cost_multi(*(torch.from_numpy(a) for a in dense))
    got = tops.batched_cost_multi(*forms)
    rows = tops.batched_cost_multi(*forms, interleaved=True)
    assert rows.shape == got[0].shape + (4,)
    for f, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g.reshape(B, N), w)
        assert torch.equal(rows[..., f].reshape(B, N), w)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("case", MULTI_VIEWS)
def test_batched_cost_multi_views_match_reference(case, use_kernel):
    """The same views against the JAX package's per-row Pallas kernel
    (interpret mode) and its jnp path on the dense numpy inputs."""
    dense, forms = _multi_views(case, 10 + MULTI_VIEWS.index(case))
    B, N = dense[1].shape
    if case == "row_block":    # a flat list: compare as (B, N)
        forms = [v.reshape(B, N, *v.shape[1:]) for v in forms]
    _compare_multi(*dense, use_kernel, forms=forms)


def _flat_source(case, B=4, N=9):
    """The inputs of ``ops.batched_cost_multi`` in one form, and for each
    of layers, pe, kt, df the tensor whose storage a view would share
    (None where the form needs a copy)."""
    block = torch.arange(B * N * 11, dtype=torch.float32).reshape(B, N, 11)
    if case == "row_block":
        block = block.reshape(B * N, 11)
        cols = (block[:, :8], block[:, 8], block[:, 9], block[:, 10])
        return cols, (block,) * 4
    if case == "views_3d":
        cols = (block[..., :8], block[..., 8], block[..., 9], block[..., 10])
        return cols, (block,) * 4
    if case == "contiguous":
        args = (block[..., :8].contiguous(),
                *(block[..., i].contiguous() for i in (8, 9, 10)))
        return args, args
    if case == "number":
        layers, pe = block[..., :8].contiguous(), block[..., 8].contiguous()
        kt = torch.tensor(3.0)
        return (layers, pe, kt, 1.0), (layers, pe, kt, None)
    table, col = block[0, :, :8], block[:, :1, 8]         # "broadcast"
    return (table, col, block[0, :, 9], block[..., 10]), (None, None, None,
                                                          block)


FLAT_CASES = ["row_block", "views_3d", "contiguous", "number", "broadcast"]


@pytest.mark.parametrize("case", FLAT_CASES)
def test_batched_cost_multi_hands_the_kernel_views(case, monkeypatch):
    """ops.batched_cost_multi flattens each input to the per-row kernel's
    (M, 8) and (M,) arguments without a copy wherever a stride can
    express it (the service's (M, 11) row block, (B, N) views of one
    block, contiguous arrays, one value at stride 0), fields side by
    side, and copies only a broadcast that no stride expresses."""
    args, sources = _flat_source(case)
    seen = []

    def plain(*flat):
        seen.extend(flat)
        return tuple(torch.zeros(flat[1].shape) for _ in range(4))

    monkeypatch.setattr(tops.ref, "cost_eval_multi_ref", plain)
    out = tops.batched_cost_multi(*args)
    assert len(seen) == 4 and seen[0].shape == (36, 8)
    assert seen[0].stride(1) == 1
    assert all(v.shape == (36,) for v in seen[1:])
    for flat, src in zip(seen, sources):
        if src is None:
            continue
        base = src.untyped_storage().data_ptr()
        assert flat.untyped_storage().data_ptr() == base
    assert all(o.shape == out[0].shape for o in out)


# ---------------------------------------------------------------------------
# The table kernel's operands: broadcast, strided and scalar forms.
# ---------------------------------------------------------------------------
def _operand_forms(case, rng, B, N):
    """(pe, kt, df) in one operand form and the same values as contiguous
    (B, N) numpy arrays."""
    col = lambda lo, hi: rng.integers(lo, hi, (B, 1)).astype(np.float32)
    row = lambda lo, hi: rng.integers(lo, hi, (N,)).astype(np.float32)
    full = lambda lo, hi: rng.integers(lo, hi, (B, N)).astype(np.float32)
    dense = lambda a: np.ascontiguousarray(np.broadcast_to(a, (B, N)))
    if case == "rollout":          # (E, 1) columns, a Python dataflow
        pe, kt = col(1, 161), col(1, 17)
        return ((torch.from_numpy(pe), torch.from_numpy(kt), 2.0),
                (dense(pe), dense(kt), np.full((B, N), 2.0, np.float32)))
    if case == "local_ga":         # (P, N) genomes, an (N,) dataflow row
        pe, kt, df = full(1, 161), full(1, 17), row(0, 3)
        return ((torch.from_numpy(pe), torch.from_numpy(kt),
                 torch.from_numpy(df)), (pe, kt, dense(df)))
    if case == "scalars":          # a (1, 1) tensor, a 0-d tensor
        pe = np.full((1, 1), rng.integers(1, 161), np.float32)
        kt = np.float32(rng.integers(1, 17))
        df = full(0, 3)
        return ((torch.from_numpy(pe), torch.tensor(kt),
                 torch.from_numpy(df)),
                (dense(pe), np.full((B, N), kt, np.float32), df))
    if case == "strided":          # every other column of wider arrays,
        pe, kt = full(1, 161), full(1, 17)      # and a transposed array
        wide = np.repeat(pe, 2, axis=1)
        df = rng.integers(0, 3, (N, B)).astype(np.float32)
        return ((torch.from_numpy(wide)[:, ::2],
                 torch.from_numpy(np.ascontiguousarray(kt.T)).T,
                 torch.from_numpy(df).T), (pe, kt, np.ascontiguousarray(
                     df.T)))
    if case == "expanded":         # stride-0 views of a level grid
        pe, kt = col(1, 161), row(1, 17)
        return ((torch.from_numpy(pe).expand(B, N),
                 torch.from_numpy(kt).expand(B, N), 0),
                (dense(pe), dense(kt), np.zeros((B, N), np.float32)))
    raise ValueError(case)


@pytest.mark.parametrize("case", ["rollout", "local_ga", "scalars",
                                  "strided", "expanded"])
def test_table_cost_operand_forms_give_contiguous_bits(case):
    """ops.table_cost with broadcast, strided and scalar pe / kt / df gives
    the bits of the same values as contiguous (B, N) arrays, and agrees
    with the reference's cost_eval_ref on the same numpy inputs."""
    rng = np.random.default_rng(["rollout", "local_ga", "scalars", "strided",
                                 "expanded"].index(case))
    B, N = 6, 9
    layers_t = np.ascontiguousarray(_rand_layers(rng, N).T)
    forms, dense = _operand_forms(case, rng, B, N)
    got = tops.table_cost(torch.from_numpy(layers_t), *forms)
    want = tops.table_cost(torch.from_numpy(layers_t),
                           *(torch.from_numpy(a) for a in dense))
    jwant = jref.cost_eval_ref(layers_t, *dense)
    for g, w, j in zip(got, want, jwant):
        assert g.shape == (B, N)
        assert torch.equal(g, w)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("shape,stride,want", [
    ((4, 9), (9, 1), (9, 1)),          # contiguous (B, N)
    ((4, 1), (1, 1), (1, 0)),          # an (E, 1) column broadcasts along N
    ((1, 9), (9, 1), (0, 1)),          # one row broadcasts along B
    ((9,), (1,), (0, 1)),              # an (N,) row
    ((), (), (0, 0)),                  # one value
    ((4, 9), (0, 0), (0, 0)),          # an expanded value
    ((4, 9), (1, 4), (1, 4)),          # a transposed array
])
def test_broadcast_strides(shape, stride, want):
    assert costmodel_eval.broadcast_strides(shape, stride, 4, 9, "pe") == want


@pytest.mark.parametrize("shape,stride,match", [
    ((4, 9), (-9, 1), "negative stride"),
    ((9,), (-1,), "negative stride"),
    ((3, 9), (9, 1), "does not broadcast"),
    ((4, 8), (8, 1), "does not broadcast"),
    ((1, 4, 9), (36, 9, 1), "dimensions"),
])
def test_broadcast_strides_refuses(shape, stride, match):
    with pytest.raises(ValueError, match=match):
        costmodel_eval.broadcast_strides(shape, stride, 4, 9, "pe")
