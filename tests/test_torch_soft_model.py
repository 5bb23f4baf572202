"""The port's soft cost model against the JAX package's, on the CPU.

The same inputs, made with numpy from a seed, go through the soft
primitives, ``soft_evaluate`` and ``soft_model_cost`` (LP and LS) of both
packages, over ``tests/test_relaxed.py``'s conv / depthwise / GEMM layers,
its dataflows and tau in {1, 0.3, 0.05}.

Tolerances (float32; the two packages order a few operations differently):
  * values: rtol 1e-5;
  * gradients (``torch.autograd`` against ``jax.grad``): rtol 1e-4, plus
    atol 1e-6 x the largest |gradient| of the same array, for elements that
    cancel to near zero;
  * the hard path: exact -- the soft split must leave ``HARD`` bit-equal to
    the reference's golden values and to its ``evaluate``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.costmodel import layers as jlayers
from repro.costmodel import maestro as jmaestro
from repro.costmodel import primitives as jprims
from repro.costmodel import workloads as jworkloads
from repro.costmodel.layers import LayerSpec
from repro_torch.costmodel import maestro as tmaestro
from repro_torch.costmodel import primitives as tprims

CONV = LayerSpec.conv(32, 64, 28, 28, 3, 3).as_row()
DW = LayerSpec.dwconv(192, 28, 28, 3, 3).as_row()
GEMM = LayerSpec.gemm(128, 256, 512).as_row()
LAYERS = {"conv": CONV, "dwconv": DW, "gemm": GEMM}
TAUS = (1.0, 0.3, 0.05)
FIELDS = ("latency", "energy", "area", "power", "l1_bytes", "l2_bytes",
          "macs", "util")
RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_FRAC = 1e-4, 1e-6


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close_grad(got, want, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=GRAD_RTOL,
        atol=GRAD_ATOL_FRAC * float(np.max(np.abs(want))), err_msg=msg)


def _points(seed, shape):
    rng = np.random.default_rng(seed)
    pe = rng.uniform(0.5, 170.0, shape).astype(np.float32)
    kt = rng.uniform(0.5, 17.0, shape).astype(np.float32)
    # Integer points too: the staircase is exact there.
    pe[..., :3] = np.round(pe[..., :3])
    kt[..., :3] = np.round(kt[..., :3])
    return pe, kt


PRIMS = {
    "soft_ceil": (lambda m, x, tau: m.soft_ceil(x, tau), 1),
    "soft_floor": (lambda m, x, tau: m.soft_floor(x, tau), 1),
    "smooth_max": (lambda m, x, y, tau: m.smooth_max(x, y, 0.1 * tau), 2),
    "smooth_min": (lambda m, x, y, tau: m.smooth_min(x, y, 0.1 * tau), 2),
    "smooth_clip": (lambda m, x, y, tau: m.smooth_clip(
        x, 2.0, y + 3.0, 0.25 * tau), 2),
    "smooth_amax": (lambda m, x, y, tau: m.smooth_amax(
        x * x + y, 12.0 / tau), 2),
}


@pytest.mark.parametrize("tau", TAUS)
@pytest.mark.parametrize("name", sorted(PRIMS))
def test_soft_primitive_values_and_gradients(name, tau):
    fn, nargs = PRIMS[name]
    rng = np.random.default_rng(len(name))
    args = [rng.uniform(-4.0, 9.0, (6, 5)).astype(np.float32)
            for _ in range(nargs)]
    args[0][0] = np.round(args[0][0])          # integer inputs
    if name == "smooth_amax":
        args = [np.abs(a) + 0.5 for a in args]

    def jf(*xs):
        return fn(jprims, *xs, tau)

    leaves = [_t(a).requires_grad_() for a in args]
    got = fn(tprims, *leaves, tau)
    want = jf(*args)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=1e-6)
    got.sum().backward()
    grads = jax.grad(lambda *xs: jnp.sum(jf(*xs)),
                     argnums=tuple(range(nargs)))(*args)
    for i, (leaf, g) in enumerate(zip(leaves, grads)):
        _close_grad(leaf.grad.numpy(), g, f"arg {i}")


def test_softplus_is_logaddexp_beyond_torchs_threshold():
    """torch.nn.functional.softplus switches to the identity above 20; the
    port's softplus is the reference's logaddexp(x, 0) everywhere."""
    x = np.array([-30.0, -1.0, 0.0, 0.5, 19.0, 20.5, 25.0, 60.0], np.float32)
    np.testing.assert_array_equal(tprims.softplus(_t(x)).numpy(),
                                  np.asarray(jax.nn.softplus(x)))


def _soft_sum(maestro_mod, layer, pe, kt, w, tau):
    out = maestro_mod.soft_evaluate(layer, pe, kt, w, tau)
    return out.latency + out.energy + out.area + out.power


@pytest.mark.parametrize("tau", TAUS)
@pytest.mark.parametrize("df", [0, 1, 2])
@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_soft_evaluate_values_and_gradients(layer, df, tau):
    row = LAYERS[layer]
    pe, kt = _points(df, (12,))
    w = np.eye(3, dtype=np.float32)[np.full((12,), df)]
    w[6:] = np.random.default_rng(df).dirichlet([1, 1, 1], 6)  # a simplex
    want = jmaestro.soft_evaluate(row, pe, kt, w, tau)
    tl = _t(row)
    tpe, tkt, tw = (_t(a).requires_grad_() for a in (pe, kt, w))
    got = tmaestro.soft_evaluate(tl, tpe, tkt, tw, tau)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).detach().numpy(),
                                   np.asarray(getattr(want, f)), rtol=RTOL,
                                   err_msg=f)
    (got.latency + got.energy + got.area + got.power).sum().backward()
    jg = jax.grad(lambda *a: jnp.sum(_soft_sum(jmaestro, row, *a, tau)),
                  argnums=(0, 1, 2))(pe, kt, w)
    for name, leaf, g in zip(("pe", "kt", "w"), (tpe, tkt, tw), jg):
        _close_grad(leaf.grad.numpy(), g, name)


@pytest.mark.parametrize("tau", TAUS)
@pytest.mark.parametrize("scenario", ["LP", "LS"])
@pytest.mark.parametrize("name,n_layers", [("ncf", None),
                                           ("mobilenet_v2", 6)])
def test_soft_model_cost_values_and_gradients(name, n_layers, scenario, tau):
    arr = jlayers.layers_to_array(
        jworkloads.get_workload(name)[:n_layers]).astype(np.float32)
    N = arr.shape[0]
    pe, kt = _points(7, (4, N))
    w = np.random.default_rng(8).dirichlet([1, 1, 1], (4, N)).astype(
        np.float32)

    def jobj(pe, kt, w):
        mc = jmaestro.soft_model_cost(arr, pe, kt, w, tau, scenario)
        return jnp.sum(jnp.log(mc.latency) + jnp.log(mc.energy)
                       + mc.area * 1e-6 + mc.power * 1e-3)

    want = jmaestro.soft_model_cost(arr, pe, kt, w, tau, scenario)
    tpe, tkt, tw = (_t(a).requires_grad_() for a in (pe, kt, w))
    got = tmaestro.soft_model_cost(_t(arr), tpe, tkt, tw, tau, scenario)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).detach().numpy(),
                                   np.asarray(getattr(want, f)), rtol=RTOL,
                                   err_msg=f)
    obj = torch.sum(torch.log(got.latency) + torch.log(got.energy)
                    + got.area * 1e-6 + got.power * 1e-3)
    obj.backward()
    jg = jax.grad(jobj, argnums=(0, 1, 2))(pe, kt, w)
    for nm, leaf, g in zip(("pe", "kt", "w"), (tpe, tkt, tw), jg):
        _close_grad(leaf.grad.numpy(), g, nm)


def test_soft_model_cost_tau_may_be_a_tensor():
    """The relaxed engine passes tau as a 0-d tensor: the same bits as a
    number."""
    arr = jlayers.layers_to_array(jworkloads.get_workload("ncf"))
    pe, kt = _points(3, (2, arr.shape[0]))
    w = np.full((2, arr.shape[0], 3), 1.0 / 3.0, np.float32)
    for scenario in ("LP", "LS"):
        a = tmaestro.soft_model_cost(_t(arr), _t(pe), _t(kt), _t(w), 0.3,
                                     scenario)
        b = tmaestro.soft_model_cost(_t(arr), _t(pe), _t(kt), _t(w),
                                     torch.tensor(0.3), scenario)
        for f in FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_hard_path_still_bit_equal_to_the_reference():
    """The golden values the reference recorded before its own hard/soft
    split, and its evaluate on random points of every dataflow: exact."""
    import test_relaxed as ref_tests

    for layer, golden in ((CONV, ref_tests.GOLDEN_CONV),
                          (DW, ref_tests.GOLDEN_DW)):
        for (pe, kt, df), want in golden.items():
            out = tmaestro.evaluate(_t(layer), pe, kt, df)
            got = tuple(np.float32(getattr(out, f))
                        for f in ("latency", "energy", "area", "power"))
            assert got == tuple(np.float32(v) for v in want), (pe, kt, df)
    rng = np.random.default_rng(0)
    arr = jlayers.layers_to_array(jworkloads.get_workload("mobilenet_v2"))
    N = arr.shape[0]
    pe = rng.integers(1, 161, (8, N)).astype(np.float32)
    kt = rng.integers(1, 17, (8, N)).astype(np.float32)
    df = rng.integers(0, 3, (8, N)).astype(np.float32)
    want = jmaestro.evaluate(arr[None], pe, kt, df)
    got = tmaestro.evaluate(_t(arr)[None], _t(pe), _t(kt), _t(df))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
