"""The port's Mamba2 decode step against the JAX package, on the CPU.

The same weights (the reference's ``init_mamba``) and the same numpy
inputs (from a seed) go through ``repro.models.ssm.mamba_step`` and
``repro_torch.models.ssm.mamba_step`` for 12 steps.  Tolerance in float32:
atol and rtol 1e-5 on the output and on both cache leaves (only the order
of float32 sums differs).  In bfloat16 the projections round in each
package's own matrix product, so outputs may differ by a bfloat16 ulp
(2**-8 relative; 0.0039 at outputs up to 0.57 here); that case holds them
to atol / rtol 1e-2, the float32 cache leaves still to 1e-5, and checks
that the cache stays float32, as the reference keeps it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch import configs
from repro_torch.models import lm, ssm

STEPS = 12


def _cfg(arch, dtype):
    return dataclasses.replace(configs.get_smoke(arch), param_dtype=dtype,
                               compute_dtype=dtype)


def _mamba(cfg):
    tree = jax.tree.map(np.asarray, jssm.init_mamba(jax.random.PRNGKey(3),
                                                    cfg))
    p = ssm.Mamba(cfg)
    with torch.no_grad():
        for name, t in p.named_parameters():
            t.copy_(torch.from_numpy(np.array(tree[name])))
    return tree, p


_jstep = jax.jit(jssm.mamba_step, static_argnums=(1,))


@pytest.mark.parametrize("arch,dtype,tol", [
    ("mamba2_130m", "float32", 1e-5),
    ("zamba2_1p2b", "float32", 1e-5),
    ("mamba2_130m", "bfloat16", 1e-2),
])
def test_mamba_step_matches_reference(arch, dtype, tol):
    cfg = _cfg(arch, dtype)
    tree, p = _mamba(cfg)
    B = 3
    xs = np.random.default_rng(4).standard_normal(
        (STEPS, B, 1, cfg.d_model)).astype(np.float32)
    jcache = jssm.init_mamba_cache(cfg, B)
    cache = ssm.init_mamba_cache(cfg, B)
    dt = getattr(torch, dtype)
    for t in range(STEPS):
        jout, jcache = _jstep(tree, cfg, jnp.asarray(xs[t], dtype), jcache)
        out, cache = ssm.mamba_step(p, cfg, torch.from_numpy(xs[t]).to(dt),
                                    cache)
        assert out.dtype == dt and cache.ssm.dtype == torch.float32
        assert cache.conv.dtype == torch.float32
        assert jcache.ssm.dtype == jcache.conv.dtype == jnp.float32
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(jout, np.float32), atol=tol,
                                   rtol=tol, err_msg=f"output at step {t}")
    for got, want in ((cache.conv, jcache.conv), (cache.ssm, jcache.ssm)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("arch", ["mamba2_130m", "zamba2_1p2b"])
def test_init_fixes_the_references_mamba_leaves(arch):
    """The leaves the reference's init fixes are the reference's values
    (A_log to within 2 float32 ulps: the two packages' linspace and log
    round differently); conv_w is normal(0, 0.5), the matrices
    normal(0, 0.02)."""
    cfg = configs.get_smoke(arch)
    # The fixed leaves do not depend on the key, so one layer of the
    # reference's init gives every layer's.
    tree = jax.tree.map(np.asarray, jssm.init_mamba(jax.random.PRNGKey(0),
                                                    cfg))
    model = lm.init_params(cfg, torch.Generator().manual_seed(0))
    for name, t in model.named_parameters():
        if ".mamba." not in name:
            continue
        leaf = name.rsplit(".", 1)[1]
        want = tree[leaf]
        got = t.float().numpy()
        if leaf == "A_log":
            np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)
        elif leaf in ("D", "dt_bias", "gate_norm", "conv_b"):
            np.testing.assert_array_equal(got, want)
        else:
            scale = 0.5 if leaf == "conv_w" else 0.02
            assert abs(got.std() / scale - 1) < 0.25, name
    assert sum(n.endswith(".A_log") for n, _ in model.named_parameters()
               ) == cfg.num_layers
