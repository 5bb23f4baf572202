"""Episode-parallel REINFORCE (``dist_reinforce``) of the port against the
JAX package.

The reference runs its mesh as forced host devices, which only a fresh
process can have, so one JAX subprocess a module (a module-scoped fixture,
``XLA_FLAGS=--xla_force_host_platform_device_count=8``) dumps an ``.npz``:

  * the reference reductions' outputs (``masked_psum``, and
    ``masked_hierarchical_psum`` without and with the int8 pod hop) on the
    four meshes of ``tests/test_distributed.py``'s
    ``test_masked_int8_pod_reduction_matches_plain_masked_psum``, and
    ``psum_int8`` across 8 pods;
  * for three mesh cases (``EPOCH_CASES``), two epochs of
    ``make_distributed_epoch`` from ``init_search``: each epoch's state
    before and after, its metrics, the actions every device sampled (with
    the reference's keys: ``fold_in`` of every axis index, then ``split``,
    then ``split(., E)``), the reduced gradient and the int8 hop's scale,
    taken from a ``shard_map`` that mirrors the epoch's shard up to the
    reduction.

Every result leaves the subprocess as ``np.asarray`` of the whole array:
this JAX version refuses to index a sharded result.  The port's epoch
replays the reference's actions (``actions=``).

Tolerances (float32, different summation orders):
  * reductions: rtol 1e-6; the int8 path within one quantum (the scale)
    per element, a different summation order inside a pod can move a
    value across a rounding boundary;
  * gradients rtol 1e-4 / atol 1e-5 (as ``test_torch_reinforce.py``);
    with the int8 hop also within one quantum over the live count, and the
    elements a quantum apart are reported and excluded from the params
    and moments, on which a quantum acts through Adam's normalisation;
  * params atol 1e-5, first moments rtol 1e-4 / atol 1e-6, pmin rtol 1e-6,
    best value rtol 1e-5 with its levels exact, feasible_frac rtol 1e-5.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import env as tenv
from repro_torch.core import policy as tpolicy
from repro_torch.core import reinforce as treinforce
from repro_torch.costmodel import workloads as tworkloads
from repro_torch.distributed import collectives, dist_search
from repro_torch.serving import SearchService, ServiceConfig
from repro_torch.training import optim as toptim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E = 2
PLATFORM = "cloud"
# name -> (mesh shape, axes, dead devices)
REDUCTION_CASES = {
    "pod1x4": ((1, 4), ("pod", "data"), ()),
    "pod4x2": ((4, 2), ("pod", "data"), ()),
    "pod4x2_dead123": ((4, 2), ("pod", "data"), (1, 2, 3)),
    "pod8_dead5": ((8,), ("pod",), (5,)),
}
# name -> (mesh shape, axes, dead devices, compress_pod_axis, seed)
EPOCH_CASES = {
    "data4": ((4,), ("data",), (), False, 1),
    "pod2x2_dead1": ((2, 2), ("pod", "data"), (1,), False, 2),
    "pod2x2_dead1_int8": ((2, 2), ("pod", "data"), (1,), True, 2),
}

REF_SCRIPT = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core import env as jenv, policy as jpolicy, reinforce as jr
from repro.costmodel import workloads as jw
from repro.distributed import dist_search as jd
from repro.training import optim as joptim

cfg = json.loads(sys.argv[1])
E, out = cfg["E"], {}

def mask_of(n, dead):
    m = np.ones(n, bool)
    m[list(dead)] = False
    return m

# One program a mesh: the cases that share a mesh run in one shard_map.
by_mesh = {}
for name, (shape, axes, dead) in cfg["reductions"].items():
    by_mesh.setdefault((tuple(shape), tuple(axes)), []).append((name, dead))
by_mesh.setdefault(((8,), ("pod",)), []).append(("int8pods", None))
for (shape, axes), cases in by_mesh.items():
    n = int(np.prod(shape))
    mesh = jax.make_mesh(shape, axes)
    xs, alives = [], []
    for name, dead in cases:
        if dead is None:      # psum_int8 across 8 pods of unequal scales
            xs.append(jax.random.normal(jax.random.PRNGKey(1), (n, 64))
                      * jnp.asarray(10.0 ** np.linspace(-2, 1, n),
                                    jnp.float32)[:, None])
            alives.append(jnp.ones(n, bool))
        else:
            xs.append(jax.random.normal(jax.random.PRNGKey(0), (n, 64)))
            alives.append(jnp.asarray(mask_of(n, dead)))

    def f(xs, als):
        res = []
        for (name, dead), x, al in zip(cases, xs, als):
            g, a = {"g": x[0]}, al[0]
            if dead is None:
                res.append((jd.psum_int8(g, "pod")["g"][None],))
                continue
            res.append((jd.masked_psum(g, a, axes)["g"][None],
                        jd.masked_hierarchical_psum(g, a, axes)["g"][None],
                        jd.masked_hierarchical_psum(
                            g, a, axes, compress=True)["g"][None]))
        return res

    res = jax.jit(shard_map(
        f, mesh=mesh, in_specs=([P(axes, None)] * len(cases),
                                [P(axes)] * len(cases)),
        out_specs=[(P(axes, None),) * (1 if d is None else 3)
                   for _, d in cases], check_rep=False))(xs, alives)
    for (name, dead), x, r in zip(cases, xs, res):
        if dead is None:
            out["int8pods/x"], out["int8pods/out"] = (np.asarray(x),
                                                      np.asarray(r[0]))
            continue
        out[f"red/{name}/x"] = np.asarray(x)
        for k, v in zip(("masked", "flat", "int8"), r):
            out[f"red/{name}/{k}"] = np.asarray(v)

def flat(prefix, tree):
    for g, d in tree.items():
        for k, v in d.items():
            out[f"{prefix}.{g}.{k}"] = np.asarray(v)

def dump_state(prefix, s):
    flat(prefix + "/params", s.params)
    flat(prefix + "/mu", s.opt_state.mu)
    flat(prefix + "/nu", s.opt_state.nu)
    for k in ("pmin", "best_value", "best_pe_lvl", "best_kt_lvl", "best_df",
              "epoch"):
        out[f"{prefix}/{k}"] = np.asarray(getattr(s, k))
    out[prefix + "/step"] = np.asarray(s.opt_state.step)

wl = jw.get_workload("ncf")
ecfg = jenv.EnvConfig(platform=cfg["platform"])
pcfg = jpolicy.PolicyConfig(obs_dim=ecfg.obs_dim, mix=ecfg.mix,
                            levels=ecfg.levels)
env = jenv.make_env(wl, ecfg)
for name, (shape, axes, dead, compress, seed) in cfg["epochs"].items():
    shape, axes = tuple(shape), tuple(axes)
    n = int(np.prod(shape))
    rcfg = jr.ReinforceConfig(epochs=2, lr=3e-3, seed=seed)
    dcfg = jd.DistConfig(episodes_per_device=E, compress_pod_axis=compress,
                         seed=seed)
    opt = joptim.Adam(lr=rcfg.lr)
    mesh = jax.make_mesh(shape, axes)
    alive = jax.device_put(jnp.asarray(mask_of(n, dead)),
                           NamedSharding(mesh, P(axes)))
    epoch = jd.make_distributed_epoch(ecfg, pcfg, rcfg, env, opt, mesh, dcfg)
    rollout = jr.make_rollout(ecfg, pcfg, env, rcfg.discount)

    def local_loss(params, pmin, keys):    # make_distributed_epoch's
        rolls = jax.vmap(lambda k: rollout(params, pmin, k))(keys)
        G = jax.vmap(lambda r: jr._discounted_returns(r, rcfg.discount))(
            rolls.rewards * rolls.mask)
        n_valid = jnp.maximum(rolls.mask.sum(axis=1), 1.0)
        mean = (G * rolls.mask).sum(axis=1) / n_valid
        var = (jnp.square(G - mean[:, None]) * rolls.mask).sum(1) / n_valid
        G_std = (G - mean[:, None]) / (jnp.sqrt(var)[:, None] + 1e-8)
        pg = -(rolls.logps * jax.lax.stop_gradient(G_std)
               * rolls.mask).sum(axis=1)
        return jnp.mean(pg), rolls

    def probe_shard(state, al):            # the epoch's shard, to the psum
        a = al[0]
        key = state.key
        for ax in axes:
            key = jax.random.fold_in(key, jax.lax.axis_index(ax))
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, E)
        (_, rolls), grads = jax.value_and_grad(local_loss, has_aux=True)(
            state.params, state.pmin, keys)
        red = jd.masked_hierarchical_psum(grads, a, axes, compress=compress)
        g = jax.tree.map(lambda x: x * a.astype(jnp.float32), grads)
        inpod = tuple(x for x in axes if x != "pod")
        if inpod:
            g = jax.tree.map(lambda x: jax.lax.psum(x, inpod), g)
        scale = jax.tree.map(
            lambda x: jax.lax.pmax(jnp.max(jnp.abs(x)) / 127.0 + 1e-12,
                                   "pod") if "pod" in axes
            else jnp.zeros(()), g)
        lead = lambda t: jax.tree.map(lambda x: x[None], t)
        return lead(red), rolls.actions[None], lead(scale)

    probe = shard_map(probe_shard, mesh=mesh, in_specs=(P(), P(axes)),
                      out_specs=(P(axes), P(axes), P(axes)), check_rep=False)
    # One program for the probe and the epoch; the state goes in
    # replicated every time, so the second epoch reuses the compile.
    both = jax.jit(lambda s: (probe(s, alive), epoch(s, alive)))
    rep = NamedSharding(mesh, P())
    state = jr.init_search(env, ecfg, pcfg, rcfg, opt)
    for ep in range(2):
        p = f"ep/{name}/{ep}"
        (red, acts, scale), (new, m) = both(jax.device_put(state, rep))
        dump_state(p + "/before", state)
        dump_state(p + "/after", new)
        out[p + "/actions"] = np.asarray(acts).reshape(n * E, -1, 3)
        flat(p + "/grads", jax.tree.map(lambda x: np.asarray(x)[0], red))
        flat(p + "/scale", jax.tree.map(lambda x: np.asarray(x)[0], scale))
        for k in ("best_value", "feasible_frac"):
            out[f"{p}/m/{k}"] = np.asarray(m[k])
        state = new

np.savez(sys.argv[2], **out)
print("OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("dist_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"))
    cfg = {"E": E, "platform": PLATFORM, "reductions": REDUCTION_CASES,
           "epochs": EPOCH_CASES}
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, json.dumps(cfg),
                        str(path)], env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
    with np.load(path) as z:
        return dict(z), str(path)


def _mask(n, dead):
    m = np.ones(n, bool)
    m[list(dead)] = False
    return m


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# The reductions.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(REDUCTION_CASES))
def test_reductions_match_the_reference(ref, name):
    z, _ = ref
    shape, axes, dead = REDUCTION_CASES[name]
    mesh = collectives.VirtualMesh(shape, axes, "cpu")
    x = _t(z[f"red/{name}/x"])
    alive = collectives.alive_flags(mesh, _mask(mesh.size, dead))
    tree = {"g": x}
    got = {
        "masked": collectives.masked_psum(mesh, tree, alive, axes)["g"],
        "flat": collectives.masked_hierarchical_psum(
            mesh, tree, alive, axes)["g"],
        "int8": collectives.masked_hierarchical_psum(
            mesh, tree, alive, axes, compress=True)["g"]}
    for k in ("masked", "flat"):
        np.testing.assert_allclose(got[k].numpy(), z[f"red/{name}/{k}"],
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    # One quantum of the int8 hop over the live count: the scale is the
    # max over pods of each pod's f32 sum's max|x| / 127 + 1e-12.
    xa = z[f"red/{name}/x"] * _mask(mesh.size, dead)[:, None]
    d = axes.index("pod")
    pods = np.moveaxis(xa.reshape(*shape, -1), d, 0).reshape(
        shape[d], -1, xa.shape[-1]).sum(axis=1, dtype=np.float32)
    scale = np.float32(np.abs(pods).max() / np.float32(127.0) + 1e-12)
    n_alive = max(mesh.size - len(dead), 1)
    diff = np.abs(got["int8"].numpy() - z[f"red/{name}/int8"])
    assert diff.max() <= 1.0001 * scale / n_alive, (name, diff.max(), scale)
    # Every device holds the same result, as the reference's do.
    for k, v in got.items():
        assert torch.equal(v, v[:1].expand_as(v)), k


def test_psum_int8_across_eight_pods_matches_the_reference(ref):
    z, _ = ref
    mesh = collectives.VirtualMesh((8,), ("pod",), "cpu")
    x = z["int8pods/x"]
    got = collectives.psum_int8(mesh, {"g": _t(x)}, "pod")["g"].numpy()
    scale = np.float32(np.abs(x).max(axis=1).max() / np.float32(127.0)
                       + 1e-12)
    diff = np.abs(got - z["int8pods/out"])
    assert diff.max() <= 1.0001 * scale, (diff.max(), scale)
    # The result is within half a quantum a device of the exact sum.
    assert np.abs(got[0] - x.sum(axis=0)).max() <= 8 * 0.5001 * scale


# ---------------------------------------------------------------------------
# The epoch, replayed.
# ---------------------------------------------------------------------------
def _setup(name):
    shape, axes, dead, compress, seed = EPOCH_CASES[name]
    wl = tworkloads.get_workload("ncf")
    ecfg = tenv.EnvConfig(platform=PLATFORM)
    pcfg = tpolicy.PolicyConfig(obs_dim=ecfg.obs_dim, mix=ecfg.mix,
                                levels=ecfg.levels)
    rcfg = treinforce.ReinforceConfig(epochs=2, lr=3e-3, seed=seed)
    dcfg = dist_search.DistConfig(episodes_per_device=E,
                                  compress_pod_axis=compress, seed=seed)
    env = tenv.make_env(wl, ecfg, "cpu")
    return ecfg, pcfg, rcfg, dcfg, env, toptim.Adam(lr=rcfg.lr)


def _group_tree(z, prefix):
    tree = {}
    for k, v in z.items():
        if k.startswith(prefix + "."):
            g, n = k[len(prefix) + 1:].split(".")
            tree.setdefault(g, {})[n] = v
    return tree


def _flat(z, prefix):
    return {k[len(prefix) + 1:]: v for k, v in z.items()
            if k.startswith(prefix + ".")}


def _state_from(z, prefix, pcfg):
    pol = tpolicy.params_from_jax(_group_tree(z, prefix + "/params"), pcfg)
    return treinforce.SearchState(
        params=pol,
        opt_state=toptim.OptState(
            _t(z[prefix + "/step"]),
            {k: _t(v) for k, v in _flat(z, prefix + "/mu").items()},
            {k: _t(v) for k, v in _flat(z, prefix + "/nu").items()}),
        pmin=_t(z[prefix + "/pmin"]), best_value=_t(z[prefix + "/best_value"]),
        best_pe_lvl=_t(z[prefix + "/best_pe_lvl"]).long(),
        best_kt_lvl=_t(z[prefix + "/best_kt_lvl"]).long(),
        best_df=_t(z[prefix + "/best_df"]).long(),
        generator=torch.Generator(), epoch=_t(z[prefix + "/epoch"]).long())


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _quantum_apart(name, z, p, grads):
    """{param: bool mask of the elements a quantum apart from the
    reference} (empty masks without the int8 hop), after checking every
    element within one quantum over the live count."""
    shape, _, dead, compress, _ = EPOCH_CASES[name]
    n_alive = max(int(np.prod(shape)) - len(dead), 1)
    apart = {}
    for k, want in _flat(z, p + "/grads").items():
        g = grads[k].detach().numpy()
        near = np.isclose(g, want, rtol=1e-4, atol=1e-5)
        if not compress:
            _close(g, want, rtol=1e-4, atol=1e-5, err_msg=k)
        else:
            q = z[f"{p}/scale.{k}"] / n_alive
            assert np.all(np.abs(g - want) <= 1.0001 * q + 1e-5), k
        apart[k] = ~near
    return apart


@pytest.mark.parametrize("name", sorted(EPOCH_CASES))
def test_replayed_epochs_match_the_reference(ref, name):
    z, _ = ref
    shape, axes, dead, compress, _ = EPOCH_CASES[name]
    ecfg, pcfg, rcfg, dcfg, env, opt = _setup(name)
    mesh = collectives.VirtualMesh(shape, axes, "cpu")
    alive = collectives.alive_flags(mesh, _mask(mesh.size, dead))
    grads_fn = dist_search.make_distributed_grads(ecfg, pcfg, rcfg, env,
                                                  mesh, alive, dcfg)
    epoch_fn = dist_search.make_distributed_epoch(ecfg, pcfg, rcfg, env, opt,
                                                  mesh, alive, dcfg)
    n_apart = 0
    for ep in range(2):
        p = f"ep/{name}/{ep}"
        actions = _t(z[p + "/actions"]).long()
        assert actions.shape == (mesh.size * E, env.num_layers, 3)
        state = _state_from(z, p + "/before", pcfg)
        grads, _ = grads_fn(state, actions)
        apart = _quantum_apart(name, z, p, grads)
        n_apart += sum(int(a.sum()) for a in apart.values())
        new, m = epoch_fn(state, actions)
        named = dict(new.params.named_parameters())
        # Epoch 0 starts from zero moments, where Adam's step is lr times
        # the sign of a gradient element however small: its params and
        # moments are compared after the next epoch only.
        for k, want in (_flat(z, p + "/after/params").items() if ep else ()):
            keep = ~apart[k]
            _close(named[k].detach().numpy()[keep], want[keep], atol=1e-5,
                   rtol=0, err_msg=k)
        for k, want in (_flat(z, p + "/after/mu").items() if ep else ()):
            keep = ~apart[k]
            _close(new.opt_state.mu[k].numpy()[keep], want[keep], rtol=1e-4,
                   atol=1e-6, err_msg=k)
        assert int(new.opt_state.step) == int(z[p + "/after/step"]) == ep + 1
        _close(new.pmin, z[p + "/after/pmin"], rtol=1e-6)
        _close(new.best_value, z[p + "/after/best_value"], rtol=1e-5)
        for k in ("best_pe_lvl", "best_kt_lvl", "best_df"):
            assert np.array_equal(getattr(new, k).numpy(),
                                  z[f"{p}/after/{k}"]), k
        assert int(new.epoch) == int(z[p + "/after/epoch"])
        for k in dist_search.DIST_METRICS:
            _close(m[k], z[f"{p}/m/{k}"], rtol=1e-5, err_msg=k)
    # A quantum apart only where a different summation order inside a pod
    # crosses a rounding boundary: a handful of 70k elements at most.
    n_params = sum(v.size for v in _flat(z, f"ep/{name}/0/grads").values())
    assert n_apart <= 1e-3 * n_params, (n_apart, n_params)
    print(f"{name}: {n_apart} of {2 * n_params} gradient elements a "
          "quantum apart")


# ---------------------------------------------------------------------------
# Identities, bit for bit.
# ---------------------------------------------------------------------------
def _bits_equal(a, b):
    assert all(torch.equal(p, q) for p, q in zip(a.params.parameters(),
                                                 b.params.parameters()))
    assert all(torch.equal(p, q) for p, q in zip(
        treinforce.state_tensors(a), treinforce.state_tensors(b)))


def test_one_shard_mesh_gives_the_bits_of_reinforce():
    ecfg, pcfg, _, _, env, _ = _setup("data4")
    rcfg = treinforce.ReinforceConfig(epochs=6, episodes_per_epoch=E, seed=5)
    want, whist = treinforce.run_search(None, ecfg, rcfg, pcfg, env=env,
                                        chunk=4)
    mesh = collectives.VirtualMesh((1,), ("data",), "cpu")
    got, ghist = dist_search.run_distributed_search(
        None, ecfg, mesh, dataclasses.replace(rcfg, episodes_per_epoch=1),
        dist_search.DistConfig(episodes_per_device=E, seed=5), pcfg, env=env)
    _bits_equal(got, want)
    assert torch.equal(got.generator.get_state(), want.generator.get_state())
    for k in dist_search.DIST_METRICS:
        assert ghist[k].tobytes() == whist[k].tobytes(), k


def test_all_dead_epoch_keeps_the_params_and_still_tracks_the_best():
    ecfg, pcfg, rcfg, dcfg, env, opt = _setup("pod2x2_dead1_int8")
    mesh = collectives.VirtualMesh((2, 2), ("pod", "data"), "cpu")
    for compress in (False, True):
        state = treinforce.init_search(env, ecfg, pcfg, rcfg, opt)
        before = [p.detach().clone() for p in state.params.parameters()]
        epoch_fn = dist_search.make_distributed_epoch(
            ecfg, pcfg, rcfg, env, opt, mesh,
            collectives.alive_flags(mesh, [False] * 4),
            dataclasses.replace(dcfg, compress_pod_axis=compress))
        new, m = epoch_fn(state)
        assert all(torch.equal(p, q) for p, q in zip(
            new.params.parameters(), before))
        assert int(new.opt_state.step) == 1
        assert torch.isfinite(new.pmin) and torch.isfinite(new.best_value)
        assert float(m["best_value"]) == float(new.best_value)
        assert 0.0 < float(m["feasible_frac"]) <= 1.0


@pytest.mark.parametrize("eps,opts", [
    (20, {}),
    (30, {"mesh": ((2, 2), ("pod", "data")), "episodes_per_device": 2,
          "compress_pod_axis": True, "straggler_mask": [1, 0, 1, 1]}),
])
def test_outcome_keeps_the_reference_schema(eps, opts):
    opts = dict(opts)
    if "mesh" in opts:
        opts["mesh"] = collectives.VirtualMesh(*opts["mesh"], "cpu")
    out = api.run_search(api.SearchRequest(
        workload="ncf", env=tenv.EnvConfig(platform=PLATFORM), eps=eps,
        seed=3, method="dist_reinforce", options=opts, device="cpu"))
    n = out.extras["devices"]
    per_epoch = opts.get("episodes_per_device", 1) * n
    assert out.method == "dist_reinforce" and len(out.history) == eps
    assert np.all(out.history[1:] <= out.history[:-1])
    assert out.history[-1] == out.best_value
    assert set(out.extras) == {"epochs", "devices", "history"}
    assert out.extras["epochs"] == max(eps // per_epoch, 1)
    assert set(out.extras["history"]) == set(dist_search.DIST_METRICS)
    assert len(out.extras["history"]["best_value"]) == out.extras["epochs"]


def test_mesh_on_another_device_than_the_request_is_refused():
    mesh = collectives.VirtualMesh((2,), ("data",), "cpu")
    with pytest.raises(ValueError, match="not on the request's device"):
        api.get_optimizer("dist_reinforce").run(api.SearchRequest(
            workload="ncf", eps=4, method="dist_reinforce",
            options={"mesh": mesh}, device="cuda"))


def test_service_runs_it_unbatched_with_the_serial_bytes():
    req = lambda: api.SearchRequest(
        workload="ncf", env=tenv.EnvConfig(platform=PLATFORM), eps=24,
        seed=4, method="dist_reinforce",
        options={"episodes_per_device": 2}, device="cpu")
    serial = api.run_search(req())
    s = SearchService(ServiceConfig(max_workers=2, device="cpu"))
    try:
        got = s.submit(req()).result(timeout=300)
    finally:
        s.close()
    assert got.best_value == serial.best_value
    assert got.history.tobytes() == serial.history.tobytes()
    for k in ("pe", "kt", "df"):
        assert getattr(got, k).tobytes() == getattr(serial, k).tobytes(), k


# ---------------------------------------------------------------------------
# Gloo ranks: a ProcessMesh of four CPU processes.
# ---------------------------------------------------------------------------
RANK_SCRIPT = r"""
import sys
import numpy as np, torch, torch.distributed as dist
sys.path.insert(0, sys.argv[5])
import test_torch_dist_reinforce as T
from repro_torch.core import reinforce
from repro_torch.distributed import collectives, dist_search

rank, world, store_path, npz, _, out = (int(sys.argv[1]), int(sys.argv[2]),
                                        *sys.argv[3:7])
torch.set_num_threads(1)      # four ranks share the host's cores
dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                        rank=rank, world_size=world)
try:
    name = "pod2x2_dead1_int8"
    shape, axes, dead, compress, seed = T.EPOCH_CASES[name]
    ecfg, pcfg, rcfg, dcfg, env, opt = T._setup(name)
    mesh = collectives.ProcessMesh(shape, axes)
    alive = collectives.alive_flags(mesh, T._mask(mesh.size, dead))
    z = dict(np.load(npz))
    p = f"ep/{name}/1"
    actions = T._t(z[p + "/actions"]).long()[rank * T.E:(rank + 1) * T.E]
    state = T._state_from(z, p + "/before", pcfg)
    grads, _ = dist_search.make_distributed_grads(
        ecfg, pcfg, rcfg, env, mesh, alive, dcfg)(state, actions)
    new, m = dist_search.make_distributed_epoch(
        ecfg, pcfg, rcfg, env, opt, mesh, alive, dcfg)(state, actions)
    res = {f"grads.{k}": v.numpy() for k, v in grads.items()}
    res.update({f"params.{k}": v.detach().numpy()
                for k, v in new.params.named_parameters()})
    res.update({k: np.asarray(getattr(new, k)) for k in (
        "pmin", "best_value", "best_pe_lvl", "best_kt_lvl", "best_df")})
    res.update({f"m.{k}": np.asarray(v) for k, v in m.items()})
    # A short unreplayed run: each rank draws from its own generator.
    run_state, hist = dist_search.run_distributed_search(
        None, ecfg, mesh, T.dataclasses.replace(rcfg, epochs=3), dcfg, pcfg,
        straggler_mask=T._mask(mesh.size, dead), env=env)
    res.update({f"run.{k}": v.detach().numpy()
                for k, v in run_state.params.named_parameters()})
    res["run.best_value"] = hist["best_value"]
    np.savez(out, **res)
finally:
    dist.destroy_process_group()
print("OK")
"""


def test_gloo_ranks_match_the_virtual_mesh(ref, tmp_path):
    z, npz = ref
    world = 4
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    outs = [tmp_path / f"rank{r}.npz" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(r), str(world),
         str(tmp_path / "store"), npz, os.path.dirname(__file__),
         str(outs[r])], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        results = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (so, se) in zip(procs, results):
        assert p.returncode == 0 and "OK" in so, se[-3000:]
    ranks = [dict(np.load(o)) for o in outs]
    for r in ranks[1:]:                     # bit-identical across the ranks
        for k, v in ranks[0].items():
            assert v.tobytes() == r[k].tobytes(), k

    # Against the virtual mesh on the same inputs: rtol 1e-6, and one
    # quantum over the live count where the int8 hop rounds differently.
    name = "pod2x2_dead1_int8"
    shape, axes, dead, compress, _ = EPOCH_CASES[name]
    ecfg, pcfg, rcfg, dcfg, env_t, opt = _setup(name)
    mesh = collectives.VirtualMesh(shape, axes, "cpu")
    alive = collectives.alive_flags(mesh, _mask(mesh.size, dead))
    p = f"ep/{name}/1"
    actions = _t(z[p + "/actions"]).long()
    state = _state_from(z, p + "/before", pcfg)
    grads, _ = dist_search.make_distributed_grads(
        ecfg, pcfg, rcfg, env_t, mesh, alive, dcfg)(state, actions)
    new, m = dist_search.make_distributed_epoch(
        ecfg, pcfg, rcfg, env_t, opt, mesh, alive, dcfg)(
        _state_from(z, p + "/before", pcfg), actions)
    got = ranks[0]
    n_alive = mesh.size - len(dead)
    named = dict(new.params.named_parameters())
    n_apart = 0
    for k, g in grads.items():
        g, want = g.numpy(), got[f"grads.{k}"]
        q = z[f"{p}/scale.{k}"] / n_alive
        assert np.all(np.abs(g - want) <= 1.0001 * q + 1e-6 * np.abs(g)), k
        near = np.isclose(want, g, rtol=1e-6, atol=1e-7)
        n_apart += int((~near).sum())
        _close(got[f"params.{k}"][near], named[k].detach().numpy()[near],
               rtol=1e-6, atol=1e-7, err_msg=k)
    assert n_apart <= 1e-3 * sum(g.numel() for g in grads.values())
    for k in ("pmin", "best_value"):
        _close(got[k], getattr(new, k), rtol=1e-6)
    for k in ("best_pe_lvl", "best_kt_lvl", "best_df"):
        assert np.array_equal(got[k], getattr(new, k).numpy()), k
    for k in dist_search.DIST_METRICS:
        _close(got[f"m.{k}"], m[k], rtol=1e-6)
    assert np.all(np.isfinite(got["run.best_value"][-1:]))
