"""The port's HTTP front door on the CPU: wire parity, admission control,
fairness, cancellation, streaming and the stats / metrics endpoints.

Ports of tests/test_http_service.py against
``repro_torch.serving.SearchHTTPService`` on an ephemeral port with
``ServiceConfig(device="cpu")``, plus the JSON codecs held to the
reference's.  The load-bearing guarantee carries over from the in-process
service: a search submitted over HTTP returns the same bits as the same
``api.run_search`` call (JSON float round-tripping is exact) -- the
frontier included.  The port runs eagerly, so its parity holds where the
reference's is at the mercy of XLA's fusion.

Every client call has a timeout, and every hub cancels its jobs and closes
in ``finally``, so a failure cannot leave a search running.
"""
import importlib.util
import json
import os
import time

import numpy as np
import pytest

from repro.serving import http_service as ref_http
from repro_torch import api, obs
from repro_torch.core import env as env_lib
from repro_torch.obs import instrument
from repro_torch.serving import (HttpConfig, QueueFull, SearchClient,
                                 SearchHTTPService, ServiceConfig,
                                 outcome_to_json, request_from_spec)
from torch_threads import one_torch_thread  # noqa: F401,E402

ECFG = env_lib.EnvConfig(platform="cloud")
TIMEOUT = 60.0          # every socket call and result wait
LONG_EPS = 10_000_000   # a reinforce job that runs until cancelled


@pytest.fixture(autouse=True)
def _clean_obs():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def _hub(max_workers=2, max_queue=8, max_running=None, weights=(),
         progress_every=200):
    return SearchHTTPService(
        service_cfg=ServiceConfig(max_workers=max_workers,
                                  default_progress_every=progress_every,
                                  device="cpu"),
        http_cfg=HttpConfig(port=0, max_queue=max_queue,
                            max_running=max_running,
                            tenant_weights=weights,
                            progress_poll_s=0.01)).start()


def _close(hub):
    """Cancel whatever is still queued or running, then shut down."""
    with hub.front._cv:
        uids = list(hub.front._jobs)
    for uid in uids:
        hub.front.cancel(uid)
    hub.close()


def _client(hub):
    return SearchClient(port=hub.port, timeout=TIMEOUT)


def _wait(pred, timeout=TIMEOUT, step=0.01):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(step)
    return False


def _run(method, eps, seed, env=ECFG, options=None):
    return api.run_search(api.SearchRequest(
        workload="ncf", env=env, eps=eps, seed=seed, method=method,
        options=dict(options or {}), device="cpu"))


def _assert_wire_equal(out, want):
    assert out["best_value"] == want.best_value
    got_hist = np.asarray(out["history"], want.history.dtype)
    assert got_hist.tobytes() == want.history.tobytes()
    for k in ("pe", "kt", "df"):
        want_k = np.asarray(getattr(want, k))
        assert np.asarray(out[k], want_k.dtype).tobytes() == \
            want_k.tobytes(), k


# ---------------------------------------------------------------------------
# Wire parity.
# ---------------------------------------------------------------------------
def test_http_end_to_end_bit_identical_to_in_process():
    """Same fixed-seed search over the wire == api.run_search, bit for bit
    (history bytes, pe/kt/df assignment, best value)."""
    want = _run("random", 200, 3)
    hub = _hub()
    try:
        client = _client(hub)
        uid = client.submit({"workload": "ncf", "method": "random",
                             "eps": 200, "seed": 3})["uid"]
        out = client.result(uid, timeout=TIMEOUT)
        _assert_wire_equal(out, want)
        assert out["method"] == "random" and out["seed"] == 3
    finally:
        _close(hub)


def test_http_nsga2_frontier_bit_identical_to_in_process():
    """nsga2 through the front door (its costs through the service's
    batcher) equals the in-process serial run, frontier included."""
    want = _run("nsga2", 240, 4, options={"population": 24})
    hub = _hub()
    try:
        client = _client(hub)
        uid = client.submit({"workload": "ncf", "method": "nsga2",
                             "eps": 240, "seed": 4,
                             "population": 24})["uid"]
        out = client.result(uid, timeout=TIMEOUT)
        _assert_wire_equal(out, want)
        assert set(out["frontier"]) == set(want.frontier)
        for k, v in want.frontier.items():
            v = np.asarray(v)
            assert np.asarray(out["frontier"][k], v.dtype).tobytes() == \
                v.tobytes(), k
    finally:
        _close(hub)


def test_http_dist_reinforce_bit_identical_to_in_process():
    """dist_reinforce over the wire (a method the service does not batch,
    on the default mesh of one device) equals the in-process run."""
    want = _run("dist_reinforce", 24, 5, options={"episodes_per_device": 2})
    hub = _hub()
    try:
        client = _client(hub)
        uid = client.submit({"workload": "ncf", "method": "dist_reinforce",
                             "eps": 24, "seed": 5,
                             "episodes_per_device": 2})["uid"]
        out = client.result(uid, timeout=TIMEOUT)
        _assert_wire_equal(out, want)
        assert out["method"] == "dist_reinforce"
    finally:
        _close(hub)


def test_http_full_env_spec_and_options_pass_through():
    """objective/constraint/dataflow and leftover option keys survive the
    spec -> SearchRequest translation (same convention as serve_search)."""
    env2 = env_lib.EnvConfig(platform="cloud", objective="energy",
                             constraint="power", dataflow=1)
    want = _run("ga", 150, 2, env=env2, options={"population": 30})
    hub = _hub()
    try:
        client = _client(hub)
        uid = client.submit({"workload": "ncf", "method": "ga", "eps": 150,
                             "seed": 2, "objective": "energy",
                             "constraint": "power", "dataflow": "eye",
                             "population": 30})["uid"]
        out = client.result(uid, timeout=TIMEOUT)
        _assert_wire_equal(out, want)
    finally:
        _close(hub)


# ---------------------------------------------------------------------------
# The JSON codecs against the reference's.
# ---------------------------------------------------------------------------
SPECS = [
    {"workload": "ncf"},
    {"workload": "mobilenet_v2", "method": "ga", "eps": 300, "seed": 5,
     "tenant": "alice", "objective": "energy", "constraint": "power",
     "platform": "iot", "scenario": "LS", "dataflow": "shi",
     "population": 40, "options": {"population": 50, "x": 1}},
    {"workload": "ncf", "method": "nsga2", "archive": 64, "eps": "640"},
]


@pytest.mark.parametrize("spec", SPECS)
def test_request_from_spec_matches_the_reference(spec):
    kw = dict(default_platform="iotx", default_eps=77, default_tenant="t")
    got, tenant = request_from_spec(spec, device="cpu", **kw)
    want, want_tenant = ref_http.request_from_spec(spec, **kw)
    assert tenant == want_tenant
    for f in ("workload", "eps", "seed", "method", "options"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("objective", "constraint", "platform", "scenario",
              "dataflow"):
        assert getattr(got.env, f) == getattr(want.env, f), f
    assert got.device == "cpu"       # the hub's, never the body's


def test_outcome_to_json_has_the_reference_keys_and_round_trips_inf():
    """An infeasible outcome (mobilenet_v2 under iot: nothing feasible in
    40 random samples) goes over the wire as ``Infinity`` and comes back
    as inf; the keys are the reference's; a traced nsga2 outcome
    serializes frontier and telemetry as plain lists and numbers."""
    from repro import api as ref_api
    from repro.core import env as ref_env

    out = api.run_search(api.SearchRequest(
        workload="mobilenet_v2", env=env_lib.EnvConfig(platform="iot"),
        eps=40, seed=0, method="random", device="cpu"))
    ref = ref_api.run_search(ref_api.SearchRequest(
        workload="mobilenet_v2", env=ref_env.EnvConfig(platform="iot"),
        eps=40, seed=0, method="random"))
    assert out.best_value == float("inf") == ref.best_value
    d = outcome_to_json(out)
    assert set(d) == set(ref_http.outcome_to_json(ref))
    text = json.dumps(d)
    assert "Infinity" in text
    back = json.loads(text)
    assert back["best_value"] == float("inf") and not back["feasible"]
    assert np.isnan(back["pe"]).all()

    obs.enable(trace=True)
    try:
        multi = _run("nsga2", 120, 1, options={"population": 30})
    finally:
        obs.disable()
    d = outcome_to_json(multi)
    assert set(d) == set(ref_http.outcome_to_json(multi))
    assert {"frontier", "telemetry"} <= set(d)
    back = json.loads(json.dumps(d, allow_nan=True))
    assert back == d
    assert all(isinstance(v, list) for v in d["frontier"].values())
    assert d["telemetry"]["engine"] == "nsga2"


# ---------------------------------------------------------------------------
# Admission control.
# ---------------------------------------------------------------------------
def test_queue_full_returns_429_with_retry_after():
    hub = _hub(max_workers=1, max_queue=1, max_running=1)
    try:
        client = _client(hub)
        running = client.submit({"workload": "ncf", "method": "reinforce",
                                 "eps": LONG_EPS})
        assert _wait(lambda: hub.front.stats()["running"] == 1
                     and hub.front.stats()["queued"] == 0)
        queued = client.submit({"workload": "ncf", "method": "random",
                                "eps": 100})
        assert hub.front.stats()["queued"] == 1      # queue now full
        status, headers, _ = client._request(
            "POST", "/v1/search",
            {"workload": "ncf", "method": "random", "eps": 100})
        assert status == 429
        assert float(headers["Retry-After"]) > 0
        with pytest.raises(QueueFull):               # client-side surface
            client.submit({"workload": "ncf", "method": "random",
                           "eps": 100})
        st = hub.front.stats()
        assert st["rejected"] == 2
        assert st["tenants"]["anon"]["rejected"] == 2
        client.cancel(queued["uid"])
        client.cancel(running["uid"])
    finally:
        _close(hub)


def test_bad_request_body_is_400_not_500():
    hub = _hub()
    try:
        client = _client(hub)
        status, _, data = client._request("POST", "/v1/search",
                                          {"method": "random"})  # no workload
        assert status == 400 and b"workload" in data
        status, _, _ = client._request("POST", "/v1/search",
                                       {"workload": "ncf", "eps": 0})
        assert status == 400                         # eps < 1
        status, _, _ = client._request("GET", "/v1/search/nope")
        assert status == 404
        status, _, _ = client._request("DELETE", "/v1/search/nope")
        assert status == 404
        status, _, _ = client._request("GET", "/no/such/route")
        assert status == 404
        status, _, _ = client._request("GET", "/v1/search/nope/progress")
        assert status == 404
    finally:
        _close(hub)


def test_unknown_method_fails_the_job_not_the_server():
    hub = _hub()
    try:
        client = _client(hub)
        uid = client.submit({"workload": "ncf", "method": "no_such",
                             "eps": 10})["uid"]
        with pytest.raises(RuntimeError, match="failed"):
            client.result(uid, timeout=TIMEOUT)
        assert "unknown optimizer" in client.status(uid)["error"]
        st = client.stats()["front_door"]["tenants"]["anon"]
        assert st["failed"] == 1 and st["completed"] == 0
    finally:
        _close(hub)


# ---------------------------------------------------------------------------
# Cancellation over the wire.
# ---------------------------------------------------------------------------
def test_cancel_over_wire_running_and_queued():
    hub = _hub(max_workers=1, max_queue=8, max_running=1,
               progress_every=50)
    try:
        client = _client(hub)
        running = client.submit({"workload": "ncf", "method": "reinforce",
                                 "eps": LONG_EPS})["uid"]
        assert _wait(lambda: client.status(running)["status"] == "running")
        queued = client.submit({"workload": "ncf", "method": "random",
                                "eps": 100})["uid"]
        # Queued cancel resolves while the worker is still busy.
        client.cancel(queued)
        assert _wait(lambda: client.status(queued)["status"] == "cancelled",
                     timeout=5)
        assert client.status(running)["status"] == "running"
        client.cancel(running)
        assert _wait(lambda: client.status(running)["status"] == "cancelled")
        with pytest.raises(RuntimeError, match="cancelled"):
            client.result(queued, timeout=5)
        st = client.stats()["front_door"]["tenants"]["anon"]
        assert st["cancelled"] == 2 and st["completed"] == 0
    finally:
        _close(hub)


# ---------------------------------------------------------------------------
# Progress streaming.
# ---------------------------------------------------------------------------
def test_progress_stream_is_incremental_jsonl():
    hub = _hub(max_workers=1, progress_every=25)
    try:
        client = _client(hub)
        uid = client.submit({"workload": "ncf", "method": "reinforce",
                             "eps": 100})["uid"]
        recs = list(client.progress(uid))
        assert recs[-1]["done"] is True
        assert recs[-1]["status"] == "done"
        trials = recs[:-1]
        assert len(trials) >= 3                      # 25-step cadence
        steps = [r["step"] for r in trials]
        assert steps == sorted(steps) and steps[-1] == 100
        assert all(np.isfinite(r["best_value"]) or r["best_value"] == float(
            "inf") for r in trials)
        out = client.result(uid, timeout=TIMEOUT)
        assert out["best_value"] == min(r["best_value"] for r in trials)
    finally:
        _close(hub)


# ---------------------------------------------------------------------------
# Tenant fairness + accounting.
# ---------------------------------------------------------------------------
def test_wrr_interactive_tenant_not_starved_by_backlog():
    """One running slot, tenant A floods 4 jobs, tenant B submits 1: WRR
    must schedule B's single job ahead of A's backlog tail."""
    hub = _hub(max_workers=1, max_queue=16, max_running=1)
    try:
        client = _client(hub)
        a = [client.submit({"workload": "ncf", "method": "random",
                            "eps": 600, "seed": s, "tenant": "batch"})["uid"]
             for s in range(4)]
        b = client.submit({"workload": "ncf", "method": "random",
                           "eps": 300, "seed": 9,
                           "tenant": "interactive"})["uid"]
        for uid in a + [b]:
            client.result(uid, timeout=TIMEOUT)
        jobs = {uid: hub.front.get(uid) for uid in a + [b]}
        assert jobs[b].finished_at < jobs[a[2]].finished_at
        assert jobs[b].finished_at < jobs[a[3]].finished_at

        tenants = client.stats()["front_door"]["tenants"]
        assert tenants["batch"]["submitted"] == 4
        assert tenants["batch"]["completed"] == 4
        assert tenants["batch"]["eps_requested"] == 4 * 600
        assert tenants["batch"]["eps_finished"] == 4 * 600
        assert tenants["interactive"]["completed"] == 1
        assert tenants["interactive"]["eps_finished"] == 300
    finally:
        _close(hub)


def _wrr_order(front_door_cls, weights, submissions, n):
    """Dequeue order of a front door that never runs a job: the tenants of
    its first ``n`` weighted round-robin picks."""
    from repro_torch.api.types import SearchRequest

    fd = front_door_cls(None, max_queue=64, max_running=0,
                        weights=dict(weights))
    try:
        for tenant in submissions:
            fd.submit(SearchRequest(workload="ncf", eps=10), tenant)
        with fd._cv:
            return [fd._next_job_locked().tenant for _ in range(n)]
    finally:
        fd.close()


@pytest.mark.parametrize("weights", [(("heavy", 2), ("light", 1)),
                                     (("heavy", 3),), ()])
def test_wrr_order_equals_the_reference(weights):
    """The same submissions under the same weights are dequeued in the
    reference's order, and the long-run shares follow the weights."""
    from repro_torch.serving.http_service import _FrontDoor

    subs = ["heavy"] * 12 + ["light"] * 12 + ["third"] * 3
    got = _wrr_order(_FrontDoor, weights, subs, len(subs))
    assert got == _wrr_order(ref_http._FrontDoor, weights, subs, len(subs))
    w = dict(weights)
    window = got[3:3 + 2 * (w.get("heavy", 1) + w.get("light", 1) + 1)]
    assert window.count("heavy") == 2 * w.get("heavy", 1)
    assert window.count("light") == 2 * w.get("light", 1)


def test_stats_and_metrics_endpoints():
    hub = _hub()
    try:
        client = _client(hub)
        uid = client.submit({"workload": "ncf", "method": "random",
                             "eps": 60, "tenant": "t0"})["uid"]
        client.result(uid, timeout=TIMEOUT)
        st = client.stats()
        assert st["service"]["completed"] == 1
        assert st["front_door"]["tenants"]["t0"]["completed"] == 1
        assert st["front_door"]["max_queue"] == 8
        text = client.metrics_text()
        # The registry's exposition is served whole -- the front-door
        # metrics are registered (samples only accrue while obs is on).
        assert "# TYPE repro_http_requests counter" in text
        assert "# TYPE repro_service_requests counter" in text
    finally:
        _close(hub)


def test_http_metrics_accrue_when_telemetry_enabled(tmp_path):
    obs.enable()
    hub = _hub()
    try:
        client = _client(hub)
        before = instrument.HTTP_REQUESTS.value(route="/v1/stats",
                                                code="200")
        client.stats()
        client.stats()
        # A handler counts its request after the response went out.
        assert _wait(lambda: instrument.HTTP_REQUESTS.value(
            route="/v1/stats", code="200") == before + 2, timeout=10)
        uid = client.submit({"workload": "ncf", "method": "ga",
                             "eps": 100, "population": 20})["uid"]
        out = client.result(uid, timeout=TIMEOUT)
        assert out["telemetry"]["engine"] == "ga"
        assert out["telemetry"]["hard_evals"] == 100
        assert out["telemetry"]["points"] > 0        # batcher attribution
        text = client.metrics_text()
        assert "repro_http_requests_total{" in text
        assert 'route="/v1/stats"' in text
        assert 'repro_service_requests_total{status="completed"} 1.0' in text
        path = tmp_path / "m.prom"
        path.write_text(text)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        spec = importlib.util.spec_from_file_location(
            "check_telemetry", os.path.join(repo, "tools",
                                            "check_telemetry.py"))
        checker = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(checker)
        assert checker.check_metrics(str(path), [
            "repro_http_requests", "repro_batcher_dispatches",
            "repro_dispatch_seconds"]) > 0
    finally:
        _close(hub)
