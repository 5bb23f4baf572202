"""HTTP/JSON front door over :class:`~repro_torch.serving.SearchService`.

Port of ``repro.serving.http_service``: the same routes, JSON bodies,
scheduling and status codes.  ``SearchHTTPService`` puts a network face on the in-process search service:
tickets become URLs, progress becomes a chunked JSONL stream, and the
process-wide metrics registry is scrapable at ``/metrics``.  Zero new
dependencies -- the server is stdlib ``http.server.ThreadingHTTPServer``,
the client ``http.client``.

Endpoints::

    POST   /v1/search                  submit -> 202 {uid, url, tenant}
                                       or 429 + Retry-After when the
                                       admission queue is full
    GET    /v1/search/<uid>            status; includes "result" once done
    DELETE /v1/search/<uid>            cancel (queued jobs finish instantly)
    GET    /v1/search/<uid>/progress   chunked application/x-ndjson: one
                                       Trial per line, then a terminal
                                       {"status": ..., "done": true} line
    GET    /v1/stats                   service + front-door + tenant stats
    GET    /metrics                    Prometheus text exposition (the
                                       repro_torch.obs registry)

Scheduling semantics -- the part that makes this a *front door* rather
than a proxy:

  * **admission control**: at most ``HttpConfig.max_queue`` jobs wait for
    a worker slot; past that, submissions get ``429`` with a
    ``Retry-After`` header instead of unbounded queue growth;
  * **per-tenant fairness**: queued jobs are dequeued weighted
    round-robin across the ``tenant`` field of the request body, so one
    tenant's 10k-eval GA backlog cannot starve another tenant's
    interactive random/bo probes -- an interactive job waits at most one
    full WRR rotation, not the whole backlog;
  * **per-tenant accounting**: submissions, rejections, outcomes and
    eval budgets (``eps``) per tenant, surfaced in ``/v1/stats``.

Exactness carries over the wire: the front door drives the same
``SearchService.submit`` path as in-process callers, and JSON float
round-tripping is exact (``repr`` shortest-float), so a fixed-seed search
submitted over HTTP returns bit-identical history/assignment to the same
request run in-process (``tests/test_torch_http_service.py`` locks this
in).  Non-finite floats follow Python's JSON dialect (``Infinity``/``NaN``).

The port runs every search on the service's device
(``ServiceConfig.device``): :func:`request_from_spec` takes the request's
``device`` from there, and the JSON body has no device field.  The
handler threads touch no CUDA state: they read the service's host-side
stats, the metrics registry and finished outcomes, whose arrays are numpy
by the time a ticket completes; only the service's search workers and
the batcher's dispatchers use the card.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.api import types as api_types
from repro_torch.core import env as env_lib
from repro_torch.costmodel import dataflows as dfl
from repro_torch.obs import instrument as obs_instrument
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serving.search_service import (SearchService, SearchTicket,
                                                ServiceConfig)


class QueueFull(Exception):
    """Admission control rejected a submission (HTTP 429)."""


@dataclasses.dataclass(frozen=True)
class HttpConfig:
    host: str = "127.0.0.1"
    port: int = 8731              # 0 -> ephemeral (tests)
    max_queue: int = 64           # jobs waiting for a slot; beyond -> 429
    max_running: Optional[int] = None   # None: the service's max_workers
    retry_after_s: float = 1.0    # advertised in the 429 Retry-After header
    default_tenant: str = "anon"  # jobs without a "tenant" field
    tenant_weights: Tuple[Tuple[str, int], ...] = ()   # WRR weights
    default_weight: int = 1       # weight of tenants not listed above
    default_eps: int = 600        # request defaults when the body omits them
    default_platform: str = "cloud"
    progress_poll_s: float = 0.05  # progress-stream poll granularity


# --------------------------------------------------------------------------
# Request / response JSON codecs.
# --------------------------------------------------------------------------
def request_from_spec(spec: dict, *, default_platform: str = "cloud",
                      default_eps: int = 600, default_tenant: str = "anon",
                      device: str = "cuda"
                      ) -> Tuple[api_types.SearchRequest, str]:
    """One request dict -> (SearchRequest, tenant).

    Env fields (``objective``/``constraint``/``platform``/``scenario``/
    ``dataflow``) and the core fields are popped; leftover unknown keys
    merge into ``options`` (an explicit ``options`` dict wins on
    conflicts) -- the same convention as the ``serve_search`` spec files.
    ``device`` is the serving hub's (``ServiceConfig.device``), not the
    body's: a service runs every search on its own device.
    """
    spec = dict(spec)
    tenant = str(spec.pop("tenant", default_tenant))
    ecfg = env_lib.EnvConfig(
        objective=spec.pop("objective", "latency"),
        constraint=spec.pop("constraint", "area"),
        platform=spec.pop("platform", default_platform),
        scenario=spec.pop("scenario", "LP"),
        dataflow=dfl.DATAFLOW_NAMES.index(spec.pop("dataflow", "dla")))
    workload = spec.pop("workload")
    eps = int(spec.pop("eps", default_eps))
    seed = int(spec.pop("seed", 0))
    method = spec.pop("method", "two_stage")
    explicit = spec.pop("options", {})
    options = {**spec, **explicit}
    return api_types.SearchRequest(workload=workload, env=ecfg, eps=eps,
                                   seed=seed, method=method,
                                   options=options, device=device), tenant


def _plain(v):
    """Arrays (numpy, or tensors on the CPU) -> nested lists, recursively
    through dicts, lists and tuples; numpy scalars -> Python numbers.  A
    tensor on the card raises (``np.asarray`` refuses it) instead of being
    read from a handler thread."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, (str, bool, int, float)) or v is None:
        return v
    return np.asarray(v).tolist()


def outcome_to_json(out: api_types.SearchOutcome) -> dict:
    d = {
        "method": out.method, "best_value": float(out.best_value),
        "feasible": bool(out.feasible), "eps": out.eps, "seed": out.seed,
        "samples_to_convergence": int(out.samples_to_convergence),
        "wall_seconds": out.wall_seconds,
        "pe": _plain(out.pe),
        "kt": _plain(out.kt),
        "df": _plain(out.df),
        "history": _plain(out.history),
    }
    if out.frontier is not None:
        d["frontier"] = _plain(out.frontier)
    if out.telemetry is not None:
        d["telemetry"] = _plain(out.telemetry)
    return d


# --------------------------------------------------------------------------
# Front-door scheduler: admission control + weighted round-robin fairness.
# --------------------------------------------------------------------------
class _Job:
    """One front-door submission: queued here first, a service ticket once
    a worker slot frees up."""

    __slots__ = ("uid", "tenant", "request", "created_at", "finished_at",
                 "ticket", "cancel_requested", "error", "_status", "_done")

    def __init__(self, uid: str, tenant: str,
                 request: api_types.SearchRequest):
        self.uid = uid
        self.tenant = tenant
        self.request = request
        self.created_at = time.time()
        self.finished_at: Optional[float] = None
        self.ticket: Optional[SearchTicket] = None
        self.cancel_requested = False
        self.error: Optional[str] = None
        self._status = "queued"    # pre-ticket: queued|cancelled|failed
        self._done = threading.Event()

    @property
    def status(self) -> str:
        t = self.ticket
        return t.status if t is not None else self._status

    def done(self) -> bool:
        t = self.ticket
        return t.done() if t is not None else self._done.is_set()

    def to_json(self, include_result: bool = True) -> dict:
        d = {"uid": self.uid, "url": f"/v1/search/{self.uid}",
             "tenant": self.tenant, "status": self.status,
             "method": self.request.method, "eps": self.request.eps,
             "seed": self.request.seed, "created_at": self.created_at}
        t = self.ticket
        if t is not None:
            d["trials"] = len(t.trials)
            if t.trials:
                d["best_value"] = t.trials[-1].best_value
                d["step"] = t.trials[-1].step
            if t.done():
                d["wall_seconds"] = t.wall_seconds
                if include_result and t.status == "done":
                    d["result"] = outcome_to_json(t._outcome)
                elif t._error is not None:
                    d["error"] = repr(t._error)
        elif self.error is not None:
            d["error"] = self.error
        return d


_TENANT_KEYS = ("submitted", "rejected", "completed", "cancelled", "failed",
                "eps_requested", "eps_finished")
_STATUS_KEY = {"done": "completed", "cancelled": "cancelled",
               "failed": "failed"}


class _FrontDoor:
    """Bounded admission queue feeding a SearchService, dequeued weighted
    round-robin across tenants.

    At most ``max_running`` jobs occupy service workers at once; the rest
    wait in per-tenant FIFO queues.  Each WRR turn grants a tenant
    ``weight`` consecutive dequeues before rotating, so relative long-run
    shares follow the weights while any single tenant's backlog depth is
    irrelevant to everyone else's wait.
    """

    def __init__(self, svc: SearchService, max_queue: int, max_running: int,
                 weights: Dict[str, int], default_weight: int = 1):
        self._svc = svc
        self.max_queue = int(max_queue)
        self.max_running = int(max_running)
        self._weights = dict(weights)
        self._default_weight = max(int(default_weight), 1)
        self._cv = threading.Condition()
        self._queues: Dict[str, deque] = {}
        self._order: List[str] = []     # tenants in first-seen order
        self._jobs: Dict[str, _Job] = {}
        self._uids = itertools.count()
        self._queued = 0
        self._running = 0
        self._rr_idx = 0
        self._rr_credit = 0
        self._rejected = 0
        self._tenants: Dict[str, Dict[str, int]] = {}
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="front-door-scheduler")
        self._thread.start()

    def _weight(self, tenant: str) -> int:
        return max(int(self._weights.get(tenant, self._default_weight)), 1)

    def _tenant_entry(self, tenant: str) -> Dict[str, int]:
        e = self._tenants.get(tenant)
        if e is None:
            e = self._tenants[tenant] = {k: 0 for k in _TENANT_KEYS}
        return e

    # -- client side --------------------------------------------------------
    def submit(self, request: api_types.SearchRequest, tenant: str) -> _Job:
        with self._cv:
            if self._closed:
                raise RuntimeError("front door is closed")
            e = self._tenant_entry(tenant)
            if self._queued >= self.max_queue:
                self._rejected += 1
                e["rejected"] += 1
                raise QueueFull(
                    f"admission queue full ({self._queued}/{self.max_queue})")
            job = _Job(str(next(self._uids)), tenant, request)
            q = self._queues.get(tenant)
            if q is None:
                q = self._queues[tenant] = deque()
                self._order.append(tenant)
                if len(self._order) == 1:
                    self._rr_credit = self._weight(tenant)
            q.append(job)
            self._jobs[job.uid] = job
            self._queued += 1
            e["submitted"] += 1
            e["eps_requested"] += request.eps
            obs_instrument.HTTP_QUEUE_DEPTH.set(self._queued)
            self._cv.notify_all()
        return job

    def get(self, uid: str) -> Optional[_Job]:
        with self._cv:
            return self._jobs.get(uid)

    def cancel(self, uid: str) -> Optional[_Job]:
        """Cancel a job: a still-queued one finishes right here; a running
        one is cancelled through its service ticket."""
        with self._cv:
            job = self._jobs.get(uid)
            if job is None:
                return None
            job.cancel_requested = True
            if job.ticket is None and job._status == "queued":
                self._queues[job.tenant].remove(job)
                self._queued -= 1
                self._finish_pre_ticket(job, "cancelled")
                obs_instrument.HTTP_QUEUE_DEPTH.set(self._queued)
                self._cv.notify_all()
                return job
            ticket = job.ticket
        if ticket is not None:
            ticket.cancel()
        return job

    def stats(self) -> dict:
        with self._cv:
            tenants = {}
            for t, e in self._tenants.items():
                d = dict(e)
                d["queued"] = len(self._queues.get(t, ()))
                d["weight"] = self._weight(t)
                tenants[t] = d
            return {"queued": self._queued, "running": self._running,
                    "rejected": self._rejected,
                    "max_queue": self.max_queue,
                    "max_running": self.max_running,
                    "jobs": len(self._jobs), "tenants": tenants}

    def close(self) -> None:
        with self._cv:
            self._closed = True
            # Queued jobs will never get a slot: terminate them so any
            # result()/progress waiter unblocks instead of hanging.
            for q in self._queues.values():
                while q:
                    job = q.popleft()
                    self._queued -= 1
                    self._finish_pre_ticket(job, "cancelled")
            self._cv.notify_all()
        self._thread.join(timeout=5.0)

    # -- scheduler side -----------------------------------------------------
    def _finish_pre_ticket(self, job: _Job, status: str,
                           error: Optional[str] = None) -> None:
        """Terminate a job that never reached the service (under _cv)."""
        job._status = status
        job.error = error
        job.finished_at = time.time()
        e = self._tenant_entry(job.tenant)
        e[_STATUS_KEY.get(status, "failed")] += 1
        job._done.set()

    def _next_job_locked(self) -> Optional[_Job]:
        """Weighted round-robin dequeue across tenants (under _cv)."""
        if not self._order or not any(self._queues.values()):
            return None
        n = len(self._order)
        for _ in range(n + 1):
            tenant = self._order[self._rr_idx % n]
            q = self._queues[tenant]
            if q and self._rr_credit > 0:
                self._rr_credit -= 1
                job = q.popleft()
                if not q or self._rr_credit == 0:
                    self._rr_idx += 1
                    self._rr_credit = self._weight(
                        self._order[self._rr_idx % n])
                return job
            self._rr_idx += 1
            self._rr_credit = self._weight(self._order[self._rr_idx % n])
        return None

    def _loop(self) -> None:
        while True:
            with self._cv:
                while (not self._closed
                       and (self._queued == 0
                            or self._running >= self.max_running)):
                    self._cv.wait()
                if self._closed:
                    return
                job = self._next_job_locked()
                if job is None:
                    continue
                self._queued -= 1
                self._running += 1
                obs_instrument.HTTP_QUEUE_DEPTH.set(self._queued)
            try:
                ticket = self._svc.submit(job.request)
            except Exception as e:  # noqa: BLE001 -- the job reports it
                with self._cv:
                    self._running -= 1
                    self._finish_pre_ticket(job, "failed", error=repr(e))
                    self._cv.notify_all()
                continue
            job.ticket = ticket
            if job.cancel_requested:    # cancelled in the hand-off window
                ticket.cancel()
            ticket.add_done_callback(
                lambda _t, job=job: self._job_finished(job))

    def _job_finished(self, job: _Job) -> None:
        job.finished_at = time.time()
        key = _STATUS_KEY.get(job.status, "failed")
        with self._cv:
            self._running -= 1
            e = self._tenant_entry(job.tenant)
            e[key] += 1
            if key == "completed":
                e["eps_finished"] += job.request.eps
            self._cv.notify_all()


# --------------------------------------------------------------------------
# The HTTP layer.
# --------------------------------------------------------------------------
class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "repro-search"

    def log_message(self, *args) -> None:   # route metrics, not stderr spam
        pass

    @property
    def hub(self) -> "SearchHTTPService":
        return self.server.hub  # type: ignore[attr-defined]

    # -- plumbing -----------------------------------------------------------
    def _send_json(self, code: int, obj: dict, headers=()) -> int:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)
        return code

    def _send_text(self, code: int, text: str, ctype: str) -> int:
        body = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
        return code

    def _chunk(self, text: str) -> None:
        data = text.encode()
        self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()

    def _observe(self, route: str, code: int, t0: float) -> None:
        obs_instrument.HTTP_REQUESTS.inc(route=route, code=str(code))
        obs_instrument.HTTP_REQUEST_SECONDS.observe(
            time.perf_counter() - t0, route=route)

    def _dispatch(self, verb: str) -> None:
        t0 = time.perf_counter()
        route, code = "other", 500
        try:
            route, code = self._route(verb)
        except (BrokenPipeError, ConnectionResetError):
            route, code = "disconnect", 0
        except Exception as e:  # noqa: BLE001 -- never kill the connection
            try:
                code = self._send_json(500, {"error": repr(e)})
            except OSError:
                pass
        finally:
            self._observe(route, code, t0)

    do_GET = lambda self: self._dispatch("GET")          # noqa: E731
    do_POST = lambda self: self._dispatch("POST")        # noqa: E731
    do_DELETE = lambda self: self._dispatch("DELETE")    # noqa: E731

    # -- routing ------------------------------------------------------------
    def _route(self, verb: str) -> Tuple[str, int]:
        parts = [p for p in self.path.split("?")[0].split("/") if p]
        if verb == "POST" and parts == ["v1", "search"]:
            return "/v1/search", self._post_search()
        if verb == "GET" and parts == ["v1", "stats"]:
            return "/v1/stats", self._send_json(200, self.hub.stats())
        if verb == "GET" and parts == ["metrics"]:
            return "/metrics", self._send_text(
                200, obs_metrics.REGISTRY.prometheus_text(),
                "text/plain; version=0.0.4")
        if len(parts) == 3 and parts[:2] == ["v1", "search"]:
            uid = parts[2]
            if verb == "GET":
                return "/v1/search/{uid}", self._get_search(uid)
            if verb == "DELETE":
                return "/v1/search/{uid}", self._delete_search(uid)
        if (len(parts) == 4 and parts[:2] == ["v1", "search"]
                and parts[3] == "progress" and verb == "GET"):
            return "/v1/search/{uid}/progress", self._stream_progress(
                parts[2])
        return "other", self._send_json(404, {"error": "no such route"})

    def _post_search(self) -> int:
        try:
            n = int(self.headers.get("Content-Length", 0))
            spec = json.loads(self.rfile.read(n) or b"{}")
            cfg = self.hub.http_cfg
            request, tenant = request_from_spec(
                spec, default_platform=cfg.default_platform,
                default_eps=cfg.default_eps,
                default_tenant=cfg.default_tenant,
                device=self.hub.service.cfg.device)
        except Exception as e:  # noqa: BLE001 -- malformed body
            return self._send_json(400, {"error": f"bad request: {e!r}"})
        try:
            job = self.hub.front.submit(request, tenant)
        except QueueFull as e:
            return self._send_json(
                429, {"error": str(e)},
                headers=[("Retry-After",
                          f"{self.hub.http_cfg.retry_after_s:g}")])
        return self._send_json(202, job.to_json(include_result=False))

    def _get_search(self, uid: str) -> int:
        job = self.hub.front.get(uid)
        if job is None:
            return self._send_json(404, {"error": f"no such search {uid}"})
        return self._send_json(200, job.to_json())

    def _delete_search(self, uid: str) -> int:
        job = self.hub.front.cancel(uid)
        if job is None:
            return self._send_json(404, {"error": f"no such search {uid}"})
        return self._send_json(200, {"uid": job.uid, "status": job.status,
                                     "cancel_requested": True})

    def _stream_progress(self, uid: str) -> int:
        job = self.hub.front.get(uid)
        if job is None:
            return self._send_json(404, {"error": f"no such search {uid}"})
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        poll = self.hub.http_cfg.progress_poll_s
        sent = 0
        while True:
            trials = job.ticket.trials if job.ticket is not None else ()
            while sent < len(trials):
                tr = trials[sent]
                sent += 1
                rec = {"step": tr.step, "value": tr.value,
                       "best_value": tr.best_value}
                if tr.shard is not None:
                    rec["shard"] = tr.shard
                self._chunk(json.dumps(rec) + "\n")
            if job.done():
                break
            time.sleep(poll)
        self._chunk(json.dumps({"status": job.status, "done": True}) + "\n")
        self._chunk("")   # 0\r\n\r\n terminator
        return 200


class SearchHTTPService:
    """The network front door: one SearchService + scheduler + HTTP server.

    ::

        with SearchHTTPService(http_cfg=HttpConfig(port=0)) as hub:
            hub.start()                      # serve on a background thread
            client = SearchClient(port=hub.port)
            uid = client.submit({"workload": "ncf", "method": "random",
                                 "eps": 300, "tenant": "alice"})["uid"]
            out = client.result(uid)

    Or ``serve_forever()`` on the main thread (the
    ``repro_torch.launch.serve_http`` CLI does exactly that).
    """

    def __init__(self, service_cfg: Optional[ServiceConfig] = None,
                 http_cfg: Optional[HttpConfig] = None,
                 service: Optional[SearchService] = None):
        self.http_cfg = http_cfg or HttpConfig()
        self.service = service if service is not None else SearchService(
            service_cfg or ServiceConfig())
        self._owns_service = service is None
        max_running = (self.http_cfg.max_running
                       if self.http_cfg.max_running is not None
                       else self.service.cfg.max_workers)
        self.front = _FrontDoor(self.service, self.http_cfg.max_queue,
                                max_running,
                                dict(self.http_cfg.tenant_weights),
                                self.http_cfg.default_weight)
        self.httpd = ThreadingHTTPServer(
            (self.http_cfg.host, self.http_cfg.port), _Handler)
        self.httpd.daemon_threads = True
        self.httpd.hub = self   # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self.httpd.server_address[0]
        return f"http://{host}:{self.port}"

    def start(self) -> "SearchHTTPService":
        """Serve on a daemon thread; returns self (fluent for tests)."""
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="http-front-door", daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._thread = threading.current_thread()
        self.httpd.serve_forever()

    def stats(self) -> dict:
        return {"service": self.service.stats(),
                "front_door": self.front.stats()}

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._thread is not None and self._thread is not \
                threading.current_thread():
            self.httpd.shutdown()
            self._thread.join(timeout=10.0)
        self.httpd.server_close()
        self.front.close()
        if self._owns_service:
            self.service.close()

    def __enter__(self) -> "SearchHTTPService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# --------------------------------------------------------------------------
# Minimal stdlib client (tests, CI smoke, benchmarks).
# --------------------------------------------------------------------------
class SearchClient:
    """Thin ``http.client`` wrapper speaking the front door's JSON dialect.

    One fresh connection per call (progress streams hold theirs open), so
    instances are safe to share across threads.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 8731,
                 timeout: float = 300.0):
        self.host = host
        self.port = int(port)
        self.timeout = timeout

    def _request(self, verb: str, path: str, body: Optional[dict] = None):
        import http.client

        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)
        try:
            payload = json.dumps(body).encode() if body is not None else None
            conn.request(verb, path, body=payload,
                         headers={"Content-Type": "application/json"}
                         if payload else {})
            resp = conn.getresponse()
            data = resp.read()
            return resp.status, dict(resp.getheaders()), data
        finally:
            conn.close()

    def submit(self, spec: dict) -> dict:
        """POST a search; raises :class:`QueueFull` on 429."""
        status, headers, data = self._request("POST", "/v1/search", spec)
        if status == 429:
            raise QueueFull(
                f"429: retry after {headers.get('Retry-After')}s")
        if status != 202:
            raise RuntimeError(f"submit failed: {status} {data!r}")
        return json.loads(data)

    def status(self, uid: str) -> dict:
        status, _, data = self._request("GET", f"/v1/search/{uid}")
        if status != 200:
            raise KeyError(f"search {uid}: {status} {data!r}")
        return json.loads(data)

    def cancel(self, uid: str) -> dict:
        status, _, data = self._request("DELETE", f"/v1/search/{uid}")
        if status != 200:
            raise KeyError(f"search {uid}: {status} {data!r}")
        return json.loads(data)

    def result(self, uid: str, timeout: float = 300.0,
               poll_s: float = 0.05) -> dict:
        """Poll until the search finishes; returns the result dict.
        Raises RuntimeError for cancelled/failed searches."""
        deadline = time.time() + timeout
        while True:
            d = self.status(uid)
            if d["status"] == "done":
                return d["result"]
            if d["status"] in ("cancelled", "failed"):
                raise RuntimeError(
                    f"search {uid} {d['status']}: {d.get('error')}")
            if time.time() > deadline:
                raise TimeoutError(f"search {uid} still {d['status']}")
            time.sleep(poll_s)

    def progress(self, uid: str):
        """Yield progress records from the chunked JSONL stream, the
        terminal ``{"status": ..., "done": true}`` record last."""
        import http.client

        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)
        try:
            conn.request("GET", f"/v1/search/{uid}/progress")
            resp = conn.getresponse()
            if resp.status != 200:
                raise KeyError(f"search {uid}: {resp.status}")
            for line in resp:   # http.client decodes the chunking
                line = line.strip()
                if line:
                    yield json.loads(line)
        finally:
            conn.close()

    def stats(self) -> dict:
        status, _, data = self._request("GET", "/v1/stats")
        if status != 200:
            raise RuntimeError(f"stats: {status}")
        return json.loads(data)

    def metrics_text(self) -> str:
        status, _, data = self._request("GET", "/metrics")
        if status != 200:
            raise RuntimeError(f"metrics: {status}")
        return data.decode()
