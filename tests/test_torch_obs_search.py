"""The port's spans and counters inside a search, on the CPU.

A traced ``two_stage`` search records its set-up as ``search.prepare``
spans and its stage-2 chunks' host time by phase; ``obs.current()`` hands
an engine the span to attach counters to; a span is mirrored into a
recording ``torch.profiler`` on the profiler's clock; and the benchmark's
readers of these spans and counters (``perfbench/metrics``) on made-up
runs.  The card's side (``graph.capture``, ``device_us``) is in
tests/test_torch_cuda.py.
"""
import os
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import api, obs
from repro_torch.core import env as env_lib
from repro_torch.obs import trace as trace_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from perfbench import harness  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_obs():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def _two_stage(**kw):
    return api.SearchRequest(
        workload="ncf", env=env_lib.EnvConfig(platform="cloud"), eps=8,
        seed=4, method="two_stage",
        options={"ga": {"population": 8, "generations": 10}}, device="cpu",
        **kw)


def test_traced_two_stage_records_set_up_and_stage2_phases():
    obs.enable(trace=True)
    out = api.run_search(_two_stage(progress_every=16,
                                    on_progress=lambda t: None))
    spans = obs.tracer().spans()
    prepare = [s for s in spans if s["name"] == "search.prepare"]
    assert sorted(s["attrs"]["part"] for s in prepare) == \
        ["env", "ga", "policy"]
    assert all(s["parent"] == "search.run" for s in prepare)
    chunks = [s for s in spans if s["name"] == "search.chunk"]
    assert all(s["parent"] == "search.run" for s in chunks)
    ga = [c for c in chunks if c["attrs"]["engine"] == "local_ga"]
    assert len(ga) == 5                   # 10 generations, 2 a chunk
    for c in ga:
        a = c["attrs"]
        assert min(a["fitness_us"], a["evolve_us"]) > 0
        assert a["fitness_us"] + a["evolve_us"] <= c["dur_us"]
    assert not any("device_us" in c["attrs"] or "stream_us" in c["attrs"]
                   for c in chunks)
    assert not any(s["name"] == "graph.capture" for s in spans)
    # Stage 1's assignment rides in the outcome, where the GA starts.
    for k in ("pe", "kt", "df"):
        assert out.extras[f"stage1_{k}"].shape == out.pe.shape


def test_untraced_two_stage_has_the_traced_bytes():
    plain = api.run_search(_two_stage())
    obs.enable(trace=True)
    traced = api.run_search(_two_stage())
    assert plain.history.tobytes() == traced.history.tobytes()
    for k in ("ga_history", "stage1_pe", "stage1_kt", "stage1_df"):
        assert plain.extras[k].tobytes() == traced.extras[k].tobytes(), k


def test_current_is_the_innermost_open_span():
    assert obs.current() is obs.NULL_SPAN
    with obs.span("search.run"):
        assert obs.current() is obs.NULL_SPAN      # telemetry off
    obs.enable(trace=True)
    assert obs.current() is obs.NULL_SPAN          # no span open
    with obs.span("search.run") as outer:
        assert obs.current() is outer
        with obs.span("search.chunk") as inner:
            assert obs.current() is inner
            obs.current().set(evolve_us=2.5)
        assert obs.current() is outer
    assert obs.current() is obs.NULL_SPAN
    (chunk, _) = obs.tracer().spans()
    assert chunk["attrs"] == {"evolve_us": 2.5}
    obs.disable()
    assert obs.current() is obs.NULL_SPAN


def _profiled_events(name, n):
    """``n`` spans ``name`` (the first a warm-up) under a CPU profiler;
    their records and the profiler's events of that name."""
    from torch.profiler import ProfilerActivity, profile

    obs.enable(trace=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(n):
            with obs.span(name):
                torch.ones(4).sum()
    events = sorted((e.start_ns(), e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == name)
    return [s for s in obs.tracer().spans() if s["name"] == name], events


def test_span_is_mirrored_into_the_profiler_on_its_clock():
    spans, events = _profiled_events("search.chunk", 4)
    assert len(events) == len(spans) == 4
    for s, (start_ns, dur_ns) in list(zip(spans, events))[1:]:
        assert abs(s["ts_us"] - start_ns / 1e3) < 100, (s, start_ns)
        # The range encloses the span.
        assert dur_ns / 1e3 >= s["dur_us"]


def test_span_is_not_mirrored_without_a_profiler():
    obs.enable(trace=True)
    with obs.span("search.chunk") as sp:
        assert sp._mirror is None


def test_tracer_takes_its_clock_anchor_when_created():
    a = trace_mod.Tracer()
    b = trace_mod.Tracer()
    assert b._t0_ns > a._t0_ns
    for t in (a, b):
        with t.span("x"):
            pass
    # Both anchors put the same instant within a millisecond of each other.
    assert abs(a.spans()[0]["ts_us"] - b.spans()[0]["ts_us"]) < 1e3


# ---------------------------------------------------------------------------
# The benchmark's readers of these spans and counters.
# ---------------------------------------------------------------------------
def _span(name, ts, dur, tid=1, **attrs):
    return {"name": name, "ts_us": ts, "dur_us": dur, "tid": tid,
            "depth": 0, "attrs": attrs}


def _run(spans):
    return harness.RunData(None, 0.0, 0.0, 2, spans, [])


def _chunk(ts, dur, engine, steps, tid=1, **counters):
    return _span("search.chunk", ts, dur, tid, engine=engine, start=0,
                 steps=steps, **counters)


# Two searches on thread 1, and spans outside them: another thread's
# search.run-less capture, and one past the second search's end.
SPANS = [
    _span("search.run", 0, 10_000),
    _span("search.prepare", 10, 100, part="env"),
    _span("search.prepare", 120, 300, part="policy"),
    _span("graph.capture", 500, 2_000),
    _chunk(3_000, 4_000, "reinforce", 500, device_us=3_500.0,
           stream_us=3_600.0),
    _span("search.prepare", 7_100, 50, part="ga"),
    _chunk(7_200, 2_000, "local_ga", 1_000, fitness_us=600.0,
           evolve_us=1_000.0),
    _span("search.run", 20_000, 10_000),
    _span("search.prepare", 20_010, 150, part="env"),
    _span("graph.capture", 20_500, 3_000),
    _chunk(24_000, 4_000, "reinforce", 1_500, device_us=8_500.0,
           stream_us=8_700.0),
    _chunk(28_100, 1_800, "local_ga", 1_000, fitness_us=400.0,
           evolve_us=800.0),
    _span("graph.capture", 20_500, 9_000, tid=2),
    _span("search.prepare", 29_950, 100, part="env"),
]

READERS = {
    "capture_ms": (2_000 + 3_000) / 2 / 1e3,
    "prepare_ms": (100 + 300 + 50 + 150) / 2 / 1e3,
    "stage1_device_ms": (3_500 + 8_500) / 2_000 / 1e3,
    "stage2_fitness_ms": (600 + 400) / 2_000 / 1e3,
    "stage2_evolve_ms": (1_000 + 800) / 2_000 / 1e3,
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_on_a_made_up_run(name):
    read = harness.reader(Path(REPO), name)
    assert read(_run(SPANS)) == pytest.approx(READERS[name])


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_finds_nothing_without_its_spans(name):
    """The parent's spans (search.run and bare chunks) and no spans at
    all: nothing to read, and no error."""
    read = harness.reader(Path(REPO), name)
    parent = [_span("search.run", 0, 10_000),
              _chunk(3_000, 4_000, "reinforce", 500),
              _chunk(7_200, 2_000, "local_ga", 1_000)]
    assert read(_run(parent)) is None
    assert read(_run([])) is None
