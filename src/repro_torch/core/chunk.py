"""The shared chunk loop every chunked engine drives through.

Port of ``repro.core.chunk``: split ``total`` steps into ``chunk``-sized
pieces, run one piece, append its history, fire ``on_chunk(state, h,
done)`` (the unified API's streaming point), repeat.  Engines sync with
the device once per chunk, when a piece's history goes to numpy.

Per-chunk telemetry lives here too: one engine-tagged ``search.chunk``
span per chunk, ``n * evals_per_step`` hard evaluations counted, and the
chunk's wall-clock in the current flight recorder.  The span closes after
``run_chunk`` has returned its history on the host, so it covers the
chunk's device work without a sync of its own, and it stays outside any
captured CUDA graph (a graph replays only what ran on the device).
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.obs import instrument as obs_instrument
from repro_torch.obs import state as obs_state
from repro_torch.obs import trace as obs_trace


def drive(state, total: int, chunk: Optional[int],
          run_chunk: Callable,
          on_chunk: Optional[Callable] = None,
          *,
          engine: str,
          evals_per_step: int = 1,
          start: int = 0) -> Tuple[object, List]:
    """Run ``total - start`` more steps of ``run_chunk`` in chunks.

    run_chunk(state, n) -> (state, h): one piece of ``n`` steps.
    on_chunk(state, h, done): fires after every piece, with ``done``
        counted from ``start`` (an engine whose loop has a prologue, such
        as the relaxed engine's rounding-variant tail, offsets it).
    engine / evals_per_step: telemetry tags -- each chunk of ``n`` steps
        accounts ``n * evals_per_step`` hard evaluations (GA generations
        evaluate a population per step, RL epochs E episodes, SA one).
    Returns ``(state, [h, ...])``.
    """
    chunk = (total - start) if not chunk else max(int(chunk), 1)
    hist: List = []
    done = start
    while done < total:
        n = min(chunk, total - done)
        if obs_state.enabled:
            t0 = time.perf_counter()
            with obs_trace.span("search.chunk", engine=engine, start=done,
                                steps=n, evals=n * evals_per_step):
                state, h = run_chunk(state, n)
            obs_instrument.chunk_metrics(engine, n, n * evals_per_step,
                                         time.perf_counter() - t0)
        else:
            state, h = run_chunk(state, n)
        hist.append(h)
        done += n
        if on_chunk is not None:
            on_chunk(state, h, done)
    return state, hist


def concat_hist(hist: List) -> np.ndarray:
    """Concatenate per-chunk history arrays ((0,) f32 when no chunks ran)."""
    return (np.concatenate(hist) if hist else np.empty((0,), np.float32))


def concat_hist_dict(hist: List) -> dict:
    """Concatenate per-chunk history dicts key-wise (RL-family metrics)."""
    if not hist:
        return {}
    return {k: np.concatenate([h[k] for h in hist]) for k in hist[0]}
