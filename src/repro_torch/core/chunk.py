"""The shared chunk loop every chunked engine drives through.

Port of ``repro.core.chunk`` without its telemetry: split ``total`` steps
into ``chunk``-sized pieces, run one piece, append its history, fire
``on_chunk(state, h, done)`` (the unified API's streaming point), repeat.
Engines sync with the device once per chunk, when a piece's history goes
to numpy.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np


def drive(state, total: int, chunk: Optional[int],
          run_chunk: Callable,
          on_chunk: Optional[Callable] = None,
          *,
          start: int = 0) -> Tuple[object, List]:
    """Run ``total - start`` more steps of ``run_chunk`` in chunks.

    run_chunk(state, n) -> (state, h): one piece of ``n`` steps.
    on_chunk(state, h, done): fires after every piece, with ``done``
        counted from ``start`` (an engine whose loop has a prologue, such
        as the relaxed engine's rounding-variant tail, offsets it).
    Returns ``(state, [h, ...])``.
    """
    chunk = (total - start) if not chunk else max(int(chunk), 1)
    hist: List = []
    done = start
    while done < total:
        n = min(chunk, total - done)
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
