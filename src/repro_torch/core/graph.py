"""One step of an engine captured as a CUDA graph and replayed.

The port's counterpart of a jitted step in the reference: the step's few
thousand small launches are recorded once and then replayed by one call,
so the host no longer dispatches them one by one.  What a replay computes
is fixed at capture: the step must read and write the same tensors every
time (its state lives in static buffers, updated in place) and must not
sync with the host.

The kernels' wrappers count their launches (``ops.launch_counts``).
Launches made while warming up or capturing are recorded on the side
stream instead of counted; each replay then counts the launches its
capture recorded.  A capture that fails raises: nothing falls back to
running the step eagerly.

With telemetry on, each capture is one ``graph.capture`` span: its
warm-up calls (their host time ``warmup_us``), the capture itself and
the graph's instantiation, and the port-kernel launches the capture
recorded (``launches``).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Sequence

import torch

from repro_torch.kernels import build
from repro_torch.obs import trace as obs_trace

# Calls of the warm-up before a capture.
WARMUPS = 3
# One capture at a time in this process: a capture starts with a device
# synchronize, which must not meet another thread's capture under way.
_capture_lock = threading.Lock()
_stream_lock = threading.Lock()


def _capture_stream(device) -> "torch.cuda.Stream":
    """A side stream for one warm-up and capture, entered in
    ``build.recording`` with an empty record.

    PyTorch hands out the streams of a pool in turn, 32 a priority.  A
    capture takes its stream from the high-priority pool, which nothing
    else in the port draws on, so no thread's working stream (a fanout
    worker's, a batcher dispatcher's) is ever a stream under capture; and
    it skips a stream that another capture under way still records on.
    """
    with _stream_lock:
        for _ in range(64):
            stream = torch.cuda.Stream(device, priority=-1)
            if stream.cuda_stream not in build.recording:
                build.recording[stream.cuda_stream] = {}
                return stream
    raise RuntimeError("every high-priority stream is under capture")


class CapturedStep:
    """``fn`` captured on ``device`` after :data:`WARMUPS` calls of
    ``warmup``.

    ``warmup`` runs the same work as ``fn`` on other buffers (cuBLAS and
    autograd set themselves up on the first calls, which must not run
    under capture).  ``generators`` are the CUDA generators ``fn`` draws
    from: each replay draws what an eager call would draw next, and
    advances them as that call would.
    """

    def __init__(self, fn: Callable[[], None], warmup: Callable[[], None],
                 device, generators: Sequence[torch.Generator] = ()):
        device = torch.device(device)
        self.graph = torch.cuda.CUDAGraph()
        self.launches: Dict[str, int] = {}
        with obs_trace.span("graph.capture") as sp:
            # The warm-up's launches go to this stream's record: dropped.
            stream = _capture_stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
            key = stream.cuda_stream
            try:
                t0 = time.perf_counter_ns()
                with torch.cuda.stream(stream):
                    for _ in range(WARMUPS):
                        warmup()
                sp.set(warmup_us=round((time.perf_counter_ns() - t0) / 1e3,
                                       3))
                torch.cuda.current_stream(device).wait_stream(stream)
                build.recording[key] = self.launches
                for gen in generators:
                    self.graph.register_generator_state(gen)
                # Other threads (the search service's workers) may use the
                # card during the capture; only this thread is held to its
                # rules.
                with _capture_lock, torch.cuda.graph(
                        self.graph, stream=stream,
                        capture_error_mode="thread_local"):
                    fn()
            finally:
                build.recording.pop(key, None)
            sp.set(launches=sum(self.launches.values()))

    def replay(self) -> None:
        self.graph.replay()
        build.add_launches(self.launches)
