"""Boot the HTTP search front door of the PyTorch port.

    # Serve on :8731 on the card with a persistent cost cache and 2:1
    # tenant weights:
    PYTHONPATH=src python -m repro_torch.launch.serve_http --device cuda \
        --port 8731 --workers 8 --cache-dir /var/cache/repro_torch \
        --tenant-weights batch=1,interactive=2

    # Then, from anywhere:
    curl -s localhost:8731/v1/search -d \
        '{"workload": "ncf", "method": "random", "eps": 300,
          "tenant": "interactive"}'
    curl -s localhost:8731/v1/search/0            # status / result
    curl -sN localhost:8731/v1/search/0/progress  # chunked JSONL stream
    curl -s localhost:8731/v1/stats
    curl -s localhost:8731/metrics                # Prometheus text

The flags are those of ``repro.launch.serve_http``, plus ``--device``
(default ``cuda``; without a card it fails, and nothing falls back to the
CPU; ``cpu`` runs the kernels' plain versions).  Every search runs on
that device.

Telemetry is enabled by default so the ``/metrics`` endpoint is live;
``--no-telemetry`` turns it off (requests still work, counters freeze).
``--cache-dir`` makes the per-point cost memo cache persistent: entries
flush to versioned shard files and reload on restart, so a warm restart
serves popular queries almost entirely from disk.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch import obs
from repro_torch.serving import (HttpConfig, SearchHTTPService, SearchService,
                                 ServiceConfig)


def _parse_weights(text: str):
    """``a=2,b=1`` -> (("a", 2), ("b", 1))."""
    if not text:
        return ()
    pairs = []
    for item in text.split(","):
        name, _, w = item.partition("=")
        pairs.append((name.strip(), int(w or 1)))
    return tuple(pairs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8731,
                    help="0 picks an ephemeral port")
    ap.add_argument("--workers", type=int, default=8,
                    help="search worker threads in the backing service")
    ap.add_argument("--dispatch-workers", type=int, default=1,
                    help="fused-dispatch pool size in the cost-eval batcher")
    ap.add_argument("--window-ms", type=float, default=2.0)
    ap.add_argument("--cache-dir", default="",
                    help="persist the cost memo cache here (versioned "
                    "shard files); warm restarts reload it")
    ap.add_argument("--cache-flush-every", type=int, default=4096,
                    help="flush the persistent cache every N fresh entries")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="admission queue bound; past it -> HTTP 429")
    ap.add_argument("--max-running", type=int, default=0,
                    help="concurrent searches (0: same as --workers)")
    ap.add_argument("--tenant-weights", default="",
                    help="WRR weights, e.g. batch=1,interactive=4")
    ap.add_argument("--default-weight", type=int, default=1)
    ap.add_argument("--platform", default="cloud",
                    choices=["unlimited", "cloud", "iot", "iotx"])
    ap.add_argument("--eps", type=int, default=600,
                    help="default eval budget for bodies that omit eps")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the service runs; cuda fails without a card")
    ap.add_argument("--no-telemetry", action="store_true",
                    help="skip enabling repro_torch.obs (freezes /metrics)")
    args = ap.parse_args(argv)

    if not args.no_telemetry:
        obs.enable(trace=True)

    svc_cfg = ServiceConfig(max_workers=args.workers,
                            window_ms=args.window_ms,
                            device=args.device,
                            dispatch_workers=args.dispatch_workers,
                            cache_dir=args.cache_dir or None,
                            cache_flush_every=args.cache_flush_every)
    http_cfg = HttpConfig(host=args.host, port=args.port,
                          max_queue=args.max_queue,
                          max_running=args.max_running or None,
                          tenant_weights=_parse_weights(args.tenant_weights),
                          default_weight=args.default_weight,
                          default_eps=args.eps,
                          default_platform=args.platform)
    service = SearchService(svc_cfg)
    hub = SearchHTTPService(http_cfg=http_cfg, service=service)
    cache_note = (f", cache-dir {args.cache_dir} "
                  f"({len(service.cache)} entries warm)"
                  if args.cache_dir else "")
    print(f"search front door on {hub.url} "
          f"({args.workers} workers, device {args.device}{cache_note})",
          flush=True)
    try:
        hub.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        hub.close()
        service.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
