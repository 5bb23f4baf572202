"""Serving in the PyTorch port: the search service and the LM engine.

  cost_cache     -- per-point memo cache (in memory, or persistent shards)
  batcher        -- cross-request cost-eval batcher (per-row cost kernel)
  search_service -- SearchService / SearchTicket / ServiceConfig
  http_service   -- the HTTP/JSON front door over the service
                    (SearchHTTPService / SearchClient / HttpConfig)
  engine         -- batched greedy LM decoding for every family
                    (Engine / ServeConfig / Request, flash-decode kernel)
"""
from repro_torch.serving.batcher import CostEvalBatcher  # noqa: F401
from repro_torch.serving.cost_cache import (  # noqa: F401
    CostMemoCache,
    PersistentCostCache,
)
from repro_torch.serving.engine import (  # noqa: F401
    Engine,
    Request,
    ServeConfig,
    synthetic_requests,
)
from repro_torch.serving.http_service import (  # noqa: F401
    HttpConfig,
    QueueFull,
    SearchClient,
    SearchHTTPService,
    outcome_to_json,
    request_from_spec,
)
from repro_torch.serving.search_service import (  # noqa: F401
    BATCHED_METHODS,
    RAW_BATCHED_METHODS,
    SearchCancelled,
    SearchService,
    SearchTicket,
    ServiceConfig,
)
