"""Serving in the PyTorch port: the search service and the LM engine.

  cost_cache     -- per-point memo cache (in memory, or persistent shards)
  batcher        -- cross-request cost-eval batcher (per-row cost kernel)
  search_service -- SearchService / SearchTicket / ServiceConfig
  engine         -- batched greedy LM decoding for the dense family
                    (Engine / ServeConfig / Request, flash-decode kernel)

The reference's HTTP front door is not ported yet.
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
from repro_torch.serving.search_service import (  # noqa: F401
    BATCHED_METHODS,
    RAW_BATCHED_METHODS,
    SearchCancelled,
    SearchService,
    SearchTicket,
    ServiceConfig,
)
