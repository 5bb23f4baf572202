"""The search service of the PyTorch port: ConfuciuX-as-a-service.

  cost_cache     -- per-point memo cache (in memory, or persistent shards)
  batcher        -- cross-request cost-eval batcher (per-row cost kernel)
  search_service -- SearchService / SearchTicket / ServiceConfig

The reference's LM engine and HTTP front door are not ported yet.
"""
from repro_torch.serving.batcher import CostEvalBatcher  # noqa: F401
from repro_torch.serving.cost_cache import (  # noqa: F401
    CostMemoCache,
    PersistentCostCache,
)
from repro_torch.serving.search_service import (  # noqa: F401
    BATCHED_METHODS,
    RAW_BATCHED_METHODS,
    SearchCancelled,
    SearchService,
    SearchTicket,
    ServiceConfig,
)
