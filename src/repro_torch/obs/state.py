"""Process-wide observability switch shared by every ``repro_torch.obs``
module.

Port of ``repro.obs.state``.  One mutable module holds the single source
of truth for "is telemetry on", so the hot-path check is a module-attribute
load plus a bool test -- ``if not state.enabled: return`` -- and flipping
the switch affects every instrumented call site at once.  Everything here
is observational: enabling or disabling telemetry never changes a search
result (asserted registry-wide in tests/test_torch_conformance.py).
"""
from __future__ import annotations

from typing import Optional

# The one switch.  False (the default) turns every obs primitive into a
# near-free no-op: metric updates return immediately, ``span`` yields a
# shared null context manager, and no recorder is installed.
enabled: bool = False

# The active Tracer (``repro_torch.obs.trace.Tracer``) or None.  Spans are
# only recorded when BOTH ``enabled`` is True and a tracer is installed.
tracer: Optional[object] = None
