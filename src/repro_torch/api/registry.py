"""String-keyed optimizer registry: ``get_optimizer("two_stage"|...)``.

Port of ``repro.api.registry``.  The built-in adapters live in
:mod:`repro_torch.api.optimizers`, imported on first lookup; with
:mod:`repro_torch.obs` telemetry on, ``run_search`` fills
``SearchOutcome.telemetry``.
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict, Protocol, Tuple, runtime_checkable

from repro_torch.api.types import SearchOutcome, SearchRequest
from repro_torch.obs import recorder as obs_recorder
from repro_torch.obs import state as obs_state
from repro_torch.obs import trace as obs_trace

# Modules that register optimizers as an import side effect.
_PLUGIN_MODULES = (
    "repro_torch.api.optimizers",
    "repro_torch.distributed.dist_search",
)

_FACTORIES: Dict[str, Callable[[], "Optimizer"]] = {}
_ALIASES: Dict[str, str] = {}
_loaded = False


@runtime_checkable
class Optimizer(Protocol):
    """Anything with a ``name`` and ``run(SearchRequest) -> SearchOutcome``."""

    name: str

    def run(self, request: SearchRequest) -> SearchOutcome:
        ...


def register(name: str, *, aliases: Tuple[str, ...] = ()):
    """Class/factory decorator adding an optimizer under ``name``."""

    def deco(factory: Callable[[], Optimizer]):
        if name in _FACTORIES:
            raise ValueError(f"optimizer {name!r} already registered")
        _FACTORIES[name] = factory
        for alias in aliases:
            _ALIASES[alias] = name
        return factory

    return deco


def _load_plugins() -> None:
    global _loaded
    if _loaded:
        return
    for mod in _PLUGIN_MODULES:
        importlib.import_module(mod)
    _loaded = True


def get_optimizer(name: str) -> Optimizer:
    """Resolve a registered optimizer by name (or alias) and instantiate it."""
    _load_plugins()
    key = _ALIASES.get(name, name)
    if key not in _FACTORIES:
        raise KeyError(
            f"unknown optimizer {name!r}; registered: "
            f"{', '.join(sorted(_FACTORIES))}")
    return _FACTORIES[key]()


def list_optimizers() -> Tuple[str, ...]:
    """All registered canonical names (aliases excluded), sorted."""
    _load_plugins()
    return tuple(sorted(_FACTORIES))


def run_search(request: SearchRequest) -> SearchOutcome:
    """One-call entry point: dispatch ``request`` to ``request.method``.

    With :mod:`repro_torch.obs` telemetry on, the run executes under a
    fresh :class:`~repro_torch.obs.recorder.FlightRecorder` (installed
    thread-locally, so concurrent service searches each get their own)
    inside a ``search.run`` span, and the recorder's summary lands on
    ``outcome.telemetry``.  Telemetry is observational only: the outcome
    is byte-identical with it on or off.
    """
    opt = get_optimizer(request.method)
    if not obs_state.enabled:
        return opt.run(request)
    rec = obs_recorder.FlightRecorder(engine=opt.name)
    with obs_recorder.recording(rec), \
            obs_trace.span("search.run", method=opt.name, eps=request.eps,
                           seed=request.seed):
        out = opt.run(request)
    out.telemetry = rec.summary()
    return out
