"""Faults planted in the program underneath a run, for the tests and for
``control.py --fault``: each is a context manager that breaks the timed
path where the fault would be made, and restores it on exit.

* ``adam_unchanged``: the policy's optimizer step returns its parameters
  unchanged (the step count still moves on);
* ``answer_value``: the returned objective is off by a factor 1 + 1e-4;
* ``answer_assignment``: the returned assignment puts every layer at the
  most PEs (160), the objective left as the search found it;
* ``ga_skipped``: stage 2 runs no generation and reports no history;
* ``ga_short``: stage 2 stops after a tenth of its generations;
* ``ga_frozen``: stage 2 selects and keeps its best but never changes its
  population (every generation returns its input population).
"""
from __future__ import annotations

import contextlib
from unittest import mock

import numpy as np


@contextlib.contextmanager
def adam_unchanged():
    from repro_torch.training import optim

    def update(self, grads, state, params):
        return ({k: p.clone() for k, p in params.items()},
                optim.OptState(state.step + 1, state.mu, state.nu))

    with mock.patch.object(optim.Adam, "update", update):
        yield


def _answer(alter):
    @contextlib.contextmanager
    def plant():
        from repro_torch.api import optimizers, types

        build = types.build_outcome

        def altered(request, method, best_value, pe, kt, df, *a, **kw):
            if pe is not None:
                best_value, pe = alter(best_value, pe)
            return build(request, method, best_value, pe, kt, df, *a, **kw)

        with mock.patch.object(optimizers, "_outcome", altered), \
                mock.patch.object(types, "build_outcome", altered):
            yield

    return plant


answer_value = _answer(lambda v, pe: (float(v) * (1 + 1e-4), pe))
answer_assignment = _answer(
    lambda v, pe: (v, np.full(np.shape(pe), 160.0, np.float32)))


@contextlib.contextmanager
def ga_skipped():
    import torch
    from repro_torch.core import ga

    def skipped(*a, **kw):
        state = ga.GAState(None, torch.tensor(float("inf")), None, None,
                           None)
        return state, np.asarray([], np.float32)

    with mock.patch.object(ga, "run_local_ga", skipped):
        yield


@contextlib.contextmanager
def ga_short():
    import dataclasses

    from repro_torch.core import ga

    whole = ga.run_local_ga

    def short(workload, ecfg, pe, kt, df, cfg, *a, **kw):
        cfg = dataclasses.replace(cfg, generations=max(
            cfg.generations // 10, 1))
        return whole(workload, ecfg, pe, kt, df, cfg, *a, **kw)

    with mock.patch.object(ga, "run_local_ga", short):
        yield


@contextlib.contextmanager
def ga_frozen():
    from repro_torch.core import ga

    make = ga.make_local_ga_engine

    def frozen_engine(*a, **kw):
        engine = make(*a, **kw)

        def evolve(state, fit):
            new, best = engine.evolve(state, fit)
            return new._replace(pop=state.pop), best

        return engine._replace(evolve=evolve)

    with mock.patch.object(ga, "make_local_ga_engine", frozen_engine):
        yield


FAULTS = {"adam_unchanged": adam_unchanged, "answer_value": answer_value,
          "answer_assignment": answer_assignment, "ga_skipped": ga_skipped,
          "ga_short": ga_short, "ga_frozen": ga_frozen}
