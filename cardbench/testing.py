"""Helpers of the benchmark's own tests: a copy of the benchmark's data at a
size the CPU runs in seconds, and programs planted in place of the port's.

Only the season is cut (few, short games); every width is the
configuration's own.
"""

from __future__ import annotations

import importlib
import json
import shutil
from pathlib import Path
from typing import Any, Dict

import torch

from . import reference
from .spec import ROOT

#: The traffic parameters a tiny copy replaces.
TINY = {
    'season-rate': {'season_games': 16, 'actions': 128, 'valid_low': 90, 'valid_high': 128,
                    'stratum_games': 8, 'games_per_call': 4, 'samples': 3, 'trace_seconds': 0.3},
    'scenario-grid': {'season_games': 16, 'actions': 128, 'valid_low': 90, 'valid_high': 128,
                      'stratum_games': 8, 'games_per_call': 4, 'samples': 3, 'trace_seconds': 0.3,
                      'grid': {'builder': 'end_location', 'nx': 3, 'ny': 2}},
}


def tiny_root(dest: Path) -> Path:
    """``BENCHMARK.json`` and the benchmark's data files copied under
    ``dest``, with each traffic mix cut to :data:`TINY`."""
    dest = Path(dest)
    shutil.copy(ROOT / 'BENCHMARK.json', dest / 'BENCHMARK.json')
    for kind in ('configs', 'traffic', 'cells', 'metrics', 'drivers'):
        shutil.copytree(ROOT / 'cardbench' / kind, dest / 'cardbench' / kind,
                        ignore=shutil.ignore_patterns('__pycache__'))
    for name, cut in TINY.items():
        path = dest / 'cardbench' / 'traffic' / f'{name}.json'
        traffic = json.loads(path.read_text())
        traffic.update(cut)
        path.write_text(json.dumps(traffic))
    return dest


def batch_fields(model: reference.Model, batch: Any) -> Dict[str, torch.Tensor]:
    return {n: getattr(batch, n) for n in model.family.FIELDS}


def plant_control(monkeypatch: Any, spec: Any) -> None:
    """Put the control (the reference in float32 with TF32 products) in the
    program's place: the adapter's ``build`` returns the reference model, and
    the entry of each driver of ``spec`` computes the control's values of the
    batch it is given."""
    def build(config, weights, mean, std, device):
        family, head = reference.modules(config)
        return reference.Model(family, head, config, weights, mean, std)

    def rate(model, batch):
        return reference.values(model, batch_fields(model, batch), control=True)

    def rate_scenarios(model, batch, grid):
        updates = {n: [float(v) for v in u] for n, u in grid.field_updates.items()}
        fields = reference.perturbed(batch_fields(model, batch), updates)
        values = reference.values(model, fields, control=True)
        return values.reshape(len(next(iter(updates.values()))), batch.n_games, *values.shape[1:])

    monkeypatch.setattr(importlib.import_module('cardbench.adapters.vaep_mlp'), 'build', build)
    monkeypatch.setattr(spec.driver('rate'), 'entry', rate)
    monkeypatch.setattr(spec.driver('scenario'), 'entry', rate_scenarios)


def plant_fault(monkeypatch: Any, spec: Any, fault: str, warm_calls: int) -> None:
    """Break the program's values where they are produced, in the entry of
    each driver of ``spec``: ``'half'`` leaves the second half of the games
    out (their values zero), ``'altered'`` moves one value of every call by
    1e-4, ``'raises'`` makes every call after the warm-up's fail."""
    calls = [0]

    def broken(values: torch.Tensor) -> torch.Tensor:
        calls[0] += 1
        if fault == 'raises' and calls[0] <= warm_calls:
            return values
        values = values.clone()
        if fault == 'half':
            games = values.shape[-3]
            values[..., games // 2:, :, :] = 0.0
        elif fault == 'altered':
            values.view(-1)[7] += 1e-4
        else:
            raise RuntimeError('planted failure')
        return values

    for kind in ('rate', 'scenario'):
        driver = spec.driver(kind)
        entry = driver.entry
        monkeypatch.setattr(driver, 'entry', lambda *a, entry=entry: broken(entry(*a)))
