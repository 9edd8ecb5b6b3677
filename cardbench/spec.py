"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the root names each cell's configuration and traffic
mix and each metric. Everything else is a file of its own under
``cardbench/``, found by that name, so that a new configuration, mix or
metric is a new file plus a new entry, and no existing file changes:

- ``configs/<config>.json``: the configuration's sizes; its ``family``,
  ``head`` and ``adapter`` name the modules under ``families/``, ``heads/``
  and ``adapters/`` that hold its reference and its call into the program
  (loaded from their files, :meth:`Spec.module`);
- ``traffic/<traffic>.json``: the mix's parameters (:mod:`cardbench.traffic`);
- ``drivers/<kind>.py``: the ``Load`` class that calls the program for the
  mixes of that ``kind`` (a subclass of :class:`cardbench.traffic.ClosedLoop`);
- ``cells/<workload>.json``: the limits that decide ``correct`` in the cell;
- ``metrics/<metric>.py``: a reader with ``read(run) -> float | None``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, List

#: The repository root: the directory above this package.
ROOT = Path(__file__).resolve().parent.parent
#: Modules loaded from their files, by resolved path: one module object a file.
_MODULES: Dict[Path, Any] = {}


def load_file(path: Path) -> Any:
    """The module of the Python file ``path``, loaded once."""
    path = Path(path).resolve()
    if path not in _MODULES:
        spec = importlib.util.spec_from_file_location(f'cardbench_file_{len(_MODULES)}', path)
        if spec is None or spec.loader is None or not path.is_file():
            raise FileNotFoundError(path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _MODULES[path] = module
    return _MODULES[path]


class Spec:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path = ROOT) -> None:
        self.root = Path(root)
        self.bench = json.loads((self.root / 'BENCHMARK.json').read_text())
        self.workloads = {w['name']: w for w in self.bench['workloads']}

    def _json(self, kind: str, name: str) -> Dict[str, Any]:
        return json.loads((self.root / 'cardbench' / kind / f'{name}.json').read_text())

    def workload(self, name: str) -> Dict[str, Any]:
        if name not in self.workloads:
            raise KeyError(f'no workload {name!r} in BENCHMARK.json; it has {sorted(self.workloads)}')
        return self.workloads[name]

    def config(self, name: str) -> Dict[str, Any]:
        return self._json('configs', name)

    def traffic(self, name: str) -> Dict[str, Any]:
        return self._json('traffic', name)

    def limits(self, workload: str) -> Dict[str, float]:
        return self._json('cells', workload)['limits']

    def metrics(self, workload: str, per_layer: bool) -> List[Dict[str, Any]]:
        """The metrics a run of ``workload`` reports: its end-to-end metrics,
        or with ``per_layer`` the per-layer metrics that list it (or, with no
        list, that move an end-to-end metric it reports)."""
        def applies(m: Dict[str, Any]) -> bool:
            return 'workloads' not in m or workload in m['workloads']

        e2e = [m for m in self.bench['end_to_end'] if applies(m)]
        if not per_layer:
            return e2e
        moved = {m['name'] for m in e2e}
        return [m for m in self.bench['per_layer']
                if workload in m.get('workloads', []) or ('workloads' not in m and m['moves'] in moved)]

    def reader(self, metric: str) -> Any:
        """The ``read`` function of ``metrics/<metric>.py``."""
        return load_file(self.root / 'cardbench' / 'metrics' / f'{metric}.py').read

    def module(self, kind: str, name: str) -> Any:
        """The module ``cardbench/<kind>/<name>.py`` of this root: an action
        language (``families``), a head kind (``heads``), a program adapter
        (``adapters``) or a traffic kind's driver (``drivers``)."""
        return load_file(self.root / 'cardbench' / kind / f'{name}.py')

    def modules(self, config: Dict[str, Any]) -> Any:
        """``(family, head, adapter)``: the modules a configuration names."""
        return (self.module('families', config['family']), self.module('heads', config['head']),
                self.module('adapters', config['adapter']))

    def driver(self, kind: str) -> Any:
        """The module ``drivers/<kind>.py``, whose ``Load`` calls the program
        for the traffic mixes of that kind."""
        return self.module('drivers', kind)
