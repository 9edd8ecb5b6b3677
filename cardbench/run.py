"""Run one cell of the port's benchmark on one card and print its result.

    python3 -m cardbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic mix,
its limits and its metrics are found by name (:mod:`cardbench.spec`). A run:

1. set-up, which ``setup_s`` times from the process's start: the port's
   import and its kernels (built by ``nvcc`` into ``build/kernels`` of the
   checkout on a first run, loaded after), the season and the weights drawn
   from ``--seed`` on the card, the port's model built from those weights,
   and a warm-up of the cell's shapes;
2. a window of ``--seconds``, driven by the traffic kind's driver
   (``cardbench/drivers/<kind>.py``; by default one caller in a closed
   loop, each call's values copied to the host before the next). With ``--trace 1`` the profiler runs over the first ``trace_seconds`` of
   it and the run reports the per-layer metrics;
3. the check: a sample of the window's answers, drawn from the seed, held
   to the plain reference once the program is freed (:mod:`cardbench.reference`);
4. the result: each compared number beside its limit as the last lines of
   standard error, and one JSON line on standard output.

It exits non-zero and prints no result without enough CUDA cards, or if
JAX, flax or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import sys
import time
from types import SimpleNamespace
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import reference, spec as specmod, trace as tracemod, traffic as trafficmod

#: Top-level module names that must not be loaded in a run.
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'socceraction_tpu')
#: Build and kernel caches of the program, at fixed paths in the checkout.
CACHE_DIRS = {
    'SOCCERACTION_TPU_COMPILE_CACHE': 'build/kernels',
    'TRITON_CACHE_DIR': 'build/triton',
    'TORCH_EXTENSIONS_DIR': 'build/torch_extensions',
    'CUDA_CACHE_PATH': 'build/nv',
}
#: Calls that warm the cell's shapes before the window.
WARM_CALLS = 3
#: Games of the season whose features give the standardization.
STAT_GAMES = 8


def process_start() -> float:
    """The boot-clock second at which this process started."""
    try:
        with open('/proc/self/stat') as f:
            ticks = int(f.read().rsplit(')', 1)[1].split()[19])
        return ticks / os.sysconf('SC_CLK_TCK')
    except (OSError, ValueError, IndexError):
        return time.clock_gettime(time.CLOCK_BOOTTIME)


def set_precision() -> None:
    """Full float32 products: the configurations state TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')


def sync(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def prepare(spec: specmod.Spec, name: str, seed: int, device: torch.device,
            program: bool = True) -> SimpleNamespace:
    """Draw a cell's season and weights from ``seed`` on ``device`` and (with
    ``program``) build the port's model and the caller of its traffic: the
    cell's entry, configuration and traffic, the season, the reference model
    and the loaded caller."""
    cell = spec.workload(name)
    config, traffic = spec.config(cell['config']), spec.traffic(cell['traffic'])
    family, head = reference.modules(config)
    adapter = importlib.import_module(f"cardbench.adapters.{config['adapter']}")
    set_precision()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    season = trafficmod.make_season(family, traffic, gen, rng, device)
    # the standardization: the reference's features of the season's first games
    sample = slice(0, STAT_GAMES)
    mean, std, onehot = reference.standardization(
        family, config, {n: t[sample] for n, t in season.fields.items()}, season.mask[sample])
    weights = head.make(gen, config['hidden'], onehot, std, device)
    model = reference.Model(family, head, config, weights, mean, std)
    built = adapter.build(config, weights, mean, std, device) if program else None
    load = spec.driver(traffic['kind']).Load(traffic, config, adapter, built, season, family, rng, device)
    return SimpleNamespace(cell=cell, config=config, traffic=traffic, season=season, model=model,
                load=load)


def run_cell(spec: specmod.Spec, name: str, seed: int, seconds: float, trace: bool,
             device: torch.device, started: Optional[float] = None) -> Dict[str, Any]:
    """Run cell ``name`` on ``device`` and return its result line's object.

    The benchmark's command gives a card; tests call this on the CPU.
    """
    started = process_start() if started is None else started
    limits = spec.limits(name)
    c = prepare(spec, name, seed, device)
    cell, config, traffic, model, load = c.cell, c.config, c.traffic, c.model, c.load
    del c
    for i in range(WARM_CALLS):
        load.call(i, keep=False)
    sync(device)
    setup_s = time.clock_gettime(time.CLOCK_BOOTTIME) - started

    ran = load.window(seconds, device, traffic['trace_seconds'] if trace else None)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == 'cuda' else 0
    parsed = tracemod.record(ran['prof']) if ran['prof'] is not None else None
    calls, traced = ran['calls'], ran['traced']

    # the check, once the program's state is freed
    load.release()
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    judged = trafficmod.judge(model, load, load.answers())
    judged['check_s'] = time.perf_counter() - t_check
    checks = {
        'max_abs_gap': {'value': judged['max_abs_gap'], 'limit': limits['max_abs_gap']},
        'nonfinite': {'value': judged['nonfinite'], 'limit': 0},
        'failed_calls': {'value': ran['failed'], 'limit': 0},
    }
    correct = judged['answers'] > 0 and all(c['value'] <= c['limit'] for c in checks.values())

    # what the metric readers read (cardbench.readers)
    run = SimpleNamespace(config=config, traffic=traffic, work_unit=load.work_unit,
              setup_s=setup_s, wall_s=ran['wall_s'],
              calls=calls, traced=calls[:traced] if traced else [],
              untraced=calls[traced:] if traced else calls, trace=parsed,
              device_name=torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu')
    metrics = {}
    for m in spec.metrics(name, per_layer=trace):
        value = spec.reader(m['name'])(run)
        if value is None and not trace and correct:
            raise RuntimeError(f"end-to-end metric {m['name']} has no value in this run")
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    result: Dict[str, Any] = {
        'correct': bool(correct), 'attempted': len(calls), 'failed': ran['failed'],
        'metrics': metrics,
        'device': {
            'platform': 'gpu' if device.type == 'cuda' else 'cpu',
            'kind': run.device_name, 'count': cell['chips'], 'memory_peak_bytes': memory_peak,
        },
    }
    if parsed is not None and parsed.calls:
        result['device']['busy_s'] = tracemod.busy_s(parsed)
        result['device']['window_s'] = parsed.window_s
        result['breakdown'] = tracemod.breakdown(parsed)
    result['errors'] = ran['errors']
    result['compared'] = {k: judged[k] for k in ('answers', 'values_compared', 'check_s')}
    result['checks'] = checks
    return result


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split('.')[0] in FORBIDDEN)


def main(argv: Optional[List[str]] = None) -> int:
    started = process_start()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    spec = specmod.Spec()
    cell = spec.workload(args.workload)
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(spec.root / rel)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell['chips']:
        print(f"cardbench: cell {args.workload} needs {cell['chips']} CUDA card(s); "
              f'this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 2
    result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device('cuda', 0), started)
    loaded = forbidden_modules()
    if loaded:
        print(f'cardbench: forbidden modules loaded: {loaded}', file=sys.stderr)
        return 3
    for key, check in result['checks'].items():
        print(f"check {key}: {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
