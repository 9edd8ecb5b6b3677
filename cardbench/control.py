"""The control of the check that decides ``correct``, with the program beside it.

    python3 -m cardbench.control --workload <name> --seeds 1 2 3 [--program]

For each seed it draws the cell's season and weights as a run does, picks
``samples`` of the traffic's calls in an order drawn from the seed, and
holds to the float64 reference, by the run's own comparison
(:func:`cardbench.traffic.judge`), the control: the reference in the
precision below the configuration's (float32 with TF32 products). With
``--program`` it also rates the same calls through the program's timed
entry and holds those values to the reference. One JSON line a seed, then
the largest and smallest reading of each. The limits of ``cells/`` are set
between the program's readings (the lower) and the control's (the upper).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import run as runmod, spec as specmod, traffic as trafficmod


def readings(spec: specmod.Spec, name: str, seed: int, device: torch.device,
             program: bool) -> Dict[str, Any]:
    """The control's widest gap on one seed, and the program's with ``program``."""
    cell = runmod.prepare(spec, name, seed, device, program=program)
    load = cell.load
    picks = np.random.default_rng(seed).permutation(len(load.items))[:cell.traffic['samples']]
    items = [load.items[i] for i in picks]
    out: Dict[str, Any] = {'seed': seed, 'workload': name}
    if program:
        answers = []
        for item in items:
            answers.append((item, load.values(item).cpu()))
        load.release()
        out['program'] = trafficmod.judge(cell.model, load, answers)
    out['control'] = trafficmod.judge(cell.model, load,
                                      [(item, None) for item in items], control=True)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--program', action='store_true')
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)
    spec = specmod.Spec()
    for var, rel in runmod.CACHE_DIRS.items():
        os.environ[var] = str(spec.root / rel)
    device = torch.device(args.device)
    rows = []
    for seed in args.seeds:
        row = readings(spec, args.workload, seed, device, args.program)
        rows.append(row)
        print(json.dumps(row), flush=True)
        if device.type == 'cuda':
            torch.cuda.empty_cache()
    summary = {'workload': args.workload, 'seeds': len(rows)}
    for side in ('program', 'control'):
        gaps = [r[side]['max_abs_gap'] for r in rows if side in r]
        if gaps:
            summary[side] = {'largest': max(gaps), 'smallest': min(gaps)}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
