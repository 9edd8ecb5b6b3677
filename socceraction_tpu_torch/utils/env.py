"""Launch and join the processes of a ``torch.distributed`` run.

The counterpart of ``socceraction_tpu/utils/env.py``. PyTorch runs one
process per device, so a scale-out run is a gang of ranks that find each
other through a rendezvous store:

- :func:`init_distributed` joins the calling process to its gang. Under
  ``torchrun`` it reads the launcher's environment (``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``); under
  :func:`run_distributed_workers` it reads the file store that launcher
  named. The backend is NCCL on the card and gloo on the CPU unless the
  caller names one.
- :func:`run_distributed_workers` spawns ``world_size`` ranks of a
  worker script on this host, each with its own rank, a file store in a
  fresh temporary directory (never a TCP port, which two launches at
  once could both pick), a time limit for the whole gang, and the tail of
  a failing rank's output in the error it raises. A rank that fails or
  outlives the limit takes the whole gang down with it: the others would
  wait for it in their next collective.

The JAX module's ``cpu_device_env`` sets XLA's virtual-device flags and
has no counterpart: a CPU rank here is a process, not a virtual device.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path
from typing import List, Mapping, Optional, Sequence, Tuple

__all__ = ['INIT_METHOD_ENV', 'init_distributed', 'run_distributed_workers']

#: The environment variable through which :func:`run_distributed_workers`
#: hands its ranks the rendezvous (a ``file://`` URL).
INIT_METHOD_ENV = 'SOCCERACTION_TPU_TORCH_INIT_METHOD'

#: Bytes of a failing rank's output quoted in the error.
_TAIL = 4000


def init_distributed(
    backend: Optional[str] = None,
    *,
    device_type: str = 'cuda',
    timeout_s: float = 300.0,
) -> Tuple[int, int]:
    """Join this process to its gang -> ``(rank, world_size)``.

    ``backend`` defaults to ``'nccl'`` for ``device_type='cuda'`` and
    ``'gloo'`` for ``'cpu'``. For NCCL the current card is set first, from
    ``LOCAL_RANK`` (``torchrun`` sets it) or else the rank modulo the
    cards on the host. The rendezvous is :data:`INIT_METHOD_ENV` when a
    launcher of this module set it, else ``env://``. ``timeout_s`` bounds
    every collective of the default group.
    """
    import torch
    import torch.distributed as dist

    if device_type not in ('cuda', 'cpu'):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    if backend is None:
        backend = 'nccl' if device_type == 'cuda' else 'gloo'
    rank = int(os.environ['RANK'])
    world_size = int(os.environ['WORLD_SIZE'])
    if device_type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device is available; pass device_type="cpu" to run on the CPU'
            )
        local = int(os.environ.get('LOCAL_RANK', rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if not dist.is_initialized():
        dist.init_process_group(
            backend,
            init_method=os.environ.get(INIT_METHOD_ENV, 'env://'),
            rank=rank,
            world_size=world_size,
            timeout=timedelta(seconds=timeout_s),
        )
    return rank, world_size


def _tail(path: Path) -> str:
    text = path.read_text(errors='replace') if path.exists() else ''
    return text[-_TAIL:]


def run_distributed_workers(
    worker_path: str,
    world_size: int = 2,
    *,
    args: Sequence[str] = (),
    timeout_s: float = 120.0,
    env: Optional[Mapping[str, str]] = None,
    store_dir: Optional[str] = None,
) -> List[str]:
    """Run ``python worker_path *args`` as ``world_size`` ranks -> their outputs.

    Each rank gets ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE`` and
    :data:`INIT_METHOD_ENV` (a file store under ``store_dir``, default a
    temporary directory removed afterwards), this repository on
    ``PYTHONPATH``, gloo on the loopback interface unless
    ``GLOO_SOCKET_IFNAME`` says otherwise, and ``env`` over the caller's
    environment; the worker calls :func:`init_distributed`. Returns each
    rank's combined stdout/stderr, in rank order.

    Raises ``RuntimeError`` naming the first rank to fail, with the tail of
    its output, as soon as any rank exits non-zero, and ``TimeoutError``
    with every rank's tail once ``timeout_s`` has passed; either way every
    rank still running is killed first.
    """
    if world_size < 1:
        raise ValueError(f'world_size must be >= 1, got {world_size}')
    root = str(Path(__file__).resolve().parents[2])
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        base = dict(os.environ)
        base.update(env or {})
        base['PYTHONPATH'] = root + (
            os.pathsep + base['PYTHONPATH'] if base.get('PYTHONPATH') else ''
        )
        # every rank is on this host: gloo connects them over loopback
        base.setdefault('GLOO_SOCKET_IFNAME', 'lo')
        base['WORLD_SIZE'] = str(world_size)
        base[INIT_METHOD_ENV] = 'file://' + os.path.join(tmp, 'store')
        logs = [Path(tmp) / f'rank{i}.log' for i in range(world_size)]
        procs: List[subprocess.Popen] = []
        try:
            for i, log in enumerate(logs):
                with open(log, 'wb') as out:
                    procs.append(subprocess.Popen(
                        [sys.executable, worker_path, *args],
                        env={**base, 'RANK': str(i), 'LOCAL_RANK': str(i)},
                        stdout=out,
                        stderr=subprocess.STDOUT,
                    ))
            deadline = time.monotonic() + timeout_s
            while True:
                codes = [p.poll() for p in procs]
                failed = [i for i, c in enumerate(codes) if c not in (None, 0)]
                if failed:
                    i = failed[0]
                    raise RuntimeError(
                        f'distributed worker {i} of {world_size} failed (rc={codes[i]}):\n'
                        + _tail(logs[i])
                    )
                if all(c == 0 for c in codes):
                    return [log.read_text(errors='replace') for log in logs]
                if time.monotonic() > deadline:
                    tails = '\n'.join(
                        f'--- rank {i} ---\n{_tail(log)}' for i, log in enumerate(logs)
                    )
                    raise TimeoutError(
                        f'{world_size} distributed workers did not finish in {timeout_s} s:\n'
                        + tails
                    )
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
