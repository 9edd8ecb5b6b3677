"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface. At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under the
build directory (:func:`build_dir`: ``SOCCERACTION_TPU_COMPILE_CACHE``
when set, else the repository's git-ignored ``build/kernels/``) and loaded
with ``ctypes``. The library's file name carries a digest of the source
and the flags (:func:`library_digest`, computed without ``nvcc``), so an
edited source is rebuilt and a stale library is never loaded. A library
already in place (built before, or installed by the serving warm tier
through :func:`install_library`) is loaded without ``nvcc``. Nothing here
runs at import time: this module imports on machines with no CUDA toolkit.

Every load is reported to the dispatch observatory
(:func:`~socceraction_tpu_torch.obs.dispatch.record_kernel_build`: an
``nvcc`` build counts into ``dispatch/kernel_builds`` and
``dispatch/build_seconds``), and :func:`load_libraries` is the
``kernel_build`` phase of the cold-start timeline.

A kernel that cannot run raises :class:`KernelError`: no toolkit, a failed
build, a library that does not load, a launch whose CUDA call returned an
error, or (:class:`KernelRefused`) operands it refuses. The wrappers run
their whole CUDA side under :func:`kernel_boundary`, so any other exception
raised there (an ``OSError`` from ``nvcc`` or ``dlopen``, a missing symbol,
a CUDA error from PyTorch) reaches the caller as a ``KernelError`` too.
Callers that degrade on other failures (the serving breaker) never degrade
on these.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, Iterator, List, Sequence, Tuple

from ..config import compile_cache_dir
from ..obs.coldstart import TIMELINE
from ..obs.dispatch import record_kernel_build

__all__ = [
    'BUILD_DIR', 'KernelError', 'KernelRefused', 'build_dir', 'build_library', 'build_log',
    'build_seconds', 'install_library', 'kernel_boundary', 'library_digest', 'library_path',
    'load_libraries', 'load_library', 'ptxas_report',
]

_PKG = Path(__file__).resolve().parent.parent
_SRC_DIR = _PKG / 'csrc'
#: Where the shared libraries are built by default (inside the checkout,
#: git-ignored).
BUILD_DIR = _PKG.parent / 'build' / 'kernels'

_NVCC_FLAGS = (
    '-gencode', 'arch=compute_90a,code=sm_90a',
    '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
)

_lock = threading.Lock()
#: one lock per library, so different libraries build at the same time
_name_locks: Dict[str, threading.Lock] = {}
_loaded: Dict[str, ctypes.CDLL] = {}
_paths: Dict[str, Path] = {}
#: Seconds each library took to build in this process (0.0 when it was
#: already on disk).
build_seconds: Dict[str, float] = {}


class KernelError(RuntimeError):
    """A hand-written kernel cannot run: no CUDA toolkit to build it, its
    build failed, its library does not load, or its launch failed."""


class KernelRefused(KernelError, ValueError):
    """A kernel refuses its operands: a device it has no kernel for,
    operands that are not contiguous, or widths for which a block of B1
    would need more shared memory than the card gives one. A
    ``ValueError`` too: the operands, not the card, are at fault."""


@contextlib.contextmanager
def kernel_boundary(name: str) -> Iterator[None]:
    """Run the CUDA side of kernel ``name``'s wrapper: a ``KernelError``
    passes as it is, any other exception is raised again as a
    ``KernelError`` (chained to it)."""
    try:
        yield
    except KernelError:
        raise
    except Exception as e:
        raise KernelError(f'{name} cannot run: {type(e).__name__}: {e}') from e


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise KernelError('no CUDA toolkit found (set CUDA_HOME); cannot build kernels')
    return os.path.join(CUDA_HOME, 'bin', 'nvcc')


def build_dir() -> Path:
    """The directory libraries are built into and loaded from, read at
    call time: ``SOCCERACTION_TPU_COMPILE_CACHE`` when set, else
    :data:`BUILD_DIR`."""
    configured = compile_cache_dir()
    return Path(configured) if configured else BUILD_DIR


def library_digest(name: str) -> str:
    """The digest that names ``csrc/<name>.cu``'s library: its source and
    the compiler's flags (no ``nvcc`` needed to compute it)."""
    src = _SRC_DIR / f'{name}.cu'
    return hashlib.sha256(src.read_bytes() + ' '.join(_NVCC_FLAGS).encode()).hexdigest()[:16]


def library_path(name: str) -> Path:
    """Where :func:`load_library` finds (or builds) ``name``'s library."""
    return build_dir() / f'lib{name}-{library_digest(name)}.so'


def _lock_for(name: str) -> threading.Lock:
    with _lock:
        return _name_locks.setdefault(name, threading.Lock())


def _build(name: str) -> Tuple[Path, bool, float]:
    """``name``'s library on disk, built with ``nvcc`` only when it is not
    in place: ``(path, compiled, seconds)``. Call under the name's lock."""
    src = _SRC_DIR / f'{name}.cu'
    so = library_path(name)
    t0 = time.perf_counter()
    compiled = not so.exists()
    if compiled:
        so.parent.mkdir(parents=True, exist_ok=True)
        # build to a temporary name, then rename: concurrent builders
        # never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=so.parent)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *_NVCC_FLAGS, '-o', tmp, str(src)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise KernelError(
                    f'nvcc failed to build {src} (exit {proc.returncode}):\n'
                    f'{proc.stdout}{proc.stderr}'
                )
            Path(f'{so}.log').write_text(proc.stdout + proc.stderr)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return so, compiled, time.perf_counter() - t0


def build_library(name: str) -> Path:
    """``name``'s library on disk (built first if needed), not loaded: what
    the serving warm tier ships."""
    with _lock_for(name), kernel_boundary(name):
        so, compiled, seconds = _build(name)
        if compiled:
            build_seconds[name] = seconds
            record_kernel_build(name, seconds, compiled=True)
        return so


def install_library(name: str, blob: bytes) -> Path:
    """Put a shipped build of ``name``'s library where :func:`load_library`
    finds it, so the next load runs no ``nvcc``; returns its path.

    The caller vouches for the bytes (the warm tier checks each against
    its manifest's sha256 and the digest in its fingerprint first). The
    file is written under a temporary name and renamed, so a concurrent
    loader never reads half of it. A library this process already loaded
    stays loaded.
    """
    with _lock_for(name):
        so = library_path(name)
        so.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=so.parent)
        try:
            with os.fdopen(fd, 'wb') as fh:
                fh.write(blob)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return so


def load_library(name: str) -> ctypes.CDLL:
    """The loaded ``csrc/<name>.cu`` library, built first if needed.

    The compiler's report (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside the library as ``<lib>.log``. A failed build
    raises with the compiler's output; a compiler that does not start or a
    library that does not load raises too, each as a :class:`KernelError`.
    """
    with _lock_for(name), kernel_boundary(name):
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        so, compiled, seconds = _build(name)
        build_seconds[name] = seconds
        _paths[name] = so
        lib = _loaded[name] = ctypes.CDLL(str(so))
        record_kernel_build(name, seconds, compiled=compiled)
        return lib


def load_libraries(names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """Build and load several libraries at once: one ``nvcc`` per source,
    all started together; the cold-start timeline's ``kernel_build``
    phase."""
    with TIMELINE.phase('kernel_build'), ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(load_library, names)))


def build_log(name: str) -> str:
    """The compiler's report for the loaded library ``name`` (empty when
    the build log is gone)."""
    log = Path(f'{_paths[name]}.log')
    return log.read_text() if log.exists() else ''


def ptxas_report(name: str) -> List[Dict[str, Any]]:
    """Registers and spill bytes of each kernel in the loaded library
    ``name``, from its ``-Xptxas -v`` report."""
    rows: List[Dict[str, Any]] = []
    for line in build_log(name).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            rows.append({'kernel': m.group(1)})
            continue
        if not rows:
            continue
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', line)
        if m:
            rows[-1]['spill_stores'] = int(m.group(1))
            rows[-1]['spill_loads'] = int(m.group(2))
        m = re.search(r'Used (\d+) registers', line)
        if m:
            rows[-1]['registers'] = int(m.group(1))
    return rows
