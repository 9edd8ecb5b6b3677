"""The serving warm tier: ship the built kernel libraries with a version.

Port of the JAX package's ``socceraction_tpu/serve/aot.py``. A service
scales out by starting replicas, and each one pays its compiler before it
rates its first action. In the JAX package that compiler is XLA, and its
warm tier ships serialized executables. In the port the only compiled
artifacts are the shared libraries of the hand-written kernels, which
:mod:`~socceraction_tpu_torch.ops.cuda_build` builds with ``nvcc`` (one
per ``csrc/*.cu``: B1's ``gather_matmul`` and B2's ``segment_sum``), so
the port's warm tier ships those libraries:

- :func:`export_serving_aot` — writes each built library into
  ``<dir>/aot/`` beside a ``manifest.json`` carrying the environment
  fingerprint (:func:`env_fingerprint`), each library's sha256 and size,
  the serving ladder and ``max_actions`` it was exported for, and the
  model's layout signature. Both libraries ship, so a replica that also
  runs the learner starts with no ``nvcc`` at all.
- :func:`load_serving_aot` — the first tier of
  ``RatingService.warmup()``: when the stored fingerprint and layout
  match this process and model, every library is checksum-verified and
  installed where ``load_library`` finds it
  (:func:`~socceraction_tpu_torch.ops.cuda_build.install_library`), so
  the warm-up loads libraries instead of building them. A mismatch is
  ``outcome='stale'`` (counted, evented, in ``health()['aot']``) and the
  normal build runs: a library built elsewhere is never loaded. Reads run
  through the ``registry.aot`` fault point and a retry site; a truncated
  or corrupt library is a *named* ``miss``, never a failed warm-up or
  swap.
- :func:`enable_compile_cache` — the middle tier: the kernels' build
  directory (``SOCCERACTION_TPU_COMPILE_CACHE``,
  :func:`socceraction_tpu_torch.config.compile_cache_dir`), which
  replicas sharing a filesystem share.

The libraries are weight- and shape-independent: one exported set serves
every version of the same layout on the same card and toolkit, at any
bucket. No CUDA graph is captured: a graph cannot be written to disk.

Importing this module needs neither torch nor numpy: they load only when
libraries are exported or loaded. :func:`read_manifest` is stdlib-only,
so control-plane tooling can read a shipped fingerprint cheaply.

Outcomes land in ``serve/aot_loads{outcome=hit|stale|miss}`` (one ``hit``
per installed library, one ``stale``/``miss`` per load attempt) plus an
``aot_load`` event in the flight recorder and the active run log.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..config import compile_cache_dir
from ..resil.faults import fault_point
from ..resil.retry import RetryPolicy, retry_call

__all__ = [
    'AOT_DIRNAME',
    'AOT_FORMAT',
    'enable_compile_cache',
    'env_fingerprint',
    'export_serving_aot',
    'fingerprint_diff',
    'last_aot_load',
    'load_serving_aot',
    'read_manifest',
]

#: subdirectory of a registry version dir holding the shipped libraries
AOT_DIRNAME = 'aot'

#: manifest format; a reader refuses anything newer (same stance as the
#: checkpoint format stamps)
AOT_FORMAT = 1

#: The kernel libraries a version ships: B1 (every serving flush) and B2
#: (the learner's statistics), named by their ``csrc/<name>.cu``.
KERNELS: Tuple[str, ...] = ('gather_matmul', 'segment_sum')

#: Library reads retried under this policy: transient filesystem errors
#: back off and retry; checksum mismatches (ValueError) are permanent —
#: the caller falls back to building, waiting cannot fix bit rot.
AOT_RETRY = RetryPolicy(max_attempts=3, base_delay_s=0.05, max_delay_s=1.0)

#: the last load attempt's summary (process-wide)
_LAST_LOAD: Optional[Dict[str, Any]] = None
_LAST_LOAD_LOCK = threading.Lock()


def last_aot_load() -> Optional[Dict[str, Any]]:
    """The most recent :func:`load_serving_aot` summary, or ``None``."""
    with _LAST_LOAD_LOCK:
        return dict(_LAST_LOAD) if _LAST_LOAD is not None else None


def _note_load(summary: Dict[str, Any]) -> None:
    global _LAST_LOAD
    with _LAST_LOAD_LOCK:
        _LAST_LOAD = dict(summary)


def _emit_event(kind: str, **payload: Any) -> None:
    """Recorder + run-log fan-out; telemetry must never fail a load."""
    try:
        from ..obs.recorder import RECORDER
        from ..obs.trace import current_runlog

        RECORDER.record(kind, **payload)
        log = current_runlog()
        if log is not None:
            log.event(kind, **payload)
    except Exception:
        pass


# --------------------------------------------------------------------------
# environment fingerprint
# --------------------------------------------------------------------------


def _profile_sha256() -> str:
    """sha256 of the port's platform-profile file (or 'absent'): it picks
    the rating path, and so whether B1 serves at all."""
    from ..ops import profile as _profile

    try:
        with open(_profile._PROFILE_FILE, 'rb') as f:
            return hashlib.sha256(f.read()).hexdigest()
    except (OSError, TypeError):
        return 'absent'


def env_fingerprint(device: Any = None) -> Dict[str, str]:
    """The shipped libraries' compatibility key in THIS process.

    Everything that decides whether a library built elsewhere can serve
    here: torch and its CUDA version, the card's name and compute
    capability (``sm_90a`` code runs on compute capability 9.0 only), the
    digest that names each library (its source and ``nvcc`` flags,
    computed without ``nvcc``), and, as in the JAX package, the platform
    profile's hash, the resolved rating path, the in-dispatch guard flag
    and the checkpoint format. ``device`` is the serving device (default:
    the current card, else the CPU).
    """
    import torch

    from ..ml.mlp import MLP_FORMAT_VERSION
    from ..obs import numerics
    from ..ops import cuda_build
    from ..ops.profile import preferred_rating_path

    if device is None:
        device = 'cuda' if torch.cuda.is_available() else 'cpu'
    device = torch.device(device)
    if device.type == 'cuda':
        major, minor = torch.cuda.get_device_capability(device)
        card, capability = torch.cuda.get_device_name(device), f'{major}.{minor}'
    else:
        card, capability = device.type, 'none'
    try:
        path = preferred_rating_path(device.type)
    except Exception:
        path = 'invalid'
    out = {
        'aot_format': str(AOT_FORMAT),
        'torch': str(torch.__version__),
        'cuda': str(torch.version.cuda),
        'device_kind': str(card),
        'compute_capability': capability,
        'platform_profile_sha256': _profile_sha256(),
        'rating_path': str(path),
        'guards': '1' if numerics.guards_enabled() else '0',
        'checkpoint_format': str(MLP_FORMAT_VERSION),
    }
    for name in KERNELS:
        out[f'library_{name}'] = cuda_build.library_digest(name)
    return out


def fingerprint_diff(stored: Dict[str, Any], current: Dict[str, Any]) -> List[str]:
    """Keys on which two fingerprints disagree (empty = compatible).

    Compared over the union of keys: a field one side lacks IS a
    mismatch (an older manifest without ``guards`` must not silently
    pass a guard-enabled process).
    """
    keys = set(stored) | set(current)
    return sorted(k for k in keys if str(stored.get(k)) != str(current.get(k)))


def model_signature(model: Any) -> str:
    """The serving model's layout: family, feature kernels, state depth,
    table storage and each head's kind and parameter shapes. Shipped
    libraries are held to it, as the JAX package holds each executable to
    its abstract signature: a version directory whose libraries were
    exported for another layout was assembled wrong."""
    parts = [
        f'family={getattr(model, "_fused_registry", None)}',
        f'k={model.nb_prev_actions}',
        f'xfns={",".join(model.xfns)}',
        f'quantize={getattr(model, "quantize", "none")}',
    ]
    for i, head in enumerate(model._heads()):
        module = getattr(head, 'module', None)
        shapes = (
            ';'.join(f'{n}:{"x".join(map(str, p.shape))}' for n, p in module.state_dict().items())
            if module is not None else ''
        )
        parts.append(f'head{i}={type(head).__name__}[{shapes}]')
    return ' '.join(parts)


def _check_exportable(model: Any) -> None:
    if getattr(model, '_fused_registry', None) != 'standard':
        # the same boundary as RatingService._validate_model, stated at
        # export time instead of serve time
        raise ValueError(
            'AOT export covers standard-SPADL serving models '
            f'(got fused registry {getattr(model, "_fused_registry", None)!r})'
        )
    from ..ops.profile import FUSED_PATH_HIDDEN_DTYPES

    path = model._rating_path()
    if not model._can_fuse() or path not in FUSED_PATH_HIDDEN_DTYPES:
        raise ValueError(
            'AOT export covers the fused serving path; this model/'
            f'platform configuration rates through {path!r} without a '
            'fused dispatch (kernel B1) to ship'
        )


# --------------------------------------------------------------------------
# export
# --------------------------------------------------------------------------


def export_serving_aot(
    model: Any,
    dest: str,
    *,
    ladder: Tuple[int, ...],
    max_actions: int,
) -> Dict[str, Any]:
    """Ship the kernel libraries ``model``'s serving needs into ``dest``.

    ``dest`` is the ``aot/`` directory (created; must not already hold a
    manifest — artifacts are immutable like everything else in the
    registry). Each library is built first if this process has not built
    it (``nvcc``), then copied with its sha256; ``ladder`` and
    ``max_actions`` (the serving shapes replicas will use) are recorded in
    the manifest, which is written last: a crash mid-export leaves a
    manifest-less directory that reads as no artifacts. Returns the
    manifest dict.
    """
    from ..ops import cuda_build

    _check_exportable(model)
    manifest_path = os.path.join(dest, 'manifest.json')
    if os.path.exists(manifest_path):
        raise ValueError(
            f'AOT artifacts already exist at {dest!r}; they are '
            'immutable — export into a fresh version/candidate instead'
        )
    os.makedirs(dest, exist_ok=True)
    entries: List[Dict[str, Any]] = []
    for name in KERNELS:
        built = cuda_build.build_library(name)
        with open(built, 'rb') as f:
            blob = f.read()
        with open(os.path.join(dest, built.name), 'wb') as f:
            f.write(blob)
        entries.append({
            'id': name,
            'file': built.name,
            'digest': cuda_build.library_digest(name),
            'sha256': hashlib.sha256(blob).hexdigest(),
            'nbytes': len(blob),
        })
    manifest = {
        'format': AOT_FORMAT,
        'fingerprint': env_fingerprint(model.device),
        'created_unix': time.time(),
        'ladder': [int(b) for b in ladder],
        'max_actions': int(max_actions),
        'signature': model_signature(model),
        'entries': entries,
    }
    with open(manifest_path, 'w', encoding='utf-8') as f:
        json.dump(manifest, f, sort_keys=True)
    return manifest


# --------------------------------------------------------------------------
# load
# --------------------------------------------------------------------------


def read_manifest(aot_dir: str) -> Optional[Dict[str, Any]]:
    """The AOT manifest of ``aot_dir``, or ``None`` when absent.

    Stdlib-only. A *corrupt* manifest raises ``ValueError`` naming the
    file — half-written provenance must surface, not read as absent; a
    manifest newer than this library is refused like a too-new
    checkpoint.
    """
    path = os.path.join(aot_dir, 'manifest.json')
    if not os.path.isfile(path):
        return None
    try:
        with open(path, encoding='utf-8') as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise ValueError(
            f'AOT manifest corrupt: {path!r} failed to parse ({type(e).__name__}: {e})'
        ) from e
    if not isinstance(manifest, dict) or 'entries' not in manifest:
        raise ValueError(f'AOT manifest corrupt: {path!r} is not a manifest object')
    if int(manifest.get('format', 0)) > AOT_FORMAT:
        raise ValueError(
            f'AOT manifest at {path!r} has format={manifest.get("format")}, '
            f'newer than this library understands (<= {AOT_FORMAT}); '
            'upgrade socceraction_tpu_torch to load it'
        )
    return manifest


def _read_artifact(aot_dir: str, entry: Dict[str, Any]) -> bytes:
    """One checksum-verified library read (the ``registry.aot`` site).

    The fault point sits INSIDE the retried callable, so an injected
    transient error exercises the retry policy and an injected
    ``ValueError`` (bit rot) surfaces at once — both paths then reach the
    caller's build fallback.
    """
    path = os.path.join(aot_dir, entry['file'])

    def _read() -> bytes:
        fault_point('registry.aot', artifact=entry['file'])
        with open(path, 'rb') as f:
            blob = f.read()
        digest = hashlib.sha256(blob).hexdigest()
        if digest != entry.get('sha256'):
            raise ValueError(
                f'AOT artifact corrupt: {path!r} sha256 {digest[:12]}… '
                f'does not match the manifest ({str(entry.get("sha256"))[:12]}…); '
                'the library is truncated or damaged — building instead'
            )
        return blob

    return retry_call(_read, site='registry.aot', policy=AOT_RETRY)


def load_serving_aot(
    model: Any,
    aot_dir: str,
    *,
    ladder: Tuple[int, ...],
    max_actions: int,
    context: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Check the shipped libraries and install them for ``load_library``.

    The first tier of ``RatingService.warmup()``. Never raises: the
    summary dict's ``outcome`` is

    - ``'hit'`` — fingerprint and layout matched and every library was
      checksum-verified and installed (one
      ``serve/aot_loads{outcome="hit"}`` count per library): the next
      ``load_library`` of each runs no ``nvcc``;
    - ``'stale'`` — libraries exist but were built for another
      environment (or exported for another layout): nothing is installed,
      ``mismatch`` names the keys that moved, and the caller builds —
      loudly counted, never silently served;
    - ``'miss'`` — no artifacts, or a corrupt or unreadable one
      (``reason`` names it): the caller builds.

    A failure part-way fails the whole load as ``'miss'`` after the
    libraries before it were installed; those still skip their build.
    ``ladder`` and ``max_actions`` are the serving shapes: the libraries
    serve any shape, so they are not held to the shipped ones.
    """
    summary: Dict[str, Any] = {
        'outcome': 'miss',
        'entries_loaded': 0,
        'aot_dir': aot_dir,
        **(context or {}),
    }
    try:
        # OSError included: a manifest on network storage mid-failover can
        # fail its open — the never-raises contract covers it
        manifest = read_manifest(aot_dir)
    except (ValueError, OSError) as e:
        summary['reason'] = f'{type(e).__name__}: {e}'
        return _finish_load(summary)
    if manifest is None:
        summary['reason'] = 'no AOT artifacts shipped'
        return _finish_load(summary, count=False)
    try:
        from ..obs import counter
        from ..ops import cuda_build

        stored = dict(manifest.get('fingerprint') or {})
        summary['fingerprint'] = stored
        current = env_fingerprint(model.device)
        mismatch = fingerprint_diff(stored, current)
        if mismatch:
            summary['outcome'] = 'stale'
            summary['mismatch'] = {
                k: {'stored': stored.get(k), 'current': current.get(k)} for k in mismatch
            }
            return _finish_load(summary)
        signature = model_signature(model)
        if manifest.get('signature') != signature:
            # exported for another layout: the same staleness class as a
            # fingerprint mismatch
            summary['outcome'] = 'stale'
            summary['mismatch'] = {
                'signature': {'stored': manifest.get('signature'), 'current': signature}
            }
            return _finish_load(summary)
        by_id = {e.get('id'): e for e in manifest.get('entries', [])}
        loaded = 0
        for name in KERNELS:
            entry = by_id.get(name)
            if entry is None:
                summary['reason'] = f'artifact {name!r} missing from the manifest'
                return _finish_load(summary)
            blob = _read_artifact(aot_dir, entry)
            cuda_build.install_library(name, blob)
            loaded += 1
            summary['entries_loaded'] = loaded
            counter('serve/aot_loads', unit='count').inc(1, outcome='hit')
    except Exception as e:
        summary['reason'] = f'{type(e).__name__}: {e}'
        return _finish_load(summary)
    summary['outcome'] = 'hit'
    return _finish_load(summary, count=False)


def _finish_load(summary: Dict[str, Any], count: bool = True) -> Dict[str, Any]:
    """Count the terminal outcome, emit the event, stash the summary.

    ``hit`` outcomes were already counted per library; ``stale``/``miss``
    count once per load attempt. A fully absent ``aot/`` dir does not
    count a miss, but still stashes the summary.
    """
    if count and summary['outcome'] in ('stale', 'miss'):
        from ..obs import counter

        counter('serve/aot_loads', unit='count').inc(1, outcome=summary['outcome'])
    _emit_event('aot_load', **summary)
    _note_load(summary)
    return summary


# --------------------------------------------------------------------------
# the compile cache (tier 2)
# --------------------------------------------------------------------------

_CACHE_LOCK = threading.Lock()
_CACHE_ENABLED: Optional[str] = None


def enable_compile_cache(path: Optional[str] = None) -> Optional[str]:
    """Point the kernels' build directory at ``path`` (idempotent).

    ``path`` defaults to ``SOCCERACTION_TPU_COMPILE_CACHE``
    (:func:`socceraction_tpu_torch.config.compile_cache_dir`); with
    neither set this is a no-op returning ``None``: libraries build into
    the checkout's ``build/kernels/``. A given ``path`` is written into
    the environment variable, which
    :func:`~socceraction_tpu_torch.ops.cuda_build.build_dir` reads at
    each build, so every later build and load in this process (and its
    children) uses it. Returns the active directory.
    """
    global _CACHE_ENABLED
    from ..config import COMPILE_CACHE_ENV

    path = path or compile_cache_dir()
    if not path:
        return None
    with _CACHE_LOCK:
        if _CACHE_ENABLED == path and compile_cache_dir() == path:
            return path
        os.makedirs(path, exist_ok=True)
        os.environ[COMPILE_CACHE_ENV] = path
        _CACHE_ENABLED = path
    _emit_event('compile_cache_enabled', path=path)
    return path
