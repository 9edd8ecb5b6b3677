"""Versioned model registry with warm device residency and atomic hot-swap.

Port of the JAX package's ``socceraction_tpu/serve/registry.py``. The
on-disk layout is that package's (``root/<name>/<version>/``, candidates
under ``root/<name>/.candidates/<tag>``, ``manifest.json`` beside a
checkpoint), and every checkpoint is a ``save_model`` directory either
package reads, so a registry written by either package loads in the
other.

A serving process outlives any single model: ratings traffic keeps
flowing while a newly trained model is rolled out (or a bad one rolled
back). The registry layers three things over
:meth:`~socceraction_tpu_torch.vaep.base.VAEP.save_model` artifacts:

- **named + versioned storage** — ``root/<name>/<version>/`` directories,
  each one a ``save_model`` checkpoint. Loaders go through
  :func:`socceraction_tpu_torch.vaep.base.load_model`, so the
  ``format_version`` stamp and the artifacts' sha256s are checked before
  anything is read.
- **warm device residency** — on load, every head's module and
  standardization statistics live on the registry's device, and the
  serving fold (:meth:`VAEP.warm_serving`) is built once, so steady-state
  rating re-uploads nothing. The bytes are claimed under the ``registry``
  owner of the residency ledger, per version.
- **atomic hot-swap** — :meth:`activate` replaces the active
  ``(name, version, model)`` triple under a lock in one reference
  assignment, so a reader sees the old triple or the new one, never a
  half-swapped mixture.

The continuous-learning loop (:mod:`socceraction_tpu_torch.learn`) adds
two lifecycle stages on top:

- **candidates** — :meth:`stage_candidate` saves a freshly trained model
  under ``root/<name>/.candidates/<tag>`` (invisible to
  :meth:`versions`; the leading dot is outside the version grammar, so a
  candidate can never be activated by accident). A candidate that passes
  the promotion gate is :meth:`promote_candidate`-d — one atomic rename
  into a real version directory, no re-serialization — and one that
  fails stays on disk for post-mortems until the retention policy
  (:meth:`gc_candidates`) reclaims it.
- **rollback** — :meth:`rollback` re-activates the version that was
  serving *before* the last activation. The previous model is still
  resident in the load cache (pruned to active + previous), so a rollback
  is one warm, atomic reference swap — counted under
  ``serve/model_swaps{reason="rollback"}``.

``publish(aot=)``, ``stage_candidate(aot=)``, :meth:`ModelRegistry.aot_dir`
and :meth:`ModelRegistry.export_aot` ship the serving warm tier's kernel
libraries inside a version (:mod:`socceraction_tpu_torch.serve.aot`), as
the JAX package ships its compiled executables.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..device import DeviceLike, resolve_device
from ..obs import counter, span
from ..obs.residency import Claim, claim_bytes
from ..resil.faults import fault_point
from ..resil.retry import RetryPolicy, retry_call

__all__ = ['ModelRegistry']

#: Checkpoint loads retried under this policy: transient filesystem
#: errors (a registry on network storage mid-failover) back off and
#: retry; corrupt artifacts (checksum mismatch → ValueError) and missing
#: versions (FileNotFoundError) raise immediately — waiting cannot fix
#: either.
LOAD_RETRY = RetryPolicy(max_attempts=3, base_delay_s=0.05, max_delay_s=1.0)

_NAME_RE = re.compile(r'^[A-Za-z0-9][A-Za-z0-9._-]*$')

#: Subdirectory of ``root/<name>/`` holding staged (gate-pending or
#: gate-rejected) candidate checkpoints. The leading dot keeps it out of
#: the version grammar (``_NAME_RE``) and out of ``versions()`` listings.
_CANDIDATES = '.candidates'


def _version_sort_key(version: str) -> Tuple[Any, ...]:
    """Order versions numerically when they look numeric ('2' < '10')."""
    parts = re.split(r'[._-]', version)
    return tuple(
        (0, int(p)) if p.isdigit() else (1, p) for p in parts
    )


class ModelRegistry:
    """Named, versioned store of rating models over ``save_model`` artifacts.

    Parameters
    ----------
    root : str
        Directory holding ``<name>/<version>/`` checkpoints. Created on
        first publish; a pre-existing tree is picked up as-is.
    device
        Where loaded models live: ``cuda`` (default) or ``'cpu'``.
    """

    def __init__(self, root: str, *, device: DeviceLike = None) -> None:
        self.root = root
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._loaded: Dict[Tuple[str, str], Any] = {}
        #: residency claims per cached version (owner ``registry`` in the
        #: ledger) — claimed at load, released when the load cache prunes
        #: the version, so ``mem/owned_bytes{owner="registry"}`` answers
        #: "how many model versions are warm"
        self._claims: Dict[Tuple[str, str], Claim] = {}
        self._active: Optional[Tuple[str, str, Any]] = None
        self._previous: Optional[Tuple[str, str, Any]] = None
        self._candidate_seq = 0

    # -- storage -----------------------------------------------------------

    def _dir(self, name: str, version: str) -> str:
        for part in (name, version):
            if not _NAME_RE.match(part):
                raise ValueError(
                    f'invalid registry name/version {part!r} '
                    '(want [A-Za-z0-9][A-Za-z0-9._-]*)'
                )
        return os.path.join(self.root, name, version)

    def publish(
        self,
        name: str,
        version: str,
        model: Any,
        *,
        aot: Optional[Dict[str, Any]] = None,
    ) -> str:
        """Save a fitted model as ``name``/``version``; returns its path.

        Refuses to overwrite an existing version — versions are immutable
        (republish under a new version instead).

        ``aot`` (``{'ladder': (...), 'max_actions': N}``) additionally
        ships the kernel libraries the model's serving needs in an
        ``aot/`` subdirectory of the version
        (:func:`socceraction_tpu_torch.serve.aot.export_serving_aot`): a
        replica whose environment fingerprint matches then installs them
        instead of running ``nvcc``. Export with the shapes replicas
        serve (``RatingService``'s bucket ladder / ``max_actions``).
        """
        path = self._dir(name, version)
        if os.path.exists(path):
            raise ValueError(
                f'model {name}/{version} already exists at {path!r}; '
                'versions are immutable — publish a new version'
            )
        os.makedirs(path)
        model.save_model(path)
        if aot is not None:
            self._export_aot_into(model, path, aot)
        return path

    @staticmethod
    def _export_aot_into(model: Any, path: str, aot: Dict[str, Any]) -> None:
        """Ship the kernel libraries inside a version/candidate dir.

        A failed export (a model that does not rate through the fused
        path, a kernel that does not build) removes the just-created
        directory before re-raising: the immutability guard would
        otherwise refuse every retry of the same version. A *crash*
        mid-export needs no cleanup — the manifest is written last, so a
        manifest-less ``aot/`` reads as no artifacts.
        """
        from .aot import AOT_DIRNAME, export_serving_aot

        try:
            export_serving_aot(
                model,
                os.path.join(path, AOT_DIRNAME),
                ladder=tuple(aot['ladder']),
                max_actions=int(aot['max_actions']),
            )
        except Exception:
            shutil.rmtree(path, ignore_errors=True)
            raise

    def aot_dir(self, name: str, version: str) -> str:
        """The ``aot/`` artifact directory of ``name``/``version``.

        A path computation only: existence (and fingerprint match) is the
        loader's business; ``RatingService.warmup`` reads an absent
        directory as the no-artifacts tier.
        """
        from .aot import AOT_DIRNAME

        return os.path.join(self._dir(name, version), AOT_DIRNAME)

    def export_aot(
        self,
        name: str,
        version: Optional[str] = None,
        *,
        ladder: Any,
        max_actions: int,
    ) -> Dict[str, Any]:
        """Ship the kernel libraries with an already-published version.

        The backfill path for versions published without ``aot=``: loads
        the version and writes ``aot/`` into its directory. The artifact
        set is immutable once written. Returns the manifest.
        """
        from .aot import export_serving_aot

        version = self.resolve_version(name, version)
        model = self.load(name, version)
        return export_serving_aot(
            model, self.aot_dir(name, version), ladder=tuple(ladder), max_actions=int(max_actions),
        )

    def names(self) -> List[str]:
        """Published model names."""
        if not os.path.isdir(self.root):
            return []
        return sorted(
            d for d in os.listdir(self.root)
            if os.path.isdir(os.path.join(self.root, d))
        )

    def versions(self, name: str) -> List[str]:
        """Published versions of ``name``, oldest to newest."""
        base = os.path.join(self.root, name)
        if not os.path.isdir(base):
            return []
        found = [
            v for v in os.listdir(base)
            if os.path.isfile(os.path.join(base, v, 'meta.json'))
        ]
        return sorted(found, key=_version_sort_key)

    # -- loading + residency ----------------------------------------------

    def load(self, name: str, version: Optional[str] = None) -> Any:
        """Load (and device-warm) ``name``/``version`` (default: newest).

        The checkpoint is read by the port's ``load_model`` onto the
        registry's device, under ``retry_call(site='registry.load')``.
        Loaded models are cached per ``(name, version)`` — versions are
        immutable, so a cache entry can never go *stale*. The cache is
        pruned to the active + previous versions at every activation
        (:meth:`activate` / :meth:`rollback`), so a loop that promotes a
        new version per iteration holds at most two models resident
        instead of growing without bound.
        """
        version = self.resolve_version(name, version)
        key = (name, version)
        with self._lock:
            model = self._loaded.get(key)
        if model is not None:
            return model
        from ..vaep.base import load_model

        path = self._dir(name, version)
        if not os.path.isfile(os.path.join(path, 'meta.json')):
            raise FileNotFoundError(f'no model at {path!r}')
        with span('serve/model_load', model=name, version=version):

            def _load() -> Any:
                fault_point('registry.load', model=name, version=version)
                return load_model(path, device=self.device)

            model = retry_call(_load, site='registry.load', policy=LOAD_RETRY)
            self.warm(model)
        with self._lock:
            if key not in self._loaded:
                self._loaded[key] = model
                # attribute the version's device residency (heads +
                # serving fold) to the registry: keyed per version,
                # released when the cache prunes it
                self._claims[key] = claim_bytes(
                    'registry', self._resident_arrays(model),
                    key=f'{name}/{version}',
                )
            return self._loaded[key]

    @staticmethod
    def _resident_arrays(model: Any) -> list:
        """The device tensors :meth:`warm` made resident for ``model``.

        Per head (MLP or seq): its module's parameters plus the
        standardization statistics ``mean_``/``std_``; then the prepared
        serving fold (:meth:`VAEP.serving_arrays`, built by ``warm``) —
        the bytes one warm model version holds on the card (the residency
        ledger's ``registry`` owner claims exactly these).
        """
        arrays: list = []
        for clf in getattr(model, '_models', {}).values():
            module = getattr(clf, 'module', None)
            if module is not None:
                arrays.extend(p.detach() for p in module.parameters())
            for stat in (getattr(clf, 'mean_', None), getattr(clf, 'std_', None)):
                if stat is not None:
                    arrays.append(stat)
        serving = getattr(model, 'serving_arrays', None)
        if callable(serving):
            arrays.extend(serving())
        return arrays

    def warm(self, model: Any) -> Any:
        """Make a model's constants resident on the registry's device.

        Each head's module and its ``mean_``/``std_`` move onto the device
        (a no-op for a model ``load`` read there), and the serving fold is
        built now (:meth:`VAEP.warm_serving`), so the first rating gathers
        from resident tables instead of paying the fold build, and the
        residency claim sees the fold's bytes. A model whose own device is
        another raises.
        """
        if getattr(model, 'device', self.device) != self.device:
            raise ValueError(
                f'the model lives on {model.device}, the registry on {self.device}'
            )
        for clf in getattr(model, '_models', {}).values():
            module = getattr(clf, 'module', None)
            if module is not None:
                module.to(self.device)
            for stat in ('mean_', 'std_'):
                value = getattr(clf, stat, None)
                if value is not None:
                    setattr(clf, stat, value.to(self.device))
        warm_serving = getattr(model, 'warm_serving', None)
        if callable(warm_serving):
            warm_serving()
        return model

    # -- the active model --------------------------------------------------

    def resolve_version(self, name: str, version: Optional[str]) -> str:
        """``version``, or the newest published version of ``name``.

        Callers that validate/warm a model before activating it resolve
        ONCE and pass the pinned version everywhere after — re-resolving
        'newest' later would race a concurrent publish.
        """
        if version is not None:
            return version
        available = self.versions(name)
        if not available:
            raise FileNotFoundError(
                f'no versions of model {name!r} under {self.root!r}'
            )
        return available[-1]

    def activate(self, name: str, version: Optional[str] = None) -> Tuple[str, str]:
        """Atomically make ``name``/``version`` the active serving model.

        The version is resolved FIRST and that exact version is loaded,
        device-warmed and activated — a publish racing this call can
        never make the recorded version string mismatch the live model.
        The swap itself is one locked reference assignment, so a
        concurrent reader sees either the old triple or the new one —
        never a mixture. Returns the ``(name, version)`` that went live.
        """
        version = self.resolve_version(name, version)
        model = self.load(name, version)
        with self._lock:
            if self._active is not None and self._active[:2] != (name, version):
                self._previous = self._active
            self._active = (name, version, model)
            self._prune_loaded_locked()
        counter('serve/model_swaps', unit='count').inc(1)
        return name, version

    def _prune_loaded_locked(self) -> None:
        """Drop cached models other than the active/previous versions.

        Called (under the lock) at every activation: rollback needs
        exactly those two warm, and anything older would otherwise
        accumulate one full parameter set per promotion for the life of
        the process. A caller still holding a reference to an evicted
        model keeps using it unaffected — only the cache lets go.
        """
        keep = {
            triple[:2]
            for triple in (self._active, self._previous)
            if triple is not None
        }
        self._loaded = {k: v for k, v in self._loaded.items() if k in keep}
        # the evicted versions' residency claims go with them: the
        # ledger's `registry` owner tracks exactly the cache's warm set
        # (a caller still holding an evicted model keeps its tensors
        # live — those bytes then show up as the census's unattributed
        # remainder, which is the honest place for them)
        for key in [k for k in self._claims if k not in keep]:
            self._claims.pop(key).release()

    def active(self) -> Tuple[str, str, Any]:
        """The active ``(name, version, model)`` triple (one atomic read)."""
        with self._lock:
            active = self._active
        if active is None:
            raise RuntimeError(
                'no active model: call activate(name, version) first'
            )
        return active

    def previous(self) -> Optional[Tuple[str, str]]:
        """The ``(name, version)`` that was serving before the last swap.

        ``None`` until a second distinct version has been activated.
        This is what :meth:`rollback` will restore.
        """
        with self._lock:
            prev = self._previous
        return prev[:2] if prev is not None else None

    def rollback(
        self, expected: Optional[Tuple[str, str]] = None
    ) -> Tuple[str, str]:
        """Atomically re-activate the previously active version.

        The previous *model object* is still warm (it was serving until
        the last swap, and the load cache retains active + previous), so
        the whole exchange happens under one lock hold — read previous,
        swap the triples — the same atomicity as :meth:`activate`, with
        no window for a concurrent activation to slip between a read
        and the swap. Callers that validated a specific target first
        pass it as ``expected``; a concurrent activation that changed
        "previous" in the meantime then raises instead of silently
        activating a version nobody validated. After a rollback the
        *rolled-back-from* version becomes the new "previous", so a
        mistaken rollback can itself be rolled back. Counted under
        ``serve/model_swaps{reason="rollback"}``.
        """
        with self._lock:
            prev = self._previous
            if prev is None:
                raise RuntimeError(
                    'no previous version to roll back to (rollback needs '
                    'a completed swap first)'
                )
            if expected is not None and prev[:2] != tuple(expected):
                raise RuntimeError(
                    f'previous version changed concurrently (expected '
                    f'{tuple(expected)}, found {prev[:2]}); re-read '
                    'previous() and retry'
                )
            name, version, _model = prev
            self._previous = self._active
            self._active = prev
            self._prune_loaded_locked()
        counter('serve/model_swaps', unit='count').inc(1, reason='rollback')
        return name, version

    # -- candidate lifecycle (the continuous-learning loop) ----------------

    def _candidate_dir(self, name: str, tag: str) -> str:
        if not _NAME_RE.match(name) or not _NAME_RE.match(tag):
            raise ValueError(
                f'invalid candidate name/tag {name!r}/{tag!r} '
                '(want [A-Za-z0-9][A-Za-z0-9._-]*)'
            )
        return os.path.join(self.root, name, _CANDIDATES, tag)

    def stage_candidate(
        self,
        name: str,
        model: Any,
        tag: Optional[str] = None,
        *,
        manifest: Optional[Dict[str, Any]] = None,
        aot: Optional[Dict[str, Any]] = None,
    ) -> Tuple[str, str]:
        """Save ``model`` as a staged candidate of ``name``; returns
        ``(tag, path)``.

        Candidates live under ``root/<name>/.candidates/<tag>`` — real
        ``save_model`` checkpoints, but invisible to :meth:`versions` /
        :meth:`resolve_version`, so nothing can activate one before the
        promotion gate passes. The default tag is a timestamp plus a
        process-local sequence number (collision-free within a process;
        across processes the timestamp + refusal-to-overwrite guard
        surfaces the race instead of corrupting a checkpoint).

        ``manifest``, when given, is written next to the checkpoint as
        ``manifest.json`` — the **training manifest** (trained-game ids
        + frozen drift-reference statistics) that travels with the
        candidate through :meth:`promote_candidate`'s atomic rename, so
        every published version carries the provenance a restarted
        process needs (:meth:`load_manifest`).

        ``aot`` (``{'ladder': ..., 'max_actions': ...}``) ships the kernel
        libraries in the candidate's ``aot/`` subdirectory: they ride
        :meth:`promote_candidate`'s atomic rename with the checkpoint, so
        a replica hot-swapping to the promoted version runs no ``nvcc``.
        """
        if tag is None:
            with self._lock:
                self._candidate_seq += 1
                seq = self._candidate_seq
            tag = f'{time.strftime("%Y%m%dT%H%M%S")}-{os.getpid()}-{seq}'
        path = self._candidate_dir(name, tag)
        if os.path.exists(path):
            raise ValueError(f'candidate {name}/{tag} already staged at {path!r}')
        os.makedirs(path)
        model.save_model(path)
        if manifest is not None:
            with open(os.path.join(path, 'manifest.json'), 'w') as f:
                json.dump(manifest, f, sort_keys=True, default=str)
        if aot is not None:
            self._export_aot_into(model, path, aot)
        return tag, path

    def load_manifest(
        self, name: str, version: Optional[str] = None
    ) -> Optional[Dict[str, Any]]:
        """The training manifest of ``name``/``version`` (default newest).

        ``None`` when the version predates manifests (bootstrap
        versions, pre-resilience checkpoints) — callers fall back to
        their legacy reconstruction; a *corrupt* manifest raises (a
        half-written provenance record must surface, not silently read
        as absent).
        """
        version = self.resolve_version(name, version)
        path = os.path.join(self._dir(name, version), 'manifest.json')
        if not os.path.isfile(path):
            return None
        with open(path, encoding='utf-8') as f:
            return json.load(f)

    def candidates(self, name: str) -> List[str]:
        """Staged candidate tags of ``name``, oldest first (by mtime)."""
        base = os.path.join(self.root, name, _CANDIDATES)
        if not os.path.isdir(base):
            return []
        found = [
            t for t in os.listdir(base)
            if os.path.isfile(os.path.join(base, t, 'meta.json'))
        ]
        return sorted(found, key=lambda t: os.path.getmtime(os.path.join(base, t)))

    def promote_candidate(self, name: str, version: str, tag: str) -> str:
        """Publish a staged candidate as ``name``/``version`` (atomic).

        One ``os.replace`` of the candidate directory into the version
        slot — the checkpoint bytes the gate evaluated ARE the bytes
        that serve; nothing is re-serialized between evaluation and
        publication. The usual immutability rule applies: an existing
        version refuses to be overwritten.
        """
        src = self._candidate_dir(name, tag)
        if not os.path.isfile(os.path.join(src, 'meta.json')):
            raise FileNotFoundError(f'no staged candidate {name}/{tag}')
        dst = self._dir(name, version)
        if os.path.exists(dst):
            raise ValueError(
                f'model {name}/{version} already exists at {dst!r}; '
                'versions are immutable — promote under a new version'
            )
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        os.replace(src, dst)
        return dst

    def next_version(self, name: str) -> str:
        """The next free numeric version string of ``name`` ('1', '2', …).

        Non-numeric published versions are ignored for the increment but
        can never collide (the result is purely numeric).
        """
        numeric = [
            int(v) for v in self.versions(name)
            if v.isdigit()
        ]
        return str(max(numeric) + 1 if numeric else 1)

    def gc_candidates(self, name: Optional[str] = None, *, keep: int = 2) -> List[str]:
        """Retention policy: delete all but the newest ``keep`` candidates.

        Gate-rejected candidates are kept on disk for post-mortems, but
        a loop that keeps training (and keeps getting rejected) must not
        grow the registry without bound. Returns the removed candidate
        directories. ``name=None`` sweeps every published name.
        """
        removed: List[str] = []
        names = [name] if name is not None else self.names()
        for n in names:
            tags = self.candidates(n)
            for tag in tags[: max(0, len(tags) - max(0, int(keep)))]:
                path = self._candidate_dir(n, tag)
                shutil.rmtree(path, ignore_errors=True)
                removed.append(path)
                counter('serve/candidates_expired', unit='count').inc(1)
        return removed
