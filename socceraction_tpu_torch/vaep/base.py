"""VAEP serving: valuing actions by estimating probabilities.

Port of the serving side of ``socceraction_tpu/vaep/base.py``. A
:class:`VAEP` holds a scores head and a concedes head
(:class:`~socceraction_tpu_torch.ml.mlp.MLPClassifier`) and rates packed
batches:

- :meth:`VAEP.rate_batch` is the main path: both heads' first layers
  folded once into combined tables (optionally bf16/int8), one fused
  gather + matmul first layer per batch (the CUDA kernel on the card),
  the hidden chains, and the VAEP formula;
- :meth:`VAEP.rate_batch_reference` is the same function through the
  materialized feature tensor, in plain PyTorch, for parity checks.

:func:`load_model` reads a directory written by the JAX package's
``VAEP.save_model`` (its ``meta.json`` gates and sha256 checks included).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import TYPE_CHECKING, Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import NB_PREV_ACTIONS
from ..core.batch import ActionBatch, bucket_games, pack_actions, pad_batch_games, unpack_values
from ..device import DeviceLike, resolve_device
from ..ml.mlp import MLPClassifier
from ..ops.features import KERNELS, compute_features
from ..ops.formula import vaep_values
from ..ops.fused import PreparedPair, pair_probs_prepared, prepare_pair_fold, train_layout
from ..ops.quant import check_quantize_mode

if TYPE_CHECKING:  # pandas is imported inside rate() only
    import pandas as pd

__all__ = ['CHECKPOINT_FORMAT_VERSION', 'NotFittedError', 'VAEP', 'XFNS_DEFAULT', 'load_model']

#: Newest ``save_model`` directory format this port reads (the JAX
#: package's ``CHECKPOINT_FORMAT_VERSION``).
CHECKPOINT_FORMAT_VERSION = 3

#: int8 scales persisted beside the heads of a quantized checkpoint.
_QUANT_SCALES_ARTIFACT = 'models/quant_scales.npz'

#: The reference's 14 default feature transformers, by kernel name.
XFNS_DEFAULT: Tuple[str, ...] = (
    'actiontype_onehot',
    'result_onehot',
    'actiontype_result_onehot',
    'bodypart_onehot',
    'time',
    'startlocation',
    'endlocation',
    'startpolar',
    'endpolar',
    'movement',
    'team',
    'time_delta',
    'space_delta',
    'goalscore',
)

_LABELS = ('scores', 'concedes')


class NotFittedError(ValueError):
    """Raised when a model without heads is asked to rate."""


class VAEP:
    """VAEP serving over packed batches.

    Parameters
    ----------
    xfns : sequence of str, optional
        Feature kernel names, in column order (default: the reference's 14).
    nb_prev_actions : int
        Game states per action (default 3).
    models : dict, optional
        ``{'scores': MLPClassifier, 'concedes': MLPClassifier}`` on ``device``.
    device
        Where the model runs: ``cuda`` (default) or ``'cpu'``.
    """

    def __init__(
        self,
        xfns: Optional[Sequence[str]] = None,
        nb_prev_actions: int = NB_PREV_ACTIONS,
        *,
        models: Optional[Dict[str, MLPClassifier]] = None,
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        self.xfns = tuple(XFNS_DEFAULT if xfns is None else xfns)
        unknown = [n for n in self.xfns if n not in KERNELS]
        if unknown:
            raise ValueError(f'feature transformers {unknown} have no kernel')
        self.nb_prev_actions = nb_prev_actions
        self._models: Dict[str, MLPClassifier] = {}
        if models is not None:
            if sorted(models) != sorted(_LABELS):
                raise ValueError(f'models must be exactly {_LABELS}, got {sorted(models)}')
            for col, clf in models.items():
                if clf.mean_.device != self.device:
                    raise ValueError(
                        f'head {col!r} lives on {clf.mean_.device}, the model on {self.device}'
                    )
            self._models = {col: models[col] for col in _LABELS}
        #: cached (key, PreparedPair) serving fold, see _prepared_pair
        self._pair_prep: Optional[Tuple[Any, PreparedPair]] = None
        #: int8 scales restored from a quantized checkpoint (or None)
        self._quant_scales: Optional[Dict[str, torch.Tensor]] = None

    # -- quantized serving fold --------------------------------------------

    @property
    def quantize(self) -> str:
        """The heads' shared table-storage mode: ``'none'``, ``'bf16'`` or ``'int8'``."""
        modes = {m.quantize for m in self._models.values()}
        if len(modes) > 1:
            raise ValueError(f'heads disagree on quantize mode: {sorted(modes)}')
        return modes.pop() if modes else 'none'

    def set_quantize(self, mode: str) -> 'VAEP':
        """Set the serving table-storage mode on both heads.

        The prepared fold is rebuilt on the next rating; persisted int8
        scales are dropped when the mode changes.
        """
        check_quantize_mode(mode)
        if mode != 'none' and not self._models:
            raise NotFittedError('load or set the heads before set_quantize')
        changed = mode != self.quantize
        for m in self._models.values():
            m.quantize = mode
        self._pair_prep = None
        if changed:
            self._quant_scales = None
        return self

    def _heads(self) -> Tuple[MLPClassifier, MLPClassifier]:
        if not self._models:
            raise NotFittedError('this model has no heads to rate with')
        return self._models[_LABELS[0]], self._models[_LABELS[1]]

    def _prepared_pair(self) -> PreparedPair:
        """The serving fold, built once per (mode, heads) and cached.

        The cache key holds references to the exact objects the fold was
        built from (compared with ``is``), so swapping a head rebuilds it.
        """
        clf_a, clf_b = self._heads()
        mode = self.quantize
        key = (
            (mode, self.xfns, self.nb_prev_actions),
            (clf_a.module, clf_b.module, clf_a.mean_, clf_a.std_, clf_b.mean_, clf_b.std_),
        )
        cached = self._pair_prep
        if (
            cached is not None
            and cached[0][0] == key[0]
            and all(a is b for a, b in zip(cached[0][1], key[1]))
        ):
            return cached[1]
        scales = (self._quant_scales or {}) if mode == 'int8' else {}
        prep = prepare_pair_fold(
            clf_a, clf_b,
            names=self.xfns,
            k=self.nb_prev_actions,
            quantize=mode,
            table_scale=scales.get('table_scale'),
            w_dense_scale=scales.get('w_dense_scale'),
        )
        self._pair_prep = (key, prep)
        return prep

    # -- rating ------------------------------------------------------------

    def _overrides_on_device(
        self, batch: ActionBatch, dense_overrides: Optional[Dict[str, Any]]
    ) -> Dict[str, torch.Tensor]:
        """Validate ``dense_overrides`` by name and shape, before any padding
        or dispatch, and move them to the model's device."""
        if batch.device != self.device:
            raise ValueError(f'batch lives on {batch.device}, the model on {self.device}')
        if not dense_overrides:
            return {}
        layout = train_layout(self.xfns, self.nb_prev_actions)
        widths = {name: width for name, kind, _, width in layout.spans if kind == 'dense'}
        out = {}
        for name, block in dense_overrides.items():
            if name not in widths:
                raise ValueError(
                    f'dense override {name!r} is not a dense feature block of this '
                    f'model; overridable blocks: {sorted(widths)}'
                )
            block = torch.as_tensor(block, dtype=torch.float32, device=self.device)
            expected = (batch.n_games, batch.max_actions, widths[name])
            if tuple(block.shape) != expected:
                raise ValueError(
                    f'dense override {name!r} has shape {tuple(block.shape)}, '
                    f'expected (n_games, max_actions, width) = {expected}'
                )
            out[name] = block
        return out

    @torch.no_grad()
    def rate_batch(
        self,
        batch: ActionBatch,
        *,
        dense_overrides: Optional[Dict[str, Any]] = None,
        bucket: bool = True,
    ) -> torch.Tensor:
        """Rate a packed multi-game batch -> ``(G, A, 3)`` values.

        Offensive, defensive and total VAEP value per action. ``bucket``
        pads the game axis to its power-of-two bucket (the JAX package's
        shape discipline; values of real games are unchanged) and slices the
        result back. ``dense_overrides`` substitutes precomputed
        ``(G, A, width)`` blocks for named dense feature kernels (a serving
        layer injects the whole-match ``goalscore`` block this way). Values
        on padding rows are garbage by contract.
        """
        clf_a, clf_b = self._heads()
        overrides = self._overrides_on_device(batch, dense_overrides)
        n_games = batch.n_games
        target = bucket_games(n_games) if bucket else n_games
        if target != n_games:
            batch = pad_batch_games(batch, target)
            overrides = {
                name: torch.cat([b, b.new_zeros((target - n_games, *b.shape[1:]))])
                for name, b in overrides.items()
            }
        pa, pb = pair_probs_prepared(
            self._prepared_pair(), clf_a, clf_b, batch,
            names=self.xfns, k=self.nb_prev_actions, dense_overrides=overrides,
        )
        return vaep_values(batch, pa, pb)[:n_games]

    @torch.no_grad()
    def rate_batch_reference(
        self,
        batch: ActionBatch,
        *,
        dense_overrides: Optional[Dict[str, Any]] = None,
    ) -> torch.Tensor:
        """Materialized-path rating: the same function as :meth:`rate_batch`
        through the full ``(G, A, F)`` feature tensor, in plain PyTorch."""
        clf_a, clf_b = self._heads()
        overrides = self._overrides_on_device(batch, dense_overrides)
        feats = compute_features(batch, names=self.xfns, k=self.nb_prev_actions)
        if overrides:
            layout = train_layout(self.xfns, self.nb_prev_actions)
            offsets = {name: off for name, _, off, _ in layout.spans}
            for name, block in overrides.items():
                feats[..., offsets[name] : offsets[name] + block.shape[-1]] = block
        return vaep_values(
            batch, clf_a.predict_proba_device(feats), clf_b.predict_proba_device(feats)
        )

    def rate(self, game: Any, game_actions: 'pd.DataFrame') -> 'pd.DataFrame':
        """Offensive/defensive/total VAEP value of each action of one game.

        ``game`` needs a ``home_team_id``; ``game_actions`` is the game's
        SPADL frame. Returns a frame indexed like ``game_actions``.
        """
        import pandas as pd

        batch, _ = pack_actions(
            game_actions, home_team_id=game.home_team_id, device=self.device
        )
        return pd.DataFrame(
            unpack_values(self.rate_batch(batch), batch),
            columns=['offensive_value', 'defensive_value', 'vaep_value'],
            index=game_actions.index,
        )


# -- loading checkpoints of the JAX package ------------------------------------


def _check_format_version(meta: Dict[str, Any], path: str) -> None:
    """Reject checkpoints written by a newer library than this one."""
    version = int(meta.get('format_version', 1))
    if version > CHECKPOINT_FORMAT_VERSION:
        raise ValueError(
            f'checkpoint at {path!r} has format_version={version}, newer than '
            f'this library understands (<= {CHECKPOINT_FORMAT_VERSION})'
        )


def _file_sha256(path: str) -> str:
    """Streaming sha256 hex digest of one file."""
    h = hashlib.sha256()
    with open(path, 'rb') as f:
        for chunk in iter(lambda: f.read(1 << 20), b''):
            h.update(chunk)
    return h.hexdigest()


def _verify_checksums(meta: Dict[str, Any], path: str) -> None:
    """Verify ``meta['checksums']`` before any artifact is deserialized.

    A missing or altered artifact raises a ``ValueError`` naming it.
    Checkpoints from before checksums (no entry) load as they are.
    """
    for rel, want in (meta.get('checksums') or {}).items():
        artifact = os.path.join(path, rel)
        try:
            got = _file_sha256(artifact)
        except FileNotFoundError:
            raise ValueError(
                f'checkpoint artifact missing: {artifact!r} is named in '
                "meta.json's checksums but absent on disk"
            ) from None
        if got != want:
            raise ValueError(
                f'checkpoint artifact corrupt: {artifact!r} sha256 {got[:12]}… '
                f'does not match the recorded {want[:12]}…'
            )


def load_model(path: str, *, device: DeviceLike = None) -> VAEP:
    """Load a directory written by the JAX package's ``VAEP.save_model``.

    Checks the format version and every artifact's sha256 before reading
    it, restores both MLP heads on ``device`` (default ``cuda``), the
    quantize mode and, for int8, the persisted scales, so the model serves
    the bytes the saved version served. Atomic-VAEP, tree and sequence
    heads are not ported yet and raise.
    """
    dev = resolve_device(device)
    with open(os.path.join(path, 'meta.json')) as f:
        meta = json.load(f)
    _check_format_version(meta, path)
    if meta['class'] != 'VAEP':
        raise ValueError(f'checkpoint class {meta["class"]!r} is not ported; only VAEP is')
    _verify_checksums(meta, path)
    models = {}
    for col, kind in meta['heads'].items():
        if kind != 'mlp':
            raise ValueError(f'head {col!r} is a {kind!r} head; only MLP heads are ported')
        models[col] = MLPClassifier.load(
            os.path.join(path, 'models', f'{col}.npz'), device=dev
        )
    quantize = check_quantize_mode(meta.get('quantize', 'none'))
    for m in models.values():
        if quantize != 'none':
            m.quantize = quantize
    model = VAEP(meta['xfns'], meta['nb_prev_actions'], models=models, device=dev)
    scales_path = os.path.join(path, _QUANT_SCALES_ARTIFACT)
    if quantize == 'int8' and os.path.isfile(scales_path):
        with np.load(scales_path) as data:
            model._quant_scales = {
                name: torch.as_tensor(np.asarray(data[name], dtype=np.float32), device=dev)
                for name in ('table_scale', 'w_dense_scale')
            }
    return model
