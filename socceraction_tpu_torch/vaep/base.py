"""VAEP: valuing actions by estimating probabilities.

Port of ``socceraction_tpu/vaep/base.py``. A :class:`VAEP` holds a scores
head and a concedes head
(:class:`~socceraction_tpu_torch.ml.mlp.MLPClassifier`), trains them from
packed batches and rates packed batches:

- :meth:`VAEP.fit_packed` packs the training states, computes labels and
  standardization statistics from the packed form and trains both heads
  with Adam through the fused first layer (the CUDA kernel on the card),
  early-stopping on a validation split;
- :meth:`VAEP.rate_batch` is the serving path: both heads' first layers
  folded once into combined tables (optionally bf16/int8), one fused
  gather + matmul first layer per batch, the hidden chains, and the VAEP
  formula;
- :meth:`VAEP.rate_batch_reference` is the same function through the
  materialized feature tensor, in plain PyTorch, for parity checks.

:meth:`VAEP.save_model` writes, and :func:`load_model` reads, the JAX
package's checkpoint directory (``meta.json`` with its format stamp and
sha256 checksums, flax-msgpack heads), so a model moves between the two
packages either way.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
from typing import TYPE_CHECKING, Any, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import NB_PREV_ACTIONS
from ..core.batch import ActionBatch, bucket_games, pack_actions, pad_batch_games, unpack_values
from ..device import DeviceLike, resolve_device
from ..ml.learners import PACKED_LEARNERS
from ..ml.mlp import MLPClassifier
from ..ops.features import KERNELS, compute_features
from ..ops.formula import vaep_values
from ..ops.fused import (
    PreparedPair,
    TrainLayout,
    TrainStates,
    build_train_states,
    concat_train_states,
    packed_feature_stats,
    pair_probs_prepared,
    prepare_pair_fold,
    take_train_states,
    train_layout,
)
from ..ops.labels import scores_concedes
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
    """Raised when a model without heads is asked to rate or save."""


class TrainingSet(NamedTuple):
    """The packed rows :meth:`VAEP.fit_packed` trains on, split.

    ``train_rows``/``val_rows`` are the host row indices of the split;
    ``val`` and ``y_val`` are ``None`` without a validation split.
    """

    train: TrainStates
    val: Optional[TrainStates]
    y_train: Dict[str, torch.Tensor]
    y_val: Optional[Dict[str, torch.Tensor]]
    layout: TrainLayout
    train_rows: np.ndarray
    val_rows: np.ndarray


def split_rows(
    n_rows: int, val_size: float, random_state: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's train/validation row split, with numpy.

    ``default_rng(random_state).permutation(n_rows)`` (the global numpy
    generator without a seed), cut at ``floor(n_rows * (1 - val_size))``;
    the reference's quirk is kept: the row at the cut is in neither part.
    The JAX package splits with the same draws.
    """
    if random_state is not None:
        idx = np.random.default_rng(random_state).permutation(n_rows)
    else:
        idx = np.random.permutation(n_rows)
    cut = math.floor(n_rows * (1 - val_size))
    return idx[:cut], idx[cut + 1 :]


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

    # -- fitting -------------------------------------------------------------

    @staticmethod
    def _iter_packed(batches: Any) -> Iterator[Any]:
        """``fit_packed``'s input as an iterator of batches or
        ``(batch, game_ids)`` pairs."""
        if isinstance(batches, ActionBatch):
            return iter([batches])
        if isinstance(batches, tuple) and len(batches) == 2 and isinstance(batches[0], ActionBatch):
            return iter([batches])  # one (batch, game_ids) pair
        return iter(batches)

    def training_set(
        self, batches: Any, val_size: float = 0.25, random_state: Optional[int] = None
    ) -> TrainingSet:
        """Pack ``batches``, label them and split the rows (:func:`split_rows`).

        The first part of :meth:`fit_packed`, on the model's device; a
        check of two fits can compare what each trained on.
        """
        chunks: List[TrainStates] = []
        label_chunks: List[Tuple[torch.Tensor, ...]] = []
        layout = None
        for item in self._iter_packed(batches):
            batch = item[0] if isinstance(item, (tuple, list)) else item
            if batch.device != self.device:
                raise ValueError(f'batch lives on {batch.device}, the model on {self.device}')
            states, chunk_layout = build_train_states(
                batch, names=self.xfns, k=self.nb_prev_actions
            )
            if layout is None:
                layout = chunk_layout
            elif chunk_layout != layout:
                raise ValueError('packed chunks disagree on feature layout')
            chunks.append(states)
            label_chunks.append(
                tuple(t.reshape(-1).to(torch.float32) for t in scores_concedes(batch))
            )
        if layout is None:
            raise ValueError('fit_packed received no batches')
        states = concat_train_states(chunks)
        labels = {
            col: torch.cat([c[i] for c in label_chunks]) for i, col in enumerate(_LABELS)
        }
        train_rows, val_rows = split_rows(int(states.weight.shape[0]), val_size, random_state)
        tr = torch.as_tensor(train_rows, device=self.device)
        va = torch.as_tensor(val_rows, device=self.device)
        with_val = val_size > 0
        return TrainingSet(
            train=take_train_states(states, tr),
            val=take_train_states(states, va) if with_val else None,
            y_train={col: y.index_select(0, tr) for col, y in labels.items()},
            y_val={col: y.index_select(0, va) for col, y in labels.items()} if with_val else None,
            layout=layout,
            train_rows=train_rows,
            val_rows=val_rows,
        )

    def fit_packed(
        self,
        batches: Any,
        learner: str = 'mlp',
        val_size: float = 0.25,
        tree_params: Optional[Dict[str, Any]] = None,
        fit_params: Optional[Dict[str, Any]] = None,
        random_state: Optional[int] = None,
        warm_start: Optional['VAEP'] = None,
    ) -> 'VAEP':
        """Fit both probability heads from packed game states.

        Parameters
        ----------
        batches
            An :class:`~socceraction_tpu_torch.core.batch.ActionBatch` on
            the model's device, an iterable of them, or an iterable of
            ``(batch, game_ids)`` pairs.
        learner : str
            ``'mlp'``: the fused MLP head. The sequence head (``'seq'``) is
            not ported yet; tree learners need the feature matrix.
        val_size : float
            Row fraction held out for early stopping (reference: 0.25).
        tree_params, fit_params : dict, optional
            :class:`~socceraction_tpu_torch.ml.mlp.MLPClassifier` arguments
            and ``fit_packed`` arguments of each head.
        random_state : int, optional
            Seed of the train/validation split (:func:`split_rows`).
        warm_start : VAEP, optional
            A fitted model of the same feature layout whose heads seed this
            fit: its parameters and Adam state, its hyperparameters (unless
            ``tree_params`` overrides them) and its standardization
            statistics, which the copied weights are a function of. It is
            never changed.

        One statistics pass over the training rows serves both heads. The
        cached serving fold is dropped, so the next rating folds the new
        heads.
        """
        if learner == 'seq':
            raise ValueError("learner 'seq': the sequence head is not ported yet")
        if learner not in PACKED_LEARNERS:
            raise ValueError(
                f'learner {learner!r} has no packed fit path (supported: '
                f'{sorted(PACKED_LEARNERS)}); tree learners need the materialized '
                'feature matrix'
            )
        data = self.training_set(batches, val_size, random_state)
        warm_models: Dict[str, MLPClassifier] = {}
        if warm_start is not None:
            warm_models = dict(warm_start._models)
            if not warm_models:
                raise ValueError('warm_start must be a fitted model')
        warm_head = next(iter(warm_models.values()), None)
        if warm_head is not None:
            if warm_head.mean_.shape[0] != data.layout.n_features:
                raise ValueError(
                    'warm_start model has a different feature layout '
                    f'({warm_head.mean_.shape[0]} features vs {data.layout.n_features}); '
                    'warm starts require an unchanged layout'
                )
            mean = warm_head.mean_.to(self.device)
            std = warm_head.std_.to(self.device)
        else:
            mean, raw_std = packed_feature_stats(data.train, data.layout)
            std = torch.where(raw_std > 0, raw_std, 1.0)
        fit_fn = PACKED_LEARNERS[learner]
        models = {}
        for col in _LABELS:
            eval_set = None
            if data.val is not None:
                eval_set = [((data.val, data.layout), data.y_val[col])]
            head_tree, head_fit = tree_params, fit_params
            warm = warm_models.get(col)
            if warm is not None:
                head_tree = {**warm._hyperparameters(), **(tree_params or {})}
                head_fit = {
                    'init_params': warm.module,
                    **({} if warm.opt_state_ is None else {'init_opt_state': warm.opt_state_}),
                    **(fit_params or {}),
                }
            models[col] = fit_fn(
                (data.train, data.layout), data.y_train[col], eval_set, head_tree, head_fit,
                names=self.xfns, k=self.nb_prev_actions, mean=mean, std=std,
                device=self.device,
            )
        self._models = models
        # pinned int8 scales describe the weights they were derived from
        self._pair_prep = None
        self._quant_scales = None
        return self

    # -- saving ----------------------------------------------------------------

    def save_model(self, path: str) -> None:
        """Write the model as the JAX package's ``save_model`` does.

        ``models/<head>.npz`` per head (:meth:`MLPClassifier.save`),
        ``models/quant_scales.npz`` with the fold's int8 scales when the
        model serves int8, and ``meta.json`` with the format stamp (the
        oldest reader that can load it: 2 with a quantize mode, else 1)
        and every artifact's sha256. Both packages' ``load_model`` read it.
        """
        if not self._models:
            raise NotFittedError('fit the model before saving')
        os.makedirs(os.path.join(path, 'models'), exist_ok=True)
        artifacts = []
        for col, model in self._models.items():
            model.save(os.path.join(path, 'models', f'{col}.npz'))
            artifacts.append(f'models/{col}.npz')
        quantize = self.quantize
        if quantize == 'int8':
            prep = self._prepared_pair()
            np.savez(
                os.path.join(path, _QUANT_SCALES_ARTIFACT),
                table_scale=prep.tables.scale.cpu().numpy(),
                w_dense_scale=prep.w_dense.scale.cpu().numpy(),
            )
            artifacts.append(_QUANT_SCALES_ARTIFACT)
        meta = {
            'format_version': 2 if quantize != 'none' else 1,
            'class': 'VAEP',
            'nb_prev_actions': self.nb_prev_actions,
            # the JAX package's loader builds its model with this backend
            'backend': 'jax',
            'xfns': list(self.xfns),
            'heads': dict.fromkeys(self._models, 'mlp'),
            **({'quantize': quantize} if quantize != 'none' else {}),
            'checksums': {
                rel: _file_sha256(os.path.join(path, rel)) for rel in sorted(artifacts)
            },
        }
        with open(os.path.join(path, 'meta.json'), 'w') as f:
            json.dump(meta, f, indent=2)

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
