"""VAEP: valuing actions by estimating probabilities.

Port of ``socceraction_tpu/vaep/base.py``. A :class:`VAEP` holds a scores
head and a concedes head, both MLPs
(:class:`~socceraction_tpu_torch.ml.mlp.MLPClassifier`) or both GRU
sequence heads (:class:`~socceraction_tpu_torch.seq.classifier.SeqClassifier`),
trains them from packed batches and rates packed batches:

- :meth:`VAEP.fit_packed` packs the training states, computes labels and
  standardization statistics from the packed form and trains both heads
  with Adam, the MLP through the fused first layer (the CUDA kernel on the
  card), early-stopping on a validation split;
- :meth:`VAEP.rate_batch` is the serving path, on one of four paths
  chosen as the JAX package chooses them (:mod:`~..ops.profile`: the
  measured platform profile, ``SOCCERACTION_TPU_RATING_PATH``). MLP heads
  on ``'fused'``: both heads' first layers folded once into combined
  tables (optionally bf16/int8), one fused gather + matmul first layer
  per batch, the hidden chains, and the VAEP formula; ``'fused_bf16'``
  the same with a bf16 hidden chain. Seq heads (``'seq'``): both heads
  over one packing of the batch. ``'materialized'`` (forced, or a mixed
  MLP/seq pair): the feature tensor for the MLP head, the packed rows for
  a seq head (:meth:`VAEP._estimate_probabilities_batch`);
- :meth:`VAEP.rate_batch_reference` is the same function through each
  head's reference representation (the feature tensor, or a fresh
  packing for a seq head), in plain PyTorch, for parity checks.

The DataFrame layer is the JAX package's, on SPADL frames of one game:
:meth:`VAEP.compute_features` and :meth:`VAEP.compute_labels` on the
device kernels (``backend='torch'``, the default) or the pandas oracle
transformers of :mod:`.features`, :mod:`.labels` and :mod:`.formula`
(``backend='pandas'``); :meth:`VAEP.fit` on a feature frame with any
learner of :data:`~socceraction_tpu_torch.ml.learners.LEARNERS` (the MLP
trains on the model's device, the tree learners on the host);
:meth:`VAEP.rate` and :meth:`VAEP.score`. Tree heads rate on the host:
the batch paths hand them a host copy of the feature tensor.

The feature family (kernels, labels, formula, fused layout, batch class,
pandas transformers) is a set of class-level handles, which
:class:`~socceraction_tpu_torch.atomic.vaep.base.AtomicVAEP` swaps.
:meth:`VAEP.save_model` writes, and :func:`load_model` reads, the JAX
package's checkpoint directory (``meta.json`` with its class, format
stamp and sha256 checksums, flax-msgpack heads, pickled tree heads), so a
model moves between the two packages either way.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import pickle
import time
from typing import (
    TYPE_CHECKING, Any, Callable, Dict, Iterator, List, Mapping, NamedTuple, Optional, Sequence,
    Tuple, Union,
)

import numpy as np
import torch

from .. import spadl as _spadl_pkg
from ..config import NB_PREV_ACTIONS
from ..core.batch import (
    ActionBatch,
    _PackedBatch,
    bucket_games,
    pack_actions,
    pad_batch_games,
    unpack_values,
)
from ..device import DeviceLike, resolve_device
from ..ml.learners import LEARNERS, PACKED_LEARNERS
from ..ml.mlp import MLPClassifier
from ..obs import counter, gauge, histogram, span
from ..ops.features import KERNELS, compute_features
from ..ops.formula import vaep_values
from ..ops.fused import (
    REGISTRIES,
    FusedRegistry,
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
from ..ops.profile import FUSED_PATH_HIDDEN_DTYPES, hidden_dtype_for, preferred_rating_path
from ..ops.quant import check_quantize_mode
from ..seq.classifier import SeqClassifier
from ..seq.model import seq_pair_probs
from . import features as fs
from . import formula as vaepformula
from . import labels as lab

if TYPE_CHECKING:  # pandas is imported inside the methods that take or build frames
    import pandas as pd

__all__ = [
    'CHECKPOINT_FORMAT_VERSION', 'NotFittedError', 'VAEP', 'XFNS_DEFAULT', 'load_model',
    'xfns_default',
]

#: Newest ``save_model`` directory format this port reads (the JAX
#: package's ``CHECKPOINT_FORMAT_VERSION``).
CHECKPOINT_FORMAT_VERSION = 3

#: int8 scales persisted beside the heads of a quantized checkpoint.
_QUANT_SCALES_ARTIFACT = 'models/quant_scales.npz'

#: The reference's 14 default feature transformers.
xfns_default: List[fs.FeatureTransfomer] = [
    fs.actiontype_onehot,
    fs.result_onehot,
    fs.actiontype_result_onehot,
    fs.bodypart_onehot,
    fs.time,
    fs.startlocation,
    fs.endlocation,
    fs.startpolar,
    fs.endpolar,
    fs.movement,
    fs.team,
    fs.time_delta,
    fs.space_delta,
    fs.goalscore,
]

#: The same transformers by name: the kernels of the device path.
XFNS_DEFAULT: Tuple[str, ...] = tuple(fn.__name__ for fn in xfns_default)

_LABELS = ('scores', 'concedes')

#: A feature transformer: a callable of :mod:`.features` (or a custom one,
#: pandas backend only) or the name of one.
Transformer = Union[str, Callable[..., Any]]

#: The head class of each packed learner. A warm head seeds a fit only when
#: its class is the learner's: an MLP cannot seed a GRU, nor the reverse.
_PACKED_HEAD_KINDS: Dict[str, type] = {'mlp': MLPClassifier, 'seq': SeqClassifier}


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


def _default_learner() -> str:
    """``'xgboost'`` when it is installed, else ``'sklearn'`` (the JAX
    package's default)."""
    try:
        import xgboost  # noqa: F401

        return 'xgboost'
    except ImportError:
        return 'sklearn'


def _take_rows(data: Any, rows: np.ndarray) -> Any:
    """Rows ``rows`` of a frame or series (by position) or of an array."""
    return data.iloc[rows] if hasattr(data, 'iloc') else data[rows]


class VAEP:
    """Valuing Actions by Estimating Probabilities, on frames and on packed
    batches of SPADL actions.

    Parameters
    ----------
    xfns : sequence of transformers, optional
        Feature transformers in column order: callables of
        :mod:`.features` or their names (default: the reference's 14,
        :data:`xfns_default`). The device path resolves each to its kernel
        by ``__name__``; a custom transformer with no kernel serves the
        pandas backend only. :attr:`xfns` holds their names.
    nb_prev_actions : int
        Game states per action (default 3).
    backend : {'torch', 'pandas'}
        How :meth:`compute_features`, :meth:`compute_labels` and
        :meth:`rate` treat a frame: the device kernels on the model's
        device (``'torch'``, default) or the pandas oracle transformers.
        The batch entry points always run on the device.
    models : dict, optional
        ``{'scores': head, 'concedes': head}``, each an ``MLPClassifier``
        or a ``SeqClassifier`` on ``device`` (a mixed pair rates on the
        materialized path), or a fitted tree classifier (it rates on the
        host).
    device
        Where the model runs: ``cuda`` (default) or ``'cpu'``.
    """

    # the feature family, swapped by AtomicVAEP
    _default_xfns: Tuple[str, ...] = XFNS_DEFAULT
    _kernels: Dict[str, Any] = KERNELS
    _spadlcfg: Any = _spadl_pkg
    _fs: Any = fs
    _lab: Any = lab
    _vaep: Any = vaepformula
    _compute_features_kernel = staticmethod(compute_features)
    _labels_kernel = staticmethod(scores_concedes)
    _formula_kernel = staticmethod(vaep_values)
    _fused_registry = 'standard'  # the family's key in ops.fused.REGISTRIES
    _batch_class: type = ActionBatch
    _pack = staticmethod(pack_actions)

    def __init__(
        self,
        xfns: Optional[Sequence[Transformer]] = None,
        nb_prev_actions: int = NB_PREV_ACTIONS,
        backend: str = 'torch',
        *,
        models: Optional[Dict[str, Any]] = None,
        device: DeviceLike = None,
    ) -> None:
        if backend not in ('torch', 'pandas'):
            raise ValueError(f'unknown backend {backend!r}')
        self.device = resolve_device(device)
        self.backend = backend
        self._transformers = [
            self._transformer(fn) for fn in (self._default_xfns if xfns is None else xfns)
        ]
        self.xfns = tuple(getattr(fn, '__name__', repr(fn)) for fn in self._transformers)
        self.nb_prev_actions = nb_prev_actions
        self.yfns = [self._lab.scores, self._lab.concedes]
        self._feature_names: Dict[Tuple[Any, ...], List[str]] = {}
        self._models: Dict[str, Any] = {}
        if models is not None:
            if sorted(models) != sorted(_LABELS):
                raise ValueError(f'models must be exactly {_LABELS}, got {sorted(models)}')
            for col, clf in models.items():
                if isinstance(clf, (MLPClassifier, SeqClassifier)) and clf.mean_.device != self.device:
                    raise ValueError(
                        f'head {col!r} lives on {clf.mean_.device}, the model on {self.device}'
                    )
            self._models = {col: models[col] for col in _LABELS}
        #: cached (key, PreparedPair) serving fold, see _prepared_pair
        self._pair_prep: Optional[Tuple[Any, PreparedPair]] = None
        #: cached (key, {dense kernel: width}), see _dense_override_widths
        self._dense_widths: Optional[Tuple[Any, Dict[str, int]]] = None
        #: int8 scales restored from a quantized checkpoint (or None)
        self._quant_scales: Optional[Dict[str, torch.Tensor]] = None

    @property
    def _registry(self) -> FusedRegistry:
        return REGISTRIES[self._fused_registry]

    def _transformer(self, fn: Transformer) -> Callable[..., Any]:
        """A transformer of the family's feature module, given or by name."""
        if not isinstance(fn, str):
            return fn
        found = getattr(self._fs, fn, None)
        if fn not in self._kernels or found is None:
            raise ValueError(f'feature transformer {fn!r} has no kernel')
        return found

    def _kernel_names(self) -> Tuple[str, ...]:
        """The transformers' kernel names, for the device path: a
        transformer without a kernel raises."""
        for name in self.xfns:
            if name not in self._kernels:
                raise ValueError(
                    f'feature transformer {name!r} has no kernel; '
                    "use backend='pandas' for custom transformers"
                )
        return self.xfns

    def _drop_stale_quant_state(self) -> None:
        """Drop the serving fold and any pinned int8 scales after a fit:
        the scales describe the weights they were derived from."""
        self._pair_prep = None
        self._quant_scales = None

    # -- frames ----------------------------------------------------------------

    @property
    def feature_names(self) -> List[str]:
        """The feature frame's column names, as the reference derives them
        (the transformers run on a dummy frame), cached per
        ``(transformers, nb_prev_actions)``."""
        key = (tuple(self._transformers), self.nb_prev_actions)
        names = self._feature_names.get(key)
        if names is None:
            names = self._fs.feature_column_names(self._transformers, self.nb_prev_actions)
            self._feature_names[key] = names
        return names

    def features_rows(self, batch: Any) -> np.ndarray:
        """The ``(n, F)`` host feature rows of a batch's valid actions, in
        the packed frame's row order and :attr:`feature_names`' column
        order: what :meth:`compute_features` puts in its frame."""
        return unpack_values(self.compute_features_batch(batch), batch)

    def labels_rows(self, batch: Any) -> Dict[str, np.ndarray]:
        """``{label: (n,) bool}`` host labels of a batch's valid actions:
        what :meth:`compute_labels` puts in its frame."""
        tensors = self.compute_labels_batch(batch)
        return {col: unpack_values(t, batch).astype(bool) for col, t in zip(_LABELS, tensors)}

    def compute_features(self, game: Any, game_actions: 'pd.DataFrame') -> 'pd.DataFrame':
        """Feature representation of each game state of one game.

        ``game`` needs a ``home_team_id``; ``game_actions`` is the game's
        frame in this model's action language. The default backend packs
        the game and runs the kernels on the model's device; ``'pandas'``
        runs the oracle transformers.
        """
        import pandas as pd

        if self.backend == 'torch':
            batch, _ = self._pack(game_actions, home_team_id=game.home_team_id, device=self.device)
            return pd.DataFrame(
                self.features_rows(batch), columns=self.feature_names, index=game_actions.index
            )
        actions = self._spadlcfg.add_names(game_actions)
        states = self._fs.gamestates(actions, self.nb_prev_actions)
        states = self._fs.play_left_to_right(states, game.home_team_id)
        return pd.concat([fn(states) for fn in self._transformers], axis=1)

    def compute_labels(self, game: Any, game_actions: 'pd.DataFrame') -> 'pd.DataFrame':
        """The ``scores`` and ``concedes`` labels of each game state of one
        game (bool columns), on the backend's path."""
        import pandas as pd

        if self.backend == 'torch':
            batch, _ = self._pack(game_actions, home_team_id=game.home_team_id, device=self.device)
            return pd.DataFrame(self.labels_rows(batch), index=game_actions.index)
        actions = self._spadlcfg.add_names(game_actions)
        return pd.concat([fn(actions) for fn in self.yfns], axis=1)

    def _check_columns(self, X: 'pd.DataFrame') -> List[str]:
        cols = self.feature_names
        if not set(cols).issubset(set(X.columns)):
            missing = ' and '.join(set(cols).difference(X.columns))
            raise ValueError(f'{missing} are not available in the features dataframe')
        return cols

    def fit(
        self,
        X: 'pd.DataFrame',
        y: 'pd.DataFrame',
        learner: Optional[str] = None,
        val_size: float = 0.25,
        tree_params: Optional[Dict[str, Any]] = None,
        fit_params: Optional[Dict[str, Any]] = None,
        random_state: Optional[int] = None,
    ) -> 'VAEP':
        """Fit one probability head per label column of ``y`` on the
        feature frame ``X``.

        ``learner`` is a key of
        :data:`~socceraction_tpu_torch.ml.learners.LEARNERS` (default
        ``'xgboost'`` when installed, else ``'sklearn'``); ``'mlp'`` trains
        on the model's device. The columns :attr:`feature_names` are
        selected and :meth:`fit_rows` does the rest.
        """
        cols = self._check_columns(X)
        self.fit_rows(
            X[cols], {col: y[col] for col in y.columns},
            learner=_default_learner() if learner is None else learner, val_size=val_size,
            tree_params=tree_params, fit_params=fit_params, random_state=random_state,
        )
        return self

    def fit_rows(
        self,
        X: Any,
        y: Mapping[str, Any],
        learner: str,
        val_size: float = 0.25,
        tree_params: Optional[Dict[str, Any]] = None,
        fit_params: Optional[Dict[str, Any]] = None,
        random_state: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """:meth:`fit` after it selects the columns: the split and one
        learner call per label.

        ``X`` is the ``(n, F)`` feature rows (a frame or an array) and
        ``y`` one ``(n,)`` label column per head. The rows split as
        :func:`split_rows` splits them (the row at the cut is in neither
        part); the validation rows are the learner's eval set. The MLP
        learner trains on the model's device unless ``tree_params`` names
        another. Returns the train and validation row indices.
        """
        if learner not in LEARNERS:
            raise ValueError(f'a {learner!r} learner is not supported')
        train_rows, val_rows = split_rows(len(X), val_size, random_state)
        if learner == 'mlp':
            tree_params = {'device': self.device, **(tree_params or {})}
        X_train, X_val = _take_rows(X, train_rows), _take_rows(X, val_rows)
        fit_fn = LEARNERS[learner]
        models = {}
        for col, labels in y.items():
            eval_set = [(X_val, _take_rows(labels, val_rows))] if val_size > 0 else None
            models[col] = fit_fn(
                X_train, _take_rows(labels, train_rows), eval_set, tree_params, fit_params
            )
        self._models = models
        self._drop_stale_quant_state()
        return train_rows, val_rows

    def _estimate_probabilities(self, X: 'pd.DataFrame') -> 'pd.DataFrame':
        """Each head's probability of each row of a feature frame."""
        import pandas as pd

        cols = self._check_columns(X)
        Y_hat = pd.DataFrame(index=X.index)
        for col, model in self._models.items():
            Y_hat[col] = model.predict_proba(X[cols])[:, 1]
        return Y_hat

    def score(self, X: 'pd.DataFrame', y: 'pd.DataFrame') -> Dict[str, Dict[str, float]]:
        """Brier score and ROC-AUC of each probability head on ``(X, y)``."""
        from sklearn.metrics import brier_score_loss, roc_auc_score

        if not self._models:
            raise NotFittedError('fit the model before calling score')
        y_hat = self._estimate_probabilities(X)
        return {
            col: {
                'brier': brier_score_loss(y[col], y_hat[col]),
                'auroc': roc_auc_score(y[col], y_hat[col]),
            }
            for col in self._models
        }

    # -- fitting -------------------------------------------------------------

    @staticmethod
    def _iter_packed(batches: Any) -> Iterator[Any]:
        """``fit_packed``'s input as an iterator of batches or
        ``(batch, game_ids)`` pairs."""
        if isinstance(batches, _PackedBatch):
            return iter([batches])
        if isinstance(batches, tuple) and len(batches) == 2 and isinstance(batches[0], _PackedBatch):
            return iter([batches])  # one (batch, game_ids) pair
        return iter(batches)

    def _check_batch(self, batch: Any) -> None:
        """Raise unless ``batch`` is this family's batch class on the model's device."""
        if not isinstance(batch, self._batch_class):
            raise TypeError(
                f'{type(self).__name__} takes {self._batch_class.__name__}, '
                f'got {type(batch).__name__}'
            )
        if batch.device != self.device:
            raise ValueError(f'batch lives on {batch.device}, the model on {self.device}')

    def training_set(
        self, batches: Any, val_size: float = 0.25, random_state: Optional[int] = None
    ) -> TrainingSet:
        """Pack ``batches``, label them and split the rows (:func:`split_rows`).

        The first part of :meth:`fit_packed`, on the model's device; a
        check of two fits can compare what each trained on.
        """
        names = self._kernel_names()
        chunks: List[TrainStates] = []
        label_chunks: List[Tuple[torch.Tensor, ...]] = []
        layout = None
        for item in self._iter_packed(batches):
            batch = item[0] if isinstance(item, (tuple, list)) else item
            self._check_batch(batch)
            states, chunk_layout = build_train_states(
                batch, names=names, k=self.nb_prev_actions, registry=self._registry
            )
            if layout is None:
                layout = chunk_layout
            elif chunk_layout != layout:
                raise ValueError('packed chunks disagree on feature layout')
            chunks.append(states)
            label_chunks.append(
                tuple(t.reshape(-1).to(torch.float32) for t in self._labels_kernel(batch))
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
            A packed batch of this model's family (an
            :class:`~socceraction_tpu_torch.core.batch.ActionBatch`, for
            Atomic-VAEP an ``AtomicActionBatch``) on the model's device, an
            iterable of them, or an iterable of ``(batch, game_ids)`` pairs.
        learner : str
            ``'mlp'``: the fused MLP head; ``'seq'``: the GRU sequence head.
            Tree learners need the feature matrix and raise.
        val_size : float
            Row fraction held out for early stopping (reference: 0.25).
        tree_params, fit_params : dict, optional
            The head classifier's constructor arguments and ``fit_packed``
            arguments of each head.
        random_state : int, optional
            Seed of the train/validation split (:func:`split_rows`).
        warm_start : VAEP, optional
            A fitted model of the same feature layout. Each of its heads of
            the learner's class seeds this fit: its parameters and Adam
            state, its hyperparameters (unless ``tree_params`` overrides
            them) and its standardization statistics, which the copied
            weights are a function of. A head of the other architecture
            copies nothing, and the fit computes fresh statistics. The
            warm model is never changed.

        One statistics pass over the training rows serves both heads. The
        cached serving fold is dropped, so the next rating folds the new
        heads.
        """
        if learner not in PACKED_LEARNERS:
            raise ValueError(
                f'learner {learner!r} has no packed fit path (supported: '
                f'{sorted(PACKED_LEARNERS)}); tree learners need the materialized '
                'feature matrix'
            )
        data = self.training_set(batches, val_size, random_state)
        head_cls = _PACKED_HEAD_KINDS[learner]
        warm_models: Dict[str, Any] = {}
        if warm_start is not None:
            if not warm_start._models:
                raise ValueError('warm_start must be a fitted model')
            warm_models = {
                col: m for col, m in warm_start._models.items() if isinstance(m, head_cls)
            }
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
                names=self.xfns, k=self.nb_prev_actions, registry=self._fused_registry,
                mean=mean, std=std, device=self.device,
            )
        self._models = models
        self._drop_stale_quant_state()
        return self

    # -- saving ----------------------------------------------------------------

    def save_model(self, path: str) -> None:
        """Write the model as the JAX package's ``save_model`` does.

        ``models/<head>.npz`` per MLP or seq head (:meth:`MLPClassifier.save`
        or :meth:`SeqClassifier.save`), ``models/<head>.pkl`` per tree head
        (pickled), ``models/quant_scales.npz`` with the fold's int8 scales
        when the model serves int8, and ``meta.json`` with the model's
        class, backend, transformer names, each head's kind, the format
        stamp (the oldest reader that can load it: 3 with a seq head, 2
        with a quantize mode, else 1) and every artifact's sha256. Both
        packages' ``load_model`` read it. Transformers are stored by name,
        so a custom one cannot be saved.
        """
        self._heads()
        for fn, name in zip(self._transformers, self.xfns):
            if getattr(self._fs, name, None) is not fn:
                raise ValueError(
                    f'cannot serialize custom feature transformer {fn!r}; only named '
                    'transformers from the feature module are supported'
                )
        os.makedirs(os.path.join(path, 'models'), exist_ok=True)
        artifacts = []
        heads = {}
        for col, model in self._models.items():
            if isinstance(model, (MLPClassifier, SeqClassifier)):
                heads[col] = 'seq' if isinstance(model, SeqClassifier) else 'mlp'
                model.save(os.path.join(path, 'models', f'{col}.npz'))
                artifacts.append(f'models/{col}.npz')
            else:
                heads[col] = 'pickle'
                with open(os.path.join(path, 'models', f'{col}.pkl'), 'wb') as f:
                    pickle.dump(model, f)
                artifacts.append(f'models/{col}.pkl')
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
            'format_version': 3 if 'seq' in heads.values() else 2 if quantize != 'none' else 1,
            'class': type(self).__name__,
            'nb_prev_actions': self.nb_prev_actions,
            # the JAX package's name of the device backend is 'jax'
            'backend': 'jax' if self.backend == 'torch' else self.backend,
            'xfns': list(self.xfns),
            'heads': heads,
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
        """The MLP heads' shared table-storage mode: ``'none'``, ``'bf16'``
        or ``'int8'`` (seq heads serve f32: ``'none'``)."""
        modes = {m.quantize for m in self._models.values() if isinstance(m, MLPClassifier)}
        if len(modes) > 1:
            raise ValueError(f'heads disagree on quantize mode: {sorted(modes)}')
        return modes.pop() if modes else 'none'

    def set_quantize(self, mode: str) -> 'VAEP':
        """Set the serving table-storage mode on both MLP heads.

        The prepared fold is rebuilt on the next rating; persisted int8
        scales are dropped when the mode changes. A narrow mode needs MLP
        heads: seq heads have no fold to quantize.
        """
        check_quantize_mode(mode)
        if mode != 'none':
            if not self._models:
                raise NotFittedError('load or set the heads before set_quantize')
            non_mlp = [c for c, m in self._models.items() if not isinstance(m, MLPClassifier)]
            if non_mlp:
                raise ValueError(
                    f'quantized serving needs MLP heads; {non_mlp!r} are not (a seq head '
                    'has no fused fold to quantize)'
                )
        changed = mode != self.quantize
        for m in self._models.values():
            if isinstance(m, MLPClassifier):
                m.quantize = mode
        self._pair_prep = None
        if changed:
            self._quant_scales = None
        return self

    def _heads(self) -> Tuple[Any, Any]:
        if not self._models:
            raise NotFittedError('this model has no heads: fit or load them first')
        return self._models[_LABELS[0]], self._models[_LABELS[1]]

    def _can_fuse(self) -> bool:
        """True when the fused fold applies: every head is an MLP."""
        return bool(self._models) and all(
            isinstance(m, MLPClassifier) for m in self._models.values()
        )

    def _can_seq(self) -> bool:
        """True when the seq pair dispatch applies: every head is a GRU
        sequence head."""
        return bool(self._models) and all(
            isinstance(m, SeqClassifier) for m in self._models.values()
        )

    @property
    def time_rungs(self) -> bool:
        """True when serving should bucket the action axis too
        (:func:`~socceraction_tpu_torch.core.batch.bucket_window`): seq
        heads, whose kernels look only backward over masked tails, so a
        window cut to its rung rates bitwise as the full one. MLP models
        keep the full action axis."""
        return self._can_seq()

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
            names=self._kernel_names(),
            k=self.nb_prev_actions,
            registry=self._registry,
            quantize=mode,
            table_scale=scales.get('table_scale'),
            w_dense_scale=scales.get('w_dense_scale'),
        )
        self._pair_prep = (key, prep)
        return prep

    def warm_serving(self) -> Optional[PreparedPair]:
        """Build the serving fold now, so that its tables are resident
        before the first rating; ``None`` unless both heads are MLPs."""
        return self._prepared_pair() if self._can_fuse() else None

    def serving_arrays(self) -> List[torch.Tensor]:
        """The cached serving fold's device tensors (residency claims)."""
        cached = self._pair_prep
        return cached[1].arrays() if cached is not None else []

    def serving_table_bytes(self) -> Optional[int]:
        """Device bytes of the cached fold's combined tables (and int8
        scales), or ``None`` before a fold is built."""
        cached = self._pair_prep
        return cached[1].table_nbytes if cached is not None else None

    @staticmethod
    def _bucketable(batch: Any) -> bool:
        """True when the game axis may be padded: every field on one
        device."""
        return len({t.device for t in batch.fields().values()}) <= 1

    # -- rating ------------------------------------------------------------

    def compute_features_batch(self, batch: Any) -> torch.Tensor:
        """The ``(G, A, F)`` feature tensor of a batch, on its device."""
        return self._compute_features_kernel(
            batch, names=self._kernel_names(), k=self.nb_prev_actions
        )

    def compute_labels_batch(self, batch: Any) -> Tuple[torch.Tensor, torch.Tensor]:
        """The ``(G, A)`` scores and concedes labels of a batch."""
        return self._labels_kernel(batch)

    def _dense_override_widths(self) -> Dict[str, int]:
        """``{kernel name: width}`` of the overridable (dense) blocks,
        cached per (feature set, k, family)."""
        key = (self.xfns, self.nb_prev_actions, self._fused_registry)
        cached = self._dense_widths
        if cached is None or cached[0] != key:
            layout = train_layout(self.xfns, self.nb_prev_actions, self._registry)
            widths = {name: width for name, kind, _, width in layout.spans if kind == 'dense'}
            cached = self._dense_widths = (key, widths)
        return cached[1]

    def _overrides_on_device(
        self, batch: Any, dense_overrides: Optional[Dict[str, Any]]
    ) -> Dict[str, torch.Tensor]:
        """Check the batch, validate ``dense_overrides`` by name and shape,
        before any padding or dispatch, and move them to the model's device."""
        self._check_batch(batch)
        out = {}
        for name, block in (dense_overrides or {}).items():
            block = torch.as_tensor(block, dtype=torch.float32, device=self.device)
            self._check_dense_override(name, block.shape, batch.n_games, batch.max_actions)
            out[name] = block
        return out

    def _check_dense_override(
        self, name: str, shape: Tuple[int, ...], n_games: int, max_actions: int
    ) -> None:
        """Raise unless ``name`` is a dense block of this model and ``shape``
        is ``(n_games, max_actions, width)``."""
        widths = self._dense_override_widths()
        if name not in widths:
            raise ValueError(
                f'dense override {name!r} is not a dense feature block of this '
                f'model; overridable blocks: {sorted(widths)}'
            )
        expected = (n_games, max_actions, widths[name])
        if tuple(shape) != expected:
            raise ValueError(
                f'dense override {name!r} has shape {tuple(shape)}, '
                f'expected (n_games, max_actions, width) = {expected}'
            )

    def _apply_dense_overrides(
        self, feats: torch.Tensor, dense_overrides: Dict[str, torch.Tensor]
    ) -> torch.Tensor:
        """Write override blocks into a feature tensor at their kernels'
        column offsets (in place) and return it: the materialized twin of
        the fused path's ``dense_overrides``."""
        layout = train_layout(self.xfns, self.nb_prev_actions, self._registry)
        offsets = {name: off for name, _, off, _ in layout.spans}
        for name, block in dense_overrides.items():
            feats[..., offsets[name] : offsets[name] + block.shape[-1]] = block
        return feats

    @staticmethod
    def _apply_packed_overrides(
        states: TrainStates, layout: TrainLayout, dense_overrides: Dict[str, torch.Tensor]
    ) -> TrainStates:
        """The packed twin of :meth:`_apply_dense_overrides`: each
        ``(G, A, width)`` block replaces its kernel's columns of a copy of
        ``x_dense`` at the dense-local offset."""
        x = states.x_dense.clone()
        dense_off = 0
        for name, kind, _, width in layout.spans:
            if kind != 'dense':
                continue
            block = dense_overrides.get(name)
            if block is not None:
                x[:, dense_off : dense_off + width] = block.reshape(-1, width)
            dense_off += width
        return states._replace(x_dense=x)

    def _estimate_probabilities_batch(
        self,
        feats: Optional[torch.Tensor],
        batch: Optional[Any] = None,
        dense_overrides: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Dict[str, torch.Tensor]:
        """Each head's ``(G, A)`` probabilities, by head kind.

        An MLP head reads the feature tensor ``feats`` (``None`` when no
        head needs it); a tree head a host frame of it (built once for all
        tree heads), its probabilities coming back to the model's device; a
        seq head the packed rows of ``batch``, built once for all seq heads,
        with ``dense_overrides`` written into their dense columns.
        """
        probs: Dict[str, torch.Tensor] = {}
        seq_pack: Optional[Tuple[TrainStates, TrainLayout]] = None
        flat = None
        for col, model in self._models.items():
            if isinstance(model, MLPClassifier):
                probs[col] = model.predict_proba_device(feats)
                continue
            if not isinstance(model, SeqClassifier):
                if flat is None:
                    import pandas as pd

                    flat = pd.DataFrame(
                        feats.reshape(-1, feats.shape[-1]).cpu().numpy(),
                        columns=self.feature_names,
                    )
                p = model.predict_proba(flat)[:, 1]
                probs[col] = torch.as_tensor(
                    p.reshape(feats.shape[:-1]).astype(np.float32), device=self.device
                )
                continue
            if batch is None:
                raise ValueError(
                    'sequence heads rate from the packed batch; pass the batch through'
                )
            if seq_pack is None:
                states, layout = build_train_states(
                    batch, names=self.xfns, k=self.nb_prev_actions, registry=self._registry
                )
                if dense_overrides:
                    states = self._apply_packed_overrides(states, layout, dense_overrides)
                seq_pack = (states, layout)
            probs[col] = model.predict_proba_states(*seq_pack).reshape(
                batch.n_games, batch.max_actions
            )
        return probs

    def _materialized_probs(
        self, batch: Any, overrides: Dict[str, torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both heads' probabilities through their reference
        representations; the feature tensor is built only when an MLP head
        reads it."""
        need_feats = any(not isinstance(m, SeqClassifier) for m in self._models.values())
        feats = self.compute_features_batch(batch) if need_feats else None
        if feats is not None and overrides:
            feats = self._apply_dense_overrides(feats, overrides)
        probs = self._estimate_probabilities_batch(feats, batch=batch, dense_overrides=overrides)
        return probs[_LABELS[0]], probs[_LABELS[1]]

    def _rating_path(self) -> str:
        """The path :meth:`rate_batch` takes, by the JAX package's rules:
        the profile's (or the env override's) path when both heads are
        MLPs and it is a fused path, ``'seq'`` for two seq heads, else
        ``'materialized'``."""
        path = preferred_rating_path(self.device.type)
        if self._can_fuse() and path in FUSED_PATH_HIDDEN_DTYPES:
            return path
        return 'seq' if self._can_seq() else 'materialized'

    @torch.no_grad()
    def rate_batch(
        self,
        batch: Any,
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
        layer injects the whole-match ``goalscore`` block this way) on every
        path. The path is chosen per call (:meth:`_rating_path`): two MLP
        heads rate through the prepared fold and kernel B1 (``'fused'``,
        or ``'fused_bf16'`` with a bf16 hidden chain), two seq heads over
        one packing of the batch (``'seq'``), anything else through each
        head's reference representation (``'materialized'``). Values on
        padding rows are garbage by contract.

        Every call reports the JAX package's telemetry under ``(path,
        platform)`` labels (``path`` the path taken, ``platform`` the
        model's device type): the valid-action batch size
        (``vaep/rate_batch_actions``), the dispatch wall
        (``vaep/rate_batch_seconds``), the ``vaep/rated_actions`` counter
        and the ``vaep/rate_actions_per_sec`` gauge, and on the seq path
        ``seq/rated_actions`` and ``seq/rate_seconds``, inside a
        ``vaep/rate_batch`` span. All are measured at *dispatch*: nothing
        here waits for the card (the action count is the batch's host
        count, the path a cached profile entry), so on the card they bound
        the host's cost, not the card's throughput. The dispatch notes the
        numeric guards (:mod:`~socceraction_tpu_torch.obs.numerics`) for a
        later ``drain_guards()``.
        """
        self._heads()
        path = self._rating_path()
        labels = {'path': path, 'platform': self.device.type}
        t0 = time.perf_counter()
        with span('vaep/rate_batch', games=batch.n_games, **labels):
            values = self._rate(batch, dense_overrides=dense_overrides, bucket=bucket, path=path)
        dispatch_s = time.perf_counter() - t0
        n_actions = batch.total_actions
        histogram('vaep/rate_batch_actions', unit='actions').observe(n_actions, **labels)
        histogram('vaep/rate_batch_seconds', unit='s').observe(dispatch_s, **labels)
        counter('vaep/rated_actions', unit='actions').inc(n_actions, **labels)
        if dispatch_s > 0:
            gauge('vaep/rate_actions_per_sec', unit='actions/s').set(
                n_actions / dispatch_s, **labels
            )
        if path == 'seq':
            counter('seq/rated_actions', unit='actions').inc(n_actions, platform=labels['platform'])
            histogram('seq/rate_seconds', unit='s').observe(dispatch_s, platform=labels['platform'])
        return values

    @torch.no_grad()
    def _rate(
        self,
        batch: Any,
        *,
        dense_overrides: Optional[Dict[str, Any]] = None,
        bucket: bool = True,
        path: Optional[str] = None,
    ) -> torch.Tensor:
        """:meth:`rate_batch` without its span and metrics: the dispatch
        (on ``path``, default :meth:`_rating_path`)."""
        clf_a, clf_b = self._heads()
        names = self._kernel_names()
        path = self._rating_path() if path is None else path
        overrides = self._overrides_on_device(batch, dense_overrides)
        n_games = batch.n_games
        target = bucket_games(n_games) if bucket else n_games
        if target != n_games and self._bucketable(batch):
            batch = pad_batch_games(batch, target)
            overrides = {
                name: torch.cat([b, b.new_zeros((target - n_games, *b.shape[1:]))])
                for name, b in overrides.items()
            }
        common = dict(
            names=names, k=self.nb_prev_actions, registry=self._registry,
            dense_overrides=overrides,
        )
        if path in FUSED_PATH_HIDDEN_DTYPES:
            pa, pb = pair_probs_prepared(
                self._prepared_pair(), clf_a, clf_b, batch,
                hidden_dtype=hidden_dtype_for(path), **common,
            )
        elif path == 'seq':
            pa, pb = seq_pair_probs(clf_a, clf_b, batch, **common)
        else:
            pa, pb = self._materialized_probs(batch, overrides)
        return self._formula_kernel(batch, pa, pb)[:n_games]

    @torch.no_grad()
    def rate_batch_reference(
        self,
        batch: Any,
        *,
        dense_overrides: Optional[Dict[str, Any]] = None,
    ) -> torch.Tensor:
        """Reference rating: the same function as :meth:`rate_batch` in
        plain PyTorch, whatever path the profile picks. MLP heads read the
        full ``(G, A, F)`` feature tensor, seq heads a fresh packing of the
        batch, each on its own; no bucketing, no telemetry."""
        self._heads()
        overrides = self._overrides_on_device(batch, dense_overrides)
        return self._formula_kernel(batch, *self._materialized_probs(batch, overrides))

    def rate(
        self,
        game: Any,
        game_actions: 'pd.DataFrame',
        game_states: Optional['pd.DataFrame'] = None,
    ) -> 'pd.DataFrame':
        """Offensive/defensive/total VAEP value of each action of one game.

        ``game`` needs a ``home_team_id``; ``game_actions`` is the game's
        frame in this model's action language. On the default backend,
        without ``game_states``, the game is packed and rated by
        :meth:`rate_batch` on the model's device. Otherwise the heads read
        the feature frame ``game_states`` (default: :meth:`compute_features`)
        and the pandas formula values the actions. Returns a frame indexed
        like ``game_actions``.
        """
        import pandas as pd

        if not self._models:
            raise NotFittedError('fit the model before calling rate')
        if self.backend == 'torch' and game_states is None:
            batch, _ = self._pack(game_actions, home_team_id=game.home_team_id, device=self.device)
            return pd.DataFrame(
                unpack_values(self.rate_batch(batch), batch),
                columns=['offensive_value', 'defensive_value', 'vaep_value'],
                index=game_actions.index,
            )
        actions = self._spadlcfg.add_names(game_actions)
        if game_states is None:
            game_states = self.compute_features(game, game_actions)
        y_hat = self._estimate_probabilities(game_states)
        return self._vaep.value(actions, y_hat[_LABELS[0]], y_hat[_LABELS[1]])


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
    """Load a directory written by either package's ``save_model``.

    Checks the format version and every artifact's sha256 before reading
    it, dispatches on the stored class (``'VAEP'``, or ``'AtomicVAEP'``
    for :class:`~socceraction_tpu_torch.atomic.vaep.base.AtomicVAEP`),
    restores both heads (MLP or seq on ``device``, default ``cuda``; a
    pickled tree head as it was saved), the backend (the JAX package's
    ``'jax'`` loads as ``'torch'``), the quantize mode and, for int8, the
    persisted scales, so the model serves the bytes the saved version
    served.
    """
    from ..atomic.vaep.base import AtomicVAEP

    dev = resolve_device(device)
    with open(os.path.join(path, 'meta.json')) as f:
        meta = json.load(f)
    _check_format_version(meta, path)
    classes = {'VAEP': VAEP, 'AtomicVAEP': AtomicVAEP}
    if meta['class'] not in classes:
        raise ValueError(
            f'checkpoint class {meta["class"]!r} is not ported; only {sorted(classes)} are'
        )
    _verify_checksums(meta, path)
    loaders = {'mlp': MLPClassifier.load, 'seq': SeqClassifier.load}
    models = {}
    for col, kind in meta['heads'].items():
        if kind in loaders:
            models[col] = loaders[kind](os.path.join(path, 'models', f'{col}.npz'), device=dev)
        elif kind == 'pickle':
            with open(os.path.join(path, 'models', f'{col}.pkl'), 'rb') as f:
                models[col] = pickle.load(f)
        else:
            raise ValueError(f'head {col!r} has an unknown kind {kind!r}')
    quantize = check_quantize_mode(meta.get('quantize', 'none'))
    for m in models.values():
        if quantize != 'none' and isinstance(m, MLPClassifier):
            m.quantize = quantize
    backend = meta.get('backend', 'jax')
    model = classes[meta['class']](
        meta['xfns'], meta['nb_prev_actions'], 'torch' if backend == 'jax' else backend,
        models=models, device=dev,
    )
    scales_path = os.path.join(path, _QUANT_SCALES_ARTIFACT)
    if quantize == 'int8' and os.path.isfile(scales_path):
        with np.load(scales_path) as data:
            model._quant_scales = {
                name: torch.as_tensor(np.asarray(data[name], dtype=np.float32), device=dev)
                for name in ('table_scale', 'w_dense_scale')
            }
    return model
