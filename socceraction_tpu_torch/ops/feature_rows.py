"""The feature rows of a packed batch in one launch: the dense block and the combined ids.

What :func:`~.fused.packed_rows_reference` returns, ``x_dense`` ``(G·A, D)``
f32 (the dense transformers' columns in layout order) and the combined ids
``(G·A, k)`` int32, written by one launch of the hand-written kernel
``csrc/feature_rows.cu`` from the batch's raw ``(G, A)`` columns. The eager
version builds every state's shifted column, each transformer's stack and
the concatenation of the blocks, some 150 launches a call.

The layout becomes a column program (:func:`column_program`): a small int32
table of a header (the family's id recipe and goal rule), one code per
``x_dense`` column (``op | state << 8``, the ops of :data:`OPS`) and the
family's type -> one-hot group table. It is compiled once per layout and
kept on each device once (:func:`program_tensor`), so a call copies nothing
from the host. One kernel serves both families, any subset and order of
their dense transformers and any ``k``.

:func:`feature_rows` launches on the card or raises
:class:`~socceraction_tpu_torch.ops.cuda_build.KernelError` (its subclass
:class:`~socceraction_tpu_torch.ops.cuda_build.KernelRefused` for operands
the kernel does not take): there is no fallback. The dispatch between the
two versions is :func:`~.fused._packed_rows`: CPU batches run the eager
version, which the tests hold the column program to.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Any, Callable, Dict, FrozenSet, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..atomic.spadl import config as atomicconfig
from ..spadl import config as spadlconfig
from .atomic import GROUP_OF_TYPE

__all__ = [
    'OPS', 'ColumnProgram', 'column_program', 'feature_rows', 'feature_rows_cost', 'program_tensor',
]

#: Column ops, in the order of ``csrc/feature_rows.cu``'s ``enum Op`` (an
#: op's code is its position + 1). ``x0, y0``: the mirrored standard start
#: location or atomic location; ``x1, y1``: the mirrored standard end
#: location; ``disp``: the atomic displacement, negated by the mirror.
OPS: Tuple[str, ...] = (
    'type', 'result', 'bodypart', 'period', 'time', 'time_overall',
    'x0', 'y0', 'x1', 'y1', 'dist0', 'angle0', 'dist1', 'angle1',
    'move_x', 'move_y', 'move_dist', 'team', 'time_delta',
    'space_x', 'space_y', 'space_dist', 'goal_team', 'goal_opp', 'goal_diff',
    'disp_dist', 'disp_angle', 'dir_x', 'dir_y',
)
_CODE = {op: i + 1 for i, op in enumerate(OPS)}
#: Ints ahead of the column codes (``enum Header``).
HEADER = 16
#: ``cudaErrorInvalidValue``: what the C entry returns for shapes it refuses.
_INVALID_VALUE = 1
#: Guards the launch count, which several threads may bump at once.
_COUNT_LOCK = threading.Lock()

Recipe = Callable[[int], List[Tuple[str, int]]]


def _per_state(*ops: str) -> Recipe:
    return lambda k: [(op, i) for i in range(k) for op in ops]


def _per_previous(*ops: str) -> Recipe:
    return lambda k: [(op, i) for i in range(1, k) for op in ops]


def _fixed(*ops: str) -> Recipe:
    return lambda k: [(op, 0) for op in ops]


_SHARED: Dict[str, Recipe] = {
    'actiontype': _per_state('type'),
    'bodypart': _per_state('bodypart'),
    'time': _per_state('period', 'time', 'time_overall'),
    'team': _per_previous('team'),
    'time_delta': _per_previous('time_delta'),
    'goalscore': _fixed('goal_team', 'goal_opp', 'goal_diff'),
}


class _Family(NamedTuple):
    """What the kernel needs of a feature family: each dense transformer's
    columns as ``(op, state)`` in its eager block's order, the header's
    id recipe and goal rule, the type -> group table (empty: no table),
    the batch fields in the kernel's slots (``None``: no such field) and the
    pitch ``(length, width)`` of the mirror and the goal."""

    recipes: Dict[str, Recipe]
    header: Tuple[int, ...]
    groups: Tuple[int, ...]
    fields: Tuple[Optional[str], ...]
    pitch: Tuple[float, float]


_FAMILIES: Dict[str, _Family] = {
    'standard': _Family(
        recipes={
            **_SHARED,
            'result': _per_state('result'),
            'startlocation': _per_state('x0', 'y0'),
            'endlocation': _per_state('x1', 'y1'),
            'startpolar': _per_state('dist0', 'angle0'),
            'endpolar': _per_state('dist1', 'angle1'),
            'movement': _per_state('move_x', 'move_y', 'move_dist'),
            'space_delta': _per_previous('space_x', 'space_y', 'space_dist'),
        },
        # id = (type·results + result)·bodyparts + bodypart; a goal is a
        # shot-like type with a success, an own goal one with an own-goal result
        header=(
            0, len(spadlconfig.results), len(spadlconfig.bodyparts),
            spadlconfig.SHOT, spadlconfig.SHOT_PENALTY, spadlconfig.SHOT_FREEKICK,
            spadlconfig.SUCCESS, spadlconfig.OWNGOAL,
        ),
        groups=(),
        fields=('type_id', 'result_id', 'bodypart_id', 'period_id', 'is_home', 'time_seconds',
                'start_x', 'start_y', 'end_x', 'end_y'),
        pitch=(spadlconfig.field_length, spadlconfig.field_width),
    ),
    'atomic': _Family(
        recipes={
            **_SHARED,
            'location': _per_state('x0', 'y0'),
            'polar': _per_state('dist0', 'angle0'),
            'movement_polar': _per_state('disp_dist', 'disp_angle'),
            'direction': _per_state('dir_x', 'dir_y'),
        },
        # id = group[type]·bodyparts + bodypart; goals and own goals are types
        header=(1, 1, len(atomicconfig.bodyparts), atomicconfig.GOAL, atomicconfig.OWNGOAL,
                -1, -1, -1),
        groups=GROUP_OF_TYPE,
        fields=('type_id', None, 'bodypart_id', 'period_id', 'is_home', 'time_seconds',
                'x', 'y', 'dx', 'dy'),
        pitch=(atomicconfig.field_length, atomicconfig.field_width),
    ),
}

#: The dtype each kernel slot takes.
_SLOT_DTYPES = (torch.int32,) * 4 + (torch.bool,) + (torch.float32,) * 5


class ColumnProgram(NamedTuple):
    """A layout compiled for the kernel: ``codes`` is the int32 table
    (header, one code per ``x_dense`` column, group table), ``columns``
    the ``(op, state)`` of each ``x_dense`` column, ``spans`` each dense
    transformer's ``(name, offset, width)`` in ``x_dense``."""

    family: str
    k: int
    codes: Tuple[int, ...]
    columns: Tuple[Tuple[str, int], ...]
    spans: Tuple[Tuple[str, int, int], ...]

    @property
    def width(self) -> int:
        """Columns of ``x_dense`` (``D``)."""
        return len(self.columns)


@functools.lru_cache(maxsize=None)
def _compile(family: str, onehot: FrozenSet[str], names: Tuple[str, ...], k: int) -> ColumnProgram:
    fam = _FAMILIES[family]
    columns: List[Tuple[str, int]] = []
    spans: List[Tuple[str, int, int]] = []
    for name in names:
        if name in onehot:
            continue
        if name not in fam.recipes:
            raise ValueError(f'unknown feature kernel {name!r}')
        cols = fam.recipes[name](k)
        spans.append((name, len(columns), len(cols)))
        columns += cols
    goalscore = int(any(op.startswith('goal_') for op, _ in columns))
    header = [*fam.header, len(fam.groups), goalscore]
    header += [0] * (HEADER - len(header))
    codes = header + [_CODE[op] | (i << 8) for op, i in columns] + list(fam.groups)
    return ColumnProgram(family, k, tuple(codes), tuple(columns), tuple(spans))


def column_program(registry: Any, names: Sequence[str], k: int) -> ColumnProgram:
    """The column program of ``names`` at ``k`` states in ``registry``'s
    family (a :class:`~.fused.FusedRegistry`), compiled once per layout.
    One-hot transformers add no column: the combined ids carry them."""
    return _compile(registry.name, frozenset(registry.onehot_widths), tuple(names), k)


@functools.lru_cache(maxsize=None)
def program_tensor(program: ColumnProgram, device: torch.device) -> torch.Tensor:
    """``program.codes`` on ``device``, made once per program and device:
    a copy from the host on every call would wait for the card."""
    return torch.tensor(program.codes, dtype=torch.int32, device=device)


def feature_rows_cost(n: int, program: ColumnProgram) -> Dict[str, float]:
    """What one launch must move for ``n`` action slots: ``bytes``, the
    family's raw columns read once and ``x_dense`` and the ids written
    once (the halo and the goal counts re-read from L2 not counted)."""
    fam = _FAMILIES[program.family]
    raw = sum(dtype.itemsize for field, dtype in zip(fam.fields, _SLOT_DTYPES) if field is not None)
    return {'bytes': float(n * (raw + 4 * program.width + 4 * program.k))}


def feature_rows(
    batch: Any,
    *,
    names: Sequence[str],
    k: int,
    registry: Any,
    dense_overrides: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x_dense (N, D) f32, combo ids (N, k) int32)`` of a card batch in
    one launch of ``csrc/feature_rows.cu``; ``N = G·A``.

    ``dense_overrides[name]`` (``(G, A, width)``) stands in for dense
    kernel ``name``'s block: it is copied over the kernel's columns after
    the launch, with the bits the eager concatenation gives. Adds one to
    ``feature_rows.launches``. Anything that stops the launch raises
    :class:`~socceraction_tpu_torch.ops.cuda_build.KernelError`.
    """
    program = column_program(registry, names, k)
    G, A = batch.n_games, batch.max_actions
    overrides = []
    for name, off, width in program.spans:
        block = (dense_overrides or {}).get(name)
        if block is None:
            continue
        if tuple(block.shape[:2]) != (G, A):
            raise ValueError(
                f'dense override {name!r} has leading shape '
                f'{tuple(block.shape[:2])}, batch is {(G, A)}'
            )
        if tuple(block.shape[2:]) != (width,):
            raise ValueError(
                f'dense override {name!r} has shape {tuple(block.shape)}, '
                f'kernel {name!r} emits {width} columns at k={k}'
            )
        overrides.append((off, width, block))
    from .cuda_build import kernel_boundary

    with kernel_boundary('feature_rows'):
        x_dense, ids = _launch(batch, program)
        rows = x_dense.view(G, A, program.width)
        for off, width, block in overrides:
            rows[..., off : off + width].copy_(block)
    return x_dense, ids


@functools.lru_cache(maxsize=None)
def _kernel() -> Any:
    """``feature_rows_f32`` of the built library, its argument types set
    (a library that fails to load is not cached, and raises again)."""
    from .cuda_build import load_library

    fn = load_library('feature_rows').feature_rows_f32
    fn.argtypes = (
        [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _launch(batch: Any, program: ColumnProgram) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`feature_rows` on the card: check the operands, build and launch."""
    from .cuda_build import KernelError, KernelRefused

    device = batch.device
    if device.type != 'cuda':
        raise KernelRefused(f'no kernel for device {device}')
    fam = _FAMILIES[program.family]
    G, A = batch.n_games, batch.max_actions
    cols: List[Optional[torch.Tensor]] = []
    for field, dtype in zip(fam.fields, _SLOT_DTYPES):
        if field is None:
            cols.append(None)
            continue
        t = getattr(batch, field)
        if tuple(t.shape) != (G, A) or t.dtype != dtype or t.device != device:
            raise KernelRefused(
                f'feature_rows takes {field} as a ({G}, {A}) {dtype} tensor on {device}, '
                f'got {tuple(t.shape)} {t.dtype} on {t.device}'
            )
        if not t.is_contiguous():
            raise KernelRefused(f'feature_rows needs contiguous columns; {field} is not')
        cols.append(t)
    fn = _kernel()
    d, k = program.width, program.k
    x_dense = torch.empty((G * A, d), dtype=torch.float32, device=device)
    ids = torch.empty((G * A, k), dtype=torch.int32, device=device)
    if G * A == 0:
        return x_dense, ids
    prog = program_tensor(program, device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(
            prog.data_ptr(), *(None if t is None else t.data_ptr() for t in cols),
            x_dense.data_ptr(), ids.data_ptr(), G, A, d, k, *fam.pitch, stream,
        )
    if rc == _INVALID_VALUE:
        raise KernelRefused(
            f'feature_rows refused D = {d} dense columns, k = {k} states over {G} x {A} slots: '
            f'it takes k >= 1, a block within the shared memory a block can use, and fewer '
            f'than 2**31 blocks'
        )
    if rc != 0:
        raise KernelError(f'feature_rows kernel launch failed: cudaError_t {rc}')
    # several flusher threads launch at once (the service's lanes)
    with _COUNT_LOCK:
        feature_rows.launches += 1
    return x_dense, ids


#: Kernel launches made through :func:`feature_rows` (CUDA only).
feature_rows.launches = 0
