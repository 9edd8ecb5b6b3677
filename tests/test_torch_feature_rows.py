"""The feature rows in one launch (``ops/feature_rows.py``, ``csrc/feature_rows.cu``).

On the CPU the column program is held to the eager feature rows
(``ops/fused.py:packed_rows_reference``): a plain PyTorch interpreter of
the program's table, written here from the kernel's op list, must give
``x_dense`` and the combined ids bit for bit, for both families, every
dense transformer alone, the default layouts, a shuffled order and several
``k``. The ``gpu`` tests hold the kernel to the eager version on the card,
bit for bit, and skip here. The machine with the card has no JAX, and this
module imports none, so it runs there without the suite's conftest:

    python -m pytest tests/test_torch_feature_rows.py -m gpu --noconftest -q
"""

import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from socceraction_tpu_torch.atomic.vaep.base import XFNS_DEFAULT as ATOMIC_XFNS
from socceraction_tpu_torch.atomic.vaep.base import AtomicVAEP
from socceraction_tpu_torch.convert import mlp_from_jax_params
from socceraction_tpu_torch.core.batch import ActionBatch, AtomicActionBatch
from socceraction_tpu_torch.ops import feature_rows as fr
from socceraction_tpu_torch.ops.cuda_build import KernelRefused
from socceraction_tpu_torch.ops.fused import (
    ATOMIC_REGISTRY,
    REGISTRIES,
    STANDARD_REGISTRY,
    _packed_rows,
    packed_rows_reference,
)
from socceraction_tpu_torch.ops.features import kernel_width
from socceraction_tpu_torch.vaep.base import XFNS_DEFAULT as VAEP_XFNS
from socceraction_tpu_torch.vaep.base import VAEP

ROOT = Path(__file__).resolve().parent.parent
#: The port's default layouts (``VAEP``'s and ``AtomicVAEP``'s, at k = 3 the
#: season cells' 55 and 46 dense columns).
STANDARD_DEFAULT = VAEP_XFNS
ATOMIC_DEFAULT = ATOMIC_XFNS
DEFAULTS = {'standard': STANDARD_DEFAULT, 'atomic': ATOMIC_DEFAULT}


def _dense(registry):
    return [n for n in registry.kernels if n not in registry.onehot_widths]


def make_batch(family, n_games=5, n_actions=40, seed=0, device='cpu', pad_garbage=True,
               min_length=0):
    """A seeded batch with the edge cases of the features: locations on the
    goal's line and at its centre (atan of ±inf and of 0/0), zero
    displacements, goals and own goals of both teams, games shorter than
    k, a game of no actions; padding rows keep random values unless
    ``pad_garbage`` is false. With ``min_length`` every game has at least
    that many valid actions (and none is shorter than k)."""
    rng = np.random.default_rng(seed)
    shape = (n_games, n_actions)

    def coord(hi, special):
        v = rng.uniform(0.0, hi, shape).astype(np.float32)
        pick = rng.random(shape) < 0.3
        v[pick] = rng.choice(np.asarray(special, np.float32), size=int(pick.sum()))
        return v

    lengths = rng.integers(min_length, n_actions + 1, n_games)
    lengths[0] = n_actions
    if n_games > 2 and not min_length:
        lengths[1], lengths[2] = 1, 0
    mask = np.arange(n_actions)[None, :] < lengths[:, None]
    cols = {
        'bodypart_id': rng.integers(0, 4, shape).astype(np.int32),
        'period_id': np.sort(rng.integers(1, 5, shape), axis=1).astype(np.int32),
        'is_home': rng.random(shape) < 0.5,
        'time_seconds': np.sort(rng.uniform(0.0, 3000.0, shape), axis=1).astype(np.float32),
    }
    if family == 'standard':
        cols['type_id'] = rng.choice(np.array([0, 1, 11, 12, 13, 21], np.int32), size=shape)
        cols['result_id'] = rng.integers(0, 6, shape).astype(np.int32)
        cols['start_x'] = coord(105.0, [0.0, 105.0, 52.5, 104.5])
        cols['start_y'] = coord(68.0, [0.0, 34.0, 68.0, 33.5])
        cols['end_x'] = coord(105.0, [0.0, 105.0, 52.5])
        cols['end_y'] = coord(68.0, [34.0, 68.0, 0.0])
        cls = ActionBatch
    else:
        cols['type_id'] = rng.choice(np.array([0, 1, 10, 24, 27, 28, 32], np.int32), size=shape)
        cols['x'] = coord(105.0, [0.0, 105.0, 52.5])
        cols['y'] = coord(68.0, [34.0, 0.0, 68.0])
        cols['dx'] = coord(20.0, [0.0, -0.0, 3.0]) - np.float32(10.0)
        cols['dy'] = coord(12.0, [6.0, 0.0]) - np.float32(6.0)
        cls = AtomicActionBatch
    if not pad_garbage:
        for name, a in cols.items():
            a[~mask] = 0
    row_index = np.full(shape, -1, np.int32)
    row_index[mask] = np.arange(int(mask.sum()), dtype=np.int32)
    cols.update(mask=mask, n_actions=lengths.astype(np.int32),
                game_id=np.arange(n_games, dtype=np.int32), row_index=row_index)
    return cls(**{n: torch.from_numpy(np.ascontiguousarray(a)).to(device) for n, a in cols.items()})


def interpret(program, batch):
    """``(x_dense, ids)`` of ``program`` on ``batch``, column by column in
    plain PyTorch from the op names and the table's header and group table:
    what the kernel computes, written without the eager transformers."""
    codes = program.codes
    family, n_results, n_bodyparts = codes[0], codes[1], codes[2]
    goal_a, goal_b, goal_c, success, owngoal = codes[3:8]
    n_groups = codes[8]
    fam = fr._FAMILIES[program.family]
    length, width = fam.pitch
    f = torch.float32
    G, A = batch.n_games, batch.max_actions
    home = batch.is_home

    def col(slot, i):
        t = getattr(batch, fam.fields[slot])
        return t[:, (torch.arange(A) - i).clamp(min=0)]

    def flip(slot, i, extent):
        v = col(slot, i).to(f)
        return torch.where(home, v, extent - v)

    def disp(slot, i):
        v = col(slot, i).to(f)
        return torch.where(home, v, -v)

    def norm(dx, dy):
        return torch.sqrt(dx * dx + dy * dy)

    def dist(x, y):
        return norm((length - x).abs(), (width / 2 - y).abs())

    def angle(x, y):
        return torch.nan_to_num(torch.atan((width / 2 - y).abs() / (length - x).abs()))

    type0 = col(0, 0)
    if family == 0:
        shot = (type0 == goal_a) | (type0 == goal_b) | (type0 == goal_c)
        goal, own = shot & (col(1, 0) == success), shot & (col(1, 0) == owngoal)
    else:
        goal, own = type0 == goal_a, type0 == goal_b
    is_a = home == home[:, :1]
    ga = ((goal & is_a) | (own & ~is_a)).to(f)
    gb = ((goal & ~is_a) | (own & is_a)).to(f)
    sa, sb = torch.cumsum(ga, 1) - ga, torch.cumsum(gb, 1) - gb
    team_score, opp_score = torch.where(is_a, sa, sb), torch.where(is_a, sb, sa)

    ops = {
        'type': lambda i: col(0, i).to(f),
        'result': lambda i: col(1, i).to(f),
        'bodypart': lambda i: col(2, i).to(f),
        'period': lambda i: col(3, i).to(f),
        'time': lambda i: col(5, i),
        'time_overall': lambda i: (col(3, i).to(f) - 1) * 45 * 60 + col(5, i),
        'x0': lambda i: flip(6, i, length),
        'y0': lambda i: flip(7, i, width),
        'x1': lambda i: flip(8, i, length),
        'y1': lambda i: flip(9, i, width),
        'dist0': lambda i: dist(flip(6, i, length), flip(7, i, width)),
        'angle0': lambda i: angle(flip(6, i, length), flip(7, i, width)),
        'dist1': lambda i: dist(flip(8, i, length), flip(9, i, width)),
        'angle1': lambda i: angle(flip(8, i, length), flip(9, i, width)),
        'move_x': lambda i: flip(8, i, length) - flip(6, i, length),
        'move_y': lambda i: flip(9, i, width) - flip(7, i, width),
        'move_dist': lambda i: norm(flip(8, i, length) - flip(6, i, length),
                                    flip(9, i, width) - flip(7, i, width)),
        'team': lambda i: (col(4, i) == home).to(f),
        'time_delta': lambda i: col(5, 0) - col(5, i),
        'space_x': lambda i: flip(8, i, length) - flip(6, 0, length),
        'space_y': lambda i: flip(9, i, width) - flip(7, 0, width),
        'space_dist': lambda i: norm(flip(8, i, length) - flip(6, 0, length),
                                     flip(9, i, width) - flip(7, 0, width)),
        'goal_team': lambda i: team_score,
        'goal_opp': lambda i: opp_score,
        'goal_diff': lambda i: team_score - opp_score,
        'disp_dist': lambda i: norm(disp(8, i), disp(9, i)),
        'disp_angle': lambda i: torch.where(disp(9, i) == 0, 0.0, torch.atan2(disp(9, i), disp(8, i))),
        'dir_x': lambda i: _direction(disp(8, i), disp(9, i), disp(8, i)),
        'dir_y': lambda i: _direction(disp(8, i), disp(9, i), disp(9, i)),
    }
    assert set(ops) == set(fr.OPS)
    cols = [ops[op](i) for op, i in program.columns]
    x_dense = (torch.stack(cols, -1) if cols else torch.zeros((G, A, 0), dtype=f)).reshape(G * A, -1)
    groups = torch.tensor(codes[fr.HEADER + program.width:], dtype=torch.int32)
    assert len(groups) == n_groups
    ids = []
    for i in range(program.k):
        if family == 0:
            ids.append((col(0, i) * n_results + col(1, i)) * n_bodyparts + col(2, i))
        else:
            ids.append(groups[col(0, i).long()] * n_bodyparts + col(2, i))
    return x_dense, torch.stack([c.reshape(-1) for c in ids], 1).to(torch.int32)


def _direction(dx, dy, along):
    total = torch.sqrt(dx * dx + dy * dy)
    moved = total > 0
    return torch.where(moved, along / torch.where(moved, total, 1.0), along)


def assert_same_bits(got, want):
    """Equal shapes, dtypes and bits (NaN payloads and signed zeros too)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    as_int = torch.int32 if got.element_size() == 4 else torch.int64
    assert torch.equal(got.contiguous().view(as_int), want.contiguous().view(as_int))


def _layouts():
    """(family, names, k): every dense transformer alone at k = 3, the
    default layouts at k in {1, 2, 3, 5} and a shuffled default layout."""
    cases = []
    for family, registry in REGISTRIES.items():
        cases += [(family, (name,), 3) for name in _dense(registry)]
        cases += [(family, DEFAULTS[family], k) for k in (1, 2, 3, 5)]
        shuffled = list(DEFAULTS[family])
        random.Random(7).shuffle(shuffled)
        cases.append((family, tuple(shuffled), 3))
    return cases


# -- the column program on the CPU ---------------------------------------------------------


def test_ops_are_the_kernels_enum():
    """``OPS`` lists the CUDA source's ``enum Op`` in order, and the
    header fits in ``HEADER``."""
    src = (ROOT / 'socceraction_tpu_torch' / 'csrc' / 'feature_rows.cu').read_text()
    body = re.search(r'enum Op \{(.*?)\};', src, re.S).group(1)
    names = re.findall(r'OP_([A-Z0-9_]+)', body)
    assert [n.lower() for n in names] == list(fr.OPS)
    assert 'OP_TYPE = 1' in body
    header = re.search(r'enum Header \{(.*?)\};', src, re.S).group(1)
    assert f'HEADER = {fr.HEADER}' in header


@pytest.mark.parametrize('family', sorted(REGISTRIES))
def test_every_dense_transformer_has_a_recipe_of_its_width(family):
    registry = REGISTRIES[family]
    for name in _dense(registry):
        for k in (1, 2, 3, 5):
            program = fr.column_program(registry, (name,), k)
            assert program.width == kernel_width(name, k, registry.widths)
            assert program.spans == ((name, 0, program.width),)


@pytest.mark.parametrize('family, names, k', _layouts())
def test_interpreted_program_is_the_eager_rows_bit_for_bit(family, names, k):
    registry = REGISTRIES[family]
    batch = make_batch(family, seed=len(names) * 10 + k)
    want = packed_rows_reference(batch, names=names, k=k, registry=registry)
    got = interpret(fr.column_program(registry, names, k), batch)
    assert_same_bits(got[0], want[0])
    assert_same_bits(got[1], want[1])


@pytest.mark.parametrize('family', sorted(REGISTRIES))
def test_cpu_rows_are_the_eager_rows(family):
    """``_packed_rows`` on a CPU batch is the plain version, and launches nothing."""
    registry = REGISTRIES[family]
    batch = make_batch(family, seed=3)
    before = fr.feature_rows.launches
    got = _packed_rows(batch, names=DEFAULTS[family], k=3, registry=registry)
    want = packed_rows_reference(batch, names=DEFAULTS[family], k=3, registry=registry)
    assert_same_bits(got[0], want[0])
    assert_same_bits(got[1], want[1])
    assert fr.feature_rows.launches == before


@pytest.mark.parametrize('family', sorted(REGISTRIES))
def test_override_columns_are_where_the_eager_rows_put_them(family):
    """An override block copied into its span of the program's columns
    gives the eager rows with that override."""
    registry = REGISTRIES[family]
    names = DEFAULTS[family]
    batch = make_batch(family, seed=5)
    G, A = batch.n_games, batch.max_actions
    program = fr.column_program(registry, names, 3)
    rng = np.random.default_rng(1)
    overrides = {
        name: torch.from_numpy(rng.normal(size=(G, A, width)).astype(np.float64))
        for name, _off, width in program.spans[1::2]
    }
    want = packed_rows_reference(batch, names=names, k=3, registry=registry,
                                 dense_overrides=overrides)
    x_dense, ids = interpret(program, batch)
    rows = x_dense.view(G, A, -1)
    for name, off, width in program.spans:
        if name in overrides:
            rows[..., off : off + width].copy_(overrides[name])
    assert_same_bits(x_dense, want[0])
    assert_same_bits(ids, want[1])


def test_overrides_are_checked_before_any_launch():
    batch = make_batch('standard', seed=2)
    G, A = batch.n_games, batch.max_actions
    kw = dict(names=STANDARD_DEFAULT, k=3, registry=STANDARD_REGISTRY)
    with pytest.raises(ValueError, match='leading shape'):
        fr.feature_rows(batch, dense_overrides={'time': torch.zeros(G + 1, A, 9)}, **kw)
    with pytest.raises(ValueError, match='emits 9 columns'):
        fr.feature_rows(batch, dense_overrides={'time': torch.zeros(G, A, 8)}, **kw)
    with pytest.raises(KernelRefused, match='no kernel for device cpu'):
        fr.feature_rows(batch, dense_overrides={'time': torch.zeros(G, A, 9)}, **kw)


def test_the_table_is_built_once_per_layout_and_device():
    names = ('time', 'startpolar', 'goalscore')
    program = fr.column_program(STANDARD_REGISTRY, names, 3)
    assert fr.column_program(STANDARD_REGISTRY, list(names), 3) is program
    assert fr.column_program(STANDARD_REGISTRY, names, 2) is not program
    assert fr.column_program(ATOMIC_REGISTRY, ('time', 'goalscore'), 3) != program
    table = fr.program_tensor(program, torch.device('cpu'))
    assert fr.program_tensor(program, torch.device('cpu')) is table
    assert table.dtype == torch.int32 and table.tolist() == list(program.codes)


@pytest.mark.parametrize('family, raw, width', [('standard', 37, 55), ('atomic', 33, 46)])
def test_cost_counts_each_byte_once(family, raw, width):
    """The raw columns read once, ``x_dense`` and the ids written once: at
    the season cells' 1024 x 1664 chunk, 0.137 and 0.116 ms of an H100's
    3.35 TB/s."""
    program = fr.column_program(REGISTRIES[family], DEFAULTS[family], 3)
    n = 1024 * 1664
    assert program.width == width
    assert fr.feature_rows_cost(n, program) == {'bytes': float(n * (raw + 4 * width + 12))}


def test_unknown_and_onehot_names():
    with pytest.raises(ValueError, match='unknown feature kernel'):
        fr.column_program(STANDARD_REGISTRY, ('location',), 3)
    program = fr.column_program(ATOMIC_REGISTRY, ('actiontype_onehot', 'bodypart_onehot'), 3)
    assert program.width == 0 and program.spans == ()


# -- the kernel on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    """The card, or a skip where there is none (decided per test, not at
    import, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


def _card_cases():
    cases = []
    for family, registry in REGISTRIES.items():
        cases += [(family, (name,), 3, 4, 130) for name in _dense(registry)]
        cases += [(family, DEFAULTS[family], k, 6, 1664) for k in (1, 2, 3, 5)]
        shuffled = list(DEFAULTS[family])
        random.Random(11).shuffle(shuffled)
        cases += [
            (family, tuple(shuffled), 3, 3, 257),  # a partial last tile, unaligned runs
            (family, DEFAULTS[family], 3, 1, 128),  # G = 1
            (family, DEFAULTS[family], 5, 3, 2),  # fewer slots than k
        ]
    return cases


@pytest.mark.gpu
@pytest.mark.parametrize('family, names, k, games, actions', _card_cases())
def test_kernel_is_the_eager_rows_bit_for_bit(cuda, family, names, k, games, actions):
    registry = REGISTRIES[family]
    for garbage in (True, False):
        batch = make_batch(family, games, actions, seed=games * actions + k, device=cuda,
                           pad_garbage=garbage)
        before = fr.feature_rows.launches
        got = fr.feature_rows(batch, names=names, k=k, registry=registry)
        want = packed_rows_reference(batch, names=names, k=k, registry=registry)
        torch.cuda.synchronize()
        assert fr.feature_rows.launches == before + 1
        assert_same_bits(got[0], want[0])
        assert_same_bits(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize('family', sorted(REGISTRIES))
def test_kernel_overrides_are_the_eager_rows_bit_for_bit(cuda, family):
    registry = REGISTRIES[family]
    batch = make_batch(family, 4, 384, seed=21, device=cuda)
    G, A = batch.n_games, batch.max_actions
    program = fr.column_program(registry, DEFAULTS[family], 3)
    gen = torch.Generator(device=cuda).manual_seed(4)
    overrides = {
        name: torch.randn((G, A, width), generator=gen, device=cuda, dtype=torch.float64)
        for name, _off, width in program.spans[::2]
    }
    kw = dict(names=DEFAULTS[family], k=3, registry=registry, dense_overrides=overrides)
    got, want = fr.feature_rows(batch, **kw), packed_rows_reference(batch, **kw)
    assert_same_bits(got[0], want[0])
    assert_same_bits(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize('family', sorted(REGISTRIES))
def test_kernel_is_the_eager_rows_on_a_season_chunk(cuda, family):
    """One chunk of a season as the season cells rate it: 1024 games x 1664
    action slots, 1200 to 1664 valid actions a game, the default layout."""
    registry = REGISTRIES[family]
    batch = make_batch(family, 1024, 1664, seed=2147483659, device=cuda, min_length=1200)
    kw = dict(names=DEFAULTS[family], k=3, registry=registry)
    got, want = fr.feature_rows(batch, **kw), packed_rows_reference(batch, **kw)
    assert got[0].shape[1] == {'standard': 55, 'atomic': 46}[family]
    assert_same_bits(got[0], want[0])
    assert_same_bits(got[1], want[1])


def _model(family, device):
    """The family's VAEP model of the default layout at k = 3, with seeded
    random (128, 128) MLP heads."""
    registry = REGISTRIES[family]
    n = sum(kernel_width(name, 3, registry.widths) for name in DEFAULTS[family])
    rng = np.random.default_rng(5)
    widths = (n, 128, 128, 1)
    heads = {}
    for col in ('scores', 'concedes'):
        params = {
            f'Dense_{i}': {
                'kernel': (rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32),
                'bias': (0.05 * rng.normal(size=b)).astype(np.float32),
            }
            for i, (a, b) in enumerate(zip(widths[:-1], widths[1:]))
        }
        heads[col] = mlp_from_jax_params({'params': params}, np.zeros(n), np.ones(n),
                                         device=device)
    cls = VAEP if family == 'standard' else AtomicVAEP
    return cls(xfns=list(DEFAULTS[family]), nb_prev_actions=3, models=heads, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize('family', sorted(REGISTRIES))
def test_one_launch_a_rate_batch_and_a_scenario_request(cuda, family):
    from socceraction_tpu_torch.scenario.engine import rate_scenarios_batch
    from socceraction_tpu_torch.scenario.grid import end_location_grid

    model = _model(family, cuda)
    batch = make_batch(family, 6, 256, seed=8, device=cuda, pad_garbage=False)
    before = fr.feature_rows.launches
    model.rate_batch(batch)
    assert fr.feature_rows.launches == before + 1
    if family == 'standard':
        rate_scenarios_batch(model, batch, end_location_grid(3, 2))
        assert fr.feature_rows.launches == before + 2


@pytest.mark.gpu
def test_refused_operands(cuda):
    batch = make_batch('standard', 3, 256, seed=9, device=cuda)
    kw = dict(names=STANDARD_DEFAULT, k=3, registry=STANDARD_REGISTRY)
    strided = torch.empty((256, 3), device=cuda).t().copy_(batch.start_x)
    with pytest.raises(KernelRefused, match='contiguous'):
        fr.feature_rows(batch.replace(start_x=strided), **kw)
    with pytest.raises(KernelRefused, match='float32'):
        fr.feature_rows(batch.astype(torch.float64), **kw)
    with pytest.raises(KernelRefused, match='k >= 1'):
        fr.feature_rows(batch, names=('time',), k=0, registry=STANDARD_REGISTRY)
