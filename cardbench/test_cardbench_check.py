"""The check that decides ``correct`` has to fail what it is there to catch.

Each test runs a whole cell on the CPU at a tiny size (the harness's look for
a card skipped) with the timed path broken underneath, and sees ``correct``
come out false: the control (the reference in float32 with TF32 products)
put in the program's place, half of each batch left out, one value of each
answer altered where it is produced, and calls that fail. The last test runs
the cells on the card, where there is one.

    python -m pytest cardbench -q                       # CPU
    python -m pytest cardbench -q -m gpu --noconftest   # on the card
"""

from __future__ import annotations

import pytest
import torch

from cardbench import run, spec as specmod, testing

#: Every cell of ``BENCHMARK.json``, those added later too.
CELLS = tuple(w['name'] for w in specmod.Spec().bench['workloads'])
SEED = 2**31 + 29


@pytest.fixture(scope='module')
def tiny(tmp_path_factory):
    torch.set_num_threads(2)  # tiny calls: more threads only contend under parallel workers
    return specmod.Spec(testing.tiny_root(tmp_path_factory.mktemp('tiny')))


@pytest.mark.parametrize('cell', CELLS)
def test_control_in_the_programs_place_is_not_correct(tiny, monkeypatch, cell):
    testing.plant_control(monkeypatch, tiny)
    result = run.run_cell(tiny, cell, SEED, 0.3, False, torch.device('cpu'))
    gap = result['checks']['max_abs_gap']
    assert not result['correct'] and gap['value'] > gap['limit']
    assert result['failed'] == 0 and result['checks']['nonfinite']['value'] == 0


@pytest.mark.parametrize('fault', ('half', 'altered', 'raises'))
@pytest.mark.parametrize('cell', CELLS)
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    testing.plant_fault(monkeypatch, tiny, fault, run.WARM_CALLS)
    result = run.run_cell(tiny, cell, SEED, 0.3, False, torch.device('cpu'))
    assert not result['correct']
    if fault == 'raises':
        assert result['failed'] == result['attempted'] > 0
    else:
        gap = result['checks']['max_abs_gap']
        assert gap['value'] > gap['limit'] and result['failed'] == 0


def test_a_program_that_fails_in_set_up_gives_no_result(tiny, monkeypatch):
    testing.plant_fault(monkeypatch, tiny, 'raises', 0)
    with pytest.raises(RuntimeError, match='planted failure'):
        run.run_cell(tiny, 'vaep-season-rate', SEED, 0.3, False, torch.device('cpu'))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', 0)


@pytest.mark.gpu
@pytest.mark.parametrize('cell', CELLS)
def test_cells_are_correct_on_the_card(card, monkeypatch, cell):
    """Each cell at its own size for one second on the card, then the same
    with the control in the program's place."""
    spec = specmod.Spec()
    result = run.run_cell(spec, cell, SEED, 1.0, False, card)
    assert result['correct'], result['checks']
    testing.plant_control(monkeypatch, spec)
    result = run.run_cell(spec, cell, SEED, 1.0, False, card)
    assert not result['correct'], result['checks']
