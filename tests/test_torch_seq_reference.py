"""The port's GRU sequence pair against the benchmark's plain reference.

``cardbench/heads/gru.py`` is the GRU head in plain PyTorch over the raw
feature row: each state's token read off its one-hot blocks, a recurrence
oldest to newest, a readout over the standardized dense columns. Here the
benchmark's configuration ``vaep-seq-gru`` (its real widths: embedding 32,
GRU 64, readout 64, 552 combined ids, 55 dense columns) rates a seeded
16 x 128 season on the CPU: the harness's weights enter the port through
its adapter (``cardbench/adapters/vaep_seq.py``), ``VAEP.rate_batch`` takes
its ``'seq'`` path, and its values are held to the reference's float64
values by the benchmark's own comparison (``cardbench.reference.gaps``).

Tolerance: :data:`ATOL` = 1e-6, the cell's limit. The port computes in
float32 with float32 products and reads 4e-8 to 6e-8 here; the same
reference in float32 with TF32 products (the control, the precision below
the configuration's) reads about 1e-5. A program whose embedding rows are
out of the registry's order, or whose dense columns are standardized with
the one-hot columns' statistics, reads far above it.
"""

import numpy as np
import pytest
import torch

from cardbench import reference, spec as specmod, traffic

CONFIG = 'vaep-seq-gru'
ATOL = 1e-6
#: A season the CPU rates in well under a second, drawn as the cell draws its own.
TINY = {'season_games': 16, 'actions': 128, 'valid_low': 90, 'valid_high': 128,
        'stratum_games': 8}


def prepared(seed):
    """The reference model, the season and the port's model of ``seed``."""
    spec = specmod.Spec()
    config = spec.config(CONFIG)
    family, head, adapter = spec.modules(config)
    head.check(config)
    device = torch.device('cpu')
    gen = torch.Generator(device=device).manual_seed(seed)
    season = traffic.make_season(family, TINY, gen, np.random.default_rng(seed), device)
    sample = slice(0, 8)
    mean, std, layout = reference.standardization(
        family, config, {n: t[sample] for n, t in season.fields.items()}, season.mask[sample])
    weights = head.make(gen, config, layout, mean, std, device)
    model = reference.Model(family, head, config, weights, mean, std, layout)
    program = adapter.build(config, weights, layout, mean, std, device)
    batch = adapter.batch(config, season.fields, season.mask, int(season.lengths.sum()))
    return model, season, program, batch


def widest_gap(model, season, values):
    return float(reference.gaps(model, season.fields, values.double())[season.mask].max())


@pytest.fixture(params=[0, 7, 2**31 + 11], ids=lambda s: f'seed{s}')
def cell(request):
    torch.set_num_threads(2)
    return prepared(request.param)


def test_seq_pair_matches_the_plain_reference(cell):
    model, season, program, batch = cell
    assert program._rating_path() == 'seq'
    values = program.rate_batch(batch)
    assert values.shape == (*season.mask.shape, 3) and values.dtype == torch.float32
    assert torch.isfinite(values[season.mask]).all()
    assert 0 < widest_gap(model, season, values) <= ATOL


def test_the_control_is_outside_the_tolerance(cell):
    model, season, _, _ = cell
    control = reference.values(model, season.fields, control=True)
    assert widest_gap(model, season, control) > ATOL


def test_a_permuted_embedding_fails(cell):
    model, season, program, batch = cell
    for clf in program._models.values():
        with torch.no_grad():
            clf.module.embed.copy_(clf.module.embed.roll(1, 0))
    assert widest_gap(model, season, program.rate_batch(batch)) > 100 * ATOL


def test_dense_columns_standardized_with_onehot_statistics_fail(cell):
    """The dense block standardized by the statistics of one-hot columns
    (the row's first 55, where a cut of the wrong columns would land)."""
    model, season, program, batch = cell
    gru = specmod.Spec().module('heads', 'gru')
    dense = gru.dense_columns(model.layout)
    onehot = torch.tensor([b.offset + j for b in model.layout if b.onehot for j in range(b.width)])
    index = torch.arange(model.mean.numel())
    index[dense] = onehot[:len(dense)]
    for clf in program._models.values():
        clf.mean_, clf.std_ = model.mean[index], model.std[index]
    assert widest_gap(model, season, program.rate_batch(batch)) > 100 * ATOL


def test_the_reference_tokens_are_the_registrys_combined_ids():
    """The adapter's map from the registry's combined ids to the
    reference's tokens is the identity for SPADL: ``(type·6 + result)·4 +
    bodypart`` in both."""
    from socceraction_tpu_torch.ops.fused import STANDARD_REGISTRY

    spec = specmod.Spec()
    config = spec.config(CONFIG)
    family = spec.module('families', 'spadl')
    gen = torch.Generator().manual_seed(3)
    fields = reference.cast(family.draw(gen, 2, 16, torch.device('cpu')), torch.float64)
    _, layout = reference.features(family, config, fields)
    order = spec.module('adapters', 'vaep_seq').registry_order(config, layout, STANDARD_REGISTRY)
    assert torch.equal(order, torch.arange(STANDARD_REGISTRY.combo_size))
    assert STANDARD_REGISTRY.combo_size == config['table_rows'] == 552


def test_flops_per_action_by_hand():
    """2 heads x (3 steps x 2 x 3 gates x (32·64 + 64·64) + 2·(64 + 55)·64 + 2·64)."""
    from cardbench import yardstick

    spec = specmod.Spec()
    config = spec.config(CONFIG)
    assert yardstick.flops_per_action(config, spec.module('heads', 'gru')) == 251904
    assert 251904 == 2 * (3 * 2 * 3 * (32 * 64 + 64 * 64) + 2 * (64 + 55) * 64 + 2 * 64)
    mlp = spec.module('heads', 'mlp')
    assert yardstick.flops_per_action(spec.config('vaep-mlp128'), mlp) == 94976
    assert yardstick.flops_per_action(spec.config('atomic-vaep-mlp128'), mlp) == 90368


@pytest.mark.parametrize('bad', [{'embed_dim': 0}, {'hidden': None}, {'tokens': []},
                                 {'tokens': ['actiontype_onehot', 'not_a_transformer']}])
def test_check_refuses_a_configuration_it_cannot_build(bad):
    spec = specmod.Spec()
    with pytest.raises(ValueError):
        spec.module('heads', 'gru').check({**spec.config(CONFIG), **bad})
