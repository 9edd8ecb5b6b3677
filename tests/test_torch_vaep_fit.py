"""``VAEP.fit_packed`` and ``save_model`` of the port against the JAX package.

Both packages fit on the same seeded batches (``synthetic_batch`` is
bitwise equal in both), on the CPU, with (32, 16) heads and minibatches of
512: the split and the standardization statistics must agree, the fitted
model must serve, and checkpoints must move between the packages either
way.
"""

import json
import os

import numpy as np
import pytest
import torch

from socceraction_tpu.core.synthetic import synthetic_batch as jax_synthetic_batch
from socceraction_tpu.ops import fused as jfused
from socceraction_tpu.vaep.base import VAEP as JaxVAEP
from socceraction_tpu.vaep.base import load_model as jax_load_model
from socceraction_tpu_torch.core.synthetic import synthetic_batch
from socceraction_tpu_torch.vaep.base import VAEP, NotFittedError, load_model, split_rows

TREE = dict(hidden=(32, 16), batch_size=512, max_epochs=3)


@pytest.fixture(scope='module', autouse=True)
def _drain_storm_windows():
    """Retire this module's packing and serving compiles from the JAX
    compile observatory's storm window (as tests/test_torch_vaep.py does)."""
    yield
    from socceraction_tpu.ops.fused import _pair_probs, _pair_probs_prepared

    for fn in (jfused._train_states_arrays, _pair_probs, _pair_probs_prepared):
        fn.drain_storm_window()


def _pairs(device):
    """An iterator of (batch, game_ids) pairs, as a season feed yields them."""
    if device == 'jax':
        make = jax_synthetic_batch
        extra = {}
    else:
        make = synthetic_batch
        extra = {'device': device}
    return iter([
        (make(4, 256, fill=0.8, seed=3, **extra), [0, 1, 2, 3]),
        (make(2, 256, fill=0.9, seed=11, **extra), [4, 5]),
    ])


@pytest.fixture(scope='module')
def fitted():
    """(JAX model, port model), fit on the same pairs."""
    jmodel = JaxVAEP().fit_packed(_pairs('jax'), tree_params=TREE, random_state=0)
    model = VAEP(device='cpu').fit_packed(_pairs('cpu'), tree_params=TREE, random_state=0)
    return jmodel, model


def test_fit_packed_end_to_end(fitted):
    """Split and statistics equal to the JAX package's (std within rtol
    1e-6, mean within 1e-6 of max(|mean|, std), as
    ``tests/test_torch_train.py`` states); both heads healthy; the fitted
    model's fused ``rate_batch`` within 1e-5 of ``rate_batch_reference``."""
    jmodel, model = fitted
    n_rows = 6 * 256
    data = model.training_set(_pairs('cpu'), 0.25, 0)
    want_train, want_val = split_rows(n_rows, 0.25, 0)
    idx = np.random.default_rng(0).permutation(n_rows)  # the JAX package's draw
    np.testing.assert_array_equal(want_train, idx[:1152])
    np.testing.assert_array_equal(want_val, idx[1153:])  # the boundary row is in neither
    np.testing.assert_array_equal(data.train_rows, want_train)
    assert data.val.weight.shape[0] == n_rows - 1153
    for col in ('scores', 'concedes'):
        jclf, clf = jmodel._models[col], model._models[col]
        jmean, jstd = jclf.mean_.astype(np.float64), jclf.std_.astype(np.float64)
        mean, std = clf.mean_.numpy().astype(np.float64), clf.std_.numpy().astype(np.float64)
        np.testing.assert_allclose(std, jstd, rtol=1e-6, atol=0)
        assert (np.abs(mean - jmean) <= 1e-6 * np.maximum(np.abs(jmean), jstd)).all()
        health = clf.train_health_
        assert health['finite'] and health['epochs'] == 3 and health['path'] == 'fused'
        assert len(health['val_losses']) == 3
    batch = synthetic_batch(3, 256, fill=0.8, seed=5, device='cpu')
    values = model.rate_batch(batch)
    assert values.shape == (3, 256, 3)
    assert torch.isfinite(values[batch.mask]).all()
    np.testing.assert_allclose(
        values[batch.mask].numpy(), model.rate_batch_reference(batch)[batch.mask].numpy(),
        rtol=0, atol=1e-5,
    )


def test_checkpoint_loads_in_jax_and_rates_alike(fitted, tmp_path):
    """The port's ``save_model`` loads in the JAX package's ``load_model``
    (its format gate and sha256 checks included); JAX's ``rate_batch`` then
    agrees with the port's within 1e-5, and the port reads its own
    checkpoint back bitwise."""
    _, model = fitted
    model.save_model(str(tmp_path))
    with open(tmp_path / 'meta.json') as f:
        meta = json.load(f)
    assert meta['format_version'] == 1 and sorted(meta['checksums']) == [
        'models/concedes.npz', 'models/scores.npz'
    ]
    jmodel = jax_load_model(str(tmp_path))
    jb = jax_synthetic_batch(3, 256, fill=0.8, seed=5)
    tb = synthetic_batch(3, 256, fill=0.8, seed=5, device='cpu')
    mask = tb.mask.numpy()
    np.testing.assert_allclose(
        model.rate_batch(tb).numpy()[mask], np.asarray(jmodel.rate_batch(jb))[mask],
        rtol=0, atol=1e-5,
    )
    back = load_model(str(tmp_path), device='cpu')
    assert torch.equal(back.rate_batch(tb), model.rate_batch(tb))


def test_int8_checkpoint_round_trips_its_scales(fitted, tmp_path):
    """int8 ``models/quant_scales.npz``: the JAX package restores the
    port's scales bitwise and serves the same int8 bytes, and so does the
    port itself."""
    _, model = fitted
    try:
        model.set_quantize('int8')
        prep = model._prepared_pair()
        model.save_model(str(tmp_path))
        jmodel = jax_load_model(str(tmp_path))
        for name, q in (('table_scale', prep.tables), ('w_dense_scale', prep.w_dense)):
            np.testing.assert_array_equal(np.asarray(jmodel._quant_scales[name]), q.scale.numpy())
        jprep = jmodel._prepared_pair()
        np.testing.assert_array_equal(np.asarray(jprep.tables.data), prep.tables.data.numpy())
        back = load_model(str(tmp_path), device='cpu')
        assert back.quantize == 'int8'
        got = back._prepared_pair()
        assert torch.equal(got.tables.scale, prep.tables.scale)
        assert torch.equal(got.tables.data, prep.tables.data)
        tb = synthetic_batch(2, 256, seed=8, device='cpu')
        jb = jax_synthetic_batch(2, 256, seed=8)
        np.testing.assert_allclose(
            back.rate_batch(tb).numpy(), np.asarray(jmodel.rate_batch(jb)), rtol=0, atol=1e-5
        )
    finally:
        model.set_quantize('none')


def test_warm_start_reuses_stats_and_weights(fitted):
    """A warm start keeps the seed model's statistics and, with no epochs
    to run, its weights bitwise; the seed model is not changed."""
    _, model = fitted
    before = [p.clone() for p in model._models['scores'].module.parameters()]
    warm = VAEP(device='cpu').fit_packed(
        synthetic_batch(2, 256, seed=21, device='cpu'), tree_params={'max_epochs': 0},
        random_state=1, warm_start=model,
    )
    for col in ('scores', 'concedes'):
        old, new = model._models[col], warm._models[col]
        assert torch.equal(new.mean_, old.mean_) and torch.equal(new.std_, old.std_)
        assert new.hidden == old.hidden and new.batch_size == old.batch_size
        for p, q in zip(new.module.parameters(), old.module.parameters()):
            assert torch.equal(p, q) and p is not q
    for p, q in zip(before, model._models['scores'].module.parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize(
    'learner, match',
    [('sklearn', 'packed fit path'), ('xgboost', 'packed fit path'), ('seq', 'not ported')],
)
def test_fit_packed_rejects_unported_learners(learner, match):
    with pytest.raises(ValueError, match=match):
        VAEP(device='cpu').fit_packed(synthetic_batch(1, 128, device='cpu'), learner=learner)


def test_fit_packed_empty_raises():
    with pytest.raises(ValueError, match='no batches'):
        VAEP(device='cpu').fit_packed(iter([]))


def test_fit_packed_rejects_a_batch_on_another_device():
    with pytest.raises(ValueError, match='lives on meta'):
        VAEP(device='cpu').fit_packed(synthetic_batch(1, 128, device='meta'))


def test_save_model_needs_heads(tmp_path):
    with pytest.raises(NotFittedError):
        VAEP(device='cpu').save_model(str(tmp_path))
    assert not os.path.exists(tmp_path / 'meta.json')
