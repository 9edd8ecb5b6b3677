"""The port's promotion-gate statistics (``learn/``) against the JAX package's.

Seeded numpy draws, packed synthetic traffic and seeded MLP heads go
through both packages on the CPU; these mirror the JAX package's own
tests (``tests/test_learn.py`` calibration, shadow and gate, and
``tests/test_drift.py``). Tolerances:

- calibration: ``n`` bitwise; reliability curve, ECE, Brier and its
  decomposition within 1e-6; bootstrap intervals within 1e-6 with the JAX
  package's resample draws injected (``_indices=``);
- drift: bin edges and proportions bitwise (counts of 0/1 weights);
  PSI and KS within 1e-6; ``triggered`` equal;
- shadow replay: probabilities within 1e-5 (the materialized f32 path),
  its summaries as calibration's;
- the gate: verdicts and reasons equal.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from socceraction_tpu.core.batch import pack_actions as jax_pack_actions
from socceraction_tpu.core.synthetic import synthetic_actions_frame
from socceraction_tpu.learn import calibration as jcal
from socceraction_tpu.learn import drift as jdrift
from socceraction_tpu.learn import gate as jgate
from socceraction_tpu.learn import shadow as jshadow
from socceraction_tpu.vaep.base import VAEP as JaxVAEP
from socceraction_tpu_torch.learn import calibration as tcal
from socceraction_tpu_torch.learn import drift as tdrift
from socceraction_tpu_torch.learn import gate as tgate
from socceraction_tpu_torch.learn import shadow as tshadow
from socceraction_tpu_torch.obs import REGISTRY, RECORDER
from socceraction_tpu_torch.ops.fused import STANDARD_REGISTRY
from socceraction_tpu_torch.vaep.base import load_model
from tests.test_torch_rating_paths import _mlp_head

HOME = 100


def _draws(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.uniform(0, 1, n).astype(np.float32)
    y = (rng.uniform(0, 1, n) < p).astype(np.float32)
    w = (rng.uniform(0, 1, n) < 0.9).astype(np.float32)
    return p, y, w


def _jax_indices(seed, n_boot, n):
    """The row indices JAX's bootstrap draws: one randint per split key."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_boot)
    return np.array(jax.vmap(lambda k: jax.random.randint(k, (n,), 0, n))(keys))


# -- calibration --------------------------------------------------------------------------------


def test_reliability_curve_matches_jax():
    p, y, w = _draws(seed=1)
    got = tcal.reliability_curve(p, y, w, n_bins=10, device='cpu')
    want = jcal.reliability_curve(p, y, w, n_bins=10)
    for g, v in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(v), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))  # bin weights are counts


def test_reliability_curve_masses_and_empty_bins():
    p = np.asarray([0.05, 0.05, 0.95, 0.95], np.float32)
    y = np.asarray([0.0, 1.0, 1.0, 1.0], np.float32)
    conf, acc, w = tcal.reliability_curve(torch.from_numpy(p), torch.from_numpy(y), n_bins=10)
    assert conf.shape == (10,) and w.sum() == pytest.approx(4.0)
    assert (w[0], w[9]) == (2.0, 2.0) and np.all(w[1:9] == 0)
    assert acc[0] == pytest.approx(0.5) and conf[9] == pytest.approx(0.95)


@pytest.mark.parametrize('n,n_boot,seed', [(4000, 64, 7), (1500, 200, 0)])
def test_calibration_summary_matches_jax_with_its_draws(n, n_boot, seed):
    p, y, w = _draws(n, seed=seed + 2)
    want = jcal.calibration_summary(p, y, w, n_bins=10, n_boot=n_boot, seed=seed)
    got = tcal.calibration_summary(
        p, y, w, n_bins=10, n_boot=n_boot, seed=seed, device='cpu',
        _indices=_jax_indices(seed, n_boot, n),
    )
    assert got.n == want.n
    for name in ('ece', 'brier', 'brier_reliability', 'brier_resolution', 'brier_uncertainty'):
        assert abs(getattr(got, name) - getattr(want, name)) <= 1e-6, name
    for name in ('ece_ci', 'brier_ci'):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=0, atol=1e-6)
    assert got.to_dict().keys() == want.to_dict().keys()


def test_chunked_bootstrap_equals_one_chunk(monkeypatch):
    """The resamples in chunks of 3 give the intervals of one chunk."""
    p, y, w = _draws(500, seed=4)
    whole = tcal.calibration_summary(p, y, w, n_boot=20, seed=3, device='cpu')
    monkeypatch.setattr(tcal, '_CHUNK_BYTES', 3 * tcal._BYTES_PER_ROW * 500)
    chunked = tcal.calibration_summary(p, y, w, n_boot=20, seed=3, device='cpu')
    assert chunked == whole


def test_ece_separates_calibrated_from_anticalibrated():
    p, y, _ = _draws()
    good = tcal.calibration_summary(p, y, n_bins=10, n_boot=32, device='cpu')
    bad = tcal.calibration_summary(p, 1.0 - y, n_bins=10, n_boot=32, device='cpu')
    assert good.ece < 0.05 < 0.25 < bad.ece and bad.brier > good.brier


def test_brier_decomposition_identity():
    p, y, _ = _draws(seed=3)
    s = tcal.calibration_summary(p, y, n_bins=10, n_boot=8, device='cpu')
    recomposed = s.brier_reliability - s.brier_resolution + s.brier_uncertainty
    assert recomposed == pytest.approx(s.brier, abs=0.01)
    assert 0.0 <= s.brier_uncertainty <= 0.25 + 1e-6


def test_bootstrap_cis_deterministic_and_ordered():
    p, y, _ = _draws(seed=5)
    a = tcal.calibration_summary(p, y, n_boot=64, seed=7, device='cpu')
    b = tcal.calibration_summary(p, y, n_boot=64, seed=7, device='cpu')
    assert a.ece_ci == b.ece_ci and a.brier_ci == b.brier_ci
    assert a.ece_ci[0] <= a.ece_ci[1] and a.brier_ci[0] <= a.brier_ci[1]
    assert tcal.calibration_summary(p, y, n_boot=64, seed=8, device='cpu').ece_ci != a.ece_ci


def test_zero_weight_rows_contribute_nothing():
    p, y, _ = _draws(seed=9)
    w = np.ones_like(p)
    s0 = tcal.calibration_summary(p, y, w, n_boot=4, device='cpu')
    s1 = tcal.calibration_summary(
        np.concatenate([p, np.full(100, 0.99, np.float32)]),
        np.concatenate([y, np.zeros(100, np.float32)]),
        np.concatenate([w, np.zeros(100, np.float32)]),
        n_boot=4, device='cpu',
    )
    assert s1.ece == pytest.approx(s0.ece, abs=1e-6)
    assert s1.brier == pytest.approx(s0.brier, abs=1e-6)
    assert s1.n == s0.n


def test_f64_summary_is_the_exact_sums():
    """``_dtype=torch.float64`` (the reference a card check holds its f32
    statistics to) bins as f32 does, and sums as numpy does in f64; it is a
    CPU reference only, and f64 tensors on another device raise."""
    p, y, w = _draws(30000, seed=11)
    p = (0.5 + 0.02 * (p - 0.5)).astype(np.float32)  # one crowded bin, as a degraded head's
    s64 = tcal.calibration_summary(p, y, w, n_boot=4, device='cpu', _dtype=torch.float64)
    s32 = tcal.calibration_summary(p, y, w, n_boot=4, device='cpu')
    assert s64.n == s32.n
    bins = np.clip((p * 10).astype(np.int32), 0, 9)
    pd_, yd, wd = (a.astype(np.float64) for a in (p, y, w))
    mass = np.bincount(bins, wd, 10)
    conf = np.bincount(bins, wd * pd_, 10) / np.maximum(mass, 1e-12)
    acc = np.bincount(bins, wd * yd, 10) / np.maximum(mass, 1e-12)
    ece = float((mass / wd.sum() * np.abs(conf - acc)).sum())
    brier = float((wd * (pd_ - yd) ** 2).sum() / wd.sum())
    assert abs(s64.ece - ece) <= 1e-12 and abs(s64.brier - brier) <= 1e-12
    assert abs(s32.ece - ece) <= 1e-5  # f32: about 15,000 terms a bin, one after another
    with pytest.raises(ValueError, match='float32 or float64'):
        tcal.calibration_summary(p, y, w, device='cpu', _dtype=torch.float16)
    on_meta = [torch.from_numpy(a).to('meta') for a in (p, y, w)]
    with pytest.raises(ValueError, match='CPU reference'):
        tcal.calibration_summary(*on_meta, n_boot=4, _dtype=torch.float64)


def test_calibration_validation_errors():
    p, y, _ = _draws(n=16)
    with pytest.raises(ValueError, match='bins'):
        tcal.calibration_summary(p, y, n_bins=1, device='cpu')
    with pytest.raises(ValueError, match='resample'):
        tcal.calibration_summary(p, y, n_boot=0, device='cpu')
    with pytest.raises(ValueError, match='shape'):
        tcal.calibration_summary(p, y[:-1], device='cpu')
    with pytest.raises(ValueError, match='_indices'):
        tcal.calibration_summary(p, y, n_boot=2, device='cpu', _indices=np.zeros((3, 16)))


# -- drift --------------------------------------------------------------------------------------


def _frame(i, n=200):
    return synthetic_actions_frame(
        game_id=i, home_team_id=HOME, away_team_id=HOME + 1, seed=i, n_actions=n
    )


def _jax_batch(games=(0, 1, 2, 3), n=200, max_actions=256):
    stagings = [
        jax_pack_actions(_frame(i, n).assign(game_id=i), home_team_id=HOME,
                         max_actions=max_actions, as_numpy=True)[0]
        for i in games
    ]
    return jax.tree.map(lambda *xs: np.concatenate(xs, axis=0), *stagings)


def _batches(games=(0, 1, 2, 3), n=200, max_actions=256):
    """(JAX host batch, port batch on the CPU) of the same traffic."""
    frames = [(_frame(i, n), HOME) for i in games]
    return (
        _jax_batch(games, n, max_actions),
        tshadow.pack_replay_batch(frames, max_actions=max_actions, device='cpu'),
    )


def _shift(batch):
    return dataclasses.replace(batch, start_x=batch.start_x * 0.2 + 80.0)


@pytest.fixture(scope='module')
def models(tmp_path_factory):
    """(JAX VAEP, the port's VAEP) with the same seeded MLP heads."""
    jmodel = JaxVAEP()
    for seed, col in enumerate(('scores', 'concedes')):
        jmodel._models[col] = _mlp_head(JaxVAEP, STANDARD_REGISTRY, seed + 3)
    path = str(tmp_path_factory.mktemp('heads'))
    jmodel.save_model(path)
    return jmodel, load_model(path, device='cpu')


def _same_reference(got, want):
    assert got.names == want.names and got.n_actions == want.n_actions
    for name in ('lo', 'hi', 'props'):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)))


@pytest.mark.parametrize('predictions', [False, True], ids=['fields', 'with_predictions'])
def test_drift_matches_jax(models, predictions):
    """Reference edges and proportions bitwise; PSI and KS within 1e-6 on
    the same traffic and on traffic shifted in start_x; triggered equal."""
    jmodel, model = models
    cfg = dict(min_actions=64, include_predictions=predictions)
    jb, tb = _batches()
    jwatch = jdrift.DriftWatch.from_batch(jmodel if predictions else None, jb,
                                          jdrift.DriftConfig(**cfg))
    watch = tdrift.DriftWatch.from_batch(model if predictions else None, tb,
                                         tdrift.DriftConfig(**cfg))
    _same_reference(watch.reference, jwatch.reference)
    for shift in (False, True):
        window_j = _shift(jb) if shift else jb
        window_t = _shift(tb) if shift else tb
        want = jwatch.check(jmodel if predictions else None, window_j)
        got = watch.check(model if predictions else None, window_t)
        assert got.triggered == want.triggered and got.n_actions == want.n_actions
        assert got.max_psi_feature == want.max_psi_feature
        for stat in ('psi', 'ks'):
            g, w = getattr(got, stat), getattr(want, stat)
            assert g.keys() == w.keys()
            for name in g:
                assert abs(g[name] - w[name]) <= 1e-6, (stat, name)


def test_same_distribution_scores_zero_psi():
    cfg = tdrift.DriftConfig(min_actions=64, include_predictions=False)
    _, tb = _batches()
    res = tdrift.DriftWatch.from_batch(None, tb, cfg).check(None, tb)
    assert res.evaluated and not res.triggered
    assert res.max_psi == pytest.approx(0.0, abs=1e-6) and res.max_ks == pytest.approx(0.0, abs=1e-6)


def test_shifted_distribution_triggers_on_the_right_feature():
    cfg = tdrift.DriftConfig(min_actions=64, include_predictions=False)
    _, tb = _batches()
    res = tdrift.DriftWatch.from_batch(None, tb, cfg).check(None, _shift(tb))
    assert res.triggered and res.max_psi_feature == 'start_x' and res.max_psi > cfg.psi_trigger
    assert 'start_x' in res.reasons[0] and res.psi['start_y'] < 0.05


def test_padding_rows_are_not_evidence():
    cfg = tdrift.DriftConfig(min_actions=64, include_predictions=False)
    _, tb = _batches()
    watch = tdrift.DriftWatch.from_batch(None, tb, cfg)
    padded = type(tb)(**{
        n: torch.cat([t, torch.zeros((2, *t.shape[1:]), dtype=t.dtype)])
        for n, t in tb.fields().items()
    })
    r1, r2 = watch.check(None, tb), watch.check(None, padded)
    assert r1.psi == r2.psi and r1.ks == r2.ks and r1.n_actions == r2.n_actions


def test_small_window_reports_unevaluated():
    cfg = tdrift.DriftConfig(min_actions=10_000, include_predictions=False)
    _, tb = _batches()
    _, one = _batches(games=(0,))
    res = tdrift.DriftWatch.from_batch(None, tb, cfg).check(None, one)
    assert not res.evaluated and not res.triggered and 'too small' in res.reasons[0]


def test_window_gate_reads_the_host_count():
    """The gate counts valid actions from the batch's host count: a batch
    whose host count says 10 is too small whatever its mask holds."""
    cfg = tdrift.DriftConfig(min_actions=64, include_predictions=False)
    _, tb = _batches()
    watch = tdrift.DriftWatch.from_batch(None, tb, cfg)
    res = watch.check(None, dataclasses.replace(tb).with_total(10))
    assert not res.evaluated and res.n_actions == 10


def test_prediction_rows_and_mismatched_reference(models):
    _, model = models
    _, tb = _batches()
    watch = tdrift.DriftWatch.from_batch(model, tb, tdrift.DriftConfig(min_actions=64))
    names = list(watch.reference.names)
    assert names[-2:] == ['pred_concedes', 'pred_scores']
    i = names.index('pred_scores')
    assert (watch.reference.lo[i], watch.reference.hi[i]) == (0.0, 1.0)
    assert watch.check(model, tb).max_psi == pytest.approx(0.0, abs=1e-6)
    fields_only = tdrift.DriftWatch.from_batch(
        None, tb, tdrift.DriftConfig(min_actions=64, include_predictions=False)
    )
    with pytest.raises(ValueError, match='do not match the reference'):
        tdrift.drift_statistics(fields_only.reference, tb, tshadow.replay_probs(model, tb))


def test_reference_round_trips_and_manifest():
    _, tb = _batches()
    ref = tdrift.build_drift_reference(None, tb, tdrift.DriftConfig(include_predictions=False))
    back = tdrift.DriftReference.from_dict(ref.to_dict())
    _same_reference(back, ref)
    watch = tdrift.DriftWatch.from_manifest({'drift_reference': ref.to_dict()}, model_version='7')
    assert watch.reference.model_version == '7'
    with pytest.raises(ValueError, match='drift_reference'):
        tdrift.DriftWatch.from_manifest({})


def test_drift_telemetry_surface():
    REGISTRY.reset()
    cfg = tdrift.DriftConfig(min_actions=64, include_predictions=False)
    _, tb = _batches()
    watch = tdrift.DriftWatch.from_batch(None, tb, cfg)
    watch.check(None, tb)
    watch.check(None, _shift(tb))
    snap = REGISTRY.snapshot()
    assert snap.value('drift/checks') == 2 and snap.value('drift/triggers') == 1
    assert snap.value('drift/psi', stat='last', feature='start_x') > 0.25
    assert snap.value('drift/max_psi', stat='last') > 0.25
    assert 'drift_check' in [e['kind'] for e in RECORDER.events()]


# -- shadow replay ------------------------------------------------------------------------------


def test_pack_replay_batch_matches_jax():
    frames = [(_frame(30, n=100), HOME), (_frame(31, n=40), HOME), (_frame(32, n=0), HOME)]
    want = jshadow.pack_replay_batch(frames, max_actions=64)
    got = tshadow.pack_replay_batch(frames, max_actions=64, device='cpu')
    assert got.n_games == 2 and got.total_actions == 64 + 40
    for name, t in got.fields().items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(want, name)), err_msg=name)
    with pytest.raises(ValueError, match='traffic'):
        tshadow.pack_replay_batch([], max_actions=64, device='cpu')
    with pytest.raises(ValueError, match='exactly one'):
        tshadow.shadow_replay(None, None)


def test_shadow_replay_matches_jax(models, monkeypatch):
    """Probabilities within 1e-5, n bitwise, the metrics within 1e-6 and,
    with JAX's resample draws injected, the intervals within 1e-6; a second
    replay bitwise the first."""
    jmodel, model = models
    frames = [(_frame(20, n=60), HOME), (_frame(21, n=80), HOME)]
    want = jshadow.shadow_replay(jmodel, frames, max_actions=128, n_boot=16, seed=3)
    monkeypatch.setattr(tcal, '_resample_indices',
                        lambda seed, n_boot, n, chunk: [torch.from_numpy(_jax_indices(seed, n_boot, n))])
    got = tshadow.shadow_replay(model, frames, max_actions=128, n_boot=16, seed=3)
    again = tshadow.shadow_replay(model, frames, max_actions=128, n_boot=16, seed=3)
    assert (got.n_frames, got.n_actions) == (want.n_frames, want.n_actions) == (2, 140)
    mask = np.asarray(jshadow.pack_replay_batch(frames, max_actions=128).mask)
    for col in ('scores', 'concedes'):
        np.testing.assert_allclose(got.probs[col].numpy()[mask], want.probs[col][mask],
                                   rtol=0, atol=1e-5)
        assert torch.equal(got.probs[col], again.probs[col])
        g, w = got.summaries[col].to_dict(), want.summaries[col].to_dict()
        assert g == again.summaries[col].to_dict()
        assert g['n'] == w['n'] == 140.0
        for key in ('ece', 'brier', 'brier_reliability', 'brier_resolution', 'brier_uncertainty'):
            assert abs(g[key] - w[key]) <= 1e-6, key
        np.testing.assert_allclose(g['ece_ci'] + g['brier_ci'], w['ece_ci'] + w['brier_ci'],
                                   rtol=0, atol=1e-6)
    assert got.to_dict().keys() == want.to_dict().keys()


# -- the gate -----------------------------------------------------------------------------------


def _summary(mod, ece, brier, n=1000.0):
    return mod.CalibrationSummary(
        n=n, ece=ece, brier=brier, brier_reliability=ece, brier_resolution=0.0,
        brier_uncertainty=brier, ece_ci=(ece * 0.8, ece * 1.2), brier_ci=(brier * 0.9, brier * 1.1),
    )


CANDIDATES = {
    'better': ((0.03, 0.09), (0.04, 0.08), 1000.0),
    'worse_ece': ((0.09, 0.10), (0.04, 0.08), 1000.0),
    'worse_brier': ((0.05, 0.12), (0.04, 0.08), 1000.0),
    'within_band': ((0.055, 0.102), (0.045, 0.083), 1000.0),
    'small': ((0.03, 0.09), (0.04, 0.08), 8.0),
}


def _heads(mod, spec):
    (se, sb), (ce, cb), n = spec
    return {'scores': _summary(mod, se, sb, n), 'concedes': _summary(mod, ce, cb)}


def _drift_result(mod, max_psi, evaluated=True):
    return mod.DriftResult(psi={'start_x': max_psi}, ks={'start_x': 0.0}, max_psi=max_psi,
                           max_psi_feature='start_x', evaluated=evaluated, n_actions=1000)


@pytest.mark.parametrize('case', list(CANDIDATES))
@pytest.mark.parametrize('active', [True, False], ids=['active', 'bootstrap'])
@pytest.mark.parametrize('extra', ['none', 'drift_ok', 'drift_bad', 'drift_none', 'parity_ok',
                                   'parity_bad', 'parity_none', 'nonfinite'])
def test_gate_matches_jax(case, active, extra):
    """Every verdict and reason equal to the JAX package's, over the
    calibration bands, the drift band and the parity band."""
    out = []
    for cal, drift, gate in ((tcal, tdrift, tgate), (jcal, jdrift, jgate)):
        cfg = dict(max_ece_regression=0.01, max_brier_regression=0.005)
        kw = {}
        if extra.startswith('drift'):
            cfg['max_drift_psi'] = 0.25
            kw['drift'] = {'drift_ok': _drift_result(drift, 0.1),
                           'drift_bad': _drift_result(drift, 0.4),
                           'drift_none': None}[extra]
        if extra.startswith('parity') or extra == 'nonfinite':
            cfg['max_parity_err'] = 1e-5
            kw['parity'] = {
                'parity_ok': {'evaluated': True, 'max_abs_err': 1e-7, 'probes': 3},
                'parity_bad': {'evaluated': True, 'max_abs_err': 1e-3, 'probes': 3},
                'parity_none': None,
                'nonfinite': {'evaluated': True, 'max_abs_err': 0.0, 'probes': 1,
                              'serve_nonfinite_events': 2},
            }[extra]
        act = _heads(cal, ((0.05, 0.10), (0.04, 0.08), 1000.0)) if active else None
        out.append(gate.evaluate_gate(act, _heads(cal, CANDIDATES[case]), gate.GateConfig(**cfg), **kw))
    assert out[0] == out[1]


def test_report_and_record(monkeypatch):
    REGISTRY.reset()
    active = _heads(tcal, ((0.05, 0.10), (0.04, 0.08), 1000.0))
    cand = _heads(tcal, CANDIDATES['better'])
    heads = tgate.compare_heads(active, cand)
    want = jgate.compare_heads(_heads(jcal, ((0.05, 0.10), (0.04, 0.08), 1000.0)),
                               _heads(jcal, CANDIDATES['better']))
    assert heads == want
    report = tgate.PromotionReport(name='vaep', verdict='promoted', heads=heads,
                                   archs={'scores': 'mlp'}, time_unix=1.0)
    jreport = jgate.PromotionReport(name='vaep', verdict='promoted', heads=want,
                                    archs={'scores': 'mlp'}, time_unix=1.0)
    assert report.to_dict() == jreport.to_dict() and report.promoted
    tgate.record_report(report)
    snap = REGISTRY.snapshot()
    assert snap.value('learn/promotions', verdict='promoted') == 1
    assert snap.value('learn/ece', stat='last', head='scores', model='candidate') == 0.03
    assert 'promotion_report' in [e['kind'] for e in RECORDER.events()]
    assert tgate.GateConfig() == tgate.GateConfig(**dataclasses.asdict(jgate.GateConfig()))


def test_calibration_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    p, y, _ = _draws(16)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tcal.calibration_summary(p, y)
