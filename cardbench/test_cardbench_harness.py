"""CPU tests of the benchmark harness: the reference against the port at a tiny
size, the frozen counts and the metric arithmetic, discovery by name, and the
imports a run may not make.

    python -m pytest cardbench -q
"""

from __future__ import annotations

import ast
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cardbench import reference, run, spec as specmod, testing, trace, traffic, yardstick

CELLS = ('vaep-season-rate', 'atomic-season-rate', 'vaep-scenario-grid')
SEED = 2**31 + 11


@pytest.fixture(scope='module')
def tiny(tmp_path_factory):
    torch.set_num_threads(2)  # tiny calls: more threads only contend under parallel workers
    return specmod.Spec(testing.tiny_root(tmp_path_factory.mktemp('tiny')))


@pytest.mark.parametrize('cell', CELLS)
def test_port_matches_reference_on_cpu(tiny, cell):
    """The timed entry's values on the CPU, held to the float64 reference by
    the run's own comparison, within the cell's limit."""
    prepared = run.prepare(tiny, cell, SEED, torch.device('cpu'))
    load = prepared.load
    answers = [(item, load.values(item)) for item in load.items[:2]]
    judged = traffic.judge(prepared.model, load, answers)
    assert judged['nonfinite'] == 0
    assert 0 < judged['max_abs_gap'] <= tiny.limits(cell)['max_abs_gap'] / 4


@pytest.mark.parametrize('cell', CELLS)
def test_run_is_correct_and_reports_its_metrics(tiny, cell):
    result = run.run_cell(tiny, cell, SEED, 0.5, False, torch.device('cpu'))
    assert result['correct'] and result['failed'] == 0 and result['attempted'] > 1
    want = {m['name'] for m in tiny.metrics(cell, per_layer=False)}
    assert set(result['metrics']) == want
    assert list(result)[-1] == 'checks'
    assert result['compared']['answers'] == json.loads(
        (tiny.root / 'cardbench/traffic' / f"{tiny.workload(cell)['traffic']}.json").read_text())['samples']


def test_traced_run_reads_the_host_side_on_cpu(tiny):
    """On the CPU the profiler sees no device work: device metrics are left
    out, host ones are read, the breakdown is there."""
    result = run.run_cell(tiny, 'vaep-scenario-grid', SEED, 0.6, True, torch.device('cpu'))
    assert result['correct']
    assert set(result['metrics']) == {'expand_ms.scenario'}
    assert result['metrics']['expand_ms.scenario']['value'] > 0
    assert result['device']['busy_s'] == 0 and result['device']['window_s'] > 0
    assert result['breakdown']['device_ops'] == [] and result['breakdown']['idle_gaps']


def test_seed_fixes_the_inputs_and_the_work(tiny):
    a = run.prepare(tiny, 'vaep-season-rate', SEED, torch.device('cpu'), program=False)
    b = run.prepare(tiny, 'vaep-season-rate', SEED, torch.device('cpu'), program=False)
    c = run.prepare(tiny, 'vaep-season-rate', SEED + 1, torch.device('cpu'), program=False)
    for name, t in a.season.fields.items():
        assert torch.equal(t, b.season.fields[name])
    assert not torch.equal(a.season.fields['start_x'], c.season.fields['start_x'])
    assert [i.work for i in a.load.items] == [i.work for i in c.load.items]


def test_stratified_lengths_give_every_seed_the_same_work():
    t = {'valid_low': 1200, 'valid_high': 1664, 'stratum_games': 512, 'season_games': 3072}
    runs = [traffic.stratified_lengths(np.random.default_rng(s), t) for s in (1, 2**31 + 5)]
    for lengths in runs:
        assert lengths.min() >= 1200 and lengths.max() <= 1664
        strata = lengths.reshape(6, 512)
        assert all(sorted(s) == sorted(strata[0]) for s in strata)
        assert len(set(lengths.reshape(-1, 4).sum(1))) == 1
    assert not np.array_equal(*runs)
    assert abs(statistics.mean(runs[0]) - 1432) < 1


# -- frozen counts ------------------------------------------------------------


def test_b1_counts_by_hand():
    cfg = {'nb_prev_actions': 3, 'table_rows': 552, 'hidden': [128, 128], 'dense_columns': 55}
    rows = 1000
    # tables 3·552·256 + W 55·256 + bias 256 floats; per row 3 ids, 55 x, 256 out
    assert yardstick.b1_bytes(cfg, rows) == 4 * (423936 + 14080 + 256) + rows * 4 * 314
    assert yardstick.b1_ops(cfg, rows) == rows * (2 * 55 * 256 + 3 * 256)
    peak = yardstick.peaks('NVIDIA H100 80GB HBM3')
    # the serving shape, every slot valid: bytes-bound at 0.320 ms
    assert yardstick.b1_least_seconds(cfg, 512 * 1664, peak) == pytest.approx(3.20e-4, rel=3e-3)
    assert yardstick.flops_per_action(cfg) == 2 * 55 * 256 + 3 * 256 + 2 * (2 * 128 * 128 + 2 * 128)
    assert yardstick.peaks('NVIDIA A100-SXM4-40GB') is None


def test_configs_state_their_fold_shape(tiny):
    """``table_rows``, ``dense_columns`` and ``n_features`` of each
    configuration, against the reference's layout and the port's fold."""
    from socceraction_tpu_torch.ops.fused import REGISTRIES, train_layout

    for name in ('vaep-mlp128', 'atomic-vaep-mlp128'):
        cfg = tiny.config(name)
        family, _ = reference.modules(cfg)
        gen = torch.Generator().manual_seed(1)
        f = reference.cast(family.draw(gen, 2, 16, torch.device('cpu')), torch.float64)
        x, onehot = reference.features(family, cfg, f)
        assert x.shape[-1] == cfg['n_features'] and int((~onehot).sum()) == cfg['dense_columns']
        registry = REGISTRIES['atomic' if cfg['model_class'] == 'AtomicVAEP' else 'standard']
        layout = train_layout(cfg['xfns'], cfg['nb_prev_actions'], registry)
        dense = sum(w for _, kind, _, w in layout.spans if kind == 'dense')
        assert dense == cfg['dense_columns']


# -- metric arithmetic --------------------------------------------------------


def call(work, ms, t_entry=0.0, t_return=0.0):
    return SimpleNamespace(work=work, device_ms=ms, ok=True, t_entry=t_entry, t_return=t_return)


def test_rates_and_tail_over_all_calls(tiny):
    calls = [call(100, float(i)) for i in range(1, 101)]
    r = SimpleNamespace(work_unit='actions', calls=calls, wall_s=2.0, untraced=calls)
    assert tiny.reader('rated_actions_per_s')(r) == 5000.0
    assert tiny.reader('scenario_values_per_s')(r) is None
    assert tiny.reader('call_p95_ms')(r) == pytest.approx(95.05)
    calls[3].ok = False
    assert tiny.reader('rated_actions_per_s')(r) == 4950.0
    r.calls = [call(1, 1.0, t_entry=1.0, t_return=1.004), call(1, 1.0, t_entry=2.0, t_return=2.002)]
    r.untraced = r.calls
    assert tiny.reader('enqueue_ms.rate')(r) == pytest.approx(3.0)


def synthetic_trace():
    """Two calls on [0, 10] and [10, 20] s; device work [1, 3], [2, 4]
    (overlapping), [12, 15]; a host operator over [4, 6] inside the first."""
    events = [
        {'ph': 'X', 'cat': 'user_annotation', 'name': trace.CALL_RANGE, 'ts': 0, 'dur': 10e6, 'tid': 1},
        {'ph': 'X', 'cat': 'user_annotation', 'name': trace.CALL_RANGE, 'ts': 10e6, 'dur': 10e6, 'tid': 1},
        {'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::mm', 'ts': 4e6, 'dur': 2e6, 'tid': 1},
        {'ph': 'X', 'cat': 'cpu_op', 'name': 'other thread', 'ts': 0, 'dur': 20e6, 'tid': 2},
        {'ph': 'X', 'cat': 'user_annotation', 'name': 'scenario/dispatch', 'ts': 11e6, 'dur': 1e6, 'tid': 1},
        {'ph': 'X', 'cat': 'kernel', 'name': 'void gather_matmul_kernel<float>', 'ts': 1e6, 'dur': 2e6},
        {'ph': 'X', 'cat': 'kernel', 'name': 'sgemm', 'ts': 2e6, 'dur': 2e6},
        {'ph': 'X', 'cat': 'gpu_memcpy', 'name': 'Memcpy DtoH', 'ts': 12e6, 'dur': 3e6},
        {'ph': 'X', 'cat': 'gpu_user_annotation', 'name': trace.CALL_RANGE, 'ts': 0, 'dur': 20e6},
        {'ph': 'i', 'cat': 'kernel', 'name': 'instant', 'ts': 5e6},
    ]
    return trace.parse(events)


def test_union_of_intervals_and_idle_share(tiny):
    t = synthetic_trace()
    assert t.window == (0.0, 20.0)
    assert trace.busy_s(t) == pytest.approx(6.0)  # [1, 4] and [12, 15]
    assert trace.gaps(t) == [(0.0, 1.0), (4.0, 12.0), (15.0, 20.0)]
    r = SimpleNamespace(trace=t, traffic={'kind': 'scenario'})
    assert tiny.reader('idle_share.rate')(r) == pytest.approx(70.0)
    assert tiny.reader('expand_ms.scenario')(r) == pytest.approx(1000.0)  # 11 s less 10 s


def test_idle_gaps_by_host_activity():
    gaps = trace.host_during_gaps(synthetic_trace())
    # gaps [0, 1], [4, 12], [15, 20] of the calling thread (tid 1) only
    assert gaps == pytest.approx({trace.CALL_RANGE: 11.0, 'aten::mm': 2.0, 'scenario/dispatch': 1.0})
    b = trace.breakdown(synthetic_trace())
    assert b['device_ops'][0] == ['Memcpy DtoH', pytest.approx(3.0)]
    assert sum(s for _, s in b['idle_gaps']) == pytest.approx(14.0)


def test_innermost_segments_of_nested_events():
    segs = trace.innermost([(0, 10, 'a'), (2, 4, 'b'), (3, 4, 'c'), (6, 12, 'd')])
    assert segs == [(0, 2, 'a'), (2, 3, 'b'), (3, 4, 'c'), (4, 6, 'a'), (6, 10, 'd')]


def test_roofline_and_mfu(tiny):
    cfg = tiny.config('vaep-mlp128')
    t = synthetic_trace()
    untraced = [call(10**9, 0.0, t_entry=30.0), call(10**9, 0.0)]
    untraced[-1].t_end = 32.0
    r = SimpleNamespace(trace=t, config=cfg, device_name='NVIDIA H100 80GB HBM3',
                        traced=[call(10**9, 0.0), call(10**9, 0.0)], untraced=untraced)
    peak = yardstick.peaks(r.device_name)
    least = 2 * yardstick.b1_least_seconds(cfg, 10**9, peak)
    assert tiny.reader('b1_roofline.rate')(r) == pytest.approx(100 * least / 2.0)
    flops = 2e9 * yardstick.flops_per_action(cfg)
    assert tiny.reader('mfu.scenario')(r) == pytest.approx(100 * flops / 2.0 / 495e12)
    r.device_name = 'cpu'
    assert tiny.reader('b1_roofline.rate')(r) is None and tiny.reader('mfu.rate')(r) is None


# -- discovery ----------------------------------------------------------------


def test_cells_find_their_pieces_by_name():
    s = specmod.Spec()
    assert [w['name'] for w in s.bench['workloads']] == list(CELLS)
    for w in s.bench['workloads']:
        assert s.config(w['config'])['hidden'] == [128, 128]
        assert s.traffic(w['traffic'])['season_games'] == 3072
        assert s.limits(w['name'])['max_abs_gap'] > 0
        e2e = s.metrics(w['name'], per_layer=False)
        assert 'setup_s' in {m['name'] for m in e2e} and len(e2e) >= 2
        layer = s.metrics(w['name'], per_layer=True)
        assert layer and all(m['moves'] in {e['name'] for e in e2e} for m in layer)
        assert issubclass(s.driver(s.traffic(w['traffic'])['kind']).Load, traffic.ClosedLoop)
    for m in s.bench['end_to_end'] + s.bench['per_layer']:
        assert callable(s.reader(m['name']))
    for c in s.bench['configs']:
        assert Path(c['file']).name == f"{c['name']}.json"


def test_a_new_config_mix_and_metric_are_new_files_only(tmp_path):
    """A test-only configuration, traffic mix, cell and per-layer metric,
    each a new file plus a ``BENCHMARK.json`` entry, run with no edit to any
    existing file."""
    root = testing.tiny_root(tmp_path)
    d = root / 'cardbench'
    cfg = json.loads((d / 'configs/vaep-mlp128.json').read_text())
    cfg['nb_prev_actions'] = 2
    (d / 'configs/vaep-k2.json').write_text(json.dumps(cfg))
    mix = json.loads((d / 'traffic/season-rate.json').read_text())
    mix.update(games_per_call=8, samples=2)
    (d / 'traffic/season-rate-8.json').write_text(json.dumps(mix))
    (d / 'cells/vaep-k2.rate8.json').write_text(json.dumps({'limits': {'max_abs_gap': 1e-6}}))
    (d / 'metrics/calls_per_s.test.py').write_text(
        'def read(run):\n    return len(run.calls) / run.wall_s\n')
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    bench['configs'].append({'name': 'vaep-k2', 'source': 'test', 'file': 'cardbench/configs/vaep-k2.json',
                             'reduced': ['nb_prev_actions'], 'why': 'test'})
    bench['workloads'].append({'name': 'vaep-k2.rate8', 'config': 'vaep-k2',
                               'traffic': 'season-rate-8', 'chips': 1, 'why': 'test'})
    bench['end_to_end'][0]['workloads'].append('vaep-k2.rate8')
    bench['per_layer'].append({'name': 'calls_per_s.test', 'unit': 'calls/s', 'better': 'higher',
                               'source': 'host_clock', 'layer': 'VAEP entry',
                               'moves': 'rated_actions_per_s', 'workloads': ['vaep-k2.rate8']})
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    s = specmod.Spec(root)
    e2e = run.run_cell(s, 'vaep-k2.rate8', SEED, 0.4, False, torch.device('cpu'))
    assert e2e['correct'] and 'rated_actions_per_s' in e2e['metrics']
    traced = run.run_cell(s, 'vaep-k2.rate8', SEED, 0.4, True, torch.device('cpu'))
    assert traced['correct'] and traced['metrics']['calls_per_s.test']['value'] > 0


#: A test-only traffic kind: its own arrivals, so its own window.
PACED_DRIVER = '''
"""Traffic kind ``paced``: one caller whose calls arrive ``calls_per_s`` a second."""

import time

from cardbench import traffic


class Load(traffic.ClosedLoop):
    def values(self, item):
        return self.program.rate_batch(item.batch)

    def window(self, seconds, device, trace_seconds):
        w = traffic.Window(device, trace_seconds)
        period = 1.0 / self.traffic['calls_per_s']
        while len(w.calls) * period < seconds:  # the arrivals inside the window
            i = len(w.calls)
            time.sleep(max(0.0, i * period - w.elapsed()))
            w.timed(self, i)
        return w.finish()
'''


def test_a_new_traffic_kind_is_new_files_only(tmp_path):
    """A test-only traffic kind with arrivals of its own (a driver that
    overrides the window), a mix of that kind, a cell and its limits: new
    files plus a ``BENCHMARK.json`` entry, with no edit to any existing
    file. The end-to-end and per-layer metrics read it as they read the
    closed loop."""
    root = testing.tiny_root(tmp_path)
    d = root / 'cardbench'
    (d / 'drivers/paced.py').write_text(PACED_DRIVER)
    mix = json.loads((d / 'traffic/season-rate.json').read_text())
    mix.update(kind='paced', calls_per_s=4.0, samples=2)
    (d / 'traffic/season-paced.json').write_text(json.dumps(mix))
    (d / 'cells/vaep-paced.json').write_text(json.dumps({'limits': {'max_abs_gap': 1e-6}}))
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    bench['workloads'].append({'name': 'vaep-paced', 'config': 'vaep-mlp128',
                               'traffic': 'season-paced', 'chips': 1, 'why': 'test'})
    for m in bench['end_to_end'] + bench['per_layer']:
        if 'vaep-season-rate' in m.get('workloads', []):
            m['workloads'].append('vaep-paced')
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    s = specmod.Spec(root)
    assert not issubclass(s.driver('rate').Load, s.driver('paced').Load)
    e2e = run.run_cell(s, 'vaep-paced', SEED, 1.0, False, torch.device('cpu'))
    assert e2e['correct'] and e2e['failed'] == 0
    assert set(e2e['metrics']) == {'rated_actions_per_s', 'call_p95_ms', 'setup_s'}
    # paced at 4 calls a second, a 1 s window holds 4 arrivals, however fast
    # the CPU makes the calls
    assert 1 <= e2e['attempted'] <= 4
    traced = run.run_cell(s, 'vaep-paced', SEED, 0.5, True, torch.device('cpu'))
    assert traced['correct'] and traced['metrics']['enqueue_ms.rate']['value'] > 0


# -- what a run may load ------------------------------------------------------


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, 'socceraction_tpu_torch_like', sys)
    assert 'socceraction_tpu_torch_like' not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, 'jaxlib.fake', sys)
    assert run.forbidden_modules() == ['jaxlib.fake']


def test_a_cpu_run_loads_no_jax_flax_or_jax_package(tmp_path):
    """A tiny cell in a fresh interpreter with the benchmark's modules: no
    module whose top-level name is forbidden gets loaded."""
    root = testing.tiny_root(tmp_path)
    code = (
        'import json, sys, torch\n'
        'from cardbench import run, spec, control\n'
        f'r = run.run_cell(spec.Spec({str(root)!r}), "vaep-scenario-grid", 5, 0.3, True, torch.device("cpu"))\n'
        'print(json.dumps({"correct": r["correct"], "loaded": run.forbidden_modules()}))\n'
    )
    out = subprocess.run([sys.executable, '-c', code], cwd=specmod.ROOT, capture_output=True,
                         text=True, timeout=300, env={**os.environ, 'JAX_PLATFORMS': 'cpu'})
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {'correct': True, 'loaded': []}


def test_harness_sources_import_no_jax_and_read_no_old_bench():
    for path in (specmod.ROOT / 'cardbench').rglob('*.py'):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names = [node.module]
            for n in names:
                assert n.split('.')[0] not in run.FORBIDDEN, (path, n)
        if not path.name.startswith('test_'):
            text = path.read_text()
            assert 'bench_history' not in text and 'benchmarks/' not in text, path


def test_command_fails_without_a_card_or_without_the_program(tmp_path):
    """No card here: the command exits non-zero and prints no result. In a
    directory of only ``BENCHMARK.json`` and ``cardbench/`` the same holds
    wherever it runs (the program is not there to import)."""
    import shutil

    shutil.copy(specmod.ROOT / 'BENCHMARK.json', tmp_path / 'BENCHMARK.json')
    shutil.copytree(specmod.ROOT / 'cardbench', tmp_path / 'cardbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    for cwd in (specmod.ROOT, tmp_path):
        out = subprocess.run(
            [sys.executable, '-m', 'cardbench.run', '--workload', 'vaep-season-rate',
             '--seed', str(2**31 + 3), '--seconds', '1', '--trace', '0'],
            cwd=cwd, capture_output=True, text=True, timeout=300)
        if torch.cuda.is_available() and cwd == specmod.ROOT:
            continue
        assert out.returncode != 0 and out.stdout.strip() == ''
