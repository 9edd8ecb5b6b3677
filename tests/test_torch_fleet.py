"""The port's cross-process telemetry plane against the JAX package's.

Every scenario of ``tests/test_fleet.py`` that covers ``obs/wire.py``,
``obs/endpoint.py`` and ``obs/fleet.py`` runs here on both packages, with
the same inputs: the literal outcome that file asserts holds for each, and
where the outcome is a document (a wire document, a merged snapshot, a
scrape, an aggregation pass) the port's equals the JAX package's as JSON,
with the wall-clock fields (``time_unix``, exemplar ``ts``) set equal.
Then across the packages: a document either one encodes decodes in the
other, four documents of both merge to the same JSON in each, and each
package's aggregator scrapes the other's endpoint. The three port modules
import without ``jax`` or ``torch`` in a fresh process, and the JAX
package's ``tools/obsctl.py`` reads the port's run logs (``trace`` across a
process hop, ``fleet`` post-mortem). The ``bench.py`` and ``benchdiff``
tests of ``tests/test_fleet.py`` exercise the JAX package's benchmark
tools and have no counterpart here.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import random
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

from socceraction_tpu.obs import context as jcontext
from socceraction_tpu.obs import endpoint as jendpoint
from socceraction_tpu.obs import export as jexport
from socceraction_tpu.obs import fleet as jfleet
from socceraction_tpu.obs import metrics as jmetrics
from socceraction_tpu.obs import slo as jslo
from socceraction_tpu.obs import wire as jwire
from socceraction_tpu_torch.obs import context as tcontext
from socceraction_tpu_torch.obs import endpoint as tendpoint
from socceraction_tpu_torch.obs import export as texport
from socceraction_tpu_torch.obs import fleet as tfleet
from socceraction_tpu_torch.obs import metrics as tmetrics
from socceraction_tpu_torch.obs import slo as tslo
from socceraction_tpu_torch.obs import trace as ttrace
from socceraction_tpu_torch.obs import wire as twire

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = {
    'jax': SimpleNamespace(
        tag='j', wire=jwire, endpoint=jendpoint, fleet=jfleet, metrics=jmetrics, export=jexport,
        slo=jslo, context=jcontext,
    ),
    'torch': SimpleNamespace(
        tag='t', wire=twire, endpoint=tendpoint, fleet=tfleet, metrics=tmetrics, export=texport,
        slo=tslo, context=tcontext,
    ),
}
both = pytest.mark.parametrize('pkg', list(PKGS))
# Socket names stay short (``tag``): an AF_UNIX path holds at most 107
# bytes, and a test's ``tmp_path`` under a pytest worker is already long.


def canon(doc):
    """``doc`` as plain JSON with its wall-clock stamps set equal."""

    def walk(x):
        if isinstance(x, dict):
            return {k: 0.0 if k in ('ts', 'time_unix') else walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [walk(v) for v in x]
        return x

    return walk(json.loads(json.dumps(doc, sort_keys=True, default=str)))


def same_in_both(scenario, pkg):
    """Run ``scenario`` on ``pkg``; for the port, also on the JAX package,
    and hold the two outcomes equal as JSON. Returns ``pkg``'s outcome."""
    out = scenario(PKGS[pkg])
    if pkg == 'torch':
        assert canon(out) == canon(scenario(PKGS['jax']))
    return out


def _draws(seed, n=200):
    rng = random.Random(seed)
    return [rng.lognormvariate(-3, 1) for _ in range(n)]


def _replica_registry(P, seed, n=200):
    reg = P.metrics.MetricRegistry()
    c = reg.counter('serve/requests', unit='requests')
    h = reg.histogram('serve/request_seconds', unit='s')
    g = reg.gauge('serve/queue_depth', unit='requests')
    for i, v in enumerate(_draws(seed, n)):
        c.inc(1, kind='rate')
        h.observe(v, kind='rate', exemplar={'request_id': f'r{seed}-{i}'})
        g.set(i % 7)
    return reg


def _raises(fn):
    """The error type and message ``fn`` raises (None when it returns)."""
    try:
        fn()
    except Exception as e:  # the outcome compared across packages
        return [type(e).__name__, str(e)]
    return None


# -- wire format ------------------------------------------------------------


@both
def test_wire_roundtrip_is_bit_exact_against_snapshot_dict(pkg):
    def scenario(P):
        snap = _replica_registry(P, seed=1).snapshot()
        wire = P.wire.encode_snapshot(snap, replica='replica-0', registry=P.wire.ReplicaRegistry())
        decoded = P.wire.decode_snapshot(json.dumps(wire))
        assert decoded['metrics'] == P.export.snapshot_dict(snap)
        assert decoded['replica'] == 'replica-0'
        assert decoded['wire_version'] == 1
        return decoded

    same_in_both(scenario, pkg)


@both
def test_wire_version_policy_rejects_newer_refuses_garbage(pkg):
    def scenario(P):
        wire = P.wire.encode_snapshot(
            _replica_registry(P, seed=1, n=3).snapshot(), replica='replica-0',
            registry=P.wire.ReplicaRegistry(),
        )
        errors = [
            _raises(lambda: P.wire.decode_snapshot(dict(wire, wire_version=99))),
            _raises(lambda: P.wire.decode_snapshot({'metrics': {}})),
            _raises(lambda: P.wire.decode_snapshot('{torn')),
            _raises(lambda: P.wire.decode_snapshot({'wire_version': 1, 'metrics': {}})),
            _raises(lambda: P.wire.decode_snapshot([1])),
            _raises(lambda: P.wire.decode_snapshot({'wire_version': 1, 'replica': 'r', 'metrics': 1})),
        ]
        for (kind, message), match in zip(errors, (
            'newer than this library', 'wire_version', 'not valid JSON', 'missing',
            'must be a mapping', 'snapshot mapping',
        )):
            assert kind == 'WireError' and match in message
        # an older document of the same shape still decodes
        assert P.wire.decode_snapshot(dict(wire, wire_version=0))['wire_version'] == 0
        return errors

    same_in_both(scenario, pkg)


@both
def test_encode_requires_registered_id_shape(pkg):
    def scenario(P):
        snap = _replica_registry(P, seed=1, n=1).snapshot()
        small = P.wire.ReplicaRegistry(max_replicas=2)
        out = [
            _raises(lambda: P.wire.encode_snapshot(snap, replica='NOT A SLOT', registry=small)),
            _raises(lambda: P.wire.encode_snapshot(snap, replica='r' * 65, registry=small)),
        ]
        for rid in ('replica-0', 'replica-1', 'replica-0'):
            P.wire.encode_snapshot(snap, replica=rid, registry=small)
        out.append(_raises(lambda: P.wire.encode_snapshot(snap, replica='replica-2', registry=small)))
        assert out[0][0] == 'WireError' and 'invalid replica id' in out[0][1]
        assert out[2][0] == 'WireError' and 'registry full' in out[2][1]
        assert small.known() == ('replica-0', 'replica-1') and 'replica-1' in small
        return out

    same_in_both(scenario, pkg)


@both
def test_counters_sum_exactly_and_gauges_carry_replica_labels(pkg):
    def scenario(P):
        rr = P.wire.ReplicaRegistry()
        wires = [
            P.wire.encode_snapshot(
                _replica_registry(P, seed=i, n=50 + i).snapshot(), replica=f'replica-{i}',
                registry=rr, time_unix=1000.0 + i,
            )
            for i in range(3)
        ]
        merged = P.wire.merge_wires(wires, registry=rr)
        assert merged['serve/requests']['series'][0]['total'] == 50 + 51 + 52
        gauge_labels = {
            tuple(sorted(s['labels'].items())) for s in merged['serve/queue_depth']['series']
        }
        assert gauge_labels == {(('replica', f'replica-{i}'),) for i in range(3)}
        # re-merging a merged document does not double-label gauges
        rr.register('fleet')
        remerged = P.wire.merge_wires(
            [{'wire_version': 1, 'replica': 'fleet', 'time_unix': 2000.0, 'metrics': merged}],
            registry=rr,
        )
        assert {
            tuple(sorted(s['labels'].items())) for s in remerged['serve/queue_depth']['series']
        } == gauge_labels
        return [merged, remerged]

    same_in_both(scenario, pkg)


@both
def test_histogram_merge_is_exact_vs_concatenated_stream(pkg):
    def scenario(P):
        rr = P.wire.ReplicaRegistry()
        seeds = (1, 2, 3, 4)
        wires = [
            P.wire.encode_snapshot(
                _replica_registry(P, seed=s).snapshot(), replica=f'replica-{s}', registry=rr,
            )
            for s in seeds
        ]
        merged = P.wire.merge_wires(wires, registry=rr)
        concat = P.metrics.MetricRegistry()
        h = concat.histogram('serve/request_seconds', unit='s')
        for s in seeds:
            for v in _draws(s):
                h.observe(v, kind='rate')
        ref = P.export.snapshot_dict(concat.snapshot())['serve/request_seconds']['series'][0]
        got = merged['serve/request_seconds']['series'][0]
        assert got['count'] == ref['count'] == 800
        assert got['buckets'] == ref['buckets']
        assert got['quantiles'] == ref['quantiles']
        assert got['min'] == ref['min'] and got['max'] == ref['max']
        assert got['total'] == pytest.approx(ref['total'], rel=1e-12)
        return merged

    same_in_both(scenario, pkg)


@both
def test_histogram_merge_overflow_label_and_exemplar_carry(pkg):
    def scenario(P):
        rr = P.wire.ReplicaRegistry()

        def one(rid, ts, exemplar_id, overflow_n):
            reg = P.metrics.MetricRegistry()
            h = reg.histogram('serve/request_seconds', unit='s')
            h.observe(0.5, kind='rate', exemplar={'request_id': exemplar_id})
            h.labels(kind='rate')._exemplar['ts'] = ts
            for _ in range(overflow_n):
                h.labels(overflow='true').observe(123.0)
            return P.wire.encode_snapshot(reg.snapshot(), replica=rid, registry=rr, time_unix=ts)

        merged = P.wire.merge_wires([
            one('replica-0', ts=2000.0, exemplar_id='newest', overflow_n=2),
            one('replica-1', ts=1000.0, exemplar_id='older', overflow_n=3),
        ], registry=rr)
        series = {
            tuple(sorted(s['labels'].items())): s for s in merged['serve/request_seconds']['series']
        }
        assert series[(('overflow', 'true'),)]['count'] == 5
        rate = series[(('kind', 'rate'),)]
        assert rate['exemplar']['request_id'] == 'newest' and rate['exemplar']['ts'] == 2000.0
        return merged

    same_in_both(scenario, pkg)


@both
def test_merge_refuses_kind_unit_and_bucket_conflicts(pkg):
    def scenario(P):
        rr = P.wire.ReplicaRegistry()

        def doc(rid, build):
            reg = P.metrics.MetricRegistry()
            build(reg)
            return P.wire.encode_snapshot(reg.snapshot(), replica=rid, registry=rr)

        wa = doc('replica-0', lambda r: r.counter('area/thing', unit='count').inc(1))
        wb = doc('replica-1', lambda r: r.gauge('area/thing', unit='value').set(1))
        wu = doc('replica-4', lambda r: r.counter('area/thing', unit='items').inc(1))
        wc = doc('replica-2', lambda r: r.histogram('area/lat', unit='s', buckets=(0.1, 1.0)).observe(0.5))
        wd = doc('replica-3', lambda r: r.histogram('area/lat', unit='s', buckets=(0.2, 2.0)).observe(0.5))
        we = doc('replica-5', lambda r: r.histogram('area/lat', unit='s', buckets=(0.1,)).observe(0.5))
        out = [
            _raises(lambda: P.wire.merge_wires([wa, wb], registry=rr)),
            _raises(lambda: P.wire.merge_wires([wa, wu], registry=rr)),
            _raises(lambda: P.wire.merge_wires([wc, wd], registry=rr)),
            _raises(lambda: P.wire.merge_wires([wc, we], registry=rr)),
        ]
        assert 'conflicting instrument' in out[0][1] and 'conflicting instrument' in out[1][1]
        assert 'bucket boundaries differ' in out[2][1] and 'bucket boundaries differ' in out[3][1]
        assert all(kind == 'WireError' for kind, _ in out)
        return out

    same_in_both(scenario, pkg)


@both
def test_compact_snapshots_merge_without_quantiles(pkg):
    def scenario(P):
        rr = P.wire.ReplicaRegistry()
        wires = [
            {
                'wire_version': 1, 'replica': f'replica-{i}', 'time_unix': 1000.0 + i,
                'metrics': P.export.snapshot_dict(
                    _replica_registry(P, seed=i, n=20).snapshot(), buckets=False),
            }
            for i in (0, 1)
        ]
        merged = P.wire.merge_wires(wires, registry=rr)
        series = merged['serve/request_seconds']['series'][0]
        assert series['count'] == 40
        assert 'quantiles' not in series and 'buckets' not in series
        return merged

    same_in_both(scenario, pkg)


@both
def test_typed_snapshot_from_dict_round_trips_consumers(pkg):
    def scenario(P):
        typed = P.wire.typed_snapshot_from_dict(
            P.export.snapshot_dict(_replica_registry(P, seed=5, n=30).snapshot()))
        assert typed.value('serve/requests', kind='rate') == 30
        series = typed.series('serve/request_seconds', kind='rate')
        assert series.count == 30 and series.quantiles is not None
        assert series.buckets[-1][0] == float('inf')
        # the typed snapshot renders back to the same dict
        return P.export.snapshot_dict(typed)

    same_in_both(scenario, pkg)


# -- endpoint ---------------------------------------------------------------


@contextlib.contextmanager
def _endpoint(P, path, replica='endpoint-test', seed=9, n=25, **kwargs):
    reg = _replica_registry(P, seed=seed, n=n)
    telemetry = P.endpoint.Telemetry(replica=replica, registry=reg, **kwargs)
    ep = P.endpoint.serve(telemetry=telemetry, unix_path=str(path))
    try:
        yield ep, reg
    finally:
        ep.close()


@both
def test_endpoint_serves_all_routes_over_unix_socket(pkg, tmp_path):
    def scenario(P):
        with _endpoint(P, tmp_path / f'{P.tag}.sock',
                       health=lambda: {'status': 'ok', 'queue_depth': 3}) as (ep, reg):
            doc = P.endpoint.scrape(ep.address)
            assert doc['replica'] == 'endpoint-test'
            assert doc['metrics'] == P.export.snapshot_dict(reg.snapshot())
            health = P.endpoint.scrape_health(ep.address)
            assert health['status'] == 'ok' and health['replica'] == 'endpoint-test'
            prom = P.endpoint.fetch(ep.address, '/metrics').decode()
            assert 'serve_requests_total{kind="rate"} 25.0' in prom
            tail = P.endpoint.fetch(ep.address, '/tail?n=3').decode()
            lines = [json.loads(line) for line in tail.splitlines() if line.strip()]
            assert len(lines) <= 3
            assert P.endpoint.fetch(ep.address, '/tail?n=0').decode().strip() == ''
            assert os.stat(ep.address).st_mode & 0o777 == 0o600
            return {'doc': doc, 'health': health, 'prom': prom}

    same_in_both(scenario, pkg)


@both
def test_endpoint_unknown_route_and_close_unlink(pkg, tmp_path):
    def scenario(P):
        with _endpoint(P, tmp_path / f'{P.tag}.sock') as (ep, _):
            with pytest.raises(P.endpoint.EndpointError, match='404') as unknown:
                P.endpoint.fetch(ep.address, '/nope')
            path = ep.address
        assert not os.path.exists(path)
        with pytest.raises(P.endpoint.EndpointError, match='cannot reach'):
            P.endpoint.fetch(path, '/snapshot')
        # the 404 body names the routes
        return str(unknown.value).replace(path, '<path>')

    same_in_both(scenario, pkg)


@both
def test_endpoint_tcp_opt_in_loopback(pkg):
    def scenario(P):
        reg = _replica_registry(P, seed=11, n=5)
        with P.endpoint.serve(
            telemetry=P.endpoint.Telemetry(replica='endpoint-tcp', registry=reg),
            tcp=('127.0.0.1', 0),
        ) as ep:
            assert ep.address.startswith('tcp://127.0.0.1:')
            doc = P.endpoint.scrape(ep.address)
            assert doc['replica'] == 'endpoint-tcp'
            # host:port and the (host, port) tuple reach it too
            port = int(ep.address.rsplit(':', 1)[1])
            assert P.endpoint.scrape(('127.0.0.1', port))['replica'] == 'endpoint-tcp'
            assert P.endpoint.parse_address(f'127.0.0.1:{port}') == ('tcp', '127.0.0.1', port)
            return doc

    same_in_both(scenario, pkg)


@both
def test_endpoint_broken_health_is_a_500_not_a_dead_server(pkg, tmp_path):
    def scenario(P):
        def broken():
            raise RuntimeError('health bug')

        with P.endpoint.serve(
            telemetry=P.endpoint.Telemetry(
                replica='endpoint-broken', registry=P.metrics.MetricRegistry(), health=broken),
            unix_path=str(tmp_path / f'{P.tag}b.sock'),
        ) as ep:
            with pytest.raises(P.endpoint.EndpointError, match='500') as err:
                P.endpoint.fetch(ep.address, '/health')
            assert P.endpoint.fetch(ep.address, '/metrics') is not None
            return str(err.value).replace(ep.address, '<path>')

    same_in_both(scenario, pkg)


def test_address_forms_parse_alike():
    forms = ('unix:/a/b.sock', '/a/b.sock', 'b.sock', 'rel/b', 'tcp://host:80', 'host:8080',
             ('127.0.0.1', 9))
    for form in forms:
        assert tendpoint.parse_address(form) == jendpoint.parse_address(form)
    for bad in ('nohost', 'host:port'):
        for P in PKGS.values():
            with pytest.raises(P.endpoint.EndpointError, match='unrecognized'):
                P.endpoint.parse_address(bad)


def test_default_socket_directory_is_the_ports_own():
    """A JAX replica and a port replica on one host never share a socket
    path: only the directory's name differs."""
    port, ref = tendpoint.default_socket_path('replica-0'), jendpoint.default_socket_path('replica-0')
    assert port != ref
    assert os.path.basename(port) == os.path.basename(ref) == 'replica-0.sock'
    assert os.path.basename(os.path.dirname(port)) == f'socceraction-tpu-torch-telemetry-{os.getuid()}'
    assert os.path.dirname(os.path.dirname(port)) == os.path.dirname(os.path.dirname(ref))


# -- fleet aggregation ------------------------------------------------------


def _strip_walls(snapshot, *more):
    """A fleet registry's snapshot without the scrape and merge walls,
    the one clock the aggregator does not take from ``time_fn``, and
    without the instruments named in ``more``."""
    walls = ('fleet/merge_seconds', 'fleet/scrape_seconds', *more)
    return {k: v for k, v in snapshot.items() if k not in walls}


def _slo_replica(P, n_good, n_bad, latency_s=0.01):
    reg = P.metrics.MetricRegistry()
    events = reg.counter('slo/events', unit='requests')
    h = reg.histogram('serve/request_seconds', unit='s')
    for _ in range(n_good):
        events.inc(1, objective='errors', outcome='good')
        h.observe(latency_s, kind='rate')
    for _ in range(n_bad):
        events.inc(1, objective='errors', outcome='bad')
    return reg


def _pass(snap):
    """One aggregation pass as JSON."""
    return {
        'status': snap.status,
        'replicas': [r._asdict() for r in snap.replicas],
        'metrics': snap.metrics,
        'slo': snap.slo,
        'divergence': list(snap.divergence),
    }


@both
def test_aggregator_merges_staleness_slo_and_divergence(pkg):
    def scenario(P):
        clock = [100.0]
        rr = P.wire.ReplicaRegistry()
        fleet_reg = P.metrics.MetricRegistry()
        agg = P.fleet.FleetAggregator(
            stale_after_s=5.0,
            slo=P.slo.SLOConfig.simple(latency_ms=250.0, min_events=10),
            registry=fleet_reg, replica_registry=rr, time_fn=lambda: clock[0],
        )
        regs = {
            'replica-0': _slo_replica(P, 100, 0),
            'replica-1': _slo_replica(P, 100, 0),
            'replica-2': _slo_replica(P, 100, 50, latency_s=0.2),
        }
        for rid, reg in regs.items():
            agg.ingest(P.wire.encode_snapshot(reg.snapshot(), replica=rid, registry=rr))
        snap = agg.aggregate()
        assert snap.status == 'degraded' and snap.stale_replicas == ()
        errors = snap.slo['objectives']['errors']
        assert errors['window_events_slow'] == 350 and errors['breaching'] is True
        shed, reason = agg.should_shed('rate')
        assert shed and reason['objective'] == 'errors'
        assert {r['replica'] for r in snap.divergence if r['sick']} == {'replica-2'}
        p99 = next(r for r in snap.divergence
                   if r['replica'] == 'replica-2' and r['signal'] == 'request_p99_s')
        assert p99['ratio'] >= 3.0
        first = _pass(snap)
        clock[0] += 6.0
        for rid in ('replica-0', 'replica-1'):
            agg.ingest(P.wire.encode_snapshot(regs[rid].snapshot(), replica=rid, registry=rr))
        snap = agg.aggregate()
        assert snap.stale_replicas == ('replica-2',) and snap.status == 'degraded'
        assert snap.typed().value('slo/events', objective='errors', outcome='bad') == 50
        assert agg.replicas == ('replica-0', 'replica-1', 'replica-2')
        fsnap = fleet_reg.snapshot()
        assert fsnap.value('fleet/replicas', state='stale') == 1
        assert fsnap.value('fleet/scrape_age_seconds', replica='replica-2') == 6.0
        assert fsnap.value('fleet/merge_seconds', stat='count') == 2
        return [first, _pass(snap), [shed, reason], _strip_walls(P.export.snapshot_dict(fsnap))]

    same_in_both(scenario, pkg)


@both
def test_aggregator_scrape_failure_is_loud(pkg, tmp_path):
    def scenario(P):
        rr = P.wire.ReplicaRegistry()
        fleet_reg = P.metrics.MetricRegistry()
        with _endpoint(P, tmp_path / f'{P.tag}0.sock', replica='replica-0', seed=3,
                       n=10) as (ep, _):
            agg = P.fleet.FleetAggregator(
                {'replica-0': ep.address, 'replica-1': str(tmp_path / 'gone.sock')},
                stale_after_s=60.0, registry=fleet_reg, replica_registry=rr,
            )
            outcomes = agg.scrape()
            snap = agg.aggregate()
        assert outcomes == {'replica-0': True, 'replica-1': False}
        assert snap.stale_replicas == ('replica-1',) and snap.status == 'degraded'
        state = {r.replica: r for r in snap.replicas}
        assert state['replica-1'].error is not None and not state['replica-1'].reachable
        fsnap = fleet_reg.snapshot()
        assert fsnap.value('fleet/scrapes', replica='replica-0', outcome='ok') == 1
        assert fsnap.value('fleet/scrapes', replica='replica-1', outcome='error') == 1
        assert fsnap.value('fleet/scrape_seconds', stat='count') == 1
        assert fsnap.value('fleet/merge_seconds', stat='count') == 1
        assert agg.last_wire('replica-1') is None
        return {
            'status': snap.status, 'stale': snap.stale_replicas, 'metrics': snap.metrics,
            'error': state['replica-1'].error.replace(str(tmp_path), '<tmp>'),
            # ages on the default clock
            'fleet': _strip_walls(P.export.snapshot_dict(fsnap), 'fleet/scrape_age_seconds'),
        }

    out = same_in_both(scenario, pkg)
    assert 'gone.sock' in out['error']


@both
def test_aggregator_rejects_misidentified_endpoint(pkg, tmp_path):
    def scenario(P):
        rr = P.wire.ReplicaRegistry()
        with P.endpoint.serve(
            telemetry=P.endpoint.Telemetry(replica='replica-9', registry=P.metrics.MetricRegistry()),
            unix_path=str(tmp_path / f'{P.tag}9.sock'),
        ) as ep:
            agg = P.fleet.FleetAggregator(
                {'replica-0': ep.address}, registry=P.metrics.MetricRegistry(), replica_registry=rr,
            )
            rr.register('replica-9')
            outcomes = agg.scrape()
            state = {r.replica: r for r in agg.aggregate().replicas}
            error = state['replica-0'].error.replace(ep.address, '<path>')
        assert outcomes == {'replica-0': False}
        assert 'identifies as' in error
        return error

    same_in_both(scenario, pkg)


# -- the process hop --------------------------------------------------------


@both
def test_request_context_survives_the_wire_hop(pkg):
    P = PKGS[pkg]
    ctx = P.context.new_request_context('rate', deadline_ms=500.0)
    headers = ctx.to_wire()
    assert headers['request_id'] == ctx.request_id
    assert 0.0 < headers['deadline_remaining_ms'] <= 500.0
    back = P.context.RequestContext.from_wire(json.loads(json.dumps(headers)))
    assert back.request_id == ctx.request_id and back.kind == 'rate' and back.hop == 1
    remaining = back.remaining_s()
    assert remaining is not None and 0.0 < remaining <= 0.5
    hop2 = P.context.RequestContext.from_wire(back.to_wire())
    assert hop2.hop == 2 and hop2.parent_span_id is None
    free = P.context.RequestContext.from_wire(P.context.new_request_context('session').to_wire())
    assert free.deadline_t is None and free.kind == 'session'
    with pytest.raises(ValueError, match='request_id'):
        P.context.RequestContext.from_wire({'kind': 'rate'})
    # the headers carry over to the other package's context as they are
    other = PKGS['jax' if pkg == 'torch' else 'torch']
    crossed = other.context.RequestContext.from_wire(back.to_wire())
    assert (crossed.request_id, crossed.kind, crossed.hop) == (ctx.request_id, 'rate', 2)
    assert set(crossed.to_wire()) == set(back.to_wire())


# -- across the packages ----------------------------------------------------


@pytest.mark.parametrize('writer, reader', [('jax', 'torch'), ('torch', 'jax')])
def test_documents_cross_between_packages(writer, reader):
    W, R = PKGS[writer], PKGS[reader]
    doc = W.wire.encode_snapshot(
        _replica_registry(W, seed=7).snapshot(), replica='replica-0', registry=W.wire.ReplicaRegistry(),
    )
    decoded = R.wire.decode_snapshot(json.dumps(doc))
    assert decoded == json.loads(json.dumps(doc))
    # the reader's own encoding of the same registry is the same document
    own = R.wire.encode_snapshot(
        _replica_registry(R, seed=7).snapshot(), replica='replica-0',
        registry=R.wire.ReplicaRegistry(), time_unix=doc['time_unix'],
    )
    assert canon(own) == canon(decoded)
    typed = R.wire.typed_snapshot_from_dict(decoded['metrics'])
    assert typed.value('serve/requests', kind='rate') == 200
    # a newer document is refused by either reader
    with pytest.raises(R.wire.WireError, match='newer than this library'):
        R.wire.decode_snapshot(dict(doc, wire_version=R.wire.WIRE_VERSION + 1))


def test_documents_render_the_same_text():
    """Field for field and in the same order: the port's document of a
    registry is the JAX package's as JSON text, wall-clock stamps aside."""

    def zero_stamps(x):
        if isinstance(x, dict):
            return {k: 0.0 if k == 'ts' else zero_stamps(v) for k, v in x.items()}
        if isinstance(x, list):
            return [zero_stamps(v) for v in x]
        return x

    texts = {
        name: json.dumps(zero_stamps(P.wire.encode_snapshot(
            _replica_registry(P, seed=8, n=64).snapshot(), replica='replica-0',
            registry=P.wire.ReplicaRegistry(), time_unix=1000.0,
        )))
        for name, P in PKGS.items()
    }
    assert texts['torch'] == texts['jax']


def test_four_documents_of_both_packages_merge_alike():
    """Two JAX and two port documents merge to the same JSON in each
    package, and to what four documents of one package merge to."""
    def docs(owners):
        out = []
        for i, owner in enumerate(owners):
            P = PKGS[owner]
            out.append(P.wire.encode_snapshot(
                _replica_registry(P, seed=30 + i, n=40 + i).snapshot(), replica=f'replica-{i}',
                registry=P.wire.ReplicaRegistry(), time_unix=1000.0 + i,
            ))
        return out

    mixed = docs(('jax', 'torch', 'jax', 'torch'))
    merged = {name: P.wire.merge_wires(mixed, registry=P.wire.ReplicaRegistry())
              for name, P in PKGS.items()}
    assert canon(merged['torch']) == canon(merged['jax'])
    pure = jwire.merge_wires(docs(('jax',) * 4), registry=jwire.ReplicaRegistry())
    assert canon(merged['torch']) == canon(pure)
    assert merged['torch']['serve/requests']['series'][0]['total'] == 40 + 41 + 42 + 43


@pytest.mark.parametrize('aggregator', list(PKGS))
def test_aggregator_scrapes_the_other_packages_endpoint(aggregator, tmp_path):
    """A fleet of one JAX and one port endpoint, scraped by each package's
    aggregator, merges as a fleet of two JAX endpoints does."""
    def scraped(owners):
        with contextlib.ExitStack() as stack:
            roster = {}
            for i, owner in enumerate(owners):
                ep, _ = stack.enter_context(_endpoint(
                    PKGS[owner], tmp_path / f'{PKGS[aggregator].tag}{PKGS[owner].tag}{i}.sock', replica=f'replica-{i}',
                    seed=40 + i, n=20 + i,
                ))
                roster[f'replica-{i}'] = ep.address
            A = PKGS[aggregator]
            agg = A.fleet.FleetAggregator(
                roster, registry=A.metrics.MetricRegistry(), replica_registry=A.wire.ReplicaRegistry(),
                slo=A.slo.SLOConfig.simple(latency_ms=250.0),
            )
            assert agg.scrape() == {rid: True for rid in roster}
            snap = agg.aggregate()
        assert snap.status == 'ok' and snap.stale_replicas == ()
        return snap

    def without_last(metrics):
        # 'last' comes from the newest document, and the scrapes run in parallel
        return {name: [{k: v for k, v in s.items() if k != 'last'} for s in inst['series']]
                for name, inst in canon(metrics).items()}

    mixed = scraped(('jax', 'torch'))
    pure = scraped(('jax', 'jax'))
    assert without_last(mixed.metrics) == without_last(pure.metrics)
    assert canon(mixed.divergence) == canon(pure.divergence)
    assert mixed.typed().value('serve/requests', kind='rate') == 20 + 21


# -- import contract ----------------------------------------------------------


_BLOCKED_PLANE = '''
import builtins, sys
real = builtins.__import__
def blocker(name, *a, **k):
    if name.split('.')[0] in ('jax', 'jaxlib', 'torch', 'socceraction_tpu'):
        raise ImportError(f'{name} is blocked in this process')
    return real(name, *a, **k)
builtins.__import__ = blocker
import os, tempfile
from socceraction_tpu_torch.obs.metrics import MetricRegistry
from socceraction_tpu_torch.obs.wire import ReplicaRegistry, encode_snapshot, merge_wires
from socceraction_tpu_torch.obs.endpoint import Telemetry, scrape, serve
from socceraction_tpu_torch.obs.fleet import FleetAggregator
reg = MetricRegistry()
reg.counter('serve/requests', unit='requests').inc(3, kind='rate')
sock = os.path.join(tempfile.mkdtemp(), 'r.sock')
ep = serve(telemetry=Telemetry(replica='replica-0', registry=reg), unix_path=sock)
agg = FleetAggregator({'replica-0': sock}, registry=MetricRegistry())
assert agg.scrape() == {'replica-0': True}
assert agg.aggregate().typed().value('serve/requests', kind='rate') == 3
ep.close()
leaked = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'torch', 'socceraction_tpu'))
assert not leaked, leaked
print('plane ok')
'''


def test_wire_endpoint_fleet_need_neither_jax_nor_torch():
    """The three modules import and run (encode, serve, scrape, merge,
    aggregate) in a process where jax, torch and the JAX package cannot
    be imported: a fleet's front end is such a process."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, '-c', _BLOCKED_PLANE], capture_output=True, text=True,
                          env=env, timeout=60, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert 'plane ok' in proc.stdout


_LAZY_PLANE = '''
import sys
import socceraction_tpu_torch.obs as obs
plane = ('socceraction_tpu_torch.obs.wire', 'socceraction_tpu_torch.obs.endpoint',
         'socceraction_tpu_torch.obs.fleet', 'http.server')
assert not [m for m in plane if m in sys.modules], [m for m in plane if m in sys.modules]
assert obs.FleetAggregator.__module__ == 'socceraction_tpu_torch.obs.fleet'
assert obs.serve_telemetry is obs.endpoint.serve
assert obs.REPLICAS is obs.wire.REPLICAS
print(' '.join(sorted(n for n in obs.__all__ if n in obs._LAZY_HOME)))
'''


def test_the_plane_loads_lazily_with_the_jax_packages_names():
    """``import socceraction_tpu_torch.obs`` starts no HTTP machinery; the
    plane's names load on first use and are the JAX package's lazy ones."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, '-c', _LAZY_PLANE], capture_output=True, text=True,
                          env=env, timeout=60, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    import socceraction_tpu.obs as jobs

    want = {n for m in ('wire', 'endpoint', 'fleet') for n in jobs._HOMES[m]}
    assert set(proc.stdout.split()) == want


def test_plane_modules_match_the_jax_names():
    for port, ref in ((twire, jwire), (tendpoint, jendpoint), (tfleet, jfleet)):
        assert port.__all__ == ref.__all__
    assert twire.WIRE_VERSION == jwire.WIRE_VERSION == 1
    assert tfleet.DIVERGENCE_SIGNALS == jfleet.DIVERGENCE_SIGNALS
    assert tmetrics.DEFAULT_BUCKETS == jmetrics.DEFAULT_BUCKETS
    assert tmetrics._QUANTILES == jmetrics._QUANTILES


# -- obsctl reads the port's run logs -----------------------------------------


def _obsctl(argv):
    spec = importlib.util.spec_from_file_location('obsctl', os.path.join(ROOT, 'tools', 'obsctl.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mod.main(argv)
    return rc, out.getvalue()


@pytest.fixture(scope='module')
def port_logs(tmp_path_factory):
    """A front run log and two replica run logs written by the port: the
    front mints a request and ships ``to_wire()``; replica 0 rebuilds it
    with ``from_wire`` and its ``RatingService`` rates it on the CPU (a
    one-game request from the smoke's ``game_request``, entering where
    ``rate`` arrives once it has packed its frame, as phase 15's replicas
    do); each replica log embeds a registry of its own requests."""
    import chip_smoke
    from socceraction_tpu_torch.core.synthetic import synthetic_batch
    from socceraction_tpu_torch.serve import RatingService
    from socceraction_tpu_torch.serve import service as serve_service

    tmp = tmp_path_factory.mktemp('port-logs')
    paths = {name: str(tmp / name / 'obs.jsonl') for name in ('front', 'replica-0', 'replica-1')}
    with ttrace.RunLog(paths['front'], registry=tmetrics.MetricRegistry()):
        ctx = tcontext.new_request_context('rate')
        tcontext.record_request_enqueue(ctx, queue_depth=0)
        headers = json.loads(json.dumps(ctx.to_wire()))
        t0 = time.perf_counter()
    model = chip_smoke.make_model('cpu', (8,))
    req = chip_smoke.game_request(synthetic_batch(1, 128, seed=4, device='cpu'), 0)
    with ttrace.RunLog(paths['replica-0'], registry=_replica_registry(PKGS['torch'], seed=21, n=4)):
        back = tcontext.RequestContext.from_wire(headers)
        with RatingService(model, max_actions=128, max_batch_size=1) as svc:
            payload = serve_service._Payload(req.staging, req.gs, keep=(0, req.n), ctx=back)
            svc._submit(payload, 'rate', back).result(timeout=60)
    with ttrace.RunLog(paths['front'], registry=tmetrics.MetricRegistry()):
        tcontext.record_request_done(ctx, 'ok', time.perf_counter() - t0)
    with ttrace.RunLog(paths['replica-1'], registry=_replica_registry(PKGS['torch'], seed=22, n=6)):
        pass
    return ctx.request_id, paths


def test_obsctl_trace_stitches_the_ports_run_logs(port_logs):
    rid, paths = port_logs
    rc, out = _obsctl(['trace', rid, paths['front'], paths['replica-0'], '--json'])
    assert rc == 0
    trace = json.loads(out)
    assert trace['request_id'] == rid
    hops = trace['hops']
    assert [h['hop'] for h in hops] == [0, 1]
    assert hops[0]['runlog'] == paths['front'] and hops[1]['runlog'] == paths['replica-0']
    assert hops[0]['enqueue'] is not None and hops[1]['flush'] is not None
    assert set(trace['segments']) == {'queue_wait', 'pad', 'dispatch', 'slice'}
    assert trace['status'] == 'ok' and trace['bucket'] == 1 and trace['coalesced'] == 1
    rc, human = _obsctl(['trace', rid, paths['front'], paths['replica-0']])
    assert rc == 0 and 'hop 0' in human and 'hop 1' in human and 'dispatch' in human
    rc, _ = _obsctl(['trace', 'nope', paths['front'], paths['replica-0'], '--json'])
    assert rc == 1


def test_obsctl_tail_merges_the_ports_run_logs(port_logs):
    _, paths = port_logs
    rc, out = _obsctl(['tail', paths['front'], paths['replica-0'], '--json', '-n', '500'])
    assert rc == 0
    events = [json.loads(line) for line in out.splitlines() if line.strip()]
    assert events and all('_runlog' in e for e in events)
    assert [e['ts'] for e in events] == sorted(e['ts'] for e in events)
    rc, out = _obsctl(['tail', paths['replica-0'], '--json', '-n', '500'])
    assert rc == 0
    assert all('_runlog' not in json.loads(line) for line in out.splitlines() if line.strip())


def test_obsctl_fleet_post_mortem_over_the_ports_run_logs(port_logs):
    _, paths = port_logs
    rc, out = _obsctl(['fleet', paths['replica-0'], paths['replica-1'], '--json'])
    assert rc == 0
    summary = json.loads(out)
    assert {r['replica'] for r in summary['replicas']} == {'replica-0', 'replica-1'}
    total = sum(s['total'] for s in summary['metrics']['serve/requests']['series']
                if s['labels'].get('kind') == 'rate')
    assert total == 4 + 6
    rc, human = _obsctl(['fleet', paths['replica-0'], paths['replica-1']])
    assert rc == 0 and 'replica-0' in human and 'serve/requests' in human
