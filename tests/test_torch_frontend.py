"""The port's serving frontend against the JAX package's, on the CPU.

Counterparts of ``tests/test_mesh_serve.py``'s frontend cases, run against
the port's ``ServingFrontend`` over a two-lane ``RatingService``, and the
wire across the packages in both directions: the JAX package's
``FrontendClient`` against the port's server and the port's client
against the JAX package's server, with columns and index equal and values
within 1e-5 (the same weights, f32 sums in another order). The status
mapping is the JAX package's, with one difference held here: a kernel
that refuses its operands (``KernelRefused``, also a ``ValueError``) maps
to 500, not to 400.
"""

import contextlib
import io
import json
import os
import stat

import numpy as np
import pytest

from socceraction_tpu.serve.frontend import FrontendClient as JaxClient
from socceraction_tpu.serve.frontend import FrontendError as JaxFrontendError
from socceraction_tpu.serve.frontend import ServingFrontend as JaxFrontend
from socceraction_tpu.scenario.grid import end_location_grid as jax_end_location_grid
from socceraction_tpu_torch.obs import REGISTRY, drain_guards
from socceraction_tpu_torch.obs import trace as obs_trace
from socceraction_tpu_torch.ops import fused as fused_ops
from socceraction_tpu_torch.ops.cuda_build import KernelError, KernelRefused
from socceraction_tpu_torch.scenario.grid import end_location_grid
from socceraction_tpu_torch.serve import Overloaded, RatingService, SLOShed
from socceraction_tpu_torch.serve.frontend import (
    FrontendClient,
    FrontendError,
    ServingFrontend,
    default_frontend_path,
)
from tests.test_torch_serve import ATOL, HOME, PKGS, WAIT, _both_models, _fit, _frame

A = 512


@pytest.fixture(scope='module', autouse=True)
def _drain_guards():
    yield
    drain_guards()


@pytest.fixture(scope='module')
def models(tmp_path_factory):
    return _both_models(_fit(3, (16,)), str(tmp_path_factory.mktemp('frontend-v1')))


@pytest.fixture
def frontend(models, tmp_path):
    sock = str(tmp_path / 'frontend.sock')
    with RatingService(models['port'], max_actions=A, max_batch_size=4, max_wait_ms=1.0,
                       n_replicas=2) as svc:
        with ServingFrontend(svc, unix_path=sock):
            yield svc, FrontendClient(sock), sock
    assert not os.path.exists(sock), 'socket not unlinked on close'


@pytest.fixture
def jax_frontend(models, tmp_path):
    sock = str(tmp_path / 'jax-frontend.sock')
    with PKGS['jax'].Service(models['jax'], max_actions=A, max_batch_size=4,
                             max_wait_ms=1.0) as svc:
        with JaxFrontend(svc, unix_path=sock):
            yield svc, sock


# -- the JAX package's frontend cases, against the port ------------------------------------


def test_frontend_rate_round_trip_is_bitwise(frontend):
    svc, client, _sock = frontend
    frame = _frame(70, 150)
    ref = svc.rate_sync(frame, home_team_id=HOME, timeout=WAIT)
    out = client.rate(frame, home_team_id=HOME)
    assert list(out.columns) == list(ref.columns)
    assert (out.index == ref.index).all()
    np.testing.assert_array_equal(out.to_numpy(), ref.to_numpy())
    assert client.last_request_id
    health = client.health()
    assert health['status'] == 'ok' and health['replicas']['n'] == 2


def test_frontend_health_is_the_services(frontend):
    """``GET /health`` is ``health()`` through JSON (the clock readings
    aside)."""
    svc, client, _sock = frontend
    got, want = client.health(), json.loads(json.dumps(svc.health(), default=str))
    for block in (got, want):
        block.pop('uptime_s')
        block.pop('last_flush_age_s')
    assert got == want


def test_frontend_deadline_propagates_to_the_flush(frontend):
    _svc, client, _sock = frontend
    frame = _frame(71, 100)
    with pytest.raises(FrontendError) as err:
        client.rate(frame, home_team_id=HOME, deadline_ms=0.001)
    assert err.value.status in (504, 429)
    out = client.rate(frame, home_team_id=HOME, deadline_ms=60_000)
    assert len(out) == len(frame)


def test_frontend_sessions_round_trip(frontend):
    svc, client, _sock = frontend
    frame = _frame(72, 120)
    half = len(frame) // 2
    sid = client.open_session('m1', home_team_id=HOME)
    v1 = client.session_add(sid, frame.iloc[:half])
    v2 = client.session_add(sid, frame.iloc[half:])
    ref = svc.open_session('m2', home_team_id=HOME)
    np.testing.assert_array_equal(v1.to_numpy(), ref.add_actions(frame.iloc[:half]).to_numpy())
    np.testing.assert_array_equal(v2.to_numpy(), ref.add_actions(frame.iloc[half:]).to_numpy())
    client.session_close(sid)
    with pytest.raises(FrontendError) as err:
        client.session_add(sid, frame.iloc[:4])
    assert err.value.status == 400


def test_frontend_scenarios_round_trip(frontend):
    svc, client, _sock = frontend
    frame = _frame(73, 130)
    grid = end_location_grid(3, 2)
    ref = svc.rate_scenarios_sync(frame, grid, home_team_id=HOME, timeout=WAIT)
    out = client.rate_scenarios(frame, grid, home_team_id=HOME)
    assert out.shape == ref.shape == (6, len(frame), 3)
    np.testing.assert_array_equal(out, ref.astype(np.float64))


def test_frontend_error_mapping(frontend):
    _svc, client, _sock = frontend
    with pytest.raises(FrontendError) as err:
        client._call('POST', '/rate', {'actions': {'columns': {}}})
    assert err.value.status == 400 and not err.value.retriable
    with pytest.raises(FrontendError) as err:
        client._call('POST', '/nope', {})
    assert err.value.status == 404
    with pytest.raises(FrontendError) as err:
        client._call('GET', '/nope')
    assert err.value.status == 404 and 'GET /health' in err.value.payload['routes']


# -- the status mapping ---------------------------------------------------------------------


def _raising(error):
    def rate(*args, **kwargs):
        raise error

    return rate


def _status(call):
    try:
        call()
    except (FrontendError, JaxFrontendError) as e:
        return e.status, sorted(e.payload), e.retriable, e.payload.get('error')
    return 200, [], False, None


SHED = {'objective': 'latency', 'burn_rate_fast': 10.0, 'burn_rate_slow': 10.0,
        'threshold': 1.0, 'budget_remaining': 0.0}


@pytest.mark.parametrize('error', [
    Overloaded('queue full'), SLOShed(SHED), ValueError('bad frame'), RuntimeError('boom'),
], ids=['overloaded', 'slo_shed', 'value_error', 'runtime_error'])
def test_status_mapping_matches_the_jax_frontend(frontend, jax_frontend, monkeypatch, error):
    """Overload and SLO sheds map to 429 (retriable, counted by reason), a
    malformed request to 400, anything else to 500, as the JAX frontend
    maps them."""
    from socceraction_tpu.serve import SLOShed as JaxSLOShed

    svc, client, _sock = frontend
    jsvc, jsock = jax_frontend
    frame = _frame(74, 60)
    jerror = {SLOShed: JaxSLOShed(SHED), Overloaded: PKGS['jax'].Overloaded('queue full')}.get(
        type(error), error)
    monkeypatch.setattr(svc, 'rate', _raising(error))
    monkeypatch.setattr(jsvc, 'rate', _raising(jerror))
    shed_before = {r: REGISTRY.snapshot().value('serve/frontend_shed', reason=r)
                   for r in ('slo', 'overload')}
    port = _status(lambda: client.rate(frame, home_team_id=HOME))
    jax = _status(lambda: JaxClient(jsock).rate(frame, home_team_id=HOME))
    assert port == jax
    reason = {SLOShed: 'slo', Overloaded: 'overload'}.get(type(error))
    for r, n in shed_before.items():
        want = n + (1 if r == reason else 0)
        assert REGISTRY.snapshot().value('serve/frontend_shed', reason=r) == want
    if reason is not None:
        assert port[0] == 429 and port[2] is True


@pytest.mark.parametrize('error', [
    KernelRefused('a launch for D = 400 dense columns needs 300000 bytes of shared memory'),
    KernelError('gather_matmul kernel launch failed: cudaError_t 700'),
], ids=['KernelRefused', 'KernelError'])
def test_a_kernel_that_cannot_run_maps_to_500_not_400(frontend, monkeypatch, error):
    """``KernelRefused`` is a ``ValueError`` too; copied as is, the JAX
    mapping would send it to 400, as if the request were malformed. A
    kernel that cannot run is the server's fault: 500, with its text, not
    retriable."""
    _svc, client, _sock = frontend

    def b1(*args, **kwargs):
        raise error

    monkeypatch.setattr(fused_ops, 'fused_first_layer_quant', b1)
    status, _keys, retriable, text = _status(lambda: client.rate(_frame(75, 80),
                                                                 home_team_id=HOME))
    assert (status, retriable) == (500, False)
    assert text.startswith(type(error).__name__) and str(error) in text


# -- the wire across the packages -----------------------------------------------------------


def test_jax_client_against_the_port_frontend(frontend, jax_frontend):
    """The JAX package's client against the port's server, against the
    same request through the JAX package's own frontend."""
    _svc, _client, sock = frontend
    _jsvc, jsock = jax_frontend
    frame = _frame(76, 140)
    got = JaxClient(sock).rate(frame, home_team_id=HOME)
    want = JaxClient(jsock).rate(frame, home_team_id=HOME)
    assert list(got.columns) == list(want.columns)
    assert got.index.equals(want.index)
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=0, atol=ATOL)
    grid = jax_end_location_grid(3, 2)
    np.testing.assert_allclose(JaxClient(sock).rate_scenarios(frame, grid, home_team_id=HOME),
                               JaxClient(jsock).rate_scenarios(frame, grid, home_team_id=HOME),
                               rtol=0, atol=ATOL)
    assert set(JaxClient(sock).health()) >= set(JaxClient(jsock).health())


def test_port_client_against_the_jax_frontend(frontend, jax_frontend):
    """The port's client against the JAX package's server, against the
    same request through the port's own frontend; sessions too."""
    _svc, client, _sock = frontend
    _jsvc, jsock = jax_frontend
    jclient = FrontendClient(jsock)
    frame = _frame(77, 160)
    got = jclient.rate(frame, home_team_id=HOME)
    want = client.rate(frame, home_team_id=HOME)
    assert list(got.columns) == list(want.columns)
    assert got.index.equals(want.index)
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=0, atol=ATOL)
    grid = end_location_grid(3, 2)
    np.testing.assert_allclose(jclient.rate_scenarios(frame, grid, home_team_id=HOME),
                               client.rate_scenarios(frame, grid, home_team_id=HOME),
                               rtol=0, atol=ATOL)
    sid = jclient.open_session('m', home_team_id=HOME)
    np.testing.assert_allclose(jclient.session_add(sid, frame.iloc[:50]).to_numpy(),
                               want.to_numpy()[:50], rtol=0, atol=ATOL)
    jclient.session_close(sid)


# -- posture and tracing --------------------------------------------------------------------


def test_socket_posture(models, tmp_path):
    """The socket's directory is 0700 and the socket file 0600: the
    filesystem's permissions are the access control."""
    sock = str(tmp_path / 'private' / 'fe.sock')
    with RatingService(models['port'], max_actions=A, max_batch_size=2) as svc:
        with ServingFrontend(svc, unix_path=sock) as fe:
            assert fe.address == sock
            assert stat.S_IMODE(os.stat(os.path.dirname(sock)).st_mode) == 0o700
            assert stat.S_IMODE(os.stat(sock).st_mode) == 0o600
            assert stat.S_ISSOCK(os.stat(sock).st_mode)


def test_default_frontend_path_is_per_user_and_process():
    path = default_frontend_path()
    assert os.path.basename(path) == f'frontend-{os.getpid()}.sock'
    assert os.path.basename(os.path.dirname(path)) == \
        f'socceraction-tpu-torch-serving-{os.getuid()}'


def test_frontend_trace_stitches_client_hop_to_lane_flush(models, tmp_path):
    """The request id survives the hop: the client's enqueue and done
    (hop 0) and the service's (hop 1, with its flush segments) land on one
    request id, and the JAX package's ``obsctl trace`` stitches the two
    processes' logs."""
    sock = str(tmp_path / 'fe.sock')
    log = obs_trace.RunLog(str(tmp_path / 'combined.jsonl'))
    with log:
        with RatingService(models['port'], max_actions=A, max_batch_size=4, max_wait_ms=1.0,
                           n_replicas=2) as svc:
            with ServingFrontend(svc, unix_path=sock):
                client = FrontendClient(sock)
                client.rate(_frame(78, 120), home_team_id=HOME)
                rid = client.last_request_id
    with open(log.path, encoding='utf-8') as fh:
        events = [json.loads(line) for line in fh if line.strip()]
    by_hop = {}
    for e in events:
        if e.get('request_id') == rid and e['event'] in ('request_enqueue', 'request_done'):
            by_hop.setdefault(int(e.get('hop') or 0), []).append(e)
    assert set(by_hop) == {0, 1}
    for hop_events in by_hop.values():
        assert {e['event'] for e in hop_events} == {'request_enqueue', 'request_done'}
    done = next(e for e in by_hop[1] if e['event'] == 'request_done')
    assert done['status'] == 'ok'
    assert {'queue_wait', 'pad', 'dispatch', 'slice'} <= set(done['segments'])

    run_start = [e for e in events if e.get('event') == 'run_start']
    logs = []
    for hop in (0, 1):
        path = tmp_path / f'hop{hop}' / 'obs.jsonl'
        path.parent.mkdir()
        path.write_text(''.join(json.dumps(e) + '\n' for e in run_start + by_hop[hop]))
        logs.append(str(path))
    from tools.obsctl import main as obsctl_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert obsctl_main(['trace', rid, *logs, '--json']) == 0
    trace = json.loads(out.getvalue())
    assert trace['request_id'] == rid and [h['hop'] for h in trace['hops']] == [0, 1]
    assert trace['status'] == 'ok'
