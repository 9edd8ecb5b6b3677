"""The serving front door: a stdlib RPC server over one RatingService.

Port of the JAX package's ``socceraction_tpu/serve/frontend.py``; the
routes, the JSON wire and the status mapping are the JAX package's, so
either package's client talks to either package's server.

N client *processes* talk to one serving process (its replica lanes on
one card or several). The
:class:`RatingService` is in-process only — its ``rate()`` returns a
``Future``, which cannot cross a process boundary — so this module puts
the same front door on a unix socket:

- :class:`ServingFrontend` — a ``ThreadingHTTPServer`` over AF_UNIX with
  the exact posture of the telemetry endpoint
  (:mod:`socceraction_tpu_torch.obs.endpoint`): socket directory ``0700``,
  socket file ``0600``, filesystem permissions ARE the access control;
  one daemon thread per in-flight request, host-side work only on those
  threads (packing happens in :meth:`RatingService.rate` on the handler
  thread; the device dispatch stays on the service's flush lanes).
- :class:`FrontendClient` — the client half: mints a
  :class:`~socceraction_tpu_torch.obs.context.RequestContext` per call and
  ships ``ctx.to_wire()`` with the request, so the ``request_id`` (and
  the remaining deadline budget) survive the hop and ``obsctl trace
  <id> client.jsonl server.jsonl`` stitches client → front end →
  replica flush into one timeline.

Admission control and SLO shedding run BEFORE the device ever sees a
request, exactly as in-process: the service's queue bound raises
``Overloaded`` and burn-rate shedding raises ``SLOShed``, both mapped to
``429`` with a machine-readable body (``retriable`` + the shed reason),
so a client process can back off the same way an in-process caller
does. A request whose shipped deadline expires while queued maps to
``504``; malformed requests to ``400``; anything else to ``500`` with
the exception text — a kernel that cannot run
(:class:`~socceraction_tpu_torch.ops.cuda_build.KernelError`, whose
``KernelRefused`` is also a ``ValueError``) included: the card, not the
request, is at fault. Sessions get the same treatment: ``/session/open``
returns a server-side session id, ``/session/add`` rates the next slice
through the session's O(new actions) window path, ``/session/close``
drops it.

Values come back as plain JSON (columns + rows + index). The wire
format is deliberately boring — a dict of SPADL columns — because the
clients this exists for (the bench's fan-out driver, a live ingestion
sidecar) already hold exactly that. pandas is imported inside the
functions that take or return frames, so this module imports without it.
"""

from __future__ import annotations

import http.client
import http.server
import json
import os
import socket
import socketserver
import stat
import tempfile
import threading
import uuid
from typing import Any, Dict, Optional, Tuple
from urllib.parse import urlsplit

from typing import TYPE_CHECKING

import numpy as np

from ..obs import counter
from ..obs.context import DeadlineExceeded, RequestContext, new_request_context
from ..ops.cuda_build import KernelError
from .batcher import Overloaded
from .service import RATING_COLUMNS, SLOShed

if TYPE_CHECKING:  # pandas is imported inside the functions that take frames
    import pandas as pd

__all__ = ['FrontendClient', 'FrontendError', 'ServingFrontend', 'default_frontend_path']


class FrontendError(RuntimeError):
    """A front-end request failed; carries the HTTP status and payload."""

    def __init__(self, status: int, payload: Dict[str, Any]) -> None:
        self.status = int(status)
        self.payload = dict(payload)
        super().__init__(f'frontend returned {status}: {payload.get("error")}')

    @property
    def retriable(self) -> bool:
        """Whether backing off and retrying can help (shed/overload)."""
        return bool(self.payload.get('retriable'))


def default_frontend_path() -> str:
    """The default unix-socket path for this process's serving front end.

    Same layout policy as the telemetry endpoint's socket: a per-user
    ``0700`` directory under the tempdir. One file per process —
    serving traffic and telemetry scrapes stay on separate sockets.
    """
    base = os.path.join(
        tempfile.gettempdir(), f'socceraction-tpu-torch-serving-{os.getuid()}'
    )
    return os.path.join(base, f'frontend-{os.getpid()}.sock')


# -- wire forms -------------------------------------------------------------


def _frame_to_wire(frame: 'pd.DataFrame') -> Dict[str, Any]:
    """One SPADL slice as JSON-able columns (+ index for re-alignment)."""
    return {
        'columns': {
            c: np.asarray(frame[c]).tolist() for c in frame.columns
        },
        'index': np.asarray(frame.index).tolist(),
    }


def _frame_from_wire(doc: Dict[str, Any]) -> 'pd.DataFrame':
    import pandas as pd

    cols = doc.get('columns')
    if not isinstance(cols, dict) or not cols:
        raise ValueError('actions must carry non-empty {column: [values]}')
    frame = pd.DataFrame(cols)
    index = doc.get('index')
    if index is not None:
        frame.index = pd.Index(index)
    return frame


def _values_to_wire(values: 'pd.DataFrame') -> Dict[str, Any]:
    return {
        'columns': list(values.columns),
        'index': np.asarray(values.index).tolist(),
        'values': np.asarray(values, dtype=np.float64).tolist(),
    }


def _values_from_wire(doc: Dict[str, Any]) -> 'pd.DataFrame':
    import pandas as pd

    return pd.DataFrame(
        doc['values'], columns=doc['columns'], index=pd.Index(doc['index'])
    )


# -- the server -------------------------------------------------------------


class _UnixServer(socketserver.ThreadingMixIn, http.server.HTTPServer):
    """AF_UNIX ThreadingHTTPServer with the telemetry endpoint's posture."""

    daemon_threads = True
    address_family = socket.AF_UNIX
    request_queue_size = 128

    def server_bind(self) -> None:
        # permissions before accept, same rationale as obs.endpoint: the
        # file is chmod'd 0600 between bind and listen inside a 0700
        # directory, so the pre-chmod window is already access-controlled
        socketserver.TCPServer.server_bind(self)
        os.chmod(self.server_address, stat.S_IRUSR | stat.S_IWUSR)
        self.server_name = 'unix'
        self.server_port = 0

    def get_request(self) -> Tuple[Any, Any]:
        request, _ = self.socket.accept()
        return request, ('unix-peer', 0)


class _Handler(http.server.BaseHTTPRequestHandler):
    server_version = 'socceraction-tpu-torch-serving'
    protocol_version = 'HTTP/1.1'

    def do_GET(self) -> None:  # noqa: N802 (http.server contract)
        frontend: 'ServingFrontend' = self.server.frontend  # type: ignore[attr-defined]
        path = urlsplit(self.path).path
        if path == '/health':
            try:
                body = frontend.service.health()
            except Exception as e:
                self._send(500, {'error': f'{type(e).__name__}: {e}'})
                return
            self._send(200, body)
        else:
            self._send(404, {
                'error': f'unknown route GET {path!r}',
                'routes': [
                    'GET /health', 'POST /rate', 'POST /scenarios',
                    'POST /session/*',
                ],
            })

    def do_POST(self) -> None:  # noqa: N802 (http.server contract)
        frontend: 'ServingFrontend' = self.server.frontend  # type: ignore[attr-defined]
        path = urlsplit(self.path).path
        try:
            n = int(self.headers.get('Content-Length') or 0)
            doc = json.loads(self.rfile.read(n) or b'{}')
        except (ValueError, OSError) as e:
            self._send(400, {'error': f'bad request body: {e}'})
            return
        try:
            if path == '/rate':
                self._send(200, frontend.handle_rate(doc))
            elif path == '/scenarios':
                self._send(200, frontend.handle_scenarios(doc))
            elif path == '/session/open':
                self._send(200, frontend.handle_session_open(doc))
            elif path == '/session/add':
                self._send(200, frontend.handle_session_add(doc))
            elif path == '/session/close':
                self._send(200, frontend.handle_session_close(doc))
            else:
                self._send(404, {'error': f'unknown route POST {path!r}'})
        except SLOShed as e:
            counter('serve/frontend_shed', unit='requests').inc(
                1, reason='slo'
            )
            self._send(429, {
                'error': 'slo_shed', 'retriable': True, 'reason': e.reason,
            })
        except Overloaded as e:
            counter('serve/frontend_shed', unit='requests').inc(
                1, reason='overload'
            )
            self._send(429, {
                'error': 'overloaded', 'retriable': True, 'detail': str(e),
            })
        except DeadlineExceeded as e:
            self._send(504, {'error': 'deadline_exceeded', 'detail': str(e)})
        except KernelError as e:
            # before the ValueError branch: a kernel that refused its
            # operands (KernelRefused) must not read as a malformed request
            self._send(500, {'error': f'{type(e).__name__}: {e}'})
        except (KeyError, ValueError, TypeError) as e:
            self._send(400, {'error': f'{type(e).__name__}: {e}'})
        except Exception as e:  # a broken request must not kill the server
            self._send(500, {'error': f'{type(e).__name__}: {e}'})

    def _send(self, status: int, payload: Dict[str, Any]) -> None:
        body = json.dumps(payload, sort_keys=True, default=str).encode('utf-8')
        self.send_response(status)
        self.send_header('Content-Type', 'application/json')
        self.send_header('Content-Length', str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def address_string(self) -> str:  # AF_UNIX peers have no host:port
        addr = self.client_address
        return addr[0] if isinstance(addr, tuple) and addr else 'unix-peer'

    def log_message(self, format: str, *args: Any) -> None:
        pass  # request accounting lives in serve/* metrics, not stderr


class ServingFrontend:
    """The running front door over one :class:`RatingService`.

    Parameters
    ----------
    service : RatingService
        The service (one lane or several) all client processes
        share. Admission control, SLO shedding, coalescing, replica
        fan-out and breakers all stay the service's — the front end
        only moves requests across the process boundary.
    unix_path : str, optional
        Socket path (default :func:`default_frontend_path`).
    result_timeout_s : float
        Hard ceiling on one request's wait for its flush (deadline-less
        requests only; a shipped deadline bounds itself). A lane outage
        must surface as an error, not a wedged client connection.
    """

    def __init__(
        self,
        service: Any,
        *,
        unix_path: Optional[str] = None,
        result_timeout_s: float = 60.0,
    ) -> None:
        self.service = service
        self.result_timeout_s = float(result_timeout_s)
        path = unix_path or default_frontend_path()
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, mode=0o700, exist_ok=True)
        if os.path.exists(path):
            os.unlink(path)  # AF_UNIX does not SO_REUSEADDR over stale files
        self._server = _UnixServer(path, _Handler)
        self._server.frontend = self  # type: ignore[attr-defined]
        self.address = path
        self._sessions: Dict[str, Any] = {}
        self._session_lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name='serving-frontend',
            daemon=True,
        )
        self._thread.start()

    # -- route handlers (one handler thread each) --------------------------

    def _context_of(self, doc: Dict[str, Any]) -> Optional[RequestContext]:
        """The request's trace identity: shipped headers, or a fresh one.

        A client that ships ``ctx.to_wire()`` keeps its ``request_id``
        (and remaining deadline) across the hop; a bare request gets a
        front-end-minted context so the flush is traceable either way.
        """
        headers = doc.get('context')
        if headers is not None:
            return RequestContext.from_wire(headers)
        deadline_ms = doc.get('deadline_ms')
        return new_request_context(
            str(doc.get('kind') or 'rate'),
            deadline_ms=float(deadline_ms) if deadline_ms is not None else None,
        )

    def _await(self, future: Any, ctx: Optional[RequestContext]) -> Any:
        remaining = ctx.remaining_s() if ctx is not None else None
        timeout = (
            self.result_timeout_s if remaining is None
            else max(0.0, remaining) + 5.0  # grace for the expiry error path
        )
        return future.result(timeout=timeout)

    def handle_rate(self, doc: Dict[str, Any]) -> Dict[str, Any]:
        """``POST /rate``: rate one match frame through the service.

        Reconstructs the client's :class:`RequestContext` from the wire
        (hop + 1, deadline re-anchored) so ``obsctl trace`` stitches
        the client hop to this process's flush events.
        """
        frame = _frame_from_wire(doc.get('actions') or {})
        ctx = self._context_of(doc)
        future = self.service.rate(
            frame,
            home_team_id=doc.get('home_team_id'),
            context=ctx,
        )
        values = self._await(future, ctx)
        out = _values_to_wire(values)
        out['request_id'] = ctx.request_id if ctx is not None else None
        return out

    def handle_scenarios(self, doc: Dict[str, Any]) -> Dict[str, Any]:
        """``POST /scenarios``: value a counterfactual grid for one match.

        The wire form of
        :meth:`~socceraction_tpu_torch.serve.service.RatingService.rate_scenarios`:
        ``doc['grid']`` is a
        :meth:`~socceraction_tpu_torch.scenario.grid.ScenarioGrid.to_wire`
        document, the reply carries the flat ``(P, n_rows, 3)`` value
        block plus its shape, the value column names and the frame's
        row index — everything a decision-heatmap client needs to
        reassemble ranked tables without a second round trip.
        """
        from ..scenario.grid import ScenarioGrid

        frame = _frame_from_wire(doc.get('actions') or {})
        grid = ScenarioGrid.from_wire(doc.get('grid') or {})
        ctx = self._context_of(doc)
        future = self.service.rate_scenarios(
            frame,
            grid,
            home_team_id=doc.get('home_team_id'),
            context=ctx,
        )
        values = np.asarray(self._await(future, ctx), dtype=np.float64)
        return {
            'shape': list(values.shape),
            'values': values.ravel().tolist(),
            'columns': list(RATING_COLUMNS),
            'index': np.asarray(frame.index).tolist(),
            'request_id': ctx.request_id if ctx is not None else None,
        }

    def handle_session_open(self, doc: Dict[str, Any]) -> Dict[str, Any]:
        """``POST /session/open``: open a match session, return its id."""
        session = self.service.open_session(
            doc['match_id'], home_team_id=doc['home_team_id']
        )
        session_id = uuid.uuid4().hex
        with self._session_lock:
            self._sessions[session_id] = session
        return {'session_id': session_id}

    def _session(self, doc: Dict[str, Any]) -> Tuple[str, Any]:
        session_id = str(doc.get('session_id') or '')
        with self._session_lock:
            session = self._sessions.get(session_id)
        if session is None:
            raise ValueError(f'unknown session_id {session_id!r}')
        return session_id, session

    def handle_session_add(self, doc: Dict[str, Any]) -> Dict[str, Any]:
        """``POST /session/add``: append actions, return their values."""
        _sid, session = self._session(doc)
        frame = _frame_from_wire(doc.get('actions') or {})
        values = session.add_actions(frame, timeout=self.result_timeout_s)
        return _values_to_wire(values)

    def handle_session_close(self, doc: Dict[str, Any]) -> Dict[str, Any]:
        """``POST /session/close``: drop the session (idempotent)."""
        session_id = str(doc.get('session_id') or '')
        with self._session_lock:
            self._sessions.pop(session_id, None)
        return {'closed': session_id}

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Stop accepting, drop sessions, remove the socket file.

        The service itself stays up — the front end is a detachable
        door, and ownership of the service's lifecycle stays with
        whoever constructed it.
        """
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)
        with self._session_lock:
            self._sessions.clear()
        try:
            os.unlink(self.address)
        except OSError:
            pass

    def __enter__(self) -> 'ServingFrontend':
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


# -- the client half --------------------------------------------------------


class _UnixHTTPConnection(http.client.HTTPConnection):
    def __init__(self, path: str, timeout: float) -> None:
        super().__init__('localhost', timeout=timeout)
        self._path = path

    def connect(self) -> None:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(self.timeout)
        sock.connect(self._path)
        self.sock = sock


class FrontendClient:
    """A client process's handle on a :class:`ServingFrontend` socket.

    Every :meth:`rate` call mints a
    :class:`~socceraction_tpu_torch.obs.context.RequestContext` in THIS
    process (recorded in this process's run log) and ships its
    ``to_wire()`` headers, so the server-side flush carries the same
    ``request_id`` — the stitch key ``obsctl trace`` joins the two run
    logs on. Raises :class:`FrontendError` on any non-200 reply;
    ``err.retriable`` distinguishes backoff-and-retry (shed, overload)
    from hard failures.
    """

    def __init__(self, path: str, *, timeout_s: float = 120.0) -> None:
        self.path = path
        self.timeout_s = float(timeout_s)

    def _call(
        self, method: str, route: str, doc: Optional[Dict[str, Any]] = None
    ) -> Dict[str, Any]:
        conn = _UnixHTTPConnection(self.path, self.timeout_s)
        try:
            body = json.dumps(doc or {}, default=str).encode('utf-8')
            conn.request(
                method, route, body=body if method == 'POST' else None,
                headers={'Content-Type': 'application/json'},
            )
            response = conn.getresponse()
            payload = json.loads(response.read() or b'{}')
            if response.status != 200:
                raise FrontendError(response.status, payload)
            return payload
        finally:
            conn.close()

    def rate(
        self,
        actions: 'pd.DataFrame',
        *,
        home_team_id: Any = None,
        deadline_ms: Optional[float] = None,
    ) -> 'pd.DataFrame':
        """Rate one match's actions through the front end (blocking).

        Returns the :data:`RATING_COLUMNS` DataFrame aligned to
        ``actions``' index — the same contract as
        ``RatingService.rate_sync``, across the process boundary.
        """
        import time as _time

        from ..obs.context import record_request_done, record_request_enqueue

        ctx = new_request_context('rate', deadline_ms=deadline_ms)
        # hop 0 of the trace: the client's enqueue/done events land in
        # THIS process's run log; the server's from_wire hop records the
        # rest, and `obsctl trace <id> client.jsonl server.jsonl`
        # stitches the two on the preserved request_id
        record_request_enqueue(ctx, queue_depth=0)
        t0 = _time.perf_counter()
        try:
            out = self._call('POST', '/rate', {
                'actions': _frame_to_wire(actions),
                'home_team_id': home_team_id,
                'context': ctx.to_wire(),
            })
        except Exception as e:
            record_request_done(
                ctx, 'error', _time.perf_counter() - t0,
                error=f'{type(e).__name__}: {e}',
            )
            raise
        record_request_done(ctx, 'ok', _time.perf_counter() - t0)
        self.last_request_id = out.get('request_id', ctx.request_id)
        return _values_from_wire(out)

    def rate_scenarios(
        self,
        actions: 'pd.DataFrame',
        grid: Any,
        *,
        home_team_id: Any = None,
        deadline_ms: Optional[float] = None,
    ) -> np.ndarray:
        """Value a counterfactual grid through the front end (blocking).

        Ships the frame plus ``grid.to_wire()`` to ``POST /scenarios``
        and returns the ``(P, len(actions), 3)`` value array — the same
        contract as ``RatingService.rate_scenarios_sync``, across the
        process boundary, with the request id preserved for trace
        stitching exactly like :meth:`rate`.
        """
        import time as _time

        from ..obs.context import record_request_done, record_request_enqueue

        ctx = new_request_context('scenario', deadline_ms=deadline_ms)
        record_request_enqueue(ctx, queue_depth=0)
        t0 = _time.perf_counter()
        try:
            out = self._call('POST', '/scenarios', {
                'actions': _frame_to_wire(actions),
                'grid': grid.to_wire(),
                'home_team_id': home_team_id,
                'context': ctx.to_wire(),
            })
        except Exception as e:
            record_request_done(
                ctx, 'error', _time.perf_counter() - t0,
                error=f'{type(e).__name__}: {e}',
            )
            raise
        record_request_done(ctx, 'ok', _time.perf_counter() - t0)
        self.last_request_id = out.get('request_id', ctx.request_id)
        return np.asarray(out['values'], dtype=np.float64).reshape(
            out['shape']
        )

    def health(self) -> Dict[str, Any]:
        """The service's health dict, across the boundary."""
        return self._call('GET', '/health')

    def open_session(self, match_id: Any, *, home_team_id: Any) -> str:
        """Open a live-match session; returns its server-side id."""
        return self._call('POST', '/session/open', {
            'match_id': match_id, 'home_team_id': home_team_id,
        })['session_id']

    def session_add(self, session_id: str, actions: 'pd.DataFrame') -> 'pd.DataFrame':
        """Append new actions to a session; returns THEIR values only."""
        out = self._call('POST', '/session/add', {
            'session_id': session_id, 'actions': _frame_to_wire(actions),
        })
        return _values_from_wire(out)

    def session_close(self, session_id: str) -> None:
        """Release the server-side session state (idempotent)."""
        self._call('POST', '/session/close', {'session_id': session_id})
