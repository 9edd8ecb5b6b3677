"""Per-replica telemetry exposition endpoint: a tiny stdlib HTTP server.

A copy of the JAX package's ``socceraction_tpu/obs/endpoint.py``. Every
replica process of a fleet needs a scrape surface that the aggregator
(and an operator's curl) can poll without importing this package, let
alone torch. This module is that surface — stdlib only, a few kilobytes
of ``http.server`` over a unix socket by default:

- :class:`Telemetry` — what one process exposes: its replica id, the
  metric registry, an optional ``health()`` callable and the flight
  recorder.
- :func:`serve` / :class:`TelemetryEndpoint` — start the exposition
  server on a **unix socket by default** (filesystem permissions are
  the access control: the socket directory is created ``0700``, the
  socket ``0600``) or TCP opt-in via ``tcp=(host, port)`` (loopback
  unless the caller explicitly binds wider — telemetry includes env
  snippets and request ids; treat it like logs).
- :func:`fetch` / :func:`scrape` / :func:`scrape_health` — the client
  half the :class:`~socceraction_tpu_torch.obs.fleet.FleetAggregator`
  polls with.

Routes (all GET), the JAX package's:

- ``/snapshot`` — the versioned wire document
  (:func:`~socceraction_tpu_torch.obs.wire.encode_snapshot`, buckets
  included — the fleet merge needs them), JSON.
- ``/health`` — the process's health dict (the caller's ``health()``
  when wired; a minimal liveness dict otherwise), JSON.
- ``/metrics`` — Prometheus text exposition (the standard scrape path).
- ``/tail?n=50`` — the flight-recorder ring tail, JSONL (newest last).

The server runs on one daemon thread per endpoint plus one per active
request (``ThreadingHTTPServer``); every handler reads host state only
(a registry snapshot, the recorder ring) — scraping a replica never
touches the card, and the module imports neither torch nor jax. The
default socket directory is the port's own
(``socceraction-tpu-torch-telemetry-<uid>``), so a replica of each
package on one host never share a path.
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
from typing import Any, Callable, Dict, List, Optional, Tuple, Union
from urllib.parse import parse_qs, urlsplit

from .metrics import REGISTRY, MetricRegistry

__all__ = [
    'EndpointError',
    'Telemetry',
    'TelemetryEndpoint',
    'default_socket_path',
    'fetch',
    'parse_address',
    'scrape',
    'scrape_health',
    'serve',
    'serve_telemetry',
]


class EndpointError(RuntimeError):
    """An endpoint could not be started, reached, or understood."""


def _default_replica_id() -> str:
    """A stable-enough default replica id: sanitized ``<host>-<pid>``.

    Real fleets should pass explicit slot names (``replica-0`` ...) —
    the bounded :class:`~socceraction_tpu_torch.obs.wire.ReplicaRegistry` is
    the governing contract; this default only keeps single-process use
    ergonomic.
    """
    import re

    host = re.sub(r'[^a-z0-9_.-]', '-', socket.gethostname().lower())
    return f'{host or "host"}-{os.getpid()}'


def default_socket_path(replica: Optional[str] = None) -> str:
    """The default unix-socket path for this process's endpoint.

    Lives in a per-user ``0700`` directory under the tempdir, named by
    replica id — predictable enough for an operator's curl, private
    enough that filesystem permissions are the access control.
    """
    base = os.path.join(
        tempfile.gettempdir(), f'socceraction-tpu-torch-telemetry-{os.getuid()}'
    )
    name = replica or _default_replica_id()
    return os.path.join(base, f'{name}.sock')


class Telemetry:
    """What one process exposes: registry + health + recorder + identity.

    ``health`` is any zero-arg callable returning a JSON-able dict;
    without one the endpoint serves a minimal liveness dict. ``extra``
    rides into that minimal dict (and under ``'process'`` in the full
    one is left to the caller's health fn).
    """

    def __init__(
        self,
        *,
        replica: Optional[str] = None,
        registry: Optional[MetricRegistry] = None,
        health: Optional[Callable[[], Dict[str, Any]]] = None,
        recorder: Any = None,
        extra: Optional[Dict[str, Any]] = None,
    ) -> None:
        from .wire import REPLICAS

        self.replica = REPLICAS.register(replica or _default_replica_id())
        self.registry = registry if registry is not None else REGISTRY
        self._health = health
        if recorder is None:
            from .recorder import RECORDER

            recorder = RECORDER
        self.recorder = recorder
        self.extra = dict(extra or {})

    # -- the four route payloads (host state only, any thread) -------------

    def wire(self) -> Dict[str, Any]:
        """The versioned snapshot wire document (buckets included)."""
        from .wire import encode_snapshot

        return encode_snapshot(self.registry.snapshot(), replica=self.replica)

    def health(self) -> Dict[str, Any]:
        """The health dict (caller's fn, or a minimal liveness dict)."""
        if self._health is not None:
            out = dict(self._health())
        else:
            out = {'status': 'ok', **self.extra}
        out.setdefault('replica', self.replica)
        return out

    def prometheus(self) -> str:
        """Prometheus text exposition of the live registry."""
        from .export import prometheus_text

        return prometheus_text(self.registry.snapshot())

    def tail(self, n: int = 50) -> List[Dict[str, Any]]:
        """The newest ``n`` flight-recorder events (oldest first)."""
        n = int(n)
        if n <= 0:  # events[-0:] would be the WHOLE ring
            return []
        return self.recorder.events()[-n:]


class _Handler(http.server.BaseHTTPRequestHandler):
    """Routes one GET to the :class:`Telemetry` payloads (JSON errors)."""

    server_version = 'socceraction-tpu-torch-telemetry'
    protocol_version = 'HTTP/1.1'

    def do_GET(self) -> None:  # noqa: N802 (http.server contract)
        telemetry: Telemetry = self.server.telemetry  # type: ignore[attr-defined]
        split = urlsplit(self.path)
        try:
            if split.path == '/snapshot':
                body = json.dumps(
                    telemetry.wire(), sort_keys=True, default=str
                ).encode('utf-8')
                ctype = 'application/json'
            elif split.path == '/health':
                body = json.dumps(
                    telemetry.health(), sort_keys=True, default=str
                ).encode('utf-8')
                ctype = 'application/json'
            elif split.path == '/metrics':
                body = telemetry.prometheus().encode('utf-8')
                ctype = 'text/plain; version=0.0.4'
            elif split.path == '/tail':
                n = int((parse_qs(split.query).get('n') or ['50'])[0])
                body = (
                    '\n'.join(
                        json.dumps(e, sort_keys=True, default=str)
                        for e in telemetry.tail(n)
                    )
                    + '\n'
                ).encode('utf-8')
                ctype = 'application/jsonl'
            else:
                self._reply(
                    404,
                    json.dumps(
                        {
                            'error': f'unknown route {split.path!r}',
                            'routes': ['/snapshot', '/health', '/metrics', '/tail'],
                        }
                    ).encode('utf-8'),
                    'application/json',
                )
                return
        except Exception as e:  # a broken health fn must not kill the server
            self._reply(
                500,
                json.dumps(
                    {'error': f'{type(e).__name__}: {e}'}, default=str
                ).encode('utf-8'),
                'application/json',
            )
            return
        self._reply(200, body, ctype)

    def _reply(self, status: int, body: bytes, ctype: str) -> None:
        self.send_response(status)
        self.send_header('Content-Type', ctype)
        self.send_header('Content-Length', str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def address_string(self) -> str:  # AF_UNIX peers have no host:port
        addr = self.client_address
        return addr[0] if isinstance(addr, tuple) and addr else 'unix-peer'

    def log_message(self, format: str, *args: Any) -> None:
        pass  # scrapes are telemetry, not log traffic


class _TCPServer(socketserver.ThreadingMixIn, http.server.HTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    # a scrape burst (N aggregator threads + an operator's curl) must
    # queue, not bounce: the socketserver default backlog of 5 makes a
    # unix connect fail EAGAIN under modest concurrency
    request_queue_size = 128


class _UnixServer(socketserver.ThreadingMixIn, http.server.HTTPServer):
    daemon_threads = True
    address_family = socket.AF_UNIX
    request_queue_size = 128

    def server_bind(self) -> None:
        # no getfqdn over a filesystem path (HTTPServer.server_bind
        # assumes an INET address); permissions before accept: the file
        # is chmod'd 0600 between bind and listen, and lives in a 0700
        # directory, so the pre-chmod window is already access-controlled
        socketserver.TCPServer.server_bind(self)
        os.chmod(self.server_address, stat.S_IRUSR | stat.S_IWUSR)
        self.server_name = 'unix'
        self.server_port = 0

    def get_request(self) -> Tuple[Any, Any]:
        request, _ = self.socket.accept()
        return request, ('unix-peer', 0)


class TelemetryEndpoint:
    """One process's running exposition server (see module docstring).

    Exactly one transport: ``unix_path`` (default — a fresh path under
    :func:`default_socket_path`) or ``tcp=(host, port)`` (port 0 picks
    a free port; read the bound one from :attr:`address`). The server
    starts in the constructor and stops on :meth:`close` (context
    manager supported); the socket file is unlinked on close.
    """

    def __init__(
        self,
        telemetry: Telemetry,
        *,
        unix_path: Optional[str] = None,
        tcp: Optional[Tuple[str, int]] = None,
    ) -> None:
        if unix_path is not None and tcp is not None:
            raise ValueError('give at most one of unix_path= or tcp=')
        self.telemetry = telemetry
        self._unix_path: Optional[str] = None
        if tcp is not None:
            host, port = tcp
            self._server: http.server.HTTPServer = _TCPServer(
                (host, int(port)), _Handler
            )
            self.address = f'tcp://{host}:{self._server.server_address[1]}'
        else:
            path = unix_path or default_socket_path(telemetry.replica)
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, mode=0o700, exist_ok=True)
            if os.path.exists(path):
                # a previous process's socket: binding over it needs the
                # stale file gone (sockets do not SO_REUSEADDR on AF_UNIX)
                os.unlink(path)
            self._server = _UnixServer(path, _Handler)
            self._unix_path = path
            self.address = path
        self._server.telemetry = telemetry  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name=f'telemetry-endpoint-{telemetry.replica}',
            daemon=True,
        )
        self._thread.start()

    def close(self) -> None:
        """Stop serving and remove the socket file."""
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)
        if self._unix_path is not None:
            try:
                os.unlink(self._unix_path)
            except OSError:
                pass

    def __enter__(self) -> 'TelemetryEndpoint':
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def serve(
    telemetry: Optional[Telemetry] = None,
    *,
    unix_path: Optional[str] = None,
    tcp: Optional[Tuple[str, int]] = None,
    **telemetry_kwargs: Any,
) -> TelemetryEndpoint:
    """Start this process's telemetry endpoint; returns the running server.

    ``telemetry`` defaults to a fresh :class:`Telemetry` over the
    process registry and flight recorder (``telemetry_kwargs`` — e.g.
    ``replica=``, ``health=`` — feed its constructor)::

        endpoint = serve(telemetry=Telemetry(replica='replica-0'))
    """
    if telemetry is None:
        telemetry = Telemetry(**telemetry_kwargs)
    elif telemetry_kwargs:
        raise ValueError('pass either telemetry= or its constructor kwargs')
    return TelemetryEndpoint(telemetry, unix_path=unix_path, tcp=tcp)


#: package-level alias (``socceraction_tpu_torch.obs.serve_telemetry``)
#: — the bare name ``serve`` would read like the serving subsystem there
serve_telemetry = serve


# -- client half ------------------------------------------------------------


class _UnixHTTPConnection(http.client.HTTPConnection):
    def __init__(self, path: str, timeout: float) -> None:
        super().__init__('localhost', timeout=timeout)
        self._path = path

    def connect(self) -> None:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(self.timeout)
        sock.connect(self._path)
        self.sock = sock


def parse_address(address: Union[str, Tuple[str, int]]) -> Tuple[str, ...]:
    """Normalize an endpoint address to ``('unix', path)`` or
    ``('tcp', host, port)``.

    Accepted string forms: ``unix:<path>``, a filesystem path (contains
    a separator or ends in ``.sock``), ``tcp://host:port`` or
    ``host:port``. A ``(host, port)`` tuple is TCP.
    """
    if isinstance(address, tuple):
        host, port = address
        return ('tcp', str(host), int(port))
    if address.startswith('unix:'):
        return ('unix', address[len('unix:'):])
    if address.startswith('tcp://'):
        address = address[len('tcp://'):]
    elif os.sep in address or address.endswith('.sock'):
        return ('unix', address)
    host, sep, port = address.rpartition(':')
    if not sep or not port.isdigit():
        raise EndpointError(
            f'unrecognized endpoint address {address!r} (want a unix '
            "socket path, 'unix:<path>', or 'host:port')"
        )
    return ('tcp', host, int(port))


def fetch(
    address: Union[str, Tuple[str, int]],
    route: str = '/snapshot',
    *,
    timeout: float = 5.0,
) -> bytes:
    """GET one route from a replica endpoint; returns the body bytes.

    Raises :class:`EndpointError` on connection failure or a non-200
    status — the aggregator turns that into a loud unreachable-replica
    fact, never a silent hole.
    """
    parsed = parse_address(address)
    if parsed[0] == 'unix':
        conn: http.client.HTTPConnection = _UnixHTTPConnection(
            parsed[1], timeout
        )
    else:
        conn = http.client.HTTPConnection(parsed[1], parsed[2], timeout=timeout)
    try:
        try:
            conn.request('GET', route)
            response = conn.getresponse()
            body = response.read()
        except (OSError, http.client.HTTPException) as e:
            raise EndpointError(
                f'cannot reach telemetry endpoint {address!r}: '
                f'{type(e).__name__}: {e}'
            ) from None
        if response.status != 200:
            raise EndpointError(
                f'telemetry endpoint {address!r} returned {response.status} '
                f'for {route}: {body[:200]!r}'
            )
        return body
    finally:
        conn.close()


def scrape(
    address: Union[str, Tuple[str, int]], *, timeout: float = 5.0
) -> Dict[str, Any]:
    """Scrape one replica's ``/snapshot``; returns the decoded wire doc."""
    from .wire import decode_snapshot

    return decode_snapshot(fetch(address, '/snapshot', timeout=timeout))


def scrape_health(
    address: Union[str, Tuple[str, int]], *, timeout: float = 5.0
) -> Dict[str, Any]:
    """Scrape one replica's ``/health`` dict."""
    return json.loads(fetch(address, '/health', timeout=timeout))
