"""Control-plane transports: in-process (tier-1) and TCP RPC (multi-host).

Port of ``repro/runtime/fabric/transport.py``.

Both implement the one-method
:class:`~repro_torch.runtime.fabric.protocols.ControlTransport` surface —
``request(msg) -> reply`` — against the same
:meth:`CoordinatorServer.handle` entry point, so every barrier/rollback
behaviour proven over :class:`LocalTransport` in tier-1 tests holds
verbatim over the wire.

* :class:`LocalTransport` — a direct, synchronous call into the server
  (plus optional fault injection: per-host message filters let tests
  build stragglers and lossy links without touching the protocol).
* :class:`SocketTransport` / :class:`CoordinatorListener` — length-prefixed
  pickle frames over TCP.  Workers connect to the coordinator (never the
  reverse — commands piggyback on replies, so workers need no listening
  socket, which is what makes the fabric preemption-friendly: a worker
  restarted on a new node just reconnects).  The listener serves each
  connection on a thread; ``CoordinatorServer.handle`` serializes under
  its own lock, so concurrency ends at the server boundary.

The frames are pickled dataclasses from
:mod:`repro_torch.runtime.fabric.messages` — trusted-cluster RPC (the trust
model of ``torch.distributed``'s own TCP rendezvous), not a public endpoint.
"""

from __future__ import annotations

import pickle
import socket
import socketserver
import struct
import threading
from typing import Callable

from repro_torch.runtime.fabric.coordinator import CoordinatorServer

__all__ = ["LocalTransport", "SocketTransport", "CoordinatorListener"]


class LocalTransport:
    """In-process transport: request == one serialized server call.

    ``filter_fn(host, msg) -> bool`` (optional) drops messages when it
    returns False — the fault-injection hook the barrier tests use (e.g. a
    straggler whose ReadyVote never arrives).  Dropped requests return
    None, exactly what a worker sees when a reply carries no command."""

    def __init__(
        self,
        server: CoordinatorServer,
        host: str,
        filter_fn: Callable[[str, object], bool] | None = None,
    ) -> None:
        self.server = server
        self.host = host
        self.filter_fn = filter_fn
        self.sent: list[object] = []
        self.dropped: list[object] = []

    def request(self, msg: object) -> object | None:
        if self.filter_fn is not None and not self.filter_fn(self.host, msg):
            self.dropped.append(msg)
            return None
        self.sent.append(msg)
        return self.server.handle(msg)


# ---------------------------------------------------------------------------
# TCP: length-prefixed pickle frames
# ---------------------------------------------------------------------------

_LEN = struct.Struct("!I")


def _send_frame(sock: socket.socket, obj: object) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("fabric peer closed the connection")
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket) -> object:
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    return pickle.loads(_recv_exact(sock, n))


class SocketTransport:
    """Worker-side TCP client: one persistent connection, one in-flight
    request at a time (the worker loop is sequential by design)."""

    def __init__(self, address: tuple[str, int], timeout: float = 60.0) -> None:
        self.address = address
        self.sock = socket.create_connection(address, timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()

    def request(self, msg: object) -> object | None:
        with self._lock:
            _send_frame(self.sock, msg)
            return _recv_frame(self.sock)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:  # one connection == one worker, many frames
        server: CoordinatorListener = self.server  # type: ignore[assignment]
        while True:
            try:
                msg = _recv_frame(self.request)
            except (ConnectionError, OSError):
                return
            reply = server.coordinator.handle(msg)
            try:
                _send_frame(self.request, reply)
            except OSError:
                return


class CoordinatorListener(socketserver.ThreadingTCPServer):
    """Coordinator-side TCP front end: every frame -> ``handle`` -> reply.

    Bind with port 0 to get an ephemeral port (``listener.port``), then
    ``start()`` serves on a daemon thread until ``shutdown()``."""

    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, coordinator: CoordinatorServer, address=("127.0.0.1", 0)):
        super().__init__(address, _Handler)
        self.coordinator = coordinator
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self.server_address[1]

    def start(self) -> "CoordinatorListener":
        self._thread = threading.Thread(target=self.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.shutdown()
        self.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
