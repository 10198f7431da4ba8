"""Proto-less RPC transport on the standard library.

Counterpart of ``dlrover_tpu/common/grpc_utils.py``, keeping its name so
a reader finds it. The JAX package carries one generic unary gRPC method
``/dlrover_tpu.Master/call``; the port keeps that method's payload and
semantics on plain TCP, since the GPU hosts it runs on have no
``grpcio``:

* the payload is the same schema'd JSON envelope
  ``{"v": 1, "m": method_name, "d": message}`` (codec: common/comm.py —
  typed dataclass registry, no pickle anywhere on the network path),
  packed by :func:`_pack_call` and checked by :func:`_unpack_call`;
* a request is two length-prefixed frames on one connection: the
  caller's trace context (``tracing.traceparent()``, empty when none;
  gRPC metadata in the JAX package) and the payload. The response is
  one frame: a status byte, then ``comm.serialize(result)`` or the
  error's text;
* the status is gRPC's code: a malformed payload and a handler's
  ``ValueError`` answer ``INVALID_ARGUMENT``, any other handler
  exception ``INTERNAL``, a frame over the ``GRPC`` size limits of
  common/constants.py ``RESOURCE_EXHAUSTED``. The client raises
  :class:`RpcError` for each; a refused or reset connection and a
  timeout raise ``OSError`` (``ConnectionError``, ``TimeoutError``),
  which ``agent/master_client.is_connection_error`` classifies as the
  master going away;
* the server is a ``socketserver.ThreadingTCPServer``: one thread per
  connection, each serving that connection's calls in turn. The client
  keeps a pool of idle connections, so calls from several threads run
  at once, and checks a pooled connection before reusing it, so a
  master restarted on the same port is reached on the next call.

The event-loop ingest server (``AsyncRpcServer``) is not ported
(ROADMAP.md, queue A).
"""

import enum
import json
import socket
import socketserver
import struct
import threading
import time
from typing import Callable, List, Optional, Tuple

from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.constants import GRPC
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.telemetry import tracing

WIRE_VERSION = 1

_LEN = struct.Struct(">I")
#: a traceparent is two hex ids and a dash; anything longer is garbage
_MAX_TRACE_FRAME = 256


class StatusCode(enum.IntEnum):
    """The gRPC status codes the transport answers with (same numbers)."""

    OK = 0
    INVALID_ARGUMENT = 3
    RESOURCE_EXHAUSTED = 8
    INTERNAL = 13


class RpcError(Exception):
    """The remote end answered with an error status (the application's
    error, not the connection's)."""

    def __init__(self, code: StatusCode, details: str):
        super().__init__(f"{code.name}: {details}")
        self._code = code
        self.details = details

    def code(self) -> StatusCode:
        return self._code


def _pack_call(method: str, message) -> bytes:
    return json.dumps({
        "v": WIRE_VERSION,
        "m": method,
        "d": comm._encode(message),
    }, separators=(",", ":")).encode("utf-8")


def _unpack_call(payload: bytes):
    try:
        doc = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise comm.WireError(f"request is not valid JSON: {e}")
    if not isinstance(doc, dict) or not isinstance(doc.get("m"), str):
        raise comm.WireError("request envelope malformed")
    if doc.get("v") != WIRE_VERSION:
        raise comm.WireError(
            f"unsupported wire version {doc.get('v')!r}"
        )
    return doc["m"], comm._decode(doc.get("d"))


def _frame(data: bytes) -> bytes:
    return _LEN.pack(len(data)) + data


def _recv_exact(sock: socket.socket, n: int,
                eof_ok: bool = False) -> Optional[bytes]:
    """``n`` bytes from ``sock``; None on a clean end of stream before
    the first byte when ``eof_ok``, else a reset raises."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            if eof_ok and not buf:
                return None
            raise ConnectionResetError("connection closed by the peer")
        buf += chunk
    return bytes(buf)


def _recv_frame(sock: socket.socket, limit: int,
                eof_ok: bool = False) -> Optional[bytes]:
    head = _recv_exact(sock, _LEN.size, eof_ok)
    if head is None:
        return None
    (n,) = _LEN.unpack(head)
    if n > limit:
        raise RpcError(
            StatusCode.RESOURCE_EXHAUSTED,
            f"frame of {n} bytes exceeds the limit of {limit}",
        )
    return _recv_exact(sock, n)


def find_free_port(host: str = "") -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, 0))
        return s.getsockname()[1]


def addr_connected(addr: str, timeout: float = 3.0) -> bool:
    host, _, port = addr.rpartition(":")
    try:
        with socket.create_connection((host, int(port)), timeout=timeout):
            return True
    except OSError:
        return False


class _Handler(socketserver.BaseRequestHandler):
    """Serves one connection's calls in turn until the peer closes it."""

    def setup(self):
        self.request.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.server.rpc._track(self.request, True)

    def handle(self):
        rpc = self.server.rpc
        sock = self.request
        while True:
            try:
                trace = _recv_frame(sock, _MAX_TRACE_FRAME, eof_ok=True)
                if trace is None:
                    return
                payload = _recv_frame(
                    sock, GRPC.MAX_RECEIVE_MESSAGE_LENGTH
                )
            except RpcError as e:
                # the stream cannot be resynchronized past an unread
                # frame: answer, then drop the connection
                logger.warning("rejected RPC: %s", e.details)
                self._reply(sock, e.code(), e.details.encode())
                return
            except OSError:
                return
            status, body = rpc._dispatch(trace, payload)
            if not self._reply(sock, status, body):
                return

    @staticmethod
    def _reply(sock, status: StatusCode, body: bytes) -> bool:
        try:
            sock.sendall(_frame(bytes([status]) + body))
            return True
        except OSError:
            return False

    def finish(self):
        self.server.rpc._track(self.request, False)


class _TCPServer(socketserver.ThreadingTCPServer):
    # a master restarted on the same port must bind while the old
    # connections linger in TIME_WAIT
    allow_reuse_address = True
    daemon_threads = True
    block_on_close = False


class GenericRpcServer:
    """RPC server exposing one generic dispatch method."""

    def __init__(self, handler: Callable[[str, object], object],
                 port: int = 0):
        self._handler = handler
        self._server = _TCPServer(("", port), _Handler)
        self._server.rpc = self
        self.port = self._server.server_address[1]
        self._cond = threading.Condition()
        self._conns = set()
        self._inflight = 0
        self._thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()

    def _track(self, sock, alive: bool):
        with self._cond:
            if alive:
                self._conns.add(sock)
            else:
                self._conns.discard(sock)

    def _dispatch(self, trace: bytes,
                  payload: bytes) -> Tuple[StatusCode, bytes]:
        try:
            method, message = _unpack_call(payload)
        except comm.WireError as e:
            # reject, never execute: schema violations are the caller's
            # fault (or an attack), not a server error
            logger.warning("rejected malformed RPC: %s", e)
            return StatusCode.INVALID_ARGUMENT, str(e).encode()
        tid, sid = tracing.parse_traceparent(
            trace.decode("ascii", "replace")
        )
        with self._cond:
            self._inflight += 1
        try:
            with tracing.trace_context(tid, sid):
                result = self._handler(method, message)
            return StatusCode.OK, comm.serialize(result)
        except ValueError as e:
            logger.warning("RPC %s rejected: %s", method, e)
            return StatusCode.INVALID_ARGUMENT, str(e).encode()
        except Exception as e:
            logger.exception("RPC dispatch failed: %s", e)
            return StatusCode.INTERNAL, str(e).encode()
        finally:
            with self._cond:
                self._inflight -= 1
                self._cond.notify_all()

    def start(self):
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.1},
            name="rpc-accept", daemon=True,
        )
        self._thread.start()

    def stop(self, grace: Optional[float] = None):
        """Stop accepting, let calls in flight finish for up to
        ``grace`` seconds, then close every connection. Idempotent."""
        if self._stopped.is_set():
            return
        self._stopped.set()
        if self._thread is not None:
            self._server.shutdown()
            self._thread.join(timeout=5.0)
        self._server.server_close()
        deadline = time.monotonic() + (grace or 0.0)
        with self._cond:
            while self._inflight and time.monotonic() < deadline:
                self._cond.wait(deadline - time.monotonic())
            conns, self._conns = list(self._conns), set()
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def wait_for_termination(self, timeout=None):
        self._stopped.wait(timeout)


def _reusable(sock: socket.socket) -> bool:
    """An idle pooled connection can carry a call: the peer has not
    closed it and nothing unread waits on it."""
    try:
        sock.settimeout(0.0)
        sock.recv(1, socket.MSG_PEEK)
    except BlockingIOError:
        return True
    except OSError:
        return False
    return False


class GenericRpcClient:
    """Client for GenericRpcServer; thread-safe, connects lazily."""

    def __init__(self, addr: str, timeout: float = 30.0):
        self.addr = addr
        self.timeout = timeout
        self._lock = threading.Lock()
        self._idle: List[socket.socket] = []
        #: bumped by reset/close: a connection of an older generation
        #: is closed instead of pooled when its call returns
        self._generation = 0

    def _take(self) -> Tuple[Optional[socket.socket], int, str]:
        with self._lock:
            stale = []
            sock = None
            while self._idle:
                s = self._idle.pop()
                if _reusable(s):
                    sock = s
                    break
                stale.append(s)
            gen, addr = self._generation, self.addr
        for s in stale:
            s.close()
        return sock, gen, addr

    def _give(self, sock: socket.socket, gen: int):
        with self._lock:
            if gen == self._generation:
                self._idle.append(sock)
                return
        sock.close()

    def _drop_idle(self):
        with self._lock:
            idle, self._idle = self._idle, []
        for s in idle:
            s.close()

    def call(self, method: str, message, timeout: Optional[float] = None):
        timeout = timeout or self.timeout
        payload = _pack_call(method, message)
        if len(payload) > GRPC.MAX_SEND_MESSAGE_LENGTH:
            raise RpcError(
                StatusCode.RESOURCE_EXHAUSTED,
                f"request of {len(payload)} bytes exceeds the limit of "
                f"{GRPC.MAX_SEND_MESSAGE_LENGTH}",
            )
        trace = (tracing.traceparent() or "").encode("ascii")
        sock, gen, addr = self._take()
        try:
            if sock is None:
                host, _, port = addr.rpartition(":")
                sock = socket.create_connection(
                    (host.strip("[]"), int(port)), timeout=timeout
                )
                sock.setsockopt(
                    socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                )
            sock.settimeout(timeout)
            sock.sendall(_frame(trace) + _frame(payload))
            response = _recv_frame(sock, GRPC.MAX_RECEIVE_MESSAGE_LENGTH)
        except BaseException as e:
            if sock is not None:
                sock.close()
            if isinstance(e, OSError):
                # the master likely went away: its other connections
                # are as dead as this one
                self._drop_idle()
            raise
        self._give(sock, gen)
        if not response:
            raise RpcError(StatusCode.INTERNAL, "empty response")
        status = StatusCode(response[0])
        if status != StatusCode.OK:
            raise RpcError(status, response[1:].decode("utf-8", "replace"))
        return comm.deserialize(response[1:])

    def reset(self, addr: str):
        """Re-point the client at a new address; calls in flight finish
        on their old connections, which are then closed."""
        with self._lock:
            self.addr = addr
            self._generation += 1
        self._drop_idle()

    def close(self):
        with self._lock:
            self._generation += 1
        self._drop_idle()
