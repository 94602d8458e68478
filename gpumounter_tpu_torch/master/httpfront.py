"""Bounded, multiplexed HTTP front for the master gateway (the port of
:mod:`gpumounter_tpu.master.httpfront`).

The previous front was ``ThreadingHTTPServer``: one OS thread spawned per
request, HTTP/1.0 (a TCP handshake per request), no admission control —
at a few hundred concurrent attaches the master burns thread-spawn +
connection-setup per RPC and has no bound at all on threads. This module
replaces it with the classic async front the Kubernetes Network Driver
Model's thin-control-plane argument assumes underneath:

- **Acceptor** admits connections up to ``max_conns`` — beyond the bound
  the connection gets an immediate ``503`` and a close (admission happens
  BEFORE any thread allocation, counted in
  ``tpumounter_gateway_rejected_total``).
- **Selector loop** (epoll/kqueue via :mod:`selectors`) owns every idle
  keep-alive connection; a readable connection is handed to the worker
  pool. Thousands of open connections cost one fd each, zero threads.
- **Bounded worker pool** (``workers`` threads) executes requests. After
  a response, a still-open connection goes back to the selector — N
  threads multiplex M >> N connections. Requests already pipelined into
  the connection's buffer are drained before the hand-back, so
  back-to-back requests on one connection don't pay a selector round
  trip each.
- **HTTP/1.1 keep-alive** end to end: a client doing sustained
  attach/detach cycles pays connection setup once, not per request
  (bench: ~2 ms/request on loopback, more over a real network).

``tpumounter_gateway_inflight`` tracks requests admitted-but-unanswered
(queued + processing); ``peak_inflight`` on the server object records the
high-water mark (the sustained-RPS bench's acceptance number).
"""

from __future__ import annotations

import os
import queue
import select
import selectors
import socket
import threading

from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("master.httpfront")

_REJECT_RESPONSE = (b"HTTP/1.1 503 Service Unavailable\r\n"
                    b"Content-Type: application/json\r\n"
                    b"Content-Length: 52\r\n"
                    b"Connection: close\r\n\r\n"
                    b'{"result": "GatewaySaturated", "retry_after_s": 1}\n')


def _per_request_class(handler_class):
    """Derive (once per server, not per connection) a handler whose
    request loop WE drive: one ``handle_one_request`` per dispatch
    instead of the built-in serve-until-close loop."""

    class _PerRequest(handler_class):
        # HTTP/1.1 => keep-alive by default; every gateway response
        # carries Content-Length, which 1.1 requires
        protocol_version = "HTTP/1.1"

        def handle(self):          # suppress the built-in loop
            pass

        def finish(self):          # suppressed too: WE own teardown
            pass

    return _PerRequest


class _Connection:
    """One accepted connection holding its persistent per-request
    handler (rfile/wfile state survives across dispatches)."""

    def __init__(self, sock: socket.socket, addr, handler_class, server):
        self.sock = sock
        self.addr = addr
        self.server = server
        self.handler = handler_class(sock, addr, server)

    def service_one(self) -> bool:
        """Parse + answer exactly one request. Returns True when the
        connection should stay open (hand back to the selector)."""
        handler = self.handler
        try:
            handler.handle_one_request()
        except (ConnectionError, socket.timeout, OSError):
            return False
        return not handler.close_connection

    def buffered_request_waiting(self) -> bool:
        """A pipelined request already sitting in the read buffer? Peeked
        without blocking so a drained connection goes back to the
        selector instead of capturing this worker."""
        timeout = self.sock.gettimeout()
        try:
            self.sock.setblocking(False)
            try:
                return bool(self.handler.rfile.peek(1))
            finally:
                self.sock.settimeout(timeout)
        except (OSError, ValueError):
            return False

    def close(self) -> None:
        for stream in (getattr(self.handler, "wfile", None),
                       getattr(self.handler, "rfile", None)):
            try:
                if stream is not None:
                    stream.close()
            except OSError:
                pass
        try:
            self.sock.close()
        except OSError:
            pass


class MultiplexedHTTPServer:
    """Drop-in for the gateway's ``ThreadingHTTPServer`` usage surface:
    exposes ``server_port`` and ``shutdown()``; construction starts the
    acceptor, the selector loop, and the worker pool."""

    # Idle keep-alive connections are reaped by the client going away (the
    # selector sees EOF); a connection mid-request is bounded by this so a
    # stalled client cannot capture a worker forever.
    REQUEST_TIMEOUT_S = 65.0
    # Work-conserving stickiness: after answering a request, the worker
    # waits this long for the SAME connection's next request — but only
    # while no other connection is waiting for a worker — so a chatty
    # client's serial request stream skips the selector round trip per
    # request, and a busy gateway degrades to pure multiplexing.
    STICKY_GRACE_S = 0.02

    def __init__(self, address: str, port: int, handler_class,
                 workers: int | None = None, max_conns: int = 1024):
        self.handler_class = _per_request_class(handler_class)
        self.max_conns = max_conns
        self.workers = workers or min(32, (os.cpu_count() or 4) * 4)
        self._listener = socket.create_server((address, port), backlog=512,
                                              reuse_port=False)
        self.server_address = self._listener.getsockname()
        self.server_port = self.server_address[1]
        self._selector = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._selector.register(self._wake_r, selectors.EVENT_READ, None)
        self._pending: queue.SimpleQueue = queue.SimpleQueue()
        self._to_register: list[_Connection] = []
        self._register_lock = threading.Lock()
        self._conns: set[_Connection] = set()
        self._conns_lock = threading.Lock()
        self._inflight = 0
        self.peak_inflight = 0
        self._inflight_lock = threading.Lock()
        self._shutdown = threading.Event()
        self._threads = [
            threading.Thread(target=self._accept_loop, daemon=True,
                             name="gateway-accept"),
            threading.Thread(target=self._select_loop, daemon=True,
                             name="gateway-select"),
        ]
        self._threads += [
            threading.Thread(target=self._worker_loop, daemon=True,
                             name=f"gateway-worker-{i}")
            for i in range(self.workers)]
        for thread in self._threads:
            thread.start()
        logger.info("multiplexed gateway front: %d workers, %d max conns",
                    self.workers, max_conns)

    # -- inflight accounting ---------------------------------------------------

    def _inflight_delta(self, delta: int) -> None:
        with self._inflight_lock:
            self._inflight += delta
            if self._inflight > self.peak_inflight:
                self.peak_inflight = self._inflight
            REGISTRY.gateway_inflight.set(self._inflight)

    # -- acceptor --------------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                sock, addr = self._listener.accept()
            except OSError:
                return                      # listener closed: shutting down
            with self._conns_lock:
                saturated = len(self._conns) >= self.max_conns
            if saturated:
                # admission BEFORE thread allocation: the bound answers
                # here, in the acceptor, with a canned 503 — no handler,
                # no worker, no queue slot
                REGISTRY.gateway_rejected.inc()
                try:
                    sock.sendall(_REJECT_RESPONSE)
                except OSError:
                    pass
                sock.close()
                continue
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                sock.settimeout(self.REQUEST_TIMEOUT_S)
                conn = _Connection(sock, addr, self.handler_class, self)
            except OSError:
                sock.close()
                continue
            with self._conns_lock:
                self._conns.add(conn)
            self._register(conn)

    # -- selector loop ---------------------------------------------------------

    def _register(self, conn: _Connection) -> None:
        with self._register_lock:
            self._to_register.append(conn)
        self._wake()

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    def _select_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                events = self._selector.select(timeout=1.0)
            except OSError:
                return
            for key, _ in events:
                if key.data is None:        # the wake pipe
                    try:
                        self._wake_r.recv(4096)
                    except OSError:
                        pass
                    continue
                conn = key.data
                try:
                    self._selector.unregister(conn.sock)
                except (KeyError, OSError, ValueError):
                    continue
                self._inflight_delta(+1)
                self._pending.put(conn)
            with self._register_lock:
                fresh, self._to_register = self._to_register, []
            for conn in fresh:
                try:
                    self._selector.register(conn.sock,
                                            selectors.EVENT_READ, conn)
                except (OSError, ValueError):
                    self._drop(conn)

    # -- worker pool -----------------------------------------------------------

    def _worker_loop(self) -> None:
        while True:
            conn = self._pending.get()
            if conn is None:                # shutdown sentinel
                return
            keep = self._service(conn)
            # Sticky grace: while NO other connection is waiting for a
            # worker, give this connection a short window to send its
            # next request and handle it inline — a serial client's
            # request stream then skips the selector handoff entirely.
            while keep and not self._shutdown.is_set() \
                    and self._pending.empty():
                try:
                    readable, _, _ = select.select(
                        [conn.sock], [], [], self.STICKY_GRACE_S)
                except (OSError, ValueError):
                    keep = False
                    break
                if not readable:
                    break
                self._inflight_delta(+1)
                keep = self._service(conn)
            if keep and not self._shutdown.is_set():
                self._register(conn)
            else:
                self._drop(conn)

    def _service(self, conn: _Connection) -> bool:
        """One request, plus any already-pipelined ones in the buffer.
        Pairs the inflight +1 its caller accounted."""
        try:
            keep = conn.service_one()
            # drain pipelined requests before handing back: each is a
            # full request already buffered, a selector round trip per
            # would serialise them behind every other connection
            while keep and conn.buffered_request_waiting():
                keep = conn.service_one()
            return keep
        except Exception:                   # noqa: BLE001 — a handler bug
            logger.exception("gateway worker: request failed")
            return False
        finally:
            self._inflight_delta(-1)

    def _drop(self, conn: _Connection) -> None:
        with self._conns_lock:
            self._conns.discard(conn)
        conn.close()

    # -- lifecycle -------------------------------------------------------------

    def shutdown(self) -> None:
        self._shutdown.set()
        try:
            self._listener.close()
        except OSError:
            pass
        self._wake()
        for _ in range(self.workers):
            self._pending.put(None)
        for thread in self._threads:
            thread.join(timeout=2.0)
        # admitted-but-never-served connections (queued behind the
        # sentinels) still hold an inflight count: release it so the
        # gauge doesn't leak across server lifetimes
        while True:
            try:
                leftover = self._pending.get_nowait()
            except queue.Empty:
                break
            if leftover is not None:
                self._inflight_delta(-1)
                leftover.close()
        with self._conns_lock:
            conns, self._conns = list(self._conns), set()
        for conn in conns:
            conn.close()
        try:
            self._selector.close()
        except OSError:
            pass
        self._wake_r.close()
        self._wake_w.close()

    # API parity with ThreadingHTTPServer for callers that close both ways
    def server_close(self) -> None:
        self.shutdown()
