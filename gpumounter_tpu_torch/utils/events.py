"""Typed, append-only lifecycle event log — the fleet's flight data. The
port's own copy of :mod:`gpumounter_tpu.utils.events`, with its own
:data:`EVENTS` ring.

The per-request traces (utils/trace.py) answer "where did THIS request's
milliseconds go"; the metric families answer "how much of everything is
happening". Neither answers the operator question both the Kubernetes
Network Driver Model and gpu_ext's deny-with-reason telemetry (PAPERS.md)
presume: *what lifecycle decisions did the control plane take, in order,
and for whom?* Every attach/detach/admit/queue/preempt/lease/journal/
agent-fallback transition therefore emits ONE structured event carrying
the correlation ids that already exist (request id, tenant, lease pod,
node, chips) into:

- a bounded in-memory ring, served as ``GET /eventz?since=<seq>`` on both
  the worker health port and the master gateway (the master's fleet
  aggregator tails every worker's ring into one cluster-wide stream —
  master/fleet.py);
- an optional node-local JSONL file (``TPU_EVENT_LOG``) for post-mortems
  that outlive the ring;
- the ``tpumounter_events_total{kind}`` counter, so dashboards can rate
  lifecycle activity without parsing the stream.

Hot-path discipline: :meth:`EventLog.emit` takes **no event-log lock** —
the sequence counter is an atomic ``itertools.count`` and the ring is a
``deque(maxlen=...)`` (both C-atomic in CPython), so concurrent attach
handlers never serialise on telemetry. One small dict is built per event;
``TPU_EVENTS=0`` turns ``emit`` into an early return. The JSONL sidecar
is written by a background drain thread off a bounded buffer — enabling
``TPU_EVENT_LOG`` never puts a disk write (or a file lock) on the
request path. The bench pins the
attach overhead p50 with events on (the default) within noise of
events-off.

``since`` cursor contract: sequence numbers are consecutive integers for
the life of the process, starting at 1. A reader polls
``/eventz?since=<last seq it saw>`` and receives every event with a
greater seq still in the ring, plus ``dropped`` — how many events rotated
out of the ring before the reader came back (0 means the tail is
complete). A restart resets the sequence to 1; readers detect it by the
payload's ``boot`` id changing (the authoritative signal — ``seq``
moving backwards also implies a restart, but a new incarnation that
already emitted past the reader's cursor never moves it backwards).
"""

from __future__ import annotations

import atexit
import collections
import itertools
import json
import os
import threading
import time
import uuid


class EventLog:
    """Bounded, lock-free-on-emit ring of lifecycle events."""

    def __init__(self, ring_size: int = 512, enabled: bool = True,
                 path: str | None = None):
        self.enabled = enabled
        self.path = path or None
        # process-incarnation id, carried in every /eventz payload: a
        # cursor reader detects a restart by the boot changing — "seq
        # moved backwards" alone misses a restart whose new incarnation
        # already emitted past the reader's cursor (e.g. a busy boot
        # journal replay), silently losing its first events
        self.boot = uuid.uuid4().hex[:12]
        self._ring: collections.deque[dict] = collections.deque(
            maxlen=ring_size)
        self._seq = itertools.count(1)       # next() is atomic in CPython
        # JSONL sidecar (opt-in): emit only appends to this bounded
        # buffer — one background thread drains it to disk, so the hot
        # path never blocks on a write+flush (or serialises attach
        # handlers on a file lock). A stalled disk evicts the OLDEST
        # pending lines; the drain writes an ``events_lost`` marker over
        # the gap so the file never silently pretends continuity.
        self._file = None
        self._file_lock = threading.Lock()   # file handle + drain only
        self._fbuf: collections.deque[dict] = collections.deque(
            maxlen=4096)
        self._fwake = threading.Event()
        self._writer: threading.Thread | None = None
        self._last_written_seq = 0

    # -- write side (the hot path) ---------------------------------------------

    def emit(self, kind: str, *, rid: str = "", tenant: str = "",
             node: str = "", namespace: str = "", pod: str = "",
             chips: int | None = None, **attrs) -> int:
        """Append one event; returns its seq (0 when disabled).

        Fixed correlation fields ride at the top level (empty ones are
        skipped — most events carry a subset); anything else lands under
        ``attrs``. Never raises on the hot path: a broken JSONL sidecar
        degrades to ring-only."""
        if not self.enabled:
            return 0
        seq = next(self._seq)
        event: dict = {"seq": seq, "ts": round(time.time(), 3),
                       "kind": kind}
        if rid:
            event["rid"] = rid
        if tenant:
            event["tenant"] = tenant
        if node:
            event["node"] = node
        if namespace:
            event["namespace"] = namespace
        if pod:
            event["pod"] = pod
        if chips is not None:
            event["chips"] = int(chips)
        if attrs:
            event["attrs"] = attrs
        self._ring.append(event)
        from gpumounter_tpu_torch.utils.metrics import REGISTRY
        REGISTRY.events_emitted.inc(kind=kind)
        if self.path is not None:
            self._fbuf.append(event)         # deque append: no blocking
            self._fwake.set()
            if self._writer is None:
                self._start_writer()
        return seq

    def _start_writer(self) -> None:
        with self._file_lock:
            if self._writer is not None or self.path is None:
                return
            self._writer = threading.Thread(
                target=self._drain_loop, daemon=True,
                name="tpumounter-eventlog")
            self._writer.start()

    def _drain_loop(self) -> None:
        while self.path is not None:
            self._fwake.wait(0.5)
            self._fwake.clear()
            self.flush()

    def flush(self) -> None:
        """Drain pending sidecar lines to disk now (the writer thread's
        loop body; tests and shutdown call it for synchronous
        visibility). Never raises: an unwritable sidecar degrades to
        ring-only."""
        try:
            with self._file_lock:
                # batch pickup happens under the lock: two concurrent
                # drains (the writer thread's 0.5 s wake + a test or
                # shutdown flush) would otherwise interleave their
                # popleft()s — lines land out of seq order and the gap
                # detector emits events_lost markers for events that
                # were in fact written
                batch = []
                while True:
                    try:
                        batch.append(self._fbuf.popleft())
                    except IndexError:
                        break
                if not batch:
                    return
                # re-read path under the lock: a concurrent drain that
                # just hit OSError set self.path = None, and
                # abspath(None) would raise TypeError past the except
                # below
                path = self.path
                if path is None:
                    return
                if self._file is None:
                    dirname = os.path.dirname(os.path.abspath(path))
                    os.makedirs(dirname, exist_ok=True)
                    self._file = open(path, "a")
                lines = []
                # sort by seq: emit() is lock-free, so two threads can
                # buffer their events out of seq order (A takes seq N,
                # is preempted, B appends N+1 first) — written as-is the
                # gap detector below would emit a false events_lost
                # marker AND regress the watermark, repeating the false
                # marker on every following batch
                for event in sorted(batch,
                                    key=lambda e: int(e.get("seq") or 0)):
                    seq = int(event.get("seq") or 0)
                    if seq > self._last_written_seq + 1 \
                            and self._last_written_seq:
                        # the bounded buffer evicted pending lines (disk
                        # stalled behind the emit rate) — mark the gap.
                        # (An emit still in flight across the drain
                        # boundary can also land here; its line follows
                        # in the next batch, so the marker overcounts at
                        # worst by the events that do appear after it.)
                        lines.append(json.dumps(
                            {"kind": "events_lost", "ts": event["ts"],
                             "count": seq - self._last_written_seq - 1},
                            sort_keys=True))
                    if seq > self._last_written_seq:
                        self._last_written_seq = seq
                    lines.append(json.dumps(event, sort_keys=True))
                self._file.write("\n".join(lines) + "\n")
                self._file.flush()
        except OSError:
            # an unwritable sidecar must not cost the attach; the ring
            # (and /eventz) still carry the event
            self.path = None

    # -- read side (/eventz, fleet scrapes, flight recorder) -------------------

    def _snapshot_ring(self) -> list[dict]:
        """Point-in-time copy. Emit is lock-free, so a concurrent append
        can invalidate the iteration — retry (appends are microseconds;
        late attempts back off so a sustained burst can't starve the
        reader). If it STILL fails, degrade to an empty view rather than
        throwing a 500 out of /eventz."""
        for attempt in range(64):
            try:
                return sorted(self._ring, key=lambda e: e["seq"])
            except RuntimeError:       # deque mutated during iteration
                if attempt >= 8:
                    time.sleep(0.0005)
        return []

    def since(self, seq: int = 0,
              limit: int | None = None) -> tuple[list[dict], int, int]:
        """(events with seq > ``seq``, latest seq, dropped count).

        ``dropped`` counts events that rotated out of the ring between the
        caller's cursor and the oldest event still held — the reader's
        signal that its tail is incomplete (it can re-baseline from the
        JSONL sidecar if one is configured).

        ``limit`` keeps the OLDEST matching events: a cursor-paginating
        reader (the fleet aggregator) advances its cursor to the last
        RETURNED seq and re-polls for the rest — truncating from the
        newest end instead would silently skip the middle of the stream
        while reporting ``dropped=0``."""
        events = self._snapshot_ring()
        # cut at the first seq gap: emit() is lock-free, so a reader can
        # land between one thread taking seq N and appending it while
        # N+1 is already in the ring. Serving past the hole would let a
        # cursor advance over N — the event would vanish forever with
        # ``dropped`` still 0. Withhold the post-gap tail instead; the
        # hole fills in microseconds and the next poll returns it.
        # (Rotation only evicts the OLDEST entries, so within the ring a
        # gap can only be this in-flight race.)
        for i in range(1, len(events)):
            if events[i]["seq"] != events[i - 1]["seq"] + 1:
                events = events[:i]
                break
        latest = events[-1]["seq"] if events else 0
        newer = [e for e in events if e["seq"] > seq]
        dropped = 0
        if newer:
            dropped = max(0, newer[0]["seq"] - seq - 1)
        elif seq and latest and seq < latest:
            dropped = latest - seq
        if limit is not None and limit >= 0:
            newer = newer[:limit]
        return newer, latest, dropped

    def tail(self, limit: int = 64) -> list[dict]:
        return self._snapshot_ring()[-max(0, limit):]

    def snapshot(self, since: int = 0, limit: int = 256) -> dict:
        """The /eventz payload. On a truncated page ``seq`` is the last
        RETURNED seq, not the ring's newest: a reader that re-baselines
        its cursor from ``seq`` must never skip the untransmitted middle
        of the stream — it re-polls and the page advances. ``truncated``
        says more pages are pending."""
        newer, latest, dropped = self.since(since)
        events = newer[:limit] if limit >= 0 else newer
        truncated = len(events) < len(newer)
        if truncated:
            # an empty truncated page (limit=0) holds the cursor at
            # ``since`` — re-baselining to ``latest`` would skip every
            # withheld event while reporting dropped=0
            seq = events[-1]["seq"] if events else since
        else:
            seq = latest
        return {"enabled": self.enabled, "boot": self.boot, "seq": seq,
                "since": since, "truncated": truncated,
                "dropped": dropped, "events": events}

    def snapshot_from_query(self, params: dict) -> dict:
        """The /eventz payload from parse_qs-style query params — ONE
        implementation of the since/limit contract for both the worker
        health handler and the master gateway route."""
        def _int(name: str, default: int) -> int:
            try:
                return int((params.get(name) or [default])[0])
            except ValueError:
                return default
        return self.snapshot(since=_int("since", 0),
                             limit=_int("limit", 256))

    def clear(self) -> None:
        """Test isolation only — production rings never reset (the seq
        contract promises consecutive numbers for the process life)."""
        self._ring.clear()


def _from_env() -> EventLog:
    from gpumounter_tpu_torch.utils import consts
    ring = 512
    if raw := os.environ.get(consts.ENV_EVENT_RING):
        try:
            ring = max(16, int(raw))
        except ValueError:
            pass
    return EventLog(ring_size=ring,
                    enabled=os.environ.get(consts.ENV_EVENTS, "1") != "0",
                    path=os.environ.get(consts.ENV_EVENT_LOG) or None)


# One log per process (worker or master), like metrics.REGISTRY and
# trace.STORE. The atexit flush drains whatever the 0.5 s writer window
# left buffered at a clean exit — the detach/journal events immediately
# preceding the exit are exactly what a sidecar post-mortem wants.
EVENTS = _from_env()
atexit.register(EVENTS.flush)
