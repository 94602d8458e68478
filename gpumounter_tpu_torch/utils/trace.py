"""Per-request tracing for the attach/detach control plane: the port's own
copy of :mod:`gpumounter_tpu.utils.trace` (its own :data:`STORE`).

The reference has no tracing or profiling of any kind (SURVEY.md §5: "only
zap logging" — the sole way to see where an attach's seconds went was
reading interleaved debug lines). This framework's north-star metric IS a
latency (hot-attach <3s p50, BASELINE.md), so its decomposition is a
first-class observable:

- every traced operation collects a TREE of named **spans** with wall-clock
  start/end and free-form attributes (chip count, k8s verb, pool hit/miss);
- the current span is carried in a :mod:`contextvars` ContextVar, so deep
  layers (the k8s REST client, the kubelet PodResources client, the warm
  pool) join the active request's trace with :func:`span` — no parameter
  threading through every call signature;
- on completion the trace is emitted as ONE structured log line
  (``trace op=attach rid=... result=SUCCESS total_ms=... allocate_ms=...``)
  so a single grep reconstructs any request's timing — unchanged from the
  flat-phase era, fed by the root's direct children;
- each top-level phase also feeds a per-phase Prometheus histogram
  (``tpumounter_attach_phase_seconds{phase="allocate"}``), so fleet-wide
  dashboards can answer "did the p95 regression come from the scheduler
  or from actuation?" without touching logs;
- the finished trace lands in a bounded per-process ring buffer
  (:class:`TraceStore`, module singleton :data:`STORE`) served as
  ``GET /tracez`` on both the worker health port and the master gateway,
  which additionally stitches the worker's spans for the same request id
  into one cross-process tree.

Spans survive failures: a trace finished after an exception still records
the phases that ran, which is exactly when the breakdown matters most.

The module has a second sink, for the in-pod training step: :func:`region`
opens a ``torch.profiler`` range (``record_function``) while a profiler
records, so the step's layers (``train.step``, ``train.forward``,
``train.loss``, ``train.backward``, ``model.norm``, ``attn.core``) stand on
the device trace's clock beside the kernels they launch. A region never
joins a request's span tree, and with no profiler recording it opens
nothing and hooks nothing into the autograd graph. :meth:`Region.carry`
carries a region into the backward as a ``<name>.bwd`` range on the
thread that runs it. The module imports no torch: a process that never
imported it has no profiler recording.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import sys
import threading
import time

from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("trace")

# Trace results whose flat log line is demoted to DEBUG (the request
# completed as designed; /tracez and the histograms carry the numbers).
_QUIET_RESULTS = ("SUCCESS", "ok", "200")

# The innermost open span of the active request in THIS thread/context.
# ThreadingHTTPServer and the gRPC thread pool give each request its own
# thread, hence its own contextvar value — traces cannot bleed across
# concurrent requests.
_CURRENT_SPAN: contextvars.ContextVar["Span | None"] = \
    contextvars.ContextVar("tpumounter_current_span", default=None)


class Span:
    """One timed node of a trace tree.

    ``duration_s`` is None while the span is open; ``start_unix`` is
    wall-clock (for display/stitching), the duration is measured on the
    monotonic clock (immune to NTP steps mid-request)."""

    __slots__ = ("name", "attrs", "children", "start_unix", "_t0",
                 "duration_s", "_trace")

    def __init__(self, name: str, attrs: dict | None = None, trace=None):
        self.name = name
        self.attrs: dict = dict(attrs) if attrs else {}
        self.children: list[Span] = []
        self.start_unix = time.time()
        self._t0 = time.monotonic()
        self.duration_s: float | None = None
        self._trace = trace          # owning Trace (nesting boundary)

    def close(self) -> None:
        if self.duration_s is None:
            self.duration_s = time.monotonic() - self._t0

    def elapsed_s(self) -> float:
        return (self.duration_s if self.duration_s is not None
                else time.monotonic() - self._t0)

    def to_dict(self) -> dict:
        out: dict = {
            "name": self.name,
            "start_unix": round(self.start_unix, 6),
            "duration_ms": round(self.elapsed_s() * 1e3, 3),
        }
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        if self.children:
            out["children"] = [c.to_dict() for c in self.children]
        return out


def current_span() -> Span | None:
    return _CURRENT_SPAN.get()


@contextlib.contextmanager
def span(name: str, **attrs):
    """Open a child span under the ACTIVE request's current span.

    A no-op (yields None, body still runs) when no trace is active — e.g.
    background reconciler/pool threads, or unit tests driving a layer
    directly. This is what lets deep layers instrument themselves
    unconditionally without knowing whether a request is in flight."""
    parent = _CURRENT_SPAN.get()
    if parent is None:
        yield None
        return
    child = Span(name, attrs, trace=parent._trace)
    parent.children.append(child)
    token = _CURRENT_SPAN.set(child)
    try:
        yield child
    finally:
        child.close()
        _CURRENT_SPAN.reset(token)


def annotate(**attrs) -> None:
    """Attach attributes to the current span, if any (no-op otherwise)."""
    current = _CURRENT_SPAN.get()
    if current is not None:
        current.attrs.update(attrs)


@contextlib.contextmanager
def k8s_call(verb: str, resource: str):
    """Instrument one apiserver / kubelet round-trip: a ``k8s.<verb>``
    child span on the active trace plus the
    ``tpumounter_k8s_request_seconds{verb,resource}`` histogram and the
    error counter — the per-hop decomposition control-plane attach paths
    need to be debuggable at fleet scale (PAPERS.md, Kubernetes Network
    Driver Model). Metrics are recorded whether or not a trace is active."""
    from gpumounter_tpu_torch.utils.metrics import REGISTRY
    t0 = time.monotonic()
    try:
        with span(f"k8s.{verb.lower()}", verb=verb, resource=resource):
            yield
    except Exception:
        REGISTRY.k8s_errors.inc(verb=verb, resource=resource)
        raise
    finally:
        REGISTRY.k8s_latency.observe(time.monotonic() - t0,
                                     verb=verb, resource=resource)


class Region:
    """A profiler range of the training step, as :func:`region` opens it.

    :meth:`carry` holds the region's backward in a ``<name>.bwd`` range, on
    the thread that runs it, through two gradient hooks: nothing joins the
    autograd graph and no gradient changes. A region not recording
    carries nothing."""

    __slots__ = ("name", "_range")

    def __init__(self, name: str | None):
        self.name = name
        self._range = None

    def __enter__(self) -> "Region":
        if self.name is not None:
            self._open(self.name)
        return self

    def __exit__(self, *exc) -> None:
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None

    def carry(self, x, y):
        """Return ``y``, the region's output, after marking the region's
        backward: ``<name>.bwd`` opens when the gradient of ``y`` is
        complete and closes when that of ``x``, its input, is."""
        if self.name is not None and x.requires_grad and y.requires_grad:
            y.register_hook(self._open_backward)
            x.register_hook(self._close_backward)
        return y

    def _open(self, name: str) -> None:
        self._range = sys.modules["torch"].autograd.profiler.record_function(
            name)
        self._range.__enter__()

    def _open_backward(self, grad) -> None:
        self._open(self.name + ".bwd")

    def _close_backward(self, grad) -> None:
        self.__exit__()


# The region a step gets while no profiler records: it opens and marks
# nothing (``name`` None), and is shared, since nothing changes it.
_OFF = Region(None)


def region(name: str) -> Region:
    """A context manager that holds a ``torch.profiler`` range named
    ``name`` over its block while a profiler records in this thread, and
    does nothing otherwise (one check, no range, no hook)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch._C._autograd._profiler_enabled():
        return _OFF
    return Region(name)


class Trace:
    """Collects a span tree for one logical operation.

    Not thread-safe by design: one Trace belongs to one request handler
    (deep layers in other threads simply don't see its contextvar). The
    flat view (:attr:`spans`) aggregates the root's DIRECT children by
    name — phases repeated within a request (e.g. a retried resolve)
    accumulate into one entry so the log line stays one-key-per-phase,
    and nested spans (k8s calls inside a phase) never leak into the
    phase histograms.
    """

    def __init__(self, op: str, rid: str = "-"):
        self.op = op
        self.rid = rid or "-"
        self._t0 = time.monotonic()
        self.root = Span(op, trace=self)
        self.result: str | None = None
        self.total_s: float | None = None

    @contextlib.contextmanager
    def span(self, phase: str, **attrs):
        """Open a phase span of THIS trace and make it the current span,
        so module-level :func:`span` calls underneath nest inside it.

        Nesting stops at trace boundaries: if another trace's span is
        current (e.g. the master's request trace while a slice
        transaction opens its own), the phase still attaches to this
        trace's tree, not the foreign one."""
        parent = _CURRENT_SPAN.get()
        if parent is None or parent._trace is not self:
            parent = self.root
        child = Span(phase, attrs, trace=self)
        parent.children.append(child)
        token = _CURRENT_SPAN.set(child)
        try:
            yield child
        finally:
            child.close()
            _CURRENT_SPAN.reset(token)

    @contextlib.contextmanager
    def activate(self):
        """Make this trace's root the current span for the block, so
        spans opened by deep layers OUTSIDE any named phase still join
        the tree (the master gateway wraps its whole route dispatch)."""
        token = _CURRENT_SPAN.set(self.root)
        try:
            yield self
        finally:
            _CURRENT_SPAN.reset(token)

    @property
    def spans(self) -> dict[str, float]:
        """Flat phase view: root's direct children aggregated by name."""
        out: dict[str, float] = {}
        for child in self.root.children:
            out[child.name] = out.get(child.name, 0.0) + child.elapsed_s()
        return out

    def to_dict(self) -> dict:
        root = self.root.to_dict()
        return {
            "op": self.op,
            "rid": self.rid,
            "result": self.result,
            "start_unix": root["start_unix"],
            "total_ms": round((self.total_s
                               if self.total_s is not None
                               else time.monotonic() - self._t0) * 1e3, 3),
            "spans": root,
        }

    def finish(self, result: str, histograms=None, store=None) -> None:
        """Emit the trace: one log line + per-phase histogram observations
        + a TraceStore entry.

        ``histograms``: a mapping-like with ``observe(seconds, phase=...)``
        (:class:`gpumounter_tpu_torch.utils.metrics.LabeledHistogram`);
        None skips the metrics feed (unit tests of the trace itself). ``store``
        defaults to the process singleton :data:`STORE`; pass an explicit
        TraceStore to isolate, or the sentinel :data:`NO_STORE` to skip.
        """
        self.root.close()
        total = self.total_s = time.monotonic() - self._t0
        self.result = result
        flat = self.spans
        if histograms is not None:
            for phase, seconds in flat.items():
                histograms.observe(seconds, phase=phase)
        # Success traces land in /tracez + the phase histograms; the flat
        # log line for them is DEBUG (a per-request INFO write is real
        # milliseconds on the hot path — ISSUE 6 bench). Failures keep
        # INFO: they are what gets grepped when /tracez has rotated.
        level = (logging.DEBUG if result in _QUIET_RESULTS
                 else logging.INFO)
        if logger.isEnabledFor(level):
            parts = " ".join(f"{phase}_ms={seconds * 1e3:.1f}"
                             for phase, seconds in flat.items())
            logger.log(level,
                       "trace op=%s rid=%s result=%s total_ms=%.1f %s",
                       self.op, self.rid, result, total * 1e3, parts)
        target = STORE if store is None else store
        if target is not NO_STORE:
            target.add(self)


class TraceStore:
    """Bounded per-process ring buffer of completed traces.

    Two views: ``recent`` (last N, newest first) and ``slowest`` (top N by
    total duration, for "where did the bad p99 come from" archaeology —
    a recency-only ring would have rotated the interesting trace out by
    the time anyone looks). Entries are plain dicts snapshotted at add
    time, so readers never race a mutating Trace object."""

    def __init__(self, recent_max: int = 128, slowest_max: int = 32):
        self.recent_max = recent_max
        self.slowest_max = slowest_max
        self._lock = threading.Lock()
        self._recent: list[dict] = []
        self._slowest: list[dict] = []

    def add(self, trace: Trace) -> None:
        entry = trace.to_dict()
        with self._lock:
            self._recent.append(entry)
            if len(self._recent) > self.recent_max:
                del self._recent[:len(self._recent) - self.recent_max]
            self._slowest.append(entry)
            self._slowest.sort(key=lambda t: t["total_ms"], reverse=True)
            del self._slowest[self.slowest_max:]

    @staticmethod
    def _matches(entry: dict, rid: str | None, result: str | None,
                 op: str | None = None) -> bool:
        return ((rid is None or entry["rid"] == rid)
                and (result is None or entry["result"] == result)
                and (op is None or entry["op"] == op))

    def recent(self, rid: str | None = None, result: str | None = None,
               op: str | None = None, limit: int = 32) -> list[dict]:
        with self._lock:
            hits = [t for t in reversed(self._recent)
                    if self._matches(t, rid, result, op)]
        return hits[:max(0, limit)]

    def slowest(self, rid: str | None = None, result: str | None = None,
                op: str | None = None, limit: int = 10) -> list[dict]:
        with self._lock:
            hits = [t for t in self._slowest
                    if self._matches(t, rid, result, op)]
        return hits[:max(0, limit)]

    def find(self, rid: str) -> list[dict]:
        """Every stored trace for one request id, oldest first (a retry
        contract means one rid can legitimately have several traces)."""
        with self._lock:
            return [t for t in self._recent if t["rid"] == rid]

    def snapshot(self, rid: str | None = None, result: str | None = None,
                 limit: int = 32) -> dict:
        """The /tracez payload: recent + slowest, filterable."""
        return {"recent": self.recent(rid=rid, result=result, limit=limit),
                "slowest": self.slowest(rid=rid, result=result,
                                        limit=min(limit, 10))}

    def clear(self) -> None:
        with self._lock:
            self._recent.clear()
            self._slowest.clear()


# Sentinel: Trace.finish(store=NO_STORE) records nowhere (micro-tests that
# must not touch the process singleton).
NO_STORE = TraceStore(recent_max=0, slowest_max=0)

# One store per process (worker or master), like metrics.REGISTRY.
STORE = TraceStore()
