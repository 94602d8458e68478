"""Unified retry/backoff + circuit breaking for every network hop: the
port's own copy of :mod:`gpumounter_tpu.utils.retry`, whose jitter comes
from a ``random.Random`` the caller can seed.

The reference busy-polls the apiserver forever and string-matches error
kinds (SURVEY.md §0, allocator.go:247-282); this port added typed errors
and deadlines, but until this module every apiserver/kubelet/worker call
was ONE-SHOT — a single transient 429/500/connection-reset anywhere in the
attach pipeline failed the whole request. This module is the single place
that decides *whether* a failure is worth retrying, *how long* to back
off, and *when* a target is so broken that calls should fail fast instead
of queueing up (the composability-under-failure bar the Kubernetes Network
Driver Model paper sets for device control planes, PAPERS.md).

Three pieces, composed by :func:`call_with_retry`:

- :class:`RetryPolicy` — jittered exponential backoff with a per-call
  deadline and a ``Retry-After`` override (a 429's server-supplied delay
  beats our own guess).
- :class:`RetryBudget` — a token bucket capping the *ratio* of retries to
  successes across a client, so a hard outage degrades to roughly one
  attempt per call instead of multiplying load by max_attempts exactly
  when the target is drowning.
- :class:`CircuitBreaker` — closed→open→half-open per target. Open
  circuits raise :class:`CircuitOpenError` without dialing; one probe per
  ``reset_timeout_s`` decides recovery.

Retryability is classified over the existing typed errors in ONE place
(:func:`retryable`), so call sites cannot drift: 429/5xx/transport-level
``K8sApiError`` and kubelet socket flaps retry; 4xx, policy denials, and
busy devices never do (retrying a deterministic denial only adds latency
to the failure).

Every recovery is observable: ``tpumounter_retry_attempts_total{target}``
counts each re-attempt, ``tpumounter_circuit_state{target}`` exports the
breaker state (0 closed / 1 half-open / 2 open).
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from collections.abc import Callable

from gpumounter_tpu_torch.utils.errors import (CircuitOpenError,
                                               DeviceBusyError, K8sApiError,
                                               KubeletUnavailableError,
                                               MountPolicyError,
                                               PodNotFoundError)
from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("retry")


def retryable(exc: BaseException) -> bool:
    """The single retryability classifier for control-plane failures.

    - :class:`K8sApiError`: 429 (throttled), 5xx (server trouble), and
      status 0 (no HTTP response: timeout/refused/reset/dns) are
      transient. Every other 4xx is a fact about the request, not the
      network — retrying cannot change the answer.
    - :class:`PodNotFoundError` subclasses K8sApiError semantics but is a
      definitive 404: never retried.
    - :class:`KubeletUnavailableError`: the node-local socket flapping
      (kubelet restart, device-plugin re-registration) — retryable.
    - :class:`MountPolicyError` / :class:`DeviceBusyError`: deterministic
      domain denials — never retried here (the *caller* may re-request
      after freeing the device).
    - gRPC ``UNAVAILABLE`` is retryable (safe for an attach because the
      worker's per-request-id fencing makes it idempotent); other codes
      carry the worker's actual answer.
    """
    if isinstance(exc, PodNotFoundError):
        return False
    if isinstance(exc, (MountPolicyError, DeviceBusyError)):
        return False
    if isinstance(exc, K8sApiError):
        return exc.status == 0 or exc.status == 429 or exc.status >= 500
    if isinstance(exc, KubeletUnavailableError):
        return True
    try:
        import grpc
    except ModuleNotFoundError:                  # pragma: no cover
        return False
    if isinstance(exc, grpc.RpcError) and hasattr(exc, "code"):
        return exc.code() == grpc.StatusCode.UNAVAILABLE
    return False


def retryable_non_idempotent(exc: BaseException) -> bool:
    """Classifier for calls that are NOT safe to replay once the original
    attempt may have reached the server — POST creates with fixed names.

    Only failures that GUARANTEE the request never landed are retried:
    connection refused / DNS failure (no connection was ever established)
    and 429 (the server explicitly rejected before processing). A timeout
    or reset may have mutated state (the apiserver might have persisted
    the pod before the reply was lost), and a 5xx can be returned after a
    partial write — replaying those risks a 409 on an object the first
    attempt created, which the caller's cleanup would then miss (a leaked
    slave pod). Those failures surface instead; the request-id adoption
    machinery is the safe retry path for creates."""
    if isinstance(exc, PodNotFoundError):
        return False
    if isinstance(exc, K8sApiError):
        if exc.status == 429:
            return True
        if exc.status == 0:
            return exc.cause in ("refused", "dns")
        return False
    return False


def retry_after_of(exc: BaseException) -> float | None:
    """The server-mandated backoff carried by ``exc``, if any."""
    return getattr(exc, "retry_after_s", None)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Backoff shape for one call site.

    ``max_attempts`` counts the FIRST try too (1 = no retries at all, so
    the fault-free path is byte-for-byte the one-shot behavior — no extra
    round-trips). Delays grow ``base_delay_s * 2^n`` capped at
    ``max_delay_s``, each multiplied by ``1 ± jitter`` so a fleet of
    workers doesn't re-dial a recovering apiserver in lockstep.
    ``deadline_s`` bounds the whole call including backoff sleeps — a
    retried call can never outlive its caller's patience. ``rng`` draws
    the jitter; pass ``random.Random(seed)`` for a reproducible sequence.
    """

    max_attempts: int = 4
    base_delay_s: float = 0.1
    max_delay_s: float = 2.0
    deadline_s: float = 30.0
    jitter: float = 0.25
    rng: random.Random = dataclasses.field(
        default_factory=random.Random, repr=False, compare=False)

    def delay_s(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based)."""
        raw = min(self.max_delay_s, self.base_delay_s * (2 ** (attempt - 1)))
        if self.jitter <= 0:
            return raw
        return raw * self.rng.uniform(1.0 - self.jitter, 1.0 + self.jitter)


class RetryBudget:
    """Token bucket bounding the fleet-amplification of retries.

    Each retry spends 1 token; each SUCCESS deposits ``deposit_per_success``
    (default 0.1 ⇒ steady-state at most ~10% extra load from retries).
    An exhausted budget turns the next failure terminal instead of
    hammering a target that is already down. Thread-safe: one budget is
    shared per client across its request threads.
    """

    def __init__(self, capacity: float = 10.0,
                 deposit_per_success: float = 0.1):
        self.capacity = capacity
        self.deposit_per_success = deposit_per_success
        self._tokens = capacity
        self._lock = threading.Lock()

    def try_spend(self) -> bool:
        with self._lock:
            if self._tokens < 1.0:
                return False
            self._tokens -= 1.0
            return True

    def deposit(self) -> None:
        with self._lock:
            self._tokens = min(self.capacity,
                               self._tokens + self.deposit_per_success)

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens


class CircuitBreaker:
    """Per-target closed→open→half-open breaker.

    ``failure_threshold`` consecutive failures open the circuit: calls
    raise :class:`CircuitOpenError` without touching the network until
    ``reset_timeout_s`` passes, then exactly ONE caller gets through as
    the half-open probe (concurrent callers keep failing fast — a probe
    stampede would re-kill a barely-recovered target). Probe success
    closes the circuit; probe failure re-opens it for another timeout.

    State is exported on every transition as
    ``tpumounter_circuit_state{target}`` (0 closed / 1 half-open / 2 open).
    """

    CLOSED, HALF_OPEN, OPEN = 0, 1, 2
    _STATE_NAMES = {0: "closed", 1: "half-open", 2: "open"}

    def __init__(self, target: str, failure_threshold: int = 5,
                 reset_timeout_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.target = target
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probe_in_flight = False
        self._announced = False
        self._export()

    def _export(self) -> None:
        from gpumounter_tpu_torch.utils.metrics import REGISTRY
        REGISTRY.circuit_state.set(self._state, target=self.target)

    @property
    def state(self) -> int:
        with self._lock:
            return self._state

    def allow(self) -> None:
        """Admit one call or raise :class:`CircuitOpenError`."""
        with self._lock:
            if self._state == self.CLOSED:
                return
            now = self._clock()
            elapsed = now - self._opened_at
            if self._state == self.OPEN and elapsed >= self.reset_timeout_s:
                self._state = self.HALF_OPEN
                self._probe_in_flight = False
                self._export()
                logger.info("circuit for %s half-open: probing", self.target)
            if self._state == self.HALF_OPEN and not self._probe_in_flight:
                self._probe_in_flight = True     # this caller is the probe
                return
            raise CircuitOpenError(
                self.target, max(0.0, self.reset_timeout_s - elapsed))

    def record_success(self) -> None:
        with self._lock:
            if self._state != self.CLOSED:
                logger.info("circuit for %s closed (probe succeeded)",
                            self.target)
            self._state = self.CLOSED
            self._failures = 0
            self._probe_in_flight = False
            self._announced = False
            self._export()

    def record_failure(self) -> None:
        opened = False
        with self._lock:
            self._failures += 1
            if self._state == self.HALF_OPEN \
                    or self._failures >= self.failure_threshold:
                if self._state != self.OPEN:
                    opened = True
                    logger.warning(
                        "circuit for %s OPEN after %d consecutive "
                        "failure(s); failing fast for %.1fs", self.target,
                        self._failures, self.reset_timeout_s)
                self._state = self.OPEN
                self._opened_at = self._clock()
                self._probe_in_flight = False
                # announce the RISING edge only: every failed half-open
                # probe re-enters here with state != OPEN, and a target
                # down for an hour must not flood the event ring (or eat
                # the flight rate-limit slot) with one circuit_open per
                # reset_timeout_s — the outage is announced once until
                # the circuit actually closes again
                if opened and not self._announced:
                    self._announced = True
                else:
                    opened = False
                self._export()
        if opened:
            # outside the lock (the recorder snapshots stores that may
            # themselves export circuit state)
            self._announce_open()

    def _announce_open(self) -> None:
        """Lifecycle event + flight-recorder trigger on CLOSED→OPEN.
        Overridable for the same reason as ``_export``: a breaker whose
        opening is NOT an anomaly (the fleet's scrape breakers — a
        telemetry miss, already surfaced as ``stale``) must not write a
        flight bundle or flood the event ring with ``circuit_open``."""
        from gpumounter_tpu_torch.utils.events import EVENTS
        from gpumounter_tpu_torch.utils.flight import RECORDER
        EVENTS.emit("circuit_open", target=self.target,
                    failures=self._failures)
        RECORDER.note("circuit_open", target=self.target)


def call_with_retry(fn: Callable, *, policy: RetryPolicy,
                    target: str,
                    classify: Callable[[BaseException], bool] = retryable,
                    budget: RetryBudget | None = None,
                    breaker: CircuitBreaker | None = None,
                    on_retry: Callable[[BaseException, int], None]
                    | None = None,
                    sleep: Callable[[float], None] = time.sleep):
    """Run ``fn()`` under ``policy``; the one retry loop every network hop
    shares.

    ``target`` labels ``tpumounter_retry_attempts_total`` (coarse:
    "apiserver" / "kubelet" / "worker_rpc" — bounded cardinality, never a
    URL). ``breaker`` gates and records every attempt; ``budget`` caps
    retry amplification; ``on_retry(exc, attempt)`` lets call sites log or
    annotate traces. A server-supplied ``Retry-After`` overrides the
    computed backoff (capped by the remaining deadline).
    """
    from gpumounter_tpu_torch.utils.metrics import REGISTRY
    deadline = time.monotonic() + policy.deadline_s
    attempt = 0
    while True:
        attempt += 1
        if breaker is not None:
            breaker.allow()
        try:
            result = fn()
        except Exception as e:
            if breaker is not None:
                breaker.record_failure()
            if not classify(e) or attempt >= policy.max_attempts:
                raise
            delay = retry_after_of(e)
            if delay is None:
                delay = policy.delay_s(attempt)
            remaining = deadline - time.monotonic()
            if remaining <= delay:
                # Sleeping past the deadline helps nobody; surface the
                # last real failure rather than a synthetic timeout.
                raise
            if budget is not None and not budget.try_spend():
                logger.warning(
                    "retry budget for %s exhausted; failing without "
                    "retry: %s", target, e)
                raise
            REGISTRY.retry_attempts.inc(target=target)
            if on_retry is not None:
                on_retry(e, attempt)
            logger.info("retrying %s (attempt %d/%d in %.2fs): %s",
                        target, attempt + 1, policy.max_attempts, delay, e)
            sleep(delay)
        else:
            if breaker is not None:
                breaker.record_success()
            if budget is not None:
                budget.deposit()
            return result
