"""Fault injection for the port's test rigs (the start of the port of
:mod:`gpumounter_tpu.testing.chaos`): :class:`ConnectionDropped`, which the
HTTP apiserver facade (:mod:`.http_apiserver`) turns into a torn TCP
connection, and the :class:`Fault` rules a :class:`FaultInjector` applies
at the fakes' seams (``FakeKubeClient.faults``, ``HttpApiserver.faults``).
The fault plans, crash points and chaos rigs arrive with the master's
port.
"""

from __future__ import annotations

import dataclasses
import threading
import time

from gpumounter_tpu_torch.utils.errors import (K8sApiError,
                                               KubeletUnavailableError)


class ConnectionDropped(K8sApiError):
    """Injected connection drop. Subclasses the status-0 "reset" apiserver
    error so the in-process fake treats it exactly like a torn TCP
    stream; the HTTP facade catches it and actually closes the socket."""

    def __init__(self):
        super().__init__(0, "injected connection drop", cause="reset")


@dataclasses.dataclass
class Fault:
    """One injection rule, applied to calls matching (op, resource).

    ``op`` is the instrumentation verb (GET/LIST/POST/DELETE/PATCH/WATCH)
    or ``*``; ``resource`` is pods/nodes/events/podresources or ``*``.
    The first ``after`` matching calls pass untouched, then ``times``
    calls are affected: sleep ``latency_s`` (a watch hang when op=WATCH),
    then raise — ``status``+``cause`` as a :class:`K8sApiError`,
    ``kubelet=True`` as :class:`KubeletUnavailableError`, ``drop=True``
    as :class:`ConnectionDropped`. Latency-only faults just delay.
    """

    op: str = "*"
    resource: str = "*"
    times: int = 1
    after: int = 0
    latency_s: float = 0.0
    status: int | None = None
    cause: str = ""
    retry_after_s: float | None = None
    kubelet: bool = False
    drop: bool = False

    def matches(self, op: str, resource: str) -> bool:
        return (self.op in ("*", op)
                and self.resource in ("*", resource))


class FaultInjector:
    """Stateful executor of a plan's rules; one per installed plan.

    ``fired`` logs every applied fault as (op, resource, description) so
    tests can assert the plan actually bit — a chaos test whose fault
    never fired proves nothing.
    """

    def __init__(self, faults: list[Fault]):
        self._faults = [dataclasses.replace(f) for f in faults]
        self._lock = threading.Lock()
        self.fired: list[tuple[str, str, str]] = []

    def fire(self, op: str, resource: str) -> None:
        fault = None
        with self._lock:
            for candidate in self._faults:
                if not candidate.matches(op, resource):
                    continue
                if candidate.after > 0:
                    candidate.after -= 1
                    continue
                if candidate.times <= 0:
                    continue
                candidate.times -= 1
                fault = candidate
                self.fired.append((op, resource, self._describe(fault)))
                break
        if fault is None:
            return
        if fault.latency_s > 0:
            time.sleep(fault.latency_s)
        if fault.drop:
            raise ConnectionDropped()
        if fault.kubelet:
            raise KubeletUnavailableError(
                "injected kubelet socket flap")
        if fault.status is not None:
            raise K8sApiError(fault.status,
                              "injected fault", cause=fault.cause,
                              retry_after_s=fault.retry_after_s)

    @staticmethod
    def _describe(fault: Fault) -> str:
        if fault.drop:
            return "drop"
        if fault.kubelet:
            return "kubelet-flap"
        if fault.status is not None:
            return f"error-{fault.status}" + (f"-{fault.cause}"
                                              if fault.cause else "")
        return f"latency-{fault.latency_s:g}s"

    @property
    def remaining(self) -> int:
        with self._lock:
            return sum(max(0, f.times) for f in self._faults)
