"""What the traced run's profiler saw, reduced to what the metrics read.

The traced stretch is ``steps`` training steps between two device
synchronisations, inside the benchmark's own ``benchmark.window`` range.
:class:`Trace` holds, from the profiler's exported trace:

- ``device_ops``: every kernel, memory copy and memory set of the stretch
  (name, start and end in microseconds, the id of its launch);
- ``launches``: the host thread and time of each launch, by that id;
- ``ranges``: the host's named ranges (``record_function`` and PyTorch's
  own, such as ``Optimizer.step#AdamW.step``), and ``cpu_ops``: the
  operators the host ran;
- the window's bounds, the number of steps, the work of one step
  (the program's ``step_counts``, keys in :data:`benchmark.counts.KEYS`)
  and the card's peaks.

A metric reader (``benchmark/metrics/<name>.py``) takes a Trace and
returns a number, or None where it finds nothing to read.
"""

from __future__ import annotations

import bisect
import dataclasses
import json

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
WINDOW = "benchmark.window"


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    start: float          # microseconds, the trace's clock
    end: float
    link: int | None = None
    tid: object = None


@dataclasses.dataclass
class Trace:
    device_ops: list[Op]
    launches: dict[int, Op]
    ranges: list[Op]
    cpu_ops: list[Op]
    window: tuple[float, float]
    steps: int
    counts: dict[str, float]
    peaks: dict[str, float] | None

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def device_s(self, ops=None) -> float:
        """Summed device time of ``ops`` (all device ops by default)."""
        return sum(o.end - o.start
                   for o in (self.device_ops if ops is None else ops)) / 1e6

    def busy_s(self) -> float:
        """Seconds of the window in which some device op ran."""
        return self.window_s - sum(b - a for a, b in self.gaps()) / 1e6

    def kernels(self, *needles: str) -> list[Op]:
        """Device ops whose name holds any of ``needles``."""
        return [o for o in self.device_ops
                if any(n in o.name for n in needles)]

    def launched_under(self, prefix: str) -> list[Op]:
        """Device ops launched while a host range named ``prefix...`` was
        open on the launching thread."""
        spans = [r for r in self.ranges if r.name.startswith(prefix)]
        out = []
        for o in self.device_ops:
            launch = self.launches.get(o.link)
            if launch and any(s.tid == launch.tid
                              and s.start <= launch.start <= s.end
                              for s in spans):
                out.append(o)
        return out

    def gaps(self) -> list[tuple[float, float]]:
        """The window's stretches with no device op, longest first."""
        out, reach = [], self.window[0]
        for o in sorted(self.device_ops, key=lambda o: o.start):
            if o.start > reach:
                out.append((reach, o.start))
            reach = max(reach, o.end)
        if self.window[1] > reach:
            out.append((reach, self.window[1]))
        return sorted(out, key=lambda g: g[0] - g[1])

    def host_at(self, t: float) -> str:
        """The innermost host operator or range open at time ``t``."""
        best = None
        for o in (*self.cpu_ops, *self.ranges):
            if o.start <= t <= o.end and (best is None
                                          or o.start > best.start):
                best = o
        return best.name if best else "idle host"

    def breakdown(self, top: int = 10) -> dict[str, list]:
        """The device ops with most time (by name) and the longest idle
        gaps, each named by what the host was launching when it ended."""
        by_name: dict[str, float] = {}
        for o in self.device_ops:
            by_name[o.name] = (by_name.get(o.name, 0.0)
                               + (o.end - o.start) / 1e6)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        starts = sorted(self.device_ops, key=lambda o: o.start)
        keys = [o.start for o in starts]
        gaps = []
        for a, b in self.gaps()[:top]:
            i = bisect.bisect_left(keys, b)
            launch = (self.launches.get(starts[i].link)
                      if i < len(starts) else None)
            label = (self.host_at(launch.start) if launch
                     else self.host_at((a + b) / 2))
            gaps.append([label, (b - a) / 1e6])
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[n[:120], s] for n, s in gaps]}


def load(path, steps: int, counts: dict, peaks) -> Trace:
    """Read a profiler trace exported with ``export_chrome_trace``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, launches, ranges, cpu_ops, window = [], {}, [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args", {})
        op = Op(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                args.get("correlation"), e.get("tid"))
        if cat in DEVICE_CATEGORIES:
            device.append(op)
        elif cat in LAUNCH_CATEGORIES:
            launches[op.link] = op
        elif cat == "user_annotation":
            if e["name"] == WINDOW:
                window = (op.start, op.end)
            ranges.append(op)
        elif cat == "cpu_op":
            cpu_ops.append(op)
    if window is None:
        raise ValueError(f"{path}: no {WINDOW} range in the trace")
    device = [o for o in device if o.end > window[0] and o.start < window[1]]
    return Trace(device, launches, ranges, cpu_ops, window, steps, counts,
                 peaks)
