"""What the readers of the program's own spans share.

The port's training step opens ``torch.profiler`` ranges at its layers'
boundaries (``gpumounter_tpu_torch/utils/trace.py``, ``region``):
``train.step``, ``train.forward``, ``train.loss``, ``train.backward``,
``model.norm`` and ``attn.core``, and on the thread that runs the
backward ``train.loss.bwd``, ``model.norm.bwd`` and ``attn.core.bwd``.
Ops launched on the thread that holds a range are
:meth:`benchmark.trace.Trace.launched_under` it. The backward's own range,
``train.backward``, stands on the main thread while the autograd engine
launches the backward from another, so :func:`launched_within` counts
launches from any thread inside a range's interval.

A program that opens none of these ranges (one older than its spans)
gives no reading: each reader returns None where :func:`found` is false.
"""

from __future__ import annotations

import bisect


def found(trace, prefix: str) -> bool:
    """True where the traced steps ran on a device and hold a range named
    ``prefix...``."""
    return (trace.steps > 0 and bool(trace.device_ops)
            and any(r.name.startswith(prefix) for r in trace.ranges))


def _merged(ranges) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for start, end in sorted((r.start, r.end) for r in ranges):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def launched_within(trace, prefix: str) -> list:
    """Device ops launched, from any thread, while a range named
    ``prefix...`` was open on some thread."""
    spans = _merged(r for r in trace.ranges if r.name.startswith(prefix))
    starts = [a for a, _ in spans]
    out = []
    for o in trace.device_ops:
        launch = trace.launches.get(o.link)
        if launch is None:
            continue
        i = bisect.bisect_right(starts, launch.start) - 1
        if i >= 0 and launch.start <= spans[i][1]:
            out.append(o)
    return out


def launches(trace) -> list:
    """The host's calls that enqueued the window's device ops, on every
    thread."""
    links = {o.link for o in trace.device_ops}
    return [op for link, op in trace.launches.items() if link in links]


def per_step_ms(trace, ops) -> float:
    """Device time of ``ops`` a traced step, in ms."""
    return 1e3 * trace.device_s(ops) / trace.steps
