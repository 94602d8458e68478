"""host_busy_ms: the host's own work a step, in ms: the median over the
traced steps of the port's ``train.step`` range, less the time each
launch inside it (on any thread) took beyond the median launch, which is
the host blocked on a full launch queue. The profiler's own cost a call
stays in, so it is an upper bound."""

import statistics

from benchmark import spans

RANGE = "train.step"


def read(trace):
    lo, hi = trace.window
    steps = [r for r in trace.ranges
             if r.name == RANGE and lo <= r.start and r.end <= hi]
    calls = spans.launches(trace)
    inside = [[c for c in calls if s.start <= c.start <= s.end]
              for s in steps]
    every = [c.end - c.start for cs in inside for c in cs]
    if not every:
        return None
    usual = statistics.median(every)
    return 1e-3 * statistics.median(
        (s.end - s.start) - sum(max(0.0, c.end - c.start - usual)
                                for c in cs)
        for s, cs in zip(steps, inside))
