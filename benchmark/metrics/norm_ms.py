"""norm_ms: device time a step of the ops launched under the port's
``model.norm`` and ``model.norm.bwd`` ranges (every RMSNorm, forward and
backward), in ms."""

from benchmark import spans

RANGE = "model.norm"


def read(trace):
    if not spans.found(trace, RANGE):
        return None
    return spans.per_step_ms(trace, trace.launched_under(RANGE))
