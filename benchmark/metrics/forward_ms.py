"""forward_ms: device time a step of the ops launched under the port's
``train.forward`` range (the model's forward and its loss), in ms."""

from benchmark import spans

RANGE = "train.forward"


def read(trace):
    if not spans.found(trace, RANGE):
        return None
    return spans.per_step_ms(trace, trace.launched_under(RANGE))
