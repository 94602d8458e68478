"""loss_ms: device time a step of the ops launched under the port's
``train.loss`` and ``train.loss.bwd`` ranges (the f32 next-token
cross-entropy, forward and backward), in ms."""

from benchmark import spans

RANGE = "train.loss"


def read(trace):
    if not spans.found(trace, RANGE):
        return None
    return spans.per_step_ms(trace, trace.launched_under(RANGE))
