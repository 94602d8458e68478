"""backward_ms: device time a step of the ops launched, from any thread,
while the port's ``train.backward`` range was open (the whole backward:
the main thread waits in it while the autograd engine launches), in ms."""

from benchmark import spans

RANGE = "train.backward"


def read(trace):
    if not spans.found(trace, RANGE):
        return None
    return spans.per_step_ms(trace, spans.launched_within(trace, RANGE))
