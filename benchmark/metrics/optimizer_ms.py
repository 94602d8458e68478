"""optimizer_ms: device time per step of the kernels launched inside
PyTorch's own ``Optimizer.step#AdamW.step`` range, in ms."""

RANGE = "Optimizer.step#"


def read(trace):
    ops = trace.launched_under(RANGE)
    if not ops or trace.steps == 0:
        return None
    return 1e3 * trace.device_s(ops) / trace.steps
