"""device_idle_pct: the share of the traced window that no kernel, copy
or memory set covers, in %."""


def read(trace):
    if not trace.device_ops:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
