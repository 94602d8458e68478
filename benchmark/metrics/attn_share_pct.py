"""attn_share_pct: the port's attention kernels' share of all device
time of the traced steps, in %."""

KERNELS = ("flash::flash_", "_ZN5flash")


def read(trace):
    ops = trace.kernels(*KERNELS)
    if not ops:
        return None
    return 100.0 * trace.device_s(ops) / trace.device_s()
