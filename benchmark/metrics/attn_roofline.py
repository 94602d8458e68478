"""attn_roofline: the least time of the traced steps' attention,
forward and backward, over the device time of the port's attention
kernels, in %. The least time is the larger of the operations (causal
pairs only) over the peak rate and the bytes (q, k, v, o, do, dq, dk, dv
once each and the log-sum-exp) over the peak bandwidth."""

KERNELS = ("flash::flash_", "_ZN5flash")


def read(trace):
    ops = trace.kernels(*KERNELS)
    if not ops or trace.peaks is None:
        return None
    least = max(trace.counts["attn_flops"] / trace.peaks["flops"],
                trace.counts["attn_bytes"] / trace.peaks["bytes"])
    return 100.0 * least * trace.steps / trace.device_s(ops)
