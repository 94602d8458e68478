"""gemm_roofline: the model's matrix-product operations without
attention, at the card's peak, over the device time of the GEMM kernels
(cuBLAS's, named as below), in %. Every such product here does at least
a thousand operations a byte, so the operations bound it."""

KERNELS = ("gemm", "nvjet", "xmma", "splitKreduce")


def read(trace):
    ops = trace.kernels(*KERNELS)
    if not ops or trace.peaks is None:
        return None
    least = trace.counts["gemm_flops"] / trace.peaks["flops"]
    return 100.0 * least * trace.steps / trace.device_s(ops)
