"""attn_glue_ms: device time a step of the ops launched under the port's
``attn.core`` and ``attn.core.bwd`` ranges that are not one of its three
flash kernels (named as ``attn_roofline`` finds them): the layout copies,
casts, normalisation, log-sum-exp and ``drow`` around the kernels, in ms."""

from benchmark import spans

RANGE = "attn.core"
KERNELS = ("flash::flash_", "_ZN5flash")


def read(trace):
    if not spans.found(trace, RANGE):
        return None
    return spans.per_step_ms(trace, [
        o for o in trace.launched_under(RANGE)
        if not any(n in o.name for n in KERNELS)])
