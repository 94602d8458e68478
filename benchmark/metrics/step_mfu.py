"""step_mfu: the model operations of the traced steps (``model_flops``
of the program's ``step_counts``: GEMMs and causal attention, no
recompute) over the traced window's time and the card's peak, in %."""


def read(trace):
    if trace.peaks is None or trace.steps == 0:
        return None
    flops = trace.counts["model_flops"] * trace.steps
    return 100.0 * flops / trace.window_s / trace.peaks["flops"]
