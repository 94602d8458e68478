"""The readers of the port's own spans (``benchmark/spans.py`` and the six
``benchmark/metrics/`` files that use it), held to arithmetic done by hand
on a made-up trace: a main thread that holds the step's ranges and an
autograd thread that holds the backward's, launches inside and outside
each range, and one launch blocked on a full launch queue a step."""

import pytest

from benchmark import spans, spec
from benchmark import trace as trace_lib

MAIN, AUTOGRAD = 1, 2
SIX = ("forward_ms", "backward_ms", "loss_ms", "norm_ms", "attn_glue_ms",
       "host_busy_ms")
# (thread, launch time, kernel, kernel's microseconds), a step from t0
LAUNCHES = [
    (MAIN, 2, "memset_zero_grad", 1),            # in the step alone
    (MAIN, 15, "nvjet_tst_fwd", 10),              # forward
    (MAIN, 25, "rms_norm_elementwise", 4),        # forward, norm
    (MAIN, 55, "void flash::flash_fwd_wgmma_kernel<128>", 6),  # attn.core
    (MAIN, 60, "copy_layout", 2),                 # attn.core, glue
    (MAIN, 160, "log_softmax", 3),                # forward, loss
    (AUTOGRAD, 170, "stray", 2),                  # another thread's
    (MAIN, 212, "fill_ones", 1),                  # backward, main thread
    (AUTOGRAD, 225, "log_softmax_backward", 3),   # loss.bwd
    (AUTOGRAD, 260, "nvjet_tst_bwd", 20),         # backward
    (AUTOGRAD, 305, "_ZN5flash19flash_bwd_dq", 12),  # attn.core.bwd
    (AUTOGRAD, 310, "copy_layout_bwd", 5),        # attn.core.bwd, glue
    (AUTOGRAD, 385, "rms_norm_backward", 7),      # norm.bwd
    (AUTOGRAD, 410, "blocked_gemm", 9),           # backward, blocked
    (MAIN, 470, "multi_tensor_apply_kernel", 8),  # optimizer
]
RANGES = [
    (MAIN, "train.step", 0, 500), (MAIN, "train.forward", 10, 200),
    (MAIN, "model.norm", 20, 40), (MAIN, "attn.core", 50, 80),
    (MAIN, "train.loss", 150, 190), (MAIN, "train.backward", 210, 450),
    (AUTOGRAD, "train.loss.bwd", 220, 240),
    (AUTOGRAD, "attn.core.bwd", 300, 340),
    (AUTOGRAD, "model.norm.bwd", 380, 400),
    (MAIN, "Optimizer.step#AdamW.step", 460, 490),
]
BLOCKED_US = (30, 50)        # the blocked launch's own time, step by step
STEP_US = 1000


def made_up(with_spans: bool = True) -> trace_lib.Trace:
    op = trace_lib.Op
    device, launches, ranges = [], {}, []
    for s, blocked in enumerate(BLOCKED_US):
        t0 = s * STEP_US
        for i, (tid, at, kernel, us) in enumerate(LAUNCHES):
            link = 100 * s + i
            took = 1 + (blocked if kernel == "blocked_gemm" else 0)
            launches[link] = op("cudaLaunchKernel", t0 + at, t0 + at + took,
                                link, tid)
            start = t0 + 600 + 20 * i
            device.append(op(kernel, start, start + us, link))
        ranges += [op(name, t0 + a, t0 + b, None, tid)
                   for tid, name, a, b in RANGES
                   if with_spans or name.startswith("Optimizer")]
    ranges.append(op(trace_lib.WINDOW, 0.0, 2 * STEP_US, None, MAIN))
    return trace_lib.Trace(device, launches, ranges, [],
                           (0.0, 2.0 * STEP_US), 2, {}, None)


def _read(name, tr):
    return spec.metric_reader(name)(tr)


def test_each_reader_by_hand():
    tr = made_up()
    # main thread under train.forward: 10 + 4 + 6 + 2 + 3 us a step
    assert _read("forward_ms", tr) == pytest.approx(25e-3)
    # any thread inside train.backward: 1 + 3 + 20 + 12 + 5 + 7 + 9
    assert _read("backward_ms", tr) == pytest.approx(57e-3)
    # train.loss 3 + train.loss.bwd 3; the other thread's stray 2 is not
    assert _read("loss_ms", tr) == pytest.approx(6e-3)
    assert _read("norm_ms", tr) == pytest.approx(11e-3)
    # attn.core*: 6 + 2 + 12 + 5, less the two flash kernels
    assert _read("attn_glue_ms", tr) == pytest.approx(7e-3)
    # 500 us a step less the blocked launch's 30 and 50 us beyond the
    # median launch (1 us): median of 470 and 450
    assert _read("host_busy_ms", tr) == pytest.approx(0.46)
    assert _read("optimizer_ms", tr) == pytest.approx(8e-3)


def test_the_three_phases_leave_out_only_what_no_phase_holds():
    tr = made_up()
    covered = sum(_read(n, tr) for n in ("forward_ms", "backward_ms",
                                         "optimizer_ms"))
    total = spans.per_step_ms(tr, tr.device_ops)
    assert total - covered == pytest.approx(3e-3)   # zero_grad's, stray


def test_glue_and_kernels_make_up_the_attention_spans():
    tr = made_up()
    flash = spans.per_step_ms(tr, tr.kernels("flash::flash_", "_ZN5flash"))
    core = spans.per_step_ms(tr, tr.launched_under("attn.core"))
    assert _read("attn_glue_ms", tr) + flash == pytest.approx(core)


def test_launched_within_takes_every_thread_and_only_the_interval():
    tr = made_up()
    names = {o.name for o in spans.launched_within(tr, "train.backward")}
    assert "fill_ones" in names and "blocked_gemm" in names
    assert not names & {"stray", "log_softmax", "multi_tensor_apply_kernel"}
    assert {o.name for o in tr.launched_under("train.backward")} == {
        "fill_ones"}


@pytest.mark.parametrize("name", SIX)
def test_a_program_without_spans_gives_no_reading(name):
    assert _read(name, made_up(with_spans=False)) is None


@pytest.mark.parametrize("name", SIX)
def test_a_trace_with_no_device_op_gives_no_reading(name):
    tr = made_up()
    tr.device_ops = []
    assert _read(name, tr) is None
