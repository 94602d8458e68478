"""The training step's profiler ranges (``utils/trace.py``, ``region``).

Two steps of a tiny ``make_train_step(cfg, attn_impl="flash")`` run under
``torch.profiler`` and again without it, from the same weights and
batches. Under the profiler every range of the step appears its number of
times a step, the backward's ``.bwd`` ranges on the one thread that runs
the backward inside ``train.backward``; without it no range opens and no
gradient hook is set; either way the autograd graph is the same and the
losses and parameters are bitwise equal. On the CPU the flash path runs
the kernels' plain versions; the ``gpu`` case runs the CUDA kernels, where
the backward has a thread of its own. Imports no jax.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gpumounter_tpu_torch.torchcheck import model as model_lib
from gpumounter_tpu_torch.torchcheck import train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = model_lib.ModelConfig(vocab=64, d_model=32, n_heads=2, n_layers=2,
                            d_ff=64)
STEPS = 2
# ranges a step, with the backward's
PER_STEP = {"train.step": 1, "train.forward": 1, "train.loss": 1,
            "train.loss.bwd": 1, "train.backward": 1,
            "model.norm": 2 * CFG.n_layers + 1,
            "model.norm.bwd": 2 * CFG.n_layers + 1,
            "attn.core": CFG.n_layers, "attn.core.bwd": CFG.n_layers}
FORWARD = ("model.norm", "attn.core", "train.loss")


def _steps(cfg, device, profiled: bool, trace_path=None, batch=2, seq=128):
    """(losses, parameters) after ``STEPS`` steps from seed 0, and the
    ranges (name, thread, start, end) the profiler recorded."""
    state = train.init_state(cfg, seed=0, device=device)
    step = train.make_train_step(cfg, attn_impl="flash")
    generator = torch.Generator(device=device).manual_seed(1)
    batches = [train.make_batch(generator, batch, seq, cfg.vocab)
               for _ in range(STEPS)]
    losses = []
    if profiled:
        activities = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            for tokens in batches:
                state, loss = step(state, tokens)
                losses.append(loss)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
        prof.export_chrome_trace(str(trace_path))
        with open(trace_path) as f:
            events = json.load(f)["traceEvents"]
        ranges = [(e["name"], e["tid"], float(e["ts"]),
                   float(e["ts"]) + float(e["dur"])) for e in events
                  if e.get("cat") == "user_annotation"]
    else:
        for tokens in batches:
            state, loss = step(state, tokens)
            losses.append(loss)
        ranges = []
    return (torch.stack(losses).cpu(),
            [p.detach().cpu() for p in state.model.parameters()], ranges)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = tmp_path_factory.mktemp("spans") / "trace.json"
    return _steps(CFG, "cpu", True, path), _steps(CFG, "cpu", False)


def _named(ranges, name):
    return [r for r in ranges if r[0] == name]


def _assert_bwd_inside_backward(ranges):
    backward = _named(ranges, "train.backward")
    bwd = [r for r in ranges if r[0].endswith(".bwd")]
    assert bwd and len({r[1] for r in bwd}) == 1
    for r in bwd:
        assert any(b[2] <= r[2] and r[3] <= b[3] for b in backward), r


@pytest.mark.parametrize("name", sorted(PER_STEP))
def test_every_range_appears_its_number_of_times_a_step(runs, name):
    (_, _, ranges), _ = runs
    assert len(_named(ranges, name)) == STEPS * PER_STEP[name]


def test_the_backward_ranges_lie_on_one_thread_inside_train_backward(runs):
    (_, _, ranges), _ = runs
    _assert_bwd_inside_backward(ranges)


def test_the_forward_ranges_lie_inside_train_forward_inside_the_step(runs):
    (_, _, ranges), _ = runs
    steps = _named(ranges, "train.step")
    forward = _named(ranges, "train.forward")
    assert all(any(s[2] <= f[2] and f[3] <= s[3] for s in steps)
               for f in forward + _named(ranges, "train.backward"))
    for name in FORWARD:
        for r in _named(ranges, name):
            assert any(f[1] == r[1] and f[2] <= r[2] and r[3] <= f[3]
                       for f in forward), r


def test_losses_and_parameters_are_bitwise_equal_with_and_without(runs):
    (loss_on, params_on, _), (loss_off, params_off, _) = runs
    assert torch.equal(loss_on, loss_off)
    assert all(torch.equal(a, b) for a, b in zip(params_on, params_off))


def test_without_a_profiler_no_range_opens_and_no_hook_is_set(monkeypatch):
    opened, hooked = [], []
    record_function = torch.autograd.profiler.record_function
    register_hook = torch.Tensor.register_hook

    def counting_range(name, *args):
        opened.append(name)
        return record_function(name, *args)

    def counting_hook(self, hook):
        hooked.append(hook)
        return register_hook(self, hook)

    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counting_range)
    monkeypatch.setattr(torch.Tensor, "register_hook", counting_hook)
    _steps(CFG, "cpu", False)
    # PyTorch's optimizer opens its own ranges whatever runs
    assert [n for n in opened if not n.startswith("Optimizer.")] == []
    assert hooked == []
    with profile(activities=[ProfilerActivity.CPU]):
        _steps(CFG, "cpu", False)
    assert set(opened) >= set(PER_STEP)
    assert len(hooked) == 2 * (PER_STEP["model.norm"] + 1) * STEPS


def _graph(profiled: bool) -> collections.Counter:
    """The node types of one forward's autograd graph, counted."""
    model = model_lib.Transformer(CFG, device="cpu")
    attn = model_lib.make_attention(None, CFG, impl="flash")
    tokens = train.make_batch(torch.Generator().manual_seed(1), 2, 128,
                              CFG.vocab)

    def build():
        logits = model_lib.forward(model, tokens, CFG, attn_fn=attn)
        return train.cross_entropy(logits, tokens)

    if profiled:
        with profile(activities=[ProfilerActivity.CPU]):
            loss = build()
    else:
        loss = build()
    seen, todo, kinds = set(), [loss.grad_fn], collections.Counter()
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        kinds[type(node).__name__] += 1
        todo += [n for n, _ in node.next_functions]
    return kinds


def test_the_ranges_add_no_node_to_the_autograd_graph():
    off = _graph(False)
    assert off and off == _graph(True)


def test_the_trace_module_imports_where_torch_cannot_be_imported():
    code = ("import sys\n"
            "sys.modules['torch'] = None\n"
            "from gpumounter_tpu_torch.utils import trace\n"
            "with trace.region('train.step') as r:\n"
            "    assert r.carry(1, 2) == 2\n"
            "assert sys.modules['torch'] is None\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "ok"


@pytest.mark.gpu
def test_on_the_card_the_ranges_and_the_numbers_hold(tmp_path):
    """The CUDA kernels in bf16 at head_dim 128: the backward's ranges on
    the autograd engine's own thread, inside ``train.backward``; losses
    and parameters bitwise equal with and without the profiler."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    cfg = model_lib.ModelConfig(vocab=512, d_model=256, n_heads=2,
                                n_layers=2, d_ff=1024, dtype=torch.bfloat16)
    loss_on, params_on, ranges = _steps(cfg, "cuda", True,
                                        tmp_path / "trace.json", 2, 512)
    loss_off, params_off, _ = _steps(cfg, "cuda", False, batch=2, seq=512)
    assert torch.equal(loss_on, loss_off)
    assert all(torch.equal(a, b) for a, b in zip(params_on, params_off))
    _assert_bwd_inside_backward(ranges)
    main = {r[1] for r in _named(ranges, "train.step")}
    assert {r[1] for r in ranges if r[0].endswith(".bwd")}.isdisjoint(main)
    counts = collections.Counter(r[0] for r in ranges)
    assert counts["model.norm.bwd"] == STEPS * (2 * cfg.n_layers + 1)
    assert counts["attn.core.bwd"] == STEPS * cfg.n_layers
