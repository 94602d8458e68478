"""The port stands alone: no module of gpumounter_tpu_torch, and not
chip_smoke.py, imports jax, optax or the JAX package; and its entry points
run on the GPU or raise, unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "gpumounter_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "optax", "gpumounter_tpu")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_no_forbidden_module_loaded_at_run_time():
    """Import every port module and chip_smoke in a fresh interpreter, then
    check what actually landed in sys.modules."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT_FILES if p.name != "chip_smoke.py")
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]


def test_parallel_entry_points_raise_without_a_gpu(monkeypatch):
    """The entry points of the parallel schemes default to the GPU and
    never fall back to the CPU (``device="cpu"`` runs them in gloo
    worlds: tests/test_torch_parallel.py, test_torch_moe_pipeline.py)."""
    import torch

    from gpumounter_tpu_torch import entry
    from gpumounter_tpu_torch.torchcheck import dist, model, moe, pipeline
    from gpumounter_tpu_torch.torchcheck import probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "entry": lambda: entry.entry(),
        "dryrun_multichip": lambda: entry.dryrun_multichip(2),
        "run_world": lambda: dist.run_world(2, _never_called),
        "make_mesh": lambda: model.make_mesh(),
        "init_moe_params": lambda: moe.init_moe_params(moe.MoEConfig()),
        "make_mlp_layers": lambda: pipeline.make_mlp_layers(2, 8),
        "validate_training": lambda: probe.validate_training(n_devices=2),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    fn, (net, tokens) = entry.entry(device="cpu")
    assert fn(net, tokens).shape == (2, 32, 64)
    assert moe.init_moe_params(moe.MoEConfig(), device="cpu")["w1"].shape \
        == (4, 64, 128)
    assert len(pipeline.make_mlp_layers(2, 8, device="cpu")) == 2


def _never_called(device):
    raise AssertionError("a world started without a GPU")
