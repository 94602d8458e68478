"""Nothing under benchmark/ imports JAX or the JAX package, and the plain
references import nothing of the port either. Top-level module names (the
part before the first dot) are compared whole: the port's name begins with
the JAX package's."""

import ast
import subprocess
import sys

import pytest

from benchmark import run, spec

FILES = sorted((spec.ROOT / spec.PACKAGE).rglob("*.py"))
EVERYWHERE = ("jax", "jaxlib", "flax", "gpumounter_tpu")
IN_REFERENCE = EVERYWHERE + ("gpumounter_tpu_torch", "benchmark")


def imported(path) -> list[tuple[int, str]]:
    """(line, top-level name) of every absolute import in ``path``."""
    out = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name.split(".")[0]) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append((node.lineno, node.module.split(".")[0]))
    return out


def forbidden_in(path) -> tuple[str, ...]:
    rel = path.relative_to(spec.ROOT / spec.PACKAGE)
    return IN_REFERENCE if rel.parts[0] == "reference" else EVERYWHERE


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(spec.ROOT)))
def test_no_forbidden_import(path):
    bad = [(line, name) for line, name in imported(path)
           if name in forbidden_in(path)]
    assert not bad, f"{path.name} imports {bad}"


def test_the_check_compares_whole_top_level_names(tmp_path):
    """``gpumounter_tpu_torch`` is not ``gpumounter_tpu``, ``jaxtyping`` is
    not ``jax``; but ``jax.numpy`` is ``jax``."""
    src = tmp_path / "x.py"
    src.write_text("import jaxtyping\nimport gpumounter_tpu_torch.kernels\n"
                   "from jax import numpy\nimport jax.numpy as jnp\n")
    names = [n for _, n in imported(src)]
    assert [n for n in names if n in EVERYWHERE] == ["jax", "jax"]


def test_a_run_loads_no_forbidden_module():
    """What the harness, the reference and the port load, in a fresh
    interpreter, holds none of the forbidden names."""
    code = ("import sys\n"
            "import benchmark.run, benchmark.calibrate\n"
            "import benchmark.reference.decoder_lm\n"
            "import gpumounter_tpu_torch.torchcheck.train\n"
            "import gpumounter_tpu_torch.torchcheck.flash_attention\n"
            "print(benchmark.run._forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    assert set(run.FORBIDDEN) == set(EVERYWHERE)
