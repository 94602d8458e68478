"""AST lints pinning the port's checkpoint deletion discipline — the
drain/federation lints of ``tests/test_federation_lint.py``, applied to
``gpumounter_tpu_torch/torchcheck/drain.py`` and ``federation.py``:

1. In drain.py every deletion call (unlink/remove/rmtree/rmdir) is
   confined to the commit path (``_prune_generations``, reached only from
   ``commit_manifest``), the atomic writer's failed-tmp cleanup, and the
   legacy cycle's own tmp file: a deletion reachable from a restore could
   destroy the sole surviving copy of the state exactly when it is needed.
2. Pruning is reached only from the commit.
3. The restore-path functions exist and never delete.
4. The member side (federation.py) deletes nothing.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DELETERS = {"os.unlink", "os.remove", "os.rmdir", "shutil.rmtree"}


def _parse(name):
    path = os.path.join(ROOT, "gpumounter_tpu_torch", "torchcheck", name)
    with open(path) as f:
        return ast.parse(f.read(), filename=path)


def _functions(tree):
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(node.name, []).append(node)
    return out


def _call_names(node):
    """Dotted names of every call inside ``node``."""
    names = []
    for call in ast.walk(node):
        if not isinstance(call, ast.Call):
            continue
        parts = []
        f = call.func
        while isinstance(f, ast.Attribute):
            parts.append(f.attr)
            f = f.value
        if isinstance(f, ast.Name):
            parts.append(f.id)
        names.append(".".join(reversed(parts)))
    return names


def test_drain_deletions_confined_to_the_commit_path():
    allowed = {"_prune_generations", "_atomic_write", "drain_restore_cycle"}
    offenders = {}
    for name, defs in _functions(_parse("drain.py")).items():
        for fn in defs:
            hits = [c for c in _call_names(fn) if c in _DELETERS]
            if hits and name not in allowed:
                offenders[name] = hits
    assert not offenders, (
        f"deletion calls outside the sanctioned commit path: {offenders}")


def test_prune_reached_only_from_commit():
    callers = [name for name, defs in _functions(_parse("drain.py")).items()
               for fn in defs if name != "_prune_generations"
               and any(c.endswith("_prune_generations")
                       for c in _call_names(fn))]
    assert callers == ["commit_manifest"], (
        f"_prune_generations called from {callers}; pruning may run ONLY "
        "inside the commit (after manifest + LATEST are durable)")


@pytest.mark.parametrize("required", [
    "restore_sharded", "restore_last_good", "_load_generation",
    "_verify_shards", "restore"])
def test_restore_paths_exist_and_never_delete(required):
    functions = _functions(_parse("drain.py"))
    assert required in functions, f"missing {required}"
    for fn in functions[required]:
        assert not any(c in _DELETERS for c in _call_names(fn))


def test_federation_module_never_deletes_checkpoints():
    hits = [c for c in _call_names(_parse("federation.py"))
            if c in _DELETERS]
    assert hits == [], f"federation.py deletes files: {hits}"
