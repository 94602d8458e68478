"""The port's copy of tests/test_informer_lint.py, held against
``gpumounter_tpu_torch`` with the port's names (``GPUMountService``,
``GPUAllocator``, ``GPUMounter``, ``add_gpu``). Imports no jax.

Informer lint (AST-based, à la test_retry_lint): hot-path modules must
not read pods from the apiserver client directly — every pod read goes
through the informer handle (``self.reads``, k8s/informer.py), so the
zero-LIST attach budget cannot silently regress by someone adding a
``self.kube.list_pods(...)`` call back.

Writes (create/patch/delete) stay on the client by design — they must hit
the apiserver — and the informer module itself plus the background
reconciler (not on the attach path) are the only non-client holders of
raw list/watch calls.
"""

import ast
import inspect

import gpumounter_tpu_torch.allocator.allocator as allocator_mod
import gpumounter_tpu_torch.k8s.informer as informer_mod
import gpumounter_tpu_torch.worker.pool as pool_mod
import gpumounter_tpu_torch.worker.service as service_mod

HOT_PATH_MODULES = (allocator_mod, pool_mod, service_mod)

READ_VERBS = {"list_pods", "list_pods_with_version", "watch_pods"}


def _receiver_name(node: ast.AST) -> str:
    """Best-effort dotted receiver of an attribute access:
    ``self.kube.list_pods`` -> "self.kube"."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _read_calls_on_kube(module) -> list[str]:
    tree = ast.parse(inspect.getsource(module))
    offenders = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Attribute):
            continue
        if node.attr not in READ_VERBS:
            continue
        receiver = _receiver_name(node.value)
        # any receiver that IS (or holds) the raw client: self.kube,
        # kube, sim.kube, self.sim.kube ...
        if receiver == "kube" or receiver.endswith(".kube"):
            offenders.append(f"{module.__name__}: {receiver}.{node.attr}")
    return offenders


def test_hot_path_modules_never_list_pods_on_the_client():
    offenders = [o for module in HOT_PATH_MODULES
                 for o in _read_calls_on_kube(module)]
    assert offenders == [], \
        f"pod reads bypass the informer handle: {offenders}"


def test_hot_path_modules_read_through_the_handle():
    """The positive half: each hot-path module actually holds and uses a
    ``reads`` handle (not just avoids the client)."""
    for module in HOT_PATH_MODULES:
        tree = ast.parse(inspect.getsource(module))
        uses = [n for n in ast.walk(tree)
                if isinstance(n, ast.Attribute)
                and isinstance(n.value, ast.Attribute)
                and n.value.attr == "reads"]
        assert uses, f"{module.__name__} never reads through the handle"


def test_informer_owns_the_shared_list_watch():
    """Inside k8s/informer.py, raw client list/watch calls live in exactly
    the stream machinery: the informer's seed/loop and the legacy
    (informer-less) wait fallback — nowhere else."""
    tree = ast.parse(inspect.getsource(informer_mod))
    holders = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for inner in ast.walk(node):
                if isinstance(inner, ast.Attribute) \
                        and inner.attr in READ_VERBS \
                        and _receiver_name(inner.value).endswith("kube"):
                    holders.add(node.name)
    assert holders <= {"_resync", "_run", "_wait_pods_watch", "sync",
                       "get_pod", "list_pods", "list_pods_with_version"}, \
        holders


def test_wait_state_machines_use_the_handle():
    """The allocator's create/delete waits and the pool's refill wait ride
    the shared stream (reads.wait_pods), not private watches."""
    import textwrap
    for module, method in ((allocator_mod, "_wait_running"),
                           (allocator_mod, "_wait_deleted"),
                           (pool_mod, "_await_running")):
        cls = {"allocator": "GPUAllocator",
               "pool": "PoolManager"}[module.__name__.rsplit(".", 1)[-1]]
        source = textwrap.dedent(inspect.getsource(
            getattr(getattr(module, cls), method)))
        tree = ast.parse(source)
        names = {n.attr for n in ast.walk(tree)
                 if isinstance(n, ast.Attribute)}
        assert "wait_pods" in names, f"{cls}.{method} bypasses wait_pods"
