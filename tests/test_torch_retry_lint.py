"""The port's copy of tests/test_retry_lint.py, held against
``gpumounter_tpu_torch`` with the port's names (``GPUMountService``,
``GPUAllocator``, ``GPUMounter``, ``add_gpu``). Imports no jax.

Retry-layer lint (à la test_metrics_lint): every apiserver / kubelet
network call site must go through the unified retry layer
(utils/retry.py) — no raw one-shot escapes.

The invariant is structural, so it is enforced structurally: the modules
that own network I/O each expose exactly one raw one-shot seam
(``_request_once`` / ``_*_once``), referenced ONLY by the retrying
wrapper above it. A new verb added without retry wiring, or a helper
that starts calling the raw seam directly, fails this suite instead of
shipping a one-shot call that dies on the first transient 500.
"""

import ast
import inspect
import textwrap

from gpumounter_tpu_torch.collector import podresources
from gpumounter_tpu_torch.k8s import client
from gpumounter_tpu_torch.master import gateway


def _functions(module) -> dict[str, ast.AST]:
    """{qualified name: funcdef} for every function/method in the module."""
    tree = ast.parse(inspect.getsource(module))
    out = {}

    def walk(node, prefix=""):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out[prefix + child.name] = child
                walk(child, prefix + child.name + ".")
            elif isinstance(child, ast.ClassDef):
                walk(child, prefix + child.name + ".")
            else:
                walk(child, prefix)
    walk(tree)
    return out


def _names_used(funcdef) -> set[str]:
    """Attribute and bare names referenced anywhere inside the function."""
    names = set()
    for node in ast.walk(funcdef):
        if isinstance(node, ast.Attribute):
            names.add(node.attr)
        elif isinstance(node, ast.Name):
            names.add(node.id)
    return names


def _referencing_functions(module, name: str) -> set[str]:
    """Qualified names of functions whose body references ``name``
    (excluding the definition of ``name`` itself). Nested helpers are
    reported as their enclosing method (Class.method)."""
    hits = set()
    for qual, funcdef in _functions(module).items():
        if qual.endswith("." + name) or qual == name:
            continue
        if name in _names_used(funcdef):
            hits.add(".".join(qual.split(".")[:2]))
    return hits


# -- k8s/client.py: the apiserver REST client ----------------------------------

def test_urlopen_is_confined_to_the_one_shot_request():
    """The raw HTTP round-trip lives in exactly one place."""
    hits = _referencing_functions(client, "urlopen")
    assert hits == {"RestKubeClient._request_once"}, hits


def test_request_once_is_only_called_by_the_retrying_wrapper():
    hits = _referencing_functions(client, "_request_once")
    assert hits == {"RestKubeClient._request"}, hits


def test_rest_request_goes_through_the_retry_layer():
    funcs = _functions(client)
    assert "call_with_retry" in _names_used(
        funcs["RestKubeClient._request"])


def test_rest_watch_uses_the_resume_layer():
    funcs = _functions(client)
    assert "_resilient_watch" in _names_used(
        funcs["RestKubeClient.watch_pods"])
    # the one-shot stream is only consumed by the resuming watch
    hits = _referencing_functions(client, "_watch_stream")
    assert hits == {"RestKubeClient.watch_pods"}, hits


def test_fake_client_verbs_all_go_through_the_retry_layer():
    """The fake must carry the retry layer like it carries the k8s_call
    instrumentation — chaos tests prove nothing about production
    otherwise. Every public verb delegates to self._retry; every one-shot
    body consults the fault injector."""
    funcs = _functions(client)
    verbs = {"get_pod": "_get_pod_once",
             "list_pods_with_version": "_list_pods_once",
             "create_pod": "_create_pod_once",
             "delete_pod": "_delete_pod_once",
             "patch_pod": "_patch_pod_once",
             "get_node": "_get_node_once",
             "create_event": "_create_event_once"}
    for verb, once_name in verbs.items():
        names = _names_used(funcs[f"FakeKubeClient.{verb}"])
        assert "_retry" in names, f"FakeKubeClient.{verb} bypasses _retry"
        once = _names_used(funcs[f"FakeKubeClient.{once_name}"])
        assert "_fault" in once, \
            f"FakeKubeClient.{once_name} skips fault injection"
    assert "_resilient_watch" in _names_used(
        funcs["FakeKubeClient.watch_pods"])


def test_no_module_retries_around_the_retrying_client():
    """Nested retry loops multiply attempts (4 inner x 4 outer = 16 calls
    per burst). Only the designated modules may hold a retry loop."""
    import gpumounter_tpu_torch.allocator.allocator as allocator_mod
    import gpumounter_tpu_torch.worker.reconciler as reconciler_mod
    import gpumounter_tpu_torch.worker.service as service_mod
    for module in (allocator_mod, service_mod, reconciler_mod):
        source = inspect.getsource(module)
        assert "call_with_retry" not in source, \
            f"{module.__name__} must not stack retries on the client's"


# -- collector/podresources.py: the kubelet client -----------------------------

def test_kubelet_grpc_calls_confined_to_one_shot_seams():
    hits = _referencing_functions(podresources, "_call")
    assert hits <= {"KubeletPodResourcesClient._list_pods_once",
                    "KubeletPodResourcesClient._allocatable_once"}, hits


def test_kubelet_list_goes_through_the_retry_layer():
    funcs = _functions(podresources)
    assert "call_with_retry" in _names_used(
        funcs["PodResourcesClient.list_pods"])
    assert "call_with_retry" in _names_used(
        funcs["KubeletPodResourcesClient.allocatable_gpu_ids"])


def test_kubelet_one_shot_only_called_by_base_template():
    hits = _referencing_functions(podresources, "_list_pods_once")
    assert hits == {"PodResourcesClient.list_pods"}, hits


# -- master/gateway.py: worker RPCs --------------------------------------------

def test_gateway_worker_rpcs_use_breaker_and_policy():
    funcs = _functions(gateway)
    names = _names_used(funcs["MasterGateway._call_node_worker"])
    assert "_breaker" in names, "worker RPCs bypass the circuit breaker"
    assert "rpc_retry_policy" in names, "worker RPCs bypass the policy"
    # every route reaches workers through the breaker-guarded path
    # (_add via the shared attach-attempt builder, which both the live
    # route and adopted waiter re-runs use)
    for route in ("_add", "_remove", "_status"):
        route_names = _names_used(funcs[f"MasterGateway.{route}"])
        assert "_call_worker" in route_names or \
            "_call_node_worker" in route_names or \
            "_worker_attach_attempt" in route_names, route
    builder_names = _names_used(
        funcs["MasterGateway._worker_attach_attempt"])
    assert "_call_node_worker" in builder_names


def _doc_or_comment_stripped(source: str) -> str:
    """Source with docstrings/comments removed — crude, for grep lints."""
    tree = ast.parse(textwrap.dedent(source))
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Module)):
            if (node.body and isinstance(node.body[0], ast.Expr)
                    and isinstance(node.body[0].value, ast.Constant)):
                node.body[0].value.value = ""
    return ast.unparse(tree)


def test_classifier_is_single_sourced():
    """Exactly one retryability decision exists: utils/retry.retryable.
    The network clients never re-implement '429 or 5xx' locally (the
    gateway's 429 is a RESPONSE mapping, not a retry decision, and lives
    outside the clients)."""
    import gpumounter_tpu_torch.utils.retry as retry_mod
    for module in (client, podresources):
        code = _doc_or_comment_stripped(inspect.getsource(module))
        assert "429" not in code, \
            f"{module.__name__} hand-rolls retryability status checks"
    assert "429" in inspect.getsource(retry_mod.retryable)
