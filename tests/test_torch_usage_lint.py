"""AST lints for the port's usage sampler: the checks of
tests/test_usage_lint.py against ``gpumounter_tpu_torch/`` module paths
(the port keeps every seam they check). Sampling must stay OFF the
attach/detach hot path: the sampler owns its thread; request threads may
at most serve ALREADY-collected state (/utilz = ``snapshot()``):

1. no hot-path module can even import ``collector.usage``;
2. the request-path methods of the mount service never touch a sampler;
3. the health handler serves ``snapshot()`` only — no ``sample_once``/
   ``update_status`` reachable from a health request thread;
4. the sampler ships ON by default (``TPU_USAGE=0`` reverts), with
   sampling driven exclusively by its own loop thread, and NVML is
   initialised in the sampler's ``start`` (the probe's ``open``), never
   per sample.
"""

import ast
import inspect

import gpumounter_tpu_torch.actuation.mount as mount_mod
import gpumounter_tpu_torch.allocator.allocator as allocator_mod
import gpumounter_tpu_torch.collector.collector as collector_mod
import gpumounter_tpu_torch.collector.usage as usage_mod
import gpumounter_tpu_torch.worker.grpc_server as grpc_mod
import gpumounter_tpu_torch.worker.service as service_mod

# Everything an AddGPU/RemoveGPU request thread executes.
HOT_PATH_MODULES = (service_mod, grpc_mod, allocator_mod, mount_mod,
                    collector_mod)


def _imports(tree: ast.AST) -> set[str]:
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add(node.module or "")
    return out


def _callers(tree: ast.AST, attr: str) -> list[str]:
    """Names of the functions in ``tree`` that call ``<x>.<attr>(...)``."""
    callers = []
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) \
                        and isinstance(sub.func, ast.Attribute) \
                        and sub.func.attr == attr:
                    callers.append(node.name)
    return callers


def test_no_hot_path_module_imports_the_sampler():
    offenders = []
    for module in HOT_PATH_MODULES:
        tree = ast.parse(inspect.getsource(module))
        hits = {name for name in _imports(tree) if "usage" in name}
        if hits:
            offenders.append(f"{module.__name__}: {sorted(hits)}")
    assert offenders == [], \
        f"sampler reachable from the hot path: {offenders}"


def test_request_path_methods_never_touch_a_sampler():
    source = inspect.getsource(service_mod.GPUMountService)
    tree = ast.parse("class _T:\n" + "\n".join(
        "    " + line for line in source.splitlines()))
    request_paths = {"add_gpu", "_add_gpu", "remove_gpu", "_remove_gpu",
                     "gpu_status", "node_status"}
    seen, offenders = set(), []
    for node in ast.walk(tree):
        if not isinstance(node, ast.FunctionDef) \
                or node.name not in request_paths:
            continue
        seen.add(node.name)
        for sub in ast.walk(node):
            name = (sub.attr if isinstance(sub, ast.Attribute)
                    else sub.id if isinstance(sub, ast.Name) else "")
            if name and ("sampler" in name or name == "sample_once"
                         or name == "usage"):
                offenders.append(f"{node.name}: {name}")
    assert seen == request_paths
    assert offenders == [], \
        f"request path touches sampler state: {offenders}"


def test_health_handler_serves_snapshot_not_sampling():
    import gpumounter_tpu_torch.worker.main as main_mod
    source = inspect.getsource(main_mod._HealthHandler)
    assert "sample_once" not in source
    assert "update_status" not in source
    assert ".snapshot()" in source


def test_sampling_runs_only_from_the_loop_thread():
    tree = ast.parse(inspect.getsource(usage_mod))
    assert _callers(tree, "sample_once") == ["_run"]


def test_nvml_is_initialised_once_per_sampler_life():
    """``nvmlInit_v2`` is called from the GPU probe's ``open`` alone, and
    ``open`` from the sampler's ``start`` alone: no sampling pass can
    re-initialise NVML."""
    tree = ast.parse(inspect.getsource(usage_mod))
    assert _callers(tree, "nvmlInit_v2") == ["open"]
    assert _callers(tree, "nvmlShutdown") == ["close"]
    assert _callers(tree, "open") == ["start"]
    assert _callers(tree, "close") == ["stop"]


def test_usage_is_the_production_default():
    from gpumounter_tpu_torch.utils.config import Settings
    assert Settings().usage_enabled is True
    assert Settings.from_env({}).usage_enabled is True
    assert Settings.from_env({"TPU_USAGE": "0"}).usage_enabled is False


def test_snapshot_performs_no_probe_or_inventory_reads():
    source = inspect.getsource(usage_mod.ChipUsageSampler.snapshot)
    for forbidden in ("probe.sample", "update_status", "enumerate"):
        assert forbidden not in source, forbidden
