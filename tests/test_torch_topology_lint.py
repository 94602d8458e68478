"""AST lints for the port's topology plane: the checks of
tests/test_topology_lint.py against ``gpumounter_tpu_torch/`` module
paths (the port keeps every seam they check). Fragmentation scoring must
stay OFF every request path; the fleet tick thread owns ALL scoring,
scrape threads only ingest raw /topoz payloads, request threads serve
already-computed snapshots:

1. no hot-path module can even import ``master.topology`` or
   ``collector.topology`` (exact module names — ``allocator.topology``
   is a legitimate hot-path import);
2. both /topoz handlers serve ``snapshot()`` only;
3. scoring (``_compute``) is reachable from ``tick()`` alone, and the
   aggregator drives ``topology.tick`` from its own tick only;
4. a defrag candidate's counter and event fire together or not at all
   (the ``_note_candidate`` seam);
5. the plane ships ON by default (``TPU_TOPOLOGY=0`` reverts).
"""

import ast
import inspect

import gpumounter_tpu_torch.actuation.mount as mount_mod
import gpumounter_tpu_torch.allocator.allocator as allocator_mod
import gpumounter_tpu_torch.collector.collector as collector_mod
import gpumounter_tpu_torch.collector.topology as nodetopo_mod
import gpumounter_tpu_torch.master.fleet as fleet_mod
import gpumounter_tpu_torch.master.topology as fleettopo_mod
import gpumounter_tpu_torch.worker.grpc_server as grpc_mod
import gpumounter_tpu_torch.worker.service as service_mod

HOT_PATH_MODULES = (service_mod, grpc_mod, allocator_mod, mount_mod,
                    collector_mod)
FORBIDDEN_IMPORTS = {"gpumounter_tpu_torch.master.topology",
                     "gpumounter_tpu_torch.collector.topology"}


def _imports(tree: ast.AST) -> set[str]:
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add(node.module or "")
    return out


def _method_callers(module, attr: str) -> list[str]:
    """Names of the functions in ``module`` that call ``<x>.<attr>(...)``."""
    tree = ast.parse(inspect.getsource(module))
    callers = []
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) \
                        and isinstance(sub.func, ast.Attribute) \
                        and sub.func.attr == attr:
                    callers.append(node.name)
    return callers


def test_no_hot_path_module_imports_the_topology_plane():
    offenders = []
    for module in HOT_PATH_MODULES:
        tree = ast.parse(inspect.getsource(module))
        hits = _imports(tree) & FORBIDDEN_IMPORTS
        if hits:
            offenders.append(f"{module.__name__}: {sorted(hits)}")
    assert offenders == [], \
        f"topology plane reachable from the hot path: {offenders}"


def test_worker_topoz_handler_serves_snapshot_only():
    import gpumounter_tpu_torch.worker.main as main_mod
    source = inspect.getsource(main_mod._HealthHandler)
    assert ".snapshot()" in source
    assert "update_status" not in source
    assert "sample_once" not in source


def test_master_topoz_route_serves_snapshot_only():
    import gpumounter_tpu_torch.master.gateway as gateway_mod
    source = inspect.getsource(gateway_mod)
    assert "self.topology.snapshot()" in source
    offenders = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("tick", "ingest", "_compute") \
                and isinstance(node.func.value, ast.Attribute) \
                and node.func.value.attr == "topology":
            offenders.append(node.func.attr)
    assert offenders == [], \
        f"gateway drives topology compute from a request thread: {offenders}"


def test_snapshot_performs_no_inventory_or_label_reads():
    source = inspect.getsource(nodetopo_mod.NodeTopologyView.snapshot)
    for forbidden in ("update_status", "get_node", "probe.sample",
                      "sample_once"):
        assert forbidden not in source, forbidden


def test_scoring_runs_only_from_the_tick_thread():
    assert _method_callers(fleettopo_mod, "_compute") == ["tick"]


def test_aggregator_ticks_topology_from_its_own_tick_only():
    tree = ast.parse(inspect.getsource(fleet_mod))
    callers = []
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) \
                        and isinstance(sub.func, ast.Attribute) \
                        and sub.func.attr == "tick" \
                        and isinstance(sub.func.value, ast.Attribute) \
                        and sub.func.value.attr == "topology":
                    callers.append(node.name)
    assert callers == ["tick"], \
        f"topology scored off the fleet tick thread: {callers}"


def test_defrag_candidate_metric_and_event_are_paired():
    tree = ast.parse(inspect.getsource(fleettopo_mod))
    inc_callers, emit_callers = [], []
    for node in ast.walk(tree):
        if not isinstance(node, ast.FunctionDef):
            continue
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call) \
                    or not isinstance(sub.func, ast.Attribute):
                continue
            if sub.func.attr == "inc" \
                    and isinstance(sub.func.value, ast.Attribute) \
                    and sub.func.value.attr == "defrag_candidates":
                inc_callers.append(node.name)
            if sub.func.attr == "emit" and sub.args \
                    and isinstance(sub.args[0], ast.Constant) \
                    and sub.args[0].value == "defrag_candidate":
                emit_callers.append(node.name)
    assert inc_callers == ["_note_candidate"], inc_callers
    assert emit_callers == ["_note_candidate"], emit_callers


def test_topology_is_the_production_default():
    from gpumounter_tpu_torch.master.topology import enabled
    from gpumounter_tpu_torch.utils.config import Settings
    assert Settings().topology_enabled is True
    assert Settings.from_env({}).topology_enabled is True
    assert Settings.from_env({"TPU_TOPOLOGY": "0"}).topology_enabled \
        is False
    assert enabled({}) is True
    assert enabled({"TPU_TOPOLOGY": "0"}) is False
