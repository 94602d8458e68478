"""AST lints for the port's node failure domain: the checks of
tests/test_nodehealth_lint.py against ``gpumounter_tpu_torch/`` module
paths (the port keeps every seam they check).

The subsystem's safety argument rests on two structural rules that a
refactor could silently break:

1. **One eviction seam.** Health-driven lease removal must cross
   ``AttachBroker.fence_lease`` — the ONE site that cleans cluster
   ground truth (slave pods), counts, events and capacity-signals.
   Health code (master/nodehealth.py, the broker's node-down handling,
   slice repair) reaching into the :class:`LeaseTable` directly would
   evict the lease while leaving ground truth granting GPUs — the
   zombie-rejoin convergence would then RESTORE the fenced grant.
2. **No silent transitions.** Every node health-state change goes
   through ``NodeHealthTracker._set_state``, which pairs the paired
   lifecycle event with the gauge move — an operator tailing /eventz
   must see every cordon/fence decision the control plane made.
"""

import ast
import os

import gpumounter_tpu_torch
from gpumounter_tpu_torch.master import nodehealth

_PKG = os.path.dirname(gpumounter_tpu_torch.__file__)

# LeaseTable mutation surface no health code may touch directly.
_EVICTION_ATTRS = {"drop", "evict_where", "release", "merge_records",
                   "record", "rederive"}


def _parse(rel_path):
    path = os.path.join(_PKG, rel_path)
    with open(path) as f:
        return ast.parse(f.read(), filename=path)


def _functions(tree):
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    out[f"{node.name}.{item.name}"] = item
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(node.name, node)
    return out


def _called_attrs(node):
    for call in ast.walk(node):
        if isinstance(call, ast.Call) and isinstance(call.func,
                                                     ast.Attribute):
            yield call.func


def test_nodehealth_module_never_touches_the_lease_table():
    tree = _parse("master/nodehealth.py")
    offenders = [f"{fn.attr} (line {fn.lineno})"
                 for fn in _called_attrs(tree)
                 if fn.attr in _EVICTION_ATTRS]
    assert not offenders, \
        "master/nodehealth.py performs lease-table mutations directly " \
        f"({offenders}); health code must go through the broker's " \
        "fence_lease / handle_node_down seam"
    names = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    assert "LeaseTable" not in names, \
        "master/nodehealth.py references LeaseTable — the tracker " \
        "judges nodes, the broker owns leases"


def test_every_health_state_transition_goes_through_set_state():
    tree = _parse("master/nodehealth.py")
    funcs = _functions(tree)
    setter = funcs.get("NodeHealthTracker._set_state")
    assert setter is not None, "_set_state vanished — update this lint"
    # the seam itself emits the paired event AND moves the gauge
    assert any(fn.attr == "emit" for fn in _called_attrs(setter)), \
        "_set_state no longer emits the paired lifecycle event"
    gauge_moved = any(
        fn.attr == "set" and isinstance(fn.value, ast.Attribute)
        and fn.value.attr == "node_health_state"
        for fn in _called_attrs(setter))
    assert gauge_moved, \
        "_set_state no longer moves node_health_state{node}"
    # ...and no OTHER site writes record.state
    for name, func in funcs.items():
        if name.split(".")[-1] in ("_set_state", "__init__"):
            continue
        for node in ast.walk(func):
            if isinstance(node, ast.Assign):
                for target in node.targets:
                    assert not (isinstance(target, ast.Attribute)
                                and target.attr == "state"), \
                        f"{name} writes .state outside _set_state " \
                        "(silent health transition)"


def test_broker_node_down_path_evicts_only_through_fence_lease():
    funcs = _functions(_parse("master/admission.py"))
    fence = funcs.get("AttachBroker.fence_lease")
    assert fence is not None, "fence_lease vanished — update this lint"
    attrs = {fn.attr for fn in _called_attrs(fence)}
    # the seam does ALL of: evict, clean cluster truth, count, event,
    # wake the queue
    for wanted in ("drop", "inc", "emit", "signal_capacity",
                   "_fence_cleanup"):
        assert wanted in attrs, \
            f"fence_lease no longer calls {wanted} — the seam's " \
            "contract eroded"
    for name in ("AttachBroker.handle_node_down",):
        func = funcs[name]
        assert not any(fn.attr in _EVICTION_ATTRS
                       for fn in _called_attrs(func)), \
            f"{name} mutates the lease table directly instead of " \
            "crossing fence_lease"
        assert any(fn.attr == "fence_lease"
                   for fn in _called_attrs(func)), \
            f"{name} no longer crosses the fencing seam"
    # the reaper's unreachable-node escape also fences, never drops
    reap = funcs["AttachBroker._reap"]
    assert any(fn.attr == "fence_lease" for fn in _called_attrs(reap)), \
        "_reap lost its fence-after-N-failures escape (dead workers " \
        "would be retried forever)"


def test_slice_repair_evicts_only_through_the_seam_and_pairs_events():
    funcs = _functions(_parse("master/slicetxn.py"))
    for name in ("SliceTxnManager.repair_group",
                 "SliceTxnManager._teardown_group"):
        func = funcs[name]
        called = {fn.attr for fn in _called_attrs(func)}
        assert "drop" not in called and "evict_where" not in called, \
            f"{name} evicts leases directly instead of fence_lease/" \
            "release"
        assert "fence_lease" in called, \
            f"{name} no longer crosses the fencing seam"
    # migration is the NON-destructive half: it must never fence (the
    # node is alive) nor evict directly — leavers detach cleanly or
    # stay until the drain/dead path finishes them
    migrate = {fn.attr for fn in _called_attrs(
        funcs["SliceTxnManager._migrate"])}
    assert "fence_lease" not in migrate and "drop" not in migrate \
        and "evict_where" not in migrate, \
        "_migrate fences/evicts — a proactive migration off a LIVE " \
        "node must never revoke one-way"
    # every slice_repairs counter move pairs with a slice_repair event
    for name, func in funcs.items():
        hits = [fn for fn in _called_attrs(func)
                if fn.attr == "inc" and isinstance(fn.value, ast.Attribute)
                and fn.value.attr == "slice_repairs"]
        if hits:
            assert any(fn.attr == "emit" for fn in _called_attrs(func)), \
                f"{name} counts a repair outcome without emitting the " \
                "paired slice_repair event"


def test_subsystem_is_default_on_and_gateway_gates_on_the_knob():
    assert nodehealth.enabled({}) is True
    assert nodehealth.enabled({"TPU_NODE_HEALTH": "0"}) is False
    with open(os.path.join(_PKG, "master", "gateway.py")) as f:
        source = f.read()
    assert "nodehealth.enabled()" in source, \
        "gateway no longer gates the tracker on nodehealth.enabled()"


def test_worker_add_path_crosses_the_drain_gate():
    funcs = _functions(_parse("worker/service.py"))
    add = funcs["GPUMountService.add_gpu"]
    assert any(fn.attr == "inflight" for fn in _called_attrs(add)), \
        "add_gpu no longer crosses the drain gate (a draining worker " \
        "would admit new attaches)"
    remove = funcs["GPUMountService.remove_gpu"]
    assert any(fn.attr == "inflight" for fn in _called_attrs(remove)), \
        "remove_gpu no longer holds an in-flight token (drain could " \
        "not settle on it)"


def test_grpc_adapter_maps_draining_before_generic_errors():
    tree = _parse("worker/grpc_server.py")
    handler = None
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == "handle":
            src = ast.dump(node)
            if "WorkerDrainingError" in src:
                handler = node
                break
    assert handler is not None, \
        "the AddGPU gRPC handler no longer catches WorkerDrainingError " \
        "— a drain refusal would surface as INTERNAL instead of the " \
        "typed draining UNAVAILABLE"
