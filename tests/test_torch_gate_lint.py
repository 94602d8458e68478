"""The port's copy of tests/test_gate_lint.py, held against
``gpumounter_tpu_torch`` with the port's names (``GPUMountService``,
``GPUAllocator``, ``GPUMounter``, ``add_gpu``). Imports no jax.

Device-gate lint (AST-based, à la test_actuation_lint): revocation has
exactly ONE seam.

1. Every device-permission mutation in the mount façade crosses the
   ``DeviceGate`` seam: ``actuation/mount.py`` may not call the cgroup
   controller's ``sync_device_access``/``revoke_device_access`` directly,
   and no module outside the gate/controller pair may either — a new
   detach/expiry/preempt path cannot ship a side-channel revoke.
2. The detach path revokes through the gate BEFORE node unlinks: inside
   ``unmount_chips``, ``gate.revoke`` appears and no unlink/remove batch
   precedes it.
3. No request-thread module touches the NATIVE sync surface: ``BpfGate``
   (program load/replace — a verifier round trip) is reachable only from
   ``actuation/gate.py`` build wiring, ``actuation/cgroup.py`` (the
   legacy v2 path) and ``actuation/bpf.py`` itself; the worker service /
   gRPC / master layers never name it.
4. The gate ships default-ON (``TPU_GATE=legacy`` reverts).
"""

import ast
import inspect

import gpumounter_tpu_torch.actuation.gate as gate_mod
import gpumounter_tpu_torch.actuation.mount as mount_mod
import gpumounter_tpu_torch.allocator.allocator as allocator_mod
import gpumounter_tpu_torch.collector.collector as collector_mod
import gpumounter_tpu_torch.master.admission as admission_mod
import gpumounter_tpu_torch.master.gateway as gateway_mod
import gpumounter_tpu_torch.worker.grpc_server as grpc_mod
import gpumounter_tpu_torch.worker.pool as pool_mod
import gpumounter_tpu_torch.worker.reconciler as reconciler_mod
import gpumounter_tpu_torch.worker.service as service_mod

_MUTATORS = {"sync_device_access", "revoke_device_access",
             "_v1_write_batch", "_v1_write", "_v2_sync"}


def _attr_calls(tree: ast.AST) -> list[str]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            out.append(node.func.attr)
    return out


def test_mount_facade_never_calls_the_controller_directly():
    tree = ast.parse(inspect.getsource(mount_mod))
    calls = set(_attr_calls(tree)) & _MUTATORS
    assert calls == set(), \
        f"actuation/mount.py mutates device permissions around the " \
        f"DeviceGate seam: {sorted(calls)} — route through self.gate"


def test_no_module_outside_the_seam_mutates_device_permissions():
    offenders = []
    for module in (service_mod, grpc_mod, allocator_mod, collector_mod,
                   pool_mod, reconciler_mod, admission_mod, gateway_mod):
        tree = ast.parse(inspect.getsource(module))
        hits = set(_attr_calls(tree)) & _MUTATORS
        if hits:
            offenders.append(f"{module.__name__}: {sorted(hits)}")
    assert offenders == [], \
        f"device-permission mutation outside the gate seam: {offenders}"


def test_unmount_revokes_through_the_gate_before_node_removal():
    """Inside unmount_chips' per-container actuate closure, the FIRST
    mutating call is gate.revoke; apply_device_nodes follows it."""
    tree = ast.parse(inspect.getsource(mount_mod))
    unmount = None
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) \
                and node.name == "unmount_chips":
            unmount = node
    assert unmount is not None
    order = []
    for node in ast.walk(unmount):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            if node.func.attr in ("revoke", "apply_device_nodes"):
                base = node.func.value
                name = (base.attr if isinstance(base, ast.Attribute)
                        else getattr(base, "id", "?"))
                order.append((node.lineno, f"{name}.{node.func.attr}"))
    order.sort()
    names = [n for _, n in order]
    assert "gate.revoke" in names, \
        "unmount_chips does not cross the DeviceGate seam"
    first_unlink = names.index("actuator.apply_device_nodes") \
        if "actuator.apply_device_nodes" in names else len(names)
    assert names.index("gate.revoke") < first_unlink, \
        f"node unlink precedes the gate revoke: {names}"


def test_mount_grants_through_the_gate():
    tree = ast.parse(inspect.getsource(mount_mod))
    mount = None
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == "mount_chips":
            mount = node
    assert mount is not None
    calls = _attr_calls(mount)
    assert "grant" in calls, \
        "mount_chips does not cross the DeviceGate seam"


def test_native_sync_surface_unreachable_from_request_threads():
    """`BpfGate` (program load/replace — the slow, privileged native
    surface) is confined: only the gate build wiring and the legacy
    controller may name it. Request-thread modules (service, gRPC,
    mount, master) must not."""
    import gpumounter_tpu_torch.worker.main as main_mod
    for module in (service_mod, grpc_mod, mount_mod, admission_mod,
                   gateway_mod, pool_mod, reconciler_mod, main_mod):
        source = inspect.getsource(module)
        assert "BpfGate" not in source and "bpfgate_" not in source, \
            f"{module.__name__} reaches the native sync surface directly"


def test_gate_module_itself_confines_native_calls_to_the_backend():
    """Inside gate.py, the raw bpf binding is touched only by the
    NativeGateBackend class and build_gate — DeviceGate itself speaks
    only the backend interface."""
    tree = ast.parse(inspect.getsource(gate_mod))
    offenders = []
    for node in tree.body:
        if isinstance(node, ast.ClassDef) \
                and node.name == "NativeGateBackend":
            continue
        if isinstance(node, ast.FunctionDef) and node.name == "build_gate":
            continue
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Attribute) and \
                    sub.attr.startswith("map_") and \
                    isinstance(sub.value, ast.Attribute) and \
                    sub.value.attr == "gate":
                offenders.append(f"line {sub.lineno}: {sub.attr}")
            if isinstance(sub, ast.Name) and sub.id == "BpfGate":
                offenders.append(f"line {sub.lineno}: BpfGate")
    assert offenders == [], \
        f"native binding reached outside NativeGateBackend: {offenders}"


def test_gate_is_the_production_default():
    from gpumounter_tpu_torch.utils.config import Settings
    assert Settings().gate_mode == "auto"
    assert Settings.from_env({}).gate_mode == "auto"
    assert Settings.from_env({"TPU_GATE": "legacy"}).gate_mode == "legacy"


def test_service_detach_paths_carry_cause_into_the_gate():
    """The detach entry points thread ``cause`` down to unmount_chips —
    the deny-reason attribution contract (lease-expired / preempted
    reasons come from HERE)."""
    source = inspect.getsource(service_mod.GPUMountService)
    tree = ast.parse("class _T:\n" + "\n".join(
        "    " + line for line in source.splitlines()))
    for node in ast.walk(tree):
        if not (isinstance(node, ast.FunctionDef)
                and node.name == "_remove_gpu"):
            continue
        for call in ast.walk(node):
            if isinstance(call, ast.Call) \
                    and isinstance(call.func, ast.Attribute) \
                    and call.func.attr == "unmount_chips":
                kwargs = {kw.arg for kw in call.keywords}
                assert "cause" in kwargs, \
                    "_remove_gpu's unmount_chips call drops the cause " \
                    "— deny reasons would all read 'detach'"
                return
    raise AssertionError("_remove_gpu/unmount_chips call not found")
