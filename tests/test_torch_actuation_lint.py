"""The port's copy of tests/test_actuation_lint.py, held against
``gpumounter_tpu_torch`` with the port's names (``GPUMountService``,
``GPUAllocator``, ``GPUMounter``, ``add_gpu``). Imports no jax.

Actuation lint (AST-based, à la test_informer_lint): with the resident
agent enabled, NO module on the attach hot path may fork/exec — no
``subprocess`` usage, no ``os.system``/``os.popen``/``os.fork``/
``os.exec*``. The per-attach shell-out the agent replaced must only be
reachable through the explicit fallback seam: the ``NsenterActuator``
class inside ``actuation/nsenter.py``."""

import ast
import inspect

import gpumounter_tpu_torch.actuation.agent as agent_mod
import gpumounter_tpu_torch.actuation.bpf as bpf_mod
import gpumounter_tpu_torch.actuation.cgroup as cgroup_mod
import gpumounter_tpu_torch.actuation.gate as gate_mod
import gpumounter_tpu_torch.actuation.mount as mount_mod
import gpumounter_tpu_torch.actuation.nsenter as nsenter_mod
import gpumounter_tpu_torch.allocator.allocator as allocator_mod
import gpumounter_tpu_torch.collector.collector as collector_mod
import gpumounter_tpu_torch.collector.podresources as podresources_mod
import gpumounter_tpu_torch.device.enumerator as enumerator_mod
import gpumounter_tpu_torch.device.plan as plan_mod
import gpumounter_tpu_torch.k8s.client as client_mod
import gpumounter_tpu_torch.k8s.informer as informer_mod
import gpumounter_tpu_torch.worker.pool as pool_mod
import gpumounter_tpu_torch.worker.service as service_mod

# Everything an AddTPU/RemoveTPU can touch while the agent is enabled.
HOT_PATH_MODULES = (
    agent_mod, mount_mod, cgroup_mod, bpf_mod, gate_mod,
    service_mod, pool_mod, allocator_mod,
    collector_mod, podresources_mod, enumerator_mod, plan_mod,
    client_mod, informer_mod,
)

_FORK_OS_CALLS = {"system", "popen", "fork", "forkpty", "spawnv",
                  "spawnvp", "execv", "execvp", "execve", "posix_spawn"}


def _fork_exec_offenders(tree: ast.AST, module_name: str) -> list[str]:
    offenders = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names]
            source = getattr(node, "module", None) or ""
            if "subprocess" in names or source == "subprocess":
                offenders.append(f"{module_name}: import subprocess")
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name):
            if node.value.id == "subprocess":
                offenders.append(
                    f"{module_name}: subprocess.{node.attr}")
            if node.value.id == "os" and node.attr in _FORK_OS_CALLS:
                offenders.append(f"{module_name}: os.{node.attr}")
    return offenders


def test_no_fork_exec_on_the_attach_hot_path():
    offenders = []
    for module in HOT_PATH_MODULES:
        if module is nsenter_mod:
            continue
        offenders += _fork_exec_offenders(
            ast.parse(inspect.getsource(module)), module.__name__)
    assert offenders == [], \
        f"fork/exec reachable outside the fallback seam: {offenders}"


def test_nsenter_fork_exec_confined_to_the_fallback_class():
    """Inside nsenter.py itself, every subprocess use must live in the
    NsenterActuator class — the ONE named fallback seam."""
    tree = ast.parse(inspect.getsource(nsenter_mod))
    offenders = []
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == "NsenterActuator":
            continue
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            continue        # the module-level import itself is fine
        offenders += _fork_exec_offenders(node, "nsenter")
    assert offenders == [], \
        f"fork/exec outside NsenterActuator: {offenders}"


def test_agent_is_the_production_default():
    """The resident agent ships ON: the fork-free warm path is the
    default actuator wiring, not an opt-in."""
    from gpumounter_tpu_torch.utils.config import Settings
    assert Settings().agent_enabled is True
    assert Settings.from_env({}).agent_enabled is True
    assert Settings.from_env({"TPU_AGENT": "0"}).agent_enabled is False


def test_mounter_single_namespace_crossing_per_container():
    """The positive half: mount/unmount actuate through ONE
    apply_device_nodes batch per container (the agent's single-crossing
    discipline), never per-node loops over create/remove."""
    for method in ("mount_chips", "unmount_chips"):
        source = inspect.getsource(getattr(mount_mod.GPUMounter, method))
        tree = ast.parse("class _T:\n" + source.replace("\n", "\n    "))
        calls = {n.attr for n in ast.walk(tree)
                 if isinstance(n, ast.Attribute)}
        assert "apply_device_nodes" in calls, method
        assert "create_device_node" not in calls, method
        assert "remove_device_node" not in calls, method
