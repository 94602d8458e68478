"""The port's deploy manifests (deploy/gpu/) and images
(docker/gpu-mounter-*/): parseable, consistent with each other and with
the port's constants (the mirror of tests/test_deploy.py); and the
control plane's observability pack (deploy/observability/) serving the
port unchanged, since the port keeps every metric family name."""

import json
import os
import re
import stat
import subprocess

import yaml

from gpumounter_tpu_torch.utils import consts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GPU_DEPLOY = os.path.join(REPO, "deploy", "gpu")
MANIFESTS = ("namespace.yaml", "service-account.yaml", "rbac.yaml",
             "gpu-mounter-workers.yaml", "gpu-mounter-master.yaml",
             "gpu-mounter-svc.yaml")


def load(name):
    with open(os.path.join(GPU_DEPLOY, name)) as f:
        return list(yaml.safe_load_all(f))


def _env(container) -> dict:
    return {e["name"]: e.get("value", e.get("valueFrom"))
            for e in container.get("env", [])}


def _master_docs():
    docs = load("gpu-mounter-master.yaml")
    deployment = next(d for d in docs if d["kind"] == "Deployment")
    pdb = next(d for d in docs if d["kind"] == "PodDisruptionBudget")
    return deployment, pdb


def _worker():
    (worker,) = load("gpu-mounter-workers.yaml")
    return worker


def test_all_manifests_parse():
    names = sorted(n for n in os.listdir(GPU_DEPLOY) if n.endswith(".yaml"))
    assert names == sorted(MANIFESTS)
    for name in names:
        docs = load(name)
        assert docs and all(d for d in docs), name


def test_pool_namespace_consistent_with_code():
    (ns,) = load("namespace.yaml")
    assert ns["metadata"]["name"] == consts.DEFAULT_POOL_NAMESPACE \
        == "gpu-pool"
    worker = _worker()
    env = _env(worker["spec"]["template"]["spec"]["containers"][0])
    assert env[consts.ENV_POOL_NAMESPACE] == consts.DEFAULT_POOL_NAMESPACE
    master, _ = _master_docs()
    menv = _env(master["spec"]["template"]["spec"]["containers"][0])
    assert menv[consts.ENV_POOL_NAMESPACE] == consts.DEFAULT_POOL_NAMESPACE


def test_worker_labels_match_discovery_selector():
    worker = _worker()
    labels = worker["spec"]["template"]["metadata"]["labels"]
    key, _, value = consts.WORKER_LABEL_SELECTOR.partition("=")
    assert labels.get(key) == value == "gpu-mounter-worker"
    assert worker["metadata"]["namespace"] == consts.WORKER_NAMESPACE


def test_worker_runs_the_ports_worker_with_its_ports():
    container = _worker()["spec"]["template"]["spec"]["containers"][0]
    assert container["command"] == [
        "python", "-m", "gpumounter_tpu_torch.worker.main"]
    ports = {p["containerPort"] for p in container["ports"]}
    assert ports == {consts.WORKER_GRPC_PORT, consts.WORKER_GRPC_PORT + 1}
    probes = {container[p]["httpGet"]["port"]
              for p in ("readinessProbe", "livenessProbe")}
    assert probes == {consts.WORKER_GRPC_PORT + 1}


def test_worker_privileges_and_mounts():
    spec = _worker()["spec"]["template"]["spec"]
    assert spec["hostPID"] is True
    container = spec["containers"][0]
    assert container["securityContext"]["privileged"] is True
    mounts = {m["mountPath"] for m in container["volumeMounts"]}
    assert {"/sys/fs/cgroup", "/dev", "/proc",
            "/var/lib/kubelet/pod-resources",
            "/var/lib/kubelet/device-plugins"} <= mounts
    paths = {v["name"]: v["hostPath"]["path"] for v in spec["volumes"]}
    for mount in container["volumeMounts"]:
        assert paths[mount["name"]] == mount["mountPath"], mount


def test_worker_lands_on_every_gpu_nodepool():
    """Exists on GKE's accelerator label, never a value: every GPU pool
    (H100, A100, L4, ...) gets a worker; and the nvidia.com/gpu taint is
    tolerated, or no GPU node admits it."""
    spec = _worker()["spec"]["template"]["spec"]
    assert "nodeSelector" not in spec
    terms = (spec["affinity"]["nodeAffinity"]
             ["requiredDuringSchedulingIgnoredDuringExecution"]
             ["nodeSelectorTerms"])
    exprs = [e for t in terms for e in t["matchExpressions"]]
    accel = [e for e in exprs
             if e["key"] == "cloud.google.com/gke-accelerator"]
    assert accel and all(e["operator"] == "Exists" and "values" not in e
                         for e in accel)
    assert any(t.get("key") == consts.GPU_RESOURCE_NAME
               and t.get("operator") == "Exists"
               for t in spec["tolerations"])


def test_service_targets_master_port():
    (svc,) = load("gpu-mounter-svc.yaml")
    assert svc["spec"]["ports"][0]["targetPort"] == consts.MASTER_HTTP_PORT
    master, _ = _master_docs()
    mlabels = master["spec"]["template"]["metadata"]["labels"]
    for k, v in svc["spec"]["selector"].items():
        assert mlabels.get(k) == v
    container = master["spec"]["template"]["spec"]["containers"][0]
    assert container["command"] == [
        "python", "-m", "gpumounter_tpu_torch.master.main"]


def test_master_ha_topology():
    """Two replicas only with the full HA triple on, spread over hosts
    and behind a disruption budget that keeps one alive."""
    master, pdb = _master_docs()
    assert master["spec"]["replicas"] == 2
    spec = master["spec"]["template"]["spec"]
    env = _env(spec["containers"][0])
    assert env[consts.ENV_MASTER_SHARDS] == "2"
    assert env[consts.ENV_ELECTION] == "1"
    assert env[consts.ENV_INTENT_STORE] == "1"
    assert env[consts.ENV_REPLICA_ID]["fieldRef"]["fieldPath"] \
        == "metadata.name"
    assert "$(POD_IP)" in env[consts.ENV_ADVERTISE_URL]
    assert env["POD_IP"]["fieldRef"]["fieldPath"] == "status.podIP"
    terms = (spec["affinity"]["podAntiAffinity"]
             ["preferredDuringSchedulingIgnoredDuringExecution"])
    assert any(t["podAffinityTerm"]["topologyKey"]
               == "kubernetes.io/hostname" for t in terms)
    assert pdb["spec"]["maxUnavailable"] == 1
    selector = pdb["spec"]["selector"]["matchLabels"]
    labels = master["spec"]["template"]["metadata"]["labels"]
    assert all(labels.get(k) == v for k, v in selector.items())


def test_the_service_account_is_the_one_the_pods_run_as():
    (sa,) = load("service-account.yaml")
    master, _ = _master_docs()
    for spec in (master["spec"]["template"]["spec"],
                 _worker()["spec"]["template"]["spec"]):
        assert spec["serviceAccountName"] == sa["metadata"]["name"]
    for doc in load("rbac.yaml"):
        for subject in doc.get("subjects", []):
            assert (subject["name"], subject["namespace"]) == (
                sa["metadata"]["name"], sa["metadata"]["namespace"])


def test_rbac_grants_ha_configmap_access_pool_scoped_only():
    docs = load("rbac.yaml")
    for doc in docs:
        if doc["kind"] == "ClusterRole":
            for rule in doc["rules"]:
                assert "configmaps" not in rule["resources"]
    (role,) = [d for d in docs if d["kind"] == "Role"]
    cm_rules = [r for r in role["rules"] if "configmaps" in r["resources"]]
    assert cm_rules, "pool-namespace Role grants no configmap access"
    verbs = {v for r in cm_rules for v in r["verbs"]}
    assert {"get", "create", "patch", "delete"} <= verbs
    assert "update" not in verbs


def test_rbac_is_not_cluster_admin():
    docs = load("rbac.yaml")
    for doc in docs:
        if doc["kind"] == "ClusterRoleBinding":
            assert doc["roleRef"]["name"] != "cluster-admin"
    roles = [d for d in docs if d["kind"] in ("Role", "RoleBinding")]
    assert roles and all(
        r["metadata"]["namespace"] == consts.DEFAULT_POOL_NAMESPACE
        for r in roles)


def test_deploy_sh_is_executable_and_covers_manifests():
    path = os.path.join(GPU_DEPLOY, "deploy.sh")
    assert os.stat(path).st_mode & stat.S_IXUSR
    with open(path) as f:
        content = f.read()
    for name in MANIFESTS:
        assert f"deploy/gpu/{name}" in content, name
    for verb in ("deploy)", "redeploy)", "uninstall)"):
        assert verb in content
    assert "namespace/gpu-pool" in content
    assert subprocess.run(["bash", "-n", path]).returncode == 0


def _dockerfile(name: str) -> str:
    with open(os.path.join(REPO, "docker", name, "Dockerfile")) as f:
        return f.read()


def test_images_copy_only_the_port():
    for name, module in (("gpu-mounter-master", "master"),
                         ("gpu-mounter-worker", "worker")):
        text = _dockerfile(name)
        copies = re.findall(r"^COPY (.+)$", text, re.M)
        assert copies, name
        for copy in copies:
            parts = copy.split()
            sources = [p for p in parts[:-1] if not p.startswith("--")]
            assert sources == [
                "/app/gpumounter_tpu_torch" if "--from" in copy
                else "gpumounter_tpu_torch"], (name, copy)
        assert (f'ENTRYPOINT ["python", "-m", '
                f'"gpumounter_tpu_torch.{module}.main"]') in text


def test_worker_image_builds_the_ports_native_code_and_no_torch():
    text = _dockerfile("gpu-mounter-worker")
    assert "make -C gpumounter_tpu_torch/native" in text
    for name in ("gpuprobe.cc", "bpf_gate.cc", "Makefile"):
        assert os.path.exists(os.path.join(
            REPO, "gpumounter_tpu_torch", "native", name))
    for image in ("gpu-mounter-worker", "gpu-mounter-master"):
        installs = re.findall(r"pip install (.+)$", _dockerfile(image), re.M)
        packages = {p for line in installs for p in line.split()
                    if not p.startswith("-")}
        assert packages == {"grpcio", "protobuf", "pyyaml"}, image
    assert "EXPOSE 1200 1201" in text


# -- the observability pack serves the port unchanged --------------------------

def _port_metric_names() -> set:
    from gpumounter_tpu_torch.utils.metrics import REGISTRY
    return set(re.findall(r"^# TYPE (\S+)", REGISTRY.render_text(), re.M))


def _referenced_metrics(expr_text: str) -> set:
    names = set()
    for tok in re.findall(r"\btpumounter_[a-z0-9_]+", expr_text):
        for suffix in ("_bucket", "_count", "_sum"):
            if tok.endswith(suffix):
                tok = tok[: -len(suffix)]
                break
        names.add(tok)
    return names


def test_observability_pack_metrics_exist_in_the_ports_registry():
    """Every metric family the Grafana dashboard and the Prometheus rules
    of deploy/observability/ query is one the port's REGISTRY exports, so
    those files serve a GPU fleet as they are."""
    base = os.path.join(REPO, "deploy", "observability")
    with open(os.path.join(base, "grafana-dashboard.json")) as f:
        dash = json.load(f)
    exprs = [t["expr"] for p in dash["panels"] for t in p.get("targets", [])]
    with open(os.path.join(base, "prometheus-rules.yaml")) as f:
        rules = [r for g in yaml.safe_load(f)["groups"] for r in g["rules"]]
    exprs += [r["expr"] for r in rules]
    assert len(exprs) > 10
    referenced = set()
    for expr in exprs:
        refs = _referenced_metrics(expr)
        assert refs, f"no tpumounter metric in {expr!r}"
        referenced |= refs
    missing = referenced - _port_metric_names()
    assert not missing, f"the port does not export {sorted(missing)}"
