"""The Kubernetes client, through both packages: the cases of
tests/test_k8s_client.py that tests/test_torch_k8s.py does not hold. The
fake's create hook, watch timeout and field selector; the in-cluster
client against the control plane's stub apiserver (CRUD, bearer token,
watch, the required environment); and the kubeconfig client (token and
token files, contexts, ``KUBECONFIG`` lists and precedence, inline CA
data, typed errors, and the inline key's temporary file deleted)."""

import base64
import datetime
import glob
import tempfile
import time

import pytest

from tests.test_k8s_client import (_StubApiserver, _write_kubeconfig,
                                   make_pod, stub_http_server)
from tests.torch_control_plane import BOTH, IDS

__all__ = ["stub_http_server"]


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


@pytest.fixture
def client(pkg):
    return pkg.mod("k8s.client")


def _auths():
    return [a for (_, _, a) in _StubApiserver.requests_log]


# -- FakeKubeClient -------------------------------------------------------------

def test_fake_on_create_hook_mutates_async(client):
    c = client.FakeKubeClient()

    def scheduler(pod):
        time.sleep(0.02)
        c.set_pod_status(pod["metadata"]["namespace"],
                         pod["metadata"]["name"], phase="Running")
    c.on_create.append(scheduler)
    c.create_pod("default", make_pod("p1"))
    assert c.get_pod("default", "p1")["status"]["phase"] == "Pending"
    deadline = time.time() + 2
    while time.time() < deadline and \
            c.get_pod("default", "p1")["status"]["phase"] != "Running":
        time.sleep(0.01)
    assert c.get_pod("default", "p1")["status"]["phase"] == "Running"


def test_fake_watch_times_out_and_filters_by_field(client):
    c = client.FakeKubeClient()
    start = time.monotonic()
    assert list(c.watch_pods("default", timeout_s=0.2)) == []
    assert time.monotonic() - start < 2.0
    c.create_pod("default", make_pod("p1"))
    c.create_pod("default", make_pod("p2"))
    events = list(c.watch_pods("default", field_selector="metadata.name=p2",
                               timeout_s=0.2))
    assert [pod["metadata"]["name"] for _, pod in events] == ["p2"]


# -- InClusterKubeClient ---------------------------------------------------------

@pytest.fixture
def incluster(client, tmp_path, stub_http_server):
    sa = tmp_path / "sa"
    sa.mkdir()
    (sa / "token").write_text("test-token")
    return client.InClusterKubeClient(host=stub_http_server, sa_dir=str(sa))


def test_incluster_crud_roundtrip_with_bearer(pkg, incluster):
    c = incluster
    c.create_pod("default", make_pod("p1"))
    assert c.get_pod("default", "p1")["metadata"]["name"] == "p1"
    assert len(c.list_pods("default")) == 1
    c.delete_pod("default", "p1")
    with pytest.raises(pkg.errors.PodNotFoundError) as ei:
        c.get_pod("default", "p1")
    assert ei.value.namespace == "default"
    c.delete_pod("default", "p1")             # a 404 is swallowed
    assert "Bearer test-token" in _auths()


def test_incluster_watch_stream(incluster):
    incluster.create_pod("default", make_pod("p1", phase="Running"))
    events = list(incluster.watch_pods("default", timeout_s=2))
    assert events and events[0][0] == "ADDED"
    assert events[0][1]["metadata"]["name"] == "p1"


def test_incluster_requires_env_when_no_host(pkg, client, monkeypatch):
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    with pytest.raises(pkg.errors.K8sApiError):
        client.InClusterKubeClient()


# -- KubeconfigKubeClient --------------------------------------------------------

def test_kubeconfig_token_crud_and_bearer(pkg, client, tmp_path,
                                          stub_http_server):
    path = _write_kubeconfig(tmp_path, stub_http_server,
                             user={"token": "kc-token"})
    c = client.KubeconfigKubeClient(path=path)
    assert (c.context_name, c.namespace) == ("dev", "tpu-pool")
    c.create_pod("default", make_pod("p1"))
    assert c.get_pod("default", "p1")["metadata"]["name"] == "p1"
    c.delete_pod("default", "p1")
    with pytest.raises(pkg.errors.PodNotFoundError):
        c.get_pod("default", "p1")
    assert "Bearer kc-token" in _auths()


@pytest.mark.parametrize("token_file", ["absolute", "relative"])
def test_kubeconfig_token_file(client, tmp_path, stub_http_server,
                               token_file):
    tok = tmp_path / "token.txt"
    tok.write_text("file-token\n")
    path = _write_kubeconfig(
        tmp_path, stub_http_server,
        user={"tokenFile": str(tok) if token_file == "absolute"
              else "token.txt"})
    client.KubeconfigKubeClient(path=path).list_pods("default")
    assert "Bearer file-token" in _auths()


def test_kubeconfig_explicit_context_and_env(client, tmp_path,
                                             stub_http_server, monkeypatch):
    path = _write_kubeconfig(tmp_path, stub_http_server,
                             user={"token": "t"})
    c = client.KubeconfigKubeClient(path=path, context="other")
    assert (c.context_name, c.namespace) == ("other", "default")
    monkeypatch.setenv("KUBECONFIG", path)
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    assert isinstance(client.default_kube_client(),
                      client.KubeconfigKubeClient)


def test_kubeconfig_error_paths(pkg, client, tmp_path, stub_http_server):
    err = pkg.errors.K8sApiError
    with pytest.raises(err, match="unreadable"):
        client.KubeconfigKubeClient(path=str(tmp_path / "absent"))
    path = _write_kubeconfig(tmp_path, stub_http_server, user={"token": "t"})
    with pytest.raises(err, match="no entry named"):
        client.KubeconfigKubeClient(path=path, context="missing")
    path2 = _write_kubeconfig(
        tmp_path, stub_http_server,
        user={"exec": {"command": "gke-gcloud-auth-plugin"}}, name="kc-exec")
    with pytest.raises(err, match="exec"):
        client.KubeconfigKubeClient(path=path2)


def _ca_pem():
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    subject = x509.Name(
        [x509.NameAttribute(x509.NameOID.COMMON_NAME, "test-ca")])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(subject).issuer_name(subject)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now)
            .not_valid_after(now + datetime.timedelta(days=1))
            .add_extension(x509.BasicConstraints(ca=True, path_length=None),
                           critical=True)
            .sign(key, hashes.SHA256()))
    return (cert.public_bytes(serialization.Encoding.PEM),
            cert.public_bytes(serialization.Encoding.DER))


def test_kubeconfig_inline_ca_data_builds_tls_context(client, tmp_path):
    pytest.importorskip("cryptography")
    pem, der = _ca_pem()
    path = _write_kubeconfig(
        tmp_path, "https://127.0.0.1:9", user={"token": "t"},
        cluster_extra={"certificate-authority-data":
                       base64.b64encode(pem).decode()})
    c = client.KubeconfigKubeClient(path=path)
    assert c._ssl is not None
    assert der in c._ssl.get_ca_certs(binary_form=True)


def test_kubeconfig_tokenfile_unreadable_raises(pkg, client, tmp_path,
                                                stub_http_server):
    path = _write_kubeconfig(tmp_path, stub_http_server,
                             user={"tokenFile": str(tmp_path / "rotated")})
    c = client.KubeconfigKubeClient(path=path)
    with pytest.raises(pkg.errors.K8sApiError,
                       match="tokenFile unreadable"):
        c.list_pods("default")


def test_kubeconfig_bad_yaml_bad_b64_and_missing_ca_are_typed(pkg, client,
                                                              tmp_path):
    err = pkg.errors.K8sApiError
    p = tmp_path / "broken"
    p.write_text("{unclosed: [")
    with pytest.raises(err, match="unparseable"):
        client.KubeconfigKubeClient(path=str(p))
    path = _write_kubeconfig(tmp_path, "https://127.0.0.1:9",
                             user={"token": "t"}, cluster_extra={
                                 "certificate-authority-data": "!!!notb64"})
    with pytest.raises(err, match="base64"):
        client.KubeconfigKubeClient(path=path)
    path = _write_kubeconfig(
        tmp_path, "https://127.0.0.1:9", user={"token": "t"}, name="kc-ca",
        cluster_extra={"certificate-authority": "/etc/absent-ca.crt"})
    with pytest.raises(err, match="TLS material"):
        client.KubeconfigKubeClient(path=path)


def test_kubeconfig_env_colon_separated_list(client, tmp_path,
                                             stub_http_server, monkeypatch):
    real = _write_kubeconfig(tmp_path, stub_http_server,
                             user={"token": "t"}, name="real")
    monkeypatch.setenv("KUBECONFIG", f"{tmp_path / 'missing'}:{real}")
    assert client.KubeconfigKubeClient().context_name == "dev"


def test_kubeconfig_inline_key_tempfile_is_deleted(pkg, client, tmp_path,
                                                   monkeypatch):
    """Inline client-key-data without a certificate is refused, and the
    temporary key file made meanwhile does not stay on disk."""
    pytest.importorskip("cryptography")
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    key_pem = key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption())
    path = _write_kubeconfig(
        tmp_path, "https://127.0.0.1:9",
        user={"token": "t",
              "client-key-data": base64.b64encode(key_pem).decode()})
    with pytest.raises(pkg.errors.K8sApiError, match="client-key"):
        client.KubeconfigKubeClient(path=path)
    assert glob.glob(str(tmp_path / "kubeconfig-client-key-*")) == []


def test_default_client_kubeconfig_env_beats_incluster(client, tmp_path,
                                                       stub_http_server,
                                                       monkeypatch):
    path = _write_kubeconfig(tmp_path, stub_http_server, user={"token": "t"})
    monkeypatch.setenv("KUBECONFIG", path)
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.0.0.1")
    assert isinstance(client.default_kube_client(),
                      client.KubeconfigKubeClient)

