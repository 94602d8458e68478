"""Minimal Kubernetes API client (pods only) + in-memory fake.

The port's own copy of :mod:`gpumounter_tpu.k8s.client`.

The reference uses client-go with a ``sync.Once`` singleton clientset
(``pkg/config/config.go:30-45``) and issues raw per-request LISTs with no
informers (``cmd/GPUMounter-master/main.go:248``). This build has no
Kubernetes client library available, so we speak the REST API directly — which
is all the control plane needs: pod get/list/create/delete plus **watch**
streams. Watches are what replace the reference's unbounded apiserver
busy-polls (``allocator.go:247-282``) with event-driven waits.

Three implementations of one interface:

- :class:`InClusterKubeClient` — production; reads the serviceaccount token /
  CA / namespace like client-go's ``rest.InClusterConfig`` and talks HTTPS to
  ``$KUBERNETES_SERVICE_HOST``.
- :class:`KubeconfigKubeClient` — dev / out-of-cluster; parses the
  current-context of ``$KUBECONFIG`` / ``~/.kube/config`` (server + CA, bearer
  token or client cert). The reference only stubbed this path with a
  hardcoded placeholder (``pkg/config/config.go:18-28``); here it is real.
  :func:`default_kube_client` picks between the two the way client-go's
  ``clientcmd`` fallback chain does.
- :class:`FakeKubeClient` — tests; an in-memory pod store with a pluggable
  "scheduler" hook so tests can script kubelet/scheduler behaviour
  (pod goes Running, goes Unschedulable, never schedules, ...).
"""

from __future__ import annotations

import abc
import http.client
import json
import os
import socket
import ssl
import threading
import time
import urllib.parse
import urllib.request
from collections.abc import Callable, Iterator
from typing import Any

from gpumounter_tpu_torch.k8s import objects
from gpumounter_tpu_torch.utils.errors import K8sApiError, PodNotFoundError
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.retry import (RetryBudget, RetryPolicy,
                                              call_with_retry, retryable,
                                              retryable_non_idempotent)
from gpumounter_tpu_torch.utils.trace import annotate, k8s_call

logger = get_logger("k8s.client")

# Apiserver backoff shape shared by the REST clients and the fake (tests
# override per instance). max_attempts counts the first try, so the
# fault-free path issues exactly one round-trip — retries only exist when
# a call actually failed with a transient error.
DEFAULT_APISERVER_RETRY = RetryPolicy(max_attempts=4, base_delay_s=0.1,
                                      max_delay_s=2.0, deadline_s=30.0)


def _parse_retry_after(value: str | None) -> float | None:
    """Seconds form of a Retry-After header; HTTP-date form is rare from
    an apiserver and not worth a date parser — ignored."""
    if not value:
        return None
    try:
        return max(0.0, float(value))
    except ValueError:
        return None


def _transport_cause(reason: object) -> str:
    """Classify a transport-level failure (no HTTP response) so the retry
    classifier and trace error attributes can tell a socket timeout — the
    request may have landed — from connection refusal, which certainly
    did not (pre-PR both were an indistinguishable status-0)."""
    if isinstance(reason, (TimeoutError, socket.timeout)):
        return "timeout"
    if isinstance(reason, ConnectionRefusedError):
        return "refused"
    if isinstance(reason, (ConnectionResetError, BrokenPipeError,
                           ConnectionAbortedError)):
        return "reset"
    if isinstance(reason, socket.gaierror):
        return "dns"
    if isinstance(reason, str) and "timed out" in reason:
        return "timeout"
    return "unreachable"


def _resilient_watch(watch_once, timeout_s: float,
                     resource_version: str | None,
                     policy: RetryPolicy) -> Iterator[WatchEvent]:
    """Run ``watch_once(remaining_s, rv)`` streams back-to-back until the
    deadline, RESUMING from the last seen resourceVersion when a stream
    dies mid-flight (transport-level status-0 error) instead of aborting
    the caller's wait. Events between the death and the resume are not
    lost: the resume starts from the last event the consumer already saw.
    HTTP-level errors (410 Gone etc.) propagate — those need a re-LIST,
    which only the caller can do."""
    from gpumounter_tpu_torch.utils.metrics import REGISTRY
    deadline = time.monotonic() + timeout_s
    rv = resource_version
    resumes = 0
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return
        try:
            for etype, obj in watch_once(remaining, rv):
                if isinstance(obj, dict):
                    rv = obj.get("metadata", {}).get(
                        "resourceVersion") or rv
                yield etype, obj
            return                       # clean server-side timeout
        except K8sApiError as e:
            if e.status != 0 or resumes + 1 >= policy.max_attempts:
                raise
            resumes += 1
            REGISTRY.retry_attempts.inc(target="watch")
            logger.warning(
                "watch stream died (%s); resuming from "
                "resourceVersion=%s (resume %d)", e, rv, resumes)
            delay = min(policy.delay_s(resumes),
                        max(0.0, deadline - time.monotonic()))
            if delay > 0:
                time.sleep(delay)


def _path_resource(path: str) -> str:
    """The resource collection an apiserver path addresses ("pods",
    "nodes", "events", ...) — the ``resource`` label of
    ``tpumounter_k8s_request_seconds``."""
    parts = [p for p in path.split("/") if p]
    try:
        if "namespaces" in parts:
            return parts[parts.index("namespaces") + 2]
        return parts[2]                       # /api/v1/<resource>/...
    except IndexError:
        return "unknown"

SERVICEACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

# (event_type, pod) as delivered by a watch stream; event_type is one of
# ADDED / MODIFIED / DELETED / BOOKMARK.
WatchEvent = tuple[str, objects.Pod]


class KubeClient(abc.ABC):
    """The exact API surface the control plane needs — nothing more."""

    @abc.abstractmethod
    def get_pod(self, namespace: str, name: str) -> objects.Pod:
        """Raises :class:`PodNotFoundError` on 404."""

    @abc.abstractmethod
    def list_pods(self, namespace: str,
                  label_selector: str | None = None) -> list[objects.Pod]:
        ...

    @abc.abstractmethod
    def list_pods_with_version(
            self, namespace: str, label_selector: str | None = None
    ) -> tuple[list[objects.Pod], str]:
        """(pods, list resourceVersion) — the version to start a watch from
        so no event between the LIST and the watch is lost."""

    @abc.abstractmethod
    def create_pod(self, namespace: str, pod: objects.Pod) -> objects.Pod:
        ...

    @abc.abstractmethod
    def delete_pod(self, namespace: str, name: str,
                   grace_period_seconds: int = 0,
                   resource_version: str | None = None) -> None:
        """404s are swallowed — deleting an already-gone pod is success.

        ``resource_version`` is a DeleteOptions precondition: the delete
        only lands if the live object still has that version, else 409
        (:class:`K8sApiError`). The warm-pool trim uses this so a delete
        decided on a stale LIST cannot kill a pod an attach adopted in
        between."""

    @abc.abstractmethod
    def patch_pod(self, namespace: str, name: str, patch: dict[str, Any],
                  resource_version: str | None = None) -> objects.Pod:
        """JSON merge-patch (RFC 7386: null deletes a key) the pod and
        return the updated object. ``resource_version`` is an optimistic-
        concurrency precondition: the patch carries
        ``metadata.resourceVersion`` and the apiserver answers 409 Conflict
        when the live object has moved on — the warm-pool adoption race is
        decided by exactly this (two claimers patch the same observed
        version; one wins, the other gets 409 and tries the next pod).
        Raises :class:`PodNotFoundError` on 404, :class:`K8sApiError`
        (status 409) on a lost precondition."""

    @abc.abstractmethod
    def watch_pods(self, namespace: str, label_selector: str | None = None,
                   field_selector: str | None = None,
                   timeout_s: float = 60.0,
                   resource_version: str | None = None
                   ) -> Iterator[WatchEvent]:
        """Stream events for up to ``timeout_s``; iterator ends at deadline.

        ``resource_version`` starts the stream from a LIST's version (no
        lost-event window). An expired version raises
        :class:`K8sApiError` with status 410 — re-LIST and restart."""

    @abc.abstractmethod
    def get_node(self, name: str) -> dict[str, Any]:
        """Node object (for TPU topology labels / allocatable). Raises
        :class:`K8sApiError` (status 404 for unknown nodes)."""

    # ConfigMaps: the declaratively-persisted, CAS-able object kind the
    # HA control plane keeps broker intent and election locks in
    # (master/store.py, master/election.py). Same optimistic-concurrency
    # contract as patch_pod: a resourceVersion precondition answers 409
    # when the live object moved on — which is exactly how two master
    # replicas decide every state/lock race.

    @abc.abstractmethod
    def get_config_map(self, namespace: str, name: str) -> dict[str, Any]:
        """Raises :class:`K8sApiError` (status 404) for unknown maps."""

    @abc.abstractmethod
    def create_config_map(self, namespace: str,
                          obj: dict[str, Any]) -> dict[str, Any]:
        """409 :class:`K8sApiError` when the name exists (create IS the
        acquisition CAS for a lock object that does not exist yet)."""

    @abc.abstractmethod
    def patch_config_map(self, namespace: str, name: str,
                         patch: dict[str, Any],
                         resource_version: str | None = None
                         ) -> dict[str, Any]:
        """JSON merge-patch (null deletes a key) with an optional
        resourceVersion precondition; 409 on a lost CAS, 404
        :class:`K8sApiError` when absent."""

    @abc.abstractmethod
    def delete_config_map(self, namespace: str, name: str) -> None:
        """404s are swallowed — deleting an already-gone map is success."""

    @abc.abstractmethod
    def create_event(self, namespace: str,
                     event: dict[str, Any]) -> dict[str, Any]:
        """POST a core/v1 Event (attach/detach audit trail on the target
        pod, surfaced by ``kubectl describe``)."""


# -- production clients --------------------------------------------------------


class RestKubeClient(KubeClient):
    """Shared REST/watch machinery; subclasses supply endpoint + credentials.

    Subclasses set ``self.base`` (URL) and ``self._ssl`` (context or None) and
    implement :meth:`_token` (empty string ⇒ no Authorization header, e.g.
    client-cert auth carried by the ssl context instead).
    """

    base: str
    _ssl: ssl.SSLContext | None

    # Overridable per instance (tests shrink the delays); the budget is
    # lazily shared across this client's request threads so a hard outage
    # cannot multiply load by max_attempts on every caller at once.
    retry_policy: RetryPolicy = DEFAULT_APISERVER_RETRY

    def _token(self) -> str:
        return ""

    @property
    def _retry_budget(self) -> RetryBudget:
        budget = getattr(self, "_retry_budget_obj", None)
        if budget is None:
            budget = self._retry_budget_obj = RetryBudget()
        return budget

    def _request(self, method: str, path: str,
                 query: dict[str, str] | None = None,
                 body: dict[str, Any] | None = None,
                 stream: bool = False, timeout: float = 30.0,
                 content_type: str = "application/json"):
        """EVERY apiserver round-trip goes through here: one-shot
        :meth:`_request_once` under the unified retry layer
        (utils/retry.py). Only transiently-failed calls re-issue — the
        fault-free path is exactly one round-trip. POST (create) is not
        idempotent, so it uses the stricter classifier: replay only when
        the request provably never landed."""
        classify = retryable_non_idempotent if method == "POST" \
            else retryable
        return call_with_retry(
            lambda: self._request_once(method, path, query=query, body=body,
                                       stream=stream, timeout=timeout,
                                       content_type=content_type),
            policy=self.retry_policy, target="apiserver",
            classify=classify, budget=self._retry_budget)

    def _request_once(self, method: str, path: str,
                      query: dict[str, str] | None = None,
                      body: dict[str, Any] | None = None,
                      stream: bool = False, timeout: float = 30.0,
                      content_type: str = "application/json"):
        url = self.base + path
        if query:
            url += "?" + urllib.parse.urlencode(query)
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Accept", "application/json")
        if data is not None:
            req.add_header("Content-Type", content_type)
        tok = self._token()
        if tok:
            req.add_header("Authorization", f"Bearer {tok}")
        # WATCH and LIST are verbs of their own on dashboards — a 30s
        # watch chunk or a fleet-wide LIST averaged into GET latency would
        # bury every real GET regression. For streams only the connection
        # setup is timed here; consuming the stream is the caller's
        # (deliberately unbounded) wait.
        resource = _path_resource(path)
        if (query or {}).get("watch") == "true":
            verb = "WATCH"
        elif method == "GET" and path.rstrip("/").endswith(f"/{resource}"):
            verb = "LIST"                     # collection GET
        else:
            verb = method
        with k8s_call(verb, resource):
            try:
                resp = urllib.request.urlopen(req, context=self._ssl,
                                              timeout=timeout)
            except urllib.error.HTTPError as e:
                msg = e.read().decode(errors="replace")[:512]
                annotate(error_status=e.code)
                raise K8sApiError(
                    e.code, msg,
                    retry_after_s=_parse_retry_after(
                        e.headers.get("Retry-After"))) from e
            except urllib.error.URLError as e:
                cause = _transport_cause(e.reason)
                annotate(error_cause=cause)
                raise K8sApiError(
                    0, f"apiserver unreachable ({cause}): {e.reason}",
                    cause=cause) from e
            except (TimeoutError, socket.timeout) as e:
                # read-phase timeout after the connection was established —
                # unlike "refused", the request MAY have landed
                annotate(error_cause="timeout")
                raise K8sApiError(0, f"apiserver timed out: {e}",
                                  cause="timeout") from e
            except ConnectionError as e:
                # e.g. http.client.RemoteDisconnected: the server closed
                # the connection before answering — urlopen raises these
                # raw (only request-phase OSErrors get URLError-wrapped)
                annotate(error_cause="reset")
                raise K8sApiError(0, f"apiserver connection broken: {e}",
                                  cause="reset") from e
            except http.client.HTTPException as e:
                # torn/garbled response (BadStatusLine et al)
                annotate(error_cause="reset")
                raise K8sApiError(0, f"apiserver response broken: {e}",
                                  cause="reset") from e
            if stream:
                return resp
            # body transfer + decode inside the timed block: on a big LIST
            # the multi-MB body is the dominant cost, and excluding it
            # would make the metric point at the wrong hop
            try:
                with resp:
                    return json.loads(resp.read())
            except (TimeoutError, socket.timeout) as e:
                annotate(error_cause="timeout")
                raise K8sApiError(0, f"apiserver body read timed out: {e}",
                                  cause="timeout") from e
            except ConnectionError as e:
                annotate(error_cause="reset")
                raise K8sApiError(0, f"apiserver body read broken: {e}",
                                  cause="reset") from e

    # -- KubeClient ------------------------------------------------------------

    def get_pod(self, namespace: str, name: str) -> objects.Pod:
        try:
            return self._request(
                "GET", f"/api/v1/namespaces/{namespace}/pods/{name}")
        except K8sApiError as e:
            if e.status == 404:
                raise PodNotFoundError(namespace, name) from None
            raise

    def list_pods(self, namespace: str,
                  label_selector: str | None = None) -> list[objects.Pod]:
        return self.list_pods_with_version(namespace, label_selector)[0]

    def list_pods_with_version(
            self, namespace: str, label_selector: str | None = None
    ) -> tuple[list[objects.Pod], str]:
        query = {}
        if label_selector:
            query["labelSelector"] = label_selector
        out = self._request("GET", f"/api/v1/namespaces/{namespace}/pods",
                            query=query)
        return (out.get("items", []),
                out.get("metadata", {}).get("resourceVersion", ""))

    def create_pod(self, namespace: str, pod: objects.Pod) -> objects.Pod:
        return self._request("POST", f"/api/v1/namespaces/{namespace}/pods",
                             body=pod)

    def delete_pod(self, namespace: str, name: str,
                   grace_period_seconds: int = 0,
                   resource_version: str | None = None) -> None:
        body: dict[str, Any] = {"gracePeriodSeconds": grace_period_seconds}
        if resource_version is not None:
            body["preconditions"] = {"resourceVersion": resource_version}
        try:
            self._request(
                "DELETE", f"/api/v1/namespaces/{namespace}/pods/{name}",
                body=body)
        except K8sApiError as e:
            if e.status != 404:
                raise

    def patch_pod(self, namespace: str, name: str, patch: dict[str, Any],
                  resource_version: str | None = None) -> objects.Pod:
        if resource_version is not None:
            meta = dict(patch.get("metadata") or {})
            meta["resourceVersion"] = resource_version
            patch = {**patch, "metadata": meta}
        try:
            return self._request(
                "PATCH", f"/api/v1/namespaces/{namespace}/pods/{name}",
                body=patch, content_type="application/merge-patch+json")
        except K8sApiError as e:
            if e.status == 404:
                raise PodNotFoundError(namespace, name) from None
            raise

    def get_node(self, name: str) -> dict[str, Any]:
        return self._request("GET", f"/api/v1/nodes/{name}")

    def get_config_map(self, namespace: str, name: str) -> dict[str, Any]:
        return self._request(
            "GET", f"/api/v1/namespaces/{namespace}/configmaps/{name}")

    def create_config_map(self, namespace: str,
                          obj: dict[str, Any]) -> dict[str, Any]:
        return self._request(
            "POST", f"/api/v1/namespaces/{namespace}/configmaps", body=obj)

    def patch_config_map(self, namespace: str, name: str,
                         patch: dict[str, Any],
                         resource_version: str | None = None
                         ) -> dict[str, Any]:
        if resource_version is not None:
            meta = dict(patch.get("metadata") or {})
            meta["resourceVersion"] = resource_version
            patch = {**patch, "metadata": meta}
        return self._request(
            "PATCH",
            f"/api/v1/namespaces/{namespace}/configmaps/{name}",
            body=patch, content_type="application/merge-patch+json")

    def delete_config_map(self, namespace: str, name: str) -> None:
        try:
            self._request(
                "DELETE",
                f"/api/v1/namespaces/{namespace}/configmaps/{name}")
        except K8sApiError as e:
            if e.status != 404:
                raise

    def create_event(self, namespace: str,
                     event: dict[str, Any]) -> dict[str, Any]:
        return self._request(
            "POST", f"/api/v1/namespaces/{namespace}/events", body=event)

    def watch_pods(self, namespace: str, label_selector: str | None = None,
                   field_selector: str | None = None,
                   timeout_s: float = 60.0,
                   resource_version: str | None = None
                   ) -> Iterator[WatchEvent]:
        # Mid-stream death (connection reset, apiserver rolling restart)
        # RESUMES from the last seen resourceVersion instead of aborting
        # the caller's wait — a watch-based state machine survives a
        # flaky stream without losing events.
        return _resilient_watch(
            lambda remaining_s, rv: self._watch_stream(
                namespace, label_selector, field_selector, remaining_s, rv),
            timeout_s, resource_version, self.retry_policy)

    def _watch_stream(self, namespace: str, label_selector: str | None,
                      field_selector: str | None, timeout_s: float,
                      resource_version: str | None
                      ) -> Iterator[WatchEvent]:
        """ONE watch connection; ends at the server-side timeout, raises a
        status-0 :class:`K8sApiError` on mid-stream transport death (the
        resume layer's signal) and propagates ERROR events (410 Gone ⇒
        caller re-LISTs)."""
        query = {"watch": "true",
                 "timeoutSeconds": str(max(1, int(timeout_s)))}
        if label_selector:
            query["labelSelector"] = label_selector
        if field_selector:
            query["fieldSelector"] = field_selector
        if resource_version:
            query["resourceVersion"] = resource_version
        resp = self._request("GET", f"/api/v1/namespaces/{namespace}/pods",
                             query=query, stream=True,
                             timeout=timeout_s + 5.0)
        try:
            with resp:
                for line in resp:
                    if not line.strip():
                        continue
                    try:
                        event = json.loads(line)
                    except json.JSONDecodeError:
                        logger.warning("unparseable watch line: %r",
                                       line[:200])
                        continue
                    etype = event.get("type", "")
                    obj = event.get("object", {})
                    if etype == "ERROR":
                        # e.g. 410 Gone: the resourceVersion is too old;
                        # callers re-LIST and restart the watch.
                        raise K8sApiError(int(obj.get("code", 0) or 0),
                                          obj.get("message",
                                                  "watch error event"))
                    yield etype, obj
        except OSError as e:
            # Mid-stream network failure: surface a typed status-0 error
            # so the resume layer re-establishes the stream from the last
            # seen resourceVersion (and exhausted resumes still reach the
            # caller's cleanup paths as a typed error).
            raise K8sApiError(0, f"watch stream broken: {e}",
                              cause="reset") from e


class InClusterKubeClient(RestKubeClient):
    """Talks to the apiserver with the pod's serviceaccount credentials.

    Mirrors client-go in-cluster config: host/port from
    ``KUBERNETES_SERVICE_HOST/PORT``, bearer token + CA from the mounted
    serviceaccount volume (ref ``pkg/config/config.go:18-28``).
    """

    def __init__(self, host: str | None = None,
                 sa_dir: str = SERVICEACCOUNT_DIR):
        if host is None:
            khost = os.environ.get("KUBERNETES_SERVICE_HOST")
            kport = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            if not khost:
                raise K8sApiError(
                    0, "KUBERNETES_SERVICE_HOST unset: not running in-cluster")
            host = f"https://{khost}:{kport}"
        self.base = host.rstrip("/")
        self._sa_dir = sa_dir
        self._token_path = os.path.join(sa_dir, "token")
        ca_path = os.path.join(sa_dir, "ca.crt")
        if os.path.exists(ca_path):
            self._ssl = ssl.create_default_context(cafile=ca_path)
        else:  # e.g. test apiserver over plain http
            self._ssl = None

    def _token(self) -> str:
        # Re-read every request: serviceaccount tokens are rotated by kubelet.
        try:
            with open(self._token_path) as f:
                return f.read().strip()
        except OSError:
            return ""


class KubeconfigKubeClient(RestKubeClient):
    """Out-of-cluster client configured from a kubeconfig file.

    Resolves the ``current-context`` (overridable via ``context``) to a
    cluster (server URL, CA bundle, optional insecure-skip-tls-verify) and a
    user (bearer token / tokenFile, or client certificate+key — inline
    ``*-data`` base64 fields or file paths). Exec plugins / auth-provider
    refresh flows are out of scope and raise a clear error rather than
    silently sending unauthenticated requests.

    The reference left this path as a hardcoded placeholder
    (``pkg/config/config.go:18-28``: "Need fix if out of cluster deploy");
    this is the real implementation.
    """

    def __init__(self, path: str | None = None, context: str | None = None):
        if path is None:
            # $KUBECONFIG is a colon-separated path list (client-go
            # semantics); full multi-file merging is out of scope — use the
            # first entry that exists.
            env = os.environ.get("KUBECONFIG", "")
            candidates = [p for p in env.split(os.pathsep) if p] or \
                [os.path.expanduser("~/.kube/config")]
            path = next((p for p in candidates if os.path.exists(p)),
                        candidates[0])
        try:
            with open(path) as f:
                cfg = _load_kubeconfig_yaml(f.read())
        except OSError as e:
            raise K8sApiError(0, f"kubeconfig unreadable: {path}: {e}") from e
        except K8sApiError:
            raise
        except Exception as e:  # yaml.YAMLError et al: keep the typed contract
            raise K8sApiError(0, f"kubeconfig unparseable: {path}: {e}") from e
        if not isinstance(cfg, dict):
            raise K8sApiError(0, f"kubeconfig {path}: not a mapping")
        ctx_name = context or cfg.get("current-context")
        if not ctx_name:
            raise K8sApiError(0, f"kubeconfig {path}: no current-context")
        ctx = _named_entry(cfg, "contexts", ctx_name, "context")
        cluster = _named_entry(cfg, "clusters", ctx.get("cluster"), "cluster")
        user = _named_entry(cfg, "users", ctx.get("user"), "user") \
            if ctx.get("user") else {}

        server = cluster.get("server", "")
        if not server:
            raise K8sApiError(0, f"kubeconfig {path}: cluster has no server")
        self.base = server.rstrip("/")
        self._kubeconfig_path = path
        self.context_name = ctx_name
        self.namespace = ctx.get("namespace", "default")

        for key in ("exec", "auth-provider", "username", "password"):
            # Fail-closed: unsupported auth mechanisms error at construction
            # instead of silently sending anonymous requests.
            if user.get(key):
                raise K8sApiError(
                    0, f"kubeconfig {path}: user uses '{key}' auth, which is "
                       "unsupported — use a token or client certificate")

        self._static_token = user.get("token", "")
        self._token_file = user.get("tokenFile", "")
        if self._token_file and not os.path.isabs(self._token_file):
            # client-go's ResolveLocalPaths: relative to the kubeconfig.
            self._token_file = os.path.join(
                os.path.dirname(path), self._token_file)

        self._ssl = None
        if self.base.startswith("https"):
            try:
                with _Materialised(cluster, "certificate-authority",
                                   path) as ca, \
                     _Materialised(user, "client-certificate", path) as cert, \
                     _Materialised(user, "client-key", path) as key:
                    if cluster.get("insecure-skip-tls-verify"):
                        self._ssl = ssl._create_unverified_context()
                    elif ca.file:
                        self._ssl = ssl.create_default_context(cafile=ca.file)
                    else:
                        self._ssl = ssl.create_default_context()
                    if cert.file:
                        self._ssl.load_cert_chain(cert.file, key.file or None)
                    elif key.file:
                        # Fail-closed (client-go parity): a client key
                        # without its certificate half would silently
                        # proceed anonymous/token-less.
                        raise K8sApiError(
                            0, f"kubeconfig {path}: user has client-key "
                               "material but no client-certificate")
            except K8sApiError:
                raise
            except (OSError, ssl.SSLError) as e:
                raise K8sApiError(
                    0, f"kubeconfig {path}: TLS material unusable: {e}") from e

    def _token(self) -> str:
        if self._static_token:
            return self._static_token
        if self._token_file:
            try:
                with open(self._token_file) as f:
                    return f.read().strip()
            except OSError as e:
                # Never degrade to anonymous requests (class contract).
                raise K8sApiError(
                    0, f"kubeconfig tokenFile unreadable: "
                       f"{self._token_file}: {e}") from e
        return ""


def _load_kubeconfig_yaml(text: str) -> Any:
    try:
        import yaml  # deferred: only the out-of-cluster path needs it
    except ModuleNotFoundError as e:
        raise K8sApiError(
            0, "kubeconfig support needs PyYAML (pip install pyyaml); "
               "the in-cluster path does not") from e
    return yaml.safe_load(text)


def _named_entry(cfg: dict, section: str, name: str | None,
                 inner: str) -> dict:
    for item in cfg.get(section) or []:
        if isinstance(item, dict) and item.get("name") == name:
            return item.get(inner) or {}
    raise K8sApiError(
        0, f"kubeconfig: no entry named {name!r} in {section!r}")


class _Materialised:
    """Context manager resolving ``<field>`` (a file path, relative to the
    kubeconfig) or ``<field>-data`` (inline base64) to an on-disk path the
    ssl module can load. Inline data — which may be a client private key —
    goes to a mode-0600 temp file that is deleted on exit, so secrets never
    outlive the ssl-context construction."""

    def __init__(self, entry: dict, field: str, kubeconfig_path: str):
        self.file = ""
        self._tmp = None
        data = entry.get(f"{field}-data")
        if data:
            import base64
            import tempfile
            try:
                raw = base64.b64decode(data, validate=True)
            except Exception as e:
                raise K8sApiError(
                    0, f"kubeconfig: bad base64 in {field}-data: {e}") from e
            self._tmp = tempfile.NamedTemporaryFile(
                prefix=f"kubeconfig-{field}-", suffix=".pem")
            self._tmp.write(raw)
            self._tmp.flush()
            self.file = self._tmp.name
        else:
            p = entry.get(field, "")
            if p and not os.path.isabs(p):
                p = os.path.join(os.path.dirname(kubeconfig_path), p)
            self.file = p

    def __enter__(self) -> "_Materialised":
        return self

    def __exit__(self, *exc) -> None:
        if self._tmp is not None:
            self._tmp.close()  # NamedTemporaryFile: close unlinks


def default_kube_client() -> KubeClient:
    """controller-runtime-style fallback chain: an explicit $KUBECONFIG
    always wins (every in-cluster pod has KUBERNETES_SERVICE_HOST injected,
    so the env var must be able to override it), then in-cluster, then
    ~/.kube/config if present."""
    if os.environ.get("KUBECONFIG"):
        return KubeconfigKubeClient()
    if os.environ.get("KUBERNETES_SERVICE_HOST"):
        return InClusterKubeClient()
    return KubeconfigKubeClient()


# -- test fake -----------------------------------------------------------------


def _json_merge_patch(target: dict, patch: dict) -> None:
    """RFC 7386 merge patch, in place: dicts merge recursively, ``None``
    deletes the key, everything else replaces."""
    for key, value in patch.items():
        if value is None:
            target.pop(key, None)
        elif isinstance(value, dict) and isinstance(target.get(key), dict):
            _json_merge_patch(target[key], value)
        else:
            target[key] = value


def _match_label_selector(pod: objects.Pod, selector: str | None) -> bool:
    if not selector:
        return True
    pod_labels = objects.labels(pod)
    for clause in selector.split(","):
        key, _, value = clause.partition("=")
        if pod_labels.get(key.strip()) != value.strip():
            return False
    return True


class FakeKubeClient(KubeClient):
    """In-memory apiserver for tests.

    ``on_create`` hooks play the scheduler/kubelet: each is called with the
    stored pod dict right after creation (in a background thread, so watch
    consumers see events asynchronously like the real thing) and may mutate it
    via :meth:`set_pod_status`.
    """

    def __init__(self):
        self._lock = threading.Condition()
        self._pods: dict[tuple[str, str], objects.Pod] = {}
        self._nodes: dict[str, dict[str, Any]] = {}
        # ConfigMaps (HA intent store + election locks) with their own
        # monotonic resourceVersion stream; cm_calls counts every
        # configmap round-trip so tests can pin "HA off = zero traffic".
        self._cms: dict[tuple[str, str], dict[str, Any]] = {}
        self._cm_rv = 0
        self.cm_calls = 0
        self._events: list[tuple[str, objects.Pod]] = []
        self._watches_ended = False
        self.on_create: list[Callable[[objects.Pod], None]] = []
        self.on_delete: list[Callable[[objects.Pod], None]] = []
        self.created: list[objects.Pod] = []
        self.deleted: list[tuple[str, str]] = []
        self.events: list[dict[str, Any]] = []
        # When >0, delete_pod keeps the pod visible for this long (simulates
        # graceful termination) before it disappears.
        self.delete_latency_s: float = 0.0
        # Deterministic fault injection (testing/chaos.py FaultInjector):
        # every verb consults it INSIDE the retry layer, so injected error
        # bursts/latency exercise the identical backoff machinery
        # production sees — the fake carries the resilience layer the same
        # way it carries the k8s_call instrumentation.
        self.faults = None
        # Fast backoff for tests; chaos plans can swap their own.
        self.retry_policy = RetryPolicy(max_attempts=4, base_delay_s=0.01,
                                        max_delay_s=0.1, deadline_s=10.0,
                                        jitter=0.0)
        self._retry_budget = RetryBudget(capacity=1000.0,
                                         deposit_per_success=1.0)

    def _fault(self, verb: str, resource: str) -> None:
        injector = self.faults
        if injector is not None:
            injector.fire(verb, resource)

    def _retry(self, fn, classify=retryable):
        return call_with_retry(fn, policy=self.retry_policy,
                               target="apiserver", classify=classify,
                               budget=self._retry_budget)

    # -- test scripting API ----------------------------------------------------

    def put_pod(self, pod: objects.Pod) -> None:
        """Insert/replace a pod without firing on_create hooks."""
        key = (objects.namespace(pod), objects.name(pod))
        with self._lock:
            event = "MODIFIED" if key in self._pods else "ADDED"
            self._pods[key] = pod
            self._record(event, pod)

    def end_watches(self) -> None:
        """End every watch stream at its next wait, as an apiserver that
        shuts down does: a consumer's thread leaves its stream at once
        instead of at the end of its chunk."""
        with self._lock:
            self._watches_ended = True
            self._lock.notify_all()

    def put_node(self, node: dict[str, Any]) -> None:
        with self._lock:
            self._nodes[node.get("metadata", {}).get("name", "")] = node

    def get_node(self, name: str) -> dict[str, Any]:
        return self._retry(lambda: self._get_node_once(name))

    def _get_node_once(self, name: str) -> dict[str, Any]:
        with k8s_call("GET", "nodes"):
            self._fault("GET", "nodes")
            with self._lock:
                node = self._nodes.get(name)
                if node is None:
                    raise K8sApiError(404, f"node {name} not found")
                return json.loads(json.dumps(node))

    # -- ConfigMaps (HA intent store / election locks) -------------------------

    def get_config_map(self, namespace: str, name: str) -> dict[str, Any]:
        return self._retry(lambda: self._get_cm_once(namespace, name))

    def _get_cm_once(self, namespace: str, name: str) -> dict[str, Any]:
        with k8s_call("GET", "configmaps"):
            self._fault("GET", "configmaps")
            with self._lock:
                self.cm_calls += 1
                cm = self._cms.get((namespace, name))
                if cm is None:
                    raise K8sApiError(
                        404, f"configmap {namespace}/{name} not found")
                return json.loads(json.dumps(cm))

    def create_config_map(self, namespace: str,
                          obj: dict[str, Any]) -> dict[str, Any]:
        return self._retry(lambda: self._create_cm_once(namespace, obj),
                           classify=retryable_non_idempotent)

    def _create_cm_once(self, namespace: str,
                        obj: dict[str, Any]) -> dict[str, Any]:
        with k8s_call("POST", "configmaps"):
            self._fault("POST", "configmaps")
            obj = json.loads(json.dumps(obj))
            meta = obj.setdefault("metadata", {})
            meta.setdefault("namespace", namespace)
            key = (namespace, meta.get("name", ""))
            with self._lock:
                self.cm_calls += 1
                if key in self._cms:
                    raise K8sApiError(
                        409, f"configmap {key} already exists")
                self._cm_rv += 1
                meta["resourceVersion"] = str(self._cm_rv)
                self._cms[key] = obj
                return json.loads(json.dumps(obj))

    def patch_config_map(self, namespace: str, name: str,
                         patch: dict[str, Any],
                         resource_version: str | None = None
                         ) -> dict[str, Any]:
        return self._retry(lambda: self._patch_cm_once(
            namespace, name, patch, resource_version))

    def _patch_cm_once(self, namespace: str, name: str,
                       patch: dict[str, Any],
                       resource_version: str | None = None
                       ) -> dict[str, Any]:
        patch = json.loads(json.dumps(patch))
        # the precondition is consumed here, not merged into the object
        patch.get("metadata", {}).pop("resourceVersion", None)
        with k8s_call("PATCH", "configmaps"):
            self._fault("PATCH", "configmaps")
            with self._lock:
                self.cm_calls += 1
                cm = self._cms.get((namespace, name))
                if cm is None:
                    raise K8sApiError(
                        404, f"configmap {namespace}/{name} not found")
                live_rv = cm.get("metadata", {}).get("resourceVersion", "")
                if resource_version is not None \
                        and live_rv != resource_version:
                    raise K8sApiError(
                        409, f"Operation cannot be fulfilled on configmaps "
                             f"{name!r}: the object has been modified "
                             f"(have {live_rv}, precondition "
                             f"{resource_version})")
                _json_merge_patch(cm, patch)
                self._cm_rv += 1
                cm.setdefault("metadata", {})["resourceVersion"] = \
                    str(self._cm_rv)
                return json.loads(json.dumps(cm))

    def delete_config_map(self, namespace: str, name: str) -> None:
        self._retry(lambda: self._delete_cm_once(namespace, name))

    def _delete_cm_once(self, namespace: str, name: str) -> None:
        with k8s_call("DELETE", "configmaps"):
            self._fault("DELETE", "configmaps")
            with self._lock:
                self.cm_calls += 1
                self._cms.pop((namespace, name), None)

    def create_event(self, namespace: str,
                     event: dict[str, Any]) -> dict[str, Any]:
        return self._retry(lambda: self._create_event_once(namespace, event),
                           classify=retryable_non_idempotent)

    def _create_event_once(self, namespace: str,
                           event: dict[str, Any]) -> dict[str, Any]:
        with k8s_call("POST", "events"):
            self._fault("POST", "events")
            event = json.loads(json.dumps(event))
            event.setdefault("metadata", {}).setdefault("namespace",
                                                        namespace)
            with self._lock:
                self.events.append(event)
            return event

    def set_pod_status(self, namespace: str, name: str,
                       **status: Any) -> None:
        """Merge fields into pod.status and emit MODIFIED."""
        with self._lock:
            pod = self._pods[(namespace, name)]
            pod.setdefault("status", {}).update(status)
            self._record("MODIFIED", pod)

    def _record(self, event_type: str, pod: objects.Pod) -> None:
        # Event index is the resourceVersion: monotonically increasing,
        # stamped on the STORED object too (like a real apiserver) so
        # get/list return versions that patch preconditions can cite.
        pod.setdefault("metadata", {})["resourceVersion"] = \
            str(len(self._events) + 1)
        copy = json.loads(json.dumps(pod))
        self._events.append((event_type, copy))
        self._lock.notify_all()

    # -- KubeClient ------------------------------------------------------------

    # Public KubeClient methods carry the same k8s_call instrumentation as
    # the REST client, so a fake-stack e2e trace shows the identical
    # apiserver child spans and k8s_request_seconds series production
    # would — the instrumentation layer is part of the contract under test.

    def get_pod(self, namespace: str, name: str) -> objects.Pod:
        return self._retry(lambda: self._get_pod_once(namespace, name))

    def _get_pod_once(self, namespace: str, name: str) -> objects.Pod:
        with k8s_call("GET", "pods"):
            self._fault("GET", "pods")
            with self._lock:
                pod = self._pods.get((namespace, name))
                if pod is None:
                    raise PodNotFoundError(namespace, name)
                return json.loads(json.dumps(pod))

    def list_pods(self, namespace: str,
                  label_selector: str | None = None) -> list[objects.Pod]:
        return self.list_pods_with_version(namespace, label_selector)[0]

    def list_pods_with_version(
            self, namespace: str, label_selector: str | None = None
    ) -> tuple[list[objects.Pod], str]:
        return self._retry(
            lambda: self._list_pods_once(namespace, label_selector))

    def _list_pods_once(
            self, namespace: str, label_selector: str | None = None
    ) -> tuple[list[objects.Pod], str]:
        with k8s_call("LIST", "pods"):
            self._fault("LIST", "pods")
            with self._lock:
                pods = [json.loads(json.dumps(p))
                        for (ns, _), p in self._pods.items()
                        if ns == namespace
                        and _match_label_selector(p, label_selector)]
                return pods, str(len(self._events))

    def create_pod(self, namespace: str, pod: objects.Pod) -> objects.Pod:
        # POST is not idempotent: a timed-out create may have landed, and
        # replaying it would 409 against our own object — stricter
        # classifier, same as the REST client
        return self._retry(lambda: self._create_pod_once(namespace, pod),
                           classify=retryable_non_idempotent)

    def _create_pod_once(self, namespace: str,
                         pod: objects.Pod) -> objects.Pod:
        with k8s_call("POST", "pods"):
            self._fault("POST", "pods")
            pod = json.loads(json.dumps(pod))
            pod.setdefault("metadata", {}).setdefault("namespace", namespace)
            pod["metadata"].setdefault(
                "uid", f"uid-{objects.name(pod)}")
            pod.setdefault("status", {}).setdefault("phase", "Pending")
            key = (namespace, objects.name(pod))
            with self._lock:
                if key in self._pods:
                    raise K8sApiError(409, f"pod {key} already exists")
                self._pods[key] = pod
                self.created.append(pod)
                self._record("ADDED", pod)
        for hook in list(self.on_create):
            threading.Thread(target=hook, args=(pod,), daemon=True).start()
        return json.loads(json.dumps(pod))

    def delete_pod(self, namespace: str, name: str,
                   grace_period_seconds: int = 0,
                   resource_version: str | None = None) -> None:
        self._retry(lambda: self._delete_pod_once(namespace, name,
                                                  resource_version))

    def _delete_pod_once(self, namespace: str, name: str,
                         resource_version: str | None = None) -> None:
        def _remove():
            with self._lock:
                pod = self._pods.pop((namespace, name), None)
                if pod is not None:
                    self._record("DELETED", pod)
            if pod is not None:
                for hook in list(self.on_delete):
                    hook(pod)
        with k8s_call("DELETE", "pods"):
            self._fault("DELETE", "pods")
            with self._lock:
                if resource_version is not None:
                    pod = self._pods.get((namespace, name))
                    if pod is not None:
                        live_rv = pod.get("metadata", {}).get(
                            "resourceVersion", "")
                        if live_rv != resource_version:
                            raise K8sApiError(
                                409, f"Precondition failed: pod {name!r} is "
                                     f"at {live_rv}, delete expected "
                                     f"{resource_version}")
                self.deleted.append((namespace, name))
        if self.delete_latency_s > 0:
            t = threading.Timer(self.delete_latency_s, _remove)
            t.daemon = True
            t.start()
        else:
            _remove()

    def patch_pod(self, namespace: str, name: str, patch: dict[str, Any],
                  resource_version: str | None = None) -> objects.Pod:
        return self._retry(lambda: self._patch_pod_once(namespace, name,
                                                        patch,
                                                        resource_version))

    def _patch_pod_once(self, namespace: str, name: str,
                        patch: dict[str, Any],
                        resource_version: str | None = None) -> objects.Pod:
        patch = json.loads(json.dumps(patch))
        # the precondition is consumed here, not merged into the object
        patch.get("metadata", {}).pop("resourceVersion", None)
        with k8s_call("PATCH", "pods"):
            self._fault("PATCH", "pods")
            with self._lock:
                pod = self._pods.get((namespace, name))
                if pod is None:
                    raise PodNotFoundError(namespace, name)
                live_rv = pod.get("metadata", {}).get("resourceVersion", "")
                if resource_version is not None \
                        and live_rv != resource_version:
                    raise K8sApiError(
                        409, f"Operation cannot be fulfilled on pods "
                             f"{name!r}: the object has been modified "
                             f"(have {live_rv}, precondition "
                             f"{resource_version})")
                _json_merge_patch(pod, patch)
                self._record("MODIFIED", pod)
                return json.loads(json.dumps(pod))

    def watch_pods(self, namespace: str, label_selector: str | None = None,
                   field_selector: str | None = None,
                   timeout_s: float = 60.0,
                   resource_version: str | None = None
                   ) -> Iterator[WatchEvent]:
        # Same resume-on-stream-death semantics as the REST client: an
        # injected mid-stream fault re-enters _watch_once from the last
        # seen resourceVersion, so chaos plans exercise production's
        # resume machinery through the fake.
        return _resilient_watch(
            lambda remaining_s, rv: self._watch_once(
                namespace, label_selector, field_selector, remaining_s, rv),
            timeout_s, resource_version, self.retry_policy)

    def _watch_once(self, namespace: str, label_selector: str | None = None,
                    field_selector: str | None = None,
                    timeout_s: float = 60.0,
                    resource_version: str | None = None
                    ) -> Iterator[WatchEvent]:
        # Replays the event log from ``resource_version`` (default: from the
        # beginning, equivalent to resourceVersion=0) then follows new
        # events. Event index == resourceVersion, matching
        # list_pods_with_version.
        deadline = time.monotonic() + timeout_s
        try:
            cursor = int(resource_version or 0)
        except ValueError:
            cursor = 0
        field_name = None
        if field_selector and field_selector.startswith("metadata.name="):
            field_name = field_selector.split("=", 1)[1]
        while True:
            # fault check per poll round: a WATCH fault can hang the stream
            # (latency) or kill it mid-flight (status-0 error → resume)
            self._fault("WATCH", "pods")
            with self._lock:
                while cursor >= len(self._events):
                    if self._watches_ended:
                        return
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._lock.wait(
                            timeout=min(remaining, 0.5)):
                        if time.monotonic() >= deadline:
                            return
                batch = self._events[cursor:]
                cursor = len(self._events)
            for event_type, pod in batch:
                if objects.namespace(pod) != namespace:
                    continue
                if not _match_label_selector(pod, label_selector):
                    continue
                if field_name and objects.name(pod) != field_name:
                    continue
                yield event_type, pod
            if time.monotonic() >= deadline:
                return
