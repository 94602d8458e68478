"""A real HTTP apiserver facade over a :class:`FakeKubeClient`.

The port's own copy of :mod:`gpumounter_tpu.testing.http_apiserver`.

Process-level boot tests launch the ACTUAL worker/master binaries
(``python -m gpumounter_tpu_torch.worker.main``) as subprocesses; those
binaries speak the Kubernetes REST API through their kubeconfig client, so
the test side needs a genuine HTTP server — not an in-process fake. This
adapter translates the pods/nodes REST surface (the exact subset
``k8s/client.py`` uses: get/list/create/delete/watch + node get) onto a
FakeKubeClient, which means every ClusterSim scheduler script
(on_create hooks assigning chips, Unschedulable scenarios, delete latency)
works unchanged across the process boundary.
"""

from __future__ import annotations

import json
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from gpumounter_tpu_torch.k8s.client import FakeKubeClient
from gpumounter_tpu_torch.utils.errors import K8sApiError, PodNotFoundError


class HttpApiserver:
    """``serve(FakeKubeClient)`` → base URL; ``close()`` stops it.

    ``faults`` (a testing/chaos.py FaultInjector) is consulted at the
    HTTP layer before dispatch, so chaos plans can inject GENUINE
    connection drops and latency against the real REST client — the
    in-process FakeKubeClient seam can only simulate them. A
    ``ConnectionDropped`` fault tears the TCP connection with no HTTP
    response, which the client surfaces as a status-0 "reset" error.
    """

    def __init__(self, kube: FakeKubeClient, address: str = "127.0.0.1"):
        self.kube = kube
        self.faults = None
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _inject(self, verb: str, resource: str) -> bool:
                """Fire the fault hook; True = connection torn, abort."""
                if outer.faults is None:
                    return False
                from gpumounter_tpu_torch.testing.chaos import ConnectionDropped
                try:
                    outer.faults.fire(verb, resource)
                except ConnectionDropped:
                    try:
                        self.connection.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    self.close_connection = True
                    return True
                except K8sApiError as e:
                    self._json(e.status or 500, {"message": str(e)})
                    return True
                return False

            def _json(self, code: int, obj) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                q = {k: v[0] for k, v in parse_qs(url.query).items()}
                parts = url.path.strip("/").split("/")
                verb = ("WATCH" if q.get("watch") == "true"
                        else "GET" if len(parts) in (4, 6) else "LIST")
                resource = ("nodes" if parts[2:3] == ["nodes"]
                            else "configmaps"
                            if parts[4:5] == ["configmaps"] else "pods")
                if self._inject(verb, resource):
                    return
                try:
                    if parts[:2] == ["api", "v1"] and \
                            parts[2:3] == ["nodes"] and len(parts) == 4:
                        return self._json(200, outer.kube.get_node(parts[3]))
                    ns = parts[3]
                    if len(parts) == 6 and parts[4] == "configmaps":
                        return self._json(200, outer.kube.get_config_map(
                            ns, parts[5]))
                    if len(parts) == 6:         # single pod GET
                        return self._json(200, outer.kube.get_pod(
                            ns, parts[5]))
                    if q.get("watch") == "true":
                        return self._watch(ns, q)
                    pods, rv = outer.kube.list_pods_with_version(
                        ns, q.get("labelSelector"))
                    return self._json(200, {
                        "items": pods,
                        "metadata": {"resourceVersion": rv}})
                except PodNotFoundError as e:
                    return self._json(404, {"message": str(e)})
                except K8sApiError as e:
                    return self._json(e.status or 500, {"message": str(e)})

            def _watch(self, ns: str, q: dict) -> None:
                timeout = float(q.get("timeoutSeconds", 30))
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                # chunked-free streaming: close delimits the stream, exactly
                # what the client's line iterator expects
                self.send_header("Connection", "close")
                self.end_headers()
                for etype, pod in outer.kube.watch_pods(
                        ns, label_selector=q.get("labelSelector"),
                        field_selector=q.get("fieldSelector"),
                        timeout_s=timeout,
                        resource_version=q.get("resourceVersion")):
                    line = json.dumps({"type": etype, "object": pod}) + "\n"
                    try:
                        self.wfile.write(line.encode())
                        self.wfile.flush()
                    except OSError:
                        return      # client went away mid-stream

            def do_POST(self):
                length = int(self.headers.get("Content-Length") or 0)
                obj = json.loads(self.rfile.read(length) or b"{}")
                parts = self.path.strip("/").split("/")
                ns = parts[3]
                resource = (parts[4] if parts[4:5] in (["events"],
                                                       ["configmaps"])
                            else "pods")
                if self._inject("POST", resource):
                    return
                try:
                    if resource == "events":
                        return self._json(
                            201, outer.kube.create_event(ns, obj))
                    if resource == "configmaps":
                        return self._json(
                            201, outer.kube.create_config_map(ns, obj))
                    return self._json(201, outer.kube.create_pod(ns, obj))
                except K8sApiError as e:
                    return self._json(e.status or 500, {"message": str(e)})

            def do_DELETE(self):
                # the client's DeleteOptions body is read before the reply:
                # a socket closed with bytes unread answers with a RST,
                # which can reach the client before the reply does
                self.rfile.read(int(self.headers.get("Content-Length") or 0))
                parts = urlparse(self.path).path.strip("/").split("/")
                resource = ("configmaps" if parts[4:5] == ["configmaps"]
                            else "pods")
                if self._inject("DELETE", resource):
                    return
                if resource == "configmaps":
                    outer.kube.delete_config_map(parts[3], parts[5])
                else:
                    outer.kube.delete_pod(parts[3], parts[5])
                return self._json(200, {"status": "Success"})

            def do_PATCH(self):
                length = int(self.headers.get("Content-Length") or 0)
                patch = json.loads(self.rfile.read(length) or b"{}")
                parts = urlparse(self.path).path.strip("/").split("/")
                resource = ("configmaps" if parts[4:5] == ["configmaps"]
                            else "pods")
                if self._inject("PATCH", resource):
                    return
                # the rv precondition rides inside metadata, exactly as
                # the REST client sends it (client.py patch_pod)
                rv = (patch.get("metadata") or {}).get("resourceVersion")
                try:
                    if resource == "configmaps":
                        return self._json(200, outer.kube.patch_config_map(
                            parts[3], parts[5], patch, resource_version=rv))
                    return self._json(200, outer.kube.patch_pod(
                        parts[3], parts[5], patch, resource_version=rv))
                except PodNotFoundError as e:
                    return self._json(404, {"message": str(e)})
                except K8sApiError as e:
                    return self._json(e.status or 500, {"message": str(e)})

        self.server = ThreadingHTTPServer((address, 0), Handler)
        # a booted worker's informer holds a WATCH stream open at all
        # times; handler threads must be daemons or server_close() would
        # block on the in-flight chunk for up to its full timeout
        self.server.daemon_threads = True
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()
        self.base = f"http://{address}:{self.server.server_port}"

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()      # release the listening socket


def write_kubeconfig(path: str, server: str) -> str:
    """Minimal token kubeconfig pointing at ``server`` (our facade ignores
    auth; the client requires the file to be well-formed)."""
    import yaml
    cfg = {"apiVersion": "v1", "kind": "Config", "current-context": "boot",
           "contexts": [{"name": "boot",
                         "context": {"cluster": "c", "user": "u"}}],
           "clusters": [{"name": "c", "cluster": {"server": server}}],
           "users": [{"name": "u", "user": {"token": "boot-test"}}]}
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path
