"""Stub ``nvidia.com/gpu`` kubelet device plugin (v1beta1; the port of
:mod:`gpumounter_tpu.testing.device_plugin`).

The kind e2e's keystone: on a node with no GPUs, this plugin registers
``nvidia.com/gpu`` with the real kubelet and advertises N fake GPUs by
driver-shaped UUID (``GPU-...``, as NVIDIA's plugin names them), so the
REAL scheduler + kubelet run the slave-pod accounting path end to end.

Allocate responses bind-mount the fixture nodes (``<dev_root>/nvidiaN`` at
195:N, and the companions every GPU shares: ``nvidiactl`` at 195:255 and
the ``nvidia-uvm`` pair at a uvm major, each with its ``.majmin`` sidecar)
into the container under ``/dev`` — regular files, mountable anywhere,
accepted by the enumerators with ``allow_fake`` (device/fake.py's format).

Without a ``plugin_dir`` the plugin serves under a fresh, short temporary
directory: a unix socket path must fit ``sun_path`` (108 bytes), which a
deep per-test temporary directory does not always.

CLI (inside the kind node / a privileged pod with the kubelet dirs):

    python -m gpumounter_tpu_torch.testing.device_plugin \\
        --devices 4 --dev-root /var/lib/gpumounter-fake-dev \\
        [--plugin-dir /var/lib/kubelet/device-plugins]

Creates the fixture files, serves DevicePlugin on
``<plugin-dir>/gpumounter-stub.sock``, registers with the kubelet, and
re-registers if the kubelet restarts (its Registration socket reappears).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import os
import shutil
import tempfile
import threading

from gpumounter_tpu_torch.device.fake import FAKE_COMPANIONS, fake_uuid
from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("testing.device_plugin")

KUBELET_PLUGIN_DIR = "/var/lib/kubelet/device-plugins"
ENDPOINT = "gpumounter-stub.sock"
API_VERSION = "v1beta1"
# sun_path holds 108 bytes including the terminating NUL
UNIX_PATH_MAX = 107


def _write_node(dev_root: str, name: str, major: int, minor: int) -> None:
    path = os.path.join(dev_root, name)
    with open(path, "w"):
        pass
    with open(path + ".majmin", "w") as f:
        f.write(f"{major}:{minor}")


def make_fixture_gpus(dev_root: str, n: int) -> list[str]:
    """Fixture GPU nodes in the fake-device format every enumerator accepts
    with allow_fake (regular file + ``.majmin`` sidecar): ``nvidiaN`` at
    195:N and the shared companions. Returns the GPUs' UUIDs."""
    os.makedirs(dev_root, exist_ok=True)
    for i in range(n):
        _write_node(dev_root, f"nvidia{i}", consts.NVIDIA_MAJOR, i)
    for node in FAKE_COMPANIONS:
        _write_node(dev_root, os.path.basename(node.host_path), node.major,
                    node.minor)
    return [fake_uuid(i) for i in range(n)]


class StubGPUPlugin:
    """Serves the DevicePlugin service and handles kubelet registration."""

    def __init__(self, n_devices: int, dev_root: str,
                 plugin_dir: str | None = None,
                 resource_name: str = consts.GPU_RESOURCE_NAME,
                 endpoint: str = ENDPOINT):
        self.n_devices = n_devices
        self.dev_root = dev_root
        self._tmpdir = None
        if plugin_dir is None:
            self._tmpdir = plugin_dir = tempfile.mkdtemp(prefix="dp-")
        self.plugin_dir = plugin_dir
        self.resource_name = resource_name
        self.endpoint = endpoint
        self.socket_path = os.path.join(plugin_dir, endpoint)
        if len(os.fsencode(self.socket_path)) > UNIX_PATH_MAX:
            raise ValueError(
                f"unix socket path is {len(os.fsencode(self.socket_path))} "
                f"bytes, over the {UNIX_PATH_MAX}-byte limit: "
                f"{self.socket_path}")
        self.uuids = [fake_uuid(i) for i in range(n_devices)]
        self._server = None
        self._executor: concurrent.futures.ThreadPoolExecutor | None = None
        self._stop = threading.Event()

    # -- DevicePlugin service handlers ----------------------------------------

    def _options(self, request, context):
        from gpumounter_tpu_torch.api import deviceplugin_pb2 as pb
        return pb.DevicePluginOptions()

    def _list_and_watch(self, request, context):
        from gpumounter_tpu_torch.api import deviceplugin_pb2 as pb
        devices = [pb.Device(ID=uuid, health="Healthy")
                   for uuid in self.uuids]
        yield pb.ListAndWatchResponse(devices=devices)
        # hold the stream open (static device set) until the kubelet
        # cancels or we stop; event-wait so shutdown is prompt
        stop = self._stop
        while not stop.wait(0.5):
            if not context.is_active():
                return

    def _mount(self, cresp, name: str) -> None:
        host = os.path.join(self.dev_root, name)
        for suffix in ("", ".majmin"):
            cresp.mounts.add(container_path=f"/dev/{name}{suffix}",
                             host_path=host + suffix, read_only=False)

    def _allocate(self, request, context):
        from gpumounter_tpu_torch.api import deviceplugin_pb2 as pb
        resp = pb.AllocateResponse()
        for creq in request.container_requests:
            cresp = resp.container_responses.add()
            for device_id in creq.devicesIDs:
                self._mount(cresp, f"nvidia{self.uuids.index(device_id)}")
            # every GPU needs the shared nodes; a container gets them once
            for node in FAKE_COMPANIONS:
                self._mount(cresp, os.path.basename(node.host_path))
        logger.info("Allocate: %s", [list(c.devicesIDs)
                                     for c in request.container_requests])
        return resp

    def _pre_start(self, request, context):
        from gpumounter_tpu_torch.api import deviceplugin_pb2 as pb
        return pb.PreStartContainerResponse()

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "StubGPUPlugin":
        import grpc

        from gpumounter_tpu_torch.api import deviceplugin_pb2 as pb
        # fresh stop event per server generation — resetting it in
        # stop_server would let a concurrent serve_forever miss the signal
        self._stop = threading.Event()
        make_fixture_gpus(self.dev_root, self.n_devices)
        os.makedirs(self.plugin_dir, exist_ok=True)
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        self._executor = concurrent.futures.ThreadPoolExecutor(max_workers=4)
        self._server = grpc.server(self._executor)
        handler = grpc.method_handlers_generic_handler(
            "v1beta1.DevicePlugin", {
                "GetDevicePluginOptions": grpc.unary_unary_rpc_method_handler(
                    self._options,
                    request_deserializer=pb.Empty.FromString,
                    response_serializer=(
                        pb.DevicePluginOptions.SerializeToString)),
                "ListAndWatch": grpc.unary_stream_rpc_method_handler(
                    self._list_and_watch,
                    request_deserializer=pb.Empty.FromString,
                    response_serializer=(
                        pb.ListAndWatchResponse.SerializeToString)),
                "Allocate": grpc.unary_unary_rpc_method_handler(
                    self._allocate,
                    request_deserializer=pb.AllocateRequest.FromString,
                    response_serializer=pb.AllocateResponse.SerializeToString),
                "PreStartContainer": grpc.unary_unary_rpc_method_handler(
                    self._pre_start,
                    request_deserializer=(
                        pb.PreStartContainerRequest.FromString),
                    response_serializer=(
                        pb.PreStartContainerResponse.SerializeToString)),
            })
        self._server.add_generic_rpc_handlers((handler,))
        self._server.add_insecure_port(f"unix://{self.socket_path}")
        self._server.start()
        logger.info("device plugin serving on %s (%d devices)",
                    self.socket_path, self.n_devices)
        return self

    def register(self, kubelet_socket: str | None = None) -> None:
        """Register with the kubelet's Registration service."""
        import grpc

        from gpumounter_tpu_torch.api import deviceplugin_pb2 as pb
        kubelet_socket = kubelet_socket or os.path.join(
            self.plugin_dir, "kubelet.sock")
        channel = grpc.insecure_channel(f"unix://{kubelet_socket}")
        try:
            call = channel.unary_unary(
                "/v1beta1.Registration/Register",
                request_serializer=pb.RegisterRequest.SerializeToString,
                response_deserializer=pb.Empty.FromString)
            call(pb.RegisterRequest(version=API_VERSION,
                                    endpoint=self.endpoint,
                                    resource_name=self.resource_name),
                 timeout=10)
            logger.info("registered %s with kubelet", self.resource_name)
        finally:
            channel.close()

    def serve_forever(self) -> None:
        """Register and re-register when the kubelet restarts (detected by
        our plugin socket disappearing — kubelet wipes the dir on boot)."""
        self.register()
        while not self._stop.wait(3.0):
            if not os.path.exists(self.socket_path):
                logger.info("kubelet restarted; re-serving + re-registering")
                self.stop_server()
                self.start()
                self.register()

    def stop_server(self) -> None:
        self._stop.set()
        if self._server is not None:
            self._server.stop(grace=0)
            self._server = None
        if self._executor is not None:
            self._executor.shutdown(wait=False)
            self._executor = None

    def close(self) -> None:
        """Stop serving and remove the temporary plugin directory, if this
        plugin made one."""
        self.stop_server()
        if self._tmpdir is not None:
            shutil.rmtree(self._tmpdir, ignore_errors=True)
            self._tmpdir = None

    def __enter__(self) -> "StubGPUPlugin":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--devices", type=int, default=4)
    parser.add_argument("--dev-root", default="/var/lib/gpumounter-fake-dev")
    parser.add_argument("--plugin-dir", default=KUBELET_PLUGIN_DIR)
    args = parser.parse_args(argv)
    plugin = StubGPUPlugin(args.devices, args.dev_root, args.plugin_dir)
    plugin.start()
    plugin.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
