"""The port's stub ``nvidia.com/gpu`` device plugin (testing/device_plugin.py)
on the v1beta1 wire, against the control plane's stub on the same calls:
the fixture nodes, ListAndWatch, Allocate and the kubelet registration,
over real unix sockets. The port's plugin serves under a short temporary
directory by default, so its socket path stays inside ``sun_path`` (108
bytes) however deep the test's own temporary directory is (pytest-xdist's
``popen-gwN`` adds to it)."""

import concurrent.futures
import os
import threading

import grpc
import pytest

from gpumounter_tpu.api import deviceplugin_pb2 as jax_pb
from gpumounter_tpu.testing.device_plugin import StubTPUPlugin
from gpumounter_tpu_torch.api import deviceplugin_pb2 as pb
from gpumounter_tpu_torch.device.fake import fake_uuid
from gpumounter_tpu_torch.testing.device_plugin import (UNIX_PATH_MAX,
                                                        StubGPUPlugin)


@pytest.fixture
def plugin(tmp_path):
    with StubGPUPlugin(n_devices=4, dev_root=str(tmp_path / "dev")) as p:
        yield p


def _channel(p):
    return grpc.insecure_channel(f"unix://{p.socket_path}")


def test_both_device_plugin_protos_are_one_file():
    assert pb.DESCRIPTOR.serialized_pb == jax_pb.DESCRIPTOR.serialized_pb
    assert pb.Device is jax_pb.Device or \
        pb.Device.DESCRIPTOR.full_name == jax_pb.Device.DESCRIPTOR.full_name


def test_socket_path_is_short_and_removed_with_the_plugin(tmp_path):
    deep = tmp_path / ("d" * 60) / ("e" * 60)
    with StubGPUPlugin(n_devices=1, dev_root=str(deep / "dev")) as p:
        assert len(os.fsencode(p.socket_path)) <= UNIX_PATH_MAX
        assert os.path.exists(p.socket_path)
        plugin_dir = p.plugin_dir
    assert not os.path.exists(plugin_dir)
    with pytest.raises(ValueError, match="byte limit"):
        StubGPUPlugin(n_devices=1, dev_root=str(deep / "dev"),
                      plugin_dir=str(deep / "device-plugins"))


def test_fixture_gpus_and_companions_created(plugin, tmp_path):
    dev = tmp_path / "dev"
    for i in range(4):
        assert (dev / f"nvidia{i}.majmin").read_text() == f"195:{i}"
        assert (dev / f"nvidia{i}").exists()
    assert (dev / "nvidiactl.majmin").read_text() == "195:255"
    assert (dev / "nvidia-uvm.majmin").read_text().endswith(":0")
    assert (dev / "nvidia-uvm-tools.majmin").read_text().endswith(":1")


def _list_and_watch(p, module):
    with _channel(p) as channel:
        stream = channel.unary_stream(
            "/v1beta1.DevicePlugin/ListAndWatch",
            request_serializer=module.Empty.SerializeToString,
            response_deserializer=module.ListAndWatchResponse.FromString,
        )(module.Empty(), timeout=10)
        first = next(iter(stream))
        stream.cancel()
    return [(d.ID, d.health) for d in first.devices]


def test_list_and_watch_streams_healthy_gpus_by_uuid(plugin, tmp_path):
    got = _list_and_watch(plugin, pb)
    assert got == [(fake_uuid(i), "Healthy") for i in range(4)]
    # the control plane's stub streams the same shape, chip ids by index
    with StubTPUPlugin(n_devices=4, dev_root=str(tmp_path / "tpu-dev"),
                       plugin_dir=plugin.plugin_dir,
                       endpoint="tpu.sock") as tpu:
        assert _list_and_watch(tpu, jax_pb) == [(str(i), "Healthy")
                                                for i in range(4)]


def test_allocate_bind_mounts_fixture_files(plugin, tmp_path):
    with _channel(plugin) as channel:
        call = channel.unary_unary(
            "/v1beta1.DevicePlugin/Allocate",
            request_serializer=pb.AllocateRequest.SerializeToString,
            response_deserializer=pb.AllocateResponse.FromString)
        req = pb.AllocateRequest()
        req.container_requests.add(devicesIDs=[fake_uuid(1), fake_uuid(3)])
        resp = call(req, timeout=10)
    assert len(resp.container_responses) == 1
    mounts = {m.container_path: m.host_path
              for m in resp.container_responses[0].mounts}
    dev = tmp_path / "dev"
    assert mounts["/dev/nvidia1"] == str(dev / "nvidia1")
    assert mounts["/dev/nvidia3.majmin"] == str(dev / "nvidia3.majmin")
    assert "/dev/nvidia0" not in mounts
    for name in ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools"):
        assert mounts[f"/dev/{name}"] == str(dev / name)
        assert mounts[f"/dev/{name}.majmin"] == str(dev / f"{name}.majmin")
    assert len(mounts) == 2 * 5


def test_registers_with_kubelet_socket(plugin):
    received = []
    done = threading.Event()

    def register(request, context):
        received.append(request)
        done.set()
        return pb.Empty()

    kubelet_sock = os.path.join(plugin.plugin_dir, "kubelet.sock")
    server = grpc.server(concurrent.futures.ThreadPoolExecutor(max_workers=1))
    server.add_generic_rpc_handlers((
        grpc.method_handlers_generic_handler("v1beta1.Registration", {
            "Register": grpc.unary_unary_rpc_method_handler(
                register,
                request_deserializer=pb.RegisterRequest.FromString,
                response_serializer=pb.Empty.SerializeToString)}),))
    server.add_insecure_port(f"unix://{kubelet_sock}")
    server.start()
    try:
        plugin.register()
        assert done.wait(5)
        req = received[0]
        assert (req.version, req.endpoint, req.resource_name) == (
            "v1beta1", "gpumounter-stub.sock", "nvidia.com/gpu")
    finally:
        server.stop(grace=0)
