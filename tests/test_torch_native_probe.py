"""The port's native libgpuprobe.so: the scenarios of the Python
enumerator on the same fixture trees, so the two implementations are
pinned to the same behaviour (the counterpart of
tests/test_native_probe.py)."""

import os
import subprocess

import pytest

from gpumounter_tpu_torch.device.enumerator import PyEnumerator
from gpumounter_tpu_torch.device.fake import fake_uuid
from gpumounter_tpu_torch.device.native_enumerator import (NativeEnumerator,
                                                           best_enumerator,
                                                           load_library)
from test_torch_device import gpu_host, link_fd, make_gpu_tree, pci_of  # noqa: F401

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "gpumounter_tpu_torch", "native")


@pytest.fixture(scope="module", autouse=True)
def build_native():
    subprocess.run(["make", "-C", NATIVE_DIR], check=True,
                   capture_output=True)


def _shape(devices):
    return [(d.index, d.device_path, d.major, d.minor, d.uuid,
             d.pci_address, d.companions) for d in devices]


def test_library_loads():
    assert load_library() is not None


def test_native_enumerate_matches_python(gpu_host):
    make_gpu_tree(gpu_host, range(4))
    native = NativeEnumerator(gpu_host, allow_fake=True)
    py = PyEnumerator(gpu_host, allow_fake=True)
    assert _shape(native.enumerate()) == _shape(py.enumerate())
    assert len(native.enumerate()) == 4
    assert native.uuid_source == py.uuid_source == "proc"
    assert [d.uuid for d in native.enumerate()] == [fake_uuid(i)
                                                    for i in range(4)]
    assert native.enumerate()[1].pci_address == pci_of(1)


def test_native_ignores_fake_without_flag(gpu_host):
    make_gpu_tree(gpu_host, range(2))
    assert NativeEnumerator(gpu_host, allow_fake=False).enumerate() == []


def test_native_skips_names_and_majors_that_are_not_gpus(gpu_host):
    make_gpu_tree(gpu_host, range(3))
    for name in ("nvidia-modeset", "nvidia+1", "nvidia-1", "nvidia2x"):
        open(os.path.join(gpu_host.dev_root, name), "w").close()
    with open(os.path.join(gpu_host.dev_root, "nvidia1.majmin"), "w") as f:
        f.write("120:1")
    native = NativeEnumerator(gpu_host, allow_fake=True).enumerate()
    assert [d.index for d in native] == [0, 2]
    assert _shape(native) == _shape(
        PyEnumerator(gpu_host, allow_fake=True).enumerate())


def test_native_nvml_fallback_matches_python(gpu_host):
    from test_torch_device import FakeNvml
    from gpumounter_tpu_torch.device import enumerator as en
    make_gpu_tree(gpu_host, [0, 3], identities=False)

    def nvml():
        return en.nvml_identities(FakeNvml([(3, fake_uuid(3),
                                             "00000000:1B:00.0")]))

    native = NativeEnumerator(gpu_host, allow_fake=True, nvml=nvml)
    py = PyEnumerator(gpu_host, allow_fake=True, nvml=nvml)
    assert _shape(native.enumerate()) == _shape(py.enumerate())
    assert native.uuid_source == py.uuid_source == "nvml"
    assert [d.uuid for d in native.enumerate()] == ["", fake_uuid(3)]


def test_native_driver_major(gpu_host):
    make_gpu_tree(gpu_host, [])
    enum = NativeEnumerator(gpu_host, allow_fake=True)
    assert enum.driver_major("nvidia") == 195
    assert enum.driver_major("nvidia-uvm") == 510
    assert enum.driver_major("nosuch") is None


def test_native_busy_detection(gpu_host):
    make_gpu_tree(gpu_host, [0])
    node = os.path.join(gpu_host.dev_root, "nvidia0")
    link_fd(gpu_host, 100, 7, node)
    os.makedirs(os.path.join(gpu_host.proc_root, "200", "fd"))
    enum = NativeEnumerator(gpu_host, allow_fake=True)
    assert enum.device_open_pids([100, 200, 300], [node]) == [100]
    assert enum.device_open_pids([], [node]) == []
    assert PyEnumerator(gpu_host).device_open_pids([100, 200, 300],
                                                   [node]) == [100]


def test_best_enumerator_prefers_native(gpu_host):
    assert isinstance(best_enumerator(gpu_host), NativeEnumerator)
