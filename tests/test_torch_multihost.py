"""Multi-host bring-up through the port (tests/test_multihost.py, case
for case).

A slice spans hosts: after the slice attach each pod sees only its host's
GPUs, and its pod process drives all of them through one rank process per
device, the ranks of every pod forming one ``torch.distributed`` world.
Here two probe processes x 4 gloo ranks each must form an 8-device world
(global rank = process id x 4 + local), agree on the collectives, and run
the toy flagship's sharded train step over the spanning mesh; and the
launcher underneath (``dist.LocalWorld``) holds its rank numbering, its
rendezvous and its one-N-per-world rule. Imports no jax.
"""

import json
import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

import torch_slices
import torch_worlds
from gpumounter_tpu_torch.torchcheck import dist as dist_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch_probe_world(num_processes: int, cpu_devices: int,
                        expect: int, timeout_s: float = 420.0):
    """Run the port's probe CLI in ``num_processes`` pod processes of
    ``cpu_devices`` ranks each, forming one world; returns each process's
    parsed JSON report."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "gpumounter_tpu_torch.torchcheck.probe",
             "--expect", str(expect),
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", str(num_processes),
             "--process-id", str(i),
             "--cpu-devices", str(cpu_devices)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env, cwd=REPO)
        for i in range(num_processes)
    ]
    reports = []
    for i, proc in enumerate(procs):
        try:
            out, err = proc.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            pytest.fail(f"probe process {i} timed out after {timeout_s}s")
        assert proc.returncode == 0, (
            f"probe process {i} rc={proc.returncode}\n"
            f"stdout: {out}\nstderr tail: {err[-2000:]}")
        reports.append(json.loads(out.strip().splitlines()[-1]))
    return reports


def test_slice_attach_then_multihost_bringup(tmp_path):
    """The control-plane half (an all-or-nothing slice attach across two
    simulated GPU nodes via the port's /addgpuslice) followed by the
    bring-up each pod then runs: its ranks federate, the collectives
    cross processes, the sharded train step runs."""
    stack = torch_slices.stack(tmp_path, hosts=2, n_chips=4)
    try:
        status, body = torch_slices.post(f"{stack.base}/addgpuslice",
                                         torch_slices.slice_body(2, gpus=4))
        assert status == 200 and body["result"] == "SUCCESS", body
        assert all(p["result"] == "SUCCESS" for p in body["pods"]), body
    finally:
        stack.close()
    reports = _launch_probe_world(num_processes=2, cpu_devices=4, expect=8)
    for report in reports:
        assert report["ok"], report
        assert report["devices"]["device_count"] == 8
        assert report["training"]["ok"], report["training"]


def test_two_process_world_federates_and_trains():
    reports = _launch_probe_world(num_processes=2, cpu_devices=4, expect=8)
    for i, report in enumerate(reports):
        assert report["ok"], report
        dev = report["devices"]
        assert dev["device_count"] == 8, dev
        assert dev["local_device_count"] == 4, dev
        assert dev["process_count"] == 2, dev
        assert dev["process_index"] == i, dev
        assert report["local_ranks_ok"] == [True] * 4, report
        coll = report["collectives"]
        assert coll["ok"] and not coll["degenerate_single_device"], coll
        assert coll["n_devices"] == 8, coll
        # the flagship sharded train step ran over the spanning mesh
        tr = report["training"]
        assert tr["ok"], tr
        assert tr["mesh"] == {"data": 1, "seq": 8, "model": 1}, tr


def test_expecting_more_devices_than_the_world_has_exits_2():
    port = _free_port()
    proc = subprocess.run(
        [sys.executable, "-m", "gpumounter_tpu_torch.torchcheck.probe",
         "--expect", "9", "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", "0", "--cpu-devices", "4"],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 2, proc.stderr[-2000:]
    assert "expected 9 devices" in json.loads(
        proc.stdout.strip().splitlines()[-1])["error"]


def _pods(sizes, target, args=()):
    """Local worlds of ``sizes`` ranks forming one world over TCP, started
    together as the pods of a slice would be; each pod's results."""
    port, world = _free_port(), sum(sizes)
    offsets = [sum(sizes[:i]) for i in range(len(sizes))]

    def pod(n, offset):
        with dist_lib.LocalWorld(n, target, args, device="cpu",
                                 world_size=world, rank_offset=offset,
                                 rendezvous=f"127.0.0.1:{port}",
                                 timeout_s=120) as ranks:
            return ranks.wait()

    with ThreadPoolExecutor(len(sizes)) as pool:
        futures = [pool.submit(pod, n, o) for n, o in zip(sizes, offsets)]
        return [f.result(timeout=300) for f in futures]


def test_local_worlds_number_their_ranks_process_major():
    got = _pods([2, 2], torch_worlds.rank_layout)
    assert got == [[(0, 0, 0, 4), (1, 1, 0, 4)],
                   [(2, 0, 1, 4), (3, 1, 1, 4)]]


def test_pods_that_drive_different_numbers_of_devices_fail_loudly():
    with pytest.raises(RuntimeError, match="different numbers of devices"):
        _pods([1, 2], torch_worlds.local_sizes)


@pytest.mark.parametrize("args", [
    dict(n_local=0), dict(n_local=2, world_size=3, rank_offset=2),
    dict(n_local=2, world_size=4),
], ids=["no_ranks", "past_the_world", "spanning_without_rendezvous"])
def test_a_local_world_refuses_impossible_ranks(args):
    n_local = args.pop("n_local")
    with pytest.raises(ValueError):
        dist_lib.LocalWorld(n_local, torch_worlds.rank_sum, device="cpu",
                            **args)
