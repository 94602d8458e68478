"""The port's in-pod probe on the CPU: gloo collectives over worker
processes, the toy training check (one process, and sharded over a world
of gloo processes), and the CLI's exit codes."""

import json
import os
import subprocess
import sys

import pytest
import torch

from gpumounter_tpu_torch.torchcheck import probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_validate_collectives_over_two_gloo_processes():
    r = probe.validate_collectives(2, device="cpu")
    assert r == {"n_devices": 2, "backend": "gloo", "allreduce_ok": True,
                 "ring_ok": True, "degenerate_single_device": False,
                 "ok": True}


def test_single_device_collectives_are_marked_degenerate():
    r = probe.validate_collectives(1, device="cpu")
    assert r["ok"] and r["degenerate_single_device"]


def test_validate_training_on_cpu():
    r = probe.validate_training(device="cpu")
    assert r["ok"] and r["final_loss"] < r["first_loss"]
    assert r["mesh"] is None


def test_validate_training_over_four_gloo_processes_reports_mesh():
    """With more than one device the toy step is sharded over make_mesh():
    the seq dim takes all four, T = 16 x 4."""
    r = probe.validate_training(device="cpu", n_devices=4)
    assert r["mesh"] == {"data": 1, "seq": 4, "model": 1}
    assert r["ok"] and r["final_loss"] < r["first_loss"], r


def test_run_probe_on_cpu():
    r = probe.run_probe(expected=2, timeout_s=0, device="cpu",
                        cpu_devices=2)
    assert r["ok"], r
    assert r["devices"]["device_count"] == 2
    assert r["collectives"]["n_devices"] == 2


def test_device_count_is_polled_in_a_child_process():
    """CUDA fixes a process's device set at its first CUDA call, so the
    count comes from a fresh child each poll. This host has no GPU: the
    child sees 0 and the wait times out without this process touching
    CUDA."""
    assert probe._child_device_count() == 0
    with pytest.raises(TimeoutError, match="expected 1 devices, have 0"):
        probe.wait_for_devices(1, timeout_s=0, device="cuda")


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "gpumounter_tpu_torch.torchcheck.probe",
         *args], capture_output=True, text=True, cwd=REPO, env=env,
        timeout=300)


def test_cli_exit_codes():
    ok = _cli("--cpu-devices", "4", "--expect", "4")
    assert ok.returncode == 0, ok.stderr[-2000:]
    report = json.loads(ok.stdout.strip().splitlines()[-1])
    assert report["ok"] is True
    assert report["training"]["mesh"] == {"data": 1, "seq": 4, "model": 1}
    timeout = _cli("--cpu-devices", "2", "--expect", "4", "--timeout", "0")
    assert timeout.returncode == 2
    assert "expected 4 devices" in json.loads(
        timeout.stdout.strip().splitlines()[-1])["error"]


def test_cli_joins_a_world_of_two_processes():
    """``--coordinator``/``--num-processes``/``--process-id``: each process
    is one rank of a gloo world and checks its own part over it."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gpumounter_tpu_torch.torchcheck.probe",
         "--cpu-devices", "1", "--expect", "2",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(rank)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=REPO, env=env)
        for rank in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-2000:]
        report = json.loads(out.strip().splitlines()[-1])
        assert report["devices"]["process_index"] == rank
        assert report["devices"]["device_count"] == 2
        assert report["collectives"]["backend"] == "gloo"
        assert report["collectives"]["allreduce_ok"]
        assert report["training"]["mesh"] == {"data": 1, "seq": 2,
                                              "model": 1}


@pytest.mark.parametrize("args", [
    ["--num-processes", "2"],
    ["--coordinator", "127.0.0.1:1", "--process-id", "0"],
    ["--coordinator", "127.0.0.1:1", "--num-processes", "2",
     "--process-id", "2", "--cpu-devices", "2"],
    ["--coordinator", "127.0.0.1:1", "--num-processes", "2",
     "--process-id", "0", "--cpu-devices", "0"],
], ids=["count_alone", "count_missing", "process_past_the_world",
        "no_devices_a_process"])
def test_cli_refuses_an_incomplete_world(args):
    proc = _cli(*args)
    assert proc.returncode == 2 and "error:" in proc.stderr


def test_a_rank_that_vanishes_fails_the_world_fast():
    """A process gone without a report fails the world at once with its
    exit code, instead of leaving its peers blocked until the deadline."""
    import time

    import torch_worlds
    from gpumounter_tpu_torch.torchcheck import dist as dist_lib
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1:\nexited with code 3"):
        dist_lib.run_world(3, torch_worlds.vanishing_world, device="cpu",
                           timeout_s=120)
    assert time.monotonic() - t0 < 60


@pytest.mark.gpu
def test_run_probe_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = probe.run_probe()
    assert r["ok"], r
    assert r["devices"]["backend"] == "cuda"


def _fds_and_threads():
    import threading
    return len(os.listdir("/proc/self/fd")), threading.active_count()


def test_closing_a_queue_with_unread_work_does_not_hang():
    """Work no rank read (a rank gone before it took its item), larger
    than the pipe, must not hang the queue's close."""
    import multiprocessing
    import threading

    from gpumounter_tpu_torch.torchcheck import dist as dist_lib
    q = multiprocessing.get_context("spawn").Queue()
    for _ in range(3):
        q.put(b"x" * 200_000)
    closer = threading.Thread(target=dist_lib._close, args=(q,),
                              daemon=True)
    closer.start()
    closer.join(timeout=dist_lib.FAILURE_GRACE_S + 20)
    assert not closer.is_alive()


def test_a_world_leaves_no_thread_fd_or_rendezvous_behind(monkeypatch):
    """run_world closes its queues (joining their feeder threads), the
    processes' sentinels and its rendezvous directory before it returns,
    so a long-lived caller (a test process, a daemon) does not grow."""
    import tempfile

    import torch_worlds
    from gpumounter_tpu_torch.torchcheck import dist as dist_lib
    stores: list[str] = []
    real_mkdtemp = tempfile.mkdtemp

    def mkdtemp(*args, **kwargs):
        stores.append(real_mkdtemp(*args, **kwargs))
        return stores[-1]

    # this test's own rendezvous directories (other processes' worlds may
    # be running in the same temporary directory)
    monkeypatch.setattr(dist_lib.tempfile, "mkdtemp", mkdtemp)
    dist_lib.run_world(2, torch_worlds.rank_sum, device="cpu")   # warm-up
    before = _fds_and_threads()
    for _ in range(3):
        assert dist_lib.run_world(2, torch_worlds.rank_sum,
                                  device="cpu") == [1, 1]
        assert _fds_and_threads() == before
    assert len(stores) == 4
    assert not [d for d in stores if os.path.exists(d)]


def test_concurrent_worlds_do_not_meet():
    """Two worlds started at the same moment each form their own
    rendezvous (a file store in a directory of their own)."""
    from concurrent.futures import ThreadPoolExecutor

    import torch_worlds
    from gpumounter_tpu_torch.torchcheck import dist as dist_lib
    with ThreadPoolExecutor(2) as pool:
        futures = [pool.submit(dist_lib.run_world, n, torch_worlds.rank_sum,
                               device="cpu") for n in (2, 3)]
        assert [f.result(timeout=300) for f in futures] == [[1, 1],
                                                            [3, 3, 3]]


def test_a_stuck_rank_dumps_its_stack_before_the_deadline(capfd):
    """A rank still running just short of the world's deadline prints
    every thread's stack, so the stuck one names where it waits."""
    import time

    import torch_worlds
    from gpumounter_tpu_torch.torchcheck import dist as dist_lib
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"ranks \[0, 1\]"):
        dist_lib.run_world(2, torch_worlds.stuck_world, device="cpu",
                           timeout_s=dist_lib.STACK_DUMP_LEAD_S + 8)
    assert time.monotonic() - t0 < 60
    err = capfd.readouterr().err
    assert "Timeout (0:00:0" in err and "in stuck_world" in err, err[-3000:]


def test_a_rank_that_starts_late_still_dumps_before_the_deadline(capfd):
    """The stack dump is timed from the world's deadline, not from the
    rank's start: ranks held until 5 s before the deadline (as a slow
    torch import under load holds them) still print every thread's stack
    before the parent stops them. Timed from their own start, the dump
    would come 3 s after the deadline."""
    import time

    import torch_worlds
    from gpumounter_tpu_torch.torchcheck import dist as dist_lib
    timeout_s = dist_lib.STACK_DUMP_LEAD_S + 8
    late = torch_worlds.LateStart(time.time() + timeout_s - 5)
    with dist_lib.LocalWorld(2, torch_worlds.late_stuck_world,
                             device="cpu", shared=late,
                             timeout_s=timeout_s) as world:
        with pytest.raises(TimeoutError, match=r"ranks \[0, 1\]"):
            world.wait()
    err = capfd.readouterr().err
    assert "in stuck_world" in err and "in late_stuck_world" in err, \
        err[-3000:]
