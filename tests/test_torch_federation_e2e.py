"""The port's members ride a live slice resize end to end.

Real member processes (``python -m gpumounter_tpu_torch.torchcheck.
federation --device cpu --local-devices N``: one pod process driving N
gloo rank processes each) against the JAX package's ``MultiNodeStack``
master, as ``tests/test_federation.py`` runs the JAX members, at N = 1 and
at the JAX e2e's N = 2:

- ``/slice/resize`` 2 → 4 → 2 hosts of N devices each: worlds of 2N, 4N,
  2N devices, step counter and loss trajectory intact across both
  transitions, members resized out exit 0;
- the coordinator member SIGKILLed mid-resize: the barrier sticks, the
  control plane moves the generation past the dead member, and the
  survivors re-form a world of 3N under a re-elected coordinator,
  restoring the last good generation;
- a SIGKILLed rank takes its member down (non-zero exit, every rank of it
  gone), and a SIGKILLed member takes its ranks with it.

Every wait has its own deadline. This file holds only the e2es, so that a
run with several workers gives them a worker of their own.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import pytest

from gpumounter_tpu.master.admission import BrokerConfig
from gpumounter_tpu.testing.chaos import (assert_checkpoint_invariants,
                                          assert_slice_invariants)
from gpumounter_tpu.utils.config import HostPaths
from gpumounter_tpu_torch.testing.chaos import (
    assert_checkpoint_invariants as port_checkpoint_invariants)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 120.0
# devices per member pod: the port's one-device members, and the JAX
# e2e's two
LOCAL_DEVICES = (1, 2)
IDS = ("one_device_members", "two_device_members")


def _host(tmp_path, i):
    base = tmp_path / f"node{i}"
    for sub in ("dev", "proc", "sys/fs/cgroup"):
        (base / sub).mkdir(parents=True)
    return HostPaths(dev_root=str(base / "dev"),
                     proc_root=str(base / "proc"),
                     sys_root=str(base / "sys"),
                     cgroup_root=str(base / "sys" / "fs" / "cgroup"),
                     kubelet_socket=str(base / "pr" / "kubelet.sock"))


def _post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 method="POST")
    try:
        resp = urllib.request.urlopen(req, timeout=60)
        return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _target(members, per_host):
    """Hosts of ``per_host`` devices each, one member pod per host."""
    return {"pods": [{"namespace": "default", "pod": f"workload-{i}"}
                     for i in members], "tpusPerHost": per_host}


def _stack(tmp_path, hosts, **kw):
    from gpumounter_tpu.testing.sim import MultiNodeStack
    return MultiNodeStack([_host(tmp_path, i) for i in range(hosts)],
                          n_chips=2, **kw)


def _spawn_member(base, group, i, tmp_path, n, *, hold_dir=None,
                  barrier_timeout=6.0):
    status = str(tmp_path / f"member-{i}.jsonl")
    argv = [sys.executable, "-m", "gpumounter_tpu_torch.torchcheck.federation",
            "--master", base, "--group", group,
            "--member", f"default/workload-{i}",
            "--checkpoint-root", str(tmp_path / "ckpt"),
            "--local-devices", str(n), "--device", "cpu",
            "--status-file", status, "--stop-file", str(tmp_path / "stop"),
            "--barrier-timeout", str(barrier_timeout), "--seq-len", "48"]
    if hold_dir is not None:
        argv += ["--hold-dir", str(hold_dir)]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    # the member's stderr stays in member-<i>.err for a failing run
    with open(str(tmp_path / f"member-{i}.err"), "wb") as err:
        proc = subprocess.Popen(argv, cwd=REPO, env=env,
                                stdout=subprocess.DEVNULL, stderr=err,
                                start_new_session=True)
    return proc, status


def _records(status_path):
    try:
        with open(status_path) as f:
            return [json.loads(line) for line in f if line.strip()]
    except OSError:
        return []


def _wait_for(predicate, timeout_s=WAIT_S, what="condition"):
    deadline = time.monotonic() + timeout_s
    while True:
        value = predicate()
        if value:
            return value
        assert time.monotonic() < deadline, f"timed out waiting: {what}"
        time.sleep(0.25)


def _steps_at(status_path, generation, world, n=2):
    def check():
        steps = [r for r in _records(status_path)
                 if r["phase"] == "step"
                 and r["generation"] == generation
                 and r["world_devices"] == world]
        return steps if len(steps) >= n else None
    return check


def _reap(procs, timeout_s=60.0):
    for proc in procs:
        try:
            proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=10)


@pytest.mark.parametrize("n", LOCAL_DEVICES, ids=IDS)
def test_multiprocess_resize_2_4_2_end_to_end(tmp_path, n):
    stack = _stack(tmp_path, hosts=4)
    procs = []
    try:
        status, body = _post(f"{stack.base}/addtpuslice",
                             _target(range(2), n))
        assert status == 200, body
        group = body["group"]
        p0, s0 = _spawn_member(stack.base, group, 0, tmp_path, n)
        p1, s1 = _spawn_member(stack.base, group, 1, tmp_path, n)
        procs = [p0, p1]
        _wait_for(_steps_at(s0, 1, 2 * n, n=3), what="gen-1 steps")
        # GROW 2 -> 4: two new member processes join the world
        status, body = _post(f"{stack.base}/slice/resize",
                             _target(range(4), n))
        assert status == 200, body
        assert body["generation"] == 2
        p2, s2 = _spawn_member(stack.base, group, 2, tmp_path, n)
        p3, s3 = _spawn_member(stack.base, group, 3, tmp_path, n)
        procs += [p2, p3]
        _wait_for(_steps_at(s0, 2, 4 * n, n=3), what="gen-2 steps")
        _wait_for(_steps_at(s2, 2, 4 * n, n=1), what="member-2 joined")
        # SHRINK 4 -> 2: members 2 and 3 are refused at the barrier, exit
        status, body = _post(f"{stack.base}/slice/resize",
                             _target(range(2), n))
        assert status == 200, body
        assert body["generation"] == 3
        _wait_for(_steps_at(s0, 3, 2 * n, n=3), what="gen-3 steps")
        for proc in (p2, p3):
            assert proc.wait(timeout=WAIT_S) == 0
        assert any(r["phase"] == "resized_out" for r in _records(s2))
        with open(tmp_path / "stop", "w") as f:
            f.write("1")
        _reap([p0, p1])
        assert p0.returncode == 0 and p1.returncode == 0

        records = _records(s0)
        steps = [r for r in records if r["phase"] == "step"]
        numbers = [r["step"] for r in steps]
        assert numbers == sorted(set(numbers)), numbers
        assert {1: 2 * n, 2: 4 * n, 3: 2 * n} == {
            r["generation"]: r["world_devices"] for r in steps}
        reshapes = [r for r in records if r["phase"] == "reshape_done"]
        assert [r["generation"] for r in reshapes] == [2, 3]
        assert all(r["rolled_back"] is False for r in reshapes)
        begins = [r for r in records if r["phase"] == "reshape_begin"]
        for begin, done in zip(begins, reshapes):
            # the state restored bit for bit: the same fingerprint
            assert begin["fingerprint"] == done["fingerprint"]
            assert begin["step"] == done["step"]
        # the new members resumed the generation-2 checkpoint
        started = [r for r in _records(s2) if r["phase"] == "started"][0]
        assert started["resumed"] and started["restored_generation"] == 2
        losses = [r["loss"] for r in steps]
        assert len(losses) >= 9
        assert (sum(losses[-3:]) / 3) < (sum(losses[:3]) / 3), losses
        assert_slice_invariants(stack.gateway.broker,
                                [r.sim for r in stack.rigs],
                                kube=stack.master_kube)
        assert_checkpoint_invariants(str(tmp_path / "ckpt"))
        port_checkpoint_invariants(str(tmp_path / "ckpt"))
        # one shard per rank of the world that drained each generation
        # (members x N), each restored onto a world of another size
        for generation, ranks in ((2, 2 * n), (3, 4 * n)):
            manifest = json.loads((tmp_path / "ckpt" / f"gen-{generation}"
                                   / "manifest.json").read_text())
            assert manifest["process_count"] == ranks, manifest
            assert len(manifest["shards"]) == ranks, manifest
    finally:
        _reap(procs, timeout_s=5.0)
        stack.close()


@pytest.mark.parametrize("n", LOCAL_DEVICES, ids=IDS)
def test_member_sigkill_mid_resize_rolls_back_and_reforms(tmp_path, n):
    stack = _stack(tmp_path, hosts=4,
                   broker_config=BrokerConfig(resize_barrier_timeout_s=1.0))
    hold = tmp_path / "hold"
    hold.mkdir()
    procs = []
    try:
        status, body = _post(f"{stack.base}/addtpuslice",
                             _target(range(2), n))
        assert status == 200, body
        group = body["group"]
        p0, s0 = _spawn_member(stack.base, group, 0, tmp_path, n,
                               hold_dir=hold, barrier_timeout=3.0)
        p1, s1 = _spawn_member(stack.base, group, 1, tmp_path, n,
                               hold_dir=hold, barrier_timeout=3.0)
        procs = [p0, p1]
        _wait_for(lambda: os.path.exists(
            hold / "default--workload-0.ready-1") and os.path.exists(
            hold / "default--workload-1.ready-1"), what="gen-1 holds")
        (hold / "go-1").touch()
        _wait_for(_steps_at(s0, 1, 2 * n, n=3), what="gen-1 steps")

        # GROW 2 -> 4: members drain gen 2, leave the world, and HOLD at
        # the pre-join seam — the deterministic mid-resize window
        status, body = _post(f"{stack.base}/slice/resize",
                             _target(range(4), n))
        assert status == 200, body
        assert body["generation"] == 2
        _wait_for(lambda: os.path.exists(
            hold / "default--workload-0.ready-2") and os.path.exists(
            hold / "default--workload-1.ready-2"), what="gen-2 holds")
        # SIGKILL member 0 — the coordinator — inside the window
        os.killpg(p0.pid, signal.SIGKILL)
        p0.wait(timeout=10)
        (hold / "go-2").touch()
        p2, s2 = _spawn_member(stack.base, group, 2, tmp_path, n,
                               barrier_timeout=3.0)
        p3, s3 = _spawn_member(stack.base, group, 3, tmp_path, n,
                               barrier_timeout=3.0)
        procs += [p2, p3]

        def stuck():
            _, barrier = _get(f"{stack.base}/slice/barrier?group={group}")
            return barrier if (barrier.get("generation") == 2
                               and len(barrier.get("joined") or []) == 3
                               and barrier.get("stuck")) else None
        barrier = _wait_for(stuck, what="stuck 3/4 barrier")
        assert barrier["missing"] == ["default/workload-0"]
        assert not [r for r in _records(s1) if r["phase"] == "step"
                    and r["generation"] == 2]

        # the control plane moves past the dead member: generation 3 for
        # the three live members, coordinator re-elected to member 1
        status, body = _post(f"{stack.base}/slice/resize",
                             _target([1, 2, 3], n))
        assert status == 200, body
        assert body["generation"] == 3
        _wait_for(lambda: os.path.exists(
            hold / "default--workload-1.ready-3"), what="gen-3 hold")
        (hold / "go-3").touch()
        steps = _wait_for(_steps_at(s1, 3, 3 * n, n=3), what="gen-3 steps")
        records = _records(s1)
        done = [r for r in records if r["phase"] == "reshape_done"]
        assert done and done[-1]["generation"] == 3
        # generation 3 never committed: the last good one is 2
        assert done[-1]["restored_generation"] == 2
        assert done[-1]["rolled_back"] is True
        begin = [r for r in records if r["phase"] == "reshape_begin"][-1]
        assert done[-1]["fingerprint"] == begin["fingerprint"]
        gen1_last = max(r["step"] for r in records
                        if r["phase"] == "step" and r["generation"] == 1)
        assert steps[0]["step"] == gen1_last + 1
        losses = [r["loss"] for r in records if r["phase"] == "step"]
        assert (sum(losses[-3:]) / 3) < (sum(losses[:3]) / 3), losses
        with open(tmp_path / "stop", "w") as f:
            f.write("1")
        _reap([p1, p2, p3])
        assert p1.returncode == 0
        assert p2.returncode == 0 and p3.returncode == 0
        assert_slice_invariants(stack.gateway.broker,
                                [r.sim for r in stack.rigs],
                                kube=stack.master_kube)
        assert_checkpoint_invariants(str(tmp_path / "ckpt"))
    finally:
        _reap(procs, timeout_s=5.0)
        stack.close()


def _rank_pids(parent):
    """The live rank processes a member spawned (its children running
    ``multiprocessing``'s spawn entry; not its resource tracker)."""
    pids = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmdline = f.read()
        except OSError:
            continue
        state, ppid = fields[0], int(fields[1])
        if ppid == parent and state != "Z" and b"spawn_main" in cmdline:
            pids.append(int(entry))
    return sorted(pids)


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _two_members_training(tmp_path, stack):
    """Two members of two CPU devices each, training at generation 1;
    returns their processes, status files and rank pids."""
    status, body = _post(f"{stack.base}/addtpuslice", _target(range(2), 2))
    assert status == 200, body
    members = [_spawn_member(stack.base, body["group"], i, tmp_path, 2)
               for i in range(2)]
    for _, status_path in members:
        _wait_for(_steps_at(status_path, 1, 4, n=2), what="gen-1 steps")
    ranks = [_rank_pids(proc.pid) for proc, _ in members]
    assert [len(r) for r in ranks] == [2, 2], ranks
    return members, ranks


def test_a_killed_rank_takes_its_member_down(tmp_path):
    stack = _stack(tmp_path, hosts=2)
    procs = []
    try:
        members, ranks = _two_members_training(tmp_path, stack)
        procs = [proc for proc, _ in members]
        (p0, s0), victim = members[0], ranks[0][1]
        os.kill(victim, signal.SIGKILL)
        # the member stops its other rank and exits non-zero
        assert p0.wait(timeout=WAIT_S) == 1
        assert not [pid for pid in ranks[0] if _alive(pid)]
        error = [r for r in _records(s0) if r["phase"] == "error"][-1]
        killed = [r for r in error["ranks"].values() if r["pid"] == victim]
        assert killed and killed[0]["signal"] == "SIGKILL", error
        assert "was killed by SIGKILL" in error["message"], error
    finally:
        _reap(procs, timeout_s=5.0)
        stack.close()
    assert not [pid for pids in ranks for pid in pids if _alive(pid)]


def test_a_killed_member_takes_its_ranks_with_it(tmp_path):
    stack = _stack(tmp_path, hosts=2)
    procs = []
    try:
        members, ranks = _two_members_training(tmp_path, stack)
        procs = [proc for proc, _ in members]
        p1 = members[1][0]
        os.kill(p1.pid, signal.SIGKILL)       # the member alone
        p1.wait(timeout=10)
        _wait_for(lambda: not [pid for pid in ranks[1] if _alive(pid)],
                  timeout_s=10.0, what="member 1's ranks gone")
    finally:
        _reap(procs, timeout_s=5.0)
        stack.close()
    assert not [pid for pids in ranks for pid in pids if _alive(pid)]
