"""The port's pod process rides the port's own control plane.

- The acceptance flow (counterpart of ``tests/test_elastic.py``'s
  ``test_training_loop_rides_slice_resize_end_to_end``): ``/addgpuslice``
  over two hosts of the port's ``MultiNodeStack``, the port's
  ``MasterSliceSignal`` on ``/slicez``, and an ``ElasticSupervisor`` (gloo
  ranks) riding 2 → 4 → 2 hosts of 2 devices through ``POST
  /slice/resize``. The JAX harness rides the same flow on the JAX
  package's stack.
- The hot-attach under the ride: the port's ``LiveStack`` (HTTP master in
  front of the port's worker, which stamps the mesh-generation file), a
  pod process started before any attach and waiting for its file, then
  ``GET /addgpu`` of 2 GPUs (a world of 2 ranks) and a second of 2 more
  (the file bumps, a world of 4 ranks restores). The JAX harness rides the
  JAX stack's file through the same two attaches.

Both rides start from the JAX harness's initial state (generation 1 of
the port's checkpoint, ``convert.state_tree_from_jax``) and take the JAX
harness's tokens. Per-step losses agree within the tolerance of
``tests/test_torch_elastic.py``'s 4 → 8 → 4 parity (rtol 1e-4), and every
leaf is bitwise across each respawn (whole-leaf digests).
"""

import concurrent.futures
import json
import os
import time
import urllib.error
import urllib.request

import jax
import numpy as np

from gpumounter_tpu.jaxcheck import elastic as jelastic
from gpumounter_tpu.jaxcheck import federation as jfed
from gpumounter_tpu.jaxcheck import model as jmodel
from gpumounter_tpu.jaxcheck import train as jtrain
from gpumounter_tpu_torch.torchcheck import convert
from gpumounter_tpu_torch.torchcheck import drain as tdrain
from gpumounter_tpu_torch.torchcheck import elastic
from gpumounter_tpu_torch.torchcheck import model as tmodel

import torch_worlds
from torch_control_plane import JAX, TORCH

TINY = dict(vocab=64, d_model=32, n_heads=4, n_layers=1, d_ff=64)
JTINY = jmodel.ModelConfig(**TINY)
CFG = tmodel.ModelConfig(**TINY)
RIDE_DEADLINE_S = 600
LR = 1e-2


def _batch(i, batch=4, seq=16):
    key = jax.random.fold_in(jax.random.PRNGKey(7), i)
    return np.array(jtrain.make_batch(key, batch, seq, TINY["vocab"]))


def _http(method, url, obj=None):
    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _seed_checkpoint(harness, root):
    """Generation 1 of the port's checkpoint: the JAX harness's state."""
    tdrain.drain_sharded(convert.state_tree_from_jax(
        jax.tree.map(np.asarray, harness.state)), root, 1)


def _by_phase(records):
    out = {}
    for record in records:
        out.setdefault(record["phase"], []).append(record)
    return out


def _check_respawns(by_phase, generations):
    """Every restored leaf is the drained one, bit for bit, and the step
    counter continues, at each respawn."""
    assert len(by_phase["reshape_begin"]) == len(generations)
    for begin, done, generation in zip(by_phase["reshape_begin"],
                                       by_phase["reshape_done"],
                                       generations):
        assert done["step"] == begin["step"]
        assert done["fingerprint"] == begin["fingerprint"]
        assert done["digests"] == begin["digests"]
        assert len(done["digests"]) == len(begin["digests"]) > 10
        assert done["restored_generation"] == generation
        assert done["rolled_back"] is False


# -- the acceptance flow: 2 -> 4 -> 2 hosts by POST /slice/resize -------------

def _target(pkg, n):
    return {"pods": [{"namespace": "default", "pod": f"workload-{i}"}
                     for i in range(n)], f"{pkg.dev}sPerHost": 2}


def _stack(pkg, root):
    return pkg.mod("testing.sim").MultiNodeStack(
        [pkg.host(root / f"node{i}") for i in range(4)], n_chips=2)


def _port_slice_ride(stack, group, root, batches):
    """The port's pod process on ``/slicez``: resizes to 4 hosts after
    step 10 and back to 2 after step 20, posted from its own status hook
    (so the next read of the signal sees them). Returns the records and
    the generations the resizes answered."""
    records, answered = [], []

    def on_record(record):
        records.append(record)
        if record["phase"] == "step" and record["step"] in (10, 20):
            status, body = _http(
                "POST", f"{stack.base}/slice/resize",
                _target(TORCH, 4 if record["step"] == 10 else 2))
            assert status == 200, body
            answered.append(body["generation"])

    ride = elastic.ElasticSupervisor(
        CFG, elastic.MasterSliceSignal(stack.base, group), root,
        device="cpu", batches=torch_worlds.FixedBatches(batches), lr=LR,
        max_steps=30, verify=True, on_record=on_record)
    assert ride.run() == 0, [r for r in records if r["phase"] == "error"]
    return records, answered


def test_training_loop_rides_the_ports_slice_resize(tmp_path):
    batches = [_batch(i) for i in range(30)]
    port = _stack(TORCH, tmp_path / "torch")
    ref = _stack(JAX, tmp_path / "jax")
    harness = None
    try:
        status, body = _http("POST", f"{ref.base}/addtpuslice",
                             _target(JAX, 2))
        assert status == 200, body
        jsignal = jelastic.MasterSliceSignal(ref.base, body["group"])
        status, body = _http("POST", f"{port.base}/addgpuslice",
                             _target(TORCH, 2))
        assert status == 200, body
        group = body["group"]
        signal = elastic.MasterSliceSignal(port.base, group)
        assert (signal.generation(), signal.chips()) == (1, 4)

        harness = jelastic.ElasticHarness(
            JTINY, jsignal.generation, jsignal.chips,
            optimizer=jtrain.make_optimizer(lr=LR),
            step_factory=jfed._default_step_factory).start()
        assert harness.mesh.devices.size == 4
        root = str(tmp_path / "ckpt")
        _seed_checkpoint(harness, root)
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            ride = pool.submit(_port_slice_ride, port, group, root, batches)
            want = []
            for n, upto in ((4, 10), (2, 20), (None, 30)):
                for i in range(len(want), upto):
                    harness.poll()
                    want.append(harness.train_step(batches[i]))
                if n is not None:
                    status, body = _http("POST", f"{ref.base}/slice/resize",
                                         _target(JAX, n))
                    assert status == 200, body
            assert harness.reshapes == 2
            records, answered = ride.result(timeout=RIDE_DEADLINE_S)
        assert answered == [2, 3]
        assert (signal.generation(), signal.chips()) == (3, 4)

        by_phase = _by_phase(records)
        assert [r["world_devices"] for r in by_phase["started"]
                + by_phase["reshape_done"]] == [4, 8, 4]
        steps = by_phase["step"]
        assert [r["step"] for r in steps] == list(range(1, 31))
        assert [(r["generation"], r["world_devices"]) for r in steps] == \
            [(1, 4)] * 10 + [(2, 8)] * 10 + [(3, 4)] * 10
        got = [r["loss"] for r in steps]
        np.testing.assert_allclose(got, want, rtol=1e-4)
        assert np.mean(got[-5:]) < np.mean(got[:5]), got
        assert by_phase["started"][0]["restored_generation"] == 1
        _check_respawns(by_phase, (2, 3))
        assert by_phase["done"][0]["step"] == 30
        # ground truth followed the resizes in both stacks: only hosts 0-1
        # hold devices
        for stack in (port, ref):
            assert [len(rig.sim.slave_pods()) for rig in stack.rigs] == \
                [1, 1, 0, 0]
    finally:
        if harness is not None:
            harness.close()
        port.close()
        ref.close()


# -- the hot-attach under the ride: /addgpu 2, then 2 more --------------------

def _attach(pkg, base, n):
    return _http("GET", f"{base}/add{pkg.dev}/namespace/default/pod/workload"
                        f"/{pkg.dev}/{n}/isEntireMount/false")


def _live_stack(pkg, root, gen_dir):
    """``pkg``'s master in front of its worker, which stamps ``gen_dir``;
    the container's nodes are made under the fixture ``/proc``."""
    sim = pkg.mod("testing.sim")
    rig = sim.WorkerRig(pkg.host(root), n_chips=4, actuator="procroot")
    rig.sim.settings.mesh_gen_dir = str(gen_dir)
    return sim.LiveStack(rig)


def _container_nodes(rig, pkg):
    dev = os.path.join(rig.host.proc_root, str(rig.pid), "root", "dev")
    return sorted(n for n in os.listdir(dev)
                  if n.startswith(pkg.node_prefix)
                  and not n.endswith(".majmin"))


def test_pod_process_rides_hot_attaches_through_the_ports_master(tmp_path):
    batches = [_batch(i) for i in range(12)]
    port = _live_stack(TORCH, tmp_path / "torch", tmp_path / "torch-gen")
    ref = _live_stack(JAX, tmp_path / "jax", tmp_path / "jax-gen")
    path = str(tmp_path / "torch-gen" / "default--workload.json")
    stop = str(tmp_path / "stop")
    harness = None
    try:
        # the JAX harness on its worker's file: 2 chips attached
        status, body = _attach(JAX, ref.base, 2)
        assert status == 200, body
        jsignal = jelastic.FileSignal(
            str(tmp_path / "jax-gen" / "default--workload.json"))
        harness = jelastic.ElasticHarness(
            JTINY, jsignal.generation, jsignal.chips,
            optimizer=jtrain.make_optimizer(lr=LR),
            step_factory=jfed._default_step_factory).start()
        root = str(tmp_path / "ckpt")
        _seed_checkpoint(harness, root)

        # the port's pod process starts before any attach and waits
        records, attaches = [], []

        def on_record(record):
            records.append(record)
            if record["phase"] == "step" and record["step"] == 6:
                attaches.append(_attach(TORCH, port.base, 2))
            if record["phase"] == "step" and record["step"] == 12:
                with open(stop, "w") as f:
                    f.write("1")

        ride = elastic.ElasticSupervisor(
            CFG, elastic.FileSignal(path), root, device="cpu",
            batches=torch_worlds.FixedBatches(batches), lr=LR, verify=True,
            stop_path=stop, on_record=on_record)
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            run = pool.submit(ride.run)
            time.sleep(1.0)
            assert not run.done()
            assert [r["phase"] for r in records] == ["waiting"]
            assert not os.path.exists(path)

            status, body = _attach(TORCH, port.base, 2)
            assert status == 200, body
            first = body["device_ids"]
            want = [harness.train_step(b) for b in batches[:6]]
            status, body = _attach(JAX, ref.base, 2)
            assert status == 200, body
            assert harness.poll() is True
            want += [harness.train_step(b) for b in batches[6:]]
            assert run.result(timeout=RIDE_DEADLINE_S) == 0, \
                [r for r in records if r["phase"] == "error"]
        (status, body), = attaches
        assert status == 200, body
        second = body["device_ids"]
        assert not set(first) & set(second)
        assert elastic.read_generation_file(path)["chips"] == \
            sorted(first + second)

        by_phase = _by_phase(records)
        assert [r["world_devices"] for r in by_phase["started"]
                + by_phase["reshape_done"]] == [2, 4]
        steps = by_phase["step"]
        assert [r["step"] for r in steps] == list(range(1, 13))
        assert [r["world_devices"] for r in steps] == [2] * 6 + [4] * 6
        generations = [r["generation"] for r in steps]
        # the worker's own stamps: unix times, one per attach
        assert all(isinstance(g, float) for g in generations)
        assert generations[0] < generations[6]
        got = [r["loss"] for r in steps]
        np.testing.assert_allclose(got, want, rtol=1e-4)
        assert by_phase["started"][0]["restored_generation"] == 1
        _check_respawns(by_phase, (2,))
        assert by_phase["stopped"][0]["step"] == 12

        # the detach after the stop: no slave pod, no node in the container
        status, body = _http(
            "POST", f"{port.base}/removegpu/namespace/default/pod/workload"
                    "/force/false")
        assert status == 200, body
        assert port.rig.sim.slave_pods() == []
        assert _container_nodes(port.rig, TORCH) == []
        assert elastic.FileSignal(path).chips() == 0
    finally:
        if harness is not None:
            harness.close()
        port.close()
        ref.close()
