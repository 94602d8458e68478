"""The port's elastic harness (``torchcheck/elastic.py``) and
``convert.train_state_from_jax`` against the JAX package.

- The JAX worker stamps the mesh-generation file; the port's FileSignal
  reads it (``tests/test_elastic.py``'s worker case).
- Elastic parity: the JAX ``ElasticHarness`` rides 4 → 8 → 4 virtual
  devices in one process; the port's pod process rides 4 → 8 → 4 rank
  processes (``ElasticSupervisor``: each bump drains a world of gloo
  ranks and spawns the next, which restores resharded), from the same
  weights (``convert.state_tree_from_jax``) and the JAX harness's tokens.
  Per-step losses agree within the mesh-step tolerance of
  ``tests/test_torch_parallel.py`` (rtol 1e-4); every leaf is bitwise
  across each respawn.
- In one process the harness's world is a world of one: a reshape there
  is a process-group teardown and re-init, with the state bit-identical.
- ``train_state_from_jax`` starts the port mid-trajectory, AdamW moments
  and step counts included.
"""

import concurrent.futures
import types

import jax
import numpy as np
import pytest
import torch

from gpumounter_tpu.jaxcheck import elastic as jelastic
from gpumounter_tpu.jaxcheck import federation as jfed
from gpumounter_tpu.jaxcheck import model as jmodel
from gpumounter_tpu.jaxcheck import train as jtrain
from gpumounter_tpu.utils import consts as jconsts
from gpumounter_tpu_torch.torchcheck import convert
from gpumounter_tpu_torch.torchcheck import drain as tdrain
from gpumounter_tpu_torch.torchcheck import elastic
from gpumounter_tpu_torch.torchcheck import federation as tfed
from gpumounter_tpu_torch.torchcheck import model as tmodel
from gpumounter_tpu_torch.torchcheck import probe
from gpumounter_tpu_torch.torchcheck import train as ttrain

import torch_worlds

TINY = dict(vocab=64, d_model=32, n_heads=4, n_layers=1, d_ff=64)
JTINY = jmodel.ModelConfig(**TINY)
CFG = tmodel.ModelConfig(**TINY)
WORLD_DEADLINE_S = 300


def _batch(i, batch=4, seq=16):
    key = jax.random.fold_in(jax.random.PRNGKey(7), i)
    return np.array(jtrain.make_batch(key, batch, seq, TINY["vocab"]))


# -- the worker's notification file ---------------------------------------------

def test_worker_stamps_mesh_generation_file_the_port_reads(fake_host,
                                                           tmp_path):
    from gpumounter_tpu.testing.sim import WorkerRig
    rig = WorkerRig(fake_host, n_chips=4)
    try:
        gen_dir = tmp_path / "mesh-gen"
        rig.sim.settings.mesh_gen_dir = str(gen_dir)
        outcome = rig.service.add_tpu("workload", "default", 4, True,
                                      request_id="rid-gen")
        assert outcome.result == jconsts.AddResult.SUCCESS
        path = str(gen_dir / "default--workload.json")
        payload = elastic.read_generation_file(path)
        assert payload == jelastic.read_generation_file(path)
        assert len(payload["chips"]) == 4
        first = payload["generation"]
        signal = elastic.FileSignal(path)
        assert signal.chips() == 4
        assert signal.generation() == first
        outcome = rig.service.remove_tpu("workload", "default", [], False,
                                         request_id="rid-gen-2")
        assert outcome.result == jconsts.RemoveResult.SUCCESS
        assert signal.chips() == 0
        assert signal.generation() > first
    finally:
        rig.close()


def test_missing_generation_file_is_no_signal(tmp_path):
    signal = elastic.FileSignal(str(tmp_path / "absent.json"))
    assert signal.generation() is None and signal.chips() == 0


# -- elastic parity, 4 -> 8 -> 4 ------------------------------------------------

def _port_ride(root, batches):
    """The port's ride: one pod process (``ElasticSupervisor``) rides its
    own chip count, 4 -> 8 -> 4, moved after steps 12 and 24; each bump
    drains its world of rank processes and spawns the next, which restores
    the drained generation resharded. Returns the status records."""
    signal = {"gen": 1, "chips": 4}
    records = []

    def on_record(record):
        records.append(record)
        if record["phase"] == "step" and record["step"] in (12, 24):
            signal.update(gen=signal["gen"] + 1,
                          chips=8 if record["step"] == 12 else 4)

    ride = elastic.ElasticSupervisor(
        CFG, types.SimpleNamespace(generation=lambda: signal["gen"],
                                   chips=lambda: signal["chips"]),
        root, device="cpu", batches=torch_worlds.FixedBatches(batches),
        lr=1e-2, max_steps=36, verify=True, on_record=on_record)
    assert ride.run() == 0, [r for r in records if r["phase"] == "error"]
    return records


def test_elastic_ride_4_8_4_matches_the_jax_harness(tmp_path):
    batches = [_batch(i) for i in range(36)]
    signal = {"gen": 1, "chips": 4}
    harness = jelastic.ElasticHarness(
        JTINY, lambda: signal["gen"], lambda: signal["chips"],
        optimizer=jtrain.make_optimizer(lr=1e-2),
        step_factory=jfed._default_step_factory).start()
    # generation 1 of the port: the JAX harness's initial state
    root = str(tmp_path / "ckpt")
    tdrain.drain_sharded(convert.state_tree_from_jax(
        jax.tree.map(np.asarray, harness.state)), root, 1)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(_port_ride, root, batches)
        try:
            want = [harness.train_step(b) for b in batches[:12]]
            signal.update(gen=2, chips=8)
            assert harness.poll()
            want += [harness.train_step(b) for b in batches[12:24]]
            signal.update(gen=3, chips=4)
            assert harness.poll()
            want += [harness.train_step(b) for b in batches[24:]]
        finally:
            harness.close()
        records = port.result(timeout=3 * WORLD_DEADLINE_S)
    by_phase = {}
    for record in records:
        by_phase.setdefault(record["phase"], []).append(record)
    assert [r["world_devices"] for r in by_phase["started"]
            + by_phase["reshape_done"]] == [4, 8, 4]
    steps = by_phase["step"]
    assert [r["step"] for r in steps] == list(range(1, 37))
    assert [r["world_devices"] for r in steps] == [4] * 12 + [8] * 12 \
        + [4] * 12
    got = [r["loss"] for r in steps]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert np.mean(got[-6:]) < np.mean(got[:6])
    # no reset at either reshape: the step counter continues and every
    # restored leaf is the drained one, bit for bit (whole-leaf digests
    # across worlds of 4 and 8 ranks)
    assert by_phase["started"][0]["restored_generation"] == 1
    for begin, done, generation in zip(by_phase["reshape_begin"],
                                       by_phase["reshape_done"], (2, 3)):
        assert done["step"] == begin["step"]
        assert done["digests"] == begin["digests"]
        assert len(done["digests"]) == len(begin["digests"]) > 10
        assert done["restored_generation"] == generation
        assert done["rolled_back"] is False
    assert [r["step"] for r in by_phase["reshape_begin"]] == [12, 24]
    assert by_phase["done"][0]["step"] == 36


# -- one process: a world of one -------------------------------------------------

@pytest.fixture
def world_of_one():
    """This test process as a gloo world of one; left at teardown."""
    probe.initialize_distributed(f"127.0.0.1:{tfed.free_port()}", 1, 0,
                                 "cpu")
    yield
    probe.shutdown_distributed()


def _reinit_world_of_one():
    """The single-process teardown: leave the world, join a new world of
    one on a fresh port (devices are not re-enumerated)."""
    assert probe.shutdown_distributed() is True
    probe.initialize_distributed(f"127.0.0.1:{tfed.free_port()}", 1, 0,
                                 "cpu")


def test_harness_reshapes_through_a_world_teardown(world_of_one):
    signal = {"gen": 1, "chips": 1}
    harness = elastic.ElasticHarness(
        CFG, lambda: signal["gen"], lambda: signal["chips"], lr=1e-2,
        reinitialize=_reinit_world_of_one, device="cpu").start()
    try:
        assert tuple(harness.mesh.shape) == (1, 1, 1)
        losses = [harness.train_step(_batch(i)) for i in range(6)]
        embed = harness.state.model.embed.detach().clone()
        moment = harness.state.optimizer.state[
            harness.state.model.embed]["exp_avg"].clone()
        signal["gen"] = 2
        assert harness.poll() is True
        assert harness.reshapes == 1 and harness.generation == 2
        assert torch.equal(harness.state.model.embed, embed)
        restored = harness.state.optimizer.state[harness.state.model.embed]
        assert torch.equal(restored["exp_avg"], moment)
        assert float(restored["step"]) == 6.0
        assert harness.state.step == 6
        assert harness.poll() is False           # no bump, no reshape
        losses += [harness.train_step(_batch(i)) for i in range(6, 12)]
        assert harness.state.step == 12
        assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    finally:
        harness.close()


def test_harness_refuses_a_chip_count_other_than_its_world():
    for chips in (10_000, 0):
        harness = elastic.ElasticHarness(CFG, lambda: 1, lambda: chips,
                                         device="cpu")
        with pytest.raises(RuntimeError,
                           match="attach/visibility mismatch"):
            harness.start()
        harness.close()


def test_harness_needs_exactly_one_absorbing_mesh_dim():
    with pytest.raises(ValueError, match="exactly one"):
        elastic.ElasticHarness(CFG, lambda: 1, lambda: 1, seq=1,
                               device="cpu")


# -- state specs and the JAX state's carry-over -----------------------------------

def test_state_specs_follow_the_parameter_split():
    specs = elastic.state_specs(CFG)
    params = tmodel.param_shardings(CFG)
    assert specs["params"] == params
    for name, spec in params.items():
        assert specs["opt"][name] == {"exp_avg": spec, "exp_avg_sq": spec,
                                      "step": ()}
    assert specs["step"] is None
    state = ttrain.init_state(CFG, device="cpu")
    tree = ttrain.state_tree(state)
    assert tree["params"].keys() == specs["params"].keys()
    assert tree["opt"].keys() == specs["opt"].keys()


def test_train_state_from_jax_continues_mid_trajectory():
    """Three JAX steps, then the whole JAX state (parameters, AdamW
    moments, count, step) goes to the port; three more steps in each
    package agree (rtol 1e-4) — fresh moments would not."""
    step = jtrain.make_train_step(JTINY, optimizer=jtrain.make_optimizer(
        lr=1e-2))
    state = jtrain.init_state(jax.random.PRNGKey(0), JTINY,
                              optimizer=jtrain.make_optimizer(lr=1e-2))
    for i in range(3):
        state, _ = step(state, _batch(i))
    np_state = jax.tree.map(np.asarray, state)
    port = convert.train_state_from_jax(np_state, CFG, device="cpu",
                                        lr=1e-2)
    assert port.step == 3
    embed = port.model.embed
    assert float(port.optimizer.state[embed]["step"]) == 3.0
    np.testing.assert_array_equal(
        port.optimizer.state[embed]["exp_avg_sq"].numpy(),
        np_state.opt_state[0].nu["embed"])
    port_step = ttrain.make_train_step(CFG)
    want, got = [], []
    for i in range(3, 6):
        state, loss = step(state, _batch(i))
        want.append(float(loss))
        port, loss = port_step(port, torch.from_numpy(_batch(i)).long())
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # without the moments the trajectory differs: the carry matters
    fresh = ttrain.state_from_tree(CFG, {
        **ttrain.state_tree(convert.train_state_from_jax(np_state, CFG,
                                                         device="cpu")),
        "opt": ttrain.state_tree(ttrain.init_state(CFG, device="cpu"))
        ["opt"]}, "cpu", lr=1e-2)
    _, loss = port_step(fresh, torch.from_numpy(_batch(3)).long())
    _, loss = port_step(fresh, torch.from_numpy(_batch(4)).long())
    assert abs(float(loss) - want[1]) > 1e-3
