"""The port's drain (``torchcheck/drain.py``) against the JAX package's.

The cases of ``tests/test_drain.py`` (legacy single-file drain/restore of
a train state) and ``tests/test_drain_sharded.py`` (per-process shard
files, committed manifest, atomic writes, resharding, typed errors and
last-good rollback), on the port; where those cases repeat each other they
are cases of one parametrised test. The JAX package's own checks hold the
port's roots: ``testing/chaos.assert_checkpoint_invariants`` and
``jaxcheck/drain.restore_sharded`` accept what the port commits. Worlds of
gloo processes (``tests/torch_worlds.py``) drain and restore across world
sizes: 4 → 8 on a 1-D mesh, and the Megatron split of a train state from a
world of 2 onto a world of 4, bitwise.
"""

import json
import os
import pickle
import shutil

import jax
import numpy as np
import pytest
import torch

from gpumounter_tpu.jaxcheck import drain as jdrain
from gpumounter_tpu.testing.chaos import assert_checkpoint_invariants
from gpumounter_tpu_torch.testing import chaos as tchaos
from gpumounter_tpu_torch.torchcheck import dist as tdist
from gpumounter_tpu_torch.torchcheck import drain as drain_lib
from gpumounter_tpu_torch.torchcheck import elastic as telastic
from gpumounter_tpu_torch.torchcheck import model as tmodel
from gpumounter_tpu_torch.torchcheck import train as ttrain

import torch_worlds

TINY = dict(vocab=64, d_model=32, n_heads=4, n_layers=1, d_ff=64)
CFG = tmodel.ModelConfig(**TINY)
WORLD_DEADLINE_S = 300


def _tokens(seed=1, batch=4, seq=32):
    rng = np.random.default_rng(seed)
    start = rng.integers(0, 64, (batch, 1))
    stride = rng.integers(1, 4, (batch, 1))
    return ((start + stride * np.arange(seq)[None]) % 64).astype(np.int64)


def _trained_state(steps=2):
    state = ttrain.init_state(CFG, seed=0, device="cpu", lr=1e-2)
    step = ttrain.make_train_step(CFG)
    tokens = torch.from_numpy(_tokens())
    for _ in range(steps):
        state, loss = step(state, tokens)
    return state, step, tokens, float(loss)


def _leaves_equal(a, b, path="tree"):
    """Two trees of dicts hold the same leaves under the same keys
    (JAX's tree functions sort dict keys, so order is not compared)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for key in a:
            _leaves_equal(a[key], b[key], f"{path}/{key}")
        return
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    np.testing.assert_array_equal(a, b, err_msg=path)


def _world(n, target, *args):
    return tdist.run_world(n, target, args, device="cpu",
                           timeout_s=WORLD_DEADLINE_S)


# -- legacy single-file drain (tests/test_drain.py) ----------------------------

def test_drain_writes_checkpoint_and_returns_host_tree(tmp_path):
    state, *_ = _trained_state()
    path = str(tmp_path / "ckpt" / "state.pkl")
    host = drain_lib.drain(ttrain.state_tree(state), path)
    assert os.path.exists(path)
    for leaf in drain_lib._leaves(host):
        assert isinstance(leaf, int) or (isinstance(leaf, torch.Tensor)
                                         and leaf.device.type == "cpu")
    # a copy, not the live tensors
    assert host["params"]["embed"].data_ptr() != \
        state.model.embed.data_ptr()


def test_restore_preserves_values_and_structure(tmp_path):
    state, *_ = _trained_state()
    path = str(tmp_path / "state.pkl")
    tree = ttrain.state_tree(state)
    drain_lib.drain(tree, path)
    restored = drain_lib.restore(path)
    assert restored.keys() == tree.keys()
    assert restored["opt"].keys() == tree["opt"].keys()
    _leaves_equal(tree, restored)


def test_training_continues_identically_after_drain_restore(tmp_path):
    state, step, tokens, _ = _trained_state()
    path = str(tmp_path / "state.pkl")
    drain_lib.drain(ttrain.state_tree(state), path)
    # ground truth: the next loss without any drain
    _, expected_loss = step(state, tokens)
    restored = ttrain.state_from_tree(CFG, drain_lib.restore(path), "cpu",
                                      lr=1e-2)
    assert isinstance(restored, ttrain.TrainState) and restored.step == 2
    _, resumed_loss = step(restored, tokens)
    assert abs(float(resumed_loss) - float(expected_loss)) < 1e-6


def test_restore_onto_explicit_shardings(tmp_path):
    """The params checkpoint of one process, restored by a world of 4
    onto a (1, 2, 2) mesh: each rank holds its slices, which gather to
    the drained values."""
    state, *_ = _trained_state()
    path = str(tmp_path / "state.pkl")
    host = drain_lib.drain(ttrain.state_tree(state)["params"], path)
    got = _world(4, torch_worlds.legacy_restore_world, path, TINY,
                 {"data": 1, "seq": 2, "model": 2})
    for rank in got:
        assert rank["local_wqkv"] == (32, 3, 2, 8)      # heads over model
        _leaves_equal(host, rank["params"])


def test_legacy_drain_restore_cycle_keeps_values(tmp_path):
    state, *_ = _trained_state()
    tree = ttrain.state_tree(state)
    restored = drain_lib.drain_restore_cycle(
        tree, telastic.state_specs(CFG), device="cpu")
    _leaves_equal(tree, restored)


# -- sharded streaming (tests/test_drain_sharded.py) ---------------------------

def _tree(scale=1.0):
    """The three placement classes a train state carries: a matrix, a
    vector, a host step counter (whole on one process)."""
    return {"matrix": torch.arange(32, dtype=torch.float32).reshape(8, 4)
            * scale, "replicated": torch.ones(3) * scale, "step": 7}


def _drain(root, generation, scale=1.0):
    drain_lib.drain_sharded(_tree(scale), root, generation)


@pytest.fixture(scope="module")
def x_root(tmp_path_factory):
    """Generation 1 drained by a world of 4, the matrix sharded over a
    1-D mesh of the world and the vector replicated."""
    root = str(tmp_path_factory.mktemp("x") / "ckpt")
    _world(4, torch_worlds.x_drain_world, root, 1)
    return root


def test_sharded_roundtrip_reshards_onto_a_different_mesh(x_root):
    assert drain_lib.latest_generation(x_root) == 1
    assert_checkpoint_invariants(x_root)
    # restore onto a world of 8: same values, new placement
    got = _world(8, torch_worlds.x_restore_world, x_root)
    for rank in got:
        np.testing.assert_array_equal(
            rank["matrix"], np.arange(32, dtype=np.float32).reshape(8, 4))
        np.testing.assert_array_equal(rank["replicated"], np.ones(3))
        assert rank["step"] == 7
        assert rank["local_shape"] == (1, 4)


def test_shard_entries_deduplicate_replicas(x_root):
    """A replicated leaf appears ONCE across all shard files (replica 0
    only) and the sharded matrix's entries tile it exactly once."""
    gen = os.path.join(x_root, "gen-1")
    payloads = []
    for i in range(4):
        with open(os.path.join(gen, drain_lib._shard_name(i, 4)),
                  "rb") as f:
            payloads.append(pickle.load(f))
    replicated = [e for p in payloads
                  for e in p["tree"]["replicated"]["entries"]]
    assert len(replicated) == 1
    assert payloads[0]["tree"]["replicated"]["entries"] == replicated
    matrix = sorted(tuple(e["index"][0]) for p in payloads
                    for e in p["tree"]["matrix"]["entries"])
    assert matrix == [(0, 2), (2, 4), (4, 6), (6, 8)]


def test_jax_reader_restores_the_port_root(x_root):
    """The JAX package's own restore, without shardings, reads the
    port's f32 root and returns the port's arrays."""
    host = jdrain.restore_sharded(x_root)
    np.testing.assert_array_equal(
        host["matrix"], np.arange(32, dtype=np.float32).reshape(8, 4))
    np.testing.assert_array_equal(host["replicated"], np.ones(3))
    assert int(host["step"]) == 7
    port = drain_lib.restore_sharded(x_root)
    _leaves_equal(port, host)


def test_restore_without_specs_returns_host_tree(tmp_path):
    root = str(tmp_path / "ckpt")
    _drain(root, 1)
    timings = {}
    host = drain_lib.restore_sharded(root, timings=timings)
    assert isinstance(host["matrix"], torch.Tensor)
    assert host["matrix"].device.type == "cpu"
    np.testing.assert_array_equal(
        host["matrix"].numpy(),
        np.arange(32, dtype=np.float32).reshape(8, 4))
    assert set(timings) == {"read_verify_s", "unpickle_assemble_s"}


def _tear(root, how):
    """Break a committed root the way a crash or a bad disk would."""
    gen = os.path.join(root, f"gen-{drain_lib.latest_generation(root)}")
    shard = os.path.join(gen, drain_lib._shard_name(0, 1))
    if how == "torn_latest":
        with open(os.path.join(root, "LATEST"), "w") as f:
            f.write("gen-9\n")
    elif how == "missing_shard":
        os.remove(shard)
    elif how == "truncated_shard":
        with open(shard, "r+b") as f:
            f.truncate(8)
    elif how == "no_manifest":
        os.remove(os.path.join(gen, "manifest.json"))
    elif how == "never_committed":
        shutil.rmtree(root)
        os.makedirs(root)


def _checked(check, root) -> str:
    try:
        check(root)
        return "ok"
    except Exception as e:              # the outcome is compared by kind
        return type(e).__name__


@pytest.mark.parametrize("how,want", [
    ("committed", "ok"), ("two_generations", "ok"),
    ("never_committed", "ok"), ("torn_latest", "AssertionError"),
    ("missing_shard", "TornShardError"),
    ("truncated_shard", "TornShardError"),
    ("no_manifest", "ManifestError")])
def test_checkpoint_invariants_agree_with_the_control_planes(tmp_path, how,
                                                             want):
    """The port's ``testing/chaos.assert_checkpoint_invariants`` and the
    JAX package's give the same verdict on the same port roots."""
    root = str(tmp_path / "ckpt")
    _drain(root, 1)
    if how == "two_generations":
        _drain(root, 2, scale=2.0)
    else:
        _tear(root, how)
    assert _checked(tchaos.assert_checkpoint_invariants, root) == want
    assert _checked(assert_checkpoint_invariants, root) == want


def test_commit_keeps_current_plus_previous_generation_only(tmp_path):
    root = str(tmp_path / "ckpt")
    for generation in (1, 2, 3):
        _drain(root, generation, scale=float(generation))
    assert drain_lib.list_generations(root) == [2, 3]
    assert drain_lib.latest_generation(root) == 3
    assert_checkpoint_invariants(root)


def test_prune_spares_the_newest_COMMITTED_generation(tmp_path):
    root = str(tmp_path / "ckpt")
    _drain(root, 1, scale=1.0)
    gen2 = os.path.join(root, "gen-2")
    os.makedirs(gen2)
    with open(os.path.join(gen2, drain_lib._shard_name(0, 1)), "wb") as f:
        f.write(b"partial")
    _drain(root, 3, scale=3.0)
    assert drain_lib.list_generations(root) == [1, 3]
    _, generation = drain_lib.restore_last_good(root)
    assert generation == 3
    assert_checkpoint_invariants(root)


def _truncate(root):
    shard = os.path.join(root, "gen-2", drain_lib._shard_name(0, 1))
    with open(shard, "r+b") as f:
        f.truncate(os.path.getsize(shard) // 2)


def _corrupt_manifest(root):
    with open(os.path.join(root, "gen-2", "manifest.json"), "w") as f:
        f.write("{not json")


def _flip_a_byte(root):
    shard = os.path.join(root, "gen-2", drain_lib._shard_name(0, 1))
    data = bytearray(open(shard, "rb").read())
    data[len(data) // 2] ^= 0xFF        # same size, different bytes
    with open(shard, "wb") as f:
        f.write(bytes(data))


@pytest.mark.parametrize("damage, error, match", [
    (_truncate, drain_lib.TornShardError, "truncated"),
    (_corrupt_manifest, drain_lib.ManifestError, "corrupt"),
    (_flip_a_byte, drain_lib.TornShardError, "checksum"),
], ids=["truncated_shard", "corrupt_manifest", "checksum_mismatch"])
def test_damaged_generation_is_typed_and_rolls_back_to_last_good(
        tmp_path, damage, error, match):
    root = str(tmp_path / "ckpt")
    _drain(root, 1, scale=1.0)
    _drain(root, 2, scale=2.0)
    damage(root)
    specs = {"matrix": (), "replicated": (), "step": None}
    with pytest.raises(error, match=match):
        drain_lib.restore_sharded(root, specs)
    # the JAX reader refuses the same damage with its own typed error
    with pytest.raises(getattr(jdrain, error.__name__), match=match):
        jdrain.restore_sharded(root)
    tree, generation = drain_lib.restore_last_good(root, specs)
    assert generation == 1
    np.testing.assert_array_equal(
        tree["matrix"].numpy(),
        np.arange(32, dtype=np.float32).reshape(8, 4))
    # and the failed restore deleted NOTHING
    assert drain_lib.list_generations(root) == [1, 2]


def test_wrong_generation_is_typed(tmp_path):
    root = str(tmp_path / "ckpt")
    _drain(root, 2)
    with pytest.raises(drain_lib.WrongGenerationError):
        drain_lib.restore_sharded(root, expect_generation=3)
    assert drain_lib.restore_sharded(root) is not None


def test_crash_before_manifest_leaves_last_good_committed(tmp_path):
    root = str(tmp_path / "ckpt")
    _drain(root, 1, scale=1.0)
    gen2 = os.path.join(root, "gen-2")
    os.makedirs(gen2)
    with open(os.path.join(gen2, drain_lib._shard_name(0, 1)), "wb") as f:
        f.write(b"partial")
    assert drain_lib.latest_generation(root) == 1
    tree = drain_lib.restore_sharded(root, expect_generation=1)
    assert int(tree["step"]) == 7
    assert_checkpoint_invariants(root)
    _, generation = drain_lib.restore_last_good(root)
    assert generation == 1


def test_empty_root_is_no_checkpoint(tmp_path):
    with pytest.raises(drain_lib.NoCheckpointError):
        drain_lib.restore_sharded(str(tmp_path / "nothing"))
    with pytest.raises(drain_lib.NoCheckpointError):
        drain_lib.restore_last_good(str(tmp_path / "nothing"))


def test_invariants_catch_a_deleted_sole_copy(tmp_path):
    root = str(tmp_path / "ckpt")
    _drain(root, 1)
    shutil.rmtree(os.path.join(root, "gen-1"))
    with pytest.raises(AssertionError, match="sole surviving copy"):
        assert_checkpoint_invariants(root)


def test_manifest_records_generation_world_and_checksums(tmp_path):
    root = str(tmp_path / "ckpt")
    _drain(root, 4)
    with open(os.path.join(root, "gen-4", "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["format"] == drain_lib.SHARDED_FORMAT \
        == jdrain.SHARDED_FORMAT
    assert manifest["generation"] == 4
    assert manifest["process_count"] == 1
    name = drain_lib._shard_name(0, 1)
    assert name == jdrain._shard_name(0, 1)
    assert set(manifest["shards"]) == {name}
    meta = manifest["shards"][name]
    assert meta["sha256"] == jdrain._sha256(os.path.join(root, "gen-4",
                                                         name))
    assert meta["bytes"] == os.path.getsize(os.path.join(root, "gen-4",
                                                         name))


def test_legacy_drain_is_atomic_and_leaves_no_tmp(tmp_path):
    path = str(tmp_path / "ckpt" / "state.ckpt")
    tree = _tree()
    drain_lib.drain(tree, path)
    restored = drain_lib.restore(path, {"matrix": (), "replicated": (),
                                        "step": None})
    _leaves_equal(restored, tree)
    leftovers = [n for n in os.listdir(os.path.dirname(path))
                 if n.endswith(".draining")]
    assert leftovers == [], "tmp file outlived the atomic rename"


def test_legacy_drain_failure_keeps_the_old_checkpoint(tmp_path,
                                                       monkeypatch):
    path = str(tmp_path / "state.ckpt")
    drain_lib.drain(_tree(scale=1.0), path)
    good = open(path, "rb").read()

    def exploding_dumps(*a, **k):
        raise OSError("disk full mid-serialize")
    monkeypatch.setattr(drain_lib.pickle, "dumps", exploding_dumps)
    with pytest.raises(OSError):
        drain_lib.drain(_tree(scale=2.0), path)
    monkeypatch.undo()
    assert open(path, "rb").read() == good
    assert [n for n in os.listdir(str(tmp_path))
            if n.endswith(".draining")] == []


# -- across worlds, and across packages ---------------------------------------

@pytest.fixture(scope="module")
def megatron_root(tmp_path_factory):
    """A train state on the Megatron split of a world of 2, drained as
    generation 1; returns (root, the drained tree whole)."""
    root = str(tmp_path_factory.mktemp("megatron") / "ckpt")
    drained = _world(2, torch_worlds.drain_state_world, root, TINY,
                     _tokens())
    return root, drained[0]


def test_world_of_two_drains_world_of_four_restores_bitwise(megatron_root):
    root, drained = megatron_root
    assert_checkpoint_invariants(root)
    with open(os.path.join(root, "gen-1", "manifest.json")) as f:
        assert json.load(f)["process_count"] == 2
    got = _world(4, torch_worlds.restore_state_world, root, TINY,
                 {"data": 2, "seq": 1, "model": 2})
    for rank in got:
        assert rank["own_slices"]
        assert rank["step"] == 2
        _leaves_equal(rank["tree"], drained)
    # AdamW's per-parameter step survived (bias correction continues)
    assert float(got[0]["tree"]["opt"]["embed"]["step"]) == 2.0


def test_jax_invariants_and_reader_accept_the_port_state_root(
        megatron_root):
    root, drained = megatron_root
    assert_checkpoint_invariants(root)
    host = jdrain.restore_sharded(root)
    assert int(host["step"]) == 2
    _leaves_equal(host, drained)


def test_bf16_leaf_is_carried_bitwise_and_refused_by_the_jax_reader(
        tmp_path):
    """numpy has no bfloat16: a bf16 leaf travels as its uint16 bits
    under a dtype name the JAX reader cannot parse, so JAX fails loudly
    instead of casting the bits by value."""
    root = str(tmp_path / "ckpt")
    values = torch.randn(6, 5, generator=torch.Generator().manual_seed(0))
    tree = {"w": values.to(torch.bfloat16), "f": values, "step": 3}
    drain_lib.drain_sharded(tree, root, 1)
    restored = drain_lib.restore_sharded(root)
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"].view(torch.int16),
                       tree["w"].view(torch.int16))
    assert torch.equal(restored["f"], values)
    assert_checkpoint_invariants(root)
    assert jax.numpy.bfloat16 is not None    # ml_dtypes is registered
    with pytest.raises(TypeError, match=drain_lib.BF16_BITS):
        jdrain.restore_sharded(root)
