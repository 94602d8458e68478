"""Per-rank functions of the parity tests' process worlds.

``dist.run_world`` spawns fresh processes that import the function they
run by name, so these live in a module that imports no JAX: the children
import only torch, numpy and the port. Each takes numpy inputs drawn by
the JAX side of a test, runs the port's sharded path on its shard, and
returns (from every rank; the tests read rank 0's) the unsharded results
as numpy arrays.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from gpumounter_tpu_torch.torchcheck import convert
from gpumounter_tpu_torch.torchcheck import dist as dist_lib
from gpumounter_tpu_torch.torchcheck import drain as tdrain
from gpumounter_tpu_torch.torchcheck import elastic as telastic
from gpumounter_tpu_torch.torchcheck import federation as tfed
from gpumounter_tpu_torch.torchcheck import model as tmodel
from gpumounter_tpu_torch.torchcheck import moe as tmoe
from gpumounter_tpu_torch.torchcheck import pipeline as tpipe
from gpumounter_tpu_torch.torchcheck import train as ttrain
from gpumounter_tpu_torch.torchcheck.ring_attention import (
    make_sharded_ring_attention)
from gpumounter_tpu_torch.torchcheck.ulysses import make_ulysses_attention

BTHD = (None, "seq", None, None)
MESH_BTHD = ("data", "seq", "model", None)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().numpy()


def _attend(attn, mesh, spec, arrays, grads: bool):
    """attn over the shards of numpy (q, k, v[, w]); returns the unsharded
    output and, with ``grads``, the unsharded grads of sum(out * w)."""
    q, k, v = (dist_lib.shard(torch.from_numpy(a), mesh, spec).requires_grad_(
        grads) for a in arrays[:3])
    out = attn(q, k, v)
    result = {"out": _np(dist_lib.unshard(out, mesh, spec))}
    if grads:
        w = dist_lib.shard(torch.from_numpy(arrays[3]), mesh, spec)
        (out * w).sum().backward()
        for name, x in zip(("dq", "dk", "dv"), (q, k, v)):
            result[name] = _np(dist_lib.unshard(x.grad, mesh, spec))
    return result


def _model(cfg, np_params, mesh):
    net = convert.load_jax_params(tmodel.Transformer(cfg, device="cpu"),
                                  np_params)
    return tmodel.shard_model(net, mesh)


def _logits(cfg, np_params, tokens, mesh, impl):
    net = _model(cfg, np_params, mesh)
    attn = tmodel.make_attention(mesh, cfg, impl)
    with torch.no_grad():
        logits = tmodel.forward(net, dist_lib.shard(
            torch.from_numpy(tokens).long(), mesh, ("data", "seq")), cfg,
            attn, mesh)
    return _np(dist_lib.unshard(logits, mesh, ("data", "seq")))


def parallel_world(device, inp: dict, cfg_fields: dict) -> dict:
    """Ring, Ulysses and the (data, seq, model) train step, on a seq-only
    mesh of the whole world and on a (2, 2, 2) mesh."""
    cfg = tmodel.ModelConfig(**cfg_fields)
    seq_mesh = tmodel.make_mesh(device=device)
    ring = make_sharded_ring_attention(seq_mesh)
    ring_pallas = make_sharded_ring_attention(seq_mesh, block_impl="pallas")
    res = {
        "ring8": _attend(ring, seq_mesh, BTHD, inp["ring8"], False),
        "causal": [_attend(ring, seq_mesh, BTHD, qkv, False)["out"]
                   for qkv in inp["causal"]],
        "ring8_grad": _attend(ring, seq_mesh, BTHD, inp["ring8_grad"], True),
        "pallas8": _attend(ring_pallas, seq_mesh, BTHD, inp["pallas8"],
                           False),
        "pallas8_grad": _attend(ring_pallas, seq_mesh, BTHD,
                                inp["pallas8_grad"], True),
        "uly": _attend(make_ulysses_attention(seq_mesh), seq_mesh, BTHD,
                       inp["uly"], False),
        "uly_flash": _attend(make_ulysses_attention(seq_mesh,
                                                    local_impl="flash"),
                             seq_mesh, BTHD, inp["uly_flash"], True),
    }

    mesh = tmodel.make_mesh(data=2, model=2, device=device)
    res["composed"] = _attend(make_sharded_ring_attention(mesh), mesh,
                              MESH_BTHD, inp["composed"], False)
    params, tokens = inp["train"]
    state = ttrain.TrainState(net := _model(cfg, params, mesh),
                              ttrain.make_optimizer(net.parameters()))
    step = ttrain.make_train_step(cfg, mesh)
    local = dist_lib.shard(torch.from_numpy(tokens).long(), mesh,
                           ("data", "seq"))
    losses = []
    for _ in range(3):
        state, loss = step(state, local)
        losses.append(float(loss))
    res["train_losses"] = losses
    params, tokens = inp["logits"]
    res["logits"] = {impl: _logits(cfg, params, tokens, mesh, impl)
                     for impl in ("ring", "ulysses")}
    params, tokens = inp["logits_t256"]
    res["logits_t256"] = {impl: _logits(cfg, params, tokens, mesh, impl)
                          for impl in ("ring_pallas", "ulysses_flash")}
    no_seq = tmodel.make_mesh(data=2, seq=1, model=4, device=device)
    res["logits_t256"]["seq1_ring"] = _logits(cfg, params, tokens, no_seq,
                                              "ring")
    return res


def moe_pipeline_world(device, inp: dict, moe_fields: dict) -> dict:
    """Expert-parallel MoE on a (data 2, expert 4) mesh, and the GPipe
    pipeline over the first ``n_stages`` ranks for each case of
    ``inp["pipelines"]``."""
    res: dict = {}
    cfg = tmoe.MoEConfig(**moe_fields)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "expert"))
    params = convert.tensors_from_jax(inp["moe_params"])
    x = torch.from_numpy(inp["moe_x"])
    local = tmoe.with_expert_sharding(mesh, params)
    local_x = dist_lib.shard(x, mesh, ("data",))
    out = tmoe.moe_ffn(local, local_x, cfg, mesh)
    res["moe_out"] = _np(dist_lib.unshard(out, mesh, ("data",)))
    loss, grads = tmoe.make_moe_value_and_grad(cfg, mesh)(local, local_x)
    specs = tmoe.moe_param_shardings()
    res["moe_grads"] = {k: _np(dist_lib.unshard(g, mesh, specs[k]))
                        for k, g in grads.items()}
    res["moe_loss"] = float(loss)
    step = tmoe.make_moe_train_step(cfg, mesh)
    losses = []
    for _ in range(4):
        local, loss = step(local, local_x)
        losses.append(float(loss))
    res["moe_losses"] = losses

    for key, case in inp["pipelines"].items():
        n_stages = case["n_stages"]
        pp_mesh = DeviceMesh("cpu", torch.arange(n_stages),
                             mesh_dim_names=("pipe",))
        if dist.get_rank() >= n_stages:
            continue
        layers = convert.tensors_from_jax(case["layers"])
        mbs = torch.from_numpy(case["mbs"])
        stacked = tpipe.stack_stage_params(layers, n_stages)
        leaves = {k: v.requires_grad_(True) for k, v in
                  tpipe.place_stage_params(pp_mesh, stacked).items()}
        out = tpipe.make_pipeline(pp_mesh, tpipe.mlp_block)(leaves, mbs)
        loss = torch.mean(torch.square(out - torch.roll(mbs, 1, dims=-2)))
        loss.backward()
        res[key] = {"out": _np(out), "grads": {
            k: _np(dist_lib.unshard(v.grad, pp_mesh, ("pipe",)))
            for k, v in leaves.items()}}
        step = tpipe.make_pipeline_train_step(pp_mesh)
        stage_params = tpipe.place_stage_params(pp_mesh, stacked)
        losses = []
        for _ in range(3):
            stage_params, loss = step(stage_params, mbs)
            losses.append(float(loss))
        res[key]["losses"] = losses
    return res


def _whole_tree(tree, specs, mesh) -> dict:
    """A state tree of this rank's shards as whole numpy arrays. No
    tensor may go back to the parent: torch sends a tensor through a
    queue as a handle to this process's memory, which is gone once the
    process exits."""
    def whole(leaf, spec):
        if spec is not None:
            leaf = dist_lib.unshard(leaf, mesh, spec)
        return _np(leaf) if isinstance(leaf, torch.Tensor) else leaf
    return tdrain._map(whole, tree, specs)


def drain_state_world(device, root: str, cfg_fields: dict,
                      tokens: np.ndarray) -> dict:
    """A train state on the Megatron split of the world (model = world
    size), two steps, then ``drain_sharded`` generation 1 with the
    world's barrier. Returns the drained tree, whole."""
    cfg = tmodel.ModelConfig(**cfg_fields)
    mesh = tmodel.make_mesh(data=1, seq=1, model=dist.get_world_size(),
                            device=device)
    state = ttrain.init_state(cfg, seed=0, device=device, mesh=mesh, lr=1e-2)
    step = ttrain.make_train_step(cfg, mesh)
    local = dist_lib.shard(torch.from_numpy(tokens).long(), mesh,
                           ("data", "seq"))
    for _ in range(2):
        state, _ = step(state, local)
    specs = telastic.state_specs(cfg)
    tree = ttrain.state_tree(state)
    tdrain.drain_sharded(tree, root, 1, specs=specs, mesh=mesh,
                         sync_fn=dist.barrier)
    return _whole_tree(tree, specs, mesh)


def restore_state_world(device, root: str, cfg_fields: dict,
                        dims: dict) -> dict:
    """``restore_sharded`` onto a (data, seq, model) = ``dims`` mesh of
    the world. Returns the restored tree, whole, and whether each rank's
    tensors are exactly its slices of it."""
    cfg = tmodel.ModelConfig(**cfg_fields)
    mesh = tmodel.make_mesh(**dims, device=device)
    specs = telastic.state_specs(cfg)
    tree = tdrain.restore_sharded(root, specs, mesh=mesh, device=device,
                                  expect_generation=1)
    whole = _whole_tree(tree, specs, mesh)
    own = tdrain._map(
        lambda leaf, full, spec: spec is None or torch.equal(
            leaf, dist_lib.shard(torch.from_numpy(full), mesh, spec)),
        tree, whole, specs)
    state = ttrain.state_from_tree(cfg, tree, device, lr=1e-2)
    return {"tree": whole, "own_slices": all(tdrain._leaves(own)),
            "step": state.step}


class FixedBatches:
    """The token batch of each step from a fixed list (the JAX harness's
    batches), for a pod process's ranks (picklable)."""

    def __init__(self, batches: list):
        self.batches = [np.asarray(b) for b in batches]

    def __call__(self, step: int):
        return self.batches[step]


# A state-shaped tree on a 1-D mesh "x" (the JAX drain tests' tree): a
# matrix sharded over x, a replicated vector, a host step counter.
X_SPECS = {"matrix": ("x", None), "replicated": (), "step": None}


def _x_mesh():
    return init_device_mesh("cpu", (dist.get_world_size(),),
                            mesh_dim_names=("x",))


def x_drain_world(device, root: str, generation: int) -> None:
    mesh = _x_mesh()
    matrix = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    tree = {"matrix": dist_lib.shard(matrix, mesh, X_SPECS["matrix"]),
            "replicated": torch.ones(3), "step": 7}
    tdrain.drain_sharded(tree, root, generation, specs=X_SPECS, mesh=mesh,
                         sync_fn=dist.barrier)


def x_restore_world(device, root: str) -> dict:
    mesh = _x_mesh()
    tree = tdrain.restore_sharded(root, X_SPECS, mesh=mesh, device=device,
                                  expect_generation=1)
    return {"matrix": _np(dist_lib.unshard(tree["matrix"], mesh,
                                           X_SPECS["matrix"])),
            "local_shape": tuple(tree["matrix"].shape),
            "replicated": _np(tree["replicated"]),
            "step": int(tree["step"])}


def legacy_restore_world(device, path: str, cfg_fields: dict,
                         dims: dict) -> dict:
    """The legacy single-file params checkpoint restored onto a
    (data, seq, model) = ``dims`` mesh of the world: each rank's slices,
    gathered whole."""
    cfg = tmodel.ModelConfig(**cfg_fields)
    mesh = tmodel.make_mesh(**dims, device=device)
    specs = tmodel.param_shardings(cfg)
    params = tdrain.restore(path, specs, mesh=mesh, device=device)
    return {"params": _whole_tree(params, specs, mesh),
            "local_wqkv": tuple(params["layers.0.wqkv"].shape)}


def agreement_world(device, values: list) -> int:
    """Each rank contributes ``values[rank]`` to the world's agreement."""
    return tfed.WorldAgreement().agree(values[dist.get_rank()])


def vanishing_world(device) -> int:
    """Rank 1 leaves without a word (as a killed process does); the
    others wait for it in a collective."""
    import os
    if dist.get_rank() == 1:
        os._exit(3)
    x = torch.ones(1)
    dist.all_reduce(x)
    return int(x.item())


def stuck_world(device) -> int:
    """Rank 1 never reaches the collective its peers wait in (a stuck
    rank); its stack is what the world's stack dump must name."""
    import time
    if dist.get_rank() == 1:
        time.sleep(600)
    x = torch.ones(1)
    dist.all_reduce(x)
    return int(x.item())


def rank_layout(device) -> tuple:
    """(global rank, local rank, pod process index, world size) as a rank
    of a ``LocalWorld`` sees them."""
    local = int(os.environ["LOCAL_RANK"])
    return (dist.get_rank(), local,
            dist.get_rank() // int(os.environ["LOCAL_WORLD_SIZE"]),
            dist.get_world_size())


def local_sizes(device) -> list:
    """The world's check that every pod drives the same N."""
    return dist_lib.check_local_sizes()


def rank_sum(device) -> int:
    """The sum of the ranks over the world."""
    x = torch.tensor([dist.get_rank()])
    dist.all_reduce(x)
    return int(x.item())


def _stamp(path: str, generation: int, chips: list) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump({"generation": generation, "chips": chips}, f)
    os.replace(tmp, path)


def pod_ride(root: str, signal_path: str, chips: list,
             result_path: str) -> None:
    """A pod process on the card: one rank rides a bump of its pod's
    generation file (stamped at generation 1, then 2 after step 2) with
    the flash step on a small bf16 model; writes its exit code, its
    status records and whether it ever initialised CUDA."""
    from functools import partial
    cfg = tmodel.ModelConfig(vocab=64, d_model=128, n_heads=2, n_layers=1,
                             d_ff=256, dtype=torch.bfloat16)
    records = []

    def on_record(record):
        records.append(record)
        if record["phase"] == "step" and record["step"] == 2:
            _stamp(signal_path, 2, chips)

    _stamp(signal_path, 1, chips)
    ride = telastic.ElasticSupervisor(
        cfg, telastic.FileSignal(signal_path), os.path.join(root, "ckpt"),
        device="cuda", batches=telastic.SeededBatches(2, 128, cfg.vocab),
        step_factory=partial(ttrain.make_train_step, attn_impl="flash"),
        max_steps=4, verify=True, on_record=on_record)
    rc = ride.run()
    with open(result_path, "w") as f:
        json.dump({"rc": rc, "records": records,
                   "cuda_initialized": torch.cuda.is_initialized()}, f)
