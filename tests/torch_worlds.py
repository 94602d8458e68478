"""Per-rank functions of the parity tests' process worlds.

``dist.run_world`` spawns fresh processes that import the function they
run by name, so these live in a module that imports no JAX: the children
import only torch, numpy and the port. Each takes numpy inputs drawn by
the JAX side of a test, runs the port's sharded path on its shard, and
returns (from every rank; the tests read rank 0's) the unsharded results
as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from gpumounter_tpu_torch.torchcheck import convert
from gpumounter_tpu_torch.torchcheck import dist as dist_lib
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
