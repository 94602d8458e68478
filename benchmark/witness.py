"""Readings of where the program's first gradient departs from the
reference's, by a second path (not part of a run).

    python3 -m benchmark.witness --config <name> --traffic <name> \\
        --seeds a,b,c [--out file.json]

For each seed, the program's first steps as a run takes them
(:func:`benchmark.run.program_readings`), with the gradient that the
port's backward hands to the embedding's lookup (``embed[tokens]``) caught
on its way. The embedding's first gradient norm is read five ways:

- ``program``: the port's own, as a run reads it;
- ``index_put_bf16``: the caught gradient summed per id by
  ``index_put_(accumulate=True)`` into bfloat16, the lookup's backward
  alone;
- ``embedding_backward``: the same by ``aten.embedding_dense_backward``
  (the backward of ``F.embedding``), also into bfloat16;
- ``index_add_f32``: the same summed in float32;
- ``reference``: the plain reference's.

Then the reference's steps again with float32 parameters and moments in
place of the stated bfloat16 state, and the norm of each norm gain's
change (``ln1.g``, ``ln2.g``, ``ln_f.g``) on the three sides.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import torch
from torch.overrides import TorchFunctionMode

from benchmark import calibrate, inputs, run, spec


class CatchLookupGrad(TorchFunctionMode):
    """Keeps the first gradient that flows into ``weight[index]``."""

    def __init__(self, weight: torch.Tensor):
        super().__init__()
        self.weight, self.index, self.grad = weight, None, None

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (func is torch.Tensor.__getitem__ and args[0] is self.weight
                and self.index is None):
            self.index = args[1]
            out.register_hook(self._keep)
        return out

    def _keep(self, grad: torch.Tensor) -> None:
        if self.grad is None:
            self.grad = grad.detach().clone()


def load_parts(config: str, traffic: str, root=spec.ROOT) -> spec.Cell:
    """A cell of ``config`` under ``traffic`` found by their file names,
    whether or not ``BENCHMARK.json`` holds it."""
    base = root / spec.PACKAGE
    body = json.loads((base / "configs" / f"{config}.json").read_text())
    return spec.Cell(
        name=f"{config}.{traffic}", chips=1, config_name=config,
        config=body, program=spec.program_module(body, root),
        traffic_name=traffic,
        traffic=json.loads((base / "traffic" / f"{traffic}.json").read_text()),
        limits={}, end_to_end=(), per_layer=())


def _gains(change_norms: dict[str, float]) -> dict[str, float]:
    gains = [v for n, v in change_norms.items() if n.endswith(".g")]
    return {"median": statistics.median(gains), "max": max(gains)}


def witness(cell: spec.Cell, seed: int, device) -> dict:
    vocab = cell.program.dims(cell.config).vocab
    pool = inputs.token_pool(cell.traffic, vocab, seed, device)
    state, step = run.build_program(cell, seed, device)
    catch = CatchLookupGrad(state.model.embed)
    shape = tuple(state.model.embed.shape)
    with catch:
        state, prog = run.program_readings(cell, seed, state, step, pool,
                                           device)
    del state, step
    ids, dx = catch.index.reshape(-1), catch.grad.reshape(-1, shape[1])
    embed = {
        "program": prog["grad_norms"]["embed"],
        "index_put_bf16": float(torch.zeros(shape, dtype=dx.dtype,
                                            device=device)
                                .index_put_((ids,), dx, accumulate=True)
                                .float().norm()),
        "embedding_backward": float(torch.ops.aten.embedding_dense_backward(
            dx, ids, vocab, -1, False).float().norm()),
        "index_add_f32": float(torch.zeros(shape, device=device)
                               .index_add_(0, ids, dx.float()).norm())}
    top = int(torch.bincount(ids).max())
    del catch, dx
    calibrate._free(device)
    ref = run.reference_readings(cell, seed, pool, device)
    calibrate._free(device)
    embed["reference"] = ref["grad_norms"]["embed"]
    master = dict(cell.config, torch_dtype="float32")
    ref32 = spec.reference_module(master).train(
        master, run.make_params(cell, seed, device),
        [pool[i] for i in range(run.SETUP_STEPS)])
    calibrate._free(device)
    return {"seed": seed, "most_frequent_id_count": top,
            "embed_grad_norm": embed,
            "embed_gap": {k: abs(v - embed["reference"]) / embed["reference"]
                          for k, v in embed.items() if k != "reference"},
            "gains_change": {"program": _gains(prog["change_norms"]),
                             "reference": _gains(ref["change_norms"]),
                             "reference_f32_state":
                                 _gains(ref32["change_norms"])}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--traffic", required=True)
    parser.add_argument("--seeds", type=calibrate._seeds, required=True)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    cell = load_parts(args.config, args.traffic)
    run.pin_caches(spec.ROOT)
    if not torch.cuda.is_available():
        print("witness: no CUDA device", file=sys.stderr)
        return 3
    records = []
    for seed in args.seeds:
        records.append(witness(cell, seed, torch.device("cuda", 0)))
        print(json.dumps(records[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"cell": cell.name,
                       "device": torch.cuda.get_device_name(0),
                       "records": records}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
