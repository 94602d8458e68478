"""Readings that the limits of a cell are set from (not part of a run).

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,... \\
        [--control-seeds a,b,c] [--fault-seeds a,b,c] [--out file.json]

In one process, for each seed of ``--seeds``: the program's first steps
as a run takes them (:func:`benchmark.run.program_readings`), then
the plain reference, and the three numbers of :mod:`benchmark.check`.
For each of ``--control-seeds`` the control is read against the same
reference: the reference itself with every matrix product's operands in
float8 (``precision="fp8"``). For each of ``--fault-seeds`` the program
is read again with each fault of :data:`FAULTS` planted under it.

The lower reading of a number is the largest that sound seeds give; the
upper, the smallest that the control gives, or a fault (see ``PERF.md``).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time

import torch

from benchmark import check, inputs, run, spec


@contextlib.contextmanager
def _patched(module, name: str, value):
    original = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, original)


@contextlib.contextmanager
def unchanged_state(cell):
    """The step computes its loss and returns the state unchanged. Written
    for the dense decoder's step alone: any other program is refused."""
    if cell.config["program"] != "decoder_lm":
        raise ValueError(f"unchanged_state plants a dense decoder's step; "
                         f"program {cell.config['program']!r} has none")
    from gpumounter_tpu_torch.torchcheck import model as model_lib
    from gpumounter_tpu_torch.torchcheck import train

    def make_train_step(cfg, mesh=None, attn_impl="ring"):
        attn = model_lib.make_attention(mesh, cfg, impl=attn_impl)

        def step(state, tokens):
            with torch.no_grad():
                logits = model_lib.forward(state.model, tokens, cfg,
                                           attn_fn=attn, mesh=mesh)
                return state, train.cross_entropy(logits, tokens)
        return step

    with _patched(train, "make_train_step", make_train_step):
        yield


@contextlib.contextmanager
def half_batch(cell):
    """The loss leaves out half of the batch (half of the rows, or of the
    positions of a single row) and takes the mean over the rest."""
    from gpumounter_tpu_torch.torchcheck import train
    full = train.cross_entropy

    def cross_entropy(logits, tokens):
        b, t = tokens.shape
        if b > 1:
            return full(logits[:b // 2], tokens[:b // 2])
        return full(logits[:, :t // 2], tokens[:, :t // 2])

    with _patched(train, "cross_entropy", cross_entropy):
        yield


# The faults a one-chip training cell can have, each planted by
# ``with FAULTS[name](cell):``. It exchanges nothing between chips, and
# produces no token or checkable answer of its own: its outputs are the
# state and the loss.
FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch}


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def program(cell, seed: int, pool, device) -> dict:
    state, step = run.build_program(cell, seed, device)
    state, readings = run.program_readings(cell, seed, state, step, pool,
                                           device)
    del state, step
    _free(device)
    return readings


def calibrate(cell, seeds, control_seeds=(), fault_seeds=(), device=None,
              log=None) -> list[dict]:
    """One record per (seed, kind): kind is "program", "control" or a
    fault's name; each with its three numbers and both sides' readings."""
    records = []
    for seed in sorted(set(seeds) | set(control_seeds) | set(fault_seeds)):
        pool = inputs.token_pool(cell.traffic,
                                 cell.program.dims(cell.config).vocab, seed,
                                 device)
        sides = {}
        if seed in seeds:
            sides["program"] = program(cell, seed, pool, device)
        for name, fault in FAULTS.items():
            if seed in fault_seeds:
                with fault(cell):
                    sides[name] = program(cell, seed, pool, device)
        t0 = time.perf_counter()
        ref = run.reference_readings(cell, seed, pool, device)
        ref_s = time.perf_counter() - t0
        _free(device)
        if seed in control_seeds:
            sides["control"] = run.reference_readings(cell, seed, pool,
                                                      device, "fp8")
            _free(device)
        for kind, readings in sides.items():
            record = {"seed": seed, "kind": kind,
                      "numbers": check.compare(readings, ref),
                      "losses": readings["losses"],
                      "reference_losses": ref["losses"],
                      "reference_s": ref_s,
                      "readings": readings, "reference": ref}
            records.append(record)
            if log:
                print(json.dumps(record), file=log, flush=True)
    return records


def summary(records: list[dict]) -> dict:
    """Per kind and number: the largest and the smallest reading."""
    out: dict = {}
    for r in records:
        for name, value in r["numbers"].items():
            lo, hi = out.setdefault(r["kind"], {}).get(name, (value, value))
            out[r["kind"]][name] = (min(lo, value), max(hi, value))
    return out


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=_seeds, default=[])
    parser.add_argument("--control-seeds", type=_seeds, default=[])
    parser.add_argument("--fault-seeds", type=_seeds, default=[])
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    cell = spec.load_cell(args.workload)
    run.pin_caches(spec.ROOT)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    records = calibrate(cell, args.seeds, args.control_seeds,
                        args.fault_seeds, torch.device("cuda", 0),
                        log=sys.stdout)
    result = {"cell": cell.name, "device": torch.cuda.get_device_name(0),
              "summary": summary(records), "records": records}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result["summary"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
