"""A copy of the benchmark in a temporary root with one more cell, ``tiny``:
a cell's configuration at tiny widths, added by files and entries alone."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark import spec

TINY = "tiny.b2-t256"


def tiny_root(tmp: Path, like: str = "pythia-6.9b.pretrain-t2048",
              dtype: str = "bfloat16", batch: int = 2, seq: int = 256,
              program: str | None = None, **sizes) -> Path:
    """``tmp`` holding BENCHMARK.json and benchmark/ with the cell ``tiny``:
    ``like``'s configuration at small sizes, its limits, and a Zipf
    traffic of ``batch`` x ``seq``. ``program`` names the configuration's
    program in place of ``like``'s."""
    shutil.copytree(spec.ROOT / spec.PACKAGE, tmp / spec.PACKAGE,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    entry = next(w for w in bench["workloads"] if w["name"] == like)
    config_file = next(c["file"] for c in bench["configs"]
                       if c["name"] == entry["config"])
    config = json.loads((spec.ROOT / config_file).read_text())
    config.update(hidden_size=64, num_attention_heads=2,
                  num_hidden_layers=2, intermediate_size=256,
                  vocab_size=512, torch_dtype=dtype)
    config.update(sizes)
    if program is not None:
        config["program"] = program
    base = tmp / spec.PACKAGE
    (base / "configs" / "tiny.json").write_text(json.dumps(config))
    (base / "traffic" / "tiny.json").write_text(json.dumps(
        {"batch": batch, "seq": seq, "zipf_exponent": 1.0, "pool": 4,
         "trace_steps": 2}))
    shutil.copy(spec.ROOT / spec.PACKAGE / "limits" / f"{like}.json",
                base / "limits" / f"{TINY}.json")
    bench["configs"].append({"name": "tiny", "source": "tiny",
                             "file": "benchmark/configs/tiny.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": TINY, "config": "tiny",
                               "traffic": "tiny", "chips": 1,
                               "why": "tests"})
    for metric in bench["per_layer"]:
        metric["workloads"].append(TINY)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
