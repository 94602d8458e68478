"""Find the benchmark's parts by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, one traffic mix, one cell or
one per-layer metric is a file of its own, found by its name:

- ``benchmark/configs/<config>.json``: the model's sizes as they are run
  (the published ``config.json`` keys, with every change listed under
  ``reduced``), the name of its program under ``program`` and of its
  plain reference under ``reference``;
- ``benchmark/programs/<program>.py``: the port's side of a cell, the
  only code that knows the model's leaves and sizes. The harness calls
  its ``dims(config)`` (at least ``vocab`` and ``dtype``),
  ``groups(dims)`` (the weights' leaves, :mod:`benchmark.inputs`),
  ``build(config, dims, params, device)`` (``(state, step)``: a state with
  ``.model`` and ``.optimizer``, and ``step(state, tokens)`` giving
  ``(state, loss)``) and ``step_counts(dims, batch, seq)`` (the keys of
  :data:`benchmark.counts.KEYS`);
- ``benchmark/reference/<reference>.py``: that plain reference;
- ``benchmark/traffic/<traffic>.json``: the parameters the one generator
  in :mod:`benchmark.inputs` reads;
- ``benchmark/limits/<cell>.json``: the limits of the cell's comparison
  with the reference, with the readings they were set from;
- ``benchmark/metrics/<metric>.py``: a reader with ``read(trace)``.

So a cell, a configuration or a metric is added by adding files and
entries, and no file that is there changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = Path(__file__).resolve().parent.name


@dataclasses.dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with the files it names, loaded."""
    name: str
    chips: int
    config_name: str
    config: dict
    program: ModuleType
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: tuple[dict, ...]
    per_layer: tuple[dict, ...]


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return _read_json(root / "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic, limits and the
    metrics it reports. Raises KeyError for a name BENCHMARK.json lacks."""
    bench = load_benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(known: {sorted(entries)})")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(root / configs[entry["config"]]["file"])
    base = root / PACKAGE
    return Cell(
        name=name, chips=int(entry["chips"]),
        config_name=entry["config"], config=config,
        program=program_module(config, root),
        traffic_name=entry["traffic"],
        traffic=_read_json(base / "traffic" / f"{entry['traffic']}.json"),
        limits=_read_json(base / "limits" / f"{name}.json"),
        end_to_end=tuple(m for m in bench["end_to_end"]
                         if _applies(m, name)),
        per_layer=tuple(m for m in bench["per_layer"] if _applies(m, name)))


def _module(kind: str, name: str, root: Path) -> ModuleType:
    """``benchmark/<kind>/<name>.py`` as a module (names may hold ``.``
    and ``-``, so it is loaded by path, not by import name)."""
    path = root / PACKAGE / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"{kind} {name!r}: no file {path}")
    key = f"{PACKAGE}.{kind}.{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    # registered, as an import would be, so that a dataclass in it can
    # resolve its own annotations
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, root: Path = ROOT):
    """The ``read(trace)`` function of per-layer metric ``name``."""
    return _module("metrics", name, root).read


def program_module(config: dict, root: Path = ROOT) -> ModuleType:
    """The program the configuration names."""
    if "program" not in config:
        raise KeyError("the configuration names no \"program\" (a file "
                       f"under {PACKAGE}/programs/)")
    return _module("programs", config["program"], root)


def reference_module(config: dict, root: Path = ROOT) -> ModuleType:
    """The plain reference the configuration names."""
    return _module("reference", config["reference"], root)
