"""BENCHMARK.json keeps to its contract, and the harness finds every
configuration, cell, traffic mix and metric by its name, including ones
added by files alone."""

import json
import re

import pytest
import torch

from benchmark import check, counts, run, spec
from benchmark import trace as trace_lib
from benchmark.tests.tiny import TINY, tiny_root

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# keys of sizes that a cut may never change (widths, heads, experts a token)
WIDTHS = re.compile(r"(_size|_dim|_rank|_width|_heads|experts_per_tok)$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "-m", "benchmark.run"]
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_entries():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTHS.search(k)
                   for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] == "train_tokens_per_s"
        assert set(m["workloads"]) <= set(CELLS)
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads_by_name(cell):
    loaded = spec.load_cell(cell)
    d = loaded.program.dims(loaded.config)
    assert d.d_model % d.n_heads == 0 and d.head_dim in (64, 128)
    assert loaded.traffic["seq"] % 128 == 0
    compared = set(check.NAMES) & set(loaded.limits)
    assert compared and set(loaded.limits["readings"]["lower"]) == set(
        check.NAMES)
    assert set(check.NAMES) - compared == set(
        loaded.limits.get("not_compared", {}))
    assert {m["name"] for m in loaded.end_to_end} == {
        "train_tokens_per_s", "setup_s"}
    for metric in loaded.per_layer:
        assert callable(spec.metric_reader(metric["name"]))
    assert hasattr(spec.reference_module(loaded.config), "train")


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=lambda c: c["name"])
def test_config_file_states_its_cuts(config):
    body = json.loads((spec.ROOT / config["file"]).read_text())
    assert body["source"] == config["source"]
    assert body["reduced"] == config["reduced"]
    assert set(body["reduced"]) == set(body["published"])
    for key in body["reduced"]:
        assert key in body and body[key] != body["published"][key]
    assert body["deployment"] and body["departures"] and body["assumed"]


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell")


def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path):
    root = tiny_root(tmp_path)
    (root / "benchmark" / "metrics" / "tokens_per_step.py").write_text(
        "def read(trace):\n"
        "    return trace.counts['tokens']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "tokens_per_step", "unit": "tokens", "better": "higher",
        "source": "program_counter", "layer": "train step",
        "moves": "train_tokens_per_s", "workloads": [TINY]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell(TINY, root)
    assert cell.config["hidden_size"] == 64
    assert "tokens_per_step" in [m["name"] for m in cell.per_layer]
    assert "tokens_per_step" not in [
        m["name"] for m in spec.load_cell(CELLS[0], root).per_layer]
    d = cell.program.dims(cell.config)
    tr = trace_lib.Trace([], {}, [], [], (0.0, 1e6), 1,
                         cell.program.step_counts(d, 2, 256), None)
    assert spec.metric_reader("tokens_per_step", root)(tr) == 512.0


# A program of another architecture's place, as a later PR would add it:
# the dense decoder underneath, every call the harness makes recorded.
RECORDING = '''
from pathlib import Path

from benchmark import spec

BASE = spec.program_module({"program": "decoder_lm"},
                           Path(__file__).resolve().parents[2])
CALLS = []


def dims(config):
    CALLS.append("dims")
    return BASE.dims(config)


def groups(d):
    CALLS.append("groups")
    return BASE.groups(d)


def build(config, d, params, device):
    CALLS.append("build")
    state, step = BASE.build(config, d, params, device)

    def recorded(state, tokens):
        CALLS.append("step")
        return step(state, tokens)
    return state, recorded


def step_counts(d, batch, seq):
    CALLS.append("step_counts")
    return BASE.step_counts(d, batch, seq)
'''


def _files(base):
    return {p.relative_to(base): p.read_bytes() for p in base.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_program_added_as_files_is_the_one_the_run_drives(tmp_path):
    """A module under programs/ and a configuration that names it: the
    run goes through it alone (setup's two steps, the traced window's),
    and no file the benchmark had changes."""
    root = tiny_root(tmp_path, program="recording")
    (root / spec.PACKAGE / "programs" / "recording.py").write_text(RECORDING)
    cell = spec.load_cell(TINY, root)
    assert cell.program.__file__ == str(
        root / spec.PACKAGE / "programs" / "recording.py")
    result, _ = run.run_cell(cell, 2**31 + 21, 0.2, True,
                             torch.device("cpu"), root)
    calls = cell.program.CALLS
    assert result["correct"], result["checks"]
    assert calls.count("step") == result["attempted"]
    assert {"dims", "groups", "build", "step_counts"} <= set(calls)
    assert calls.index("build") < calls.index("step")
    have = _files(spec.ROOT / spec.PACKAGE)
    copied = _files(root / spec.PACKAGE)
    assert all(copied[p] == have[p] for p in copied if p in have)


def test_a_configuration_without_a_program_is_refused(tmp_path):
    root = tiny_root(tmp_path)
    path = root / spec.PACKAGE / "configs" / "tiny.json"
    body = json.loads(path.read_text())
    del body["program"]
    path.write_text(json.dumps(body))
    with pytest.raises(KeyError, match="program"):
        spec.load_cell(TINY, root)


def test_readers_find_nothing_in_an_empty_trace():
    tr = trace_lib.Trace([], {}, [], [], (0.0, 1e6), 0,
                         {"model_flops": 1.0, "gemm_flops": 1.0,
                          "attn_flops": 1.0, "attn_bytes": 1.0,
                          "tokens": 1.0}, None)
    for metric in BENCH["per_layer"]:
        assert spec.metric_reader(metric["name"])(tr) is None


def test_readers_on_a_made_up_trace():
    """Two steps: a GEMM, a flash kernel and an AdamW kernel each, with
    gaps; the readers' arithmetic by hand."""
    op = trace_lib.Op
    device = []
    for s in range(2):
        t0 = s * 100.0
        device += [op("sm90_xmma_gemm_bf16", t0 + 10, t0 + 40, 3 * s + 1),
                   op("void flash::flash_fwd_wgmma_kernel<128>", t0 + 40,
                      t0 + 60, 3 * s + 2),
                   op("multi_tensor_apply_kernel", t0 + 70, t0 + 80,
                      3 * s + 3)]
    launches = {3 * s + k: op("cudaLaunchKernel", s * 100.0 + k, s * 100.0
                              + k + 0.5, 3 * s + k, 1)
                for s in range(2) for k in (1, 2, 3)}
    ranges = [op("Optimizer.step#AdamW.step", 2.5, 3.5, None, 1),
              op("Optimizer.step#AdamW.step", 103.0, 103.9, None, 1),
              op(trace_lib.WINDOW, 0.0, 200.0, None, 1)]
    counts_ = {"model_flops": 1e6, "gemm_flops": 6e5, "attn_flops": 4e5,
               "attn_bytes": 1e3, "tokens": 8.0}
    peaks = {"flops": 1e12, "bytes": 1e9}
    tr = trace_lib.Trace(device, launches, ranges, [], (0.0, 200.0), 2,
                         counts_, peaks)
    read = {m["name"]: spec.metric_reader(m["name"])(tr)
            for m in BENCH["per_layer"]}
    # window 200 us, busy 2 x 60 us
    assert read["device_idle_pct"] == pytest.approx(40.0)
    assert read["attn_share_pct"] == pytest.approx(100 * 40 / 120)
    # least time max(4e5 / 1e12, 1e3 / 1e9) = 1 us a step, kernels 20 us
    assert read["attn_roofline"] == pytest.approx(5.0)
    assert read["gemm_roofline"] == pytest.approx(100 * 0.6 / 30)
    assert read["step_mfu"] == pytest.approx(100 * 2e6 / 200e-6 / 1e12)
    # each step's third launch lies inside AdamW's range: 10 us a step
    assert read["optimizer_ms"] == pytest.approx(1e-2)
    gaps = tr.breakdown()["idle_gaps"]
    assert [round(s * 1e6, 6) for _, s in gaps[:2]] == [30.0, 20.0]
    assert sum(s for _, s in gaps) == pytest.approx(80e-6)
