"""The comparison that decides ``correct`` fails what it must: the float8
control, and every fault a training cell can have, planted under a run
that skips only the harness's look for a chip. Each cell's own limits,
on a tiny model of its configuration on the CPU."""

import pytest
import torch

from benchmark import calibrate, check, inputs, run, spec
from benchmark.tests.tiny import TINY, tiny_root

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
CPU = torch.device("cpu")


@pytest.fixture(params=CELLS)
def cell(request, tmp_path):
    return spec.load_cell(TINY, tiny_root(tmp_path, like=request.param))


def _run(cell, seed):
    result, _ = run.run_cell(cell, seed, 0.2, False, CPU)
    return result


def test_a_sound_run_is_correct(cell):
    result = _run(cell, 2**31 + 11)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] >= run.SETUP_STEPS + 1
    assert result["failed"] == 0


def test_the_float8_control_is_not_correct(cell):
    seed = 2**31 + 12
    pool = inputs.token_pool(cell.traffic, 512, seed, CPU)
    ref = run.reference_readings(cell, seed, pool, CPU)
    control = run.reference_readings(cell, seed, pool, CPU, "fp8")
    ok, shown = check.verdict(check.compare(control, ref), cell.limits)
    assert not ok, shown


@pytest.mark.parametrize("fault", sorted(calibrate.FAULTS))
def test_a_fault_under_the_run_is_not_correct(cell, fault):
    with calibrate.FAULTS[fault](cell):
        result = _run(cell, 2**31 + 13)
    assert not result["correct"], result["checks"]


def test_the_unchanged_state_fault_refuses_another_program(tmp_path):
    """It plants the dense decoder's step, so it is no fault of another
    program's: it raises rather than run the dense model in its place."""
    cell = spec.load_cell(TINY, tiny_root(tmp_path))
    other = spec.Cell(**{**cell.__dict__,
                         "config": dict(cell.config, program="other")})
    with pytest.raises(ValueError, match="other"):
        with calibrate.unchanged_state(other):
            pass
