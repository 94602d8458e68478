"""The command itself: on the card, one short run of a cell ends with a
correct result line; without one, or without the program beside it, it
exits non-zero and prints no result."""

import json
import shutil
import subprocess
import sys

import pytest

from benchmark import spec

CELL = "pythia-6.9b.pretrain-t2048"


def _command(cwd, *extra, timeout=900):
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", CELL,
         "--seed", "2147483659", "--seconds", "2", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=timeout)


@pytest.mark.gpu
def test_a_cell_runs_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    proc = _command(spec.ROOT, "--trace", "0")
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["count"] == 1
    assert result["device"]["kind"] == torch.cuda.get_device_name(0)
    assert set(result["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert list(result)[-1] == "checks"
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")


def test_without_a_card_it_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = _command(spec.ROOT, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "needs 1 CUDA device" in proc.stderr


def test_beside_nothing_but_its_own_files_it_prints_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.ROOT / spec.PACKAGE, tmp_path / spec.PACKAGE,
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _command(tmp_path, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
