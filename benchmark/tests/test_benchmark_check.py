"""The comparison holds each moving leaf's gradient against its own norm,
the harness refuses AdamW settings the port does not hold, and the
witness reads the embedding's gradient by its second path."""

import pytest
import torch

from benchmark import check, run, spec, witness
from benchmark.tests.tiny import TINY, tiny_root

CPU = torch.device("cpu")


def _readings(grads, changes):
    return {"losses": [2.0], "grad_norms": dict(grads),
            "change_norms": dict(changes)}


def test_a_small_leaf_is_held_against_its_own_norm():
    """A leaf a thirtieth of the median, read 10% low, reads 0.1; a leaf
    under a thousandth of the median is left out of both gaps."""
    ref = {"a": 1.0, "b": 0.9, "c": 1.1, "embed": 0.03, "bias": 1e-5}
    prog = dict(ref, embed=0.027, bias=2e-5)
    changes = {"a": 0.5, "b": 0.5, "c": 0.5, "embed": 0.0, "bias": 0.0}
    numbers = check.compare(_readings(prog, dict(changes, bias=1.0)),
                            _readings(ref, changes))
    assert numbers["grad_gap"] == pytest.approx(0.1)
    assert numbers["change_gap"] == 0.0


def test_change_gap_floors_a_leaf_that_does_not_move_at_the_median():
    ref = {"a": 1.0, "b": 1.0, "g": 1.0}
    changes = {"a": 0.4, "b": 0.5, "g": 0.0}
    prog_changes = dict(changes, g=0.05)
    numbers = check.compare(_readings(ref, prog_changes),
                            _readings(ref, changes))
    assert numbers["change_gap"] == pytest.approx(0.05 / 0.4)


def test_adamw_settings_the_port_does_not_hold_are_refused(tmp_path):
    root = tiny_root(tmp_path)
    cell = spec.load_cell(TINY, root)
    training = dict(cell.config["training"], betas=[0.9, 0.999])
    other = spec.Cell(**{**cell.__dict__,
                         "config": dict(cell.config, training=training)})
    with pytest.raises(ValueError, match="betas"):
        run.build_program(other, 5, CPU)
    state, _ = run.build_program(cell, 5, CPU)
    run.check_optimizer(cell.config["training"], state.optimizer)


def test_the_witness_reads_the_lookup_gradient_by_a_second_path(tmp_path):
    """At a tiny width with 153 repeats of the most frequent id: the
    port's lookup gradient summed in float32 agrees with the reference,
    and the norm gains move only with a float32 state."""
    root = tiny_root(tmp_path, seq=512)
    cell = witness.load_parts("tiny", "tiny", root)
    r = witness.witness(cell, 2**33 + 5, CPU)
    assert r["most_frequent_id_count"] > 100
    assert r["embed_gap"]["index_add_f32"] < 2e-3
    assert r["embed_grad_norm"]["program"] == pytest.approx(
        r["embed_grad_norm"]["index_put_bf16"], rel=1e-3)
    assert r["gains_change"]["program"]["max"] == 0.0
    assert r["gains_change"]["reference"]["max"] == 0.0
    assert r["gains_change"]["reference_f32_state"]["median"] > 0.0


def test_a_number_the_limits_leave_out_is_not_compared():
    numbers = {"loss_gap": 1.0, "grad_gap": 0.01, "change_gap": 0.001}
    ok, shown = check.verdict(numbers, {"grad_gap": 0.2, "change_gap": 2e-3})
    assert ok and set(shown) == {"grad_gap", "change_gap"}
    ok, _ = check.verdict(numbers, {"loss_gap": 1e-4, "grad_gap": 0.2})
    assert not ok
    with pytest.raises(ValueError):
        check.verdict(numbers, {"readings": {}})
