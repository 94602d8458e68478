"""The attachment-record cache of the worker service, through both packages
(the counterpart of tests/test_attach_cache.py): a detach of a pod this
worker just attached resolves from the attach-time record with no kubelet
round trip, checked against the informer's slave-pod view, and every
sign of staleness falls back to the full resolution. The zero-round-trip
detach and the slave-set drift are held by tests/test_torch_worker.py
(``test_detach_resolves_from_the_attach_record``,
``test_slave_set_drift_falls_back_to_full_resolution``); the transcript
below runs them again beside the other signals."""

import dataclasses

import pytest

from tests.torch_control_plane import BOTH, IDS, JAX, TORCH, norm_result


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


@pytest.fixture
def rig(pkg, tmp_path):
    r = pkg.rig(tmp_path, n_chips=4, informer=True)
    yield r
    r.close()


KEY = ("default", "workload")


def _attach(pkg, rig, n=4, entire=True, rid="cache-test"):
    outcome = pkg.add(rig.service, "workload", "default", n, entire,
                      request_id=rid)
    assert norm_result(outcome.result) == "SUCCESS"
    return outcome


def _detach(pkg, rig, uuids=()):
    """A detach's result role and how many kubelet LISTs it paid."""
    before = rig.sim.podresources.list_calls
    out = pkg.remove(rig.service, "workload", "default", list(uuids), False)
    return norm_result(out.result), rig.sim.podresources.list_calls - before


def test_detach_subset_by_uuid_served_from_record(pkg, rig):
    chips = _attach(pkg, rig, n=2, entire=False).chips
    assert _detach(pkg, rig, [chips[0].uuid]) == ("SUCCESS", 0)


def test_record_invalidated_after_detach(pkg, rig):
    """A detach consumes the record: it described the state before."""
    _attach(pkg, rig, n=2, entire=False)
    assert _detach(pkg, rig)[0] == "SUCCESS"
    assert KEY not in rig.service._attach_records


def _tamper(rig, **changes):
    record = rig.service._attach_records[KEY]
    rig.service._attach_records[KEY] = dataclasses.replace(record, **changes)


def test_recreated_pod_uid_mismatch_falls_back(pkg, rig):
    _attach(pkg, rig)
    _tamper(rig, uid="uid-of-a-previous-life")
    result, lists = _detach(pkg, rig)
    assert result == "SUCCESS" and lists > 0


def test_aged_record_falls_back(pkg, rig):
    _attach(pkg, rig)
    record = rig.service._attach_records[KEY]
    _tamper(rig, recorded_at=record.recorded_at
            - rig.sim.settings.attach_cache_ttl_s - 1)
    result, lists = _detach(pkg, rig)
    assert result == "SUCCESS" and lists > 0


def test_unknown_uuid_still_raises_precise_error(pkg, rig):
    _attach(pkg, rig)
    assert _detach(pkg, rig, ["no-such-chip"])[0] == "NOT_FOUND"


def test_informerless_rig_never_uses_the_record(pkg, tmp_path):
    rig = pkg.rig(tmp_path, n_chips=4)
    try:
        _attach(pkg, rig)
        result, lists = _detach(pkg, rig)
        assert result == "SUCCESS" and lists > 0
    finally:
        rig.close()


def _transcript(pkg, tmp_path) -> list:
    """Every staleness signal in turn, with the LISTs each detach paid."""
    rig = pkg.rig(tmp_path, n_chips=4, informer=True)
    try:
        out = []
        chips = _attach(pkg, rig, n=2, entire=False, rid="t1").chips
        out.append(_detach(pkg, rig, [chips[0].uuid]))
        out.append(KEY in rig.service._attach_records)
        out.append(_detach(pkg, rig))
        _attach(pkg, rig, rid="t2")
        _tamper(rig, uid="other")
        out.append(_detach(pkg, rig))
        _attach(pkg, rig, rid="t3")
        _tamper(rig, recorded_at=0.0)
        out.append(_detach(pkg, rig))
        _attach(pkg, rig, rid="t4")
        out.append(_detach(pkg, rig, ["no-such-chip"]))
        return out
    finally:
        rig.close()


def test_attach_cache_transcripts_agree(tmp_path):
    assert _transcript(TORCH, tmp_path / "torch") == \
        _transcript(JAX, tmp_path / "jax")
