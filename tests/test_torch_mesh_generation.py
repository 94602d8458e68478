"""The worker's mesh-generation file, stamped by each package's own worker.

Counterparts of ``tests/test_elastic.py``'s worker cases (the stamp on
attach and detach, and no file by default), run through both packages'
``WorkerRig`` side by side (``BOTH`` of ``tests/torch_control_plane.py``):
the same add → add → remove drives each worker, and the two files agree
on their name, their keys, sorted chip lists of the same lengths, a
strictly increasing generation, no chip after the full detach and an
atomic replace (no temporary left). Each file is read by the port's
``FileSignal`` and by the JAX package's. The drain's flush hook is the
service's ``flush_mesh_generation`` on both, as each ``worker/main.py``
registers it.
"""

import inspect
import json
import os

import pytest

from gpumounter_tpu.jaxcheck import elastic as jelastic
from gpumounter_tpu_torch.torchcheck import elastic

from torch_control_plane import BOTH, IDS

FILE = "default--workload.json"


def _ride(pkg, rig, gen_dir):
    """add 2 → add 1 → remove all on ``rig``; the file after each step."""
    payloads = []
    steps = (lambda: pkg.add(rig.service, "workload", "default", 2, False,
                             request_id="rid-gen-1"),
             lambda: pkg.add(rig.service, "workload", "default", 1, False,
                             request_id="rid-gen-2"),
             lambda: pkg.remove(rig.service, "workload", "default", [],
                                False, request_id="rid-gen-3"))
    for step in steps:
        outcome = step()
        assert outcome.result.name == "SUCCESS", outcome
        with open(os.path.join(gen_dir, FILE)) as f:
            payloads.append(json.load(f))
        assert sorted(os.listdir(gen_dir)) == [FILE]
    return payloads


@pytest.fixture
def rides(tmp_path):
    """Each package's worker stamping its own directory through the same
    add → add → remove: {package: (gen_dir, payloads)}."""
    out = {}
    for pkg in BOTH:
        rig = pkg.rig(tmp_path / pkg.name / "host", n_chips=4)
        try:
            gen_dir = str(tmp_path / pkg.name / "mesh-gen")
            rig.sim.settings.mesh_gen_dir = gen_dir
            out[pkg.name] = (gen_dir, _ride(pkg, rig, gen_dir))
        finally:
            rig.close()
    return out


def test_both_workers_stamp_the_same_file(rides):
    shapes = {}
    for name, (gen_dir, payloads) in rides.items():
        path = os.path.join(gen_dir, FILE)
        # name, keys, sorted chip lists
        assert os.path.exists(path)
        assert [sorted(p) for p in payloads] == [["chips", "generation"]] * 3
        assert all(p["chips"] == sorted(p["chips"]) for p in payloads)
        assert all(len(set(p["chips"])) == len(p["chips"])
                   for p in payloads)
        # the second attach keeps the first one's chips
        assert set(payloads[0]["chips"]) < set(payloads[1]["chips"])
        generations = [p["generation"] for p in payloads]
        assert generations == sorted(set(generations)), generations
        assert all(isinstance(g, float) and g > 0 for g in generations)
        shapes[name] = [len(p["chips"]) for p in payloads]
        # both packages' readers see the last stamp: no chip left
        for reader in (elastic, jelastic):
            signal = reader.FileSignal(path)
            assert signal.chips() == 0
            assert signal.generation() == generations[-1]
            assert reader.read_generation_file(path) == payloads[-1]
    assert shapes == {"jax": [2, 3, 0], "torch": [2, 3, 0]}


@pytest.mark.parametrize("pkg", BOTH, ids=IDS)
def test_the_stamp_is_an_atomic_replace(pkg, tmp_path, monkeypatch):
    """The file appears only by a rename of a fsynced temporary in the
    same directory, and the directory is fsynced after it."""
    rig = pkg.rig(tmp_path / "host", n_chips=4)
    gen_dir = str(tmp_path / "mesh-gen")
    rig.sim.settings.mesh_gen_dir = gen_dir
    calls = []
    real_replace, real_fsync = os.replace, os.fsync

    def replace(src, dst):
        calls.append(("replace", os.path.dirname(src),
                      os.path.basename(src), dst))
        return real_replace(src, dst)

    def fsync(fd):
        calls.append(("fsync", os.readlink(f"/proc/self/fd/{fd}")))
        return real_fsync(fd)

    monkeypatch.setattr(os, "replace", replace)
    monkeypatch.setattr(os, "fsync", fsync)
    try:
        outcome = pkg.add(rig.service, "workload", "default", 1, False)
        assert outcome.result.name == "SUCCESS"
    finally:
        monkeypatch.undo()
        rig.close()
    path = os.path.join(gen_dir, FILE)
    stamps = [c for c in calls if c[0] == "replace" and c[3] == path]
    assert len(stamps) == 1
    _, directory, tmp_name, _ = stamps[0]
    assert directory == gen_dir and tmp_name.endswith(".gen")
    order = calls.index(stamps[0])
    assert ("fsync", os.path.join(gen_dir, tmp_name)) in calls[:order]
    assert ("fsync", gen_dir) in calls[order:]
    assert os.listdir(gen_dir) == [FILE]


@pytest.mark.parametrize("pkg", BOTH, ids=IDS)
def test_generation_file_disabled_by_default(pkg, tmp_path):
    rig = pkg.rig(tmp_path / "host", n_chips=4)
    try:
        assert rig.sim.settings.mesh_gen_dir == ""
        outcome = pkg.add(rig.service, "workload", "default", 4, True)
        assert outcome.result.name == "SUCCESS"
        outcome = pkg.remove(rig.service, "workload", "default", [], False)
        assert outcome.result.name == "SUCCESS"
    finally:
        rig.close()
    written = [os.path.join(d, f) for d, _, files in os.walk(tmp_path)
               for f in files if f.endswith((FILE, ".gen"))]
    assert written == []


@pytest.mark.parametrize("pkg", BOTH, ids=IDS)
def test_the_drain_flushes_the_generation_directory(pkg, tmp_path,
                                                     monkeypatch):
    """The rig's drain (``MultiNodeStack._attach_drain``, the wiring of
    ``worker/main.py``) runs the service's ``flush_mesh_generation``,
    which fsyncs the directory."""
    source = inspect.getsource(pkg.mod("worker.main"))
    assert "drainer.register_flush(service.flush_mesh_generation)" in source
    rig = pkg.rig(tmp_path / "host", n_chips=4)
    gen_dir = str(tmp_path / "mesh-gen")
    rig.sim.settings.mesh_gen_dir = gen_dir
    try:
        pkg.mod("testing.sim").MultiNodeStack._attach_drain(rig)
        assert rig.drain._flush_hooks == [rig.service.flush_mesh_generation]
        outcome = pkg.add(rig.service, "workload", "default", 1, False)
        assert outcome.result.name == "SUCCESS"
        synced = []
        real_fsync = os.fsync

        def fsync(fd):
            synced.append(os.readlink(f"/proc/self/fd/{fd}"))
            return real_fsync(fd)

        monkeypatch.setattr(os, "fsync", fsync)
        assert rig.drain.run(journal=None, timeout_s=5.0) is True
        monkeypatch.undo()
        assert synced.count(gen_dir) == 1
    finally:
        rig.close()
