"""The port's copy of tests/test_events_lint.py, held against
``gpumounter_tpu_torch`` with the port's names (``GPUMountService``,
``GPUAllocator``, ``GPUMounter``, ``add_gpu``). Imports no jax.

AST lint: no silent lifecycle transitions.

The telemetry plane's value is completeness — an operator reading
``/eventz`` must be able to trust that every journal record and every
broker admission outcome produced an event. These lints walk the source
so a future journal record kind or admission outcome can't ship without
its paired emission:

1. every :class:`AttachJournal` method that appends a journal record
   (``begin`` / ``_mark`` / ``record_detach``) calls ``EVENTS.emit``;
2. every ``REGISTRY.admission_decisions.inc(...)`` call-site in
   ``master/admission.py`` lives in a function that also emits an event
   (the decision stream and the counter must agree on volume);
3. the preemption and lease-expiry reclaim paths emit too.
"""

import ast
import os

import gpumounter_tpu_torch

_PKG = os.path.dirname(gpumounter_tpu_torch.__file__)


def _parse(rel_path):
    path = os.path.join(_PKG, rel_path)
    with open(path) as f:
        return ast.parse(f.read(), filename=path)


def _functions(tree):
    """Every function/method in the module, by name (qualified with the
    class name for methods)."""
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    out[f"{node.name}.{item.name}"] = item
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(node.name, node)
    return out


def _calls_attr(func_node, attr, base=None):
    """Does the function body contain a call to ``<base>.<attr>(...)``
    (any base when ``base`` is None)?"""
    for node in ast.walk(func_node):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if not (isinstance(fn, ast.Attribute) and fn.attr == attr):
            continue
        if base is None:
            return True
        value = fn.value
        if isinstance(value, ast.Name) and value.id == base:
            return True
        if isinstance(value, ast.Attribute) and value.attr == base:
            return True
    return False


def _emits_event(func_node):
    return _calls_attr(func_node, "emit", base="EVENTS")


def test_every_journal_record_writer_emits_an_event():
    funcs = _functions(_parse("worker/journal.py"))
    writers = ["AttachJournal.begin", "AttachJournal._mark",
               "AttachJournal.record_detach", "AttachJournal.record_gate",
               "AttachJournal.record_baseline",
               "AttachJournal.drop_baseline"]
    for name in writers:
        assert name in funcs, f"{name} vanished — update this lint"
        assert _emits_event(funcs[name]), \
            f"{name} appends a journal record without emitting a " \
            "lifecycle event (silent transition)"
    # completeness: any OTHER method that calls _append must be one of
    # the known writers (or the writers' shared helper set) — a new
    # record kind can't bypass the emission requirement
    for name, node in funcs.items():
        if not name.startswith("AttachJournal."):
            continue
        if _calls_attr(node, "_append"):
            assert name in writers + ["AttachJournal._load"], \
                f"{name} writes journal records but is not covered by " \
                "the event-emission lint — pair it with EVENTS.emit " \
                "and add it here"


def test_every_admission_outcome_emits_an_event():
    # master/slicetxn.py records gang decisions (queue_timeout /
    # granted_queued) and master/gateway.py the node-cordon denial into
    # the same counter — same pairing contract
    offenders = []
    for module in ("master/admission.py", "master/slicetxn.py",
                   "master/gateway.py"):
        funcs = _functions(_parse(module))
        for name, node in funcs.items():
            has_decision = False
            for call in ast.walk(node):
                if (isinstance(call, ast.Call)
                        and isinstance(call.func, ast.Attribute)
                        and call.func.attr == "inc"
                        and isinstance(call.func.value, ast.Attribute)
                        and call.func.value.attr
                        == "admission_decisions"):
                    has_decision = True
            if has_decision and not _emits_event(node):
                offenders.append(f"{module}:{name}")
    assert not offenders, \
        f"admission outcomes recorded without a paired lifecycle " \
        f"event in: {offenders}"


def test_slice_txn_terminals_emit_events():
    """Every slice transaction terminal (commit / abort / adoption /
    hand-back / resize) is a lifecycle-visible transition: the
    slice_txns_total counter and the event stream must agree on
    volume."""
    funcs = _functions(_parse("master/slicetxn.py"))
    for name in ("SliceTxnManager._commit", "SliceTxnManager._abort",
                 "SliceTxnManager._hand_back",
                 "SliceTxnManager._run_adopted",
                 "SliceTxnManager.resize"):
        assert name in funcs, f"{name} vanished — update this lint"
        assert _emits_event(funcs[name]), \
            f"{name} resolves slice-txn state without emitting a " \
            "lifecycle event"


def test_reclaim_paths_emit_events():
    funcs = _functions(_parse("master/admission.py"))
    for name in ("AttachBroker._try_preempt", "AttachBroker._reap"):
        assert name in funcs, f"{name} vanished — update this lint"
        assert _emits_event(funcs[name]), \
            f"{name} reclaims chips without emitting a lifecycle event"


def test_attach_and_detach_completions_emit_events():
    # the emitting bodies live one hop under the public RPCs since the
    # drain gate wrapped them (worker/drain.py — the refusal must not
    # record an attach event it never worked on)
    funcs = _functions(_parse("worker/service.py"))
    for name in ("GPUMountService._add_gpu_traced",
                 "GPUMountService._remove_gpu_traced"):
        assert name in funcs, f"{name} vanished — update this lint"
        assert _emits_event(funcs[name]), \
            f"{name} completes without emitting a lifecycle event"
