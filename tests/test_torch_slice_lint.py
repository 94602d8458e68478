"""AST lints of the port's slice subsystem — the control plane's rules of
tests/test_admission_lint.py (a slice attach and the resize's grow half go
through admission before any fan-out), tests/test_federation_lint.py
(barrier state changes only across ``_barrier_transition``, which pairs
the metric with the event) and tests/test_events_lint.py (every slice-txn
terminal emits a lifecycle event), held against the port's
``master/gateway.py``, ``admission.py`` and ``slicetxn.py``. Imports no
jax."""

import ast
import inspect

from gpumounter_tpu_torch.master import admission, gateway, slicetxn


def _functions(module) -> dict[str, ast.AST]:
    """{qualified name: funcdef} for every function/method in the module."""
    tree = ast.parse(inspect.getsource(module))
    out = {}

    def walk(node, prefix=""):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out[prefix + child.name] = child
                walk(child, prefix + child.name + ".")
            elif isinstance(child, ast.ClassDef):
                walk(child, prefix + child.name + ".")
            else:
                walk(child, prefix)
    walk(tree)
    return out


def _names_used(funcdef) -> set[str]:
    names = set()
    for node in ast.walk(funcdef):
        if isinstance(node, ast.Attribute):
            names.add(node.attr)
        elif isinstance(node, ast.Name):
            names.add(node.id)
    return names


def _referencing_functions(module, name: str) -> set[str]:
    """Qualified names of the innermost functions that mention ``name``."""
    hits = set()
    for qual, fn in _functions(module).items():
        inner = {n for n in ast.walk(fn)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                 and n is not fn}
        nested = set()
        for sub in inner:
            nested |= set(map(id, ast.walk(sub)))
        for node in ast.walk(fn):
            if id(node) in nested:
                continue
            if (isinstance(node, ast.Attribute) and node.attr == name) or \
                    (isinstance(node, ast.Name) and node.id == name):
                hits.add(qual)
    return hits


def _call_names(node) -> list[str]:
    names = []
    for call in ast.walk(node):
        if not isinstance(call, ast.Call):
            continue
        parts = []
        f = call.func
        while isinstance(f, ast.Attribute):
            parts.append(f.attr)
            f = f.value
        if isinstance(f, ast.Name):
            parts.append(f.id)
        names.append(".".join(reversed(parts)))
    return names


# -- admission (tests/test_admission_lint.py) ---------------------------------

def test_slice_handlers_only_dispatched_from_route():
    for handler in ("_slice_attach", "_slice_resize", "_slice_detach",
                    "_slice_barrier_join"):
        assert _referencing_functions(gateway, handler) == \
            {"MasterGateway._route"}, handler


def test_slice_attach_admits_before_fanout():
    """Both slice-mutation handlers route through the txn manager, whose
    transaction entry runs under the broker's reservation-scoped
    admission context; the resize's grow half is such a transaction; the
    raw coordinator is reachable only from the detach handler and the
    manager."""
    funcs = _functions(gateway)
    for handler in ("MasterGateway._slice_attach",
                    "MasterGateway._slice_resize"):
        assert "slices" in _names_used(funcs[handler]), \
            f"{handler} bypasses the slice txn manager"
    txn_funcs = _functions(slicetxn)
    assert "admission" in _names_used(txn_funcs["SliceTxnManager.attach"])
    assert "attach" in _names_used(txn_funcs["SliceTxnManager.resize"])
    assert _referencing_functions(gateway, "_slice_coordinator") == \
        {"MasterGateway._slice_detach"}
    assert _referencing_functions(slicetxn, "SliceCoordinator") == \
        {"SliceTxnManager._coordinator"}
    # the fan-out inside attach comes after the admission context opens
    attach = txn_funcs["SliceTxnManager.attach"]
    withs = [n for n in ast.walk(attach) if isinstance(n, ast.With)]
    assert withs and "admission" in _call_names(withs[0].items[0])[0]
    assert "self._run" in _call_names(withs[0])


def test_broker_slice_paths_detach_through_the_manager():
    """Group expiry and group preemption detach the whole slice through
    the manager's ``detach_members`` — never member by member through the
    single-lease path."""
    funcs = _functions(admission)
    for name in ("AttachBroker._reap_group", "AttachBroker._preempt_group"):
        assert "self._slice.detach_members" in _call_names(funcs[name])
    assert "self._reap_group" in _call_names(funcs["AttachBroker._reap"])
    assert "self._preempt_group" in \
        _call_names(funcs["AttachBroker._try_preempt"])


# -- the barrier seam (tests/test_federation_lint.py) --------------------------

def test_barrier_metric_and_event_only_inside_the_seam():
    offenders = []
    for name, fn in _functions(slicetxn).items():
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            dotted = _call_names(node)[:1]
            if dotted == ["REGISTRY.slice_barriers.inc"] \
                    and not name.endswith("._barrier_transition"):
                offenders.append((name, "metric"))
            if dotted == ["EVENTS.emit"] and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    node.args[0].value == "slice_barrier" and \
                    not name.endswith("._barrier_transition"):
                offenders.append((name, "event"))
    assert not offenders, offenders


def test_barrier_seam_pairs_metric_with_event():
    seam = _functions(slicetxn)["SliceTxnManager._barrier_transition"]
    calls = _call_names(seam)
    assert "REGISTRY.slice_barriers.inc" in calls
    assert "EVENTS.emit" in calls


def test_every_barrier_map_mutation_crosses_the_seam():
    offenders = []
    for name, fn in _functions(slicetxn).items():
        mutates = False
        for node in ast.walk(fn):
            if isinstance(node, (ast.Assign, ast.Delete)):
                for target in node.targets:
                    if isinstance(target, ast.Subscript) and \
                            isinstance(target.value, ast.Attribute) and \
                            target.value.attr == "_barriers":
                        mutates = True
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in ("pop", "clear", "setdefault",
                                       "update") and \
                    isinstance(node.func.value, ast.Attribute) and \
                    node.func.value.attr == "_barriers":
                mutates = True
        if mutates and "self._barrier_transition" not in _call_names(fn):
            offenders.append(name)
    assert not offenders, offenders


def test_barrier_route_stays_out_of_the_trace_ring():
    source = inspect.getsource(gateway)
    assert '"/slice/barrier": "slicebarrier"' in source
    assert "slicebarrier" in gateway._UNTRACED_ROUTES
    assert "slicez" in gateway._UNTRACED_ROUTES


# -- lifecycle events (tests/test_events_lint.py) ------------------------------

def _emits_event(fn) -> bool:
    return any(c == "EVENTS.emit" for c in _call_names(fn))


def test_slice_txn_terminals_emit_events():
    funcs = _functions(slicetxn)
    for name in ("SliceTxnManager._commit", "SliceTxnManager._abort",
                 "SliceTxnManager._hand_back", "SliceTxnManager.resize"):
        assert name in funcs, f"{name} vanished — update this lint"
        assert _emits_event(funcs[name]), name


def test_slice_txn_counter_paired_with_events():
    """Every ``slice_txns`` increment sits in a function that emits."""
    for name, fn in _functions(slicetxn).items():
        if "REGISTRY.slice_txns.inc" in _call_names(fn):
            assert _emits_event(fn), name


def test_broker_group_reclaims_emit_events():
    funcs = _functions(admission)
    for name in ("AttachBroker._reap_group", "AttachBroker._preempt_group",
                 "AttachBroker.park_gang"):
        assert _emits_event(funcs[name]), name
