"""The port's copy of tests/test_admission_lint.py, held against
``gpumounter_tpu_torch`` with the port's names (``GPUMountService``,
``GPUAllocator``, ``GPUMounter``, ``add_gpu``). Imports no jax.

Admission-layer lint (pattern of test_retry_lint / test_informer_lint):
every mutating gateway route must pass through the attach broker's
admission layer — structurally, no route may reach ``_add`` /
``_slice_attach`` without an ``admit()`` call in its path, and no gateway
method may fire an attach RPC outside the broker's orchestration. A new
mutating route added without admission wiring fails here instead of
shipping a quota bypass."""

from gpumounter_tpu_torch.master import admission, gateway, slicetxn

from tests.test_torch_retry_lint import (_functions, _names_used,
                                   _referencing_functions)


def test_attach_handlers_only_dispatched_from_route():
    """The only caller of the attach handlers is the method-checked
    dispatcher — there is no side door around tenant/priority parsing."""
    assert _referencing_functions(gateway, "_add") == \
        {"MasterGateway._route"}
    assert _referencing_functions(gateway, "_slice_attach") == \
        {"MasterGateway._route"}
    assert _referencing_functions(gateway, "_slice_resize") == \
        {"MasterGateway._route"}


def test_add_routes_through_the_broker():
    """_add never dials the worker directly: the RPC lives in a closure
    the broker invokes (admission, queueing, preemption wrap it)."""
    funcs = _functions(gateway)
    names = _names_used(funcs["MasterGateway._add"])
    assert "broker" in names, "_add bypasses the attach broker"
    assert "attach" in names, "_add does not use broker.attach"


def test_slice_attach_admits_before_fanout():
    """Slice admission moved into the txn manager (master/slicetxn.py)
    with the crash-safe protocol: both gateway slice-mutation handlers
    route through it, and the manager's transaction entry runs under the
    broker's reservation-scoped admission context — the whole gang wait
    stays inside the reservation, so a parked slice's chips count as
    in-flight usage against its tenant's cap."""
    funcs = _functions(gateway)
    for handler in ("MasterGateway._slice_attach",
                    "MasterGateway._slice_resize"):
        names = _names_used(funcs[handler])
        assert "slices" in names, \
            f"{handler} bypasses the slice txn manager"
    txn_funcs = _functions(slicetxn)
    attach_names = _names_used(txn_funcs["SliceTxnManager.attach"])
    assert "admission" in attach_names, \
        "SliceTxnManager.attach skips reservation-scoped quota admission"
    resize_names = _names_used(txn_funcs["SliceTxnManager.resize"])
    assert "attach" in resize_names, \
        "resize's grow half must run as an admitted slice txn"
    # the raw coordinator (which holds the per-host add_gpu calls) is
    # only reachable from the admitted detach handler and the manager
    assert _referencing_functions(gateway, "_slice_coordinator") == \
        {"MasterGateway._slice_detach"}
    assert _referencing_functions(slicetxn, "SliceCoordinator") == \
        {"SliceTxnManager._coordinator"}


def test_broker_attach_cannot_skip_admission():
    """The broker's own orchestration entry runs under the
    reservation-scoped admission() context, which calls admit() — the
    one admission authority (decision counter + typed denial), not a
    re-implementable check."""
    funcs = _functions(admission)
    assert "admission" in _names_used(funcs["AttachBroker.attach"])
    assert "admit" in _names_used(funcs["AttachBroker.admission"])
    assert "_inflight" in _names_used(funcs["AttachBroker.admission"])
    admit_names = _names_used(funcs["AttachBroker.admit"])
    assert "admission_decisions" in admit_names
    assert "QuotaExceededError" in admit_names
    # usage comes from the lease table (live state), never a local tally
    assert "leases" in admit_names


def test_every_gateway_attach_rpc_site_is_broker_gated():
    """Any MasterGateway method that references the attach RPC
    (add_gpu) must also reference the broker — a future route that
    hand-rolls a worker attach without admission fails here."""
    for qual, funcdef in _functions(gateway).items():
        parts = qual.split(".")
        if len(parts) != 2 or parts[0] != "MasterGateway":
            continue        # nested defs are counted inside their method
        names = _names_used(funcdef)
        if "add_gpu" in names:
            assert "broker" in names, \
                f"{qual} fires an attach RPC outside the admission layer"
