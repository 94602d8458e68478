"""The control plane's intent-store lint (tests/test_store_lint.py), its
ten AST checks held against the port's ``gpumounter_tpu_torch/master/``
modules: broker state is cluster ground truth ONLY if every mutation
writes through the store layer (master/store.py). Structurally: every
LeaseTable method that mutates the lease dict must reference a store
seam, every waiter park/resolve site must persist/unpersist its intent
record, and no module outside the store/election pair may touch the
ConfigMap CAS primitives. A new mutation path added without store wiring
fails here instead of shipping state a failed-over peer cannot see.
"""

import ast

from gpumounter_tpu_torch.master import (admission, election, fleet,
                                         gateway, lease, slicetxn, store)

from tests.test_torch_slice_lint import (_functions, _names_used,
                                         _referencing_functions)

# LeaseTable methods that mutate self._leases WITHOUT a store write, by
# design — each exemption is the point of the method, not an oversight:
#   evict_where   — shard hand-off: the records now belong to the new
#                   leader; deleting them would destroy the state it is
#                   about to rehydrate
#   merge_records — rehydration INTO memory FROM the store; writing back
#                   would be a no-op echo
SANCTIONED_MEMORY_ONLY = {"LeaseTable.evict_where",
                          "LeaseTable.merge_records"}

STORE_SEAMS = {"_store_put", "_store_del", "_store_sync"}


def _mutates_leases(funcdef) -> bool:
    """True when the function writes the lease dict: subscript
    assignment/deletion, .pop()/.clear()/.update(), or rebinding
    self._leases wholesale."""
    for node in ast.walk(funcdef):
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for target in targets:
                if isinstance(target, ast.Subscript) and \
                        isinstance(target.value, ast.Attribute) and \
                        target.value.attr == "_leases":
                    return True
                if isinstance(target, ast.Attribute) and \
                        target.attr == "_leases":
                    return True
        elif isinstance(node, ast.Delete):
            for target in node.targets:
                if isinstance(target, ast.Subscript) and \
                        isinstance(target.value, ast.Attribute) and \
                        target.value.attr == "_leases":
                    return True
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in ("pop", "clear", "update", "setdefault"):
            inner = node.func.value
            if isinstance(inner, ast.Attribute) and \
                    inner.attr == "_leases":
                return True
    return False


def test_every_lease_mutation_writes_through_the_store():
    """No LeaseTable mutation site escapes the store layer: any method
    that touches the lease dict either references a store seam or is on
    the sanctioned memory-only list (with its reason documented above)."""
    for qual, funcdef in _functions(lease).items():
        if not qual.startswith("LeaseTable.") or "." in \
                qual[len("LeaseTable."):]:
            continue
        if not _mutates_leases(funcdef):
            continue
        if qual in SANCTIONED_MEMORY_ONLY:
            continue
        names = _names_used(funcdef)
        assert names & STORE_SEAMS, \
            f"{qual} mutates the lease table without a store write — " \
            "a failed-over peer would rehydrate stale state"


def test_sanctioned_exemptions_still_exist():
    """The exemption list must not rot: every sanctioned name is a real
    mutating method (a rename would silently re-arm the lint on the old
    name and skip the new one)."""
    funcs = _functions(lease)
    for qual in SANCTIONED_MEMORY_ONLY:
        assert qual in funcs, f"{qual} no longer exists"
        assert _mutates_leases(funcs[qual]), f"{qual} no longer mutates"
        # and they must NOT write the store — if one starts writing,
        # remove it from the list so the lint covers it
        assert not (_names_used(funcs[qual]) & STORE_SEAMS), qual


def test_store_seams_are_the_only_record_writers_in_lease():
    """LeaseRecord construction (the serialize half of the round-trip)
    is confined to the store seams — no method hand-rolls a record."""
    hits = _referencing_functions(lease, "LeaseRecord")
    assert hits <= {"LeaseTable._store_put", "LeaseTable._store_sync",
                    "LeaseTable.flush_renewals"}, hits


def test_waiter_park_and_resolve_sites_persist_intent():
    """The queue path persists on park and unpersists on EVERY exit
    (grant, timeout, error, hand-off — the finally block), and the
    adoption drain resolves its record no matter how the re-run ends."""
    funcs = _functions(admission)
    queued = _names_used(funcs["AttachBroker._attach_queued"])
    assert "_persist_waiter" in queued, \
        "_attach_queued parks a waiter without persisting its intent"
    assert "_unpersist_waiter" in queued, \
        "_attach_queued resolves a waiter without removing its record"
    adopted = _names_used(funcs["AttachBroker._run_adopted"])
    assert "_unpersist_rid" in adopted, \
        "_run_adopted can leave a resolved intent record behind"
    # parking happens in exactly two places: the single-attach queue
    # path (persisted as a waiter record above) and the gang path, whose
    # durable intent is the slice TXN record — pinned below
    # (``_waiters.add`` is the one enqueue verb of the WaiterQueue).
    appenders = {
        qual.split(".", 1)[0] + "." + qual.split(".")[1]
        for qual, funcdef in funcs.items()
        if qual.startswith("AttachBroker.")
        and any(isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr == "add"
                and isinstance(n.func.value, ast.Attribute)
                and n.func.value.attr == "_waiters"
                for n in ast.walk(funcdef))}
    assert appenders == {"AttachBroker._attach_queued",
                         "AttachBroker.park_gang"}, appenders


def test_slice_txn_intent_is_persisted_around_the_fanout():
    """The crash-safe slice protocol: attach() writes the intent record
    BEFORE the fan-out (and the per-host marker callback persists as
    hosts land), every terminal path resolves it (commit deletes, a
    clean abort deletes, an unclean abort re-persists for re-adoption),
    and the gang's park site is attach's own loop — no slice waits
    without a durable record."""
    funcs = _functions(slicetxn)
    attach = _names_used(funcs["SliceTxnManager.attach"])
    assert "_persist_txn" in attach, \
        "SliceTxnManager.attach fans out without writing its intent"
    commit = _names_used(funcs["SliceTxnManager._commit"])
    assert "_unpersist_txn" in commit
    abort = _names_used(funcs["SliceTxnManager._abort"])
    assert {"_unpersist_txn", "_persist_txn"} <= abort
    marker = _names_used(funcs["SliceTxnManager._marker_callback"])
    assert "_persist_txn" in marker, \
        "per-host commit markers are not persisted as hosts land"
    run = _names_used(funcs["SliceTxnManager._run"])
    assert "park_gang" in run and "unpark_gang" in run, \
        "the gang park/unpark pair moved out of the txn-scoped loop"


def test_configmap_cas_is_confined_to_store_and_election():
    """Only the store (state records) and the election (lock records)
    may write ConfigMaps; a broker/gateway/fleet mutation that bypasses
    them would dodge both the fence check and the CAS discipline."""
    for module in (admission, lease, gateway, fleet, slicetxn):
        for qual, funcdef in _functions(module).items():
            names = _names_used(funcdef)
            bad = names & {"patch_config_map", "create_config_map",
                           "delete_config_map"}
            assert not bad, \
                f"{module.__name__}.{qual} writes ConfigMaps directly " \
                f"({bad}) — all broker state goes through the store"


def test_store_cas_is_one_seam_with_the_fence_check_inside():
    """Every store write funnels through _cas, where the fence token
    check and the annotation patch are ONE atomic step — the split-brain
    impossibility argument (docs/guide/HA.md) depends on no second
    write path existing."""
    assert _referencing_functions(store, "patch_config_map") == \
        {"IntentStore._cas"}
    assert _referencing_functions(store, "create_config_map") == \
        {"IntentStore._cas"}
    cas = _functions(store)["IntentStore._cas"]
    names = _names_used(cas)
    assert "StoreFencedError" in names, \
        "_cas no longer enforces the fencing token"
    # and the public write path reaches it
    assert "_cas" in _names_used(_functions(store)["IntentStore._write"])


def test_record_mutations_route_through_the_coalescer_seam():
    """The group-commit contract: NO request-thread code
    path issues a per-record CAS. Every record mutation crosses
    ``IntentStore._mutate`` (the coalescer seam); ``_write`` — the
    per-record CAS — is reachable only from that seam (the sanctioned
    TPU_STORE_GROUP_COMMIT=0 off-path) and the dirty replay; and
    ``_cas`` itself has exactly four sanctioned-with-reason callers:
      _write        — the per-record off-path + dirty replay
      put_leases    — already one CAS per shard by construction
      poke_peers    — the fence-exempt capacity stamp (no record state)
      flush_pending — the group-commit flush (ONE fused CAS per shard)
    A new direct caller is a new serialization point on the per-shard
    CAS stream and fails here instead of shipping."""
    funcs = _functions(store)
    for qual in ("IntentStore.put_lease", "IntentStore.delete_lease",
                 "IntentStore.put_waiter", "IntentStore.delete_waiter",
                 "IntentStore.put_slice_txn",
                 "IntentStore.delete_slice_txn"):
        names = _names_used(funcs[qual])
        assert "_mutate" in names, \
            f"{qual} mutates a record without the coalescer seam"
        assert not ({"_cas", "_write"} & names), \
            f"{qual} bypasses the coalescer seam with a direct CAS"
    # _put_leases_locked's _write is its DEGRADATION path only: a
    # failed batch falls back to per-record writes so each record gets
    # its own dirty-parking — not a hot-path caller. (put_leases runs
    # its CAS under _flush_mutex so an in-flight coalescer flush can
    # never land a stale batch over the fresh sync.)
    assert _referencing_functions(store, "_write") == \
        {"IntentStore._mutate", "IntentStore.flush_dirty",
         "IntentStore._put_leases_locked"}
    assert _referencing_functions(store, "_cas") == {
        "IntentStore._write", "IntentStore._put_leases_locked",
        "IntentStore.poke_peers", "IntentStore.flush_pending"}
    assert "_flush_mutex" in _names_used(
        _functions(store)["IntentStore.put_leases"]), \
        "put_leases lost its serialization against the coalescer flush"


def test_group_commit_flush_keeps_the_durability_rules():
    """The fused flush must keep the per-record disciplines: park on
    no-live-token AND on apiserver failure (the dirty queue), surface a
    real fence through on_fenced (demotion) — and the broker tick
    drives flush_pending as the backstop before the dirty replay."""
    flush = _functions(store)["IntentStore.flush_pending"]
    names = _names_used(flush)
    assert "_park" in names, \
        "a refused fused batch must park dirty, not vanish"
    assert "on_fenced" in names and "StoreFencedError" in names, \
        "flush_pending no longer surfaces fences for demotion"
    tick = _functions(admission)["AttachBroker.tick"]
    assert "flush_pending" in _names_used(tick), \
        "the broker tick lost the group-commit flush backstop"


def test_election_lock_writes_carry_the_full_annotation_set():
    """Lock mutations (create/renew/takeover) all build their
    annotations through _lock_annotations — holder, url, fence and
    deadline move together, so an observer can never read a lock with a
    new fence but a stale holder."""
    hits = _referencing_functions(election, "_lock_annotations")
    assert hits == {"ShardElection._try_create", "ShardElection._renew",
                    "ShardElection._takeover"}, hits
