"""AST lints for the port's defragmenter: the checks of
tests/test_defrag_lint.py against ``gpumounter_tpu_torch/`` module paths
(the port keeps every seam they check). The actuator must be UNABLE to
degrade the fleet — every move crosses the ONE repair seam, and nothing
in master/defrag.py can fence, tear down, or touch the lease table
directly:

1. master/defrag.py never calls a destructive or lease-mutating method —
   its only actuation entries are ``migrate_member`` and the
   adoption-tail ``finish_member_detach``, both on the SliceTxnManager;
2. ``migrate_member`` is invoked from exactly one place (``_execute``)
   and, on the manager side, defers to an in-flight repair;
3. planning consults ``_eligible`` (hysteresis first) before anything
   reaches actuation;
4. ``defrag_moves.inc`` and the ``defrag_plan``/``defrag_move`` events
   fire together or not at all (the ``_note_move`` seam);
5. the rollout default is ``plan``.
"""

import ast
import inspect

import gpumounter_tpu_torch.master.defrag as defrag_mod
import gpumounter_tpu_torch.master.slicetxn as slicetxn_mod

# Methods that fence, tear down, mutate the lease table, or actuate
# outside the repair seam. ``release`` and ``attach`` are included: the
# actuator must ride migrate_member, never run its own grow/shrink.
FORBIDDEN_CALLS = {"fence_lease", "_teardown_group", "detach_members",
                   "rollback", "evict_where", "drop", "attach",
                   "release", "repair_group", "_migrate"}


def _method_callers(module, attr: str) -> list[str]:
    """Names of the functions in ``module`` that call ``<x>.<attr>(...)``."""
    tree = ast.parse(inspect.getsource(module))
    callers = []
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) \
                        and isinstance(sub.func, ast.Attribute) \
                        and sub.func.attr == attr:
                    callers.append(node.name)
    return callers


def test_defrag_module_is_fence_free_and_teardown_free():
    tree = ast.parse(inspect.getsource(defrag_mod))
    offenders = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in FORBIDDEN_CALLS:
            offenders.append(node.func.attr)
    assert offenders == [], \
        f"defrag actuates outside the repair seam: {offenders}"


def test_every_move_crosses_the_repair_seam_once():
    """``migrate_member`` has exactly one call site in defrag.py
    (``_execute``) and ``finish_member_detach`` exactly one
    (``_run_adopt``, the adoption tail)."""
    assert _method_callers(defrag_mod, "migrate_member") == \
        ["_execute"]
    assert _method_callers(defrag_mod, "finish_member_detach") == \
        ["_run_adopt"]


def test_seam_shares_the_repair_guard_and_defers():
    """On the manager side, ``migrate_member`` and
    ``finish_member_detach`` consult the SAME ``_repairing`` guard
    ``repair_group`` holds — a repair in flight always wins."""
    for name in ("migrate_member", "finish_member_detach"):
        source = inspect.getsource(getattr(slicetxn_mod.SliceTxnManager,
                                           name))
        assert "_repairing" in source, name
    source = inspect.getsource(
        slicetxn_mod.SliceTxnManager.migrate_member)
    assert "repair in flight" in source


def test_planning_consults_eligible_and_hysteresis_first():
    """``_plan`` filters through ``_eligible``; ``_eligible`` applies
    the hysteresis comparison — nothing reaches ``_actuate`` without
    surviving every interlock."""
    assert "_eligible" in inspect.getsource(defrag_mod.DefragActuator
                                            ._plan)
    eligible = inspect.getsource(defrag_mod.DefragActuator._eligible)
    assert "hysteresis_ticks" in eligible
    assert "idle" in eligible
    assert "node_excluded_fn" in eligible
    # _actuate executes journaled plans only — it never reads the raw
    # candidate report
    assert "defrag_candidates" not in inspect.getsource(
        defrag_mod.DefragActuator._actuate)


def test_move_metric_and_events_are_paired():
    """``defrag_moves.inc`` and ``EVENTS.emit(defrag_plan|defrag_move)``
    each have exactly one call site — the ``_note_move`` seam — so the
    counter, the events and the /fleetz recent ring can never drift.
    The emit's kind argument is an IfExp selecting between the two
    names (planned → defrag_plan, else defrag_move)."""
    tree = ast.parse(inspect.getsource(defrag_mod))
    inc_callers, emit_callers = [], []
    for node in ast.walk(tree):
        if not isinstance(node, ast.FunctionDef):
            continue
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call) \
                    or not isinstance(sub.func, ast.Attribute):
                continue
            if sub.func.attr == "inc" \
                    and isinstance(sub.func.value, ast.Attribute) \
                    and sub.func.value.attr == "defrag_moves":
                inc_callers.append(node.name)
            if sub.func.attr == "emit" and sub.args:
                kinds = {c.value for c in ast.walk(sub.args[0])
                         if isinstance(c, ast.Constant)}
                if kinds & {"defrag_plan", "defrag_move"}:
                    emit_callers.append(node.name)
                    # the IfExp also walks its test's "planned" constant
                    assert {"defrag_plan", "defrag_move"} <= kinds, \
                        f"{node.name} emits only {kinds}"
    assert inc_callers == ["_note_move"], inc_callers
    assert emit_callers == ["_note_move"], emit_callers


def test_journal_precedes_actuation_in_execute():
    """The crash seam: ``_execute`` journals state="acting" BEFORE the
    ``migrate_member`` call — a master killed in between leaves the
    record a failed-over leader adopts."""
    source = inspect.getsource(defrag_mod.DefragActuator._execute)
    assert source.index("_journal") < source.index("migrate_member")


def test_plan_is_the_rollout_default():
    from gpumounter_tpu_torch.utils.config import Settings
    assert Settings().defrag_mode == "plan"
    assert Settings.from_env({}).defrag_mode == "plan"
    assert Settings.from_env(
        {"TPU_DEFRAG_MODE": "act"}).defrag_mode == "act"
    assert defrag_mod.mode({}) == "plan"
    assert defrag_mod.mode({"TPU_DEFRAG_MODE": "act"}) == "act"
    assert defrag_mod.enabled({}) is True
    assert defrag_mod.enabled({"TPU_DEFRAG_MODE": "0"}) is False


def test_interlock_knobs_are_validated():
    import pytest

    from gpumounter_tpu_torch.utils.config import Settings
    defaults = Settings.from_env({})
    assert defaults.defrag_hysteresis_ticks == 3
    assert defaults.defrag_idle_duty_max == 0.05
    assert defaults.defrag_max_inflight == 1
    assert defaults.defrag_budget == 4
    for env in ({"TPU_DEFRAG_MODE": "yes"},
                {"TPU_DEFRAG_HYSTERESIS_TICKS": "0"},
                {"TPU_DEFRAG_IDLE_DUTY_MAX": "1.5"},
                {"TPU_DEFRAG_MAX_INFLIGHT": "0"},
                {"TPU_DEFRAG_BUDGET": "0"}):
        with pytest.raises(ValueError):
            Settings.from_env(env)
