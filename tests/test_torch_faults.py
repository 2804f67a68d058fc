"""The port's copy of the fault-injection plan (serving/faults.py, numpy
only) held to the JAX package's module: the same code, and the same
schedules, fault sequences and logs for the same scripts and seeds."""
import ast
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.serving import faults as jfaults  # noqa: E402
from repro_torch.serving import faults as tfaults  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _code_without_docstrings(path: Path) -> str:
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


def test_faults_copy_is_the_original_code():
    """Only the docstrings may differ (the module's names the smoke run)."""
    assert _code_without_docstrings(
        ROOT / "src" / "repro_torch" / "serving" / "faults.py") == \
        _code_without_docstrings(ROOT / "src" / "repro" / "serving" /
                                 "faults.py")


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_seeded_schedule_equals_original(seed):
    kw = dict(shards=3, replicas=2, horizon_calls=60, kills=3, delays=2,
              drops=2, flaps=2, delay_ms=0.0)
    t = tfaults.FaultPlan.seeded(seed, **kw)
    j = jfaults.FaultPlan.seeded(seed, **kw)
    assert t._events == j._events


def _drive(mod, plan, calls):
    out = []
    for s, r, op in calls:
        try:
            plan.on_call(s, r, op)
            out.append("ok")
        except mod.FaultError as e:
            out.append(type(e).__name__)
    return out


def test_scripted_faults_replay_like_the_original():
    """kill / revive / drop / flap / delay scripts give the same outcome
    per call, the same log and the same stats on both copies."""
    outcomes = []
    for mod in (tfaults, jfaults):
        plan = mod.FaultPlan()
        plan.kill_at(0, 0, 2)
        plan.revive_at(0, 0, 5)
        plan.drop_at(1, 1, 1)
        plan.flap_at(1, 0, 3, up_after=2)
        plan.delay_at(0, 1, 0, ms=1.0)
        calls = [(s, r, op) for i in range(8) for s in range(2)
                 for r in range(2) for op in ("scan",)]
        got = _drive(mod, plan, calls)
        plan.kill(1, 1)
        assert plan.is_down(1, 1)
        got += _drive(mod, plan, [(1, 1, "probe")])
        plan.revive(1, 1)
        got += _drive(mod, plan, [(1, 1, "probe")])
        outcomes.append((got, plan.log, plan.stats(), plan.injected))
    assert outcomes[0] == outcomes[1]
    got = outcomes[0][0]
    assert "ReplicaKilled" in got and "DroppedResponse" in got


def test_fault_classes_match_the_original():
    for name in ("FaultError", "ReplicaKilled", "DroppedResponse"):
        t, j = getattr(tfaults, name), getattr(jfaults, name)
        assert [c.__name__ for c in t.__mro__] == \
            [c.__name__ for c in j.__mro__]
    assert issubclass(tfaults.ReplicaKilled, RuntimeError)
    assert np.array_equal(
        sorted(tfaults.FaultPlan.seeded(5, 2, 2).stats()["calls"]), [])
