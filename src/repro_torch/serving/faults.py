"""Deterministic fault injection for the replicated-shard router.

``FaultPlan`` scripts chaos at the router's shard-call boundary
(serving.cluster.ShardReplicaRouter routes EVERY replica interaction —
scans, margin calls, writes, health probes — through ``on_call``), so a
scenario is a replayable schedule, not a race: events are keyed by the
per-(shard, replica) call index, and as long as calls to one replica are
issued serially (the router serializes them; the services serialize whole
batches), the same plan produces the same fault sequence every run.

Fault vocabulary:

- ``kill(s, r)`` / ``revive(s, r)`` — direct switches: every call to a
  killed replica raises ``ReplicaKilled`` until revived (health probes
  included, so the router's hysteresis sees a genuinely dead peer).
- ``delay_at(s, r, call, ms)`` — the matching call sleeps D ms before
  executing; with D past the router's deadline this is how scripted
  timeouts (and the retry-to-sibling ladder) are exercised.
- ``drop_at(s, r, call)`` — the matching call executes nothing and raises
  ``DroppedResponse`` (the work-done-but-answer-lost failure mode).
- ``kill_at(s, r, call)`` / ``revive_at(s, r, call)`` — scheduled
  versions of the switches.
- ``flap_at(s, r, call, up_after)`` — kill that auto-revives after
  ``up_after`` further calls to the same replica: the health-flapping
  scenario the re-admit hysteresis exists for.

``FaultPlan.seeded`` builds a replayable random soak schedule from a
numpy seed; ``chip_smoke.py``'s cluster phase requires zero uncaught
exceptions while one of these runs under live traffic.

Numpy only: a copy of the JAX package's module, held to it by
tests/test_torch_faults.py.
"""
from __future__ import annotations

import threading
import time

import numpy as np


class FaultError(RuntimeError):
    """Base class for injected faults (so callers can catch just these)."""


class ReplicaKilled(FaultError):
    """The target replica is down (injected)."""


class DroppedResponse(FaultError):
    """The call's response was dropped after the work ran (injected)."""


class FaultPlan:
    """Scripted, replayable fault schedule keyed by per-replica call index.

    Thread-safe; one plan drives one router.  ``on_call`` is the single
    hook: the router invokes it with (shard, replica, op) before every
    replica interaction, and the plan either returns (optionally after an
    injected delay) or raises a ``FaultError`` the router treats exactly
    like a real replica failure.
    """

    def __init__(self):
        self._mu = threading.Lock()
        self._calls: dict[tuple[int, int], int] = {}
        # (shard, replica, call_idx) -> list of event tuples
        self._events: dict[tuple[int, int, int], list[tuple]] = {}
        # (shard, replica) -> None (down until revived) or call index at
        # which the replica auto-revives (flap)
        self._down: dict[tuple[int, int], int | None] = {}
        self.log: list[tuple] = []      # (call_idx, shard, replica, op, what)
        self.injected = 0

    # -- scripting -----------------------------------------------------------

    def kill(self, shard: int, replica: int) -> None:
        with self._mu:
            self._down[(shard, replica)] = None

    def revive(self, shard: int, replica: int) -> None:
        with self._mu:
            self._down.pop((shard, replica), None)

    def is_down(self, shard: int, replica: int) -> bool:
        with self._mu:
            return (shard, replica) in self._down

    def _add(self, shard: int, replica: int, call: int, ev: tuple) -> None:
        with self._mu:
            self._events.setdefault((shard, replica, call), []).append(ev)

    def kill_at(self, shard: int, replica: int, call: int) -> None:
        self._add(shard, replica, call, ("kill",))

    def revive_at(self, shard: int, replica: int, call: int) -> None:
        self._add(shard, replica, call, ("revive",))

    def delay_at(self, shard: int, replica: int, call: int,
                 ms: float) -> None:
        self._add(shard, replica, call, ("delay", float(ms)))

    def drop_at(self, shard: int, replica: int, call: int) -> None:
        self._add(shard, replica, call, ("drop",))

    def flap_at(self, shard: int, replica: int, call: int,
                up_after: int) -> None:
        self._add(shard, replica, call, ("flap", int(up_after)))

    # -- the router-side hook ------------------------------------------------

    def on_call(self, shard: int, replica: int, op: str) -> None:
        """Advance (shard, replica)'s call clock and apply any scheduled
        event, then enforce the down state.  Raises ReplicaKilled /
        DroppedResponse; sleeps for scripted delays."""
        delay_ms = 0.0
        fault: Exception | None = None
        with self._mu:
            key = (shard, replica)
            idx = self._calls.get(key, 0)
            self._calls[key] = idx + 1
            for ev in self._events.pop((shard, replica, idx), ()):
                if ev[0] == "kill":
                    self._down[key] = None
                elif ev[0] == "revive":
                    self._down.pop(key, None)
                elif ev[0] == "delay":
                    delay_ms = ev[1]
                elif ev[0] == "drop":
                    fault = DroppedResponse(
                        f"dropped response from shard {shard} replica "
                        f"{replica} (call {idx}, op {op})")
                elif ev[0] == "flap":
                    self._down[key] = idx + ev[1]
            until = self._down.get(key, -1)
            if until is None or (until >= 0 and idx < until):
                fault = ReplicaKilled(
                    f"shard {shard} replica {replica} is down "
                    f"(call {idx}, op {op})")
            elif until >= 0:
                self._down.pop(key, None)       # flap window over
            if delay_ms or fault is not None:
                what = (type(fault).__name__ if fault is not None
                        else f"delay {delay_ms}ms")
                self.log.append((idx, shard, replica, op, what))
                self.injected += 1
        if delay_ms:
            time.sleep(delay_ms * 1e-3)
        if fault is not None:
            raise fault

    def stats(self) -> dict:
        with self._mu:
            return {
                "injected": self.injected,
                "pending_events": sum(len(v) for v in self._events.values()),
                "down": sorted(k for k, v in self._down.items()
                               if v is None),
                "calls": dict(self._calls),
            }

    # -- seeded soak schedules -----------------------------------------------

    @classmethod
    def seeded(cls, seed: int, shards: int, replicas: int,
               horizon_calls: int = 200, kills: int = 3, delays: int = 3,
               drops: int = 2, flaps: int = 2,
               delay_ms: float = 5.0) -> "FaultPlan":
        """A replayable random schedule over the first ``horizon_calls``
        calls of each replica: ``kills`` kill→revive windows, ``delays``
        scripted delays, ``drops`` dropped responses, ``flaps`` flap
        events.  Same seed ⇒ same schedule ⇒ same fault sequence under a
        serialized caller — the chaos soak's replayability contract.  At
        most replicas−1 replicas of any one shard get a kill/flap window,
        so scripted faults alone never take a whole shard down (full-shard
        loss is the benchmark's separate, explicit phase)."""
        rng = np.random.default_rng(seed)
        plan = cls()
        # schedule kill windows on distinct (shard, replica) targets,
        # leaving replica `shards % replicas`-rotated survivors untouched
        targets = [(s, r) for s in range(shards) for r in range(replicas)]
        protected = {(s, (s % replicas)) for s in range(shards)}
        candidates = [t for t in targets if t not in protected]
        rng.shuffle(candidates)
        for i in range(min(kills, len(candidates))):
            s, r = candidates[i]
            at = int(rng.integers(1, max(2, horizon_calls // 2)))
            width = int(rng.integers(2, 8))
            plan.kill_at(s, r, at)
            plan.revive_at(s, r, at + width)
        for i in range(min(flaps, len(candidates))):
            s, r = candidates[(i + kills) % len(candidates)]
            at = int(rng.integers(horizon_calls // 2, horizon_calls))
            plan.flap_at(s, r, at, up_after=int(rng.integers(1, 4)))
        for _ in range(delays):
            s = int(rng.integers(0, shards))
            r = int(rng.integers(0, replicas))
            at = int(rng.integers(1, horizon_calls))
            plan.delay_at(s, r, at, ms=float(delay_ms))
        for _ in range(drops):
            s = int(rng.integers(0, shards))
            r = int(rng.integers(0, replicas))
            at = int(rng.integers(1, horizon_calls))
            plan.drop_at(s, r, at)
        return plan
