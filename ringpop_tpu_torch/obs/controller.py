"""OpsController: the actuator half of the closed observability loop.

``obs/rules.py`` turns telemetry into alert transitions; this module
turns firing alerts into mitigations, through seams that ALL predate
it — the controller adds policy, not mechanism:

* ``dgro_rescore`` — per-rank load or arc-diameter skew: drop the
  sticky DGRO candidate and re-score placement at current membership
  (:meth:`~ringpop_tpu_torch.serve.state.RingStore.rescore_placement`; the
  arxiv 2410.11142 scorer was already landed and sticky — telemetry is
  now the trigger that pays the movement).
* ``drain`` — a degrading rank: route its ring block away via a
  :meth:`~ringpop_tpu_torch.serve.state.RingStore.drain` generation commit
  BEFORE SWIM declares it faulty, then probe the new placement
  (``forward.batch.rank_load``) and record the drained rank's key share
  as the action's EFFECT.
* ``resize`` — a rank stale on ``/healthz``: invoke the r19
  checkpoint-at-P / resume-at-P′ path (injected as a callable — the
  harness owns process lifecycle; the controller owns the decision).

Every action lands as a ``kind:"action"`` journal record whose span
PARENTS the triggering alert's span — ``obs.trace.chain()`` therefore
reconstructs alert → decision → action → effect from the journal
alone, which is the game-day acceptance bar.  A mitigation that itself
raises emits ``ok: false`` and dumps the flight ring under
``scope="controller"`` (its own once-per-process slot — it must never
burn the engine-crash dump, pinned in ``tests/test_closed_loop.py``).

torch-free: numpy + stdlib only.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from ringpop_tpu_torch.obs.rules import FLEET
from ringpop_tpu_torch.obs.trace import salt_of, span_id_of

# mitigation names — the policy dict maps rule ids onto these
ACTIONS = ("dgro_rescore", "drain", "resize")


class OpsController:
    """Alert-driven mitigation dispatch with per-subject cooldowns.

    ``policy`` maps rule id → action name (:data:`ACTIONS`); alerts
    whose rule has no policy entry are ignored (they remain visible in
    the journal — not every alert warrants a reflex).  Seams:

    * ``ring_store`` — a :class:`~ringpop_tpu_torch.serve.state.RingStore`
      (or duck-type with ``rescore_placement()``/``drain(servers)``);
    * ``server_of`` — rank → server name, for ``drain`` (the rules
      engine alerts about RANKS; the ring speaks server names);
    * ``resize`` — callable ``(stale_rank) -> detail dict``, the r19
      checkpoint/resume invocation;
    * ``drain_probe`` — callable ``(server) -> int``, the drained
      server's key share over a probe population against the POST-drain
      ring (the harness's ``ring.lookup_batch`` count), the drain's
      effect measurement: 0 means the block really routed away;
    * ``recorder`` — a FlightRecorder; failed mitigations dump under
      ``scope="controller"``.

    ``cooldown`` suppresses re-dispatch of the same (action, subject)
    for that many :meth:`on_alerts` rounds — an alert that stays firing
    across evaluations must not re-drain every block."""

    def __init__(
        self,
        *,
        sink: Callable[[dict], None],
        policy: dict[str, str],
        rank: int = 0,
        ring_store=None,
        server_of: Optional[Callable[[int], str]] = None,
        resize: Optional[Callable[[int], dict]] = None,
        drain_probe: Optional[Callable[[], "list"]] = None,
        recorder=None,
        cooldown: int = 4,
    ):
        bad = sorted(set(policy.values()) - set(ACTIONS))
        if bad:
            raise ValueError(f"unknown actions in policy: {bad}")
        self.sink = sink
        self.policy = dict(policy)
        self.rank = rank
        self.ring_store = ring_store
        self.server_of = server_of
        self.resize = resize
        self.drain_probe = drain_probe
        self.recorder = recorder
        self.cooldown = cooldown
        self._round = 0
        self._last_round: dict[tuple[str, int], int] = {}
        self._drained: set[int] = set()
        self.actions_taken = 0
        self.actions_failed = 0
        self.history: list[dict] = []

    # -- dispatch -------------------------------------------------------------

    def on_alerts(
        self, alerts: list[dict], *, tick: Optional[int] = None
    ) -> list[dict]:
        """Feed one evaluation round's alert records (the return value
        of ``RuleEngine.evaluate``); returns the action records emitted.
        Only ``state == "firing"`` transitions dispatch — a clear is
        information, not work."""
        self._round += 1
        out: list[dict] = []
        for alert in alerts:
            if alert.get("state") != "firing":
                continue
            action = self.policy.get(alert.get("rule"))
            if action is None:
                continue
            subject = int(alert.get("about_rank", FLEET))
            key = (action, subject)
            last = self._last_round.get(key)
            if last is not None and self._round - last < self.cooldown:
                continue
            self._last_round[key] = self._round
            out.extend(self._dispatch(action, subject, alert, tick))
        return out

    def _dispatch(
        self, action: str, subject: int, alert: dict, tick
    ) -> list[dict]:
        records: list[dict] = []
        ok, detail, err, server = False, {}, None, None
        try:
            if action == "dgro_rescore":
                rec = self.ring_store.rescore_placement()
                ok = rec is not None
                if ok:
                    detail = {
                        "gen": rec["gen"],
                        "placement": rec.get("placement", {}),
                    }
            elif action == "drain":
                if subject in self._drained:
                    return records  # already routed away
                server = self.server_of(subject)
                rec = self.ring_store.drain([server])
                ok = rec is not None
                if ok:
                    self._drained.add(subject)
                    detail = {"server": server, "gen": rec["gen"]}
            elif action == "resize":
                detail = dict(self.resize(subject) or {})
                ok = True
        except Exception as e:
            err = f"{type(e).__name__}: {e}"
            if self.recorder is not None:
                # the controller's OWN dump slot: a broken mitigation is
                # forensically interesting, but must not consume the
                # once-per-process engine-crash dump
                self.recorder.dump(
                    f"controller:{action}", error=e, scope="controller"
                )
        act = self._emit(action, subject, alert, ok, detail, err, tick)
        records.append(act)
        if ok:
            self.actions_taken += 1
        else:
            self.actions_failed += 1
        if ok and action == "drain" and self.drain_probe is not None:
            records.append(self._probe_drain(subject, server, act, tick))
        return records

    def _probe_drain(self, subject: int, server: str, act: dict, tick) -> dict:
        """Measure the drain's effect: the drained server's key share
        over a probe population against the POST-drain ring must be 0."""
        try:
            share = int(self.drain_probe(server))
            ok, detail, err = share == 0, {"server": server, "share": share}, None
        except Exception as e:
            ok, detail, err = False, {}, f"{type(e).__name__}: {e}"
        trace = act["trace"]
        record = {
            "kind": "action",
            "action": "effect",
            "of": act["action"],
            "rule": act["rule"],
            "about_rank": subject,
            "ok": ok,
            "detail": detail,
            "error": err,
            "tick": tick,
            "rank": self.rank,
            "trace": trace,
            "span": span_id_of(
                trace, "effect", salt=salt_of("effect", subject),
                parent=act["span"],
            ),
            "parent": act["span"],
            "t": time.time(),
        }
        self._sink(record)
        return record

    def _emit(
        self, action: str, subject: int, alert: dict, ok: bool,
        detail: dict, err, tick,
    ) -> dict:
        trace = alert["trace"]  # the action joins the ALERT's trace
        record = {
            "kind": "action",
            "action": action,
            "rule": alert.get("rule"),
            "about_rank": subject,
            "ok": ok,
            "detail": detail,
            "error": err,
            "tick": tick,
            "rank": self.rank,
            "trace": trace,
            "span": span_id_of(
                trace, "action",
                salt=salt_of(action, subject, self._round),
                parent=alert["span"],
            ),
            "parent": alert["span"],
            "t": time.time(),
        }
        self._sink(record)
        self.history.append(record)
        return record

    def _sink(self, record: dict) -> None:
        try:
            self.sink(record)
        except Exception:
            pass  # the ops plane never takes the run down
