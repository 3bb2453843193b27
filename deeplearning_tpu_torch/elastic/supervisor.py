"""Run supervisor — the port of ``deeplearning_tpu/elastic/supervisor.py``:
launch, watch the heartbeat, classify, requeue.

The supervisor owns the outer loop every long run needs:

    launch child → watch heartbeat → classify the ending → maybe requeue

Classification of an ended (or killed) attempt:

- exit 0                 → ``completed``: done, stop.
- exit :data:`EXIT_PREEMPTED` (75) → ``preempted``: the child landed its
  checkpoint before dying; requeue immediately-ish (backoff still
  applies — preemption storms exist).
- wedge (heartbeat ``step`` AND ``activity`` both frozen past
  ``wedge_deadline_s``) → ``wedged``: SIGTERM, grace, SIGKILL, requeue.
  A *slow* child (activity advancing, step not — a long first step, a
  big eval) is never killed.
- any other exit         → ``crashed``: requeue under the same budget.

Requeue waits ``min(base·factor^(n-1), max)·(1+jitter·U)`` and burns one
unit of a bounded restart budget; when the budget is gone the supervisor
gives up with the child's last exit code. Every decision is recorded to
the supervisor's *own* flight recorder (the child has its own) and
dumped to ``<workdir>/flightrec_supervisor.json``, with JAX's event kinds
and fields (``launch``, ``child_exit``, ``wedge_kill``, ``backoff``,
``requeue``, ``completed``, ``stopped``, ``gave_up``), which the
restarts section of a run report reads.

The supervisor never touches the card: it imports no torch, and its
flight dumps skip the memory snapshot (``include_hbm=False``), so it
cannot wedge in the device setup it polices and holds no CUDA context
beside its child's. ``python -m deeplearning_tpu_torch.supervise`` is the
CLI.
"""

from __future__ import annotations

import os
import random
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from . import faults, heartbeat
from ..obs import threads as obs_threads
from .preempt import EXIT_PREEMPTED

__all__ = ["SupervisorConfig", "Supervisor", "WedgeDetector",
           "backoff_delay", "backoff_schedule",
           "worst_outcome", "exit_for_outcome",
           "OUTCOME_SEVERITY", "EXIT_WEDGED"]

# fleet exit classification: a crash outranks a wedge outranks a
# preemption outranks a clean/deliberate stop — numeric exit codes
# don't sort this way (75 > 1), so fleet mode classifies instead of
# max()ing raw return codes
OUTCOME_SEVERITY = {"completed": 0, "stopped": 0,
                    "preempted": 1, "wedged": 2, "crashed": 3}
EXIT_WEDGED = 70          # EX_SOFTWARE: killed-wedged, distinct from 1/75


def worst_outcome(outcomes: Sequence[str]) -> str:
    """The most severe outcome of a fleet (crash > wedge > preempted >
    clean); unknown labels rank as crashes."""
    worst = "completed"
    for o in outcomes:
        if OUTCOME_SEVERITY.get(o, 3) > OUTCOME_SEVERITY.get(worst, 3):
            worst = o
    return worst


def exit_for_outcome(outcome: str) -> int:
    """Representative process exit code for a classified outcome."""
    return {"completed": 0, "stopped": 0,
            "preempted": EXIT_PREEMPTED,
            "wedged": EXIT_WEDGED}.get(outcome, 1)


class SupervisorConfig:
    """Knobs for one supervised run. Defaults suit real runs; tests dial
    the deadlines down to tenths of seconds."""

    def __init__(self, argv: Sequence[str], *,
                 workdir: str = "runs/supervised",
                 heartbeat_path: Optional[str] = None,
                 max_restarts: int = 5,
                 backoff_base_s: float = 1.0,
                 backoff_factor: float = 2.0,
                 backoff_max_s: float = 60.0,
                 backoff_jitter: float = 0.25,
                 wedge_deadline_s: float = 120.0,
                 startup_deadline_s: float = 600.0,
                 poll_s: float = 0.25,
                 kill_grace_s: float = 10.0,
                 env: Optional[Dict[str, str]] = None,
                 seed: Optional[int] = None,
                 run_id: Optional[str] = None,
                 replica: Optional[int] = None):
        self.argv = list(argv)
        self.workdir = os.path.abspath(workdir)
        self.heartbeat_path = os.path.abspath(
            heartbeat_path or os.path.join(self.workdir, "heartbeat.json"))
        # fleet identity: handed to the child via env so its heartbeat,
        # /metrics exposition, and trace dump all join on the same key
        self.run_id = run_id
        self.replica = replica
        self.max_restarts = int(max_restarts)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_factor = float(backoff_factor)
        self.backoff_max_s = float(backoff_max_s)
        self.backoff_jitter = float(backoff_jitter)
        self.wedge_deadline_s = float(wedge_deadline_s)
        self.startup_deadline_s = float(startup_deadline_s)
        self.poll_s = float(poll_s)
        self.kill_grace_s = float(kill_grace_s)
        self.env = dict(env or {})
        self.seed = seed


def backoff_schedule(attempt: int, *, base_s: float, factor: float,
                     max_s: float, jitter: float,
                     rng: Optional[random.Random] = None) -> float:
    """Capped-exponential-plus-jitter delay before retry ``attempt``
    (1-based) — the one backoff curve in the codebase. The supervisor's
    requeue waits and the checkpoint manager's save retries both go
    through here, so a preemption storm (or an NFS brownout) never
    restarts/rewrites a whole fleet in lockstep."""
    base = min(base_s * (factor ** max(attempt - 1, 0)), max_s)
    u = (rng or random).random()
    return base * (1.0 + jitter * u)


def backoff_delay(attempt: int, cfg: SupervisorConfig,
                  rng: Optional[random.Random] = None) -> float:
    """Delay before restart number ``attempt`` under ``cfg``'s knobs."""
    return backoff_schedule(attempt, base_s=cfg.backoff_base_s,
                            factor=cfg.backoff_factor,
                            max_s=cfg.backoff_max_s,
                            jitter=cfg.backoff_jitter, rng=rng)


class WedgeDetector:
    """Slow-vs-wedged classifier over (step, activity) watermarks.

    ``observe(step, activity)`` returns ``"ok"`` when either watermark
    moved, ``"slow"`` when activity moves but step doesn't, ``"wedged"``
    once NEITHER has moved for ``deadline_s``. The distinction is the
    whole point: a 10-minute compile is slow (spans still tick); a dead
    device tunnel is wedged (the host thread never comes back).
    """

    def __init__(self, deadline_s: float):
        self.deadline_s = float(deadline_s)
        self._step: Optional[int] = None
        self._activity: Optional[int] = None
        self._step_at = time.monotonic()
        self._moved_at = time.monotonic()

    def reset(self) -> None:
        self._step = None
        self._activity = None
        self._step_at = time.monotonic()
        self._moved_at = time.monotonic()

    def observe(self, step: Optional[int], activity: Optional[int],
                now: Optional[float] = None) -> str:
        now = time.monotonic() if now is None else now
        moved = False
        if step is not None and step != self._step:
            self._step, self._step_at, moved = step, now, True
        if activity is not None and activity != self._activity:
            self._activity, moved = activity, True
        if moved:
            self._moved_at = now
            return "ok" if self._step_at == now else "slow"
        if now - self._moved_at >= self.deadline_s:
            return "wedged"
        return "slow" if now - self._step_at > now - self._moved_at else "ok"

    def stalled_for(self, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        return now - self._moved_at

    # ------------------------------------------------- in-process watch
    def watch(self, activity_fn: Callable[[], int],
              on_wedge: Callable[[float], None], *,
              poll_s: float = 1.0,
              stop: Optional[threading.Event] = None,
              name: str = "wedge-watch") -> threading.Thread:
        """Background thread flavor for in-process use (bench.py health
        probes): poll ``activity_fn()`` and call ``on_wedge(stalled_s)``
        once when it freezes past the deadline. ``stop.set()`` ends the
        watch — the happy path never fires the callback."""
        stop = stop or threading.Event()
        self.reset()

        def _run() -> None:
            while not stop.wait(min(poll_s, self.deadline_s / 2)):
                try:
                    verdict = self.observe(None, int(activity_fn()))
                except Exception:  # noqa: BLE001 - probe itself died
                    verdict = "wedged"
                if verdict == "wedged":
                    try:
                        on_wedge(self.stalled_for())
                    except Exception:  # noqa: BLE001
                        pass
                    return

        thread = obs_threads.spawn(_run, name=name, daemon=True,
                                   start=False)
        thread.stop = stop  # type: ignore[attr-defined]
        thread.start()
        return thread


class Supervisor:
    """The requeue loop. ``run()`` blocks until the child completes,
    the restart budget is exhausted, or the run is unsupervisable."""

    def __init__(self, cfg: SupervisorConfig):
        from ..obs.flight import FlightRecorder   # own ring, not global
        self.cfg = cfg
        self.rng = random.Random(cfg.seed)
        self.flight = FlightRecorder()
        self.flight.configure(
            os.path.join(cfg.workdir, "flightrec_supervisor.json"),
            config={"argv": cfg.argv, "max_restarts": cfg.max_restarts,
                    "wedge_deadline_s": cfg.wedge_deadline_s,
                    "backoff_base_s": cfg.backoff_base_s,
                    "backoff_factor": cfg.backoff_factor,
                    "backoff_max_s": cfg.backoff_max_s})
        self.launches = 0
        self.outcomes: List[str] = []
        self.final_outcome: Optional[str] = None
        self.backoff_total_s = 0.0
        self._log = print
        # runtime lifecycle verbs (fleet controller surface): a pending
        # directive is honored at the next watch poll / backoff wake —
        # "stop" ends the run cleanly, "restart" requeues the child NOW
        # without burning the restart budget (a capacity op, not a
        # failure). on_outcome, when set, sees every natural ending and
        # may return "requeue_now" (skip backoff + budget) or "stop"
        # (shed the replica) to override the default policy.
        self._directive_lock = threading.Lock()
        self._directive: Optional[tuple] = None
        self._wake = threading.Event()
        self.on_outcome: Optional[Callable[..., Optional[str]]] = None

    # ------------------------------------------------------- directives
    def request_stop(self, reason: str = "requested") -> None:
        """Ask the run loop to kill the child (if any) and return 0."""
        with self._directive_lock:
            self._directive = ("stop", reason)
        self._wake.set()

    def request_restart(self, reason: str = "requested") -> None:
        """Ask the run loop to kill + relaunch the child immediately —
        no backoff, no restart-budget burn. The relaunch still gets a
        fresh attempt number (``DLTPU_RESTART_ATTEMPT``), so
        attempt-gated fault specs don't re-fire in the replacement."""
        with self._directive_lock:
            if self._directive is None:       # stop always wins
                self._directive = ("restart", reason)
        self._wake.set()

    def _take_directive(self) -> Optional[tuple]:
        with self._directive_lock:
            d, self._directive = self._directive, None
            self._wake.clear()        # inside the lock: a set() after
        return d                      # this re-raises the flag

    # ----------------------------------------------------------- pieces
    def _child_env(self, attempt: int) -> Dict[str, str]:
        env = dict(os.environ)
        env.update(self.cfg.env)
        env[heartbeat.ENV_VAR] = self.cfg.heartbeat_path
        env[faults.ATTEMPT_VAR] = str(attempt)
        if self.cfg.run_id:
            env[heartbeat.RUN_ID_VAR] = self.cfg.run_id
        if self.cfg.replica is not None:
            env[heartbeat.REPLICA_VAR] = str(self.cfg.replica)
            # where the child advertises its scrape URL (fleet discovery)
            env["DLTPU_ENDPOINT_FILE"] = os.path.join(
                self.cfg.workdir, "endpoint.json")
        return env

    def _launch(self, attempt: int) -> subprocess.Popen:
        os.makedirs(self.cfg.workdir, exist_ok=True)
        try:                              # a stale beat from a previous
            os.remove(self.cfg.heartbeat_path)   # attempt must not count
        except OSError:
            pass
        self.launches += 1
        self.flight.record("launch", attempt=attempt, argv=self.cfg.argv)
        self._log(f"[supervise] attempt {attempt}: "
                  f"exec {' '.join(self.cfg.argv)}", file=sys.stderr)
        return subprocess.Popen(self.cfg.argv, env=self._child_env(attempt))

    def _watch(self, child: subprocess.Popen) -> str:
        """Block until the child exits, wedges, or a lifecycle directive
        arrives. Returns ``"exit"``, ``"wedged"``, or ``"directive"``
        (for the latter two the child may still be running — caller must
        kill). The directive check comes FIRST so a controller's verdict
        beats the child's own exit classification: a wedged serving
        child killed by us exits 0 through its graceful SIGTERM drain,
        and that must still count as a requeue, not a completion."""
        detector = WedgeDetector(self.cfg.wedge_deadline_s)
        started = time.monotonic()
        seen_beat = False
        while True:
            if self._directive is not None:
                return "directive"
            if child.poll() is not None:
                return "exit"
            beat = heartbeat.read_heartbeat(self.cfg.heartbeat_path)
            if beat is not None and beat.get("pid") == child.pid:
                seen_beat = True
                detector.observe(beat.get("step"), beat.get("activity"))
                if detector.stalled_for() >= self.cfg.wedge_deadline_s:
                    return "wedged"
            elif not seen_beat and (time.monotonic() - started
                                    >= self.cfg.startup_deadline_s):
                return "wedged"           # never even produced a beat
            self._wake.wait(self.cfg.poll_s)

    def _kill(self, child: subprocess.Popen) -> None:
        """SIGTERM → grace → SIGKILL. The grace window lets the child's
        preemption guard flush its checkpoint; a truly wedged main
        thread won't take the hint and eats the SIGKILL."""
        try:
            child.send_signal(signal.SIGTERM)
        except OSError:
            return
        try:
            child.wait(self.cfg.kill_grace_s)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait()

    # -------------------------------------------------------------- run
    def _finish(self, outcome: str, rc: int, reason: str) -> int:
        self.final_outcome = outcome
        self.flight.record(outcome if outcome in ("completed", "stopped")
                           else "gave_up", returncode=rc, reason=reason)
        self.flight.dump(reason, include_hbm=False)
        return rc

    def run(self) -> int:
        attempt, last_rc, budget_used = 0, 1, 0
        while True:
            child = self._launch(attempt)
            verdict = self._watch(child)
            if verdict == "directive":
                kind, reason = self._take_directive() or ("stop", "race")
                self._kill(child)
                if kind == "stop":
                    self.outcomes.append("stopped")
                    self._log(f"[supervise] attempt {attempt}: stopped "
                              f"({reason})", file=sys.stderr)
                    return self._finish("stopped", 0, reason)
                # restart directive: a capacity op — requeue NOW, no
                # backoff, no budget burn; attempt still advances so the
                # replacement's env (DLTPU_RESTART_ATTEMPT) moves past
                # attempt-gated fault specs
                self.outcomes.append("requeued")
                self.flight.record("requeue", attempt=attempt,
                                   reason=reason)
                self._log(f"[supervise] attempt {attempt}: requeued "
                          f"({reason})", file=sys.stderr)
                attempt += 1
                continue
            if verdict == "wedged":
                self.flight.record("wedge_kill", attempt=attempt,
                                   pid=child.pid,
                                   deadline_s=self.cfg.wedge_deadline_s)
                self._log(f"[supervise] attempt {attempt}: wedged "
                          f"(no progress for {self.cfg.wedge_deadline_s}s)"
                          f" — killing pid {child.pid}", file=sys.stderr)
                self._kill(child)
                outcome, last_rc = "wedged", child.returncode or 1
            else:
                rc = child.returncode
                last_rc = rc
                if rc == 0:
                    outcome = "completed"
                elif rc == EXIT_PREEMPTED:
                    outcome = "preempted"
                else:
                    outcome = "crashed"
                self.flight.record("child_exit", attempt=attempt,
                                   returncode=rc, outcome=outcome)
            self.outcomes.append(outcome)
            hint = None
            if self.on_outcome is not None:
                try:
                    hint = self.on_outcome(self, outcome, attempt, last_rc)
                except Exception:  # noqa: BLE001 - policy must not kill us
                    hint = None
            if hint == "stop":
                # the controller chose to shed this replica (e.g. a
                # preemption while over capacity): a deliberate, clean end
                self._log(f"[supervise] attempt {attempt} {outcome}; "
                          f"shed by controller", file=sys.stderr)
                return self._finish("stopped", 0, f"shed_after_{outcome}")
            if outcome == "completed":
                self.flight.record("completed", attempt=attempt)
                self.final_outcome = "completed"
                self.flight.dump("completed", include_hbm=False)
                return 0
            attempt += 1
            if hint == "requeue_now":
                self.flight.record("requeue", attempt=attempt - 1,
                                   reason=f"controller_{outcome}")
                self._log(f"[supervise] attempt {attempt - 1} {outcome}; "
                          f"controller requeue now", file=sys.stderr)
                continue
            budget_used += 1
            if budget_used > self.cfg.max_restarts:
                self.final_outcome = outcome
                self.flight.record("gave_up", attempts=attempt,
                                   last_outcome=outcome, returncode=last_rc)
                self.flight.dump("gave_up", include_hbm=False)
                self._log(f"[supervise] restart budget exhausted after "
                          f"{attempt} attempts; giving up (rc={last_rc})",
                          file=sys.stderr)
                return last_rc if last_rc else 1
            delay = backoff_delay(budget_used, self.cfg, self.rng)
            self.backoff_total_s += delay
            self.flight.record("backoff", attempt=attempt,
                               outcome=outcome, delay_s=round(delay, 3))
            self._log(f"[supervise] attempt {attempt - 1} {outcome}; "
                      f"requeue {attempt}/{self.cfg.max_restarts} in "
                      f"{delay:.2f}s", file=sys.stderr)
            if self._wake.wait(delay):
                d = self._take_directive()
                if d is not None and d[0] == "stop":
                    self.outcomes.append("stopped")
                    return self._finish("stopped", 0, d[1])
                # restart directive mid-backoff: just relaunch now
