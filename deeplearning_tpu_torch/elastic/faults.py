"""Fault injection: make preemption, crashes, and wedges CPU-testable.

The elastic loop only earns trust if tier-1 can kill it on purpose. The
Trainer calls :func:`maybe_fire` at two sites — every step boundary
(``site="step"``) and just before each checkpoint write
(``site="checkpoint"``) — and this module decides, from the
``DLTPU_FAULTS`` env var, whether to deliver a fault there.

Grammar (``;``-separated specs, each ``@``-separated fields)::

    DLTPU_FAULTS="sigterm@step:5@attempt:0;crash@checkpoint;wedge@step:3"

    kind      := sigterm | sigint | crash | wedge
               | nan | bad_sample | ckpt_corrupt
    site      := step[:N] | checkpoint[:N]   (N = fire at host step >= N;
                                              omitted = first visit)
    attempt:K := only fire on restart attempt K (DLTPU_RESTART_ATTEMPT,
                 set by the supervisor; defaults to 0 when unset)

Each spec fires at most once per process. Actions:

- ``sigterm``/``sigint``: ``os.kill(os.getpid(), SIG*)`` — exercises the
  real handler chain, not a shortcut into the guard.
- ``crash``: raise :class:`InjectedCrash` (a non-Preempted exception →
  non-75 exit → the supervisor counts a crash).
- ``wedge``: block in ``time.sleep`` while the heartbeat writer thread
  keeps the file fresh — exactly the wedged-device-tunnel signature
  (process alive, loop stuck) the supervisor must classify and kill.

The self-healing kinds (``nan``, ``bad_sample``, ``ckpt_corrupt``) are
*consumed*, not fired: :func:`maybe_fire` never delivers them — the
subsystem that owns the effect polls :func:`consume` and applies it
through its REAL code path, so the recovery machinery is exercised end
to end instead of shortcut into:

- ``nan@step:N``: the Trainer poisons its params with NaN at host step
  N, so the next dispatched step's jitted ``bad_step`` flag fires and
  divergence recovery (rollback or abort) runs for real.
- ``bad_sample@step:N``: the DataLoader's per-sample fetch raises
  :class:`InjectedBadSample` at fetch ordinal N — the quarantine path's
  test handle (``step`` here counts SAMPLE fetches, not train steps).
- ``ckpt_corrupt@step:N``: after the checkpoint write at step >= N
  commits, the Trainer garbles the step dir on disk
  (:func:`corrupt_checkpoint`), so restore-time verification must fall
  back to the previous intact step.

The fleet-choreography kinds target ONE replica of a supervised fleet
(``DLTPU_REPLICA``, exported per child by ``tools/supervise.py``) so a
single ``DLTPU_FAULTS`` value shared by every replica still wedges or
preempts exactly one of them:

- ``wedge_replica:<i>@step:N``: consumed by the serving
  ``MicroBatcher``'s dispatch loop on replica ``i`` once ``dispatched``
  reaches N — the loop blocks (heartbeat thread stays alive, queue
  keeps filling) so ``DispatchWatch``/the controller must classify the
  frozen stream and requeue the replica.
- ``preempt_replica:<i>@step:N``: consumed on replica ``i`` at the same
  site; the serving CLI reacts exactly as a real SIGTERM-with-grace
  preemption would — drain, then exit 75 — so the controller's
  preemption-as-capacity path runs for real.

The resilience-layer kinds extend the consumed family to the serving
data plane (all polled by the ``MicroBatcher`` against its
``dispatched`` counter):

- ``e503@submit:N``: the serve CLI answers one request with an injected
  503 once ``dispatched`` reaches N — exercises router failover and the
  per-replica circuit breaker without any replica actually failing.
- ``latency:<ms>@step:N``: the dispatch loop sleeps ``ms`` before one
  batch — injected tail latency, the stimulus the router's hedging
  policy exists to absorb.
- ``crash_replica:<i>@step:N``: replica ``i`` hard-exits (non-75,
  non-0) mid-serve, so the supervisor classifies a crash and in-flight
  requests surface as connection errors to the router.

``DLTPU_CHAOS=<seed>:<spec>`` compiles a *deterministic* schedule of
the above through :func:`chaos_schedule` (same seed → byte-identical
schedule), e.g. ``DLTPU_CHAOS="7:e503*20@5-40;latency:50*10@5-40;
wedge:1*1@10-30"`` — each token is ``kind[:target]*count@lo-hi`` and
expands to ``count`` specs in the regular grammar with step ordinals
drawn from ``[lo, hi]``. :func:`active_faults` merges the compiled
schedule with any explicit ``DLTPU_FAULTS`` specs.
"""

from __future__ import annotations

import os
import random
import signal
import time
from typing import List, Optional

__all__ = ["ENV_VAR", "ATTEMPT_VAR", "REPLICA_VAR", "CHAOS_VAR",
           "FaultSpec", "InjectedCrash", "InjectedBadSample",
           "parse_faults", "chaos_schedule", "active_faults",
           "maybe_fire", "consume", "consume_arg",
           "corrupt_checkpoint", "reset"]

ENV_VAR = "DLTPU_FAULTS"
ATTEMPT_VAR = "DLTPU_RESTART_ATTEMPT"
CHAOS_VAR = "DLTPU_CHAOS"

_KINDS = ("sigterm", "sigint", "crash", "wedge",
          "nan", "bad_sample", "ckpt_corrupt",
          "wedge_replica", "preempt_replica",
          "e503", "latency", "crash_replica")
# kinds applied by their owning subsystem via consume(); maybe_fire
# skips them so the generic step/checkpoint hooks can't double-deliver
_CONSUMED_KINDS = ("nan", "bad_sample", "ckpt_corrupt",
                   "wedge_replica", "preempt_replica",
                   "e503", "latency", "crash_replica")
# kinds whose token carries a target replica index (kind:<i>) matched
# against DLTPU_REPLICA — one shared fault var, one afflicted replica
_REPLICA_KINDS = ("wedge_replica", "preempt_replica", "crash_replica")
# kinds whose token carries a numeric argument (kind:<value>)
_ARG_KINDS = ("latency",)
_SITES = ("step", "checkpoint", "submit")
REPLICA_VAR = "DLTPU_REPLICA"

# chaos token kind → the regular-grammar kind/site it expands to
_CHAOS_KINDS = {"e503": ("e503", "submit"),
                "latency": ("latency", "step"),
                "wedge": ("wedge_replica", "step"),
                "preempt": ("preempt_replica", "step"),
                "crash": ("crash_replica", "step")}

# long enough that only the supervisor's wedge kill ends it, short
# enough that an escaped sleep can't outlive a test suite timeout
WEDGE_SLEEP_S = 600.0


class InjectedCrash(RuntimeError):
    """The ``crash`` fault: an ordinary hard failure, exit code != 75."""


class InjectedBadSample(ValueError):
    """The ``bad_sample`` fault: a per-sample decode failure, raised
    inside the loader's fetch so the quarantine path catches it exactly
    where a real corrupt JPEG would surface."""


class FaultSpec:
    __slots__ = ("kind", "site", "at_step", "attempt", "replica", "arg",
                 "fired")

    def __init__(self, kind: str, site: str, at_step: Optional[int],
                 attempt: Optional[int], replica: Optional[int] = None,
                 arg: Optional[float] = None):
        self.kind = kind
        self.site = site
        self.at_step = at_step
        self.attempt = attempt
        self.replica = replica
        self.arg = arg
        self.fired = False

    def __repr__(self) -> str:  # shows up in flight events / test output
        kind = self.kind
        if self.replica is not None:
            kind = f"{kind}:{self.replica}"
        elif self.arg is not None:
            kind = f"{kind}:{self.arg:g}"
        parts = [kind, self.site if self.at_step is None
                 else f"{self.site}:{self.at_step}"]
        if self.attempt is not None:
            parts.append(f"attempt:{self.attempt}")
        return "@".join(parts)

    def matches(self, site: str, step: int, attempt: int) -> bool:
        if self.fired or self.site != site:
            return False
        if self.attempt is not None and self.attempt != attempt:
            return False
        if self.at_step is not None and step < self.at_step:
            return False
        if self.replica is not None and self.replica != _current_replica():
            return False
        return True


def parse_faults(text: str) -> List[FaultSpec]:
    """Parse the grammar; malformed specs are skipped (a typo in a fault
    var should never take down a real run)."""
    specs: List[FaultSpec] = []
    for raw in text.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        fields = [f.strip() for f in raw.split("@")]
        kind, _, target = fields[0].lower().partition(":")
        if kind not in _KINDS:
            continue
        replica, arg = None, None
        if kind in _REPLICA_KINDS:
            try:
                replica = int(target)
            except ValueError:
                continue               # replica kinds require a target
        elif kind in _ARG_KINDS:
            try:
                arg = float(target)
            except ValueError:
                continue               # arg kinds require a value
        elif target:
            continue                   # "sigterm:3" is not grammar
        site, at_step, attempt = "step", None, None
        ok = True
        for field in fields[1:]:
            name, _, value = field.partition(":")
            name = name.lower()
            if name in _SITES:
                site = name
                if value:
                    try:
                        at_step = int(value)
                    except ValueError:
                        ok = False
            elif name == "attempt":
                try:
                    attempt = int(value)
                except ValueError:
                    ok = False
            else:
                ok = False
        if ok:
            specs.append(FaultSpec(kind, site, at_step, attempt, replica,
                                   arg))
    return specs


def chaos_schedule(text: str) -> str:
    """Compile ``DLTPU_CHAOS="<seed>:<token>;<token>..."`` into a
    regular-grammar fault string. Each token is
    ``kind[:target]*count@lo-hi`` (``count`` defaults to 1, range to
    ``0-0``); kinds: ``e503``, ``latency:<ms>``, ``wedge:<i>``,
    ``preempt:<i>``, ``crash:<i>``. Pure and deterministic — one
    ``random.Random(seed)`` consumed in token order, so the same seed
    yields a byte-identical schedule on every run (replayable chaos).
    Malformed input compiles to ``""``, never raises."""
    seed_s, sep, body = text.partition(":")
    if not sep:
        return ""
    try:
        rng = random.Random(int(seed_s))
    except ValueError:
        return ""
    out: List[str] = []
    for token in body.split(";"):
        token = token.strip()
        if not token:
            continue
        head, _, rng_s = token.partition("@")
        name, _, count_s = head.partition("*")
        kind, _, target = name.strip().lower().partition(":")
        if kind not in _CHAOS_KINDS:
            continue
        real_kind, site = _CHAOS_KINDS[kind]
        if real_kind in _REPLICA_KINDS or real_kind in _ARG_KINDS:
            if not target:
                continue               # wedge/preempt/crash/latency need one
            real_kind = f"{real_kind}:{target}"
        elif target:
            continue
        try:
            count = int(count_s) if count_s else 1
            lo_s, _, hi_s = (rng_s or "0-0").partition("-")
            lo, hi = int(lo_s), int(hi_s or lo_s)
        except ValueError:
            continue
        if count < 1 or hi < lo:
            continue
        steps = sorted(rng.randint(lo, hi) for _ in range(count))
        out.extend(f"{real_kind}@{site}:{s}" for s in steps)
    return ";".join(out)


_SPECS: Optional[List[FaultSpec]] = None


def active_faults() -> List[FaultSpec]:
    global _SPECS
    if _SPECS is None:
        specs = parse_faults(os.environ.get(ENV_VAR, ""))
        chaos = os.environ.get(CHAOS_VAR, "")
        if chaos:
            specs.extend(parse_faults(chaos_schedule(chaos)))
        _SPECS = specs
    return _SPECS


def reset() -> None:
    """Forget parsed state so tests can re-point DLTPU_FAULTS."""
    global _SPECS
    _SPECS = None


def current_attempt() -> int:
    try:
        return int(os.environ.get(ATTEMPT_VAR, "0"))
    except ValueError:
        return 0


def _current_replica() -> int:
    try:
        return int(os.environ.get(REPLICA_VAR, "0"))
    except ValueError:
        return 0


def maybe_fire(site: str, step: int = 0) -> None:
    """Fire the first matching un-fired fault for this site, if any."""
    specs = active_faults()
    if not specs:
        return
    attempt = current_attempt()
    for spec in specs:
        if spec.kind in _CONSUMED_KINDS:
            continue
        if not spec.matches(site, step, attempt):
            continue
        spec.fired = True
        _fire(spec, step)
        return


def _consume_spec(kind: str, site: str, step: int) -> Optional[FaultSpec]:
    specs = active_faults()
    if not specs:
        return None
    attempt = current_attempt()
    for spec in specs:
        if spec.kind != kind or not spec.matches(site, step, attempt):
            continue
        spec.fired = True
        from ..obs import flight
        flight.record("fault_injected", fault=repr(spec), step=int(step))
        return spec
    return None


def consume(kind: str, site: str, step: int = 0) -> bool:
    """Poll-style faults: True once when a matching un-fired spec of
    ``kind`` exists — the CALLER owns the effect (poison params, raise a
    decode error, garble a step dir), so the fault flows through the
    same code path a real failure would."""
    return _consume_spec(kind, site, step) is not None


def consume_arg(kind: str, site: str, step: int = 0) -> Optional[float]:
    """Like :func:`consume` for arg-carrying kinds (``latency:<ms>``):
    returns the spec's numeric argument once, ``None`` when nothing
    matches."""
    spec = _consume_spec(kind, site, step)
    if spec is None:
        return None
    return spec.arg if spec.arg is not None else 0.0


def corrupt_checkpoint(directory: str, step: int,
                       n_files: int = 1) -> List[str]:
    """Garble the largest file(s) of a COMMITTED checkpoint step dir
    (bit-flip a chunk in the middle) — the ``ckpt_corrupt`` fault's
    effect, applied after the write lands so Orbax's atomic-rename
    commit sees nothing. Returns the paths touched."""
    root = os.path.join(directory, str(step))
    candidates = []
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            if size > 0:
                candidates.append((size, path))
    candidates.sort(reverse=True)
    hit = []
    for size, path in candidates[:max(int(n_files), 1)]:
        with open(path, "r+b") as f:
            f.seek(size // 2)
            chunk = f.read(min(64, size - size // 2)) or b"\x00"
            f.seek(size // 2)
            f.write(bytes(b ^ 0xFF for b in chunk))
        hit.append(path)
    return hit


def _fire(spec: FaultSpec, step: int) -> None:
    from ..obs import flight
    flight.record("fault_injected", fault=repr(spec), step=int(step))
    if spec.kind in ("sigterm", "sigint"):
        signum = signal.SIGTERM if spec.kind == "sigterm" else signal.SIGINT
        # deliver through the kernel: the registry's dispatcher, the
        # flight hook, and the preemption guard all run for real
        os.kill(os.getpid(), signum)
        return
    if spec.kind == "crash":
        raise InjectedCrash(f"injected fault {spec!r} at step {step}")
    if spec.kind == "wedge":
        # simulate a blocked device transfer: the main thread stalls,
        # daemon threads (heartbeat writer) stay alive — the supervisor
        # must notice the frozen step/activity watermarks and kill us.
        deadline = time.monotonic() + WEDGE_SLEEP_S
        while time.monotonic() < deadline:
            time.sleep(0.5)
