"""The port's run supervisor (deeplearning_tpu_torch/elastic/supervisor.py)
and its CLI (``python -m deeplearning_tpu_torch.supervise``) vs the JAX
package's (deeplearning_tpu/elastic/supervisor.py, tools/supervise.py),
on the CPU.

Held against JAX: the backoff schedule and delays from one seed, the
outcome classification, the crash budget's decision log (JAX's
test_crash_exhausts_budget), the stop / restart directives and the
``on_outcome`` hints (event kinds and fields of
``flightrec_supervisor.json``), and the fleet mode's classified exit.
End to end, the supervise CLI runs the port's own train CLI on
configs/mnist_smoke.yaml through a preemption, a wedge and a resume.

The children are small: ``python -c`` one-liners, and the train CLI on
one torch thread with TensorBoard's import blocked (importing it pulls in
TensorFlow here, seconds a launch). Every subprocess and every supervisor
run has a timeout of its own, so a hang fails fast.
"""

import importlib.util
import json
import os
import random
import re
import signal
import subprocess
import sys
import threading
import time

import pytest

from deeplearning_tpu.elastic import supervisor as jsup
from deeplearning_tpu_torch import supervise as tsupervise
from deeplearning_tpu_torch.core.checkpoint import CheckpointManager
from deeplearning_tpu_torch.elastic import EXIT_PREEMPTED
from deeplearning_tpu_torch.elastic import supervisor as tsup

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PY = sys.executable
RUN_TIMEOUT_S = 60.0


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_supervise", os.path.join(ROOT, "tools", "supervise.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bounded(fn, before=None):
    """``fn()`` on a thread, bounded by RUN_TIMEOUT_S; ``before()`` runs
    beside it. Returns what ``fn`` returned."""
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("rc", fn()),
                         daemon=True)
    t.start()
    if before is not None:
        before()
    t.join(RUN_TIMEOUT_S)
    assert not t.is_alive(), "the supervisor did not finish in time"
    return out["rc"]


def _run(sup, before=None):
    """``sup.run()``, bounded; ``before(sup)`` runs beside it."""
    return _bounded(sup.run, before and (lambda: before(sup)))


def _log(workdir):
    with open(os.path.join(workdir, "flightrec_supervisor.json")) as f:
        return json.load(f)


def _shape(rec):
    """The decision log without times and pids: each event's kind and its
    field names, and the dump's reason."""
    return rec["reason"], [(e["kind"], sorted(set(e) - {"time"}))
                           for e in rec["events"]]


def _cfg(mod, argv, workdir, **kw):
    base = dict(workdir=str(workdir), poll_s=0.05, startup_deadline_s=60.0,
                backoff_base_s=0.05, backoff_max_s=0.1, kill_grace_s=1.0,
                seed=0)
    base.update(kw)
    return mod.SupervisorConfig(argv, **base)


def _both(tmp_path, argv, before=None, hint=None, **kw):
    """The same supervised run under JAX's and the port's Supervisor:
    (rc, outcomes, decision log, supervisor) of each."""
    runs = []
    for name, mod in (("jax", jsup), ("port", tsup)):
        sup = mod.Supervisor(_cfg(mod, argv, tmp_path / name, **kw))
        sup.on_outcome = hint
        rc = _run(sup, before)
        runs.append((rc, sup.outcomes, _log(tmp_path / name), sup))
    return runs


# ------------------------------------------------------ pure functions
def test_backoff_and_classification_equal_jaxs():
    assert tsup.OUTCOME_SEVERITY == jsup.OUTCOME_SEVERITY
    assert tsup.EXIT_WEDGED == jsup.EXIT_WEDGED == 70
    for attempt in range(1, 12):
        kw = dict(base_s=0.5, factor=2.0, max_s=4.0, jitter=0.25)
        assert tsup.backoff_schedule(
            attempt, rng=random.Random(attempt), **kw) == \
            jsup.backoff_schedule(attempt, rng=random.Random(attempt), **kw)
    knobs = dict(backoff_base_s=0.5, backoff_factor=3.0, backoff_max_s=7.0,
                 backoff_jitter=0.25)
    tcfg = tsup.SupervisorConfig(["x"], **knobs)
    jcfg = jsup.SupervisorConfig(["x"], **knobs)
    trng, jrng = random.Random(5), random.Random(5)
    got = [tsup.backoff_delay(a, tcfg, trng) for a in range(1, 9)]
    want = [jsup.backoff_delay(a, jcfg, jrng) for a in range(1, 9)]
    assert got == want
    assert all(lo <= d <= lo * 1.25 for d, lo in
               zip(got, [0.5, 1.5, 4.5, 7.0, 7.0, 7.0, 7.0, 7.0]))
    labels = ["completed", "stopped", "preempted", "wedged", "crashed",
              "requeued", "mystery"]
    for a in labels:
        assert tsup.exit_for_outcome(a) == jsup.exit_for_outcome(a)
        for b in labels:
            assert tsup.worst_outcome([a, b]) == jsup.worst_outcome([a, b])
    assert tsup.worst_outcome([]) == jsup.worst_outcome([]) == "completed"
    assert tsup.exit_for_outcome("preempted") == EXIT_PREEMPTED


# ------------------------------------------------ supervised children
def test_crash_exhausts_budget(tmp_path):
    """JAX's test_crash_exhausts_budget, with JAX's event log beside."""
    (jrc, jout, jrec, _), (rc, out, rec, sup) = _both(
        tmp_path, [PY, "-c", "import sys; sys.exit(7)"], max_restarts=1)
    assert rc == jrc == 7
    assert out == jout == ["crashed", "crashed"]
    assert rec["reason"] == "gave_up" and rec["hbm"] is None
    kinds = [e["kind"] for e in rec["events"]]
    assert kinds.count("launch") == 2
    assert kinds.count("backoff") == 1
    assert kinds[-1] == "gave_up"
    assert _shape(rec) == _shape(jrec)
    assert sup.final_outcome == "crashed" and sup.backoff_total_s > 0


def _after_first_launch(verb):
    def before(sup):
        deadline = time.monotonic() + RUN_TIMEOUT_S
        while sup.launches < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.2)
        getattr(sup, verb)("test")
    return before


def test_stop_and_restart_directives(tmp_path):
    """A stop directive kills the child and ends the run with 0; a
    restart directive requeues it at once, with the next attempt number
    and no backoff or budget spent."""
    sleeper = [PY, "-c", "import time; time.sleep(30)"]
    runs = _both(tmp_path / "stop", sleeper,
                 _after_first_launch("request_stop"), max_restarts=0)
    (jrc, jout, jrec, _), (rc, out, rec, sup) = runs
    assert rc == jrc == 0 and out == jout == ["stopped"]
    assert sup.final_outcome == "stopped"
    assert [e["kind"] for e in rec["events"]] == ["launch", "stopped"]
    assert _shape(rec) == _shape(jrec)
    second = [PY, "-c", "import os, sys, time; "
              "sys.exit(0) if os.environ['DLTPU_RESTART_ATTEMPT'] == '1' "
              "else time.sleep(30)"]
    runs = _both(tmp_path / "restart", second,
                 _after_first_launch("request_restart"), max_restarts=0)
    (jrc, jout, jrec, _), (rc, out, rec, sup) = runs
    assert rc == jrc == 0 and out == jout == ["requeued", "completed"]
    assert [e["kind"] for e in rec["events"]] == [
        "launch", "requeue", "launch", "child_exit", "completed"]
    assert [e["attempt"] for e in rec["events"][:3]] == [0, 0, 1]
    assert sup.backoff_total_s == 0
    assert _shape(rec) == _shape(jrec)


@pytest.mark.parametrize("hint", ["requeue_now", "stop"])
def test_on_outcome_hint(tmp_path, hint):
    """``on_outcome`` sees each natural ending: ``requeue_now`` relaunches
    with no backoff and no budget spent, ``stop`` sheds the run cleanly."""
    argv = [PY, "-c", "import os, sys; "
            "sys.exit(75 if os.environ['DLTPU_RESTART_ATTEMPT'] == '0' "
            "else 0)"]
    seen = []

    def policy(sup, outcome, attempt, rc):
        seen.append((outcome, attempt, rc))
        return hint if outcome == "preempted" else None
    (jrc, jout, jrec, _), (rc, out, rec, sup) = _both(
        tmp_path, argv, hint=policy, max_restarts=0)
    assert rc == jrc == 0 and out == jout
    assert _shape(rec) == _shape(jrec)
    assert sup.backoff_total_s == 0
    if hint == "stop":
        assert out == ["preempted"] and sup.final_outcome == "stopped"
        assert rec["reason"] == "shed_after_preempted"
        assert seen == [("preempted", 0, 75)] * 2     # JAX's, then ours
    else:
        assert out == ["preempted", "completed"]
        assert [e["kind"] for e in rec["events"]] == [
            "launch", "child_exit", "requeue", "launch", "child_exit",
            "completed"]
        assert seen == [("preempted", 0, 75), ("completed", 1, 0)] * 2


def test_fleet_mode_classifies_the_exit(tmp_path, capsys):
    """``--replicas 2``: replica 0 is preempted, replica 1 crashes; the
    fleet exits 1 (a crash outranks a preemption, though 75 > 1), as
    tools/supervise.py does on the same command."""
    child = [PY, "-c", "import os, sys; "
             "sys.exit(75 if os.environ['DLTPU_REPLICA'] == '0' else 7)"]
    rcs, lines = [], []
    for main in (_jax_cli().main, tsupervise.main):
        work = tmp_path / str(len(rcs))
        argv = ["--replicas", "2", "--run-id", "r1", "--workdir",
                str(work), "--max-restarts", "0", "--", *child]
        rcs.append(_bounded(lambda: main(argv)))
        err = capsys.readouterr().err
        lines.append([ln for ln in err.splitlines()
                      if ln.startswith("[supervise] replica")
                      or "fleet done" in ln])
        assert _log(work / "replica-1")["reason"] == "gave_up"
    assert rcs == [1, 1]
    assert lines[0] == lines[1] == [
        "[supervise] replica 0: preempted (rc=75)",
        "[supervise] replica 1: crashed (rc=7)",
        "[supervise] fleet done run_id=r1 worst=crashed exit=1"]


def test_controller_mode_raises_naming_its_item():
    with pytest.raises(ValueError, match="8d2"):
        tsupervise.main(["--controller", "--", PY, "-c", "pass"])


# -------------------------------------- the train CLI, end to end
# python -m deeplearning_tpu_torch.train, with TensorBoard's import blocked
CHILD = [PY, "-c",
         "import runpy, sys; sys.modules['torch.utils.tensorboard'] = None; "
         "runpy.run_module('deeplearning_tpu_torch.train', "
         "run_name='__main__', alter_sys=True)"]
EPOCH = 8                             # steps an epoch (2 epochs)
PREEMPT_AT, WEDGE_AT = 3, 12
WEDGE_DEADLINE_S = 6.0


def test_train_cli_preempted_wedged_and_resumed(tmp_path):
    """The supervise CLI around the port's train CLI (mnist_smoke.yaml,
    batch 8, 64 images: 8 steps an epoch, 2 epochs): attempt 0 is
    preempted at step 3 and exits 75 after its checkpoint; attempt 1
    resumes there and reruns that epoch whole (the Trainer resumes at an
    epoch's start), checkpoints at its end (step 11) and wedges at step
    12, and is killed once neither its step nor its activity moved for
    the deadline; attempt 2 resumes from step 11 and finishes the last
    epoch. Each resume starts at a checkpoint whose CRCs were recorded
    when it was written and that the restore verified."""
    work = tmp_path / "sup"
    run = tmp_path / "run"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               DLTPU_FAULTS=f"sigterm@step:{PREEMPT_AT}@attempt:0;"
                            f"wedge@step:{WEDGE_AT}@attempt:1")
    cmd = [PY, "-m", "deeplearning_tpu_torch.supervise",
           "--workdir", str(work), "--max-restarts", "4",
           "--wedge-deadline", str(WEDGE_DEADLINE_S),
           "--startup-deadline", "90", "--kill-grace", "1",
           "--backoff-base", "0.1", "--backoff-max", "0.3", "--",
           *CHILD, "--cfg", "configs/mnist_smoke.yaml", "train.device=cpu",
           "data.n_train=64", "data.global_batch=8", "train.epochs=2",
           f"train.workdir={run}"]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, start_new_session=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        out, err = proc.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        pytest.fail(f"the supervised run hung:\n{err[-3000:]}")
    assert proc.returncode == 0, err[-3000:]
    rec = _log(work)
    assert rec["reason"] == "completed" and rec["hbm"] is None
    events = rec["events"]
    kinds = [e["kind"] for e in events]
    assert kinds.count("launch") == 3
    assert kinds.count("wedge_kill") == 1
    assert kinds.count("backoff") == 2
    exits = [e for e in events if e["kind"] == "child_exit"]
    assert [e["outcome"] for e in exits] == ["preempted", "completed"]
    assert exits[0]["returncode"] == EXIT_PREEMPTED
    outcomes = [e["outcome"] for e in events
                if e["kind"] in ("child_exit", "backoff")]
    assert outcomes == ["preempted", "preempted", "wedged", "completed"]
    launch_1 = [e for e in events
                if e["kind"] == "launch" and e["attempt"] == 1][0]
    wedge = [e for e in events if e["kind"] == "wedge_kill"][0]
    assert wedge["attempt"] == 1
    assert wedge["time"] - launch_1["time"] < 60.0

    log = (run / "log_p0.txt").read_text()
    resumes = [int(s) for s in re.findall(r"auto-resume from step (\d+)",
                                          log)]
    assert resumes == [PREEMPT_AT, PREEMPT_AT + EPOCH]
    assert "failed integrity check" not in log
    ckpt = CheckpointManager(str(run / "ckpt"))
    recorded = ckpt._read_checksum_file()
    assert all(str(s) in recorded for s in resumes)
    final = resumes[-1] + EPOCH
    assert ckpt.latest_step() == final and ckpt.verify_step(final)
    assert ckpt.verify_step(resumes[-1])
    assert "top1" in out.strip().splitlines()[-1]
