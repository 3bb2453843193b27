"""Supervised training launcher of the port — the counterpart of
``tools/supervise.py``: restart on preemption, crash or wedge, with
backoff.

  python -m deeplearning_tpu_torch.supervise [options] -- \\
      python -m deeplearning_tpu_torch.train --cfg configs/vit_b16_imagenet.yaml \\
      train.workdir=runs/vit train.async_checkpoint=true

Wraps any training command in ``elastic.supervisor.Supervisor``: launches
it, watches the heartbeat file the Trainer writes (``DLTPU_HEARTBEAT`` is
exported to the child), tells slow from wedged, kills and requeues on
preemption (exit 75) / crash / wedge under a bounded restart budget, and
records every decision to ``<workdir>/flightrec_supervisor.json``. The
training command must checkpoint into a stable workdir: the resume is the
child's own (the Trainer's auto-resume); the supervisor only restarts it.
The supervisor process imports no torch and never touches the card.

Fleet mode (``--replicas N``, or a ``--run-id``): N copies of the command,
each under its own Supervisor thread in ``<workdir>/replica-<i>/``, all
sharing one ``DLTPU_RUN_ID`` and each handed its ``DLTPU_REPLICA`` index
and ``DLTPU_ENDPOINT_FILE``. The exit code is CLASSIFIED, not
``max(rcs)``: crash > wedge > preempted > clean (raw 75 would outrank a
crash's 1), with the per-replica breakdown printed.

``--controller`` (the elastic fleet: autoscaling, drain-and-requeue,
warm standbys) needs the fleet controller, which comes with ROADMAP Queue
1 item 8d2; until then it raises ``ValueError``.
"""

from __future__ import annotations

import argparse
import os
import sys
import uuid

from .elastic.supervisor import (Supervisor, SupervisorConfig,
                                 exit_for_outcome, worst_outcome)
from .obs import threads as obs_threads


def _classified_exit(outcomes, rcs, run_id) -> int:
    """Fleet verdict: per-replica breakdown + one classified exit."""
    labels = {}
    for i in sorted(outcomes):
        labels[i] = outcomes[i] or ("completed" if not rcs.get(i)
                                    else "crashed")
    worst = worst_outcome(list(labels.values()) or ["crashed"])
    rc = exit_for_outcome(worst)
    for line in ([f"replica {i}: {labels[i]} (rc={rcs.get(i)})"
                  for i in sorted(labels)]
                 + [f"fleet done run_id={run_id} worst={worst} exit={rc}"]):
        print(f"[supervise] {line}", file=sys.stderr)
    return rc


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workdir", default="runs/supervised",
                        help="supervisor state dir (heartbeat + "
                             "flightrec_supervisor.json)")
    parser.add_argument("--max-restarts", type=int, default=5,
                        help="restart budget across preemptions, "
                             "crashes, and wedge kills")
    parser.add_argument("--wedge-deadline", type=float, default=120.0,
                        help="seconds with neither step nor activity "
                             "progress before the child counts as wedged")
    parser.add_argument("--startup-deadline", type=float, default=600.0,
                        help="seconds to wait for the first heartbeat "
                             "(covers imports, the kernels' build and "
                             "the first step)")
    parser.add_argument("--backoff-base", type=float, default=1.0)
    parser.add_argument("--backoff-factor", type=float, default=2.0)
    parser.add_argument("--backoff-max", type=float, default=60.0)
    parser.add_argument("--kill-grace", type=float, default=10.0,
                        help="seconds between SIGTERM and SIGKILL when "
                             "killing a wedged child")
    parser.add_argument("--replicas", type=int, default=1,
                        help="launch N supervised replicas of the "
                             "command under one run id (fleet mode)")
    parser.add_argument("--run-id", default=None,
                        help="fleet run id (default: random); exported "
                             "to children as DLTPU_RUN_ID")
    parser.add_argument("--controller", action="store_true",
                        help="closed-loop fleet controller (ROADMAP "
                             "Queue 1 item 8d2; raises until then)")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="training command (prefix with --)")
    args = parser.parse_args(argv)

    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        parser.error("no training command given (put it after --)")
    if args.replicas < 1:
        parser.error("--replicas must be >= 1")
    if args.controller:
        raise ValueError(
            "--controller needs the fleet controller (fleet/* and "
            "obs/fleet.py), which the port gains with ROADMAP Queue 1 "
            "item 8d2; run --replicas N without it")

    def build_cfg(workdir: str, run_id, replica) -> SupervisorConfig:
        return SupervisorConfig(
            command,
            workdir=workdir,
            max_restarts=args.max_restarts,
            wedge_deadline_s=args.wedge_deadline,
            startup_deadline_s=args.startup_deadline,
            backoff_base_s=args.backoff_base,
            backoff_factor=args.backoff_factor,
            backoff_max_s=args.backoff_max,
            kill_grace_s=args.kill_grace,
            run_id=run_id,
            replica=replica,
        )

    if args.replicas == 1 and args.run_id is None:
        return Supervisor(build_cfg(args.workdir, None, None)).run()

    run_id = args.run_id or f"run-{uuid.uuid4().hex[:8]}"
    print(f"[supervise] fleet run_id={run_id} "
          f"replicas={args.replicas} workdir={args.workdir}",
          file=sys.stderr)
    rcs = {i: 1 for i in range(args.replicas)}
    sups = {}

    def _one(i: int) -> None:
        cfg = build_cfg(os.path.join(args.workdir, f"replica-{i}"),
                        run_id, i)
        sups[i] = Supervisor(cfg)
        try:
            rcs[i] = sups[i].run()
        except Exception as e:  # noqa: BLE001 - one replica's failure
            print(f"[supervise] replica {i} supervisor died: {e!r}",
                  file=sys.stderr)
            rcs[i] = 1

    # non-daemon on purpose: the fleet result is the join below
    threads = [obs_threads.spawn(_one, args=(i,), name=f"supervise-{i}",
                                 daemon=False, start=False)
               for i in range(args.replicas)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    outcomes = {i: (sups[i].final_outcome if i in sups else None)
                for i in range(args.replicas)}
    return _classified_exit(outcomes, rcs, run_id)


if __name__ == "__main__":
    raise SystemExit(main())
