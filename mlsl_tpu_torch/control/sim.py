"""Multi-process pod simulation worker: ``python -m mlsl_tpu_torch.control.sim``.

Counterpart of ``mlsl_tpu.control.sim``. One OS process = one pod member. N
of these form a real cross-process control plane over localhost TCP -- real
sockets, real SIGKILL, real miss-budget detection -- while the "training" is
a deterministic host loop: the control plane is the only cross-process
fabric, which is exactly the layer under test. Each member initializes an
Environment on the card; ``--device cpu`` asks for the CPU (the worker never
falls back to it on its own: without a card and without the flag,
``Environment.init`` raises and the worker exits non-zero). The training-loop
integration (FaultTolerantLoop and the elastic shrink over virtual ranks) is
driven in-process by tests/test_torch_control.py and by ``chip_smoke.py``'s
run (ab4).

Configuration comes from the standard env knobs (MLSL_CONTROL_PORT/
MLSL_CONTROL_WORLD/MLSL_CONTROL_RANK, MLSL_HEARTBEAT_*,
MLSL_PREEMPTION_FILE, MLSL_ELASTIC) through the normal
``Environment.init()`` arming path. Machine-readable stdout protocol::

    READY rank=0 world=3 pid=1234 http=40123
    STEP rank=0 step=7 loss=0.740741
    EVENT rank=0 kind=commit epoch=1 dead=2 survivors=0,1 leader=0
    DRAIN rank=0 mode=shrink target=1 epoch=2
    DRAINED rank=1 mode=shrink step=12
    EXIT rank=0 step=40 epoch=2 alive=0,1
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _fmt_event(rank: int, ev: dict) -> str:
    dead = ",".join(map(str, ev.get("dead", []))) or "-"
    surv = ",".join(map(str, ev.get("survivors", [])))
    return (
        f"EVENT rank={rank} kind={ev['kind']} epoch={ev['epoch']} "
        f"dead={dead} survivors={surv} leader={ev.get('leader')}"
        + (f" mode={ev['mode']} target={ev['rank']}"
           if ev["kind"] == "drain" else "")
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--steps", type=int, default=200,
                    help="host training steps to run")
    ap.add_argument("--step-s", type=float, default=0.02,
                    help="wall time per simulated step")
    ap.add_argument("--dir", default="",
                    help="rendezvous dir: rank<r>.{pid,port,state} files")
    ap.add_argument("--device", default="cuda",
                    help="the Environment's device: the card unless 'cpu' is asked for")
    args = ap.parse_args(argv)

    from mlsl_tpu_torch import control, supervisor
    from mlsl_tpu_torch.core.environment import Environment
    from mlsl_tpu_torch.obs import serve
    from mlsl_tpu_torch.resilience import PreemptionGuard

    env = Environment.get_env().init(device=args.device)
    plane = control.get_active()
    if plane is None:
        print("ERROR control plane not armed (set MLSL_CONTROL_PORT/"
              "MLSL_CONTROL_WORLD/MLSL_CONTROL_RANK)", flush=True)
        return 2
    rank = plane.rank
    # scrape surface on an ephemeral port (collision-free N-per-host); the
    # bound port lands in the rendezvous dir for the harness to read back
    srv = serve.get_server() or serve.start_server(port=0)
    if args.dir:
        os.makedirs(args.dir, exist_ok=True)
        with open(os.path.join(args.dir, f"rank{rank}.pid"), "w") as f:
            f.write(str(os.getpid()))
        with open(os.path.join(args.dir, f"rank{rank}.port"), "w") as f:
            f.write(str(srv.port if srv is not None else 0))
    print(f"READY rank={rank} world={plane.world} pid={os.getpid()} "
          f"http={srv.port if srv is not None else 0}", flush=True)

    loss = 1.0
    step = 0
    events_seen = 0
    rc = 0
    with PreemptionGuard() as guard:
        while step < args.steps:
            time.sleep(args.step_s)  # the "training step" (host-only)
            loss = 1.0 / (1.0 + 0.05 * step)
            plane.push_status(supervisor.status(), step=step,
                              step_ms=args.step_s * 1e3)
            print(f"STEP rank={rank} step={step} loss={loss:.6f}",
                  flush=True)
            # committed membership losses: label-only device map here, so
            # take_loss records the pod transition without a local error
            fault = plane.take_loss()
            if fault is not None:  # pragma: no cover - label-only maps
                print(f"FAULT rank={rank} {fault}", flush=True)
            evs = list(plane.events)
            for ev in evs[events_seen:]:
                print(_fmt_event(rank, ev), flush=True)
            events_seen = len(evs)

            drain = plane.take_drain()
            if guard.triggered and drain is None:
                # the coordinated path: SIGTERM becomes a structured notice;
                # the pod answers with ONE decision (or we time out and
                # drain locally — a partitioned leader must not hang us)
                drain = plane.coordinate_preemption("sigterm")
            if drain is not None:
                print(f"DRAIN rank={rank} mode={drain['mode']} "
                      f"target={drain['rank']} epoch={drain['epoch']}",
                      flush=True)
                if drain["mode"] == "save" or drain["rank"] == rank:
                    # our part of the pod drain: a verified save of the
                    # host state (the sim's checkpoint analog)
                    if args.dir:
                        with open(os.path.join(
                                args.dir, f"rank{rank}.state"), "w") as f:
                            f.write(f"step={step} loss={loss:.6f}\n")
                    plane.record_drain_executed(step, drain["mode"])
                    print(f"DRAINED rank={rank} mode={drain['mode']} "
                          f"step={step}", flush=True)
                    break
                # a shrink aimed at another rank: the survivors' business —
                # keep stepping on the shrunken pod
            elif guard.triggered:
                print(f"DRAINED rank={rank} mode=local step={step}",
                      flush=True)
                break
            step += 1
    st = plane.status()
    print(f"EXIT rank={rank} step={step} epoch={st['epoch']} "
          f"alive={','.join(map(str, st['alive']))}", flush=True)
    plane.stop()
    env.finalize()
    return rc


if __name__ == "__main__":
    sys.exit(main())
