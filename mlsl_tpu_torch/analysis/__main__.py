"""CLI for the static-analysis passes: the pre-commit gate.

Counterpart of ``mlsl_tpu.analysis.__main__``. Usage::

    python -m mlsl_tpu_torch.analysis                 # lint + lock analysis
    python -m mlsl_tpu_torch.analysis --lint --root . # lint an arbitrary tree
    python -m mlsl_tpu_torch.analysis --graph         # build + verify a demo
                                                      # graph on the card
    python -m mlsl_tpu_torch.analysis --graph --device cpu
    python -m mlsl_tpu_torch.analysis --concurrency   # lock analyzer +
                                                      # protocol model checker
    python -m mlsl_tpu_torch.analysis --json          # machine-readable

Exits nonzero when any error-severity finding survives — wire it as a
pre-commit hook. ``--concurrency`` is stricter: it exits nonzero on *any*
finding, warnings included, because its consumers treat an unproven
interleaving as a failure. ``--graph`` builds its graph on the card unless
``--device cpu`` asks for the CPU; without a card and without the flag the
Environment refuses to start and the command exits nonzero.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def _demo_graph_report(device: Optional[str] = None):
    """Build a small representative committed graph (a 3-layer net with a
    plain, a quantized, and a ZeRO-1 parameter set over 8 virtual ranks) on
    ``device`` (None: the card) and run the plan verifier over it — the
    ``--graph`` smoke path that exercises every pass a real commit would."""
    from mlsl_tpu_torch.analysis import plan as plan_mod
    from mlsl_tpu_torch.core.environment import Environment
    from mlsl_tpu_torch.types import CompressionType, OpType

    env = Environment.get_env().init(device=device, world_size=8)
    try:
        n = env.get_process_count()
        dist = env.create_distribution(n, 1)
        s = env.create_session()
        s.set_global_minibatch_size(max(8, n))
        prev = None
        for i, (comp, du) in enumerate([
            (CompressionType.NONE, False),
            (CompressionType.QUANTIZATION, False),
            (CompressionType.NONE, True),
        ]):
            r = s.create_operation_reg_info(OpType.CC)
            r.set_name(f"demo{i}")
            if i:
                r.add_input(8, 4)
            r.add_output(8, 4)
            r.add_parameter_set(256, 4, distributed_update=du,
                                compression_type=comp)
            op = s.get_operation(s.add_operation(r, dist))
            if prev is not None:
                prev.set_next(op, 0, 0)
            prev = op
        s.commit()
        from mlsl_tpu_torch.analysis.diagnostics import record

        rep = plan_mod.verify_session(s)
        record(rep)
        return rep
    finally:
        env.finalize()


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mlsl_tpu_torch.analysis",
        description="MLSL static analysis: plan verifier + concurrency "
                    "linter (exit 1 on error-severity findings)",
    )
    p.add_argument("--lint", action="store_true",
                   help="run the AST linter (the default when no pass is "
                        "selected)")
    p.add_argument("--graph", action="store_true",
                   help="build a representative demo graph and run the "
                        "commit-time plan verifier over it")
    p.add_argument("--device", default=None,
                   help="--graph's device: the card unless 'cpu' is asked "
                        "for")
    p.add_argument("--concurrency", action="store_true",
                   help="run the lock-order analyzer and the protocol model "
                        "checker only (exit 1 on ANY finding, warnings "
                        "included)")
    p.add_argument("--root", default=None,
                   help="lint root (default: the installed mlsl_tpu_torch "
                        "package)")
    p.add_argument("--json", action="store_true",
                   help="emit findings as JSON")
    p.add_argument("--codes", action="store_true",
                   help="print the diagnostic-code table and exit")
    args = p.parse_args(argv)

    from mlsl_tpu_torch.analysis.diagnostics import CODES, Report, record

    if args.codes:
        for code, (sev, title) in sorted(CODES.items()):
            print(f"{code}  {sev:<5}  {title}")
        return 0

    reports: List[Report] = []
    if args.lint or not (args.graph or args.concurrency):
        from mlsl_tpu_torch.analysis import lint, locks

        rep = lint.lint_tree(args.root)
        record(rep)
        reports.append(rep)
        # the lint gate includes the whole-package lockset/lock-order pass:
        # the commit bar is 0 errors across BOTH
        lrep = locks.analyze_tree(args.root)
        record(lrep)
        reports.append(lrep)
    if args.concurrency:
        from mlsl_tpu_torch.analysis import locks, protocol

        lrep = locks.analyze_tree(args.root)
        record(lrep)
        reports.append(lrep)
        prep = protocol.check_protocols()
        record(prep)
        reports.append(prep)
    if args.graph:
        reports.append(_demo_graph_report(args.device))

    rc = 0
    for rep in reports:
        if args.json:
            print(rep.to_json())
        elif rep.diagnostics:
            print(rep.format())
        print(rep.summary(), file=sys.stderr)
        if rep.errors:
            rc = 1
        elif args.concurrency and rep.diagnostics:
            rc = 1  # --concurrency: warnings fail too
    return rc


if __name__ == "__main__":
    sys.exit(main())
