"""Shared structured-diagnostic format for the static-analysis passes.

Counterpart of ``mlsl_tpu.analysis.diagnostics``, by adapted copy: the same
codes, severities and titles, so that both packages' findings compare as
``(code, anchor)`` sets. Where a code's title names the TPU (``lax``, VMEM,
Pallas semaphores), the port's pass checks the card's counterpart: see the
module docstrings of ``plan`` and ``lint``.

Both passes — the commit-time plan verifier (``analysis/plan.py``) and the
project concurrency linter (``analysis/lint.py``) — emit the same record: a
stable ``MLSL-Axxx`` code, an ``error``/``warn`` severity, a one-line message,
and an anchor (``file.py:line`` for source findings, ``graph:<node>`` for
committed-graph findings). Stability contract: codes are append-only — a code
never changes meaning, fixtures and docs pin against them
(tests/fixtures/analysis/, docs/DESIGN.md "Static analysis").

Dependency-free by design (stdlib only): the linter must run in a bare
pre-commit hook without importing torch, and ``Config.validate`` must be able
to name the severity values without dragging the comm stack in.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, Optional, Tuple

ERROR = "error"
WARN = "warn"

#: code -> (default severity, one-line title). The single source for the
#: docs table (docs/DESIGN.md) and the CLI legend; append-only.
CODES: Dict[str, Tuple[str, str]] = {
    # -- plan verifier (A1xx): the committed graph + selection table --------
    "MLSL-A101": (ERROR, "collective issue order can invert across ranks on "
                         "overlapping process groups (deferral window) — the "
                         "cross-replica deadlock class"),
    "MLSL-A102": (ERROR, "worst-case concurrent in-flight collective programs "
                         "exceed the backend budget (the XLA:CPU rendezvous "
                         "wedge class, KNOWN_FAILURES.md)"),
    "MLSL-A103": (WARN,  "in-flight collective programs above half the "
                         "backend budget"),
    "MLSL-A110": (ERROR, "quant block straddles a bucket member slot "
                         "boundary"),
    "MLSL-A111": (ERROR, "coalesced quantized payload is not ring-chunk "
                         "aligned"),
    "MLSL-A112": (ERROR, "error-feedback length disagrees with the "
                         "quant-ring geometry"),
    "MLSL-A113": (ERROR, "quant block straddles a ZeRO-1 shard boundary"),
    "MLSL-A114": (ERROR, "hier compressed-tier block straddles the "
                         "intra-slice shard boundary"),
    "MLSL-A120": (ERROR, "compiled-overlap donation hazard: donated carry "
                         "slot aliased or read after emission"),
    "MLSL-A121": (ERROR, "error-feedback snapshot/rewind machinery is not "
                         "statically paired on a retry/degrade path"),
    "MLSL-A122": (ERROR, "overlap schedule staging violation: a unit cannot "
                         "retire inside its stage window"),
    "MLSL-A130": (ERROR, "pallas ring semaphore signal/wait accounting is "
                         "unbalanced (semaphores do not drain to zero)"),
    "MLSL-A131": (ERROR, "pallas ring slot capacity cannot cover the "
                         "in-flight hop window"),
    "MLSL-A132": (WARN,  "pallas ring VMEM slot-buffer budget estimate "
                         "exceeded"),
    "MLSL-A140": (ERROR, "elastic reshard plan does not cover every ZeRO-1 "
                         "shard element exactly once (gap or overlap)"),
    "MLSL-A141": (ERROR, "elastic reshard target geometry disagrees with "
                         "the survivor world (padded/shard mismatch)"),
    # -- protocol model checker (A15x): exhaustive interleaving exploration
    # -- of the control-plane/elastic state-machine mirrors ------------------
    "MLSL-A150": (ERROR, "reachable deadlock: a protocol state with no "
                         "enabled transition that is not a completed run"),
    "MLSL-A151": (ERROR, "protocol invariant violated (dual coordinator: "
                         "two live ranks hold committed leadership at the "
                         "same epoch)"),
    "MLSL-A152": (ERROR, "lost drain-ack: a completed run where a live "
                         "rank's preemption drain was never acknowledged"),
    "MLSL-A153": (WARN,  "protocol exploration truncated at the state/"
                         "depth bound (verdict covers the prefix only)"),
    # -- AST linter (A2xx): project concurrency/idiom rules -----------------
    "MLSL-A200": (ERROR, "unparseable source file (syntax error: no rule "
                         "can run)"),
    "MLSL-A201": (ERROR, "raw lax collective outside comm/algos/ or an "
                         "allowlisted engine module"),
    "MLSL-A202": (ERROR, "device-program dispatch reachable from a "
                         "threading.Thread target (rendezvous-starvation "
                         "class)"),
    "MLSL-A203": (ERROR, "core/stats counter mutated outside its record_*/"
                         "reset_* helpers"),
    "MLSL-A204": (ERROR, "chaos wrapper missing the _mlsl_inner warm-bypass "
                         "symmetry"),
    "MLSL-A205": (ERROR, "bare except swallows the MLSL error taxonomy"),
    "MLSL-A206": (ERROR, "wall-clock time.time() in retry/backoff/poll math "
                         "(use time.monotonic)"),
    "MLSL-A207": (ERROR, "metrics-registry series internals mutated outside "
                         "the obs/metrics record/observe/sample paths"),
    # -- lockset/lock-order analyzer (A21x): whole-package may-hold-while-
    # -- calling analysis over every Lock/RLock/Condition ---------------------
    "MLSL-A210": (ERROR, "lock-order cycle in the may-hold-while-acquiring "
                         "graph (opposite-order acquisition deadlock)"),
    "MLSL-A211": (ERROR, "lock held across a blocking operation (dispatch, "
                         "no-timeout join/get/put/wait, sleep, socket I/O)"),
    "MLSL-A212": (ERROR, "module-level mutable state written from a thread "
                         "target with no lock held (cross-thread race)"),
    "MLSL-A213": (ERROR, "Condition.wait outside a while loop (spurious "
                         "wakeup runs the body on a stale predicate)"),
    "MLSL-A214": (WARN,  "daemon thread never joined in its module (dies "
                         "mid-critical-section at interpreter exit)"),
}


def normalize_code(code: str) -> str:
    """'A201' and 'MLSL-A201' both name the same diagnostic."""
    code = code.strip()
    return code if code.startswith("MLSL-") else f"MLSL-{code}"


@dataclasses.dataclass
class Diagnostic:
    code: str
    severity: str          # 'error' | 'warn'
    message: str
    anchor: str            # 'path/to/file.py:123' or 'graph:op0/ps1'

    def format(self) -> str:
        return f"{self.anchor}: {self.severity}: {self.code}: {self.message}"


class Report:
    """An ordered collection of diagnostics from one pass run."""

    def __init__(self, kind: str = "analysis"):
        self.kind = kind
        self.diagnostics: List[Diagnostic] = []

    def add(self, code: str, message: str, anchor: str,
            severity: Optional[str] = None) -> Diagnostic:
        code = normalize_code(code)
        if severity is None:
            severity = CODES.get(code, (ERROR, ""))[0]
        d = Diagnostic(code, severity, message, anchor)
        self.diagnostics.append(d)
        return d

    def extend(self, other: "Report") -> "Report":
        self.diagnostics.extend(other.diagnostics)
        return self

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == WARN]

    def codes(self) -> List[str]:
        return sorted({d.code for d in self.diagnostics})

    def format(self) -> str:
        return "\n".join(d.format() for d in self.diagnostics)

    def to_json(self) -> str:
        return json.dumps(
            {"kind": self.kind,
             "findings": [dataclasses.asdict(d) for d in self.diagnostics]},
            indent=2,
        )

    def summary(self) -> str:
        return (f"{self.kind}: {len(self.errors)} error(s), "
                f"{len(self.warnings)} warning(s)"
                + (f" [{','.join(self.codes())}]" if self.diagnostics else ""))


# -- last-verdict state (supervisor.status / dashboards) ----------------------

#: most recent verdict per pass kind: {'plan': {...}, 'lint': {...},
#: 'locks': {...}, 'protocol': {...}}. Written by record(); surfaced as the
#: 'analysis' key of supervisor.status().
_last: Dict[str, dict] = {}

#: every pass kind status() reports (a pass that never ran says so)
KINDS = ("plan", "lint", "locks", "protocol")


def record(report: Report, duration_s: float = 0.0) -> None:
    """Record a finished pass run: last-verdict state for
    ``supervisor.status()``, an ``ANALYSIS`` line in mlsl_stats.log, and one
    trace instant per finding (plus a summary instant) when the obs tracer
    is armed. Import of the stats/obs layers is lazy and fault-tolerant so
    the linter stays runnable from a bare pre-commit environment."""
    _last[report.kind] = {
        "at": time.time(),
        "errors": len(report.errors),
        "warnings": len(report.warnings),
        "codes": report.codes(),
        "duration_s": round(duration_s, 6),
        "verdict": "fail" if report.errors else "pass",
    }
    try:
        from mlsl_tpu_torch.core import stats as stats_mod

        stats_mod.record_analysis(
            report.kind, len(report.errors), len(report.warnings),
            report.codes(), duration_s,
        )
    except Exception:  # mlsl-lint: disable=A205 -- pre-commit runs lint
        pass           # without the stats stack; recording is best-effort
    try:
        from mlsl_tpu_torch.obs import tracer as obs

        tr = obs._tracer
        if tr is not None:
            for d in report.diagnostics:
                tr.instant("analysis.finding", "analysis", code=d.code,
                           severity=d.severity, anchor=d.anchor)
            tr.instant("analysis.verdict", "analysis", kind=report.kind,
                       errors=len(report.errors),
                       warnings=len(report.warnings),
                       codes=",".join(report.codes()))
    except Exception:  # mlsl-lint: disable=A205 -- as above: tracing is
        pass           # best-effort from the analysis layer


def status() -> dict:
    """Last verify/lint verdicts, for ``supervisor.status()`` ('analysis'
    key). A pass that never ran reports ``{"verdict": "never_ran"}``."""
    out = {}
    for kind in KINDS:
        out[kind] = dict(_last.get(kind, {"verdict": "never_ran"}))
    return out


def reset() -> None:
    """Clear the last-verdict state (tests)."""
    _last.clear()
