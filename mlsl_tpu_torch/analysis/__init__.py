"""Analysis for the port: the shared diagnostic format and the runtime lock
witness.

Counterpart of ``mlsl_tpu.analysis`` in part: ``diagnostics`` (stable
``MLSL-Axxx`` codes, the last verdict of each pass for
``supervisor.status()["analysis"]``) and ``witness`` (``MLSL_LOCK_WITNESS=1``:
instrumented named locks record acquisition-order edges, cycles and
over-budget holds); of the plan verifier, ``plan.verify_reshard`` alone (the
elastic reshard rule, A140/A141). The rest of the plan verifier, the linter,
the lock-order analyzer and the protocol checker wait for ROADMAP A.7d.
"""

from mlsl_tpu_torch.analysis.diagnostics import (  # noqa: F401
    CODES,
    Diagnostic,
    Report,
    record,
    reset,
    status,
)
