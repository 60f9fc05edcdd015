"""Static analysis for the port: the commit-time collective-plan verifier,
the project concurrency linter, the lockset/lock-order analyzer, the
protocol model checker, and the runtime lock witness.

Counterpart of ``mlsl_tpu.analysis``, by adapted copy. Five passes over one
structured-diagnostic format (stable ``MLSL-Axxx`` codes, ``error``/``warn``
severity, ``file:line``, ``graph:<node>`` or ``model:<name>`` anchors — see
``diagnostics.CODES`` for the full table):

- ``analysis.plan`` walks a committed Session's collective plan (armed by
  ``MLSL_VERIFY=1`` at ``Session.commit`` and where the compiled engine is
  built, or explicitly via ``verify_session``): issue-order consistency
  across overlapping groups, in-flight program budgets, quantization and
  codec geometry, the degrade machinery's preconditions, compiled-overlap
  donation hazards, and the launch limits of the CUDA kernel each request is
  routed to.
- ``analysis.lint`` runs project-specific AST rules over the source tree
  (``python -m mlsl_tpu_torch.analysis``): raw ``torch.distributed``
  collectives, thread-reachable device dispatch, stats-counter discipline,
  chaos-wrapper symmetry, taxonomy-swallowing excepts, and wall-clock retry
  math.
- ``analysis.locks`` (A21x, same gate as the linter) analyzes the whole
  package as one program: lock inventory, may-hold-while-acquiring order
  cycles, locks held across blocking ops, unlocked thread-shared globals,
  Condition.wait predicate loops, unjoined daemon threads.
- ``analysis.protocol`` (A15x, run at ``Session.commit`` next to the plan
  verifier) exhaustively explores declarative mirrors of the control-plane
  membership/drain and elastic shrink/grow protocols.
- ``analysis.witness`` is the dynamic half (``MLSL_LOCK_WITNESS=1``):
  instrumented locks record acquisition-order edges, cycles, and
  over-budget holds at runtime.

The last verdict of each pass is surfaced as the ``analysis`` key of
``supervisor.status()``.
"""

from mlsl_tpu_torch.analysis.diagnostics import (  # noqa: F401
    CODES,
    Diagnostic,
    Report,
    record,
    reset,
    status,
)


def verify_session(session, config=None):
    """Statically verify one committed session (see analysis/plan.py)."""
    from mlsl_tpu_torch.analysis import plan

    return plan.verify_session(session, config)


def verify_overlap_plan(overlap_plan, block=None):
    from mlsl_tpu_torch.analysis import plan

    return plan.verify_overlap_plan(overlap_plan, block)


def lint_tree(root=None):
    """Run the AST linter over a source tree (see analysis/lint.py)."""
    from mlsl_tpu_torch.analysis import lint

    return lint.lint_tree(root)
