"""Project concurrency/idiom linter: AST rules for the invariants the
collective engine, the fault plane and the telemetry plane rely on.

Counterpart of ``mlsl_tpu.analysis.lint``, by adapted copy: the same rules,
codes and pragma grammar over ``mlsl_tpu_torch/``. Each rule encodes a
hazard the reference hit:

- **A201** a raw ``torch.distributed`` collective (``all_reduce``,
  ``reduce_scatter_tensor``, ``all_gather_into_tensor`` and the
  ``*_single`` names torch 2.13 gives them,
  ``all_to_all_single``, ``broadcast``, ``send`` / ``recv`` and their
  list and async forms) outside ``comm/algos/`` and the allowlisted engine
  modules: collectives must route through the selection table so tuning,
  breakers and stats see them. The reference's rule flags raw ``lax.p*``
  collectives; the port has no ``lax``, and its counterpart is the process
  group's collective API (standing difference "A201's torch form"). A call
  counts when it is reached through a name bound to ``torch.distributed``
  (``import torch.distributed as X``, ``from torch import distributed``,
  ``torch.distributed.X``) or imported from it by name: a Distribution's
  own ``all_reduce`` method is the engine's entry and does not count.
- **A202** device-program dispatch reachable from a ``threading.Thread``
  target: the request dispatch (``_dispatch``), a CUDA graph's ``replay``,
  and host blocking on the device (``synchronize``; the reference's
  ``block_until_ready`` stays recognized) must stay on the consumer thread,
  whose stream order the collectives rely on.
- **A203** ``core/stats`` counter mutation outside its ``record_*``/
  ``reset_*`` helpers: the helpers are the process-wide counters' single
  mutation discipline; scattered writes race and break the stats contract.
- **A204** chaos wrappers must pair ``__wrapped__`` with ``_mlsl_inner``:
  the precompile warm bypasses chaos sites through ``_mlsl_inner``
  (comm/collectives.unwrap_chaos) — a wrapper missing it burns armed fault
  budgets inside Commit.
- **A205** bare ``except:`` swallows the MLSL error taxonomy (the
  supervisor's classify() never sees the failure; KeyboardInterrupt and
  MemoryError die silently).
- **A206** wall-clock ``time.time()`` in retry/backoff/poll math: NTP steps
  move wall clock backwards; deadlines and backoff must use
  ``time.monotonic()``.
- **A207** metrics-registry series internals (the distinctive ``_m*`` slots
  of ``obs/metrics.py``) mutated outside the registry's record/observe/
  sample paths: the A203 single-mutation discipline extended to the
  telemetry plane.

Pragmas (same-line, or a standalone comment line covering the next
statement line)::

    dist.all_reduce(t)  # mlsl-lint: disable=A201 -- reason
    # mlsl-lint: disable-file=A201 -- reason   (anywhere: whole file)

The module itself imports only the standard library.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from mlsl_tpu_torch.analysis.diagnostics import Report, WARN, normalize_code

#: torch.distributed collectives the engine owns (init_process_group,
#: barrier and the group helpers are set-up and addressing, not data
#: collectives — deliberately not listed)
COLLECTIVE_NAMES = {
    "all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor",
    "reduce_scatter_single", "all_gather_single",
    "all_to_all_single", "broadcast", "send", "recv", "isend", "irecv",
    "batch_isend_irecv", "reduce", "reduce_scatter", "all_gather",
    "all_to_all", "gather", "scatter",
}

#: package-relative modules where raw collectives ARE the implementation
#: (the engine itself); everything else needs a pragma per site. The same
#: modules as the reference's allowlist: the port keeps its engine's layout.
A201_ALLOWED_PREFIXES = ("comm/algos/",)
A201_ALLOWED_FILES = {
    "comm/collectives.py",   # the collective builder the engine lowers to
    "comm/quant_ring.py",    # compressed-ring hop engine
    "comm/sparse.py",        # top-k wire family
    "comm/codec.py",         # custom-codec wire family
    "comm/overlap.py",       # the compiled engine (phases come from algos/)
    "ops/ring_kernels.py",   # the fused ring
    "comm/transport.py",     # the cross-process hops (the port's own, A.8)
}

#: attribute/function names whose call means "a device program is being
#: dispatched or waited on from the host": the request dispatch, a CUDA
#: graph's replay, and host blocking on the card (``torch.cuda.synchronize``,
#: ``Event.synchronize``, ``Stream.synchronize``). Host->device staging
#: (``.to(device, non_blocking=True)``, ``copy_``) is deliberately NOT listed:
#: a feed worker may stage batches, only program launch and host blocking
#: must stay on the consumer thread. ``block_until_ready`` is the
#: reference's marker, kept so that its fixtures read the same here.
DISPATCH_MARKERS = {"_dispatch", "_dispatch_items", "block_until_ready",
                    "synchronize", "replay"}

#: maximum call-graph depth explored from a Thread target (intra-module)
A202_DEPTH = 6

_COUNTER_RE = re.compile(r"^[A-Z][A-Z0-9_]*_(COUNTERS|EVENTS)$")
_MUTATORS = {"update", "clear", "append", "appendleft", "pop", "popleft",
             "setdefault", "extend", "__setitem__"}

#: metrics-registry series internals (obs/metrics.py): the distinctive _m*
#: names exist so this rule can be precise — any write to them outside the
#: registry's own record/observe/sample paths bypasses the series'
#: single-mutation discipline (racing increments, torn histograms, rings
#: that stop retiring), exactly the A203 hazard one layer up
_METRICS_INTERNAL_RE = re.compile(r"^_m(val|counts|sum|n|samples|series)$")
#: obs/metrics.py scopes that own series mutations (everything else in the
#: module — exporters, summarizers — reads only)
_A207_ALLOWED_FN = ("inc", "set", "observe", "enable", "disable")

_PRAGMA_RE = re.compile(
    r"#\s*mlsl-lint:\s*(disable(?:-file)?)\s*=\s*([A-Za-z0-9\-,\s]+?)\s*(?:--.*)?$"
)


def _parse_pragmas(src: str) -> Tuple[Dict[int, Set[str]], Set[str]]:
    """-> (line -> suppressed codes, file-level suppressed codes). A pragma on
    a standalone comment line also covers the next non-blank, non-comment
    line (long call sites keep their pragma readable)."""
    line_codes: Dict[int, Set[str]] = {}
    file_codes: Set[str] = set()
    lines = src.splitlines()
    for i, line in enumerate(lines, start=1):
        m = _PRAGMA_RE.search(line)
        if not m:
            continue
        codes = {normalize_code(c) for c in m.group(2).split(",") if c.strip()}
        if m.group(1) == "disable-file":
            file_codes |= codes
            continue
        line_codes.setdefault(i, set()).update(codes)
        if line.lstrip().startswith("#"):
            # standalone comment: cover the next statement line
            for j in range(i + 1, len(lines) + 1):
                nxt = lines[j - 1].strip()
                if nxt and not nxt.startswith("#"):
                    line_codes.setdefault(j, set()).update(codes)
                    break
    return line_codes, file_codes


def _attr_root(node: ast.AST) -> Optional[str]:
    """Leftmost name of an attribute chain ('a' for a.b.c), or None."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _dist_aliases(tree: ast.Module) -> Tuple[Set[str], Set[str]]:
    """-> (names bound to the ``torch.distributed`` module, names bound to
    one of its collectives by ``from torch.distributed import x``)."""
    mods: Set[str] = set()
    fns: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed" and a.asname:
                    mods.add(a.asname)
        elif isinstance(node, ast.ImportFrom):
            if node.module == "torch":
                for a in node.names:
                    if a.name == "distributed":
                        mods.add(a.asname or a.name)
            elif node.module == "torch.distributed":
                for a in node.names:
                    if a.name in COLLECTIVE_NAMES:
                        fns.add(a.asname or a.name)
    return mods, fns


def _is_dist_attr(node: ast.Attribute, mods: Set[str]) -> bool:
    """a ``<torch.distributed alias>.<coll>`` / ``torch.distributed.<coll>``
    attribute access."""
    v = node.value
    if isinstance(v, ast.Name) and v.id in mods:
        return True
    return (isinstance(v, ast.Attribute) and v.attr == "distributed"
            and isinstance(v.value, ast.Name) and v.value.id == "torch")


class _FuncInfo:
    """Per-function facts for the thread-reachability rule (A202)."""

    __slots__ = ("key", "calls", "markers", "node")

    def __init__(self, key, node):
        self.key = key          # (class name or None, function name)
        self.node = node
        self.calls: Set[Tuple[Optional[str], str]] = set()
        self.markers: List[Tuple[int, str]] = []  # (lineno, marker name)


def _collect_functions(tree: ast.Module) -> Dict[Tuple, _FuncInfo]:
    """Index every function/method with its intra-module call edges and its
    dispatch-marker call sites."""
    funcs: Dict[Tuple, _FuncInfo] = {}

    def walk_body(node, cls: Optional[str]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                info = _FuncInfo((cls, child.name), child)
                funcs[info.key] = info
                _scan_calls(child, cls, info)
                walk_body(child, cls)  # nested defs attributed to the module
            elif isinstance(child, ast.ClassDef):
                walk_body(child, child.name)
            else:
                walk_body(child, cls)

    def _scan_calls(fn, cls, info):
        for n in ast.walk(fn):
            if not isinstance(n, ast.Call):
                continue
            f = n.func
            if isinstance(f, ast.Attribute):
                if f.attr in DISPATCH_MARKERS:
                    info.markers.append((n.lineno, f.attr))
                if isinstance(f.value, ast.Name) and f.value.id == "self":
                    info.calls.add((cls, f.attr))
                info.calls.add((None, f.attr))
            elif isinstance(f, ast.Name):
                info.calls.add((None, f.id))
    walk_body(tree, None)
    return funcs


def _thread_targets(tree: ast.Module) -> List[Tuple[Tuple, int]]:
    """Every ``threading.Thread(target=X)`` site -> (resolved key, lineno)."""
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None)
        if name != "Thread":
            continue
        for kw in node.keywords:
            if kw.arg != "target":
                continue
            v = kw.value
            if isinstance(v, ast.Attribute) and \
                    isinstance(v.value, ast.Name) and v.value.id == "self":
                out.append(((None, v.attr), node.lineno))  # class-agnostic
            elif isinstance(v, ast.Name):
                out.append(((None, v.id), node.lineno))
    return out


def _rule_path(relpath: str) -> str:
    """The package-relative path rule matching uses: linting with
    ``--root .`` (or any ancestor) yields paths like
    ``mlsl_tpu_torch/comm/algos/x.py`` — the allowlists are anchored at the
    package, so strip everything up to the last ``mlsl_tpu_torch/``
    segment."""
    marker = "mlsl_tpu_torch/"
    i = relpath.rfind(marker)
    return relpath[i + len(marker):] if i >= 0 else relpath


def lint_source(src: str, relpath: str = "<string>") -> Report:
    """Lint one file's source. ``relpath`` is package-relative with ``/``
    separators (it drives the A201/A203 allowlists — normalized through
    ``_rule_path`` so linting from an ancestor root matches the same
    rules — and every anchor)."""
    rep = Report("lint")
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        rep.add("MLSL-A200", f"unparseable source: {e.msg}",
                f"{relpath}:{e.lineno or 0}")
        return rep
    line_pragmas, file_pragmas = _parse_pragmas(src)

    def emit(code, message, lineno, severity=None):
        code = normalize_code(code)
        if code in file_pragmas or code in line_pragmas.get(lineno, ()):
            return
        rep.add(code, message, f"{relpath}:{lineno}", severity=severity)

    # -- A201: raw torch.distributed collectives -------------------------
    rule_path = _rule_path(relpath)
    allowed = rule_path in A201_ALLOWED_FILES or any(
        rule_path.startswith(p) for p in A201_ALLOWED_PREFIXES
    )
    if not allowed:
        dist_mods, dist_fns = _dist_aliases(tree)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in COLLECTIVE_NAMES \
                    and _is_dist_attr(f, dist_mods):
                name = f.attr
            elif isinstance(f, ast.Name) and f.id in dist_fns:
                name = f.id
            else:
                continue
            emit("A201",
                 f"raw torch.distributed.{name} outside the collective "
                 "engine — route through comm/algos (or pragma the "
                 "deliberate call)", node.lineno)

    # -- A202: dispatch reachable from Thread targets --------------------
    funcs = _collect_functions(tree)
    by_name: Dict[str, List[_FuncInfo]] = {}
    for (cls, name), info in funcs.items():
        by_name.setdefault(name, []).append(info)
    for key, t_line in _thread_targets(tree):
        seen: Set[Tuple] = set()
        frontier = [info for info in by_name.get(key[1], [])]
        depth = 0
        while frontier and depth < A202_DEPTH:
            nxt = []
            for info in frontier:
                if info.key in seen:
                    continue
                seen.add(info.key)
                for lineno, marker in info.markers:
                    emit("A202",
                         f"{marker}() reachable from the Thread target "
                         f"'{key[1]}' (line {t_line}): device programs must "
                         "dispatch on the consumer thread", lineno)
                for _, cname in info.calls:
                    nxt.extend(by_name.get(cname, []))
            frontier = nxt
            depth += 1

    # -- A203: stats counter mutation outside the helpers ----------------
    in_stats = rule_path == "core/stats.py"

    def counter_name(node) -> Optional[str]:
        if isinstance(node, ast.Name) and _COUNTER_RE.match(node.id):
            return node.id
        if isinstance(node, ast.Attribute) and _COUNTER_RE.match(node.attr):
            return node.attr
        return None

    def allowed_scope(fn_name: Optional[str]) -> bool:
        if not in_stats:
            return False
        # module-level init and the record_/reset_ helpers own the mutations
        return fn_name is None or fn_name.startswith(("record_", "reset_",
                                                      "_"))

    def check_node(n, fn_name):
        tgt = None
        if isinstance(n, (ast.Assign, ast.AugAssign)):
            tgts = n.targets if isinstance(n, ast.Assign) else [n.target]
            for t in tgts:
                if isinstance(t, ast.Subscript):
                    tgt = tgt or counter_name(t.value)
        elif isinstance(n, ast.Call) and isinstance(
                n.func, ast.Attribute) and n.func.attr in _MUTATORS:
            tgt = counter_name(n.func.value)
        if tgt and not allowed_scope(fn_name):
            emit("A203",
                 f"{tgt} mutated outside core/stats record_*/reset_* "
                 "helpers", n.lineno)

    def scan_scope(node, fn_name):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scan_scope(child, child.name)
                continue
            check_node(child, fn_name)
            scan_scope(child, fn_name)

    scan_scope(tree, None)

    # -- A207: metrics series internals mutated outside the registry -----
    in_metrics = rule_path == "obs/metrics.py"

    def metrics_internal(node) -> Optional[str]:
        if isinstance(node, ast.Attribute) and \
                _METRICS_INTERNAL_RE.match(node.attr):
            return node.attr
        if isinstance(node, ast.Name) and _METRICS_INTERNAL_RE.match(node.id):
            return node.id
        return None

    def a207_allowed(fn_name: Optional[str]) -> bool:
        if not in_metrics:
            return False
        # module init and the record/observe/sample/reset family own the
        # mutations ('_'-prefixed covers __init__/_get and helpers)
        return fn_name is None or fn_name.startswith(
            ("_", "record_", "sample", "reset", "clear")
        ) or fn_name in _A207_ALLOWED_FN

    def a207_check(n, fn_name):
        tgt = None
        if isinstance(n, (ast.Assign, ast.AugAssign)):
            tgts = n.targets if isinstance(n, ast.Assign) else [n.target]
            for t in tgts:
                tgt = tgt or metrics_internal(t)
                if isinstance(t, ast.Subscript):
                    tgt = tgt or metrics_internal(t.value)
        elif isinstance(n, ast.Call) and isinstance(
                n.func, ast.Attribute) and n.func.attr in _MUTATORS:
            tgt = metrics_internal(n.func.value)
        if tgt and not a207_allowed(fn_name):
            emit("A207",
                 f"metrics series internal {tgt} mutated outside the "
                 "obs/metrics record/observe/sample paths — use the "
                 "registry API (inc/set/observe)", n.lineno)

    def a207_scan(node, fn_name):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                a207_scan(child, child.name)
                continue
            a207_check(child, fn_name)
            a207_scan(child, fn_name)

    a207_scan(tree, None)

    # -- A204: chaos wrapper _mlsl_inner symmetry ------------------------
    for info in funcs.values():
        wrapped: Dict[str, int] = {}
        inner: Set[str] = set()
        for n in ast.walk(info.node):
            if isinstance(n, ast.Assign):
                for t in n.targets:
                    if isinstance(t, ast.Attribute) and isinstance(
                            t.value, ast.Name):
                        if t.attr == "__wrapped__":
                            wrapped[t.value.id] = n.lineno
                        elif t.attr == "_mlsl_inner":
                            inner.add(t.value.id)
        for name, lineno in wrapped.items():
            if name not in inner:
                emit("A204",
                     f"wrapper '{name}' sets __wrapped__ without "
                     "_mlsl_inner: the precompile warm would re-enter the "
                     "chaos site (comm/collectives.unwrap_chaos)", lineno)

    # -- A205: bare/swallowing except ------------------------------------
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if node.type is None:
            emit("A205",
                 "bare 'except:' swallows the MLSL error taxonomy "
                 "(supervisor.classify never sees the failure)", node.lineno)
        elif (isinstance(node.type, ast.Name)
              and node.type.id in ("Exception", "BaseException")
              and all(isinstance(s, (ast.Pass, ast.Continue))
                      for s in node.body)):
            emit("A205",
                 f"'except {node.type.id}' with an empty body silently "
                 "swallows classified failures", node.lineno,
                 severity=WARN)

    # -- A206: wall clock in retry/backoff math --------------------------
    def is_call_to(n, mod, name):
        return (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == name
                and isinstance(n.func.value, ast.Name)
                and n.func.value.id == mod)

    for info in funcs.values():
        body_nodes = list(ast.walk(info.node))
        if not any(is_call_to(n, "time", "sleep") for n in body_nodes):
            continue
        for n in body_nodes:
            if is_call_to(n, "time", "time"):
                emit("A206",
                     f"time.time() in '{info.key[1]}', which sleeps/backs "
                     "off: wall clock steps backwards under NTP — use "
                     "time.monotonic()", n.lineno)

    return rep


def package_root() -> str:
    """The installed mlsl_tpu_torch package directory (the default lint
    root)."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lint_file(path: str, root: Optional[str] = None) -> Report:
    root = root or package_root()
    rel = os.path.relpath(os.path.abspath(path), root).replace(os.sep, "/")
    with open(path, "r", encoding="utf-8") as f:
        src = f.read()
    return lint_source(src, rel)


def lint_tree(root: Optional[str] = None) -> Report:
    """Lint every ``.py`` file under ``root`` (default: the mlsl_tpu_torch
    package itself — the self-application the clean-tree test pins)."""
    root = os.path.abspath(root or package_root())
    rep = Report("lint")
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", "build", ".git",
                                    "node_modules", ".ruff_cache")
                       # known-bad lint fixtures exist to FLAG; they are
                       # pinned per-file by the analysis tests, and the
                       # clean-tree gate must stay 0/0 on the shipped repo
                       and not (d == "fixtures"
                                and os.path.basename(dirpath) == "tests")]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                rep.extend(lint_file(os.path.join(dirpath, fn), root))
    return rep
