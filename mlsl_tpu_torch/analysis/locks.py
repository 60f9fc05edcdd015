"""Static lockset + lock-order analyzer: the A21x rule family.

Counterpart of ``mlsl_tpu.analysis.locks``, by adapted copy over
``mlsl_tpu_torch/``. The package's value proposition is *asynchronous*
communication — a progress thread dispatching deferred collectives behind
Start/Wait/Test handles, feed workers, the control plane's heartbeat and
accept loops, the serving engine — so the A2xx linter (``analysis/lint.py``)
checks single-site idioms and this pass models the *interaction*: which
locks exist, which functions may acquire them, and what happens while they
are held.

Rules:

- **A210** lock-order cycle: the may-hold-while-acquiring graph (direct
  ``with A: with B:`` nesting plus call edges into functions that may
  acquire) contains a cycle — two threads taking the locks in opposite
  orders deadlock. A self-edge on a non-reentrant ``Lock`` is the
  single-thread special case.
- **A211** lock held across a blocking operation: device dispatch
  (``_dispatch``, a CUDA graph's ``replay``), host blocking on the card
  (``torch.cuda.synchronize``, ``Event.synchronize``,
  ``Stream.synchronize``), no-timeout ``join()``/``get()``/``put()``/
  ``wait()``, ``time.sleep``, and socket I/O (``send_frame``,
  ``accept``/``recv``/``sendall``) stall every other thread that needs the
  lock for the full blocking duration.
- **A212** module-level mutable state written from a ``threading.Thread``
  target with no lock held. ``core/stats``/``obs/metrics``/``obs/tracer``
  are allowlisted — their lock-free single-writer discipline is the
  documented design (and A203/A207 pin its mutation scope).
- **A213** ``Condition.wait`` without an enclosing ``while``.
- **A214** (warn) ``daemon=True`` thread never joined anywhere in its
  module.

The torch forms of the reference's markers (standing difference "The lock
analyzer's torch markers"): ``synchronize`` blocks as ``block_until_ready``
does (which stays recognized); ``replay`` is a dispatch; a ``.wait()`` on a
CUDA event (a name bound to ``torch.cuda.Event(...)`` or to a
``record_event(...)`` result) makes a stream wait and does not block the
host, so it is not the zero-argument ``wait`` of a thread or a queue. The
reference's device-code files (Pallas semaphore ``wait``s traced into a
kernel) have no counterpart: the port's kernels are CUDA sources.

Same pragma grammar as the linter (``# mlsl-lint: disable=A211 -- why``).
The module itself imports only the standard library.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from mlsl_tpu_torch.analysis.diagnostics import Report, normalize_code
from mlsl_tpu_torch.analysis.lint import (
    _parse_pragmas,
    _rule_path,
    package_root,
)

#: constructors that create a lock object, -> kind. Both the raw threading
#: primitives and the witness factories (analysis/witness.py) count: routing
#: a lock through the witness must not blind the static pass.
_LOCK_CTORS = {
    "Lock": "lock",
    "RLock": "rlock",
    "Condition": "condition",
    "named_lock": "lock",
    "named_rlock": "rlock",
    "named_condition": "condition",
}

#: attribute calls that block for an unbounded time only when called with
#: zero positional args and no timeout kwarg (Thread.join / Queue.get /
#: Queue.put / Event.wait — a 1-arg .join is str.join, a 1-arg .get is
#: dict.get, a with-timeout wait is bounded)
_BLOCKING_IF_NO_TIMEOUT = {"join", "get", "put", "wait"}

#: attribute calls that block regardless of arguments (socket I/O)
_BLOCKING_ALWAYS = {"accept", "recv", "recv_into", "sendall"}

#: plain / module-qualified calls that block (device dispatch markers from
#: the A202 rule, host blocking on the card, the control channel's retried
#: TCP send)
_BLOCKING_CALLS = {"_dispatch", "_dispatch_items", "block_until_ready",
                   "synchronize", "replay", "send_frame", "create_connection"}

#: modules whose module-level counters are lock-free BY DESIGN (documented
#: single-writer / GIL-atomic disciplines, pinned by A203/A207); A212 skips
#: them instead of demanding locks the design deliberately omits
_A212_ALLOWED_FILES = {"core/stats.py", "obs/metrics.py", "obs/tracer.py"}

#: device-kernel modules whose ``.wait()``/``.get()`` are device-side ops,
#: not host-thread blocking: the reference lists its Pallas ring here; the
#: port's kernels are CUDA sources, so none
_DEVICE_CODE_FILES: Set[str] = set()

#: fixpoint bound for the transitive may-acquire/may-block propagation
_MAX_PASSES = 12

LockKey = Tuple[str, Optional[str], str]   # (rule_path, owner class, attr)
FnKey = Tuple[str, Optional[str], str]     # (rule_path, class, name)


class _LockDef:
    __slots__ = ("key", "kind", "lineno")

    def __init__(self, key: LockKey, kind: str, lineno: int):
        self.key = key
        self.kind = kind
        self.lineno = lineno


class _Fn:
    """Per-function facts gathered by the held-set-aware walk."""

    __slots__ = ("key", "node", "acquires", "calls", "blocking",
                 "global_writes", "cond_waits", "nest_edges")

    def __init__(self, key: FnKey, node: ast.AST):
        self.key = key
        self.node = node
        #: lock keys this function itself acquires (any position)
        self.acquires: Set[LockKey] = set()
        #: (callee ref, held set, lineno)
        self.calls: List[Tuple[tuple, FrozenSet[LockKey], int]] = []
        #: (marker name, held set, lineno)
        self.blocking: List[Tuple[str, FrozenSet[LockKey], int]] = []
        #: (global name, held set, lineno)
        self.global_writes: List[Tuple[str, FrozenSet[LockKey], int]] = []
        #: (lineno, inside a while loop?)
        self.cond_waits: List[Tuple[int, bool]] = []
        #: direct with-nesting edges (outer key, inner key, lineno)
        self.nest_edges: List[Tuple[LockKey, LockKey, int]] = []


class _Module:
    """One parsed file: lock inventory, import map, per-function facts."""

    def __init__(self, path: str, src: str):
        self.path = path                       # rule path (package-relative)
        self.src = src
        self.tree: Optional[ast.Module] = None
        self.syntax_error: Optional[SyntaxError] = None
        self.line_pragmas: Dict[int, Set[str]] = {}
        self.file_pragmas: Set[str] = set()
        #: (owner class or None, attr) -> _LockDef
        self.locks: Dict[Tuple[Optional[str], str], _LockDef] = {}
        #: condition constructed over an existing lock: cond key -> lock key
        self.cond_alias: Dict[LockKey, LockKey] = {}
        self.funcs: Dict[FnKey, _Fn] = {}
        self.by_name: Dict[str, List[FnKey]] = {}
        #: import alias -> target rule path ('stats_mod' -> 'core/stats.py')
        self.imports: Dict[str, str] = {}
        #: module-level names bound to mutable containers
        self.mutable_globals: Set[str] = set()
        #: thread-target function names -> spawn lineno
        self.thread_targets: List[Tuple[str, int]] = []
        #: daemon spawns: (binding name or None, lineno)
        self.daemon_spawns: List[Tuple[Optional[str], int]] = []
        #: names that have .join( called on them somewhere in the module
        self.joined_names: Set[str] = set()
        #: (owner class or None, name) bound to a CUDA event: their .wait()
        #: is a stream wait, not host blocking
        self.cuda_events: Set[Tuple[Optional[str], str]] = set()
        try:
            self.tree = ast.parse(src)
        except SyntaxError as e:
            self.syntax_error = e
            return
        self.line_pragmas, self.file_pragmas = _parse_pragmas(src)
        self._scan_imports()
        self._scan_locks()
        self._scan_cuda_events()
        self._scan_globals()
        self._scan_threads()
        self._scan_functions()

    # -- inventory ---------------------------------------------------------

    def _scan_imports(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name.startswith("mlsl_tpu_torch."):
                        rel = a.name[len("mlsl_tpu_torch."):].replace(".", "/")
                        self.imports[a.asname or a.name.split(".")[-1]] = \
                            rel + ".py"
            elif isinstance(node, ast.ImportFrom):
                if not node.module or not (
                        node.module == "mlsl_tpu_torch"
                        or node.module.startswith("mlsl_tpu_torch.")):
                    continue
                base = node.module[len("mlsl_tpu_torch"):].lstrip(".")
                for a in node.names:
                    sub = (base + "/" if base else "") + a.name
                    self.imports[a.asname or a.name] = \
                        sub.replace(".", "/") + ".py"

    @staticmethod
    def _ctor_kind(call: ast.Call) -> Optional[str]:
        f = call.func
        name = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None)
        return _LOCK_CTORS.get(name or "")

    def _scan_locks(self) -> None:
        """Every ``X = threading.Lock()``-shaped binding, module-level or
        ``self.attr`` inside a class body, plus Condition-over-lock
        aliases."""

        def visit(node, cls: Optional[str]):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    visit(child, child.name)
                    continue
                if isinstance(child, ast.Assign) and \
                        isinstance(child.value, ast.Call):
                    kind = self._ctor_kind(child.value)
                    if kind:
                        for t in child.targets:
                            owner_attr = self._binding(t, cls)
                            if owner_attr is None:
                                continue
                            key = (self.path,) + owner_attr
                            self.locks[owner_attr] = _LockDef(
                                key, kind, child.lineno)
                            if kind == "condition" and child.value.args:
                                base = self._binding_of_expr(
                                    child.value.args[0], cls)
                                if base is not None:
                                    self.cond_alias[key] = \
                                        (self.path,) + base
                visit(child, cls)

        visit(self.tree, None)

    def _scan_cuda_events(self) -> None:
        """Every binding of a CUDA event: ``torch.cuda.Event(...)`` (or
        ``cuda.Event(...)``) and ``<stream>.record_event(...)``, to a
        ``self.attr`` or to a name in any scope."""

        def is_event_ctor(call: ast.Call) -> bool:
            f = call.func
            if not isinstance(f, ast.Attribute):
                return False
            if f.attr == "record_event":
                return True
            return f.attr == "Event" and (
                (isinstance(f.value, ast.Attribute) and f.value.attr == "cuda")
                or (isinstance(f.value, ast.Name) and f.value.id == "cuda"))

        def visit(node, cls: Optional[str]):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    visit(child, child.name)
                    continue
                if isinstance(child, ast.Assign) and \
                        isinstance(child.value, ast.Call) and \
                        is_event_ctor(child.value):
                    for t in child.targets:
                        b = self._binding_of_expr(t, cls)
                        if b is not None:
                            self.cuda_events.add(b)
                visit(child, cls)

        visit(self.tree, None)

    def _is_cuda_event(self, expr: ast.AST, cls: Optional[str]) -> bool:
        b = self._binding_of_expr(expr, cls)
        return b is not None and b in self.cuda_events

    def _binding(self, target: ast.AST,
                 cls: Optional[str]) -> Optional[Tuple[Optional[str], str]]:
        """A lock binding target -> (owner, attr): ``self.x`` inside class C
        is (C, 'x'); a module-level name is (None, name)."""
        if isinstance(target, ast.Attribute) and \
                isinstance(target.value, ast.Name) and \
                target.value.id == "self":
            return (cls, target.attr)
        if isinstance(target, ast.Name) and cls is None:
            return (None, target.id)
        return None

    def _binding_of_expr(self, expr: ast.AST, cls: Optional[str]
                         ) -> Optional[Tuple[Optional[str], str]]:
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and expr.value.id == "self":
            return (cls, expr.attr)
        if isinstance(expr, ast.Name):
            return (None, expr.id)
        return None

    def _scan_globals(self) -> None:
        mutable_ctors = {"dict", "list", "set", "deque", "defaultdict",
                         "OrderedDict", "Counter"}
        for child in ast.iter_child_nodes(self.tree):
            if not isinstance(child, (ast.Assign, ast.AnnAssign)):
                continue
            targets = child.targets if isinstance(child, ast.Assign) \
                else [child.target]
            v = child.value
            mutable = isinstance(v, (ast.Dict, ast.List, ast.Set)) or (
                isinstance(v, ast.Call) and isinstance(v.func, ast.Name)
                and v.func.id in mutable_ctors)
            if not mutable:
                continue
            for t in targets:
                if isinstance(t, ast.Name):
                    self.mutable_globals.add(t.id)

    def _scan_threads(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                f = node.func
                name = f.attr if isinstance(f, ast.Attribute) else (
                    f.id if isinstance(f, ast.Name) else None)
                if name == "Thread":
                    self._note_thread(node)
                elif isinstance(f, ast.Attribute) and f.attr == "join":
                    recv = f.value
                    if isinstance(recv, ast.Attribute):
                        self.joined_names.add(recv.attr)
                    elif isinstance(recv, ast.Name):
                        self.joined_names.add(recv.id)

    def _note_thread(self, node: ast.Call) -> None:
        daemon = any(
            kw.arg == "daemon" and isinstance(kw.value, ast.Constant)
            and kw.value.value is True for kw in node.keywords)
        for kw in node.keywords:
            if kw.arg != "target":
                continue
            v = kw.value
            if isinstance(v, ast.Attribute) and \
                    isinstance(v.value, ast.Name) and v.value.id == "self":
                self.thread_targets.append((v.attr, node.lineno))
            elif isinstance(v, ast.Name):
                self.thread_targets.append((v.id, node.lineno))
        if daemon:
            self.daemon_spawns.append((self._thread_binding(node),
                                       node.lineno))

    def _thread_binding(self, call: ast.Call) -> Optional[str]:
        """The name the Thread object is bound to (``self._t = Thread(...)``
        -> '_t'), found by matching the call node back to its Assign."""
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Assign) and node.value is call:
                t = node.targets[0]
                if isinstance(t, ast.Attribute):
                    return t.attr
                if isinstance(t, ast.Name):
                    return t.id
        return None

    # -- per-function facts ------------------------------------------------

    def _scan_functions(self) -> None:
        def visit(node, cls: Optional[str]):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    key: FnKey = (self.path, cls, child.name)
                    fn = _Fn(key, child)
                    self.funcs[key] = fn
                    self.by_name.setdefault(child.name, []).append(key)
                    self._walk_fn(child, cls, fn)
                    visit(child, cls)   # nested defs get their own entry
                elif isinstance(child, ast.ClassDef):
                    visit(child, child.name)
                else:
                    visit(child, cls)

        visit(self.tree, None)

    def _lock_key_of(self, expr: ast.AST, cls: Optional[str]
                     ) -> Optional[Tuple[LockKey, str]]:
        """Resolve a with-context / receiver expression to a known lock
        (following Condition-over-lock aliases) -> (key, kind)."""
        binding = self._binding_of_expr(expr, cls)
        if binding is None:
            return None
        d = self.locks.get(binding)
        if d is None and binding[0] is not None:
            # method of another class in this module, or an attr assigned in
            # a helper: fall back to a unique same-attr match
            matches = [x for (o, a), x in self.locks.items()
                       if a == binding[1]]
            d = matches[0] if len(matches) == 1 else None
        if d is None:
            return None
        key = self.cond_alias.get(d.key, d.key)
        return key, d.kind

    def _walk_fn(self, fn_node: ast.AST, cls: Optional[str], fn: _Fn) -> None:
        declared_global: Set[str] = {
            n for node in ast.walk(fn_node)
            if isinstance(node, ast.Global) for n in node.names}

        def walk(node, held: List[LockKey], in_while: bool):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                return  # nested defs are separate functions
            if isinstance(node, ast.With):
                entered: List[LockKey] = []
                for item in node.items:
                    got = self._lock_key_of(item.context_expr, cls)
                    if got is None:
                        continue
                    key, _kind = got
                    fn.acquires.add(key)
                    for h in held + entered:
                        if h != key:
                            fn.nest_edges.append((h, key, node.lineno))
                    entered.append(key)
                for b in node.body:
                    walk(b, held + entered, in_while)
                return
            if isinstance(node, ast.While):
                for child in ast.iter_child_nodes(node):
                    walk(child, held, True)
                return
            if isinstance(node, ast.Call):
                self._note_call(node, cls, fn, held, in_while)
            self._note_write(node, cls, fn, held, declared_global)
            for child in ast.iter_child_nodes(node):
                walk(child, held, in_while)

        for stmt in ast.iter_child_nodes(fn_node):
            walk(stmt, [], False)

    def _note_call(self, call: ast.Call, cls: Optional[str], fn: _Fn,
                   held: List[LockKey], in_while: bool) -> None:
        f = call.func
        hset = frozenset(held)
        # a positional arg makes join/get/wait bounded or non-queue
        # (str.join(it), dict.get(k), Event.wait(t)); put(item) still blocks
        # and is only bounded by an explicit timeout/block kwarg
        kwargs = {kw.arg for kw in call.keywords}
        if isinstance(f, ast.Attribute) and f.attr == "put":
            has_timeout = bool(kwargs & {"timeout", "block"})
        else:
            has_timeout = bool(call.args) or bool(kwargs & {"timeout",
                                                            "block"})
        if isinstance(f, ast.Attribute):
            recv_lock = self._lock_key_of(f.value, cls)
            if f.attr in ("acquire",) and recv_lock is not None:
                fn.acquires.add(recv_lock[0])
            if f.attr == "wait":
                if recv_lock is not None and recv_lock[1] == "condition":
                    fn.cond_waits.append((call.lineno, in_while))
                    return   # Condition.wait releases its lock: not A211
                if self._is_cuda_event(f.value, cls):
                    return   # a stream wait: the host does not block
            if f.attr in _BLOCKING_ALWAYS and held:
                fn.blocking.append((f.attr, hset, call.lineno))
            elif f.attr in _BLOCKING_IF_NO_TIMEOUT and held \
                    and not has_timeout:
                fn.blocking.append((f.attr, hset, call.lineno))
            if f.attr in _BLOCKING_CALLS and held:
                fn.blocking.append((f.attr, hset, call.lineno))
            # sleep: time.sleep / bare sleep
            if f.attr == "sleep" and isinstance(f.value, ast.Name) \
                    and f.value.id == "time" and held:
                fn.blocking.append(("time.sleep", hset, call.lineno))
            # call-graph edge
            if isinstance(f.value, ast.Name):
                if f.value.id == "self":
                    fn.calls.append((("self", f.attr), hset, call.lineno))
                elif f.value.id in self.imports:
                    fn.calls.append((("import", f.value.id, f.attr),
                                     hset, call.lineno))
        elif isinstance(f, ast.Name):
            if f.id in _BLOCKING_CALLS and held:
                fn.blocking.append((f.id, hset, call.lineno))
            if f.id in self.imports:
                # from mlsl_tpu_torch.x import fn; fn(...)
                fn.calls.append((("import_fn", f.id), hset, call.lineno))
            else:
                fn.calls.append((("local", f.id), hset, call.lineno))

    def _note_write(self, node: ast.AST, cls: Optional[str], fn: _Fn,
                    held: List[LockKey], declared_global: Set[str]) -> None:
        hset = frozenset(held)

        def global_name(expr) -> Optional[str]:
            if isinstance(expr, ast.Name) and \
                    expr.id in self.mutable_globals:
                return expr.id
            return None

        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                name = None
                if isinstance(t, ast.Subscript):
                    name = global_name(t.value)
                elif isinstance(t, ast.Name) and t.id in declared_global \
                        and t.id in self.mutable_globals:
                    name = t.id
                if name:
                    fn.global_writes.append((name, hset, node.lineno))
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and node.func.attr in (
                    "append", "appendleft", "extend", "update", "add",
                    "setdefault", "pop", "popleft", "clear", "remove",
                    "discard"):
            name = global_name(node.func.value)
            if name:
                fn.global_writes.append((name, hset, node.lineno))


# ---------------------------------------------------------------------------
# whole-package analysis
# ---------------------------------------------------------------------------


def _resolve(mods: Dict[str, _Module], mod: _Module, caller: FnKey,
             ref: tuple) -> List[FnKey]:
    """A recorded call ref -> candidate function keys (under-approximate:
    unresolvable receivers contribute no edges)."""
    kind = ref[0]
    if kind == "self":
        name = ref[1]
        cls = caller[1]
        exact = (mod.path, cls, name)
        if exact in mod.funcs:
            return [exact]
        return mod.by_name.get(name, [])
    if kind == "local":
        return mod.by_name.get(ref[1], [])
    if kind == "import":
        target = mods.get(mod.imports.get(ref[1], ""))
        if target is None:
            return []
        return [k for k in target.by_name.get(ref[2], ())
                if k[1] is None]  # module-qualified -> module-level fns
    if kind == "import_fn":
        # from mlsl_tpu_torch.pkg import name -- the import maps name to either a
        # module (pkg/name.py) or a module-level function in pkg/__init__.py
        tpath = mod.imports.get(ref[1], "")
        parent = os.path.dirname(tpath)
        fname = os.path.basename(tpath)[:-3] if tpath.endswith(".py") else ""
        init = (parent + "/" if parent else "") + "__init__.py"
        target = mods.get(init)
        if target is not None:
            return [k for k in target.by_name.get(fname, ()) if k[1] is None]
        return []
    return []


def _fixpoint_may_acquire(mods: Dict[str, _Module]
                          ) -> Dict[FnKey, Set[LockKey]]:
    may: Dict[FnKey, Set[LockKey]] = {}
    for m in mods.values():
        for key, fn in m.funcs.items():
            may[key] = set(fn.acquires)
    for _ in range(_MAX_PASSES):
        changed = False
        for m in mods.values():
            for key, fn in m.funcs.items():
                acc = may[key]
                before = len(acc)
                for ref, _held, _line in fn.calls:
                    for callee in _resolve(mods, m, key, ref):
                        acc |= may.get(callee, set())
                if len(acc) != before:
                    changed = True
        if not changed:
            break
    return may


def _fixpoint_may_block(mods: Dict[str, _Module]
                        ) -> Dict[FnKey, Optional[Tuple[str, str]]]:
    """fn -> (marker, anchor 'path:line') of one blocking site reachable
    from it (its own, or transitively through resolvable calls), or None."""
    may: Dict[FnKey, Optional[Tuple[str, str]]] = {}
    # blocking is recorded in fn.blocking only when a lock was held at the
    # site; for propagation what matters is that the callee CAN block at
    # all, so rescan every call node with the same marker logic (minus the
    # held filter, minus Condition.wait — that releases its lock)
    for m in mods.values():
        for key, fn in m.funcs.items():
            may[key] = None
            if m.path in _DEVICE_CODE_FILES:
                continue
            cls = key[1]
            for node in ast.walk(fn.node):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                name = f.attr if isinstance(f, ast.Attribute) else (
                    f.id if isinstance(f, ast.Name) else None)
                kwargs = {kw.arg for kw in node.keywords}
                if name == "put":
                    has_timeout = bool(kwargs & {"timeout", "block"})
                else:
                    has_timeout = bool(node.args) or bool(
                        kwargs & {"timeout", "block"})
                if name == "wait" and isinstance(f, ast.Attribute):
                    got = m._lock_key_of(f.value, cls)
                    if got is not None and got[1] == "condition":
                        continue
                    if m._is_cuda_event(f.value, cls):
                        continue
                if name in _BLOCKING_CALLS or name in _BLOCKING_ALWAYS or (
                        name in _BLOCKING_IF_NO_TIMEOUT and not has_timeout):
                    may[key] = (name or "?", f"{m.path}:{node.lineno}")
                    break
                if name == "sleep" and isinstance(f, ast.Attribute) and \
                        isinstance(f.value, ast.Name) and \
                        f.value.id == "time":
                    may[key] = ("time.sleep", f"{m.path}:{node.lineno}")
                    break
    for _ in range(_MAX_PASSES):
        changed = False
        for m in mods.values():
            for key, fn in m.funcs.items():
                if may[key] is not None:
                    continue
                for ref, _held, _line in fn.calls:
                    for callee in _resolve(mods, m, key, ref):
                        if may.get(callee) is not None:
                            may[key] = may[callee]
                            changed = True
                            break
                    if may[key] is not None:
                        break
        if not changed:
            break
    return may


def _lock_name(key: LockKey) -> str:
    path, owner, attr = key
    return f"{path}:{owner + '.' if owner else ''}{attr}"


def _find_cycles(edges: Dict[Tuple[LockKey, LockKey], int]
                 ) -> List[Tuple[List[LockKey], int]]:
    """Cycles in the acquisition-order graph -> (cycle node list, anchor
    line). Each strongly-connected component with a cycle reports once."""
    graph: Dict[LockKey, Set[LockKey]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    index: Dict[LockKey, int] = {}
    low: Dict[LockKey, int] = {}
    on_stack: Set[LockKey] = set()
    stack: List[LockKey] = []
    sccs: List[List[LockKey]] = []
    counter = [0]

    def strongconnect(v: LockKey) -> None:
        # iterative Tarjan: (node, iterator) frames
        work = [(v, iter(sorted(graph[v])))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(graph[w]))))
                    advanced = True
                    break
                if w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                sccs.append(comp)

    for v in sorted(graph):
        if v not in index:
            strongconnect(v)

    out = []
    for comp in sccs:
        cyclic = len(comp) > 1 or (comp[0], comp[0]) in edges
        if not cyclic:
            continue
        comp = sorted(comp)
        anchor = min(line for (a, b), line in edges.items()
                     if a in comp and b in comp)
        out.append((comp, anchor))
    return out


def analyze_sources(files: Dict[str, str]) -> Report:
    """Run the A21x pass over ``{rule_path: source}``. Cross-module edges
    resolve through the package-internal import graph; anything that cannot
    be resolved contributes no edge (under-approximation: this pass must
    never cry wolf on the shipped tree)."""
    rep = Report("locks")
    mods: Dict[str, _Module] = {}
    for path, src in sorted(files.items()):
        mods[path] = _Module(path, src)

    def emit(mod: _Module, code: str, message: str, lineno: int) -> None:
        code = normalize_code(code)
        if code in mod.file_pragmas or \
                code in mod.line_pragmas.get(lineno, ()):
            return
        rep.add(code, message, f"{mod.path}:{lineno}")

    may_acquire = _fixpoint_may_acquire(mods)
    may_block = _fixpoint_may_block(mods)

    # -- A210: acquisition-order graph + cycles ---------------------------
    edges: Dict[Tuple[LockKey, LockKey], int] = {}
    edge_mod: Dict[Tuple[LockKey, LockKey], _Module] = {}
    for m in mods.values():
        for key, fn in m.funcs.items():
            for a, b, line in fn.nest_edges:
                edges.setdefault((a, b), line)
                edge_mod.setdefault((a, b), m)
            for ref, held, line in fn.calls:
                if not held:
                    continue
                targets: Set[LockKey] = set()
                for callee in _resolve(mods, m, key, ref):
                    targets |= may_acquire.get(callee, set())
                for h in held:
                    for t in targets:
                        if t != h:
                            edges.setdefault((h, t), line)
                            edge_mod.setdefault((h, t), m)
    for cycle, anchor in _find_cycles(edges):
        names = " -> ".join(_lock_name(k) for k in cycle)
        mod = next((edge_mod[(a, b)] for (a, b) in edges
                    if a in cycle and b in cycle
                    and edges[(a, b)] == anchor), None)
        if mod is None:
            continue
        emit(mod, "A210",
             f"lock-order cycle: {names} — threads taking these locks in "
             "opposite orders deadlock; pick one order and hold to it",
             anchor)

    # -- A211 / A212 / A213 per-function facts ----------------------------
    seen_211: Set[Tuple[str, int]] = set()
    for m in mods.values():
        if m.syntax_error is not None:
            continue   # the linter's A200 owns unparseable files
        reachable = _thread_reachable(mods, m)
        for key, fn in m.funcs.items():
            for marker, held, line in fn.blocking:
                if not held or (m.path, line) in seen_211:
                    continue
                seen_211.add((m.path, line))
                emit(m, "A211",
                     f"'{marker}' can block while "
                     f"{_held_names(held)} is held — every thread needing "
                     "the lock stalls for the full blocking duration",
                     line)
            for ref, held, line in fn.calls:
                if not held or (m.path, line) in seen_211:
                    continue
                for callee in _resolve(mods, m, key, ref):
                    blk = may_block.get(callee)
                    if blk is None:
                        continue
                    seen_211.add((m.path, line))
                    emit(m, "A211",
                         f"call into '{callee[2]}' (which can block: "
                         f"'{blk[0]}' at {blk[1]}) while "
                         f"{_held_names(held)} is held", line)
                    break
            for line, in_while in fn.cond_waits:
                if not in_while:
                    emit(m, "A213",
                         "Condition.wait outside a while loop: wakeups are "
                         "spurious by contract — re-check the predicate in "
                         "a loop", line)
            if m.path in _A212_ALLOWED_FILES:
                continue
            if key in reachable:
                for name, held, line in fn.global_writes:
                    if held:
                        continue
                    emit(m, "A212",
                         f"module-level mutable '{name}' written from "
                         f"thread-reachable '{key[2]}' with no lock held — "
                         "a cross-thread read-modify-write race", line)

        # -- A214: daemon spawns never joined -----------------------------
        for binding, line in m.daemon_spawns:
            if binding is not None and binding in m.joined_names:
                continue
            who = f"'{binding}'" if binding else "an unbound Thread"
            emit(m, "A214",
                 f"daemon thread {who} is never joined in this module: at "
                 "interpreter exit it dies mid-critical-section, leaking "
                 "locks and half-written state — join it in a shutdown "
                 "path (or pragma with the reason)", line)
    return rep


def _held_names(held: FrozenSet[LockKey]) -> str:
    return "/".join(sorted(_lock_name(k) for k in held))


def _thread_reachable(mods: Dict[str, _Module], m: _Module) -> Set[FnKey]:
    """Function keys reachable (resolvable calls, bounded) from any of this
    module's Thread targets."""
    frontier: List[FnKey] = []
    for name, _line in m.thread_targets:
        frontier.extend(m.by_name.get(name, []))
    seen: Set[FnKey] = set()
    depth = 0
    while frontier and depth < _MAX_PASSES:
        nxt: List[FnKey] = []
        for key in frontier:
            if key in seen:
                continue
            seen.add(key)
            mod = mods.get(key[0])
            fn = mod.funcs.get(key) if mod else None
            if fn is None:
                continue
            for ref, _held, _line in fn.calls:
                nxt.extend(_resolve(mods, mod, key, ref))
        frontier = nxt
        depth += 1
    return seen


def analyze_source(src: str, relpath: str = "<string>") -> Report:
    """Single-file convenience (the fixture tests): whole-package analysis
    over a one-file package."""
    return analyze_sources({_rule_path(relpath): src})


def analyze_tree(root: Optional[str] = None) -> Report:
    """Analyze every ``.py`` under ``root`` (default: the installed
    mlsl_tpu_torch package) as one program — the form the lint gate and
    ``--concurrency`` run."""
    root = os.path.abspath(root or package_root())
    files: Dict[str, str] = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", "build", ".git",
                                    "node_modules", ".ruff_cache")
                       and not (d == "fixtures"
                                and os.path.basename(dirpath) == "tests")]
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            with open(path, "r", encoding="utf-8") as f:
                files[_rule_path(rel)] = f.read()
    return analyze_sources(files)
