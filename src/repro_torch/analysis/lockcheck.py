"""Lock-discipline checker + the scan pass shared with the
thread-shared-state audit.

Rules (finding rule ids):

``locked-call``          a ``*_locked`` / ``@requires_lock`` function
                         called without the owning lock held (lexically
                         inside ``with <lock>``, or from a function
                         whose own contract holds the same lock).
``serialized-call``      a ``@requires_serialized`` function called
                         from outside the dispatcher surface (no
                         ``_svc_lock`` held, caller not serialized or
                         allowlisted).
``blocking-under-lock``  a blocking operation (``config.BLOCKING_CALLS``)
                         invoked while a NARROW lock is held.  Coarse
                         locks (``config.COARSE_LOCKS``) are exempt —
                         holding ``_svc_lock`` across service work is
                         the engine's design.
``blocking-in-worker``   a pool job body / done-callback / thread
                         target synchronizing on other pool work
                         (``Future.result``/``wait``/``flush``/``join``)
                         — the AsyncSwapper self-deadlock class.
``unordered-store-read`` a chunk-file read of a store path with no
                         preceding same-function ordering point
                         (``swapper.wait``/``swapper.submit``/own
                         ``write_chunk_file``) — the
                         restore-vs-AoT ``os.replace`` race class.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis import config
from repro_torch.analysis.astpass import (FunctionInfo, Program, attr_chain)
from repro_torch.analysis.findings import Finding

_ORDER_ATTRS = {"wait", "submit", "read", "read_async", "flush"}
_READ_FNS = {"read_chunk_file", "verify_chunk_file"}


@dataclass
class WriteSite:
    fn: FunctionInfo
    key: Tuple[str, str]               # (owner class | module, attr)
    line: int
    guarded: bool


@dataclass
class ScanData:
    """Side products of the lock scan, consumed by sharedstate."""
    writes: List[WriteSite] = field(default_factory=list)
    reads: Dict[str, Set[Tuple[str, str]]] = field(default_factory=dict)
    edges: Dict[str, Set[str]] = field(default_factory=dict)
    by_ident: Dict[str, FunctionInfo] = field(default_factory=dict)


def run(program: Program) -> Tuple[List[Finding], ScanData]:
    findings: List[Finding] = []
    data = ScanData()
    for mod in program.modules:
        for fn in mod.all_functions:
            data.by_ident.setdefault(fn.qualname + "@" + mod.modname, fn)
    # pass 1: per-function scan (also discovers worker-marked functions)
    for mod in program.modules:
        for fn in mod.all_functions:
            _FnScanner(program, fn, findings, data).scan()
    # pass 2: worker bodies (marks accumulated program-wide in pass 1)
    for mod in program.modules:
        for fn in mod.all_functions:
            if fn.worker or fn.ident in config.WORKER_ENTRIES:
                _WorkerScanner(program, fn, findings).scan()
    return findings, data


def _match_blocking(program: Program, fn: FunctionInfo, call: ast.Call,
                    registry, held: List[str]) -> Optional[dict]:
    f = call.func
    chain = attr_chain(f)
    for e in registry:
        if "attr" in e:
            if not (isinstance(f, ast.Attribute) and f.attr == e["attr"]):
                continue
            rc = chain[:-1] if chain else ()
            if "recv" in e and not any(r in rc for r in e["recv"]):
                continue
            if "not_recv" in e and any(r in rc for r in e["not_recv"]):
                continue                # e.g. os.path.join is not a join
            if e.get("allow_held"):
                tok = program.lock_token(f.value, fn)
                if tok is not None and tok in held:
                    continue
            return e
        if "name" in e:
            if isinstance(f, ast.Name) and f.id == e["name"]:
                return e
    return None


class _FnScanner:
    """One function body: lock rules + write/read/edge collection."""

    def __init__(self, program: Program, fn: FunctionInfo,
                 findings: List[Finding], data: ScanData):
        self.p = program
        self.fn = fn
        self.findings = findings
        self.data = data
        self.reads = data.reads.setdefault(self._node_id(fn), set())
        self.edges = data.edges.setdefault(self._node_id(fn), set())
        self.globals_decl: Set[str] = set()
        for n in ast.walk(fn.node):
            if isinstance(n, ast.Global):
                self.globals_decl.update(n.names)
        # contract-held locks on entry (the function's own invariant)
        held: List[str] = []
        tok = program.contract_token(fn)
        if tok:
            held.append(tok)
        if self._serialized_context():
            held.append("ServiceRouter._svc_lock")
        self.entry_held = held
        # ordering events / read sites for the unordered-read rule
        self.order_lines: List[int] = []
        self.read_sites: List[Tuple[int, str]] = []
        self.in_order_call = 0

    @staticmethod
    def _node_id(fn: FunctionInfo) -> str:
        return f"{fn.qualname}@{fn.module.modname}"

    def _serialized_context(self) -> bool:
        cur: Optional[FunctionInfo] = self.fn
        while cur is not None:
            if cur.serialized:
                return True
            cur = cur.parent
        return False

    def _allowlisted_serial_caller(self) -> bool:
        cur: Optional[FunctionInfo] = self.fn
        while cur is not None:
            if cur.name in config.SERIALIZED_CALLER_ALLOWLIST or \
                    cur.ident in config.SERIALIZED_CALLER_ALLOWLIST:
                return True
            cur = cur.parent
        return False

    def _emit(self, rule: str, line: int, message: str):
        self.findings.append(Finding(
            checker="lock", rule=rule, file=self.fn.module.relpath,
            line=line, scope=self.fn.qualname, message=message))

    def scan(self):
        for stmt in self.fn.node.body:
            self._scan(stmt, list(self.entry_held))
        # unordered-read resolution: a read site is ordered when ANY
        # ordering point appears earlier in the same function (or the
        # function's contract is itself a worker job body — ordering
        # then happened at submit time)
        for line, what in self.read_sites:
            if any(ol <= line for ol in self.order_lines):
                continue
            self._emit(
                "unordered-store-read", line,
                f"{what} reads a store path with no preceding "
                f"swapper.wait/submit ordering point: races an "
                f"in-flight same-key AoT write's os.replace "
                f"(restore-vs-AoT race class)")

    # -- recursion ------------------------------------------------------ #
    def _scan(self, node, held: List[str]):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return                      # scanned as its own function
        if isinstance(node, ast.Lambda):
            self._scan_ordering_only(node.body)
            return                      # deferred body: lock not held
        if isinstance(node, (ast.With, ast.AsyncWith)):
            new = list(held)
            for item in node.items:
                self._scan(item.context_expr, held)
                tok = self.p.lock_token(item.context_expr, self.fn)
                if tok:
                    new.append(tok)
            for stmt in node.body:
                self._scan(stmt, new)
            return
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for tgt in targets:
                self._record_write_target(tgt, held, node.lineno)
        if isinstance(node, ast.Call):
            self._check_call(node, held)
        if isinstance(node, ast.Attribute) and \
                isinstance(node.ctx, ast.Load):
            self._record_read(node)
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            if node.id in self.fn.module.mutable_globals:
                self.reads.add((self.fn.module.modname, node.id))
        for child in ast.iter_child_nodes(node):
            self._scan(child, held)

    def _scan_ordering_only(self, node):
        """Lambda bodies still participate in the unordered-read rule
        (``with_retries(lambda: read_chunk_file(...))``)."""
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                self._note_ordering(sub)

    # -- calls ----------------------------------------------------------- #
    def _check_call(self, node: ast.Call, held: List[str]):
        chain = attr_chain(node.func)
        name = chain[-1] if chain else None
        self._note_ordering(node)
        # worker discovery: functions handed to pools/threads/callbacks
        if name in ("submit", "add_done_callback"):
            for arg in node.args:
                self._mark_worker_arg(arg)
        elif name == "Thread":
            for kw in node.keywords:
                if kw.arg == "target":
                    self._mark_worker_arg(kw.value)
        target = self.p.resolve_call(node, self.fn)
        if target is not None:
            self.edges.add(self._node_id(target))
        # rule: locked-call
        req = self.p.contract_token(target) if target is not None else (
            "?" if name and name.endswith("_locked") else None)
        if req is not None and not self._lock_satisfied(req, held):
            want = req if req != "?" else "its owning lock"
            self._emit("locked-call", node.lineno,
                       f"call to {name} requires {want} held "
                       f"(held: {sorted(set(held)) or 'none'})")
        # rule: serialized-call
        if target is not None and target.serialized:
            ok = (self._serialized_context()
                  or any(t in config.COARSE_LOCKS for t in held)
                  or self._allowlisted_serial_caller())
            if not ok:
                self._emit(
                    "serialized-call", node.lineno,
                    f"call to {target.qualname} requires the "
                    f"dispatcher (serialized under "
                    f"ServiceRouter._svc_lock)")
        # rule: blocking-under-lock (narrow locks only)
        narrow = [t for t in held if t not in config.COARSE_LOCKS]
        if narrow:
            e = _match_blocking(self.p, self.fn, node,
                                config.BLOCKING_CALLS, held)
            if e is not None:
                what = name or "<call>"
                self._emit("blocking-under-lock", node.lineno,
                           f"{what}(): {e['why']} while holding "
                           f"{sorted(set(narrow))}")

    def _lock_satisfied(self, req: str, held: List[str]) -> bool:
        if req == "?":
            return bool(held)
        if req in held:
            return True
        # unresolved-owner tokens ("?.X") satisfy a same-attr contract
        attr = req.rsplit(".", 1)[-1].rsplit(":", 1)[-1]
        return any(h.startswith("?") and h.endswith(f".{attr}")
                   for h in held)

    def _mark_worker_arg(self, arg):
        if isinstance(arg, ast.Lambda):
            _WorkerScanner(self.p, self.fn, self.findings,
                           override_node=arg.body).scan()
            return
        chain = attr_chain(arg)
        if chain is None:
            return
        if len(chain) == 1:
            cur: Optional[FunctionInfo] = self.fn
            while cur is not None:
                if chain[0] in cur.children:
                    cur.children[chain[0]].worker = True
                    return
                cur = cur.parent
            got = self.fn.module.functions.get(chain[0])
            if got is not None:
                got.worker = True
        elif chain[0] == "self" and len(chain) == 2 and self.fn.cls:
            m = self.fn.cls.methods.get(chain[1])
            if m is not None:
                m.worker = True

    # -- unordered-read bookkeeping -------------------------------------- #
    def _note_ordering(self, node: ast.Call):
        chain = attr_chain(node.func)
        name = chain[-1] if chain else None
        if chain and len(chain) >= 2 and name in _ORDER_ATTRS and \
                "swapper" in chain[:-1]:
            self.order_lines.append(node.lineno)
            return
        if name == "write_chunk_file":
            self.order_lines.append(node.lineno)
            return
        if name in _READ_FNS and self._has_store_path_arg(node):
            self.read_sites.append((node.lineno, name))

    @staticmethod
    def _has_store_path_arg(node: ast.Call) -> bool:
        for arg in node.args:
            for sub in ast.walk(arg):
                if isinstance(sub, ast.Call) and \
                        isinstance(sub.func, ast.Attribute) and \
                        sub.func.attr == "_path":
                    return True
        return False

    # -- shared-state collection ----------------------------------------- #
    def _record_write_target(self, tgt, held: List[str], line: int):
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for e in tgt.elts:
                self._record_write_target(e, held, line)
            return
        base = tgt
        while isinstance(base, ast.Subscript):
            base = base.value
        chain = attr_chain(base)
        if chain is None:
            return
        key: Optional[Tuple[str, str]] = None
        if chain[0] == "self" and len(chain) >= 2 and self.fn.cls:
            owner = self.p.resolve_class_chain(chain, self.fn.cls)
            if owner is not None:
                key = (owner.name, chain[-1])
        elif len(chain) == 1:
            nm = chain[0]
            if nm in self.fn.module.mutable_globals or \
                    nm in self.globals_decl:
                key = (self.fn.module.modname, nm)
        if key is None:
            return
        if self.fn.name == "__init__" and self.fn.parent is None:
            return                       # construction precedes sharing
        self.data.writes.append(WriteSite(
            fn=self.fn, key=key, line=line,
            guarded=any(t != "?" for t in held)))

    def _record_read(self, node: ast.Attribute):
        chain = attr_chain(node)
        if chain and chain[0] == "self" and len(chain) >= 2 and \
                self.fn.cls:
            owner = self.p.resolve_class_chain(chain, self.fn.cls)
            if owner is not None:
                self.reads.add((owner.name, chain[-1]))


class _WorkerScanner:
    """Worker-body pass: only the blocking-in-worker rule (the normal
    rules already ran in pass 1)."""

    def __init__(self, program: Program, fn: FunctionInfo,
                 findings: List[Finding], override_node=None):
        self.p = program
        self.fn = fn
        self.findings = findings
        self.node = override_node if override_node is not None \
            else fn.node

    def scan(self):
        body = self.node if not hasattr(self.node, "body") \
            else self.node.body
        if isinstance(body, list):
            for stmt in body:
                self._scan(stmt, [])
        else:
            self._scan(body, [])

    def _scan(self, node, held: List[str]):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            new = list(held)
            for item in node.items:
                self._scan(item.context_expr, held)
                tok = self.p.lock_token(item.context_expr, self.fn)
                if tok:
                    new.append(tok)
            for stmt in node.body:
                self._scan(stmt, new)
            return
        if isinstance(node, ast.Call):
            e = _match_blocking(self.p, self.fn, node,
                                config.WORKER_BLOCKING, held)
            if e is not None:
                chain = attr_chain(node.func)
                what = chain[-1] if chain else "<call>"
                self.findings.append(Finding(
                    checker="lock", rule="blocking-in-worker",
                    file=self.fn.module.relpath, line=node.lineno,
                    scope=self.fn.qualname,
                    message=f"{what}() on a worker-thread job body: "
                            f"{e['why']}"))
        for child in ast.iter_child_nodes(node):
            self._scan(child, held)
