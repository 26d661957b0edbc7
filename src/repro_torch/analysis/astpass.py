"""Shared AST collection layer: parse every module once, index classes,
locks, methods, markers, and nested functions for the checkers.

Resolution is deliberately name-based (no import graph, no type
inference): the stack wires its layers through a FIXED vocabulary of
attribute names (``config.ATTR_TYPES``), so ``self.store.write(...)``
resolves by convention.  Unresolvable receivers stay unresolved — the
checkers treat them conservatively per rule.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis import config

# call expressions whose assignment marks an attribute/global as a lock
LOCK_FACTORIES = {"Lock", "RLock", "Condition", "OrderedLock",
                  "witness_lock", "witness_rlock", "witness_condition"}


def attr_chain(node) -> Optional[Tuple[str, ...]]:
    """``self.store._lock`` -> ("self", "store", "_lock"); None when the
    expression is not a plain Name/Attribute chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return tuple(parts)
    return None


@dataclass
class FunctionInfo:
    name: str
    qualname: str                       # "Class.method" | "fn" | "fn.<locals>.g"
    node: ast.AST                       # FunctionDef / AsyncFunctionDef
    module: "ModuleInfo"
    cls: Optional["ClassInfo"]
    parent: Optional["FunctionInfo"] = None
    requires_lock: Optional[str] = None
    serialized: bool = False
    worker: bool = False                # runs on a pool/IO thread
    children: Dict[str, "FunctionInfo"] = field(default_factory=dict)

    @property
    def ident(self) -> str:
        """Config-facing identity: Class.method or bare function name."""
        if self.cls is not None and self.parent is None:
            return f"{self.cls.name}.{self.name}"
        return self.qualname


@dataclass
class ClassInfo:
    name: str
    module: "ModuleInfo"
    node: ast.ClassDef
    lock_attrs: Dict[str, str] = field(default_factory=dict)  # attr->kind
    methods: Dict[str, FunctionInfo] = field(default_factory=dict)


@dataclass
class ModuleInfo:
    relpath: str                        # repo-relative posix path
    modname: str                        # "repro.core.swap"
    tree: ast.Module
    classes: Dict[str, ClassInfo] = field(default_factory=dict)
    functions: Dict[str, FunctionInfo] = field(default_factory=dict)
    module_locks: Set[str] = field(default_factory=set)
    mutable_globals: Set[str] = field(default_factory=set)
    all_functions: List[FunctionInfo] = field(default_factory=list)


class Program:
    """All modules of one analysis run, with cross-module name indexes."""

    def __init__(self):
        self.modules: List[ModuleInfo] = []
        self.classes: Dict[str, ClassInfo] = {}
        self.functions: Dict[str, FunctionInfo] = {}  # module-level by name

    def add_source(self, source: str, relpath: str, modname: str):
        tree = ast.parse(source, filename=relpath)
        mod = ModuleInfo(relpath=relpath, modname=modname, tree=tree)
        _Collector(mod).visit(tree)
        self.modules.append(mod)
        for cname, cinfo in mod.classes.items():
            self.classes.setdefault(cname, cinfo)
        for fname, finfo in mod.functions.items():
            self.functions.setdefault(fname, finfo)
        return mod

    # -- resolution helpers -------------------------------------------- #
    def resolve_class_chain(self, chain: Tuple[str, ...],
                            cls: Optional[ClassInfo]) -> Optional[ClassInfo]:
        """Resolve the class owning ``chain[-1]`` for a chain rooted at
        ``self`` (``("self", "store", "X")`` -> DiskStore)."""
        if not chain or chain[0] != "self":
            return None
        cur = cls
        for mid in chain[1:-1]:
            cname = config.ATTR_TYPES.get(mid)
            cur = self.classes.get(cname) if cname else None
            if cur is None:
                return None
        return cur

    def resolve_call(self, call: ast.Call,
                     fn: FunctionInfo) -> Optional[FunctionInfo]:
        """Resolve a call expression to a FunctionInfo, or None."""
        chain = attr_chain(call.func)
        if chain is None:
            return None
        if len(chain) == 1:
            name = chain[0]
            cur = fn
            while cur is not None:              # nested defs shadow module
                if name in cur.children:
                    return cur.children[name]
                cur = cur.parent
            got = fn.module.functions.get(name)
            return got if got is not None else self.functions.get(name)
        owner = self.resolve_class_chain(chain, fn.cls)
        if owner is not None:
            return owner.methods.get(chain[-1])
        return None

    def lock_token(self, expr, fn: FunctionInfo) -> Optional[str]:
        """Canonical token for a lock expression, e.g.
        ``DiskStore._lock`` / ``repro.core.restore:_IO_LOCK`` /
        ``?._lock`` (shape-matched but unresolved owner)."""
        chain = attr_chain(expr)
        if chain is None:
            return None
        if len(chain) == 1:
            name = chain[0]
            if name in fn.module.module_locks:
                return f"{fn.module.modname}:{name}"
            if "lock" in name.lower():
                return f"?:{name}"
            return None
        last = chain[-1]
        owner = self.resolve_class_chain(chain, fn.cls)
        if owner is not None and last in owner.lock_attrs:
            return f"{owner.name}.{last}"
        if "lock" in last.lower() or last == "_cv":
            return f"?.{last}"
        return None

    def contract_token(self, fn: FunctionInfo) -> Optional[str]:
        """The lock a function's CONTRACT says is held on entry:
        from ``@requires_lock`` or the ``*_locked`` naming convention.
        ``"?"`` = convention applies but the owning lock is ambiguous
        (any held lock satisfies the call-site check)."""
        if fn.requires_lock:
            ln = fn.requires_lock
            if fn.cls is not None:
                return f"{fn.cls.name}.{ln}"
            return f"{fn.module.modname}:{ln}"
        if fn.name.endswith("_locked"):
            if fn.cls is not None and len(fn.cls.lock_attrs) == 1:
                only = next(iter(fn.cls.lock_attrs))
                return f"{fn.cls.name}.{only}"
            return "?"
        return None


def _decorator_markers(node) -> Tuple[Optional[str], bool]:
    """-> (requires_lock name, serialized) from a def's decorators."""
    req, ser = None, False
    for deco in node.decorator_list:
        if isinstance(deco, ast.Call):
            chain = attr_chain(deco.func)
            if chain and chain[-1] == "requires_lock" and deco.args:
                a0 = deco.args[0]
                if isinstance(a0, ast.Constant) and isinstance(a0.value, str):
                    req = a0.value
        else:
            chain = attr_chain(deco)
            if chain and chain[-1] == "requires_serialized":
                ser = True
    return req, ser


def _is_lock_factory(value) -> Optional[str]:
    """-> lock kind if ``value`` is a lock-constructing call."""
    if not isinstance(value, ast.Call):
        return None
    chain = attr_chain(value.func)
    if not chain or chain[-1] not in LOCK_FACTORIES:
        return None
    name = chain[-1]
    if name in ("Condition", "witness_condition"):
        return "condition"
    if name in ("RLock", "witness_rlock"):
        return "rlock"
    return "lock"


class _Collector(ast.NodeVisitor):
    """One pass over a module: classes, locks, functions (incl. nested),
    markers, mutable module globals."""

    def __init__(self, mod: ModuleInfo):
        self.mod = mod
        self.cls: Optional[ClassInfo] = None
        self.fn: Optional[FunctionInfo] = None

    # -- module / class level ------------------------------------------ #
    def visit_Module(self, node):
        for stmt in node.body:
            if isinstance(stmt, ast.Assign):
                self._module_assign(stmt)
            self.visit(stmt)

    def _module_assign(self, stmt: ast.Assign):
        for tgt in stmt.targets:
            if not isinstance(tgt, ast.Name):
                continue
            if _is_lock_factory(stmt.value):
                self.mod.module_locks.add(tgt.id)
            elif isinstance(stmt.value, (ast.Dict, ast.List, ast.Set,
                                         ast.DictComp, ast.ListComp,
                                         ast.SetComp)):
                self.mod.mutable_globals.add(tgt.id)

    def visit_ClassDef(self, node):
        prev_cls, prev_fn = self.cls, self.fn
        cinfo = ClassInfo(name=node.name, module=self.mod, node=node)
        # nested classes are indexed flat (none in this repo's core)
        self.mod.classes[node.name] = cinfo
        self.cls, self.fn = cinfo, None
        self.generic_visit(node)
        self.cls, self.fn = prev_cls, prev_fn

    # -- functions ------------------------------------------------------ #
    def _enter_function(self, node):
        req, ser = _decorator_markers(node)
        if self.fn is not None:
            qual = f"{self.fn.qualname}.<locals>.{node.name}"
        elif self.cls is not None:
            qual = f"{self.cls.name}.{node.name}"
        else:
            qual = node.name
        finfo = FunctionInfo(name=node.name, qualname=qual, node=node,
                             module=self.mod, cls=self.cls,
                             parent=self.fn, requires_lock=req,
                             serialized=ser)
        if self.fn is not None:
            self.fn.children[node.name] = finfo
        elif self.cls is not None:
            self.cls.methods[node.name] = finfo
        else:
            self.mod.functions[node.name] = finfo
        self.mod.all_functions.append(finfo)
        return finfo

    def visit_FunctionDef(self, node):
        finfo = self._enter_function(node)
        prev = self.fn
        self.fn = finfo
        # inside __init__, detect `self.X = threading.Lock()` etc.
        if self.cls is not None and prev is None:
            for stmt in ast.walk(node):
                if isinstance(stmt, ast.Assign):
                    kind = _is_lock_factory(stmt.value)
                    if kind:
                        for tgt in stmt.targets:
                            ch = attr_chain(tgt)
                            if ch and len(ch) == 2 and ch[0] == "self":
                                self.cls.lock_attrs[ch[1]] = kind
        self.generic_visit(node)
        self.fn = prev

    visit_AsyncFunctionDef = visit_FunctionDef
