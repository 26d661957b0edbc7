"""jit-discipline checker.

The port's counterpart of ``jax.jit`` is a captured CUDA graph: every
body of ``core/graphs.py`` is handed to ``capturable`` (the capture
helper, ``config.GRAPH_CAPTURE_HELPERS``), and J1 and J2 read those
bodies as they read the functions handed to ``jax.jit``, which they
keep flagging as the reference's analyzer does.  J3 applies to every
``*cache*`` accessor.

Rules:

``self-in-traced-fn``   (J1) a function handed to ``jax.jit``, or a
                        graph body handed to ``capturable``, closes
                        over ``self`` — retracing keys on object
                        identity, and mutable state silently bakes into
                        the trace (a graph bakes in what its capture
                        read).  The executor's idiom is to copy what it
                        needs into locals first
                        (``cs, nl = self.cs, self.n_layers``) or to
                        jit a BOUND leaf method (3+-element chain like
                        ``jax.jit(self.codec.insert)``), both of which
                        pass.
``host-call-in-jit``    (J2) host-side-effect call (print/open/
                        time.*/os.*/FAULTS.*/random.*) inside a traced
                        function or a graph body: runs once at trace
                        (capture) time, then never again; and in a
                        graph body a host sync (``.item()``, ``.cpu()``,
                        ``.numpy()``, ``.tolist()``, ``int()`` /
                        ``float()`` / ``bool()`` of a value), which
                        breaks the capture or bakes in one call's
                        value.
``unhashable-jit-key``  (J3) a jit-cache access keyed by something
                        unhashable (list/dict/set display) or by
                        ``id(...)`` — the ``id(model)`` cache bug:
                        ids are recycled after GC, so a dead model's
                        cache entry can serve a new model.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set

from repro_torch.analysis import config
from repro_torch.analysis.astpass import (FunctionInfo, ModuleInfo,
                                          Program, attr_chain)
from repro_torch.analysis.findings import Finding


def run(program: Program) -> List[Finding]:
    findings: List[Finding] = []
    for mod in program.modules:
        for fn in mod.all_functions:
            _scan_fn(program, mod, fn, findings)
    return findings


def _is_jit_call(node: ast.Call) -> bool:
    chain = attr_chain(node.func)
    return bool(chain) and chain[-1] == "jit"


def _is_capture_call(node: ast.Call) -> bool:
    chain = attr_chain(node.func)
    return bool(chain) and chain[-1] in config.GRAPH_CAPTURE_HELPERS


def _scan_fn(program: Program, mod: ModuleInfo, fn: FunctionInfo,
             findings: List[Finding]):
    for node in ast.walk(fn.node):
        if isinstance(node, ast.Call) and _is_jit_call(node):
            for arg in node.args[:1]:
                _check_traced(mod, fn, arg, findings)
        if isinstance(node, ast.Call) and _is_capture_call(node):
            for arg in node.args[:1]:
                _check_traced(mod, fn, arg, findings, graph=True)
        if isinstance(node, ast.Call):
            _check_cache_key(mod, fn, node, findings)
        if isinstance(node, ast.Subscript):
            _check_cache_subscript(mod, fn, node, findings)


# ------------------------------------------------------------------ #
# J1 / J2: the traced callable
# ------------------------------------------------------------------ #
def _check_traced(mod: ModuleInfo, fn: FunctionInfo, arg,
                  findings: List[Finding], graph: bool = False):
    body: Optional[ast.AST] = None
    label = "<traced>"
    what = "graph body" if graph else "traced function"
    helper = "capturable" if graph else "jax.jit"
    if isinstance(arg, ast.Lambda):
        body, label = arg.body, "<lambda>"
    elif isinstance(arg, ast.Call):
        # functools.partial(model.step, ...): the bound callable is
        # positional arg 0; partials over module functions resolve below
        chain = attr_chain(arg.func)
        if chain and chain[-1] == "partial" and arg.args:
            _check_traced(mod, fn, arg.args[0], findings, graph)
        return
    elif isinstance(arg, ast.Name):
        target = _lookup_local(fn, arg.id) or mod.functions.get(arg.id)
        if target is not None:
            body, label = target.node, target.qualname
    elif isinstance(arg, ast.Attribute):
        chain = attr_chain(arg)
        if chain and chain[0] == "self" and len(chain) == 2:
            # jax.jit(self.method): the trace captures `self`
            findings.append(Finding(
                checker="jit", rule="self-in-traced-fn",
                file=mod.relpath, line=arg.lineno, scope=fn.qualname,
                message=f"{helper}(self.{chain[1]}) traces a bound "
                        f"method of the ENGINE object: mutable self "
                        f"state bakes into the trace; jit a leaf "
                        f"callable or copy state to locals first"))
        # 3+-element chains (self.codec.insert) bind a leaf object —
        # accepted; model.step etc. unresolved — accepted
        return
    if body is None:
        return
    self_uses = [n for n in ast.walk(body)
                 if isinstance(n, ast.Name) and n.id == "self"]
    if self_uses:
        findings.append(Finding(
            checker="jit", rule="self-in-traced-fn",
            file=mod.relpath, line=self_uses[0].lineno,
            scope=fn.qualname,
            message=f"{what} {label} closes over `self`: "
                    f"copy the needed fields into locals before "
                    f"defining it"))
    for n in ast.walk(body):
        if isinstance(n, ast.Call):
            why = _host_call(n)
            if why:
                findings.append(Finding(
                    checker="jit", rule="host-call-in-jit",
                    file=mod.relpath, line=n.lineno, scope=fn.qualname,
                    message=f"{what} {label} calls {why}: "
                            f"host side effects run once at trace "
                            f"time, then never again"))
            elif graph and _host_sync(n):
                findings.append(Finding(
                    checker="jit", rule="host-call-in-jit",
                    file=mod.relpath, line=n.lineno, scope=fn.qualname,
                    message=f"{what} {label} calls {_host_sync(n)}: a "
                            f"host sync breaks the capture or bakes "
                            f"one call's value into the graph"))


def _lookup_local(fn: FunctionInfo, name: str) -> Optional[FunctionInfo]:
    cur: Optional[FunctionInfo] = fn
    while cur is not None:
        if name in cur.children:
            return cur.children[name]
        cur = cur.parent
    return None


def _host_call(node: ast.Call) -> Optional[str]:
    chain = attr_chain(node.func)
    if not chain:
        return None
    if len(chain) == 1 and chain[0] in config.JIT_HOST_CALL_NAMES:
        return f"{chain[0]}()"
    if len(chain) >= 2:
        if chain[0] in config.JIT_HOST_CALL_ROOTS:
            return ".".join(chain) + "()"
        if chain[:2] in config.JIT_HOST_CALL_CHAINS:
            return ".".join(chain) + "()"
    return None


def _host_sync(node: ast.Call) -> Optional[str]:
    """A call that reads a device value on the host: ``x.item()`` and
    the like, or ``int(x)`` / ``float(x)`` / ``bool(x)`` of anything but
    a constant."""
    if isinstance(node.func, ast.Attribute) and \
            node.func.attr in config.GRAPH_HOST_SYNC_ATTRS:
        return f".{node.func.attr}()"
    if isinstance(node.func, ast.Name) and \
            node.func.id in config.GRAPH_HOST_SYNC_NAMES and node.args and \
            not isinstance(node.args[0], ast.Constant):
        return f"{node.func.id}()"
    return None


# ------------------------------------------------------------------ #
# J3: cache-key hashability
# ------------------------------------------------------------------ #
def _is_cache_name(expr) -> bool:
    chain = attr_chain(expr)
    return bool(chain) and \
        config.JIT_CACHE_NAME_HINT in chain[-1].lower()


def _check_cache_key(mod: ModuleInfo, fn: FunctionInfo,
                     node: ast.Call, findings: List[Finding]):
    """``self._jit_cache_get(key, ...)`` / ``cache.get(key)`` style."""
    if not _is_cache_name(node.func):
        return
    if not node.args:
        return
    _check_key_expr(mod, fn, node.args[0], findings)


def _check_cache_subscript(mod: ModuleInfo, fn: FunctionInfo,
                           node: ast.Subscript,
                           findings: List[Finding]):
    """``self._cache[key]`` style."""
    if not _is_cache_name(node.value):
        return
    _check_key_expr(mod, fn, node.slice, findings)


def _check_key_expr(mod: ModuleInfo, fn: FunctionInfo, key,
                    findings: List[Finding]):
    resolved = key
    if isinstance(key, ast.Name):
        resolved = _last_assignment(fn, key.id) or key
    bad = _unhashable_reason(resolved)
    if bad:
        findings.append(Finding(
            checker="jit", rule="unhashable-jit-key",
            file=mod.relpath, line=key.lineno, scope=fn.qualname,
            message=f"jit-cache key {bad}; keys must be stable "
                    f"hashable values (tuples of config scalars), "
                    f"never identities or mutable containers"))


def _last_assignment(fn: FunctionInfo, name: str):
    """Last `name = <expr>` in the function body before use (textual)."""
    found = None
    for n in ast.walk(fn.node):
        if isinstance(n, ast.Assign):
            for tgt in n.targets:
                if isinstance(tgt, ast.Name) and tgt.id == name:
                    found = n.value
    return found


def _unhashable_reason(expr) -> Optional[str]:
    if isinstance(expr, (ast.List, ast.ListComp)):
        return "is a list (unhashable)"
    if isinstance(expr, (ast.Dict, ast.DictComp)):
        return "is a dict (unhashable)"
    if isinstance(expr, (ast.Set, ast.SetComp)):
        return "is a set (unhashable)"
    if isinstance(expr, ast.Call) and \
            isinstance(expr.func, ast.Name) and expr.func.id == "id":
        return "uses id(...) (recycled after GC — the stale-" \
               "cache bug)"
    if isinstance(expr, ast.Tuple):
        for elt in expr.elts:
            bad = _unhashable_reason(elt)
            if bad:
                return bad
    return None
