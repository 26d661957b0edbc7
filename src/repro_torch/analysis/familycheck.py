"""family-dispatch checker.

Rule:

``string-dispatch``  (F1) a comparison against a ``.family`` attribute
                     (``==``, ``!=``, ``in``, ``not in``) outside the
                     registry/config layer.  The KVSpec redesign
                     moved every per-family capability into the
                     declarative spec; a family-string comparison in
                     engine code re-creates the ``mc.family ==
                     "dense"`` forks that made adding the seventh
                     model family a cross-layer edit (the old
                     core/executor.py gates live on as
                     ``fixtures/family_dispatch.py``).  Fix: declare
                     the capability as a ``KVSpec`` field and read
                     THAT.

The allowlist (``config.FAMILY_DISPATCH_ALLOWED_FILES`` /
``_PREFIXES``) covers the two legitimate dispatch points — the model
registry, which maps family name -> model class, and the config
tables, which are keyed by family name — plus the spec module's own
docstring examples.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis import config
from repro_torch.analysis.astpass import ModuleInfo, Program, attr_chain
from repro_torch.analysis.findings import Finding

_OPS = {ast.Eq: "==", ast.NotEq: "!=", ast.In: "in", ast.NotIn: "not in"}


def run(program: Program) -> List[Finding]:
    findings: List[Finding] = []
    for mod in program.modules:
        if _allowed(mod.relpath):
            continue
        _Scanner(mod, findings).visit(mod.tree)
    return findings


def _allowed(relpath: str) -> bool:
    if relpath in config.FAMILY_DISPATCH_ALLOWED_FILES:
        return True
    return relpath.startswith(config.FAMILY_DISPATCH_ALLOWED_PREFIXES)


def _family_chain(node):
    """The attr chain when ``node`` is ``<recv>.family`` (or the bare
    name ``family``, the common local-alias form)."""
    chain = attr_chain(node)
    if chain and chain[-1] == "family":
        return chain
    return None


class _Scanner(ast.NodeVisitor):
    """Track the enclosing qualname; flag family-string comparisons."""

    def __init__(self, mod: ModuleInfo, findings: List[Finding]):
        self.mod = mod
        self.findings = findings
        self.stack: List[str] = []

    def _scoped(self, node):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_ClassDef = _scoped
    visit_FunctionDef = _scoped
    visit_AsyncFunctionDef = _scoped

    def visit_Compare(self, node: ast.Compare):
        sides = [node.left] + list(node.comparators)
        ops = [type(op) for op in node.ops]
        if any(op in _OPS for op in ops):
            for side in sides:
                chain = _family_chain(side)
                if chain:
                    op = next(_OPS[o] for o in ops if o in _OPS)
                    self.findings.append(Finding(
                        checker="family", rule="string-dispatch",
                        file=self.mod.relpath, line=node.lineno,
                        scope=".".join(self.stack) or "<module>",
                        message=(f"capability fork on "
                                 f"`{'.'.join(chain)} {op} ...`: declare "
                                 f"the capability as a KVSpec field and "
                                 f"branch on the spec")))
                    break
        self.generic_visit(node)
