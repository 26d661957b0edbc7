"""Finding record + stable fingerprints for baseline diffing."""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Dict


@dataclass(frozen=True)
class Finding:
    """One analyzer finding.

    ``fingerprint`` deliberately excludes the line number so pure code
    motion doesn't churn the baseline file: identity is
    (checker, rule, file, scope, message).
    """
    checker: str          # "lock" | "jit" | "shared"
    rule: str             # e.g. "blocking-under-lock"
    file: str             # repo-relative posix path
    line: int
    scope: str            # enclosing qualname, e.g. "AsyncSwapper.wait"
    message: str

    @property
    def fingerprint(self) -> str:
        ident = "|".join((self.checker, self.rule, self.file,
                          self.scope, self.message))
        return hashlib.sha1(ident.encode()).hexdigest()[:16]

    def to_dict(self) -> Dict[str, Any]:
        return {"checker": self.checker, "rule": self.rule,
                "file": self.file, "line": self.line,
                "scope": self.scope, "message": self.message,
                "fingerprint": self.fingerprint}

    def render(self) -> str:
        return (f"{self.file}:{self.line}: [{self.checker}/{self.rule}] "
                f"{self.scope}: {self.message}")

    def sort_key(self):
        return (self.file, self.line, self.checker, self.rule,
                self.message)
