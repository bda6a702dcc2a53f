#!/usr/bin/env python
"""Dependency-free codestyle gate (the reference gates style with a
flake8 tox env, `/root/reference/tox.ini:75-79`; full linting runs as
ruff in CI — this checker enforces the core rules in any environment,
including ones with no lint tools installed).

Checks: per source line — length <= 88, no trailing whitespace, no
tab indentation, no ``from module import *`` outside ``__init__``
files, LF newlines; per module (AST) — no unused imports.  Exits
non-zero listing every violation.
"""

from __future__ import annotations

import ast
import re
import sys
from pathlib import Path

MAX_LEN = 88
ROOTS = ("frei_tpu", "tests", "tools", "bench.py", "chip_smoke.py",
         "__graft_entry__.py")
STAR_IMPORT = re.compile(r"^\s*from\s+\S+\s+import\s+\*")


def check_file(path: Path) -> list:
    problems = []
    raw = path.read_bytes()
    if b"\r" in raw:
        problems.append((0, "CRLF/CR line ending"))
    for n, line in enumerate(raw.decode("utf-8").splitlines(), 1):
        if len(line) > MAX_LEN:
            problems.append((n, f"line too long ({len(line)} > {MAX_LEN})"))
        if line != line.rstrip():
            problems.append((n, "trailing whitespace"))
        if line.startswith("\t") or line.lstrip(" ").startswith("\t"):
            problems.append((n, "tab indentation"))
        if STAR_IMPORT.match(line) and path.name != "__init__.py":
            problems.append((n, "star import outside __init__"))
    return problems


def check_unused_imports(path: Path) -> list:
    """AST-based unused-import check (ruff F401 equivalent).
    ``__init__.py`` re-exports and explicit ``# noqa`` lines are
    exempt."""
    if path.name == "__init__.py":
        return []
    src = path.read_text()
    tree = ast.parse(src)
    lines = src.splitlines()
    imports = {}   # local name -> (lineno, display)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                name = (a.asname or a.name).split(".")[0]
                imports[name] = (node.lineno, a.name)
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for a in node.names:
                if a.name == "*":
                    continue
                imports[a.asname or a.name] = (node.lineno, a.name)
    used = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            pass  # the base Name is visited separately
    # names referenced in __all__ strings count as used
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            used.add(node.value)
    problems = []
    for name, (lineno, display) in imports.items():
        if name not in used and "noqa" not in lines[lineno - 1]:
            problems.append((lineno, f"unused import {display!r}"))
    return problems


def main() -> int:
    repo = Path(__file__).resolve().parent.parent
    failures = 0
    for root in ROOTS:
        p = repo / root
        files = [p] if p.is_file() else sorted(p.rglob("*.py"))
        for f in files:
            for n, msg in check_file(f) + check_unused_imports(f):
                print(f"{f.relative_to(repo)}:{n}: {msg}")
                failures += 1
    if failures:
        print(f"codestyle: {failures} violation(s)")
        return 1
    print("codestyle: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
