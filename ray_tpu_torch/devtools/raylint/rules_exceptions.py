"""R2 — exception-shadow.

A channel bug class, generalized: ``TimeoutError`` is a subclass of
``OSError``, so an ``except OSError`` arm that closes a channel also
eats the timeout that a caller upstream was supposed to see.  Two
shapes of the same mistake:

- **dead handler**: within one ``try``, a broad ``except`` lexically
  precedes a narrower one — the narrow arm can never run (CPython
  matches handlers top-down).
- **swallowed raise**: a ``raise Narrow(...)`` inside the try body whose
  own ``except Broad`` arm catches it (Narrow ⊂ Broad, strictly) and
  never re-raises — the raise was written to escape the function but
  can't.

Subclass facts come from the real builtin exception hierarchy (resolved
via ``builtins`` at analysis time), so ``TimeoutError ⊂ OSError ⊂
Exception`` needs no hand-maintained table.  Dotted or unresolvable
names (``socket.timeout``, project exceptions) fall back to exact-name
matching, which still catches duplicated arms.
"""

from __future__ import annotations

import ast
import builtins
from typing import List, Optional, Sequence, Tuple

from ray_tpu_torch.devtools.raylint.core import (
    Finding, LintConfig, Project, SourceFile, dotted_name, make_finding,
)


def _resolve(name: str) -> Optional[type]:
    """The builtin exception class a handler name refers to, if any."""
    if "." in name:  # dotted (socket.timeout, project exc): name-match only
        return None
    obj = getattr(builtins, name, None)
    if isinstance(obj, type) and issubclass(obj, BaseException):
        return obj
    return None


def _handler_names(h: ast.ExceptHandler) -> List[str]:
    """The caught type names of one arm ([] for a bare ``except:``)."""
    if h.type is None:
        return ["BaseException"]
    elts = h.type.elts if isinstance(h.type, ast.Tuple) else [h.type]
    return [dotted_name(e) or "<dynamic>" for e in elts]


def _subsumes(broad: str, narrow: str) -> bool:
    """True when an ``except broad`` arm would catch ``narrow``."""
    if broad == narrow:
        return True
    b, n = _resolve(broad), _resolve(narrow)
    if b is not None and n is not None:
        return issubclass(n, b)
    return False


def _strictly_subsumes(broad: str, narrow: str) -> bool:
    b, n = _resolve(broad), _resolve(narrow)
    return (b is not None and n is not None and b is not n
            and issubclass(n, b))


def _reraises(h: ast.ExceptHandler) -> bool:
    """The arm lets the exception (or a replacement) escape.  A raise
    inside a def/lambda DEFINED in the arm doesn't count — it runs
    later, elsewhere; the caught exception is still swallowed here."""
    stack: List[ast.AST] = list(h.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Raise):
            return True
        stack.extend(ast.iter_child_nodes(node))
    return False


def _body_raises(try_node: ast.Try) -> List[Tuple[str, int]]:
    """(exc name, line) for every ``raise Name(...)`` directly protected
    by this try (nested trys and function defs shield their own)."""
    out: List[Tuple[str, int]] = []

    def walk_block(stmts: Sequence[ast.stmt]) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Try)):
                continue  # shielded by an inner scope / inner handlers
            if isinstance(stmt, ast.Raise) and stmt.exc is not None:
                target = stmt.exc
                if isinstance(target, ast.Call):
                    target = target.func
                name = dotted_name(target)
                if name:
                    out.append((name, stmt.lineno))
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if isinstance(sub, list):
                    walk_block(sub)

    walk_block(try_node.body)
    return out


def check_exception_shadow(project: Project,
                           config: LintConfig) -> List[Finding]:
    findings: List[Finding] = []
    for sf in project:
        if sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Try) or not node.handlers:
                continue
            findings.extend(_check_try(sf, node))
    return findings


def _check_try(sf: SourceFile, node: ast.Try) -> List[Finding]:
    findings: List[Finding] = []
    arms = [(h, _handler_names(h)) for h in node.handlers]

    # (a) dead handler: an earlier arm subsumes a later one entirely
    for j in range(1, len(arms)):
        hj, names_j = arms[j]
        for i in range(j):
            hi, names_i = arms[i]
            if all(any(_subsumes(b, n) for b in names_i)
                   for n in names_j) and names_j != ["<dynamic>"]:
                if not sf.suppressed(hj.lineno, "R2"):
                    findings.append(make_finding(
                        sf, "R2", hj.lineno,
                        f'`except {"/".join(names_j)}` can never run: '
                        f'`except {"/".join(names_i)}` at line '
                        f'{hi.lineno} already catches it',
                        "reorder the handlers narrowest-first (or delete "
                        "the dead arm)",
                        detail=f'dead-arm:{"/".join(names_j)}'
                               f'<{"/".join(names_i)}'))
                break

    # (b) swallowed raise: the try body raises Narrow, an arm catches a
    # strict superclass and never re-raises — the raise cannot escape
    for exc_name, raise_line in _body_raises(node):
        for h, names in arms:
            caught = [b for b in names if _subsumes(b, exc_name)]
            if not caught:
                continue
            if any(b == exc_name or not _strictly_subsumes(b, exc_name)
                   for b in caught):
                break  # caught exactly / unresolvable: assume intended
            if not _reraises(h) and not sf.suppressed(raise_line, "R2"):
                findings.append(make_finding(
                    sf, "R2", raise_line,
                    f"`raise {exc_name}` is swallowed by the broader "
                    f'`except {"/".join(names)}` at line {h.lineno} '
                    f"(it never leaves this try)",
                    "move the raise outside the try, or re-raise "
                    f"{exc_name} from the broad arm "
                    "(the TimeoutError-closes-channel bug class)",
                    detail=f'swallowed:{exc_name}<{"/".join(names)}'))
            break  # first matching arm wins in CPython
    return findings


check_exception_shadow.RULE_ID = "R2"
check_exception_shadow.RULE_NAME = "exception-shadow"
