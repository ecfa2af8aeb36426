"""R4 — lock-scope weight.

Blocking or table-sized work inside a ``with <lock>:`` body serializes
every other thread on that lock: ``import bisect`` was found executing
inside ``Histogram.observe``'s locked path, and table scans under the
registry lock on the scrape path.  The rule recognizes a guard by
name (terminal component matching ``lock``/``mutex``/``mu``) and flags
the known-heavy operations in its body.  Work inside a nested ``def`` or
``lambda`` is NOT flagged — it runs later, when the lock is gone.
"""

from __future__ import annotations

import ast
import re
from typing import List

from ray_tpu_torch.devtools.raylint.core import (
    Finding, LintConfig, Project, SourceFile, dotted_name, make_finding,
)

_LOCK_NAME = re.compile(r"(?:^|_)(?:lock|locks|mutex|mu)$", re.IGNORECASE)

# dotted call names that block (or can block) while held
_BLOCKING_CALLS = {
    "time.sleep": "sleeps while every waiter spins",
    "subprocess.run": "spawns a process under the lock",
    "subprocess.Popen": "spawns a process under the lock",
    "subprocess.check_output": "spawns a process under the lock",
    "subprocess.check_call": "spawns a process under the lock",
    "os.system": "spawns a shell under the lock",
    "os.popen": "spawns a shell under the lock",
    "open": "file I/O under the lock",
    "json.dump": "serializes (possibly unbounded) data under the lock",
    "json.dumps": "serializes (possibly unbounded) data under the lock",
}
# socket-ish method calls (terminal attr) that block on the network
_BLOCKING_METHODS = {
    "recv", "recv_into", "recvfrom", "accept", "connect", "sendall",
    "makefile", "getaddrinfo", "gethostbyname",
}
# iterable-producing methods that mark a `sorted()` as table-sized
_TABLE_ITER = {"values", "items", "keys"}


def _lock_guard_name(item: ast.withitem) -> str:
    """The guard's dotted name when the with-item looks like a lock."""
    expr = item.context_expr
    if isinstance(expr, ast.Call):  # e.g. `with self._lock_for(x):`
        expr = expr.func
    name = dotted_name(expr)
    terminal = name.rsplit(".", 1)[-1] if name else ""
    return name if terminal and _LOCK_NAME.search(terminal) else ""


def _visit_locked(sf: SourceFile, node: ast.AST, lock: str,
                  flagged: dict) -> None:
    """Flag heavy work at ``node`` and in its subtree; prune
    deferred-execution scopes (defs/lambdas) whose bodies run after the
    lock is released."""
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        return
    if isinstance(node, (ast.Import, ast.ImportFrom)):
        if not sf.suppressed(node.lineno, "R4"):
            flagged.setdefault((node.lineno, "import"), make_finding(
                sf, "R4", node.lineno,
                f"import executed while holding {lock} (first import "
                f"takes the global import lock + disk I/O)",
                "hoist the import to module level",
                detail=f"import-under:{lock}"))
    elif isinstance(node, ast.Call):
        _flag_call(sf, node, lock, flagged)
    for child in ast.iter_child_nodes(node):
        _visit_locked(sf, child, lock, flagged)


def _flag_call(sf: SourceFile, node: ast.Call, lock: str,
               flagged: dict) -> None:
    name = dotted_name(node.func)
    terminal = name.rsplit(".", 1)[-1] if name else ""
    line = node.lineno
    if sf.suppressed(line, "R4"):
        return
    if name in _BLOCKING_CALLS:
        flagged.setdefault((line, name), make_finding(
            sf, "R4", line,
            f"{name}() inside `with {lock}:` — {_BLOCKING_CALLS[name]}",
            "move the call outside the locked region (snapshot under "
            "the lock, do the work after)",
            detail=f"blocking:{name}:under:{lock}"))
    elif terminal in _BLOCKING_METHODS and "." in name:
        flagged.setdefault((line, name), make_finding(
            sf, "R4", line,
            f"{name}() inside `with {lock}:` — network/socket I/O holds "
            f"the lock for a round trip",
            "move the I/O outside the locked region",
            detail=f"socket:{terminal}:under:{lock}"))
    elif name == "sorted" and node.args:
        arg = node.args[0]
        if (isinstance(arg, ast.Call)
                and isinstance(arg.func, ast.Attribute)
                and arg.func.attr in _TABLE_ITER):
            flagged.setdefault((line, "sorted"), make_finding(
                sf, "R4", line,
                f"sorted() over a table-sized iterable inside "
                f"`with {lock}:` — O(n log n) scan while held",
                "snapshot the rows under the lock, sort after release",
                detail=f"sorted-table:under:{lock}"))


def check_lock_scope_weight(project: Project,
                            config: LintConfig) -> List[Finding]:
    findings: List[Finding] = []
    for sf in project:
        if sf.tree is None:
            continue
        # one flagged-map per file: a nested `with` under an outer lock
        # is visited for both guards — the first (outermost) wins
        flagged: dict = {}
        for node in ast.walk(sf.tree):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            locks = [n for n in (_lock_guard_name(i) for i in node.items)
                     if n]
            if not locks:
                continue
            for stmt in node.body:
                _visit_locked(sf, stmt, locks[0], flagged)
        findings.extend(flagged.values())
    return findings


check_lock_scope_weight.RULE_ID = "R4"
check_lock_scope_weight.RULE_NAME = "lock-scope-weight"
