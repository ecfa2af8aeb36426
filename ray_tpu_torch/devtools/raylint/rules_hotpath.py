"""R3 — hot-path entropy, R8 — bare-thread hygiene.

R3: on this kernel one ``os.urandom`` read costs ~200us, so
``uuid4()``-per-task cost ~30% of task throughput before process-prefix
counters replaced those ids.  The rule keeps entropy calls out of
the modules on the submit/dispatch path; one-shot module-level seeding
(import time) is explicitly fine.

R8: a ``threading.Thread`` with neither ``daemon=`` nor a ``.join()``
anywhere in the module is a shutdown hang (non-daemon default) waiting
for its first unlucky teardown ordering.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set

from ray_tpu_torch.devtools.raylint.core import (
    Finding, LintConfig, Project, SourceFile, dotted_name, make_finding,
    parent_map,
)

# call targets that read kernel entropy (directly or transitively)
_ENTROPY_CALLS = {
    "uuid.uuid4", "uuid4", "uuid.uuid1", "uuid1",
    "os.urandom", "urandom",
    "secrets.token_bytes", "secrets.token_hex", "secrets.token_urlsafe",
    "secrets.randbits", "secrets.choice",
    "random.SystemRandom",
}


def _enclosing_function_lines(tree: ast.AST) -> Set[int]:
    """Line numbers that live inside some function body (module-level
    lines — one-shot import-time work — are the complement)."""
    lines: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            end = getattr(node, "end_lineno", node.lineno)
            lines.update(range(node.lineno, end + 1))
    return lines


def check_hot_path_entropy(project: Project,
                           config: LintConfig) -> List[Finding]:
    findings: List[Finding] = []
    for rel in config.hot_path_modules:
        sf = project.get(rel)
        if sf is None or sf.tree is None:
            continue
        fn_lines = _enclosing_function_lines(sf.tree)
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name not in _ENTROPY_CALLS:
                continue
            if node.lineno not in fn_lines:
                continue  # module-level: runs once at import, fine
            if sf.suppressed(node.lineno, "R3"):
                continue
            findings.append(make_finding(
                sf, "R3", node.lineno,
                f"{name}() on the task submit/dispatch path "
                f"(~200us/urandom on this kernel; uuid4-per-task cost "
                f"~30% of throughput before counter ids)",
                "use a process-prefix counter id (util/tracing.py "
                "pattern) or hoist the entropy to import time",
                detail=f"entropy:{name}"))
    return findings


check_hot_path_entropy.RULE_ID = "R3"
check_hot_path_entropy.RULE_NAME = "hot-path-entropy"


# ---------------------------------------------------------------------------
# R8 — bare-thread hygiene
# ---------------------------------------------------------------------------

def _is_thread_ctor(node: ast.Call) -> bool:
    name = dotted_name(node.func)
    return name == "threading.Thread" or name == "Thread"


def _joined_or_daemoned_names(tree: ast.AST) -> Set[str]:
    """Terminal attribute/variable names X for which ``X.join(...)`` or
    ``X.daemon = ...`` appears anywhere in the module."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
                and node.func.attr == "join":
            base = node.func.value
            if isinstance(base, ast.Name):
                out.add(base.id)
            elif isinstance(base, ast.Attribute):
                out.add(base.attr)
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Attribute) and t.attr == "daemon":
                    base = t.value
                    if isinstance(base, ast.Name):
                        out.add(base.id)
                    elif isinstance(base, ast.Attribute):
                        out.add(base.attr)
    # `for t in threads: t.join()` — a join on any loop variable also
    # blesses the list it iterates (conservative: collect loop targets)
    return out


def _assign_target_name(parents: Dict[ast.AST, ast.AST],
                        node: ast.AST) -> str:
    """Terminal name the Thread() result is bound to ('' if unbound)."""
    p = parents.get(node)
    while p is not None and isinstance(p, (ast.Await,)):
        node, p = p, parents.get(p)
    if isinstance(p, ast.Assign) and len(p.targets) == 1:
        t = p.targets[0]
        if isinstance(t, ast.Name):
            return t.id
        if isinstance(t, ast.Attribute):
            return t.attr
    if isinstance(p, (ast.List, ast.Tuple)):
        # thread appended into a literal list: bless via the list name
        pp = parents.get(p)
        if isinstance(pp, ast.Assign) and len(pp.targets) == 1:
            t = pp.targets[0]
            if isinstance(t, ast.Name):
                return t.id
            if isinstance(t, ast.Attribute):
                return t.attr
    if isinstance(p, ast.Call) and isinstance(p.func, ast.Attribute) \
            and p.func.attr == "append":
        base = p.func.value
        if isinstance(base, ast.Name):
            return base.id
        if isinstance(base, ast.Attribute):
            return base.attr
    return ""


def check_bare_threads(project: Project, config: LintConfig) -> List[Finding]:
    findings: List[Finding] = []
    for sf in project:
        if sf.tree is None:
            continue
        blessed = _joined_or_daemoned_names(sf.tree)
        # `for t in ts: t.join()` blesses ts too
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.For) and isinstance(node.target,
                                                        ast.Name):
                loopvar = node.target.id
                if loopvar in blessed:
                    it = node.iter
                    if isinstance(it, ast.Name):
                        blessed.add(it.id)
                    elif isinstance(it, ast.Attribute):
                        blessed.add(it.attr)
        parents = parent_map(sf.tree)
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call) or not _is_thread_ctor(node):
                continue
            if any(kw.arg == "daemon" for kw in node.keywords):
                continue
            target = _assign_target_name(parents, node)
            if target and target in blessed:
                continue
            if sf.suppressed(node.lineno, "R8"):
                continue
            findings.append(make_finding(
                sf, "R8", node.lineno,
                "threading.Thread without daemon= and without a .join() "
                "in this module (non-daemon default = shutdown hang)",
                "pass daemon=True, or join it on the teardown path",
                detail=f"bare-thread:{target or '<unbound>'}"))
    return findings


check_bare_threads.RULE_ID = "R8"
check_bare_threads.RULE_NAME = "bare-thread-hygiene"
