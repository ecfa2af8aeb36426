"""R5 — unbounded-container.

Head-resident state lives as long as the cluster.  The root-cause
class found in the metrics plane: per-origin tables that gained rows on every push and dropped
them never — dead pushers stayed in ``/metrics`` forever.  The rule
finds instance/module-level dicts/lists/sets on the configured
head-resident modules that GROW somewhere but are never shrunk
(``pop``/``del``/``clear``/``popitem``/``remove``/``discard``/
reassignment outside ``__init__``) anywhere in the module.

``collections.deque(maxlen=...)`` and constructor-capped containers are
inherently bounded and never flagged.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from ray_tpu_torch.devtools.raylint.core import (
    Finding, LintConfig, Project, SourceFile, dotted_name, make_finding,
)

_GROW_METHODS = {"append", "add", "insert", "extend", "update",
                 "setdefault", "appendleft"}
_SHRINK_METHODS = {"pop", "popitem", "popleft", "clear", "remove",
                   "discard"}


def _container_ctor(node: ast.AST) -> str:
    """'dict'/'list'/'set' when the value constructs an unbounded
    container, '' otherwise (deque(maxlen=), comprehensions from
    bounded sources, etc. are not flagged)."""
    if isinstance(node, ast.Dict) and not node.keys:
        return "dict"
    if isinstance(node, ast.List) and not node.elts:
        return "list"
    if isinstance(node, ast.Call):
        name = dotted_name(node.func)
        terminal = name.rsplit(".", 1)[-1]
        if terminal in ("dict", "OrderedDict", "defaultdict"):
            return "dict"
        if terminal == "list":
            return "list"
        if terminal == "set":
            return "set"
        if terminal == "deque":
            has_maxlen = any(kw.arg == "maxlen" for kw in node.keywords)
            return "" if has_maxlen else "list"
    if isinstance(node, ast.Call) or isinstance(node, (ast.DictComp,
                                                       ast.ListComp,
                                                       ast.SetComp)):
        return ""
    return ""


def _attr_terminal(node: ast.AST) -> str:
    """'x' for self.x / obj.x / x (the per-module identity we track)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _scan_module(sf: SourceFile) -> Tuple[
        Dict[str, Tuple[int, str]], Set[str], Set[str]]:
    """(declared containers: name -> (line, kind), grown names,
    shrunk names) for one module."""
    declared: Dict[str, Tuple[int, str]] = {}
    grown: Set[str] = set()
    shrunk: Set[str] = set()
    tree = sf.tree
    if tree is None:
        return declared, grown, shrunk

    # declarations: `self.x = {}` inside __init__, or module-level `X = {}`
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == "__init__":
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                    t = sub.targets[0]
                    if isinstance(t, ast.Attribute) and isinstance(
                            t.value, ast.Name) and t.value.id == "self":
                        kind = _container_ctor(sub.value)
                        if kind:
                            declared.setdefault(t.attr, (sub.lineno, kind))
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            kind = _container_ctor(node.value)
            if kind:
                declared.setdefault(node.targets[0].id,
                                    (node.lineno, kind))

    init_spans: List[Tuple[int, int]] = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == "__init__":
            init_spans.append((node.lineno,
                               getattr(node, "end_lineno", node.lineno)))

    def in_init(line: int) -> bool:
        return any(a <= line <= b for a, b in init_spans)

    # growth / shrink sites
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript):
                    name = _attr_terminal(t.value)
                    if name:
                        grown.add(name)          # x[k] = v
                elif _attr_terminal(t) and not in_init(node.lineno):
                    # reassignment outside __init__ resets the container
                    shrunk.add(_attr_terminal(t))
        elif isinstance(node, ast.AugAssign):
            name = _attr_terminal(node.target)
            if name:
                grown.add(name)                   # x += [...]
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, ast.Subscript):
                    name = _attr_terminal(t.value)
                    if name:
                        shrunk.add(name)          # del x[k]
        elif isinstance(node, ast.Call) and isinstance(node.func,
                                                       ast.Attribute):
            base = _attr_terminal(node.func.value)
            if not base:
                continue
            if node.func.attr in _GROW_METHODS:
                grown.add(base)
            elif node.func.attr in _SHRINK_METHODS:
                shrunk.add(base)
    return declared, grown, shrunk


def check_unbounded_containers(project: Project,
                               config: LintConfig) -> List[Finding]:
    findings: List[Finding] = []
    for rel in config.head_container_modules:
        sf = project.get(rel)
        if sf is None or sf.tree is None:
            continue
        declared, grown, shrunk = _scan_module(sf)
        for name, (line, kind) in sorted(declared.items()):
            if name not in grown or name in shrunk:
                continue
            if sf.suppressed(line, "R5"):
                continue
            findings.append(make_finding(
                sf, "R5", line,
                f"head-resident {kind} `{name}` grows in handlers but "
                f"nothing in this module ever removes from it "
                f"(slow head OOM; dead entries live forever)",
                "add a cap/LRU eviction, an expiry sweep, or explicit "
                "removal on the teardown path (the metrics registry's "
                "replacement-merge pattern)",
                detail=f"unbounded:{name}"))
    return findings


check_unbounded_containers.RULE_ID = "R5"
check_unbounded_containers.RULE_NAME = "unbounded-container"
