"""raylint core: findings, the parsed-project model, suppressions, baseline.

The port's copy of ``ray_tpu/devtools/raylint/core.py``: the same rules'
vocabulary, with ``LintConfig``'s defaults naming the port's modules and a
baseline of the port's own (``ray_tpu_torch/devtools/raylint/baseline.json``).

The suite is an AST-based invariant checker distilled from this repo's own
postmortems (the analog of the reference's clang thread-safety annotations +
TSan wiring — mechanical enforcement of project invariants instead of
re-finding the same bug classes by hand every few PRs).  Everything here is
stdlib-only: ``ast`` for parsing, ``json`` for the baseline.

Vocabulary:

- A **rule** is a callable ``check(project, config) -> List[Finding]`` with
  ``RULE_ID``/``RULE_NAME`` attributes (registered in ``__init__.RULES``).
- A **Finding** carries ``file:line``, the rule id, a one-line message and a
  one-line remedy.  Its :meth:`Finding.baseline_key` intentionally excludes
  the line number so the checked-in baseline survives unrelated edits.
- ``# raylint: disable=R4`` on the flagged line (or alone on the line above)
  suppresses a finding at the source; the package's ``baseline.json`` grandfathers
  existing findings so the CI gate only fails on NEW ones.
"""

from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

_SUPPRESS_MARK = "# raylint: disable"


@dataclass
class Finding:
    rule: str          # "R1".."R8"
    path: str          # repo-relative, forward slashes
    line: int
    message: str       # one line: what is wrong, with names
    remedy: str        # one line: how to fix it
    # stable identity for the baseline: defaults to the message, but rules
    # set it to something line-number- and phrasing-free when the message
    # embeds positions of OTHER code (e.g. "shadowed by handler at :114")
    detail: str = ""
    scope: str = ""    # enclosing "Class.method" (or "<module>")

    def baseline_key(self) -> str:
        return "|".join(
            (self.rule, self.path, self.scope, self.detail or self.message))

    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def render(self) -> str:
        return (f"{self.location()}: {self.rule} {self.message}\n"
                f"    remedy: {self.remedy}")

    def to_dict(self) -> dict:
        return {"rule": self.rule, "file": self.path, "line": self.line,
                "message": self.message, "remedy": self.remedy,
                "scope": self.scope, "key": self.baseline_key()}


class SourceFile:
    """One parsed module: source lines, AST, per-line suppressions."""

    def __init__(self, relpath: str, source: str):
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree: Optional[ast.AST] = None
        self.parse_error: Optional[SyntaxError] = None
        try:
            self.tree = ast.parse(source, filename=relpath)
        except SyntaxError as e:
            self.parse_error = e
        # line -> set of suppressed rule ids ("*" = all)
        self.suppressions: Dict[int, Set[str]] = self._scan_suppressions()
        self._scopes: Optional[List[Tuple[int, int, str]]] = None

    # -- suppressions ------------------------------------------------------
    def _scan_suppressions(self) -> Dict[int, Set[str]]:
        # real COMMENT tokens only: the marker inside a string literal or
        # docstring (e.g. documentation QUOTING the syntax) must not
        # register a suppression — a phantom "*" entry would silently
        # mask genuine findings on that line
        out: Dict[int, Set[str]] = {}
        try:
            tokens = list(tokenize.generate_tokens(
                io.StringIO(self.source).readline))
        except (tokenize.TokenError, IndentationError, SyntaxError):
            return out  # unparseable file: no tree, nothing to suppress
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            idx = tok.string.find(_SUPPRESS_MARK)
            if idx < 0:
                continue
            spec = tok.string[idx + len(_SUPPRESS_MARK):].strip()
            if spec.startswith("="):
                # "=R3,R4" — a trailing rationale is allowed and ignored:
                # "# raylint: disable=R3 (one-shot path)".  The rationale
                # starts at the first "(" and ids stop at the first token
                # that isn't R<n>/"*" — a comma inside the rationale must
                # not register prose words (or an R<n> the rationale
                # merely MENTIONS) as extra suppressed rules
                rules = set()
                for part in spec[1:].split("(", 1)[0].split(","):
                    m = re.match(r"(R\d+|\*)(?:\s+(.*))?$", part.strip())
                    if not m:
                        if part.strip():
                            break
                        continue
                    rules.add(m.group(1))
                    if m.group(2):
                        break  # id then prose: bare rationale — stop
            else:
                rules = {"*"}
            row, col = tok.start
            target = row
            # a directive alone on its own line covers the NEXT line
            if self.lines[row - 1][:col].strip() == "":
                target = row + 1
            out.setdefault(target, set()).update(rules)
        return out

    def suppressed(self, line: int, rule: str) -> bool:
        rules = self.suppressions.get(line)
        return bool(rules) and (rule in rules or "*" in rules)

    # -- scopes ------------------------------------------------------------
    def scope_at(self, line: int) -> str:
        """Innermost ``Class.method`` enclosing ``line`` (baseline keys)."""
        if self._scopes is None:
            spans: List[Tuple[int, int, str]] = []

            def walk(node: ast.AST, prefix: str) -> None:
                for child in ast.iter_child_nodes(node):
                    if isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.ClassDef)):
                        name = (prefix + "." if prefix else "") + child.name
                        end = getattr(child, "end_lineno", child.lineno)
                        spans.append((child.lineno, end, name))
                        walk(child, name)
                    else:
                        walk(child, prefix)

            if self.tree is not None:
                walk(self.tree, "")
            spans.sort(key=lambda s: (s[0], -s[1]))
            self._scopes = spans
        best = "<module>"
        for start, end, name in self._scopes:
            if start <= line <= end:
                best = name  # later entries are inner scopes
        return best


class Project:
    """The analyzed file set, parsed once and shared by every rule."""

    def __init__(self, root: str, relpaths: Sequence[str]):
        self.root = os.path.abspath(root)
        self.files: Dict[str, SourceFile] = {}
        for rel in relpaths:
            full = os.path.join(self.root, rel)
            try:
                with tokenize.open(full) as f:   # honors coding cookies
                    src = f.read()
            except (OSError, UnicodeDecodeError, SyntaxError):
                continue
            self.files[rel.replace(os.sep, "/")] = SourceFile(
                rel.replace(os.sep, "/"), src)

    def get(self, relpath: str) -> Optional[SourceFile]:
        return self.files.get(relpath)

    def __iter__(self) -> Iterable[SourceFile]:
        return iter(self.files.values())


@dataclass
class LintConfig:
    """Where the project-specific invariants live.

    The defaults describe THIS repo (module roles for the protocol rule,
    hot-path membership for the entropy rule, ...).  Fixture tests build
    configs pointing at miniature projects instead.
    """

    root: str
    package: str = "ray_tpu_torch"
    # R1 — protocol consistency.  The control wire has two directions:
    # head-bound frames (everyone -> node.py's dispatch chains) and
    # client-bound frames (node.py/dashboard -> the client/worker/agent
    # recv loops).  Modules listed as clientbound senders have their sends
    # checked against the clientbound handler chains; everything else's
    # sends are checked against the head's chains.
    head_handler_modules: Tuple[str, ...] = (
        "ray_tpu_torch/_private/node.py",
        # the client proxy is a server on the same direction: clients send
        # proxy_hello AT it and it dispatches like the head does
        "ray_tpu_torch/util/client/proxier.py",
    )
    clientbound_handler_modules: Tuple[str, ...] = (
        "ray_tpu_torch/_private/client.py",
        "ray_tpu_torch/_private/worker.py",
        "ray_tpu_torch/_private/node_agent.py",
    )
    clientbound_sender_modules: Tuple[str, ...] = (
        "ray_tpu_torch/_private/node.py",
        "ray_tpu_torch/dashboard/dashboard.py",
        # the chaos harness runs IN the head process and injects faults
        # over the agents' control connections (agent_send) — its frames
        # go head -> agent, same direction as node.py's
        "ray_tpu_torch/devtools/chaos/harness.py",
        # the proxy answers the client's handshake: proxy_ready/proxy_error
        # flow proxy -> client and are dispatched in client.py (the tenant
        # relay in util/client/driver.py forwards only variable frames)
        "ray_tpu_torch/util/client/proxier.py",
    )
    # the codecs rebuild frames from the wire — their dict literals are
    # not send sites, and their tables must not count as senders
    protocol_exclude: Tuple[str, ...] = (
        "ray_tpu_torch/_private/wire.py",
        "ray_tpu_torch/_private/packed_wire.py",
    )
    # R1 also checks the packed hot-frame codec: its _FRAME_IDS/_PACK/
    # _UNPACK tables must stay in lockstep (a frame type added to the
    # encoder but not the decoder is a silent wire break) and every
    # packed type must have live send sites and dispatch arms in BOTH
    # wire directions, exactly like the Envelope arms
    packed_codec_module: str = "ray_tpu_torch/_private/packed_wire.py"
    # R3 — modules on the task submit/dispatch path where per-task entropy
    # (uuid4/urandom ~200us on this kernel) costs whole-percent throughput
    hot_path_modules: Tuple[str, ...] = (
        "ray_tpu_torch/_private/node.py",
        "ray_tpu_torch/_private/worker.py",
        "ray_tpu_torch/_private/client.py",
        "ray_tpu_torch/_private/object_ref.py",
        "ray_tpu_torch/_private/object_store.py",
        "ray_tpu_torch/_private/events.py",
        "ray_tpu_torch/util/tracing.py",
        "ray_tpu_torch/util/metrics.py",
        "ray_tpu_torch/dag/compiled.py",
        "ray_tpu_torch/dag/channel.py",
        "ray_tpu_torch/serve/_private/router.py",
    )
    # R5 — head-resident modules whose containers live as long as the
    # cluster: growth without a cap/expiry/eviction is a slow head OOM
    head_container_modules: Tuple[str, ...] = (
        "ray_tpu_torch/_private/node.py",
        "ray_tpu_torch/_private/events.py",
        "ray_tpu_torch/_private/object_store.py",
        "ray_tpu_torch/util/tsdb.py",
        "ray_tpu_torch/util/metrics.py",
    )
    # R6 — the flight-recorder source registry
    events_module: str = "ray_tpu_torch/_private/events.py"
    # R7 — state API parity
    state_api_module: str = "ray_tpu_torch/experimental/state/api.py"
    state_surface_modules: Tuple[str, ...] = (
        "ray_tpu_torch/scripts/cli.py",
        "ray_tpu_torch/dashboard/dashboard.py",
    )
    # extra per-config knobs rules may consult
    extras: Dict[str, object] = field(default_factory=dict)

    def iter_paths(self) -> List[str]:
        """Repo-relative .py paths to lint (the package, minus caches)."""
        out: List[str] = []
        pkg_root = os.path.join(self.root, self.package)
        for dirpath, dirnames, filenames in os.walk(pkg_root):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", ".pytest_cache")]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.relpath(
                        os.path.join(dirpath, fn), self.root))
        return sorted(out)


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------

# the port's grandfathered findings, inside the package (never the JAX
# package's root ``raylint_baseline.json``)
BASELINE_RELPATH = os.path.join("ray_tpu_torch", "devtools", "raylint",
                                "baseline.json")


def baseline_path(root: str) -> str:
    return os.path.join(root, BASELINE_RELPATH)


def load_baseline(path: str) -> Dict[str, int]:
    """key -> allowed count (the multiset of grandfathered findings)."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    counts: Dict[str, int] = {}
    for key in data.get("findings", []):
        counts[key] = counts.get(key, 0) + 1
    return counts


def save_baseline(path: str, findings: Sequence[Finding]) -> None:
    keys = sorted(f.baseline_key() for f in findings)
    with open(path, "w") as f:
        json.dump({"version": 1,
                   "comment": ("grandfathered raylint findings; burn this "
                               "down — new findings always gate"),
                   "findings": keys}, f, indent=1)
        f.write("\n")


def split_new(findings: Sequence[Finding],
              baseline: Dict[str, int]) -> Tuple[List[Finding], List[Finding]]:
    """(new, baselined): occurrences beyond a key's baseline count are new."""
    remaining = dict(baseline)
    new: List[Finding] = []
    old: List[Finding] = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        k = f.baseline_key()
        if remaining.get(k, 0) > 0:
            remaining[k] -= 1
            old.append(f)
        else:
            new.append(f)
    return new, old


# ---------------------------------------------------------------------------
# shared AST helpers used by several rules
# ---------------------------------------------------------------------------

def call_name(node: ast.Call) -> str:
    """Dotted name of a call target: ``time.sleep`` / ``sorted`` / ``.wait``
    (leading dot = method on a non-Name object)."""
    return dotted_name(node.func)


def dotted_name(node: ast.AST) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return (base + "." + node.attr) if base else "." + node.attr
    return ""


def str_const(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def module_str_constants(sf: SourceFile) -> Dict[str, str]:
    """Module-level ``NAME = "literal"`` assignments (constant resolution
    for e.g. ``_SOURCE = "compiled_dag"`` passed to ``events.emit``)."""
    out: Dict[str, str] = {}
    if sf.tree is None:
        return out
    for node in sf.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            v = str_const(node.value)
            if v is not None:
                out[node.targets[0].id] = v
    return out


def all_str_constants(sf: SourceFile) -> Set[str]:
    out: Set[str] = set()
    if sf.tree is None:
        return out
    for node in ast.walk(sf.tree):
        v = str_const(node)
        if v is not None:
            out.add(v)
    return out


def parent_map(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def make_finding(sf: SourceFile, rule: str, line: int, message: str,
                 remedy: str, detail: str = "") -> Finding:
    return Finding(rule=rule, path=sf.relpath, line=line, message=message,
                   remedy=remedy, detail=detail, scope=sf.scope_at(line))
