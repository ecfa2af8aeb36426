"""Cross-module protocol rules: R1 (wire consistency), R6 (event sources),
R7 (state-API parity).

The control plane is a string-keyed wire: a frame is ``{"type": <mtype>}``
and the receiving side dispatches on ``mtype ==`` chains.  Nothing but
convention keeps the two sides in sync — a typo'd type string or a removed
handler silently drops messages (the reference gets this safety from typed
protobuf RPCs; here the linter supplies it).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch.devtools.raylint.core import (
    Finding, LintConfig, Project, SourceFile, all_str_constants, dotted_name,
    make_finding, module_str_constants, str_const,
)

# call attrs that put a frame on the control wire; the frame dict may be
# any of the first two args (`_reply(conn, msg)` passes it second).
# ``outbox.append`` counts too: the head queues client-bound frames on
# per-connection outboxes that _flush_sends writes out.
_SEND_ATTRS = ("send", "request", "_send", "_reply", "agent_send",
               "safe_send")
_OUTBOX_NAMES = ("outbox",)


def _dict_type_value(node: ast.AST) -> Optional[str]:
    """The "type" value of a dict literal frame, if statically known."""
    if not isinstance(node, ast.Dict):
        return None
    for k, v in zip(node.keys, node.values):
        if k is not None and str_const(k) == "type":
            return str_const(v)
    return None


def _scope_walk(body_nodes: List[ast.stmt]):
    """BFS over one scope's nodes, PRUNING nested function bodies: their
    locals belong to them alone (each def gets its own ``scan_scope``),
    and walking into them here would attribute one function's frame
    variables to another's ``send`` — phantom sends that mask dead
    handlers."""
    queue = list(body_nodes)
    while queue:
        node = queue.pop(0)
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                queue.append(child)


def _collect_sends(sf: SourceFile) -> List[Tuple[str, int]]:
    """(mtype, line) for every frame this module puts on the wire.

    A frame counts when a dict literal with a constant "type" key is the
    first argument of a ``.send(...)``/``.request(...)``/``._send(...)``
    call, either inline or via a straight-line local variable within the
    same function (``msg = {...}; conn.send(msg)``).
    """
    out: List[Tuple[str, int]] = []
    if sf.tree is None:
        return out

    def scan_scope(body_nodes: List[ast.stmt]) -> None:
        # local name -> (mtype, line) for dict-literal assignments,
        # tracked per scope (nested defs are pruned by _scope_walk)
        local_frames: Dict[str, Tuple[str, int]] = {}
        for node in _scope_walk(body_nodes):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                t = _dict_type_value(node.value)
                if t is not None:
                    local_frames[node.targets[0].id] = (t, node.lineno)
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.args:
                attr = node.func.attr
                is_send = attr in _SEND_ATTRS
                if attr == "append":
                    base = node.func.value
                    terminal = (base.attr if isinstance(
                        base, ast.Attribute) else
                        base.id if isinstance(base, ast.Name) else "")
                    is_send = terminal in _OUTBOX_NAMES
                if not is_send:
                    continue
                for arg in node.args[:2]:
                    t = _dict_type_value(arg)
                    if t is not None:
                        out.append((t, node.lineno))
                        break
                    if isinstance(arg, ast.Name) \
                            and arg.id in local_frames:
                        t, line = local_frames[arg.id]
                        out.append((t, line))
                        break

    for node in ast.walk(sf.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scan_scope(node.body)
    scan_scope(sf.tree.body if isinstance(sf.tree, ast.Module) else [])
    # scopes are disjoint (nested defs pruned) but keep the site-dedupe
    # as a cheap invariant anyway
    return list(dict.fromkeys(out))


def _is_type_lookup(node: ast.AST) -> bool:
    """True for ``mtype``, ``msg["type"]`` and ``msg.get("type")``."""
    if isinstance(node, ast.Name) and node.id == "mtype":
        return True
    if isinstance(node, ast.Subscript):
        sl = node.slice
        return str_const(sl) == "type"
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr == "get" and node.args:
        return str_const(node.args[0]) == "type"
    return False


def _collect_handlers(sf: SourceFile) -> List[Tuple[str, int]]:
    """(mtype, line) for every ``mtype == "literal"`` dispatch comparison."""
    out: List[Tuple[str, int]] = []
    if sf.tree is None:
        return out
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Compare) or len(node.ops) != 1 \
                or not isinstance(node.ops[0], ast.Eq):
            continue
        sides = (node.left, node.comparators[0])
        for a, b in (sides, sides[::-1]):
            if _is_type_lookup(a):
                v = str_const(b)
                if v is not None:
                    out.append((v, node.lineno))
                break
    return out


def check_protocol(project: Project, config: LintConfig) -> List[Finding]:
    """R1: every sent frame type has a handler on the receiving side, and
    every handler arm has a live sender (no silently-dropped messages, no
    dead dispatch code — in BOTH wire directions)."""
    findings: List[Finding] = []

    head_handlers: Dict[str, Tuple[SourceFile, int]] = {}
    client_handlers: Dict[str, Tuple[SourceFile, int]] = {}
    for rel in config.head_handler_modules:
        sf = project.get(rel)
        if sf is None:
            continue
        for t, line in _collect_handlers(sf):
            head_handlers.setdefault(t, (sf, line))
    for rel in config.clientbound_handler_modules:
        sf = project.get(rel)
        if sf is None:
            continue
        for t, line in _collect_handlers(sf):
            client_handlers.setdefault(t, (sf, line))

    headbound_sends: List[Tuple[SourceFile, str, int]] = []
    clientbound_sends: List[Tuple[SourceFile, str, int]] = []
    excluded = set(config.protocol_exclude)
    for sf in project:
        if sf.relpath in excluded:
            continue
        sends = _collect_sends(sf)
        if sf.relpath in config.clientbound_sender_modules:
            clientbound_sends.extend((sf, t, line) for t, line in sends)
        else:
            headbound_sends.extend((sf, t, line) for t, line in sends)

    sent_to_head = {t for _, t, _ in headbound_sends}
    sent_to_client = {t for _, t, _ in clientbound_sends}

    for sf, t, line in headbound_sends:
        if t not in head_handlers and not sf.suppressed(line, "R1"):
            findings.append(make_finding(
                sf, "R1", line,
                f'frame type "{t}" is sent to the head but has no '
                f'dispatch arm in {" / ".join(config.head_handler_modules)}',
                "add an `elif mtype == ...` handler or delete the send",
                detail=f"unhandled-headbound:{t}"))
    for sf, t, line in clientbound_sends:
        if t not in client_handlers and not sf.suppressed(line, "R1"):
            findings.append(make_finding(
                sf, "R1", line,
                f'frame type "{t}" is sent to clients but no client/worker/'
                f'agent recv loop dispatches on it',
                "add a handler in the receiving loop or delete the send",
                detail=f"unhandled-clientbound:{t}"))
    for t, (sf, line) in sorted(head_handlers.items()):
        if t not in sent_to_head and not sf.suppressed(line, "R1"):
            findings.append(make_finding(
                sf, "R1", line,
                f'dead handler: no module sends frame type "{t}" to the head',
                "delete the dispatch arm (or the sender was lost — restore it)",
                detail=f"dead-head-handler:{t}"))
    for t, (sf, line) in sorted(client_handlers.items()):
        if t not in sent_to_client and not sf.suppressed(line, "R1"):
            findings.append(make_finding(
                sf, "R1", line,
                f'dead handler: the head never sends frame type "{t}" '
                f'to clients',
                "delete the dispatch arm (or the sender was lost — restore it)",
                detail=f"dead-client-handler:{t}"))

    # -- packed hot-frame codec (packed_wire.py) ------------------------
    # Same contract as the Envelope arms, applied to the struct-packed
    # codec: the _FRAME_IDS/_PACK/_UNPACK tables must agree key-for-key
    # (a type in the encoder but not the decoder is a silent wire break),
    # and every packed type needs a live sender and a dispatch arm.
    codec_sf = project.get(getattr(config, "packed_codec_module", "") or "")
    if codec_sf is not None and codec_sf.tree is not None:
        tables: Dict[str, Tuple[Set[str], int]] = {}
        for node in codec_sf.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id in ("_FRAME_IDS", "_PACK",
                                               "_UNPACK") \
                    and isinstance(node.value, ast.Dict):
                keys = {s for s in (str_const(k) for k in node.value.keys
                                    if k is not None) if s is not None}
                tables[node.targets[0].id] = (keys, node.lineno)
        if len(tables) == 3:
            all_types = set().union(*(k for k, _ in tables.values()))
            for t in sorted(all_types):
                for tname, (keys, line) in tables.items():
                    if t not in keys and not codec_sf.suppressed(line, "R1"):
                        findings.append(make_finding(
                            codec_sf, "R1", line,
                            f'packed frame type "{t}" is missing from '
                            f'{tname} (codec tables out of lockstep — a '
                            f'peer would drop or misdecode the frame)',
                            f"add the {tname} entry for it (or remove the "
                            f"type from the other tables)",
                            detail=f"packed-table-skew:{tname}:{t}"))
            ids, ids_line = tables["_FRAME_IDS"]
            handled = set(head_handlers) | set(client_handlers)
            sent = sent_to_head | sent_to_client
            for t in sorted(ids):
                if t not in handled and not codec_sf.suppressed(ids_line, "R1"):
                    findings.append(make_finding(
                        codec_sf, "R1", ids_line,
                        f'packed frame type "{t}" has no dispatch arm in '
                        f'any recv loop (either wire direction)',
                        "add the handler or drop the packed arm",
                        detail=f"packed-unhandled:{t}"))
                if t not in sent and not codec_sf.suppressed(ids_line, "R1"):
                    findings.append(make_finding(
                        codec_sf, "R1", ids_line,
                        f'dead packed arm: no module sends frame type '
                        f'"{t}" on either wire direction',
                        "delete the packed arm (or the sender was lost)",
                        detail=f"packed-dead:{t}"))
    return findings


check_protocol.RULE_ID = "R1"
check_protocol.RULE_NAME = "protocol-consistency"


# ---------------------------------------------------------------------------
# R6 — event-source registry
# ---------------------------------------------------------------------------

def _known_sources(sf: SourceFile) -> Set[str]:
    if sf.tree is None:
        return set()
    for node in sf.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "KNOWN_SOURCES" \
                and isinstance(node.value, (ast.Tuple, ast.List)):
            return {s for s in (str_const(e) for e in node.value.elts)
                    if s is not None}
    return set()


def check_event_sources(project: Project, config: LintConfig) -> List[Finding]:
    """R6: every ``events.emit(source, ...)`` literal is declared in
    ``KNOWN_SOURCES`` — an undeclared source is invisible to
    ``python -m ray_tpu_torch events --source`` and the doctor's per-source rules."""
    findings: List[Finding] = []
    events_sf = project.get(config.events_module)
    if events_sf is None:
        return findings
    known = _known_sources(events_sf)
    if not known:
        return findings
    for sf in project:
        if sf.relpath == config.events_module:
            continue
        consts = module_str_constants(sf)
        if sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if not (isinstance(fn, ast.Attribute) and fn.attr == "emit"):
                # also accept a bare `emit(...)` imported from events
                if not (isinstance(fn, ast.Name) and fn.id == "emit"):
                    continue
            else:
                # only emit() on an events-module alias — logging handlers
                # etc. also have .emit and must not be checked
                base = dotted_name(fn.value)
                if "events" not in base and base not in ("_events",):
                    continue
            src: Optional[str] = None
            if node.args:
                src = str_const(node.args[0])
                if src is None and isinstance(node.args[0], ast.Name):
                    src = consts.get(node.args[0].id)
            for kw in node.keywords:
                if kw.arg == "source":
                    src = str_const(kw.value)
                    if src is None and isinstance(kw.value, ast.Name):
                        src = consts.get(kw.value.id)
            if src is None:
                continue  # dynamic source: not statically checkable
            if src not in known and not sf.suppressed(node.lineno, "R6"):
                findings.append(make_finding(
                    sf, "R6", node.lineno,
                    f'event source "{src}" is not declared in '
                    f'{config.events_module} KNOWN_SOURCES',
                    "add it to KNOWN_SOURCES (keeps --source discoverable) "
                    "or fix the typo",
                    detail=f"unknown-source:{src}"))
    return findings


check_event_sources.RULE_ID = "R6"
check_event_sources.RULE_NAME = "event-source-registry"


# ---------------------------------------------------------------------------
# R7 — state-API parity
# ---------------------------------------------------------------------------

def check_state_parity(project: Project, config: LintConfig) -> List[Finding]:
    """R7: every ``list_*`` state-API helper resolves to a head-side
    handler AND has a CLI or dashboard surface — a listing nobody can
    reach (or that the head silently 404s) is an API-shaped lie."""
    findings: List[Finding] = []
    api_sf = project.get(config.state_api_module)
    if api_sf is None or api_sf.tree is None:
        return findings

    head_consts: Set[str] = set()
    for rel in config.head_handler_modules:
        sf = project.get(rel)
        if sf is not None:
            head_consts |= all_str_constants(sf)

    surface_consts: Set[str] = set()
    surface_attrs: Set[str] = set()
    for rel in config.state_surface_modules:
        sf = project.get(rel)
        if sf is None or sf.tree is None:
            continue
        surface_consts |= all_str_constants(sf)
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Attribute):
                surface_attrs.add(node.attr)
            elif isinstance(node, ast.Name):
                surface_attrs.add(node.id)

    for node in api_sf.tree.body:
        if not isinstance(node, ast.FunctionDef) \
                or not node.name.startswith("list_"):
            continue
        line = node.lineno
        if api_sf.suppressed(line, "R7"):
            continue
        # head token: the "what" passed to the generic list_state page, or
        # the literal "type" of a direct request frame
        tokens: Set[str] = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                fn_name = dotted_name(sub.func)
                if fn_name.split(".")[-1] in ("_list", "list_state_page") \
                        and sub.args:
                    t = str_const(sub.args[0])
                    if t:
                        tokens.add(t)
                t = _dict_type_value(sub.args[0]) if sub.args else None
                if t:
                    tokens.add(t)
            t = _dict_type_value(sub)
            if t:
                tokens.add(t)
        if not tokens:
            continue  # helper delegates elsewhere; nothing checkable
        if not tokens & head_consts:
            findings.append(make_finding(
                api_sf, "R7", line,
                f"state helper {node.name}() requests "
                f"{sorted(tokens)} but the head handles none of them",
                "add the head-side handler (node.py dispatch / table) or "
                "remove the helper",
                detail=f"no-head-handler:{node.name}"))
        what = node.name[len("list_"):]
        if what not in surface_consts and node.name not in surface_attrs \
                and not (tokens & surface_consts):
            findings.append(make_finding(
                api_sf, "R7", line,
                f"state helper {node.name}() has no CLI or dashboard "
                f"surface (not reachable by an operator)",
                "wire it into scripts/cli.py (`python -m ray_tpu_torch list ...`) or a "
                "dashboard endpoint",
                detail=f"no-surface:{node.name}"))
    return findings


check_state_parity.RULE_ID = "R7"
check_state_parity.RULE_NAME = "state-api-parity"
