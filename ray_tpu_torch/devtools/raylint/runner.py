"""raylint runner: parse once, run rules, apply suppressions + baseline.

The CLI (``python -m ray_tpu_torch lint``), the tier-1 gate (``tests/test_torch_raylint.py``)
and ``python -m ray_tpu_torch doctor --static`` all call :func:`run_gate`; fixture tests
call :func:`analyze` with a custom :class:`LintConfig` pointing at a
miniature project.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ray_tpu_torch.devtools.raylint.core import (
    Finding, LintConfig, Project, baseline_path, load_baseline,
    save_baseline, split_new,
)


def analyze(config: LintConfig,
            rules: Optional[Sequence[str]] = None,
            project: Optional[Project] = None) -> List[Finding]:
    """Run the selected rules (default: all) over the configured file
    set and return line-suppression-filtered findings, sorted."""
    from ray_tpu_torch.devtools.raylint import RULES

    if project is None:
        project = Project(config.root, config.iter_paths())
    selected = list(rules) if rules else sorted(RULES)
    unknown = [r for r in selected if r not in RULES]
    if unknown:
        raise ValueError(f"unknown rule id(s): {unknown} "
                         f"(have {sorted(RULES)})")
    findings: List[Finding] = []
    for rid in selected:
        findings.extend(RULES[rid](project, config))
    # rules are expected to honor suppressions themselves at the best
    # line; enforce centrally too so no rule can forget
    kept = []
    for f in findings:
        sf = project.get(f.path)
        if sf is not None and sf.suppressed(f.line, f.rule):
            continue
        kept.append(f)
    kept.sort(key=lambda f: (f.path, f.line, f.rule, f.detail))
    return kept


@dataclass
class GateResult:
    findings: List[Finding]      # everything the rules produced
    new: List[Finding]           # not covered by the baseline -> gate
    baselined: List[Finding]     # grandfathered (burn these down)
    stale_keys: List[str]        # baseline entries that no longer fire

    @property
    def ok(self) -> bool:
        # stale keys fail the gate too: the baseline only burns down —
        # a fixed finding must take its grandfather entry with it
        return not self.new and not self.stale_keys


def run_gate(root: str,
             rules: Optional[Sequence[str]] = None,
             config: Optional[LintConfig] = None,
             update_baseline: bool = False,
             project=None) -> GateResult:
    """The CI gate: findings beyond the checked-in baseline fail.

    With ``update_baseline`` the CURRENT full-rule findings become the
    new baseline (never run with a rule subset — a partial run would
    erase other rules' grandfathered entries).
    """
    if update_baseline and rules:
        raise ValueError(
            "--update-baseline requires a full-rule run (a subset "
            "would erase other rules' baseline entries)")
    config = config or LintConfig(root=root)
    findings = analyze(config, rules=rules, project=project)
    bpath = baseline_path(root)
    if update_baseline:
        save_baseline(bpath, findings)
        return GateResult(findings=findings, new=[], baselined=findings,
                          stale_keys=[])
    baseline = load_baseline(bpath)
    # with a rule subset, only compare against that subset's keys
    if rules:
        prefixes = tuple(f"{r}|" for r in rules)
        baseline = {k: v for k, v in baseline.items()
                    if k.startswith(prefixes)}
    new, old = split_new(findings, baseline)
    fired = {}
    for f in findings:
        fired[f.baseline_key()] = fired.get(f.baseline_key(), 0) + 1
    stale = sorted(k for k, n in baseline.items()
                   if fired.get(k, 0) < n)
    return GateResult(findings=findings, new=new, baselined=old,
                      stale_keys=stale)


def render_report(result: GateResult, verbose: bool = False) -> str:
    """Human-readable gate report (what ``python -m ray_tpu_torch lint`` prints)."""
    out: List[str] = []
    for f in result.new:
        out.append(f.render())
    if result.new:
        out.append("")
    out.append(
        f"raylint: {len(result.new)} new finding(s), "
        f"{len(result.baselined)} baselined, "
        f"{len(result.stale_keys)} stale baseline entr(y/ies)")
    if verbose and result.baselined:
        out.append("baselined (burn these down):")
        for f in result.baselined:
            out.append("  " + f.render().replace("\n", "\n  "))
    if result.stale_keys:
        out.append("stale baseline keys (fixed — remove with "
                   "--update-baseline):")
        for k in result.stale_keys:
            out.append(f"  {k}")
    return "\n".join(out)


def to_json(result: GateResult) -> Dict[str, object]:
    return {
        "new": [f.to_dict() for f in result.new],
        "baselined": [f.to_dict() for f in result.baselined],
        "stale_baseline_keys": list(result.stale_keys),
        "ok": result.ok,
    }
