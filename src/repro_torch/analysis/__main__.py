"""``python -m repro_torch.analysis`` — run the full static pass.

Port of ``repro.analysis.__main__``.  Both engines by default;
``--lint-only`` skips the kernel audit and ``--audit-only`` the AST
rules.  The audit runs on the card (``--device cuda``, the default,
which raises where there is none); ``--device cpu`` runs its CPU half
and says which checks it left out.  ``--config`` replaces the package's
``analysis.toml``.  Exit status 1 iff findings survive the allowlist.
"""

from __future__ import annotations

import argparse
import importlib
import json
import pathlib
import sys
import time

from repro_torch.analysis.config import CONFIG_NAME, CONFIG_PATH


def _find_root(start: pathlib.Path) -> pathlib.Path:
    for cand in (start, *start.parents):
        if (cand / ".git").exists() or (cand / CONFIG_NAME).is_file():
            return cand
    return start


def _lint(root, rule_names, config):
    from repro_torch.analysis.lint import run_lint
    from repro_torch.analysis.rules import ALL_RULES
    rules = list(ALL_RULES)
    if rule_names:
        known = {r.name for r in rules}
        unknown = set(rule_names) - known
        if unknown:
            raise SystemExit(
                f"unknown rule(s) {sorted(unknown)}; available: {sorted(known)}")
        rules = [r for r in rules if r.name in rule_names]
    return run_lint(root, rules, config), [r.name for r in rules]


def _audit(archs, device, max_batch, path_names, config):
    from repro_torch import resolve_device
    from repro_torch.analysis.kernel_audit import run
    from repro_torch.core import interaction_net
    dev = resolve_device(device)
    configs = {}
    for arch in archs:
        cfg = importlib.import_module(f"repro_torch.configs.{arch}").MODEL
        configs[arch] = (cfg, interaction_net.init(0, cfg, device=dev))
    findings, stats = run(configs, max_batch=max_batch,
                          names=path_names or None)
    return [f for f in findings if not config.allowed(f.rule, f.location)], \
        stats


def main(argv=None) -> int:
    from repro_torch.analysis.config import AnalysisConfig
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static analysis: AST lint rules + kernel-contract audit")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as a JSON document")
    ap.add_argument("--rules", default="",
                    help="comma-separated lint rule subset (default: all)")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--lint-only", action="store_true",
                      help="AST rules only (no device)")
    mode.add_argument("--audit-only", action="store_true",
                      help="kernel-contract audit only")
    ap.add_argument("--paths", default="",
                    help="comma-separated registered path subset to audit")
    ap.add_argument("--arch", default="jedi_30p",
                    help="comma-separated config modules under "
                         "repro_torch.configs (default: jedi_30p)")
    ap.add_argument("--max-batch", type=int, default=1024,
                    help="bucket-ladder ceiling for the audit")
    ap.add_argument("--device", default="cuda",
                    help="where the audit runs: cuda (default; the build's "
                         "and the launches' checks) or cpu (its CPU half)")
    ap.add_argument("--config", default=None,
                    help=f"allowlist file (default: {CONFIG_PATH})")
    ap.add_argument("--root", default=None,
                    help="repo root (default: discovered from cwd)")
    args = ap.parse_args(argv)

    root = (pathlib.Path(args.root).resolve() if args.root
            else _find_root(pathlib.Path.cwd().resolve()))
    config = AnalysisConfig.load(args.config)
    rule_names = [r.strip() for r in args.rules.split(",") if r.strip()]
    path_names = [p.strip() for p in args.paths.split(",") if p.strip()]
    archs = [a.strip() for a in args.arch.split(",") if a.strip()]

    findings = []
    timings = {}
    rules, audit = [], None
    if not args.audit_only:
        t0 = time.perf_counter()
        found, rules = _lint(root, rule_names, config)
        findings += found
        timings["lint_s"] = round(time.perf_counter() - t0, 3)
    if not args.lint_only:
        t0 = time.perf_counter()
        found, audit = _audit(archs, args.device, args.max_batch, path_names,
                              config)
        findings += found
        timings["audit_s"] = round(time.perf_counter() - t0, 3)

    if args.as_json:
        doc = {"findings": [f.as_dict() for f in findings],
               "count": len(findings), "timings": timings}
        if rules:
            doc["rules"] = rules
        if audit is not None:
            doc["audit"] = audit
        print(json.dumps(doc, indent=2))
    else:
        for f in findings:
            print(f.render())
        engines = " + ".join(f"{k[:-2]} {v:.2f}s" for k, v in timings.items())
        status = "clean" if not findings else f"{len(findings)} finding(s)"
        print(f"repro_torch.analysis: {status} ({engines})", file=sys.stderr)
        if audit is not None and "card_checks" in audit:
            print(f"repro_torch.analysis: audit on {audit['device']}; card "
                  f"checks {audit['card_checks']}", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
