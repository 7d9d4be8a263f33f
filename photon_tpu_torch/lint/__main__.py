"""CLI: audit the repo's source-level conventions.

    python -m photon_tpu_torch.lint           # human report
    python -m photon_tpu_torch.lint --json    # machine report (one object)
    python -m photon_tpu_torch.lint --list    # rule names + waiver tags
    python -m photon_tpu_torch.lint --only durable_write --only guarded_by
    python -m photon_tpu_torch.lint --changed # findings in changed files
    python -m photon_tpu_torch.lint --threads # thread inventory, lock-order
                                              # graph, guarded-by bindings
    python -m photon_tpu_torch.lint --threads --json  # machine thread model
    python -m photon_tpu_torch.lint --threads --dot   # lock graph, graphviz

Import-side-effect-free: the rules read every registry they pin as an
AST literal, so the whole audit costs a second or two (the umbrella's
``lint`` suite runs exactly ``--json``; its ``threads`` suite runs
``--threads --json``). ``--threads`` dumps the whole-program thread
model — thread inventory, lock-order graph, guarded-by bindings — then
runs the four concurrency rules and exits 1 on findings. Exit status: 0
when every convention holds, 1 on findings, 2 on an unknown ``--only``
rule.
"""
from __future__ import annotations

import json
import sys


_CONCURRENCY_RULES = ("lock_order", "blocking_under_lock", "guarded_by",
                      "concurrency_model")


def threads_main(root, argv) -> int:
    """Dump the whole-program thread model (``--threads``): the thread
    inventory, lock-order graph, and guarded-by bindings — then run the
    four concurrency rules and exit 1 on any finding."""
    from photon_tpu_torch.lint import load_context, run_lint
    from photon_tpu_torch.lint.thread_model import build_thread_model

    ctx = load_context(root)
    model = build_thread_model(ctx)
    report = run_lint(root=root, only=list(_CONCURRENCY_RULES))
    findings = report["findings"]
    if "--dot" in argv:
        print(model.render_dot())
    elif "--json" in argv:
        print(json.dumps({
            "ok": report["ok"],
            "model": model.to_doc(),
            "n_findings": len(findings),
            "findings": [f.to_json() for f in findings],
        }))
    else:
        print(model.render())
        for f in findings:
            print(f.text)
        print(f"concurrency: {len(findings)} finding(s), "
              f"{len(report['suppressed'])} suppressed"
              + ("" if findings else " — thread model holds"))
    return 0 if report["ok"] else 1


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    from photon_tpu_torch.lint import run_lint
    from photon_tpu_torch.lint.rules import RULES

    if "--list" in argv:
        for name, (_fn, tag, doc) in RULES.items():
            print(f"{name:24s} tag={tag:10s} {doc}")
        return 0
    only: list = []
    it = iter(argv)
    root = None
    for a in it:
        if a == "--only":
            only.append(next(it))
        elif a == "--root":
            root = next(it)
    if "--threads" in argv:
        return threads_main(root, argv)
    unknown = sorted(set(only) - set(RULES) - {"suppression"})
    if unknown:
        print(f"unknown rule(s): {', '.join(unknown)}", file=sys.stderr)
        return 2
    report = run_lint(root=root, only=only or None,
                      changed="--changed" in argv)
    findings = report["findings"]
    if "--json" in argv:
        print(json.dumps({
            "ok": report["ok"],
            "n_files": report["n_files"],
            "n_rules": report["n_rules"],
            "n_findings": len(findings),
            "n_suppressed": len(report["suppressed"]),
            "findings": [f.to_json() for f in findings],
        }))
        return 0 if report["ok"] else 1
    for f in findings:
        print(f.text)
    print(f"{report['n_rules']} rule(s) over {report['n_files']} file(s): "
          f"{len(findings)} finding(s), "
          f"{len(report['suppressed'])} suppressed"
          + ("" if findings else " — all conventions hold"))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
