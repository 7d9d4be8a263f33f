"""CLI: run every registered hot-path contract and report violations.

    python -m photon_tpu_torch.analysis                # on the card
    python -m photon_tpu_torch.analysis --device cpu   # on the CPU
    python -m photon_tpu_torch.analysis --json         # one object
    python -m photon_tpu_torch.analysis --list         # names + budgets
    python -m photon_tpu_torch.analysis --tag mesh --only NAME ...

Each contract runs its function twice on small seeded inputs under the
recorder (`analysis.walker`). It runs on the card unless ``--device cpu``
is given; ``--device cuda`` without a card raises (no fallback to the
CPU). Exit status: 0 iff every contract holds, 1 on any violation, 2 on
an unknown contract name.
"""
from __future__ import annotations

import json
import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    as_json = "--json" in argv
    list_only = "--list" in argv
    tags: list = []
    only: list = []
    device = "cuda"
    it = iter(argv)
    for a in it:
        if a == "--tag":
            tags.append(next(it))
        elif a == "--only":
            only.append(next(it))
        elif a == "--device":
            device = next(it)

    from photon_tpu_torch.analysis.contracts import check_registry
    from photon_tpu_torch.analysis.registry import load_registry

    specs = load_registry()
    if only:
        missing = sorted(set(only) - set(specs))
        if missing:
            print(f"unknown contract(s): {', '.join(missing)}",
                  file=sys.stderr)
            return 2
        specs = {k: v for k, v in specs.items() if k in only}

    if list_only:
        for name in sorted(specs):
            s = specs[name]
            if tags and not (set(tags) & set(s.tags)):
                continue
            budget = dict(s.collectives or {})
            print(f"{name:40s} tags={','.join(s.tags) or '-':28s} "
                  f"collectives={budget or 'none'} syncs<={s.max_syncs}")
        return 0

    from photon_tpu_torch.device import resolve_device

    device = str(resolve_device(device))
    report = check_registry(specs, tags=tuple(tags) or None, device=device)
    violations = [v for entry in report.values()
                  for v in entry.get("violations", [])]
    if as_json:
        print(json.dumps({
            "ok": not violations,
            "device": device,
            "n_specs": len(report),
            "n_violations": len(violations),
            "specs": report,
        }))
        return 1 if violations else 0

    for name, entry in report.items():
        head = (f"{name}: {entry.get('ops', '?')} ops, "
                f"collectives={entry.get('collectives') or 'none'}, "
                f"syncs={entry.get('syncs', '?')}, "
                f"launches={entry.get('launches') or 'none'}, "
                f"plans 2nd call={entry.get('plan_builds_second', '?')}")
        marks = entry["violations"]
        print(("FAIL " if marks else "ok   ") + head)
        for v in marks:
            loc = f"  [at {v['where']}]" if v.get("where") else ""
            print(f"     !! ({v['rule']}) {v['message']}{loc}")
    n = len(violations)
    print(f"{len(report)} contract(s) checked on {device}, "
          f"{n} violation(s)" + ("" if n else " — all hot paths hold"))
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
