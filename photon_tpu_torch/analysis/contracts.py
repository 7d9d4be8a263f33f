"""ContractSpec: a hot-path program builder + its declared performance
budgets, and the engine that runs and checks one (port of
`photon_tpu/analysis/contracts.py`).

Hot paths register their own specs NEXT TO the code they pin (the bottom
of `ops/objective.py`, `optim/streamed.py`, `parallel/mesh.py`, ...) via
`register_contract`, so a change to a hot path and the contract it must
keep land in the same diff. `analysis.registry` imports those modules
and hands the collected registry to the CLI (``python -m
photon_tpu_torch.analysis``) and the tests.

A spec's ``build(device)`` returns ``(fn, example_args)`` on ``device``.
Checking runs ``fn(*example_args)`` twice under the recorder
(`walker.record`): the first call is the warm one (a kernel library
builds, a layout plan is made), the second the steady state every rule
reads, and `rules.rule_retrace_hazard` holds it to adding nothing. A
contract whose law is that a disarmed hook adds nothing returns
``(fn, example_args, bare)``: ``bare`` runs the same path without the
hook on the same arguments, is recorded the same way, and
`rules.rule_transfer_lint` holds ``fn``'s syncs equal to its.
Builders make small example arguments directly from a seeded numpy
generator. A builder that raises is a ``trace-error`` violation, never a
skip.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional

from photon_tpu_torch.analysis import walker
from photon_tpu_torch.analysis.rules import RULES, TracedContract, Violation


@dataclasses.dataclass(frozen=True)
class ContractSpec:
    """One hot-path program and the performance law it must obey.

    collectives: exact per-call budget of mesh collectives (e.g.
        ``{"psum": 1}`` — ONE evaluation close); any one not named
        budgets to ZERO. None is shorthand for {}.
    forbid: ops that must not run at all (`walker`'s families).
    max_const_bytes: host bytes uploaded per call (rule 4).
    max_syncs: the host syncs the call may make (rule 2); 0 unless set.
        An int, or a mapping from device type to the budget there
        (``{"cuda": 24, "cpu": 7}``): the card's sync debug mode also
        counts pageable uploads, which the CPU's census cannot see. A
        Python-loop solver's read-backs are pinned here, exactly as
        measured, as a budget that can only fall, with a comment naming
        the count per iteration (ROADMAP speed item 1).
    allow_transfers / allow_f64 / allow_weak_args: opt-outs for rules
        2/3/5 — default is the strict policy.
    require_f32_accum: every matmul, sum or cumsum over bf16 inputs, and
        every hand-written kernel's output, is f32.
    tags: workload families for filtering/reporting.
    """

    name: str
    build: Callable
    description: str = ""
    collectives: Optional[Mapping[str, int]] = None
    forbid: frozenset = frozenset()
    max_const_bytes: int = 1 << 20
    max_syncs: object = 0
    allow_transfers: bool = False
    allow_f64: bool = False
    allow_weak_args: bool = False
    require_f32_accum: bool = False
    tags: tuple = ()


# name -> ContractSpec; populated at import time by the hot-path modules.
REGISTRY: dict = {}


def register_contract(name: str, *, description: str = "",
                      collectives: Optional[Mapping[str, int]] = None,
                      forbid=frozenset(), max_const_bytes: int = 1 << 20,
                      max_syncs=0, allow_transfers: bool = False,
                      allow_f64: bool = False, allow_weak_args: bool = False,
                      require_f32_accum: bool = False, tags: tuple = ()):
    """Decorator: register the decorated builder ``build(device)`` as
    ``name``; a second spec of the same name raises."""

    def wrap(build: Callable):
        if name in REGISTRY:
            raise ValueError(f"duplicate contract name: {name!r}")
        REGISTRY[name] = ContractSpec(
            name=name, build=build, description=description,
            collectives=collectives, forbid=frozenset(forbid),
            max_const_bytes=max_const_bytes,
            max_syncs=(dict(max_syncs) if isinstance(max_syncs, Mapping)
                       else int(max_syncs)),
            allow_transfers=allow_transfers, allow_f64=allow_f64,
            allow_weak_args=allow_weak_args,
            require_f32_accum=require_f32_accum, tags=tuple(tags))
        return build

    return wrap


def sync_budget(spec: ContractSpec, device) -> int:
    """``spec``'s host-sync budget on ``device``."""
    import torch

    b = spec.max_syncs
    if isinstance(b, Mapping):
        return int(b.get(torch.device(device).type, 0))
    return int(b)


def trace_contract(spec: ContractSpec, device="cuda") -> TracedContract:
    """Build ``spec`` on ``device`` (the card unless the caller asks for
    the CPU) and run it twice under the recorder."""
    from photon_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    fn, args, *bare = spec.build(dev)
    _, first = walker.record(fn, args, dev)
    _, second = walker.record(fn, args, dev)
    bare_rec = None
    if bare:
        walker.record(bare[0], args, dev)
        _, bare_rec = walker.record(bare[0], args, dev)
    return TracedContract(spec=spec, first=first, second=second,
                          example_args=tuple(args), device=str(dev),
                          bare=bare_rec)


def check_contract(spec: ContractSpec,
                   traced: Optional[TracedContract] = None,
                   device="cuda") -> list:
    """All rule violations of one spec (empty == contract holds)."""
    t = traced if traced is not None else trace_contract(spec, device)
    out: list = []
    for rule in RULES.values():
        out.extend(rule(t))
    return out


def summarize(t: TracedContract) -> dict:
    """Per-call facts for the report, from the steady-state call."""
    s = t.second
    return {
        "ops": len([x for x in s.sites if not x.name.startswith("kernel:")]),
        "collectives": dict(sorted(walker.collective_counts(s).items())),
        "syncs": s.syncs,
        "launches": dict(sorted(s.launches.items())),
        "upload_bytes": s.upload_bytes,
        "plan_builds_first": t.first.plan_builds,
        "plan_builds_second": s.plan_builds,
        "new_signatures_second": s.new_signatures,
        **({"bare_syncs": t.bare.syncs} if t.bare is not None else {}),
    }


def check_registry(specs: Optional[Mapping[str, ContractSpec]] = None,
                   tags: Optional[tuple] = None, device="cuda") -> dict:
    """Run + check every spec on ``device``; returns name -> {spec facts,
    violations}. A builder or run that ERRORS is itself reported as a
    ``trace-error`` violation of that spec."""
    specs = dict(REGISTRY if specs is None else specs)
    report: dict = {}
    for name in sorted(specs):
        spec = specs[name]
        if tags and not (set(tags) & set(spec.tags)):
            continue
        entry: dict = {"description": spec.description,
                       "tags": list(spec.tags)}
        try:
            traced = trace_contract(spec, device)
        except Exception as e:  # noqa: BLE001 — reported, not swallowed
            entry["violations"] = [Violation(
                "trace-error", name,
                f"builder/run failed: {type(e).__name__}: {e}").to_json()]
            report[name] = entry
            continue
        entry.update(summarize(traced))
        entry["violations"] = [v.to_json()
                               for v in check_contract(spec, traced)]
        report[name] = entry
    return report


def check_names(names, device="cuda") -> dict:
    """The self-test CLIs' ``contracts`` check: the registry loaded and
    each of ``names`` checked on ``device``; ``{"ok", "n"}`` plus the
    ``violations`` by name when any fails. A builder that raises is a
    ``trace-error`` violation of its contract."""
    from photon_tpu_torch.analysis.registry import load_registry

    registry = load_registry()
    bad: dict = {}
    for name in names:
        try:
            violations = [str(v) for v in
                          check_contract(registry[name], device=device)]
        except Exception as e:  # noqa: BLE001 — reported, not swallowed
            violations = [f"{name}: (trace-error) {type(e).__name__}: {e}"]
        if violations:
            bad[name] = violations
    return {"ok": not bad, "n": len(names),
            **({"violations": bad} if bad else {})}
