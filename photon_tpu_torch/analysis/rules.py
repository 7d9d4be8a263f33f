"""Contract rules (port of `photon_tpu/analysis/rules.py`): each one turns
a recorded call + its declared budgets into zero or more `Violation`s.

The five rules, each given its torch meaning (the reference's meaning
after the dash):

1. ``collective-budget`` — per call, the number of mesh evaluation closes
   (`parallel.mesh.psum`, named ``psum``) and of cross-process gathers
   (``all_gather``) must EQUAL the spec's budget (undeclared ones budget
   0); ``forbid`` names ops that must not run at all. The reference's
   scatter family maps to the combining aten ops (``scatter_add``,
   ``scatter_reduce``, ``index_add``, ``index_put``/``put`` with
   ``accumulate=True``); its ``dot_general`` to the matmul family plus
   every hand-written kernel launch (a pass over X) — the traced-count
   rule on a jaxpr.
2. ``transfer-lint`` — the host syncs made inside the call must not
   exceed ``max_syncs`` (0 unless set, or unless ``allow_transfers``).
   The port's Python-loop solvers read back by design; their specs pin
   the count as a budget that can only fall (ROADMAP speed item 1).
   Where the builder also returns the bare path (an ``*_off_is_free``
   contract: the solver without the disarmed hook), the call's syncs
   must EQUAL the bare call's on the same arguments, so a sync the off
   path adds shows even inside the budget — no
   ``device_put``/callback inside a jitted program.
3. ``dtype-policy`` — no float64 tensor among the recorded outputs
   (unless ``allow_f64``), no bf16 x bf16 -> bf16 matmul, and under
   ``require_f32_accum`` every matmul, sum or cumsum with a bf16 input,
   and every hand-written kernel's output, is f32 — no f64 aval, bf16
   accumulation on the MXU.
4. ``const-bloat`` — host data uploaded inside the call on every call
   (tensors built from host arrays: ``aten.lift_fresh``, CPU->CUDA
   copies) past ``max_const_bytes`` — baked-in constants.
5. ``retrace-hazard`` — the call repeated on arguments of the same
   signature must add no new `telemetry.run.SignatureLog` signature, no
   kernel plan and no library load; a Python float among the example's
   arguments (where a tensor belongs) is the weak-type counterpart
   (`telemetry.run.float_drift` reads the dtype side) — weak-typed
   inputs and captured scalars retrace a jitted program.

`TraceSignatureLog` is `telemetry.run.SignatureLog` itself, re-exported
under the reference's name.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from photon_tpu_torch.analysis import walker


def __getattr__(name):
    # `TraceSignatureLog` is `telemetry.run.SignatureLog`, imported on
    # first use: the telemetry package registers a contract of its own,
    # so this module cannot import it at load time
    if name == "TraceSignatureLog":
        from photon_tpu_torch.telemetry.run import SignatureLog

        return SignatureLog
    raise AttributeError(name)


@dataclasses.dataclass(frozen=True)
class Violation:
    """One contract breach, ready for the human or --json report."""

    rule: str
    spec: str
    message: str
    where: str = ""

    def __str__(self) -> str:
        loc = f" [at {self.where}]" if self.where else ""
        return f"{self.spec}: ({self.rule}) {self.message}{loc}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class TracedContract:
    """A ContractSpec run twice under the recorder: ``first`` (the warm
    call: library builds, plans) and ``second`` (the steady state every
    rule but retrace-hazard reads), plus the builder's example args."""

    spec: object
    first: object
    second: object
    example_args: tuple
    device: str = "cpu"
    bare: object = None  # the bare path's steady call, where one is built


# ------------------------------------------------------------------- rules
def rule_collective_budget(t: TracedContract) -> list:
    out = []
    spec = t.spec
    budget = dict(spec.collectives or {})
    counts = walker.collective_counts(t.second)
    for name in sorted(set(budget) | set(counts)):
        want, got = budget.get(name, 0), counts.get(name, 0)
        if got != want:
            out.append(Violation(
                "collective-budget", spec.name,
                f"ran {got} `{name}` against a budget of {want}"))
    forbid = frozenset(spec.forbid) - walker.TRANSFER_PRIMITIVES
    if forbid:
        hits = walker.count_primitives(t.second, forbid)
        for name, got in sorted(hits.items()):
            where = [s.where for s in t.second.sites
                     if s.name == name or (name == "dot_general" and (
                         s.name in walker.MATMUL_OPS
                         or s.name.startswith("kernel:")))]
            out.append(Violation(
                "collective-budget", spec.name,
                f"forbidden op `{name}` ran {got}x (this path is "
                f"{name}-free by construction)", "; ".join(where[:4])))
    return out


def rule_transfer_lint(t: TracedContract) -> list:
    if t.spec.allow_transfers:
        return []
    from photon_tpu_torch.analysis.contracts import sync_budget

    budget = sync_budget(t.spec, t.device)
    got = t.second.syncs
    sites = ", ".join(f"{k} x{v}" for k, v in
                      sorted(t.second.sync_sites.items()) if v)
    out = []
    if got > budget:
        out.append(Violation(
            "transfer-lint", t.spec.name,
            f"{got} host sync(s) inside the call against a budget of "
            f"{budget} — every sync stalls the host on the device", sites))
    if t.bare is not None and got != t.bare.syncs:
        out.append(Violation(
            "transfer-lint", t.spec.name,
            f"{got} host sync(s) inside the call against the bare path's "
            f"{t.bare.syncs} on the same arguments — the disarmed hook "
            f"must add none", sites))
    return out


_WIDE = ("torch.float64", "torch.complex128")
_NARROW = ("torch.bfloat16", "torch.float16")


def rule_dtype_policy(t: TracedContract) -> list:
    out = []
    spec = t.spec
    f64 = []
    for s in walker.sites(t.second):
        if not spec.allow_f64 and any(d in _WIDE for d in s.out_dtypes):
            f64.append(s.where)
        narrow_out = bool(s.out_dtypes) and s.out_dtypes[0] in _NARROW
        if s.name in walker.MATMUL_OPS:
            bf_in = [d for d in s.in_dtypes if d in _NARROW]
            if bf_in and len(bf_in) >= 2 and narrow_out:
                out.append(Violation(
                    "dtype-policy", spec.name,
                    "bf16 x bf16 -> bf16 matmul (pass f32 operands or an "
                    "f32 output: bf16 products must accumulate f32)",
                    s.where))
                continue
            if spec.require_f32_accum and bf_in and narrow_out:
                out.append(Violation(
                    "dtype-policy", spec.name,
                    f"`{s.name}` accumulates {s.out_dtypes[0]} on a "
                    "require_f32_accum program (every sparse matmul must "
                    "output float32)", s.where))
        elif spec.require_f32_accum and s.name in walker.ACCUMULATING_OPS \
                and s.in_dtypes and s.in_dtypes[0] in _NARROW \
                and narrow_out:
            out.append(Violation(
                "dtype-policy", spec.name,
                f"`{s.name}` accumulates in {s.out_dtypes[0]} on a "
                "require_f32_accum program", s.where))
        elif spec.require_f32_accum and s.name.startswith("kernel:") \
                and any(d != "torch.float32" for d in s.out_dtypes):
            out.append(Violation(
                "dtype-policy", spec.name,
                f"hand-written kernel `{s.name[7:]}` writes "
                f"{'/'.join(s.out_dtypes)} on a require_f32_accum program",
                s.where))
    if f64:
        out.append(Violation(
            "dtype-policy", spec.name,
            f"float64 leaked into {len(f64)} op output(s) — every hot-path "
            "tensor is f32/bf16 by policy", "; ".join(f64[:4])))
    return out


def rule_const_bloat(t: TracedContract) -> list:
    total = t.second.upload_bytes
    if total <= t.spec.max_const_bytes:
        return []
    return [Violation(
        "const-bloat", t.spec.name,
        f"{total / 1e6:.3f} MB of host data uploaded inside every call "
        f"(budget {t.spec.max_const_bytes / 1e6:.3f} MB) — build it once "
        "on the device and pass it as an argument")]


def _python_floats(tree, path="args") -> list:
    if isinstance(tree, bool):
        return []
    if isinstance(tree, float):
        return [path]
    if isinstance(tree, (tuple, list)):
        return [p for i, v in enumerate(tree)
                for p in _python_floats(v, f"{path}[{i}]")]
    return []


def rule_retrace_hazard(t: TracedContract) -> list:
    from photon_tpu_torch.telemetry.run import float_drift, signature

    out = []
    spec, second = t.spec, t.second
    if second.new_signatures:
        out.append(Violation(
            "retrace-hazard", spec.name,
            f"the second call on the same signature recorded "
            f"{second.new_signatures} new program signature(s)"))
    if second.plan_builds:
        out.append(Violation(
            "retrace-hazard", spec.name,
            f"the second call built {second.plan_builds} kernel plan(s) "
            "again — a plan is built once per layout"))
    if second.library_loads:
        out.append(Violation(
            "retrace-hazard", spec.name,
            f"the second call loaded {second.library_loads} kernel "
            "library(ies) again"))
    if not spec.allow_weak_args:
        for path in _python_floats(t.example_args):
            out.append(Violation(
                "retrace-hazard", spec.name,
                f"{path} is a Python float where a tensor belongs — the "
                "weak-type counterpart: a scalar passed sometimes as a "
                "float and sometimes as a tensor changes the signature"))
        if not spec.allow_f64:
            drift = [d for d in float_drift(signature(t.example_args))
                     if "64" in d]
            if drift:
                out.append(Violation(
                    "retrace-hazard", spec.name,
                    f"example arguments carry {sorted(set(drift))} — "
                    "dtype drift against the f32 policy"))
    return out


RULES: dict[str, Callable[[TracedContract], list]] = {
    "collective-budget": rule_collective_budget,
    "transfer-lint": rule_transfer_lint,
    "dtype-policy": rule_dtype_policy,
    "const-bloat": rule_const_bloat,
    "retrace-hazard": rule_retrace_hazard,
}
