"""Run-time performance contracts of the port's hot paths (port of
`photon_tpu/analysis`).

The port's speed rests on invariants the code states only implicitly —
ONE reduction per mesh evaluation, communication-free chunk partials,
no combining scatter on the blocked-ELL and permuted layouts, f32
accumulation, no host round-trip inside an X pass or a kernel call, no
plan rebuilt and no new signature on a second call. The reference checks
them on the traced jaxpr; torch has no jaxpr, so each contract here is a
small run of the spec's function under a recorder:

- `walker`    — the recorder (a `TorchDispatchMode` over the aten ops,
                the mesh's and the kernels' own counters, host syncs).
- `rules`     — the five contract rules with their torch meaning, and
                `TraceSignatureLog` (`telemetry.run.SignatureLog`).
- `contracts` — ContractSpec + register_contract + the check engine.
- `registry`  — imports every hot-path module so their registrations
                run (not imported here, so those modules can import this
                package).

CLI: ``python -m photon_tpu_torch.analysis [--json] [--device cpu]``
runs the whole registry (on the card unless ``--device cpu``) and
exits 1 on any violation.
"""
from photon_tpu_torch.analysis.walker import (  # noqa: F401
    COLLECTIVE_PRIMITIVES,
    DOT_GENERAL,
    MATMUL_OPS,
    SCATTER_ADD_PRIMITIVES,
    SCATTER_PRIMITIVES,
    TRANSFER_PRIMITIVES,
    Recording,
    Site,
    collective_counts,
    count_primitives,
    record,
    sites,
)
from photon_tpu_torch.analysis.rules import (  # noqa: F401
    RULES,
    TracedContract,
    Violation,
)
from photon_tpu_torch.analysis.contracts import (  # noqa: F401
    REGISTRY,
    ContractSpec,
    check_contract,
    check_registry,
    register_contract,
    summarize,
    trace_contract,
)


def __getattr__(name):
    if name == "TraceSignatureLog":
        from photon_tpu_torch.analysis import rules

        return rules.TraceSignatureLog
    raise AttributeError(name)
