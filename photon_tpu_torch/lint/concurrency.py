"""The whole-program concurrency rules (thread model consumers; port of
`photon_tpu/lint/concurrency.py`).

Four rules over the :mod:`photon_tpu_torch.lint.thread_model` built from the
lint Context — per-function hygiene stays in ``rules.lock_discipline``;
everything here is cross-file:

- ``lock_order``         — the repo-wide lock acquisition graph (lexical
  ``with`` nesting plus locks taken by callees while a caller holds one)
  must be acyclic; a cycle is a potential deadlock between any two
  threads that walk it in opposite orders.
- ``blocking_under_lock`` — no unbounded wait while holding a lock:
  ``device_get``, untimed ``Queue.put/get``/``join``/``wait``/
  ``result``, file IO, ``subprocess``, ``retry_io`` sleeps — directly
  or via a call whose transitive closure blocks. A lock protecting
  shared state must bound its hold time or every sibling thread
  inherits the stall.
- ``guarded_by``         — every attribute/global written from ≥2
  thread roles must have a common lock held at EVERY write site
  (lexically or on every call path in); unguarded or
  inconsistently-guarded shared writes are the torn-read bugs the
  hot-swap machinery exists to prevent. Waive a deliberate site with
  ``# photon: unguarded(<reason>)``.
- ``concurrency_model``  — the known-good facts pinned as law:
  the port's thread inventory (dispatch/retire/ckpt-writer/fleet/
  ingest pool/launch) exists by name, and the load-bearing guarded-by
  bindings (e.g. "hot-swap device blocks publish under ``_swap_lock``
  only") hold exactly. Deleting a lock or renaming a thread fails the
  lint even when no race is introduced — the model is the spec.
"""
from __future__ import annotations

from photon_tpu_torch.lint import Context, Finding
from photon_tpu_torch.lint.thread_model import build_thread_model

__all__ = ["lock_order", "blocking_under_lock", "guarded_by",
           "concurrency_model", "EXPECTED_THREADS", "EXPECTED_GUARDS"]


def _short(fn_key: str) -> str:
    return fn_key.split("::", 1)[1]


def _attr_rel(attr: str) -> str:
    return attr.split("::", 1)[0]


def _attr_name(attr: str) -> str:
    return attr.split("::", 1)[1]


# ------------------------------------------------------------ lock_order

def lock_order(ctx: Context) -> list:
    """Cycles in the cross-call lock acquisition graph."""
    m = build_thread_model(ctx)
    out: list = []
    for cyc in m.cycles:
        first_edge = (cyc[0], cyc[1] if len(cyc) > 1 else cyc[0])
        rel, line, via = m.lock_edges.get(
            first_edge, (next(iter(ctx.files), "?"), 1, "?"))
        order = " -> ".join(cyc + (cyc[0],))
        out.append(Finding(
            "lock_order", rel, line,
            f"lock-order cycle (potential deadlock): {order} — first "
            f"edge via {via}; break the cycle or impose a global order",
            key="cycle:" + "|".join(cyc)))
    return out


# ---------------------------------------------------- blocking_under_lock

def blocking_under_lock(ctx: Context) -> list:
    """Unbounded blocking operations executed while a lock is held —
    directly, or through a call whose transitive closure blocks."""
    m = build_thread_model(ctx)
    # transitive blocking descriptions per function (held or not: the
    # CALLER's held set is what convicts the call site)
    blk: dict = {k: {d for d, _l, _h in fn.blockers}
                 for k, fn in m.functions.items()}
    adj: dict = {k: {t for cs in fn.calls for t in cs.targets
                     if t in m.functions}
                 for k, fn in m.functions.items()}
    for _ in range(50):
        changed = False
        for k in m.functions:
            for t in adj[k]:
                extra = blk[t] - blk[k]
                if extra:
                    blk[k] |= extra
                    changed = True
        if not changed:
            break
    out: list = []
    for k, fn in sorted(m.functions.items()):
        for desc, line, held in fn.blockers:
            if not held:
                continue
            out.append(Finding(
                "blocking_under_lock", fn.rel, line,
                f"{desc} while holding {', '.join(sorted(held))} in "
                f"{fn.qual} — move the blocking op outside the lock or "
                f"bound it with a timeout",
                key=f"{fn.qual}:{desc}"))
        for cs in fn.calls:
            if not cs.held:
                continue
            inner = set()
            for t in cs.targets:
                inner |= blk.get(t, set())
            if inner:
                out.append(Finding(
                    "blocking_under_lock", fn.rel, cs.line,
                    f"call {cs.dotted}() while holding "
                    f"{', '.join(sorted(cs.held))} in {fn.qual} blocks "
                    f"transitively ({', '.join(sorted(inner)[:3])}) — "
                    "move the call outside the lock",
                    key=f"{fn.qual}:call:{cs.dotted}"))
    return out


# ------------------------------------------------------------ guarded_by

def guarded_by(ctx: Context) -> list:
    """Attributes/globals written from ≥2 thread roles without a common
    lock across all write sites."""
    m = build_thread_model(ctx)
    out: list = []
    for attr, info in sorted(m.shared.items()):
        if info["locks"]:
            continue  # consistently guarded: common lock exists
        rel = _attr_rel(attr)
        name = _attr_name(attr)
        roles = ", ".join(sorted(info["roles"]))
        all_locked = all(locks for _k, _l, locks in info["writes"])
        for fn_key, line, locks in sorted(info["writes"],
                                          key=lambda w: (w[0], w[1])):
            if all_locked:
                msg = (f"{name} is written from roles [{roles}] under "
                       f"DIFFERENT locks (here: "
                       f"{', '.join(sorted(locks))}) with no common "
                       "lock — pick one lock for every writer")
            elif locks:
                continue  # report the unlocked sites, not this one
            else:
                msg = (f"{name} is written from roles [{roles}] with NO "
                       f"lock held at {_short(fn_key)} — guard it, or "
                       "waive with `photon: unguarded(<why>)`")
            out.append(Finding(
                "guarded_by", rel, line, msg,
                key=f"{name}:{_short(fn_key)}"))
    return out


# ------------------------------------------------------ concurrency_model

# The port's thread inventory, pinned by (file, entry label). A missing
# FILE skips the expectation (tiny fixture repos stay clean); a present
# file whose thread/pool vanished or was renamed is a finding. The port
# runs no side thread beside its upload ring (`data.dataset`'s rings
# upload on the caller's thread and a CUDA side stream), so none is
# pinned there.
EXPECTED_THREADS = (
    ("photon_tpu_torch/serving/dispatcher.py", "serving-dispatch"),
    ("photon_tpu_torch/serving/dispatcher.py", "serving-retire"),
    ("photon_tpu_torch/checkpoint/store.py", "photon-ckpt-writer"),
    ("photon_tpu_torch/serving/fleet.py", "ReplicaFleet.score"),
    ("photon_tpu_torch/data/ingest_plane.py", "_worker_init"),
    ("photon_tpu_torch/data/ingest_plane.py", "_decode_task"),
    ("photon_tpu_torch/data/ingest_plane.py", "_pool_decode"),
    ("photon_tpu_torch/parallel/launch.py", "_child_main"),
)

# Load-bearing guarded-by bindings: every write site of the attribute
# (outside __init__) must hold the named lock, lexically or on every
# call path in. "Class.attr" (or "<global>.name") <- the lock's id. The
# reference's `CoefficientStore._device` is the port's
# `CoefficientStore._device_blocks` (the uploaded generation a hot swap
# replaces).
EXPECTED_GUARDS = (
    ("photon_tpu_torch/serving/store.py", "CoefficientStore._device_blocks",
     "photon_tpu_torch.serving.store.CoefficientStore._swap_lock"),
    ("photon_tpu_torch/serving/programs.py", "ProgramLadder._qdev",
     "photon_tpu_torch.serving.programs.ProgramLadder._qlock"),
    ("photon_tpu_torch/checkpoint/store.py", "AsyncSnapshotWriter._err",
     "photon_tpu_torch.checkpoint.store.AsyncSnapshotWriter._err_lock"),
    ("photon_tpu_torch/checkpoint/faults.py", "FaultPlan.hits",
     "photon_tpu_torch.checkpoint.faults._HIT_LOCK"),
    ("photon_tpu_torch/data/ingest_plane.py", "_DecodeState._stores",
     "photon_tpu_torch.data.ingest_plane._DecodeState._lock"),
    ("photon_tpu_torch/native/__init__.py", "<global>._lib",
     "photon_tpu_torch.native._lock"),
    ("photon_tpu_torch/telemetry/run.py", "Run.counters",
     "photon_tpu_torch.telemetry.run.Run._lock"),
    ("photon_tpu_torch/telemetry/run.py", "SignatureLog._seen",
     "photon_tpu_torch.telemetry.run.SignatureLog._lock"),
    ("photon_tpu_torch/telemetry/trace.py", "TraceContext.hops",
     "photon_tpu_torch.telemetry.trace.TraceContext._lock"),
)


def concurrency_model(ctx: Context) -> list:
    """The pinned thread inventory and guarded-by bindings hold."""
    m = build_thread_model(ctx)
    out: list = []
    for rel, label in EXPECTED_THREADS:
        if ctx.get(rel) is None:
            continue
        if any(e.rel == rel and e.label == label for e in m.entries):
            continue
        out.append(Finding(
            "concurrency_model", rel, 1,
            f"expected thread/pool entry {label!r} not found in {rel} — "
            "the production thread inventory is pinned law; update "
            "EXPECTED_THREADS in lint/concurrency.py if this is a "
            "deliberate redesign",
            key=f"thread:{label}"))
    for rel, attr, lock in EXPECTED_GUARDS:
        src = ctx.get(rel)
        if src is None:
            continue
        full = f"{rel}::{attr}"
        sites: list = []
        for fn in m.functions.values():
            if fn.name == "__init__":
                continue
            for w in fn.writes:
                if w.attr == full:
                    sites.append((fn, w))
        if not sites:
            out.append(Finding(
                "concurrency_model", rel, 1,
                f"pinned guarded attribute {attr} has no write sites — "
                "update EXPECTED_GUARDS if it was removed",
                key=f"guard:{attr}:gone"))
            continue
        for fn, w in sites:
            if lock not in m.effective_locks(fn, w.held):
                out.append(Finding(
                    "concurrency_model", fn.rel, w.line,
                    f"{attr} must be published under {lock} ONLY (pinned "
                    f"binding) but {fn.qual} writes it without that lock",
                    key=f"guard:{attr}:{fn.qual}"))
    return out
