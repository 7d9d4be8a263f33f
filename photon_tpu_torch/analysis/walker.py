"""The recorder: the one run every contract rule reads (the port's
counterpart of `photon_tpu/analysis/walker.py`).

Torch has no jaxpr, so a contract's "program" is one call of the spec's
function, observed from three sides at once:

- **aten ops.** A `TorchDispatchMode` logs every aten op the call
  dispatches: its name (``aten.mm``, ``aten.index_add``, ...), the dtypes
  of its tensor inputs and outputs, whether an ``index_put``/``put``
  accumulates, and the bytes it copies from the host. Python loops unroll
  into the log, so a Wolfe trial run 3 times is 3 sets of sites.
- **the port's own counters.** The mesh's `parallel.mesh.psum` counts
  ``mesh.reductions`` (one an evaluation close) and its cross-process
  gathers ``mesh.collectives``; the hand-written kernels launch through
  ctypes, which the dispatch mode does not see, so their launches are
  read from `kernels.launch_counts` and their outputs from the launch
  hook (`kernels.add_launch_hook`); the layout plans and kernel plans
  built (`kernels.plan_builds`), the libraries loaded
  (`kernels.library_loads`) and the new signatures a `SignatureLog`
  recorded are counted around the call.
- **host syncs.** On the card, `utils.profiling.count_syncs` (torch's
  sync debug mode: every call that waits for the device, read-backs and
  pageable uploads alike). On the CPU nothing waits, so the recorder
  counts what would: ``aten._local_scalar_dense`` (``item``, ``bool``,
  ``float``, ``int`` of a tensor), ``Tensor.tolist`` calls and
  cross-device copies.

The helper names of the reference carry over (`sites`,
`count_primitives`, `collective_counts`), keyed by aten op name.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import Counter
from typing import Iterable, Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# The mesh's collective counters, by the reference's primitive names:
# `psum` is one evaluation close (`parallel.mesh.psum`, counted in
# ``mesh.reductions``), `all_gather` one cross-process gather
# (`parallel.mesh.gather_processes`, ``mesh.collectives``).
COLLECTIVE_COUNTERS = {"psum": "mesh.reductions",
                       "all_gather": "mesh.collectives"}
COLLECTIVE_PRIMITIVES = frozenset(COLLECTIVE_COUNTERS)

# The combining scatters (the reference's scatter-add family): every aten
# op whose writes to one index combine. An ``index_put``/``put`` counts
# only with ``accumulate=True`` (the recorder names it with the
# ``[accumulate]`` suffix).
SCATTER_ADD_PRIMITIVES = frozenset({
    "aten.scatter_add", "aten.scatter_add_", "aten.scatter_reduce",
    "aten.scatter_reduce_", "aten.index_add", "aten.index_add_",
    "aten.index_reduce", "aten.index_reduce_",
    "aten.index_put[accumulate]", "aten.index_put_[accumulate]",
    "aten._index_put_impl_[accumulate]", "aten.put[accumulate]",
    "aten.put_[accumulate]",
})

# The reference's full scatter family adds its plain ``scatter`` (an
# ``.at[i].set`` write, lowered to a dynamic-update-slice). Its torch
# counterparts (``index_put`` without accumulate, ``index_copy``,
# ``scatter``) write each index once and combine nothing, so the family
# maps to the combining ops alone: a forbid of either family pins the
# same fact, no read-modify-write of one index from two sources.
SCATTER_PRIMITIVES = SCATTER_ADD_PRIMITIVES

# The reference's ``device_put``/callback family: the points where a hot
# program leaves the device. In torch they are the host syncs the
# recorder counts (see the module docstring); a spec that forbids them
# holds them to its ``max_syncs`` budget (`rules.rule_transfer_lint`).
TRANSFER_PRIMITIVES = frozenset({"host_sync"})

# The matmul family (the reference's ``dot_general``): every aten
# contraction, plus any hand-written kernel launch (``kernel:<name>``
# sites) — a kernel launch is a pass over X.
MATMUL_OPS = frozenset({
    "aten.mm", "aten.bmm", "aten.addmm", "aten.addmv", "aten.mv",
    "aten.dot", "aten.vdot", "aten.matmul", "aten.baddbmm", "aten.addbmm",
    "aten.einsum", "aten._scaled_mm", "aten.linear", "aten.tensordot",
})
DOT_GENERAL = frozenset({"dot_general"})

# Reductions whose accumulator follows the operand dtype.
ACCUMULATING_OPS = frozenset({
    "aten.sum", "aten.cumsum", "aten.cumsum_", "aten.mean", "aten.nansum",
    "aten.prod", "aten.cumprod", "aten.logsumexp", "aten.segment_reduce",
})

# Sources of host data copied into a program on every call.
UPLOAD_OPS = frozenset({"aten.lift_fresh", "aten.lift_fresh_copy"})


@dataclasses.dataclass(frozen=True)
class Site:
    """One recorded op (or counter event) of the program."""

    name: str
    in_dtypes: tuple = ()
    out_dtypes: tuple = ()
    index: int = 0

    @property
    def where(self) -> str:
        return f"#{self.index}:{self.name}"


@dataclasses.dataclass
class Recording:
    """One recorded call: its sites and the counters around it."""

    sites: list
    collectives: Counter
    launches: Counter
    plan_builds: int
    library_loads: int
    new_signatures: int
    syncs: int
    sync_sites: dict
    upload_bytes: int


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _op_name(func, args, kwargs) -> str:
    """``aten.<op>``, with ``[accumulate]`` for an accumulating
    ``index_put``/``put`` (``accumulate`` is their fourth argument)."""
    name = str(func.overloadpacket)
    if name.split(".")[-1] in ("index_put", "index_put_", "_index_put_impl_",
                               "put", "put_"):
        acc = kwargs.get("accumulate", args[3] if len(args) > 3 else False)
        if acc:
            return f"{name}[accumulate]"
    return name


class _OpLog(TorchDispatchMode):
    """Logs every aten op dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.sites: list = []
        self.host_copies = 0
        self.upload_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        name = _op_name(func, args, kwargs)
        nbytes = sum(t.numel() * t.element_size() for t in outs)
        self.sites.append(Site(
            name, tuple(str(t.dtype) for t in ins),
            tuple(str(t.dtype) for t in outs), len(self.sites)))
        if name in ("aten._to_copy", "aten.copy_", "aten._copy_from"):
            src = {t.device.type for t in ins}
            dst = {t.device.type for t in outs}
            if "cuda" in src and "cpu" in dst:
                self.host_copies += 1
            elif "cpu" in src and "cuda" in dst:
                self.upload_bytes += nbytes
        if name in UPLOAD_OPS:
            self.upload_bytes += nbytes
        return out


def _counter_values() -> Counter:
    from photon_tpu_torch import telemetry

    c = telemetry.snapshot()["counters"]
    return Counter({k: int(c.get(v, 0))
                    for k, v in COLLECTIVE_COUNTERS.items()})


@contextlib.contextmanager
def _count_new_signatures(box: dict):
    """Counts the `SignatureLog.record` calls that found a new signature."""
    from photon_tpu_torch.telemetry.run import SignatureLog

    orig = SignatureLog.record

    def record(self, name, args):
        new = orig(self, name, args)
        if new:
            box["n"] += 1
        return new

    SignatureLog.record = record
    try:
        yield
    finally:
        SignatureLog.record = orig


@contextlib.contextmanager
def _count_tolist(box: dict):
    orig = torch.Tensor.tolist

    def tolist(self):
        box["n"] += 1
        return orig(self)

    torch.Tensor.tolist = tolist
    try:
        yield
    finally:
        torch.Tensor.tolist = orig


@contextlib.contextmanager
def _kernel_outputs(sites: list):
    """Logs each hand-written kernel launch as a ``kernel:<name>`` site
    with its output dtype."""
    from photon_tpu_torch import kernels

    def hook(name, n, out):
        sites.append(Site(f"kernel:{name}", (),
                          tuple(str(t.dtype) for t in _tensors(out)), -1))

    kernels.add_launch_hook(hook)
    try:
        yield
    finally:
        kernels.remove_launch_hook(hook)


def record(fn, args, device="cuda") -> tuple:
    """Run ``fn(*args)`` under the recorder; returns (its result, the
    `Recording`). ``device`` picks the sync count: the card's sync debug
    mode for ``cuda``, the CPU's read-back census otherwise."""
    from photon_tpu_torch import kernels
    from photon_tpu_torch.utils.profiling import count_syncs

    dev = torch.device(device)
    c0, l0 = _counter_values(), Counter(kernels.launch_counts())
    p0, lib0 = kernels.plan_builds(), kernels.library_loads()
    sig, tl = {"n": 0}, {"n": 0}
    ksites: list = []
    log = _OpLog()
    with contextlib.ExitStack() as stack:
        stack.enter_context(_count_new_signatures(sig))
        stack.enter_context(_kernel_outputs(ksites))
        if dev.type == "cuda":
            syncs = stack.enter_context(count_syncs(dev))
        else:
            syncs = None
            stack.enter_context(_count_tolist(tl))
        with log:
            out = fn(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    if syncs is not None:
        n_sync, sync_sites = int(syncs["n"]), dict(syncs.get("sites", {}))
    else:
        scalar = sum(s.name == "aten._local_scalar_dense" for s in log.sites)
        n_sync = scalar + tl["n"] + log.host_copies
        sync_sites = {"_local_scalar_dense": scalar, "tolist": tl["n"],
                      "device_to_host": log.host_copies}
    launches = Counter(kernels.launch_counts())
    launches.subtract(l0)
    coll = _counter_values()
    coll.subtract(c0)
    rec = Recording(
        sites=log.sites + ksites,
        collectives=+coll, launches=+launches,
        plan_builds=kernels.plan_builds() - p0,
        library_loads=kernels.library_loads() - lib0,
        new_signatures=sig["n"], syncs=n_sync, sync_sites=sync_sites,
        upload_bytes=log.upload_bytes)
    return out, rec


def sites(rec: Recording) -> Iterator[Site]:
    """Every recorded op and kernel launch of the call, in order."""
    yield from rec.sites


def count_primitives(rec: Recording,
                     names: Optional[Iterable[str]] = None) -> Counter:
    """Occurrence count per op name (``kernel:<name>`` for launches);
    ``names`` restricts the census (None counts everything). The name
    ``dot_general`` stands for the whole matmul family and every kernel
    launch."""
    wanted = None if names is None else frozenset(names)
    out: Counter = Counter()
    for s in rec.sites:
        key = s.name
        if wanted is not None and "dot_general" in wanted and (
                key in MATMUL_OPS or key.startswith("kernel:")):
            out["dot_general"] += 1
            continue
        if wanted is None or key in wanted:
            out[key] += 1
    return out


def collective_counts(rec: Recording) -> Counter:
    """How many of each mesh collective the call made (the reference's
    per-primitive census, read from the mesh's counters)."""
    return Counter({k: v for k, v in rec.collectives.items() if v})
