"""Static per-program cost estimates (port of `StaticCost` of
`photon_tpu/profiling/model.py`, with `lane_grid_cost`, the price the
lane tuner checks a round against before it dispatches it, and
`chunk_cost`, the price of one call of a streamed solver's chunk program,
which the attribution ledger divides by its measured seconds).

The reference prices a program by walking its jaxpr (trace only). The
port has no jaxpr, and `torch.utils.flop_counter` does not see the
hand-written kernels, so a lane-grid solve is priced from the program's
own structure instead: the X passes an iteration makes (two for the
margin-cached L-BFGS and TRON's accepted step, one a trial for OWL-QN,
two a CG step for TRON), each 2·nnz·G FLOPs over the layout's stored
slots (dense: n·d; `SparseRows`: n·k; `BlockedEllRows`: the hot block
n·h plus the ELL tail's slots on a matvec and the occurrence buckets'
on an Xᵀr); the line search's elementwise trials over (n, G) at its trial
cap; the per-lane vector work (the two-loop recursion over the history);
``max_iters`` iterations plus the start's two passes. Bytes are what
those passes read (each stored value and its index once a pass) plus the
(n, G) and (m, d, G) vectors they touch. Collective bytes are 0 off the
mesh; on a mesh, every evaluation's one reduction payload ((d, G)
gradient, or a trial's 2·G scalars). Per-device view, as the
reference's: a mesh is priced on one slot's share of the rows.

A chunk program (`optim/streamed.py`: ``chunk_init``, ``chunk_grad``,
``chunk_dz_phi``, ``chunk_phi``, ``chunk_value_many``) is priced from the
same X passes (`_x_passes`, `_add_pass`) plus the eager elementwise
kernels the program launches over the chunk's rows, each charged
`ELEM_BYTES` a row: eager PyTorch writes every elementwise result to
memory, where the reference's jaxpr walk charges each equation's
operands (a proxy that XLA's fusion undercuts). The reference's
``xla_cost`` (XLA's own view of the compiled program) has no counterpart:
there is no compiled program to ask, so the ledger reports ``xla: null``.
"""
from __future__ import annotations

import dataclasses

import torch

# Elementwise operations a line-search trial makes per (row, lane): the
# margin z + a·dz, the loss and its derivative (a few transcendentals),
# the weight and the two reductions.
TRIAL_OPS = 10
# Elementwise operations an evaluation makes per (row, lane) besides its
# X passes: the loss derivative and the residual.
EVAL_OPS = 10
# Per-lane vector operations an iteration makes per coordinate besides
# the two-loop recursion (direction, step, the (s, y) pair, norms).
VECTOR_OPS = 10
# The lane solvers' trial caps (optim/lane_lbfgs.py, lane_owlqn.py).
LBFGS_TRIALS = 12
OWLQN_TRIALS = 20
# An eager elementwise kernel over a chunk's rows reads up to two f32
# operands and writes one f32 result: bytes a row.
ELEM_BYTES = 12.0
# Eager kernels a row (and transcendentals) of the chunk programs on the
# logistic loss, the main path's (`ops/objective.py`, `ops/losses.py`):
# the partials at a margin — d1 (sigmoid, − y), × weights, the loss
# (zeros, logaddexp, − y·z: three), × weights, Σ; the margin's offset add;
# a φ trial — z + a·dz (two), the loss four, × weights, Σ, d1 two,
# × weights, × dz, Σ; a ladder lane — Z + offsets, the loss four,
# × weights, Σ.
PARTIALS_OPS, PARTIALS_TRANS = 9, 3
MARGIN_OPS = 1
PHI_OPS, PHI_TRANS = 13, 3
LANE_VALUE_OPS, LANE_VALUE_TRANS = 7, 2
CHUNK_PROGRAMS = ("chunk_init", "chunk_grad", "chunk_dz_phi", "chunk_phi",
                  "chunk_value_many")


@dataclasses.dataclass
class StaticCost:
    """One program's modeled cost (per call, per device)."""

    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    transcendentals: float = 0.0
    dot_flops: float = 0.0
    # random-access traffic of gathers (index-driven slots; included in
    # `bytes`)
    gather_bytes: float = 0.0
    # bytes removed from the charge by narrow storage (bf16 values read
    # at 2 bytes, not the f32 they widen to)
    narrowed_bytes: float = 0.0
    eqns: int = 0
    while_loops: int = 0
    while_trips_assumed: int = 1

    @property
    def lower_bound(self) -> bool:
        """True when a loop was priced at the default single trip."""
        return self.while_loops > 0 and self.while_trips_assumed <= 1

    @property
    def intensity(self) -> float:
        """Arithmetic intensity (FLOPs per byte moved)."""
        return self.flops / self.bytes if self.bytes > 0 else 0.0

    def to_json(self) -> dict:
        return {
            "flops": self.flops, "bytes": self.bytes,
            "collective_bytes": self.collective_bytes,
            "transcendentals": self.transcendentals,
            "dot_flops": self.dot_flops,
            "gather_bytes": self.gather_bytes,
            "narrowed_bytes": self.narrowed_bytes, "eqns": self.eqns,
            "while_loops": self.while_loops,
            "while_trips_assumed": self.while_trips_assumed,
            "intensity": round(self.intensity, 4),
            "lower_bound": self.lower_bound,
        }


@dataclasses.dataclass(frozen=True)
class _Pass:
    """One X pass at one lane: stored slots, bytes read, the random-access
    share of them, and what narrow storage saved."""

    nnz: float
    bytes: float
    gather: float
    narrowed: float


def _values(t: torch.Tensor, nnz: float) -> tuple:
    """(bytes read, bytes saved against f32) for ``nnz`` values of t's
    dtype."""
    size = t.element_size()
    return nnz * size, nnz * max(4 - size, 0)


def _x_passes(X) -> tuple:
    """(matvec pass, Xᵀr pass) of one device's matrix."""
    from photon_tpu_torch.data.matrix import BlockedEllRows, SparseRows
    from photon_tpu_torch.parallel.mesh import SlotRows

    if isinstance(X, SlotRows):
        X = X.parts[0]  # per-device view: one slot's share
    if isinstance(X, BlockedEllRows):
        n, h = X.dense.shape
        hot, hot_saved = _values(X.dense, float(n * h))

        def tail(vals) -> _Pass:
            slots = float(sum(v.numel() for v in vals))
            b, saved = (_values(vals[0], slots) if vals else (0.0, 0.0))
            idx = 4.0 * slots  # int32 column or row ids
            # each slot gathers one f32 of w (or r) at random
            return _Pass(float(n * h) + slots, hot + b + idx + 4.0 * slots,
                         4.0 * slots, hot_saved + saved)

        return tail(X.ell_vals), tail(X.bucket_vals)
    if isinstance(X, SparseRows):
        nnz = float(X.values.numel())
        b, saved = _values(X.values, nnz)
        p = _Pass(nnz, b + 4.0 * nnz + 4.0 * nnz, 4.0 * nnz, saved)
        return p, p
    nnz = float(X.numel())
    b, saved = _values(X, nnz)
    p = _Pass(nnz, b, 0.0, saved)
    return p, p


def _add_pass(cost: StaticCost, p: _Pass, G: int, n: int, d: int,
              times: float) -> None:
    """``times`` X passes at G lanes: 2·nnz·G FLOPs; X read once a pass,
    the (n, G) or (d, G) operand and result once each."""
    cost.flops += times * 2.0 * p.nnz * G
    cost.dot_flops += times * 2.0 * p.nnz * G
    cost.bytes += times * (p.bytes + 4.0 * G * (n + d))
    cost.gather_bytes += times * p.gather * G
    cost.narrowed_bytes += times * p.narrowed


_COST_CACHE: dict = {}


def lane_grid_cost(batch, task, config, G: int, mesh=None) -> StaticCost:
    """The modeled cost of one ``G``-lane `train_glm_grid` solve of
    ``batch`` under ``config`` (at its ``max_iters``), cached per
    (shapes, G, config, task, mesh slots). Nothing runs on the device."""
    from photon_tpu_torch.models.training import _matrix_dim
    from photon_tpu_torch.optim.config import OptimizerType
    from photon_tpu_torch.telemetry.run import signature

    n_slots = 1 if mesh is None else int(mesh.n_slots)
    key = (signature(batch.X), int(batch.n), int(G), repr(config),
           str(task), n_slots)
    hit = _COST_CACHE.get(key)
    if hit is not None:
        return hit
    d = _matrix_dim(batch.X)
    n = -(-int(batch.n) // n_slots)  # one slot's rows
    iters = int(config.max_iters)
    fwd, bwd = _x_passes(batch.X)
    opt = config.effective_optimizer()
    cost = StaticCost(while_loops=1, while_trips_assumed=max(iters, 1))
    # the start: the margin and the gradient
    _add_pass(cost, fwd, G, n, d, 1.0)
    _add_pass(cost, bwd, G, n, d, 1.0)
    cost.flops += EVAL_OPS * n * G
    if opt is OptimizerType.OWLQN:
        trials = OWLQN_TRIALS
        _add_pass(cost, fwd, G, n, d, iters * trials)  # a margin a trial
        _add_pass(cost, bwd, G, n, d, float(iters))
        evals_per_iter = trials
    elif opt is OptimizerType.TRON:
        cg = int(config.cg_max_iters)
        trials = 1
        _add_pass(cost, fwd, G, n, d, iters * (cg + 1.0))
        _add_pass(cost, bwd, G, n, d, iters * (cg + 1.0))
        evals_per_iter = cg + 1
    else:
        trials = LBFGS_TRIALS
        _add_pass(cost, fwd, G, n, d, float(iters))
        _add_pass(cost, bwd, G, n, d, float(iters))
        evals_per_iter = 1
    # the line search's trials, elementwise over (n, G): z, dz, y, weights
    cost.flops += iters * trials * TRIAL_OPS * n * G
    cost.transcendentals += iters * trials * 2.0 * n * G
    cost.bytes += iters * trials * 4.0 * (3.0 * n * G + n)
    # the per-lane vector work: the two-loop recursion reads the (m, d, G)
    # history twice with a dot and an axpy a slot
    m = int(config.history)
    cost.flops += iters * (4.0 * m + VECTOR_OPS) * d * G
    cost.bytes += iters * (2.0 * m + VECTOR_OPS) * 4.0 * d * G
    if mesh is not None:
        # one reduction an evaluation: the (d, G) gradient, and each
        # trial's f and slope scalars
        cost.collective_bytes = (
            (iters * evals_per_iter + 1.0) * 4.0 * d * G
            + iters * trials * 2.0 * 4.0 * G)
    _COST_CACHE[key] = cost
    return cost


def _rows_of(X) -> int:
    """One device's rows of a chunk matrix (a mesh slot's share)."""
    from photon_tpu_torch.data.matrix import BlockedEllRows, SparseRows
    from photon_tpu_torch.parallel.mesh import SlotRows

    if isinstance(X, SlotRows):
        X = X.parts[0]
    if isinstance(X, BlockedEllRows):
        return int(X.dense.shape[0])
    if isinstance(X, SparseRows):
        return int(X.values.shape[0])
    return int(X.shape[0])


def chunk_cost(program: str, X=None, *, rows=None, lanes: int = 1
               ) -> StaticCost:
    """The modeled cost of ONE call of streamed chunk program ``program``
    (one of `CHUNK_PROGRAMS`) on chunk matrix ``X`` (dense, `SparseRows`,
    `BlockedEllRows`, or a mesh chunk: one slot's share): its X passes
    priced as `lane_grid_cost` prices them, plus its elementwise kernels
    over the chunk's rows. ``chunk_phi`` reads no features: give its
    ``rows`` instead of ``X``. ``lanes``: the ladder's candidates of
    ``chunk_value_many``. Nothing runs on the device."""
    from photon_tpu_torch.models.training import _matrix_dim

    if program not in CHUNK_PROGRAMS:
        raise ValueError(f"unknown chunk program {program!r}; one of "
                         f"{CHUNK_PROGRAMS}")
    n = int(rows) if rows is not None else _rows_of(X)
    cost = StaticCost()

    def elementwise(ops: int, trans: int, G: int = 1) -> None:
        cost.flops += ops * n * G
        cost.transcendentals += trans * n * G
        cost.bytes += ops * ELEM_BYTES * n * G
        cost.eqns += ops

    if program == "chunk_phi":
        elementwise(PHI_OPS, PHI_TRANS)
        return cost
    d = _matrix_dim(X)
    fwd, bwd = _x_passes(X)
    if program == "chunk_init":  # the margin, then the partials at it
        _add_pass(cost, fwd, 1, n, d, 1.0)
        _add_pass(cost, bwd, 1, n, d, 1.0)
        elementwise(MARGIN_OPS + PARTIALS_OPS, PARTIALS_TRANS)
        cost.eqns += 2
    elif program == "chunk_grad":  # the partials at a cached margin
        _add_pass(cost, bwd, 1, n, d, 1.0)
        elementwise(PARTIALS_OPS, PARTIALS_TRANS)
        cost.eqns += 1
    elif program == "chunk_dz_phi":  # dz = X·p, then a φ trial on it
        _add_pass(cost, fwd, 1, n, d, 1.0)
        elementwise(PHI_OPS, PHI_TRANS)
        cost.eqns += 1
    else:  # chunk_value_many: one pass at `lanes` lanes, the loss a lane
        _add_pass(cost, fwd, int(lanes), n, d, 1.0)
        elementwise(LANE_VALUE_OPS, LANE_VALUE_TRANS, int(lanes))
        cost.eqns += 1
    return cost
