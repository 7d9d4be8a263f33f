"""Random-effect coordinate: per-entity solves over bucketed blocks, the
entities of a bucket as the lanes of one lock-step solve (port of
`photon_tpu/game/random_effect.py`: `align_entity_priors`, `RETrainStats`
and `RandomEffectCoordinate.train`/`score`).

Reference parity: com.linkedin.photon.ml.algorithm.RandomEffectCoordinate
trains one solver per entity. The reference `vmap`s its scalar solver
over a bucket's entities; the port runs the lane solvers of the
regularization grid (`optim.lane_lbfgs`, `lane_owlqn`, `lane_tron`) with
lanes = entities: the bucket's `data.matrix.EntityBlocks` gives each lane
its own rows, (m, E) labels, weights and offsets, and per-lane priors.
As under `vmap`, a finished lane freezes while the others run on and
keeps its own iteration count, so an entity's result does not depend on
which entities share its solve.

A bucket solves in chunks of entities (`lane_chunk`), each chunk one
lock-step solve; a chunk's (m, E) tensors stay under `LANE_ELEMS`
elements (so its solver state stays a few GB at most on the card).

The block loop is the reference's pipelined dispatch/retire ledger:
`dispatch` gathers a bucket's warm starts and priors and runs its lane
solves; `retire` reads the results back, runs the straggler pass,
scatters into the coefficient table and reports progress. Dispatch runs
ahead of retire by up to ``pipeline_depth`` buckets (the
``game_re.blocks_in_flight`` gauge). Buckets partition the entity set, so
dispatch(k+1)'s gathers never read rows retire(k) writes, and every depth
gives the same bits. The reference's dispatch returns before the device
finishes; a lane solve here reads back once per lane iteration, so what a
depth of 1 or more overlaps is bucket k+1's device gathers and uploads
with retire(k)'s host work (and the retire's read-back finds the results
already landed), not the solves themselves.

Elastic runs: retire order equals dispatch order, so "buckets 0..k
retired" is a consistent cut. Under a `checkpoint` session each retire
(after its ``bucket_retire`` fault site) reports the coefficient table in
solve space, the per-entity iterations and convergence, the counts and
the retire cursor; a resumed `train` skips the retired prefix and
re-dispatches the rest (``checkpoint.re_restores``).

``straggler_budget`` caps the first pass of every chunk at that many
iterations; the lanes of a bucket that neither converged nor failed then
gather with `EntityBlocks.take` into one block that runs, warm-started
from the capped pass, to the config's ``max_iters`` (iterations add per
entity; the second pass restarts the L-BFGS curvature history, so
iteration counts change, not the optimum).

A regularization grid over the GAME model (`game.grid`) solves a bucket
with G lanes per entity (`solve_block_grid`): lanes = (entity × grid
point), each entity's rows shared by its G lanes.

On a mesh (``mesh``, a `parallel.mesh.Mesh` of S slots) a bucket's E
lanes pad with weight-0 lanes to ``pad_to_multiple(E, S)`` and slot j
owns the contiguous lanes ``[j·c, (j+1)·c)``, c = that count / S
(reference: `dispatch_chunked` over `data_sharding`). Dispatch gathers
each LOCAL slot's lanes from the bucket (`take_lanes`) onto the slot's
device and runs their solves there, in chunks of `lane_chunk(m, c)`: the
same work on the same lanes at every process count. Retire gathers every
process's packed results (w, variances, convergence, failure and
iterations per lane) in slot order — one `all_gather` per bucket, the
only collective the update adds — and drops the padding lanes, so every
process holds the whole table and counts real lanes only. The straggler
pass re-pads its lanes to a slot multiple the same way. Slots' lanes are
never merged into one solve: that would tie an entity's bits to the
process count.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from photon_tpu_torch import checkpoint as _ckpt
from photon_tpu_torch import telemetry
from photon_tpu_torch.data.dataset import GLMBatch
from photon_tpu_torch.game.dataset import RandomEffectDataset, REBlock
from photon_tpu_torch.game.model import RandomEffectModel
from photon_tpu_torch.models.training import (_lane_result, _lane_solve,
                                              lane_weight_arrays,
                                              make_objective)
from photon_tpu_torch.models.variance import (VarianceComputationType,
                                              compute_variances_lanes)
from photon_tpu_torch.ops.losses import TaskType
from photon_tpu_torch.optim.config import OptimizerConfig
from photon_tpu_torch.optim.tracker import OptResult
from photon_tpu_torch.parallel.mesh import (check_mesh, compact_rows,
                                            gather_processes, pad_to_multiple)

# The largest (m, E) lane tensor of one chunk solve, in elements: 2^24 f32
# is 64 MB, and a lane L-BFGS keeps about a dozen such tensors plus its
# (history, d, E) pairs, so a chunk stays within a few GB of the card's
# 80 GB. Below it a whole bucket is one solve: every lock-step iteration
# costs the same host-side launches whatever E is, so fewer chunks mean
# fewer iterations' host work.
LANE_ELEMS = 1 << 24


def lane_chunk(m: int, e_real: int, lanes_per_entity: int = 1) -> int:
    """Entities per lock-step solve for a bucket of height ``m`` whose
    entities take ``lanes_per_entity`` lanes each (a grid's G: the chunk
    shrinks by G, as the reference's ``cap // G``)."""
    return max(1, min(e_real, LANE_ELEMS // max(m * lanes_per_entity, 1)))


def _lanes(a, dev) -> torch.Tensor:
    """(E, p) host rows → their (p, E) lane tensor on ``dev``."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).T)).to(dev)


def take_lanes(batch: GLMBatch, idx, pad_lanes: Optional[int] = None
               ) -> GLMBatch:
    """The entities ``idx`` of a lane-minor bucket batch as a batch of
    ``pad_lanes`` lanes (zero lanes after them: weight 0, so no solve sees
    their rows): X by `EntityBlocks.take`, the (m, E) label, weight and
    offset columns by `compact_rows` on their entity-major views."""
    y, w, o = compact_rows((batch.y.t(), batch.weights.t(),
                            batch.offsets.t()), idx, pad_rows=pad_lanes)
    return GLMBatch(batch.X.take(idx, pad_lanes), y.t().contiguous(),
                    w.t().contiguous(), o.t().contiguous())


def _objective_on(obj, dev):
    """``obj`` with every tensor field on ``dev`` (itself when there)."""
    moved = {f.name: getattr(obj, f.name).to(dev)
             for f in dataclasses.fields(obj)
             if isinstance(getattr(obj, f.name), torch.Tensor)
             and getattr(obj, f.name).device != dev}
    return dataclasses.replace(obj, **moved) if moved else obj


def _pack_lanes(w, var, conv, fail, its, home) -> torch.Tensor:
    """One f32 row per lane on ``home``, the form a slot's results travel
    in: lane-major w (lanes, p), the variances when computed, then
    converged, failed and iterations (exact in f32)."""
    n = int(w.shape[0])
    parts = [w] + ([] if var is None else [var])
    parts += [t.reshape(n, 1) for t in (conv, fail, its)]
    return torch.cat([t.to(home, torch.float32) for t in parts], dim=1)


def solve_slots(mesh, E: int, solve_share) -> torch.Tensor:
    """Dispatch ``E`` lanes over the slots of ``mesh``: they pad to a
    slot multiple and slot j owns the c = ⌈E / S⌉ lanes [j·c, (j+1)·c).
    ``solve_share(idx, c, dev)`` solves one LOCAL slot's real lanes
    ``idx`` (a long tensor, padded to c lanes) on its device and returns
    lane-major (w, variances or None, converged, failed, iterations).
    Returns this process's results packed by `_pack_lanes`, (n_local·c·k,
    K) on the home device, in slot order."""
    c = pad_to_multiple(max(E, 1), mesh.n_slots) // mesh.n_slots
    packed = []
    for j, dev in zip(mesh.local_slots, mesh.slot_devices):
        idx = torch.arange(min(j * c, E), min((j + 1) * c, E),
                           dtype=torch.long)
        packed.append(_pack_lanes(*solve_share(idx, c, dev), mesh.home))
    telemetry.count("game_re.slot_solves", len(packed))
    return torch.cat(packed)


def gather_slots(mesh, local: torch.Tensor, n: int, p: int) -> tuple:
    """Retire on a mesh: every process's `solve_slots` results in slot
    order (one gather), the padding lanes past ``n`` dropped — lane-major
    (w (n, p), variances (n, p) or None, converged, failed, iterations
    (n,) int64) on the home device."""
    rows = gather_processes(mesh, local).reshape(-1, int(local.shape[1]))
    rows = rows[:n]
    var = rows[:, p:2 * p] if rows.shape[1] == 2 * p + 3 else None
    return (rows[:, :p], var, rows[:, -3] != 0, rows[:, -2] != 0,
            rows[:, -1].to(torch.int64))


def _lockstep(iters: np.ndarray, step: int, lanes: bool = True) -> int:
    """Lock-step cost of solving ``iters`` (per-lane iteration counts) in
    chunks of ``step`` lanes: Σ over chunks of its slowest lane's count,
    times the chunk's width when ``lanes``."""
    total = 0
    for lo in range(0, iters.shape[0], step):
        part = iters[lo:lo + step]
        total += int(part.max(initial=0)) * (part.shape[0] if lanes else 1)
    return total


def align_entity_priors(prior: RandomEffectModel, entity_keys, d: int):
    """A previous run's `RandomEffectModel` → per-entity Gaussian-prior
    blocks ``(means (E, d), precisions (E, d))`` (host numpy) aligned by
    entity KEY to ``entity_keys``. Entities unseen in the prior get
    precision 0 (no prior); with variances the precision is
    `PriorDistribution.from_variances`' diagonal (variance ≤ 0: no prior
    there); without, every seen entity gets unit precision."""
    from photon_tpu_torch.optim.prior import PriorDistribution

    entity_keys = np.asarray(entity_keys)
    E = int(entity_keys.shape[0])
    pid = prior.dense_ids(entity_keys)  # (E,) rows in the prior
    seen = (pid < prior.n_entities).astype(np.float32)[:, None]
    prior_means = prior.coeffs_for(pid).cpu().numpy().astype(np.float32)
    if prior.variances is not None:
        pvar = np.concatenate(
            [prior.variances.cpu().numpy().astype(np.float32),
             np.ones((1, d), np.float32)])[pid]
        dist = PriorDistribution.from_variances(prior_means, pvar)
        prior_precs = (seen * dist.precision_diag).astype(np.float32)
    else:
        prior_precs = seen * np.ones((E, d), np.float32)
    return prior_means, prior_precs


@dataclasses.dataclass
class _InFlight:
    """One dispatched bucket awaiting retire: its solve-space priors (the
    straggler pass re-uses them) and the lane solve's device results."""

    block: REBlock
    pm: Optional[np.ndarray]
    pp: Optional[np.ndarray]
    res: Optional[OptResult]
    var: Optional[torch.Tensor]
    # on a mesh: this process's slots' packed results (`_solve_slots`)
    local: Optional[torch.Tensor] = None


@dataclasses.dataclass
class RETrainStats:
    """Per-train diagnostics (reference: per-entity OptimizationTracker)."""

    n_entities: int
    n_converged: int
    n_failed: int
    total_iterations: int
    # (E,) solver iterations per dense entity id
    iterations_per_entity: Optional[np.ndarray] = dataclasses.field(
        default=None, compare=False, repr=False)
    # (E,) whether each dense entity's solve converged
    converged_per_entity: Optional[np.ndarray] = dataclasses.field(
        default=None, compare=False, repr=False)


@dataclasses.dataclass(eq=False)
class RandomEffectCoordinate:
    """Reference: algorithm.RandomEffectCoordinate."""

    dataset: RandomEffectDataset
    task: TaskType
    config: OptimizerConfig
    mesh: Optional[object] = None
    variance: VarianceComputationType = VarianceComputationType.NONE
    # shard-level NormalizationContext shared by every entity's solve: the
    # lanes run in normalized space, coefficients convert back per row
    normalization: Optional[object] = None
    pipeline_depth: int = 1
    straggler_budget: Optional[int] = None

    def __post_init__(self):
        ds = self.dataset
        check_mesh(self.mesh)
        if int(self.pipeline_depth) < 0:
            raise ValueError("pipeline_depth must be >= 0")
        if ds.projection is not None:
            if (self.normalization is not None
                    and not self.normalization.is_identity):
                raise ValueError(
                    "feature-space projection and normalization cannot be "
                    "combined on a random-effect coordinate; normalize the "
                    "shard before building the dataset instead")
            if (ds.projector is not None
                    and self.variance is not VarianceComputationType.NONE):
                raise ValueError(
                    "coefficient variances are not defined through a "
                    "RANDOM projection; use INDEX_MAP projection or no "
                    "projection")

    def _effective_budget(self) -> Optional[int]:
        """The first-pass iteration cap, or None when the straggler
        re-solve is off (unset, non-positive, or no smaller than
        max_iters)."""
        b = self.straggler_budget
        if b is None or b <= 0 or b >= self.config.max_iters:
            return None
        return int(b)

    def _norm(self):
        n = self.normalization
        return n if n is not None and not n.is_identity else None

    def solve_block(self, block: REBlock, offsets_full, w0=None,
                    prior_means=None, prior_precs=None,
                    max_iters: Optional[int] = None):
        """Every entity of one bucket as the lanes of lock-step solves, in
        chunks of `lane_chunk` entities, in the bucket's solve space
        (projected, normalized). ``offsets_full``: the (n,) per-row
        offsets on the device; ``w0`` / ``prior_means`` / ``prior_precs``:
        (E, p) host arrays (default: zeros, no prior); ``max_iters``: a cap
        below the config's (the straggler first pass). Returns the
        lane-MAJOR `OptResult` (w (E, p), per-entity scalars (E,),
        histories (E, T + 1)) and the (E, p) variances (None for NONE), on
        the device."""
        batch = self.dataset.block_batch(block, offsets_full)
        dev = block.y.device
        obj = self.block_objective(block)
        E = block.n_entities
        if w0 is None:
            w0 = np.zeros((E, self._block_dim(block)), np.float32)
        pm = pp = None
        if prior_means is not None:
            pm, pp = _lanes(prior_means, dev), _lanes(prior_precs, dev)
        return self.solve_lanes(obj, batch, _lanes(w0, dev), pm, pp,
                                max_iters=max_iters)

    def _block_dim(self, block: REBlock) -> int:
        return block.dim if block.dim is not None else self.dataset.dim

    def block_objective(self, block: REBlock):
        """The objective of one bucket's solves, in its solve space."""
        norm = self._norm() if self.dataset.projection is None else None
        return make_objective(self.task, self.config, self._block_dim(block),
                              normalization=norm, device=block.y.device)

    # ------------------------------------------------- lanes over slots
    def _solve_slots(self, obj, batch: GLMBatch, W0: torch.Tensor,
                     prior_means=None, prior_precs=None,
                     max_iters: Optional[int] = None) -> torch.Tensor:
        """Dispatch on a mesh (`solve_slots`): the E lanes of a lane-minor
        ``batch`` (with (p, E) starts and priors), each LOCAL slot's c
        lanes (zero lanes past E) taken onto its device and solved there
        by `solve_lanes`."""
        def share(idx, c, dev):
            def cols(t):  # (p, E) lane columns -> (p, c) on dev
                return compact_rows(t.t(), idx, pad_rows=c).t() \
                    .contiguous().to(dev)

            sub = take_lanes(batch, idx, c)
            if sub.y.device != dev:
                sub = GLMBatch(sub.X.to(dev), *(t.to(dev) for t in sub[1:]))
            pm = pp = None
            if prior_means is not None:
                pm, pp = cols(prior_means), cols(prior_precs)
            res, var = self.solve_lanes(_objective_on(obj, dev), sub,
                                        cols(W0), pm, pp,
                                        max_iters=max_iters)
            return res.w, var, res.converged, res.failed, res.iterations

        return solve_slots(self.mesh, int(batch.y.shape[1]), share)

    def _gather_slots(self, local: torch.Tensor, E: int, p: int) -> tuple:
        """`gather_slots` of a bucket's E lanes as host arrays (w (E, p),
        converged, failed, iterations (E,) int64, variances or None)."""
        w, var, conv, fail, its = (
            None if t is None else t.cpu().numpy()
            for t in gather_slots(self.mesh, local, E, p))
        return (np.ascontiguousarray(w), conv, fail, its,
                None if var is None else np.ascontiguousarray(var))

    def solve_lanes_mesh(self, obj, batch: GLMBatch, W0: torch.Tensor,
                         prior_means=None, prior_precs=None,
                         max_iters: Optional[int] = None) -> tuple:
        """`solve_lanes` over the mesh's slots, dispatched and gathered at
        once (the straggler pass and the continual refresh): host (w,
        converged, failed, iterations, variances or None) of the E real
        lanes."""
        local = self._solve_slots(obj, batch, W0, prior_means, prior_precs,
                                  max_iters)
        return self._gather_slots(local, int(batch.y.shape[1]),
                                  int(W0.shape[0]))

    def solve_lanes(self, obj, batch: GLMBatch, W0: torch.Tensor,
                    prior_means: Optional[torch.Tensor] = None,
                    prior_precs: Optional[torch.Tensor] = None,
                    max_iters: Optional[int] = None):
        """The lane solves under `solve_block`: a lane-minor batch (X an
        `EntityBlocks` of E entities, (m, E) labels, weights and offsets)
        from the (p, E) starts ``W0`` and per-lane priors, in chunks of
        `lane_chunk(m, E)` lanes, each one lock-step solve. Returns the
        lane-MAJOR `OptResult` and the (E, p) variances (None for NONE)."""
        dev = W0.device
        l2, l1, cfg = lane_weight_arrays(self.config,
                                         [self.config.reg_weight])
        if max_iters is not None:
            cfg = dataclasses.replace(cfg, max_iters=int(max_iters))
        m, E = int(batch.y.shape[0]), int(batch.y.shape[1])
        step = lane_chunk(m, E)
        results, variances = [], []
        for lo in range(0, E, step):
            hi = min(E, lo + step)
            sub = batch._replace(
                X=batch.X.lanes(lo, hi),
                y=batch.y[:, lo:hi].contiguous(),
                weights=batch.weights[:, lo:hi].contiguous(),
                offsets=batch.offsets[:, lo:hi].contiguous())
            o = obj
            if prior_means is not None:
                o = dataclasses.replace(
                    obj, prior_mean=prior_means[:, lo:hi].contiguous(),
                    prior_precision=prior_precs[:, lo:hi].contiguous())
            G = hi - lo
            l2s = l2.to(dev).expand(G).contiguous()
            l1s = None if l1 is None else l1.to(dev).expand(G).contiguous()
            res = _lane_solve(o, sub, W0[:, lo:hi].contiguous(), l2s, l1s,
                              cfg)
            telemetry.count("game_re.lockstep_solves")
            var = compute_variances_lanes(o, l2s, res.w, sub, self.variance)
            results.append(_lane_result(res))
            variances.append(None if var is None else var.t())
        res = results[0]
        if len(results) > 1:
            res = OptResult(*(
                [torch.cat([getattr(r, f) for r in results])
                 for f in ("w", "value", "grad_norm", "iterations",
                           "converged", "failed", "loss_history",
                           "grad_norm_history")]
                + [sum(getattr(r, f) for r in results)
                   for f in ("evaluations", "hvps", "trials")]))
        var = (None if variances[0] is None
               else torch.cat(variances) if len(variances) > 1
               else variances[0])
        return res, var

    def _resolve_stragglers(self, block: REBlock, offsets_full, idx,
                            w_out, conv, fail, iters, var_h, pm, pp):
        """The second pass of a capped solve: the lanes ``idx`` of one
        bucket that neither converged nor failed, gathered with
        `EntityBlocks.take` (with their label, weight and offset columns
        and their priors) into one block, started from the capped pass's
        ``w_out`` and solved to the config's ``max_iters``. Iterations add
        per entity; ``w_out``, ``conv``, ``fail`` and ``var_h`` are
        overwritten in place (host arrays of the bucket's E entities).

        ``game_re.iters_saved`` counts lock-step lane-iterations: a chunk
        of width c whose slowest lane runs k iterations costs c·k (frozen
        lanes ride along). Uncapped, each first-pass chunk (`lane_chunk(m,
        E)` lanes) would run to its slowest lane's total; capped, it stops
        at its slowest capped lane and the tail's chunks (`lane_chunk(m,
        n)` lanes) pay their own:

            saved = Σ_c |c|·max_c(first + tail)
                    − Σ_c |c|·max_c(first) − Σ_t |t|·max_t(tail),

        clipped at 0 (the reference's formula, over the port's chunks
        rather than `_MAX_SOLVE_LANES`)."""
        ds = self.dataset
        dev = block.y.device
        n2 = int(idx.size)
        batch = take_lanes(ds.block_batch(block, offsets_full), idx)
        W0 = _lanes(w_out[idx], dev)
        pm2 = pp2 = None
        if pm is not None:
            pm2, pp2 = _lanes(pm[idx], dev), _lanes(pp[idx], dev)
        if self.mesh is not None:  # re-padded to a slot multiple
            w2, conv2, fail2, it2, var2 = self.solve_lanes_mesh(
                self.block_objective(block), batch, W0, pm2, pp2)
        else:
            res2, var2 = self.solve_lanes(self.block_objective(block),
                                          batch, W0, pm2, pp2)
            w2, conv2, fail2, it2 = (t.cpu().numpy() for t in (
                res2.w, res2.converged, res2.failed, res2.iterations))
            var2 = None if var2 is None else var2.cpu().numpy()
        it2 = it2.astype(np.int64)
        first = iters.copy()
        w_out[idx] = w2
        conv[idx] = conv2
        fail[idx] = fail2
        iters[idx] += it2
        if var_h is not None:
            var_h[idx] = var2
        step, step2 = self._chunk_of(block.m, first.shape[0]), \
            self._chunk_of(block.m, n2)
        full, capped = _lockstep(iters, step), _lockstep(first, step)
        tail = _lockstep(it2, step2)
        telemetry.count("game_re.straggler_entities", n2)
        telemetry.count("game_re.tail_resolves")
        telemetry.count("game_re.tail_lockstep_iters",
                        _lockstep(it2, step2, lanes=False))
        telemetry.count("game_re.iters_saved", max(full - capped - tail, 0))

    def _chunk_of(self, m: int, E: int) -> int:
        """Lanes per lock-step solve of an E-lane bucket: `lane_chunk` of
        the bucket, or on a mesh of one slot's share."""
        if self.mesh is not None:
            E = pad_to_multiple(max(E, 1), self.mesh.n_slots) \
                // self.mesh.n_slots
        return lane_chunk(m, E)

    def solve_block_grid(self, block: REBlock, offsets_lanes, W0, l2s,
                         l1s, config: OptimizerConfig):
        """A regularization grid's solve of one bucket (`game.grid`):
        every (entity × grid point) a lane, entity-major (lane e·G + g),
        in chunks of `lane_chunk` (m, E, G) entities, each chunk one
        lock-step solve whose lanes share their entity's rows
        (`EntityBlocks.grid`). ``offsets_lanes``: the (n, G) per-lane
        offsets; ``W0``: (d, E·G) lane-minor starts; ``l2s`` / ``l1s``:
        the (G,) lane weights (``l1s`` None off OWL-QN); ``config`` the
        weight-normalized one of `lane_weight_arrays`. Returns lane-minor
        (w (d, E·G), variances (d, E·G) or None, converged, failed,
        iterations (E·G,)) on the device."""
        ds = self.dataset
        dev = block.y.device
        obj = make_objective(self.task, self.config, ds.dim, device=dev)
        G = int(l2s.shape[0])
        E, m = block.n_entities, block.m
        X = block.lanes.grid(G)
        rows = block.row_index.t()  # (m, E)
        y, wts = block.y.t(), block.weights.t()
        step = lane_chunk(m, E, G)
        parts = []
        for lo in range(0, E, step):
            hi = min(E, lo + step)

            def per_lane(t):  # (m, e) entity columns -> (m, e·G) lanes
                return t[:, lo:hi, None].expand(m, hi - lo, G).reshape(m, -1)

            sub = GLMBatch(X.lanes(lo, hi), per_lane(y), per_lane(wts),
                           offsets_lanes[rows[:, lo:hi]].reshape(m, -1))
            l2 = l2s.repeat(hi - lo)
            l1 = None if l1s is None else l1s.repeat(hi - lo)
            res = _lane_solve(obj, sub, W0[:, lo * G:hi * G].contiguous(),
                              l2, l1, config)
            telemetry.count("game_re.lockstep_solves")
            var = compute_variances_lanes(obj, l2, res.w, sub, self.variance)
            parts.append((res.w, var, res.converged, res.failed,
                          res.iterations))
        if len(parts) == 1:
            return parts[0]
        w, var, conv, fail, its = zip(*parts)
        return (torch.cat(w, dim=1),
                None if var[0] is None else torch.cat(var, dim=1),
                torch.cat(conv), torch.cat(fail), torch.cat(its))

    def solve_block_grid_mesh(self, mesh, block: REBlock, offsets_lanes,
                              W0, l2s, l1s, config: OptimizerConfig):
        """`solve_block_grid` over the slots of ``mesh`` (`solve_slots`,
        `gather_slots`): the bucket's E entities pad to a slot multiple,
        each LOCAL slot's c entities (with their G lanes each) taken onto
        its device (`REBlock.take`) and solved there — the same lane-minor
        results as `solve_block_grid`, on the home device."""
        E, G = block.n_entities, int(l2s.shape[0])
        d = int(W0.shape[0])
        W0e = W0.reshape(d, E, G)

        def share(idx, c, dev):
            sub = block.take(idx.numpy(), c, dev)
            w0 = torch.zeros((d, c, G), dtype=W0.dtype, device=dev)
            w0[:, :idx.numel()] = W0e[:, idx].to(dev)
            w, var, conv, fail, its = self.solve_block_grid(
                sub, offsets_lanes.to(dev), w0.reshape(d, c * G),
                l2s.to(dev), None if l1s is None else l1s.to(dev), config)
            return w.t(), None if var is None else var.t(), conv, fail, its

        w, var, conv, fail, its = gather_slots(
            mesh, solve_slots(mesh, E, share), E * G, d)
        return (w.t().contiguous(),
                None if var is None else var.t().contiguous(),
                conv, fail, its)

    def train(self, offsets_full,
              warm_start: Optional[RandomEffectModel] = None,
              prior: Optional[RandomEffectModel] = None
              ) -> tuple[RandomEffectModel, RETrainStats]:
        """Solve every entity with the other coordinates' scores as
        offsets. ``warm_start``: a model whose coefficients start the
        solves. ``prior``: a previous run's model — each entity seen in it
        gets a Gaussian prior from its coefficients and variances, aligned
        by entity KEY (entities new to this dataset get none). With a
        ``straggler_budget`` below ``max_iters`` each bucket's first pass
        stops there and its unconverged lanes re-solve as one gathered
        block (`_resolve_stragglers`)."""
        ds = self.dataset
        E, d = ds.n_entities, ds.dim
        norm = self._norm()
        coeffs = np.zeros((E, d), np.float32)
        if (warm_start is not None
                and tuple(warm_start.coefficients.shape) == (E, d)):
            coeffs = warm_start.coefficients.cpu().numpy().astype(
                np.float32).copy()
        if norm is not None:  # the solve runs in normalized space
            coeffs = norm.rows_to_normalized_space(coeffs)
        if prior is not None and ds.projector is not None:
            raise ValueError(
                "per-entity priors cannot be projected through a RANDOM "
                "projection; use INDEX_MAP projection or no projection")
        prior_means = prior_precs = None
        if prior is not None and prior.dim == d:
            prior_means, prior_precs = align_entity_priors(
                prior, ds.entity_keys, d)
            if norm is not None:
                prior_means = norm.rows_to_normalized_space(prior_means)
                if norm.factors is not None:
                    f = np.asarray(norm.factors)
                    prior_precs = prior_precs * (f * f)[None, :]
        variances = (np.zeros((E, d), np.float32)
                     if self.variance is not VarianceComputationType.NONE
                     else None)
        n_conv = n_fail = 0
        iters_per_entity = np.zeros((E,), np.int64)
        conv_per_entity = np.zeros((E,), bool)
        if not isinstance(offsets_full, torch.Tensor):
            offsets_full = torch.from_numpy(
                np.asarray(offsets_full, np.float32))
        offsets_dev = offsets_full.to(ds.device, torch.float32)
        budget = self._effective_budget()

        # ---- checkpoint/restore: the retire cursor is the cut (the
        # module docstring); the snapshot is the coefficient table in
        # SOLVE space, the per-entity trackers and the cursor
        ck = _ckpt.current()
        st = ck.restore("re") if ck is not None else None
        n_blocks = len(ds.blocks)
        start_block = 0
        if st is not None:
            got = (st.get("kind"), int(st.get("E", -1)),
                   int(st.get("d", -1)), int(st.get("n_blocks", -1)),
                   bool(st.get("has_var", False)))
            want = ("re_train", E, d, n_blocks, variances is not None)
            if got != want:
                raise _ckpt.SnapshotStateError(
                    f"random-effect snapshot does not fit this coordinate:"
                    f" snapshot (kind, E, d, n_blocks, has_var)={got} vs "
                    f"resuming train() {want}")
            coeffs = np.array(st["coeffs"], np.float32)
            if variances is not None:
                variances = np.array(st["variances"], np.float32)
            iters_per_entity = np.array(st["iters"], np.int64)
            if "conv" in st:
                conv_per_entity = np.array(st["conv"], bool)
            n_conv, n_fail = int(st["n_conv"]), int(st["n_fail"])
            start_block = int(st["blocks_done"])
            telemetry.count("checkpoint.re_restores")
        retired = start_block

        def dispatch(block: REBlock) -> _InFlight:
            """Stage 1: the bucket's warm starts and priors, projected into
            its solve space, and its lane solves."""
            ents = block.entity_index
            w0_full = coeffs[ents]
            pm = pp = None
            if block.proj is not None:  # INDEX_MAP
                from photon_tpu_torch.game.projector import gather_rows

                w0 = gather_rows(w0_full, block.proj)
                if prior_means is not None:
                    pm = gather_rows(prior_means[ents], block.proj)
                    pp = gather_rows(prior_precs[ents], block.proj)
            elif ds.projector is not None:  # RANDOM
                w0 = ds.projector.project_coeffs(w0_full)
            else:
                w0 = w0_full
                if prior_means is not None:
                    pm, pp = prior_means[ents], prior_precs[ents]
            telemetry.count("game_re.blocks")
            if self.mesh is not None:
                dev = block.y.device
                local = self._solve_slots(
                    self.block_objective(block),
                    ds.block_batch(block, offsets_dev), _lanes(w0, dev),
                    None if pm is None else _lanes(pm, dev),
                    None if pp is None else _lanes(pp, dev), budget)
                return _InFlight(block, pm, pp, None, None, local)
            res, var = self.solve_block(block, offsets_dev, w0, pm, pp,
                                        max_iters=budget)
            return _InFlight(block, pm, pp, res, var)

        def retire(fl: _InFlight) -> None:
            """Stage 2: the OLDEST in-flight bucket's results to the host,
            its straggler pass, the scatter back, and the progress cut."""
            nonlocal n_conv, n_fail, retired
            # fault site: a preemption here loses this bucket's
            # unscattered results; a resume re-dispatches it
            _ckpt.kill_point("bucket_retire")
            block, ents = fl.block, fl.block.entity_index
            if fl.local is not None:  # the bucket's one gather, in order
                w_out, conv, fail, iters, var_h = self._gather_slots(
                    fl.local, block.n_entities, self._block_dim(block))
            else:
                w_out, conv, fail, iters = (np.array(t.cpu()) for t in (
                    fl.res.w, fl.res.converged, fl.res.failed,
                    fl.res.iterations))
                var_h = None if fl.var is None else np.array(fl.var.cpu())
            iters = iters.astype(np.int64)
            if budget is not None:
                telemetry.count("game_re.capped_lockstep_iters", _lockstep(
                    iters, self._chunk_of(block.m, iters.shape[0]),
                    lanes=False))
                strag = np.nonzero(~conv & ~fail)[0]
                if strag.size:
                    self._resolve_stragglers(block, offsets_dev, strag,
                                             w_out, conv, fail, iters, var_h,
                                             fl.pm, fl.pp)
            if block.proj is not None:
                from photon_tpu_torch.game.projector import scatter_rows_into

                scatter_rows_into(coeffs, w_out, ents, block.proj)
                if variances is not None:
                    scatter_rows_into(variances, var_h, ents, block.proj)
            elif ds.projector is not None:
                coeffs[ents] = ds.projector.back_project(w_out)
            else:
                coeffs[ents] = w_out
                if variances is not None:
                    variances[ents] = var_h
            n_conv += int(conv.sum())
            n_fail += int(fail.sum())
            iters_per_entity[ents] = iters
            conv_per_entity[ents] = conv
            retired += 1
            if ck is not None:
                payload = {
                    "kind": "re_train", "E": E, "d": d, "n_blocks": n_blocks,
                    "has_var": variances is not None, "coeffs": coeffs,
                    "iters": iters_per_entity, "conv": conv_per_entity,
                    "n_conv": n_conv, "n_fail": n_fail,
                    "blocks_done": retired}
                if variances is not None:
                    payload["variances"] = variances
                ck.update("re", payload)
                ck.note_evaluations()
                ck.maybe_snapshot()

        # the pipeline: dispatch runs ahead of retire by up to
        # `pipeline_depth` buckets; a resumed run skips the retired prefix
        pending: deque = deque()
        depth = int(self.pipeline_depth)
        for block in ds.blocks[start_block:]:
            pending.append(dispatch(block))
            telemetry.gauge("game_re.blocks_in_flight", len(pending))
            while len(pending) > depth:
                retire(pending.popleft())
        while pending:
            retire(pending.popleft())
        if ck is not None:
            ck.clear("re")
        if norm is not None:
            coeffs = norm.rows_to_original_space(coeffs)
            if variances is not None:
                variances = norm.variances_to_original_space(variances)
        model = RandomEffectModel(
            entity_name=ds.entity_name, feature_shard=ds.shard_name,
            task=self.task, coefficients=torch.from_numpy(
                np.ascontiguousarray(coeffs)).to(ds.device),
            entity_keys=ds.entity_keys, key_to_index=ds.key_to_index,
            variances=None if variances is None else torch.from_numpy(
                np.ascontiguousarray(variances)).to(ds.device))
        return model, RETrainStats(E, n_conv, n_fail,
                                   int(iters_per_entity.sum()),
                                   iters_per_entity, conv_per_entity)

    def score(self, model: RandomEffectModel) -> torch.Tensor:
        """Per-row margin for ALL rows, active and passive: one gather +
        rowwise dot."""
        return model.score(self.dataset.X, self.dataset.entity_dense)
