"""Lane-batched, budget-aware hyperparameter tuner (port of
`photon_tpu/tuning/lane_tuner.py`): GP proposal batches dispatched as
lock-step regularization LANES, with asynchronous successive halving and
a modeled-cost budget checked before each round.

- **Fixed pow2 lane chunks** (`TUNER_LANES`): every proposal batch pads
  to the same chunk by repeating its last proposal (a duplicate lane
  converges with its original; its result is discarded), so the dispatch
  signature never depends on how many configs a round proposed.
  `_SIG_LOG` records every dispatch: a tune makes exactly two signatures
  per problem shape, the screen and the survivor re-solve
  (`LaneTuningResult.assert_no_retrace`), and a blocked-ELL batch keeps
  its one kernel plan (`kernels.blocked_ell.plan_builds`).
- **Successive halving**: each round SCREENS its chunk at a capped
  iteration budget (`LaneBudget.screen_iters`) through one
  `models.training.train_glm_grid(device_results=True)`, scores every
  lane in one validation pass (`models.glm.score_models`'s lane pass),
  compacts the top ``survivor_frac`` lanes with
  `parallel.mesh.compact_rows(pad_mode="edge")` into a fixed smaller chunk
  and re-solves only those to full depth, warm-started from their
  screened coefficients (the per-lane (G, d) ``w0`` of `train_glm_grid`).
- **Cost-aware acquisition**: each round's lane program is priced before
  dispatch (`profiling.model.lane_grid_cost`, from the layout's own
  structure); the per-proposal price feeds `qei_greedy(costs=...)`, and
  the round must fit the budget: zero collective bytes off the mesh and
  FLOPs within ``cost_factor`` × the lane roofline (`RoundBudgetError`
  otherwise).

The GP fits on the training batch's device (the mesh's home with
``mesh``). With a `profiling` ledger armed, the screen and the re-solve
are its dispatches (``tuning.lane_screen``, ``tuning.lane_resolve``),
each priced by `lane_grid_cost`. The signature log and `_enforce_budget`
hold the tuner's two laws at run time; the two contracts at the bottom
of this module (``tuning_lane_dispatch``, ``tuning_round_budget``) pin
them in `python -m photon_tpu_torch.analysis`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_tpu_torch import profiling, telemetry
from photon_tpu_torch.data.matrix import SparseRows, next_pow2
from photon_tpu_torch.parallel.mesh import compact_rows
from photon_tpu_torch.profiling.model import StaticCost, lane_grid_cost
from photon_tpu_torch.telemetry.run import SignatureLog, float_drift
from photon_tpu_torch.tuning.acquisition import qei_greedy
from photon_tpu_torch.tuning.gp import fit_gp
from photon_tpu_torch.tuning.search import (SearchRange, SearchSpace,
                                            candidates)
from photon_tpu_torch.tuning.tuner import batch_device

# Fixed lane-chunk default: every proposal batch pads to this many lanes,
# so the screen's signature depends only on (batch shape, config).
TUNER_LANES = 64

# The tuner's live signature log (the continual/refresh.py pattern).
_SIG_LOG = SignatureLog()
_SIG_SCREEN = "tuning.lane_screen"
_SIG_RESOLVE = "tuning.lane_resolve"


class RoundBudgetError(RuntimeError):
    """A proposed round's MODELED cost exceeds the configured budget —
    raised BEFORE dispatch, so a misconfigured sweep fails in
    milliseconds, not after burning the round's compute."""


@dataclasses.dataclass(frozen=True)
class LaneBudget:
    """Per-round compute budget for the halving tuner.

    ``screen_iters``: the cap on the screening solve (None →
    max(4, config.max_iters // 8)). ``survivor_frac``: fraction of the
    chunk re-solved to full depth. ``cost_factor``: ceiling on modeled
    round FLOPs as a multiple of the lane roofline (4·n·d·G an iteration,
    the two X passes of a margin-cached lane step); ``max_round_flops``
    is an absolute override. Collective bytes must be 0 off the mesh."""

    screen_iters: Optional[int] = None
    survivor_frac: float = 0.25
    cost_factor: float = 16.0
    max_round_flops: Optional[float] = None


@dataclasses.dataclass
class RoundStats:
    """One halving round's accounting: what was proposed, what survived,
    and what the dispatch was modeled to cost."""

    n_proposed: int
    n_survivors: int
    screen_iters: int
    modeled_flops: float
    modeled_bytes: float
    modeled_collective_bytes: float
    flops_per_config: float
    best_screen_y: float
    best_full_y: float


@dataclasses.dataclass
class LaneTuningResult:
    """Tuning outcome + per-round accounting. ``ys`` are the SCREEN-
    fidelity metrics of every proposed config (what the GP models);
    ``best_y`` is the winning survivor's FULL-depth validation metric
    (minimized convention: higher-is-better metrics arrive negated)."""

    best_x: np.ndarray
    best_y: float
    xs: np.ndarray  # (n_configs, 1) original-space reg weights
    ys: np.ndarray  # (n_configs,) screen-fidelity metrics
    rounds: list

    def history(self) -> np.ndarray:
        """Running best screen metric after each evaluation."""
        return np.minimum.accumulate(self.ys)

    @staticmethod
    def signatures() -> dict:
        """Distinct lane-dispatch signatures seen process-wide, by program
        (one screen and one re-solve per (shapes, config), not per
        round)."""
        return {name: _SIG_LOG.signatures(name)
                for name in (_SIG_SCREEN, _SIG_RESOLVE)}

    @staticmethod
    def signature_count() -> int:
        return sum(len(v) for v in LaneTuningResult.signatures().values())

    @staticmethod
    def assert_no_retrace(baseline: int) -> int:
        """Prove the rounds added no dispatch signatures over ``baseline``
        (the count after the warming round) and that no floating argument
        drifted off f32 (the counterpart of the reference's weak-type
        check). Returns the current count."""
        count = LaneTuningResult.signature_count()
        if count > baseline:
            raise AssertionError(
                f"{count} tuner dispatch signatures exceed the warmed "
                f"baseline of {baseline}: the lane tuner took new shapes")
        # a dispatch records (X, its floating arguments): X keeps the
        # storage dtype its layout was cast to (bf16 values), the rest
        # must stay f32
        drift = sorted({d for sigs in LaneTuningResult.signatures().values()
                        for s in sigs for d in float_drift(s[2])})
        if drift:
            raise AssertionError(
                f"dtype drift in tuner dispatch arguments: {drift}")
        return count


def pad_proposals(weights, chunk: int) -> list:
    """Pad a round's proposal weights to the fixed lane chunk by
    REPEATING the last proposal (a duplicate lane costs nothing extra in
    lock-step; its result is discarded by index)."""
    weights = [float(w) for w in weights]
    if not weights:
        raise ValueError("a round needs at least one proposal")
    if len(weights) > chunk:
        raise ValueError(
            f"{len(weights)} proposals exceed the lane chunk {chunk}")
    return weights + [weights[-1]] * (chunk - len(weights))


def _enforce_budget(cost: StaticCost, batch, d: int, chunk: int,
                    iters: int, budget: LaneBudget, mesh) -> None:
    ideal = 4.0 * float(batch.n) * float(d) * float(chunk) * float(iters)
    limit = budget.cost_factor * max(ideal, 1.0)
    if budget.max_round_flops is not None:
        limit = min(limit, float(budget.max_round_flops))
    if cost.flops > limit:
        raise RoundBudgetError(
            f"modeled round cost {cost.flops:.3g} FLOPs exceeds the "
            f"budget {limit:.3g} (lane roofline {ideal:.3g} × factor "
            f"{budget.cost_factor}; max_round_flops="
            f"{budget.max_round_flops}); shrink the chunk/screen budget "
            "or raise LaneBudget.cost_factor")
    if mesh is None and cost.collective_bytes > 0:
        raise RoundBudgetError(
            f"single-device tuner round models {cost.collective_bytes} "
            "collective bytes; the lane program must be collective-free "
            "off-mesh")


def _dispatch_args(batch, *floats) -> tuple:
    """A dispatch as the signature log sees it: (X, its floating
    arguments), a `SparseRows` X by its arrays (its lazily built Xᵀr plan
    is not part of the program's shape)."""
    X = batch.X
    if isinstance(X, SparseRows):
        X = (X.indices, X.values, X.n_features)
    return (X, (batch.y, batch.weights, batch.offsets) + floats)


def _lane_scores(W, val_batch, evaluator, n_real: int) -> np.ndarray:
    """Validation metric per REAL lane, minimized convention: one lane
    pass over the validation X for every lane (`models.glm._score_many`),
    each lane's metric on the scores' device."""
    from photon_tpu_torch.models.glm import _score_many

    margins = _score_many(W, val_batch.X, val_batch.offsets)
    ys = np.empty((n_real,), np.float64)
    for i in range(n_real):
        s = float(evaluator.evaluate(margins[i], val_batch.y,
                                     val_batch.weights))
        ys[i] = -s if evaluator.higher_is_better else s
    return ys


def tune_glm_reg_lanes(
    train_batch,
    task,
    config,
    val_batch,
    n_configs: int = 256,
    lane_chunk: int = TUNER_LANES,
    reg_range: tuple = (1e-4, 1e4),
    evaluator=None,
    mesh=None,
    seed: int = 0,
    budget: Optional[LaneBudget] = None,
    kernel: str = "matern52",
    n_pool: int = 512,
):
    """Tune a GLM's regularization weight over ``n_configs`` candidates:
    GP proposal batches dispatch as lock-step lane chunks with capped
    screening, survivor compaction and warm-started full-depth re-solves
    (module docstring), on the training batch's device.

    Returns ``(best_model, best_reg_weight, LaneTuningResult)``, the
    contract of `tuning.tuner.tune_glm_reg`."""
    from photon_tpu_torch.evaluation.evaluator import default_evaluator
    from photon_tpu_torch.models import training as _training
    from photon_tpu_torch.models.glm import (Coefficients,
                                             GeneralizedLinearModel)

    if lane_chunk < 2 or (lane_chunk & (lane_chunk - 1)) != 0:
        raise ValueError(f"lane_chunk must be a pow2 >= 2, got {lane_chunk}")
    if n_configs < lane_chunk:
        raise ValueError(
            f"n_configs ({n_configs}) must cover at least one lane chunk "
            f"({lane_chunk})")
    dev = batch_device(train_batch, mesh)
    budget = budget if budget is not None else LaneBudget()
    evaluator = evaluator if evaluator is not None else default_evaluator(task)
    screen_iters = (budget.screen_iters if budget.screen_iters is not None
                    else max(4, int(config.max_iters) // 8))
    cfg_screen = dataclasses.replace(config, max_iters=screen_iters)
    k = max(1, int(round(lane_chunk * budget.survivor_frac)))
    s_chunk = min(lane_chunk, next_pow2(k, floor=2))
    space = SearchSpace([SearchRange(*reg_range, log_scale=True)])
    d = _training._matrix_dim(train_batch.X)
    val_batch = val_batch.to(dev)

    xs_unit: list = []
    screen_ys: list = []
    rounds: list = []
    best_y = np.inf
    best_weight = None
    best_coef = None

    n_rounds = -(-n_configs // lane_chunk)  # ceil
    done = 0
    for r in range(n_rounds):
        q = min(lane_chunk, n_configs - done)
        # ---- propose: a Sobol seed round, then GP + cost-aware q-EI
        if r == 0:
            units = list(candidates(space, q, "sobol", seed=seed))
        else:
            gp = fit_gp(np.asarray(xs_unit, np.float32),
                        np.asarray(screen_ys), kernel, device=dev)
            pool = candidates(space, n_pool, "sobol", seed=seed + 1000 + r)
            best_screen = float(np.min(screen_ys))
            price = rounds[-1].flops_per_config if rounds else 1.0
            idx = qei_greedy_costed(gp, pool.astype(np.float32),
                                    best_screen, q, seed=seed + 2000 + r,
                                    price=price)
            units = [pool[i] for i in idx]
        weights = [float(space.from_unit(u)[0]) for u in units]
        padded = pad_proposals(weights, lane_chunk)

        # ---- price and budget-check the round BEFORE dispatch
        cost = lane_grid_cost(train_batch, task, cfg_screen, lane_chunk,
                              mesh)
        _enforce_budget(cost, train_batch, d, lane_chunk, screen_iters,
                        budget, mesh)
        telemetry.gauge("tuning.round_model_flops", cost.flops)

        with telemetry.span("tuning.round", index=r, proposed=q,
                            chunk=lane_chunk):
            # ---- screen: a capped lock-step solve of the whole chunk
            screen_args = _dispatch_args(
                train_batch, torch.tensor(padded, dtype=torch.float32))
            _SIG_LOG.record(_SIG_SCREEN, screen_args)
            if profiling.needs_note(_SIG_SCREEN):
                profiling.note_program(_SIG_SCREEN, cost)
            with profiling.dispatch(_SIG_SCREEN, screen_args):
                res, _ = _training.train_glm_grid(
                    train_batch, task, cfg_screen, padded, mesh=mesh,
                    device_results=True, device=dev)
            ys = _lane_scores(res.w, val_batch, evaluator, q)
            xs_unit.extend(units)
            screen_ys.extend(ys.tolist())

            # ---- halve: the top-k survivors gathered on the device,
            # edge-padded to the fixed survivor chunk, re-solved to full
            # depth from their screened coefficients
            kk = min(k, q)
            survivors = np.argsort(ys, kind="stable")[:kk]
            idx_pad = np.concatenate(
                [survivors, np.full(s_chunk - kk, survivors[0], np.int64)])
            W0 = compact_rows(res.w, idx_pad, pad_mode="edge")
            sur_weights = [padded[i] for i in idx_pad]
            resolve_args = _dispatch_args(
                train_batch, W0, torch.tensor(sur_weights,
                                              dtype=torch.float32))
            _SIG_LOG.record(_SIG_RESOLVE, resolve_args)
            if profiling.needs_note(_SIG_RESOLVE):
                profiling.note_program(_SIG_RESOLVE, lane_grid_cost(
                    train_batch, task, config, s_chunk, mesh))
            with profiling.dispatch(_SIG_RESOLVE, resolve_args):
                res_full, _ = _training.train_glm_grid(
                    train_batch, task, config, sur_weights, mesh=mesh,
                    w0=W0, device_results=True, device=dev)
            full_ys = _lane_scores(res_full.w, val_batch, evaluator, kk)
            telemetry.count("tuning.rounds")
            telemetry.count("tuning.configs", q)
            telemetry.count("tuning.survivor_resolves", kk)

        j = int(np.argmin(full_ys))
        if full_ys[j] < best_y:
            best_y = float(full_ys[j])
            best_weight = sur_weights[j]
            best_coef = res_full.w[j].clone()
        rounds.append(RoundStats(
            n_proposed=q, n_survivors=kk, screen_iters=screen_iters,
            modeled_flops=cost.flops, modeled_bytes=cost.bytes,
            modeled_collective_bytes=cost.collective_bytes,
            flops_per_config=cost.flops / lane_chunk,
            best_screen_y=float(ys.min()), best_full_y=float(full_ys[j])))
        done += q

    xs_arr = np.asarray([space.from_unit(u) for u in xs_unit])
    model = GeneralizedLinearModel(Coefficients(best_coef, None), task)
    result = LaneTuningResult(
        best_x=np.asarray([best_weight]), best_y=best_y,
        xs=xs_arr, ys=np.asarray(screen_ys), rounds=rounds)
    return model, float(best_weight), result


def qei_greedy_costed(gp, pool, best_y: float, q: int, seed: int,
                      price: float):
    """The tuner's cost-aware pick: every pool candidate dispatches into
    the SAME lane program, so each is priced at the round's modeled FLOPs
    / chunk — uniform here (the plain greedy q-EI), routed through
    ``qei_greedy(costs=...)`` so spaces whose candidates imply different
    budgets pick by gain per FLOP with no tuner change."""
    costs = np.full(pool.shape[0], max(float(price), 1.0), np.float64)
    return qei_greedy(gp, pool, best_y, q, seed=seed, costs=costs)


# ----------------------------------------------------------------- contracts
# The tuner's two laws: a round's dispatch signature does not depend on
# how many configs it proposed (the fixed pow2 chunk), and a round fits
# its modeled budget before dispatch; both lane programs make no
# collective, their host syncs held to the lane search's pinned
# read-backs.
from photon_tpu_torch.analysis.contracts import register_contract  # noqa: E402


def _tuner_contract_problem(device, iters: int = 3, chunk: int = 8):
    from photon_tpu_torch.data.dataset import make_batch
    from photon_tpu_torch.models import training as _training
    from photon_tpu_torch.ops.losses import TaskType
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l2

    n, d = 32, 5
    rng = np.random.default_rng(0)
    cfg = OptimizerConfig(max_iters=iters, tolerance=1e-7, reg=l2(),
                          reg_weight=0.0, history=3,
                          regularize_intercept=True)
    batch = make_batch(rng.normal(size=(n, d)).astype(np.float32),
                       (rng.uniform(size=n) < 0.5).astype(np.float32),
                       device=device)
    weights = pad_proposals([0.1, 1.0], chunk)
    l2s, _, static_cfg = _training.lane_weight_arrays(cfg, weights)
    obj = _training.make_objective(TaskType.LOGISTIC_REGRESSION, cfg, d,
                                   device=device)
    return batch, obj, l2s.to(batch.y.device), static_cfg, cfg


@register_contract(
    name="tuning_lane_dispatch",
    description="the batched tuner's screen dispatch: proposal batches "
                "of DIFFERENT sizes pad to the fixed pow2 lane chunk, so "
                "every round carries one signature (builder raises on "
                "divergence), and the lock-step lane program is "
                "collective-free with no f64",
    # 3 iterations x 2 one-flag read-backs (optim/lane_lbfgs.py:253, :117;
    # ROADMAP speed item 1)
    collectives={}, max_syncs={"cuda": 6, "cpu": 6}, tags=("tuning", "lane"))
def _contract_tuning_lane_dispatch(device):
    from photon_tpu_torch.models.training import _lane_solve

    batch, obj, l2s, static_cfg, _ = _tuner_contract_problem(device)
    chunk = int(l2s.shape[0])
    log = SignatureLog()
    for q in (3, 7):
        padded = pad_proposals([0.1] * q, chunk)
        log.record("screen", _dispatch_args(
            batch, torch.tensor(padded, dtype=torch.float32)))
    if len(log.signatures("screen")) != 1:
        raise AssertionError(
            f"tuner dispatch signatures diverged across proposal counts: "
            f"{log.signatures('screen')}")
    d = int(batch.X.shape[1])

    def fn(b, W, o, l2v):
        return _lane_solve(o, b, W, l2v, None, static_cfg)

    return fn, (batch, torch.zeros(d, chunk, device=batch.y.device), obj,
                l2s)


@register_contract(
    name="tuning_round_budget",
    description="a tuner round fits its modeled budget BEFORE dispatch: "
                "the builder prices the screen with lane_grid_cost and "
                "raises unless collective bytes are zero and FLOPs sit "
                "within LaneBudget.cost_factor of the lane roofline; the "
                "program run is the halving tail — the compact_rows "
                "survivor gather + the warm-started full-depth re-solve "
                "from per-lane starts — equally collective-free",
    # 3 iterations x 2 one-flag read-backs (optim/lane_lbfgs.py:253, :117;
    # ROADMAP speed item 1)
    collectives={}, max_syncs={"cuda": 6, "cpu": 6}, tags=("tuning", "lane"))
def _contract_tuning_round_budget(device):
    from photon_tpu_torch.models.training import _lane_solve
    from photon_tpu_torch.ops.losses import TaskType

    batch, obj, l2s, static_cfg, cfg = _tuner_contract_problem(device)
    chunk = int(l2s.shape[0])
    d = int(batch.X.shape[1])
    iters = int(static_cfg.max_iters)
    cost = lane_grid_cost(batch, TaskType.LOGISTIC_REGRESSION, static_cfg,
                          chunk)
    _enforce_budget(cost, batch, d, chunk, iters, LaneBudget(), mesh=None)
    s_chunk = 4
    dev = batch.y.device

    def tail(w_lanes, b, o, l2_sur, idx):
        W0 = compact_rows(w_lanes, idx, pad_rows=s_chunk,
                          pad_mode="edge").t().contiguous()
        return _lane_solve(o, b, W0, l2_sur, None, static_cfg)

    rng = np.random.default_rng(1)
    w_lanes = torch.from_numpy(
        0.1 * rng.normal(size=(chunk, d)).astype(np.float32)).to(dev)
    return tail, (w_lanes, batch, obj, l2s[:s_chunk].contiguous(),
                  torch.tensor([1, 5, 2], dtype=torch.long, device=dev))
