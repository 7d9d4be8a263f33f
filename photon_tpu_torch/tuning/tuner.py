"""Bayesian hyperparameter tuner loop (port of `photon_tpu/tuning/tuner.py`).

Reference parity: com.linkedin.photon.ml.HyperparameterTuner /
hyperparameter.search.{GaussianProcessSearch, RandomSearch} and the
EvaluationFunction protocol: evaluate(candidate) → metric, minimized. The
GAME driver plugs in "train a model with these reg weights, return the
validation loss or the negated AUC".

Loop: seed with Sobol points → fit the GP on every observation → draw a
fresh candidate pool → evaluate the EI argmax (or a q-EI batch) → repeat.
The GP fits on ``device`` (default ``cuda``); `tune_glm_reg` uses its
training batch's device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from photon_tpu_torch.tuning.acquisition import (expected_improvement,
                                                 qei_greedy)
from photon_tpu_torch.tuning.gp import fit_gp
from photon_tpu_torch.tuning.search import (SearchRange, SearchSpace,
                                            candidates)


@dataclasses.dataclass
class TuningResult:
    best_x: np.ndarray  # original-space hyperparameters
    best_y: float
    xs: np.ndarray  # (n, d) all evaluated points, original space
    ys: np.ndarray  # (n,)

    def history(self) -> np.ndarray:
        """Running best metric after each evaluation."""
        return np.minimum.accumulate(self.ys)


def tune(
    evaluate: Optional[Callable[[np.ndarray], float]],
    space: SearchSpace,
    n_iters: int = 20,
    n_seed: int = 5,
    n_candidates: int = 512,
    method: str = "gp",
    kernel: str = "matern52",
    seed: int = 0,
    initial_observations: Optional[Sequence[tuple]] = None,
    batch_size: int = 1,
    evaluate_batch: Optional[Callable[[np.ndarray], Sequence[float]]] = None,
    batch_method: str = "qei",
    device=None,
) -> TuningResult:
    """Minimize ``evaluate`` over ``space`` (reference:
    HyperparameterTuner.tune).

    method: "gp" (the reference's GaussianProcessSearch), "random" or
    "sobol" (its RandomSearch fallback). initial_observations: optional
    [(x_original, y)] that warm-start the GP. batch_size > 1 proposes
    that many candidates a GP round and hands them to ``evaluate_batch``
    together (one `train_glm_grid` for `tune_glm_reg`); without
    ``evaluate_batch`` they loop ``evaluate``. batch_method: "qei" picks
    each batch by greedy joint q-EI over shared posterior fantasies,
    "liar" by the constant-liar heuristic (each pick fantasized at the
    incumbent, the GP refitted between picks). The GP fits run on
    ``device`` (default ``cuda``).
    """
    if n_iters < 1:
        raise ValueError("n_iters must be >= 1")
    if batch_size < 1:
        raise ValueError("batch_size must be >= 1")
    if evaluate is None and evaluate_batch is None:
        raise ValueError("pass evaluate or evaluate_batch")
    if evaluate_batch is None:
        evaluate_batch = lambda X: [float(evaluate(x)) for x in X]  # noqa: E731
    xs_unit: list = []
    ys: list = []
    for x0, y0 in initial_observations or ():
        xs_unit.append(space.to_unit(np.asarray(x0, np.float64)))
        ys.append(float(y0))

    def run_batch(units) -> None:
        X = np.stack([space.from_unit(u) for u in units])
        for u, y in zip(units, evaluate_batch(X)):
            xs_unit.append(u)
            ys.append(float(y))

    if method in ("random", "sobol"):
        pool = candidates(space, n_iters,
                          "sobol" if method == "sobol" else "random",
                          seed=seed)
        for i in range(0, len(pool), batch_size):
            run_batch(list(pool[i:i + batch_size]))
    elif method == "gp":
        if batch_method not in ("qei", "liar"):
            raise ValueError(f"unknown batch_method {batch_method!r}")
        n_seed = min(max(n_seed, 2), n_iters)
        run_batch(list(candidates(space, n_seed, "sobol", seed=seed)))
        done, it = n_seed, 0
        while done < n_iters:
            # a round never picks more points than the pool holds
            q = min(batch_size, n_iters - done, n_candidates)
            pool = candidates(space, n_candidates, "sobol",
                              seed=seed + 1000 + it)
            best = float(np.min(ys))
            if q > 1 and batch_method == "liar":
                Xf, Yf = list(xs_unit), list(ys)
                picks: list = []
                for _ in range(q):
                    gp = fit_gp(np.asarray(Xf, np.float32), np.asarray(Yf),
                                kernel, device=device)
                    ei = expected_improvement(
                        gp, pool.astype(np.float32), best).cpu().numpy()
                    idx = int(np.argmax(ei))
                    picks.append(pool[idx])
                    Xf.append(pool[idx])
                    Yf.append(best)  # the lie: fantasize at the incumbent
                    pool = np.delete(pool, idx, axis=0)
            else:
                gp = fit_gp(np.asarray(xs_unit, np.float32), np.asarray(ys),
                            kernel, device=device)
                if q == 1:
                    ei = expected_improvement(
                        gp, pool.astype(np.float32), best).cpu().numpy()
                    picks = [pool[int(np.argmax(ei))]]
                else:  # true joint q-EI over shared fantasies
                    idx = qei_greedy(gp, pool.astype(np.float32), best, q,
                                     seed=seed + 2000 + it)
                    picks = [pool[i] for i in idx]
            run_batch(picks)
            done += len(picks)
            it += 1
    else:
        raise ValueError(f"unknown tuning method {method!r}")

    xs_unit_arr = np.asarray(xs_unit)
    ys_arr = np.asarray(ys)
    best = int(np.argmin(ys_arr))
    return TuningResult(best_x=space.from_unit(xs_unit_arr[best]),
                        best_y=float(ys_arr[best]),
                        xs=space.from_unit(xs_unit_arr), ys=ys_arr)


def batch_device(batch, mesh=None):
    """The device a GLM batch trains on: its labels' (the mesh's home with
    ``mesh``)."""
    return mesh.home if mesh is not None else batch.y.device


def tune_glm_reg(
    train_batch,
    task,
    config,
    val_batch,
    n_iters: int = 16,
    batch_size: int = 4,
    reg_range: tuple = (1e-4, 1e4),
    evaluator=None,
    mesh=None,
    seed: int = 0,
    lanes: Optional[int] = None,
):
    """Bayesian search over a GLM's regularization weight with BATCHED
    evaluations: each GP round's ``batch_size`` candidates train as ONE
    `train_glm_grid` (the lanes share every X pass) and score in one lane
    pass (`evaluate_glm_grid`), on the training batch's device (the GP
    too).

    ``lanes`` switches to the lane-batched successive-halving tuner
    (`lane_tuner.tune_glm_reg_lanes`): ``n_iters`` then counts CONFIGS
    (≥ ``lanes``) and ``batch_size`` is ignored.

    Returns ``(best_model, best_reg_weight, TuningResult)``; the result's
    ``ys`` are the minimized metric values (AUC-like metrics negated)."""
    from photon_tpu_torch.evaluation.evaluator import default_evaluator
    from photon_tpu_torch.models.training import (evaluate_glm_grid,
                                                  train_glm_grid)

    if lanes is not None:
        from photon_tpu_torch.tuning.lane_tuner import tune_glm_reg_lanes

        return tune_glm_reg_lanes(
            train_batch, task, config, val_batch, n_configs=n_iters,
            lane_chunk=lanes, reg_range=reg_range, evaluator=evaluator,
            mesh=mesh, seed=seed)

    dev = batch_device(train_batch, mesh)
    evaluator = evaluator if evaluator is not None else default_evaluator(task)
    space = SearchSpace([SearchRange(*reg_range, log_scale=True)])
    # models in evaluation order: the winner is recovered by observation
    # index, not by a round-tripped float weight
    models: list = []

    def evaluate_batch(X) -> list:
        weights = [float(x[0]) for x in X]
        grid = train_glm_grid(train_batch, task, config, weights, mesh=mesh,
                              device=dev)
        _, scores = evaluate_glm_grid(grid, val_batch.to(dev), evaluator)
        out = []
        for (model, _), s in zip(grid, scores):
            models.append(model)
            out.append(-s if evaluator.higher_is_better else s)
        return out

    result = tune(None, space, n_iters=n_iters, batch_size=batch_size,
                  evaluate_batch=evaluate_batch, seed=seed, device=dev)
    best = int(np.argmin(result.ys))
    return models[best], float(result.xs[best, 0]), result
