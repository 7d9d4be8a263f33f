"""The entry ``train_glm_grid``: the lane-minor L-BFGS grid of L2 logistic
regressions on the blocked-ELL layout, and the plain reference that
judges what its timed fits produced.

A traffic mix that names this entry gives ``task`` logistic, ``reg`` l2,
``reg_weights`` ({"geomspace": [lo, hi, lanes]}) and ``optimizer``
(``max_iters``, ``tolerance``, ``history``, ``lane_history_dtype``).

The judge's numbers, each a relative gap, worst lane first:

- ``loss_gap``: every timed fit's losses at iterations 0 and 1 against the
  reference's first iteration (the layout, both X passes, the objective,
  the first direction and its Wolfe search);
- ``gnorm0_gap``: every timed fit's first gradient norm, as the solver
  gets it, against the reference's;
- ``dir_gap``: the direction the solver's two-loop recursion gives at an
  iteration ``k`` past the history's first wrap, drawn from the seed,
  against the reference's float64 recursion over the same gradient and
  the same (s, y) pairs: |D - D_ref| / |D_ref|;
- ``grad_gap``: the Xᵀ pass that gave the solver's gradient at that
  iteration, against the reference's gradient at the same coefficients
  and margins: |g - g_ref| / |g_ref|;
- ``final_gap``: the loss a timed fit drawn from the seed holds at its end
  against the reference's objective at that fit's final coefficients,
  read back in model order.

The two at ``k`` follow the solver from its own state: its gradient,
pairs, coefficients and margins, and the column order of its layout
(``perm_cols``), are read in a fit after the window, through hooks on
`photon_tpu_torch.optim.lane_lbfgs.LaneHistory` and
`photon_tpu_torch.ops.lane_objective.grad_at_margin_lanes` that keep
references and compute nothing. Every fit solves the same problem from
zero, so that fit is the timed fits' computation once more. The margins
the solver carries between its refreshes (z + a dz, each step's product
taking the step in bfloat16) are judged by ``final_gap``, where they make
the loss the solver holds.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import random
import time

import numpy as np

NAMES = ("loss_gap", "gnorm0_gap", "dir_gap", "grad_gap", "final_gap")


def solver(traffic: dict):
    """The solver's config and the L2 weights of a traffic mix."""
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l2

    if (traffic["task"], traffic["reg"]) != ("logistic", "l2"):
        raise ValueError(f"traffic {traffic['name']}: train_glm_grid takes "
                         f"the L2 logistic grid only")
    o = traffic["optimizer"]
    cfg = OptimizerConfig(max_iters=o["max_iters"], tolerance=o["tolerance"],
                          reg=l2(), history=o["history"],
                          lane_history_dtype=o["lane_history_dtype"])
    lo, hi, g = traffic["reg_weights"]["geomspace"]
    return cfg, [float(w) for w in np.geomspace(lo, hi, int(g))]


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def check_iteration(seed: int, history: int, max_iters: int) -> int:
    """The iteration whose direction and gradient are judged, drawn from
    the seed: past the history's first wrap, before the last."""
    lo = min(history + 1, max_iters - 1)
    return random.Random(seed ^ 0x5EED).randint(lo, max_iters - 1)


class Recorder:
    """Keeps references to what the lane solver holds at iteration ``k``
    (or at its last, if it stops sooner): the gradient, the direction its
    two-loop gives, the (s, y, stepped) pairs in its history, oldest
    first, and the Xᵀ pass that gave the gradient (its coefficients,
    margins and output)."""

    def __init__(self, k: int, m: int):
        self.k = k
        self.pushes = collections.deque(maxlen=m)
        self.n_dir = self.n_push = self.n_grad = 0
        self.grad = None
        self.at = None

    @contextlib.contextmanager
    def hooks(self):
        from photon_tpu_torch.ops import lane_objective
        from photon_tpu_torch.optim import lane_lbfgs

        H = lane_lbfgs.LaneHistory
        direction, push = H.direction, H.push
        grad = lane_objective.grad_at_margin_lanes

        def on_direction(hist, g):
            D = direction(hist, g)
            if self.n_dir <= self.k:
                self.at = dict(it=self.n_dir, g=g, D=D,
                               pairs=list(self.pushes), grad=self.grad)
            self.n_dir += 1
            return D

        def on_push(hist, s, y, accept):
            if self.n_push < self.k:
                self.pushes.append((s, y, accept))
            self.n_push += 1
            return push(hist, s, y, accept)

        def on_grad(obj, l2s, W, z, batch):
            out = grad(obj, l2s, W, z, batch)
            if self.n_grad < self.k:  # the gradient of iteration n + 1
                self.grad = dict(w=W, z=z, g=out)
            self.n_grad += 1
            return out

        H.direction, H.push = on_direction, on_push
        lane_objective.grad_at_margin_lanes = on_grad
        try:
            yield self
        finally:
            H.direction, H.push = direction, push
            lane_objective.grad_at_margin_lanes = grad


class Session:
    """One cell's set-up on ``device`` from ``seed``: the data, its counts,
    the layout built through the port and the batch; `fit` runs the timed
    entry once. ``batch_hook`` (faults): a function of the batch that
    returns the batch the fits take."""

    def __init__(self, cell: dict, seed: int, device, batch_hook=None):
        import torch

        from photon_tpu_torch.data.dataset import make_batch
        from photon_tpu_torch.data.matrix import SparseRows, to_blocked_ell

        from portbench import gen, roofline

        self.seed = seed
        self.dev = dev = torch.device(device)
        config = cell["config"]
        self.layout = config["layout"]
        hot_dtype = getattr(torch, self.layout["hot_dtype"])
        self.cfg, self.weights = solver(cell["traffic"])
        prob = gen.generate(config, seed, dev)
        self.counts = roofline.count_data(
            prob.indices, prob.values, prob.n_features,
            self.layout["d_dense"], hot_dtype.itemsize)
        self.ind = prob.indices.cpu().numpy()
        self.val = prob.values.cpu().numpy()
        self.y, self.d = prob.labels, prob.n_features
        self.rows, self.lanes = len(self.ind), len(self.weights)
        self.history = self.cfg.history
        del prob
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        sync(dev)
        t = time.perf_counter()
        with torch.profiler.record_function("portbench.layout"):
            X = to_blocked_ell(SparseRows(self.ind, self.val, self.d),
                               self.layout["d_dense"],
                               device_dense_dtype=hot_dtype, device=dev)
        sync(dev)
        self.layout_build_s = time.perf_counter() - t
        self.perm_cols = X.perm_cols
        self.batch = make_batch(X, self.y, device=dev)
        if batch_hook is not None:
            self.batch = batch_hook(self.batch)

    def fit(self, hook=None):
        """(result, record) of one fit through ``train_glm_grid``; ``hook``
        (faults, counters) wraps the call: ``hook(call)`` returns its
        result."""
        import torch

        from photon_tpu_torch import kernels as K
        from photon_tpu_torch.models.training import train_glm_grid
        from photon_tpu_torch.ops.losses import TaskType

        def call():
            with torch.profiler.record_function("portbench.fit"):
                return train_glm_grid(
                    self.batch, TaskType.LOGISTIC_REGRESSION, self.cfg,
                    self.weights, device_results=True, device=self.dev)

        K.reset_launch_counts()
        sync(self.dev)
        t0 = time.perf_counter()
        res, _ = call() if hook is None else hook(call)
        sync(self.dev)
        wall = time.perf_counter() - t0
        its = res.iterations.cpu().numpy()
        return res, dict(
            wall_s=wall, iters_sum=int(its.sum()),
            lockstep_iters=int(its.max()), trials=int(res.trials),
            launches=K.launch_counts(), failed=int(res.failed.sum()),
            history=res.loss_history.double().cpu().numpy(),
            gnorm0=res.grad_norm_history[:, 0].double().cpu().numpy(),
            iterations=its)

    @staticmethod
    def kept(res, rec):
        """What the judge keeps of a timed fit drawn for the check."""
        return res.w, rec

    def record(self, hook=None):
        """One more fit, with the solver's state at the drawn iteration
        kept: (record, kept, the recorder's snapshot)."""
        k = check_iteration(self.seed, self.history, self.cfg.max_iters)
        r = Recorder(k, self.history)
        with r.hooks():
            res, rec = self.fit(hook)
        at = r.at
        if at is not None:
            at["perm_cols"] = self.perm_cols
        return rec, self.kept(res, rec), at

    def release(self) -> None:
        """Free the program's state (the layout and the batch)."""
        import torch

        self.batch = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self) -> "Reference":
        return Reference(self)


def _lane_gap(got, want) -> float:
    """max over lanes of |got - want| / |want|, columns (d, G) in float64."""
    import torch

    got, want = got.to(torch.float64), want.to(torch.float64)
    num = torch.linalg.vector_norm(got - want, dim=0)
    den = torch.linalg.vector_norm(want, dim=0)
    gap = (num / torch.clamp(den, min=1e-300)).cpu().numpy()
    return float(np.max(np.where(np.isfinite(gap), gap, np.inf)))


class Reference:
    """The plain reference over a session's data (`portbench.reference.glm`):
    its first L-BFGS iteration, its gradient and direction at the solver's
    recorded state, and its objective at given coefficients, in float64."""

    def __init__(self, s: Session):
        import torch

        from portbench.reference import glm as ref

        self.s = s
        ind = torch.from_numpy(s.ind).to(s.dev)
        val = torch.from_numpy(s.val).to(s.dev)
        self.M = ref.Matrix(ind, val, s.d, ref.hot_columns(
            ind, val, s.d, s.layout["d_dense"]))
        del ind, val
        self.y = s.y.to(s.dev, torch.float64)
        self.l2s = torch.tensor(s.weights, dtype=torch.float64,
                                device=s.dev)
        self.first = ref.first_step(self.M, self.y, self.l2s)

    def at_iterate(self, at) -> dict:
        """``dir_gap`` and ``grad_gap`` at a recorder's snapshot."""
        import torch

        from portbench.reference import glm as ref

        if at is None or at["grad"] is None:
            return {"dir_gap": float("inf"), "grad_gap": float("inf")}
        dir_gap = _lane_gap(at["D"], ref.direction(at["g"], at["pairs"]))
        perm = at["perm_cols"].to(self.s.dev).long()
        d = perm.shape[0]
        inv = torch.full((d,), -1, dtype=torch.long, device=self.s.dev)
        inv[perm] = torch.arange(d, device=self.s.dev)
        if bool((inv < 0).any()):  # not a permutation: no model order
            return {"dir_gap": dir_gap, "grad_gap": float("inf")}
        x = at["grad"]
        g_ref = ref.gradient_at(self.M, self.y, self.l2s, x["z"],
                                x["w"].to(torch.float64)[inv])[perm]
        return {"dir_gap": dir_gap, "grad_gap": _lane_gap(x["g"], g_ref)}

    def judge(self, fits: list, kept, at) -> dict:
        """The judge's numbers for ``fits`` (records), ``kept``, the (G, d)
        coefficients and record of the fit drawn for the check, and ``at``,
        a recorder's snapshot."""
        import torch

        from portbench import judge
        from portbench.reference import glm as ref

        w, rec = kept
        w = w.to(self.s.dev, torch.float64).t().contiguous()
        final = ref.objective(self.M, self.y, self.l2s, w)[0]
        out = {
            "loss_gap": max(judge.rel(np.asarray(f["history"])[:, :2].T,
                                      self.first["loss"]) for f in fits),
            "gnorm0_gap": max(judge.rel(f["gnorm0"], self.first["gnorm0"])
                              for f in fits)}
        out.update(self.at_iterate(at))
        out["final_gap"] = judge.rel(
            judge.last_losses(rec["history"], rec["iterations"]),
            final.cpu().numpy())
        return {k: out[k] for k in NAMES}


def control_readings(cell: dict, seed: int, device="cuda",
                     variants=None) -> dict:
    """{variant: the judge's numbers} for one seed, one recorded fit a
    variant: the sound program; the control, the program's own
    lower-precision path (its (s, y) history stored in bfloat16 where the
    configuration states float32); and each planted fault
    (`portbench.faults`). ``variants``: the names to run (default all).
    The reference is built once the data is made and judges each variant
    as its fit ends, so a snapshot at a time is held."""
    from portbench import faults

    s = Session(cell, seed, device)
    sound_cfg, batch = s.cfg, s.batch
    plans = {
        "program": None,
        "control_bf16_history": None,
        "fault_unchanged": faults.unchanged,
        "fault_half_batch": None,
        "fault_permuted": faults.permuted(s.perm_cols),
    }
    s.fit()  # warm
    R = s.reference()
    out = {}
    for name, hook in plans.items():
        if variants and name not in variants:
            continue
        s.cfg = (dataclasses.replace(sound_cfg,
                                     lane_history_dtype="bfloat16")
                 if name == "control_bf16_history" else sound_cfg)
        s.batch = faults.half_batch(batch) if name == "fault_half_batch" \
            else batch
        rec, kept, at = s.record(hook)
        out[name] = R.judge([rec], kept, at)
        del rec, kept, at
    s.cfg, s.batch = sound_cfg, batch
    return out
