"""The port's streamed (out-of-device-memory) training against the JAX
package.

On the same numpy-seeded data: the host ladder (`shard_blocked_ell`,
`chunk_blocked_ell`) bit for bit, padded width buckets included; the
kernels' plan on a padded ladder chunk (its inverse map gives each real
position its row and writes no padded position, as an emulation of the
tail kernel's write pattern shows) and one plan per ring slot in a
streamed solve; the chunk-partial API (value, gradient, φ, K candidate
values) for three tasks on dense, `SparseRows` and ladder chunks;
`minimize_lbfgs_streamed`, `minimize_owlqn_streamed` and
`train_glm(ChunkedBatch)` against the reference's streamed solves with
the same chunking (iterations equal, histories within 1e-5) and against
the port's resident `train_glm` (final value within 1e-5, coefficients
within rtol 2e-3 / atol 2e-5: the reference's streamed-equals-resident
tolerance); `DeviceChunkRing`'s pass order, wrap-around and reset; GAME
fits with a chunked fixed shard; and every new raise. The port runs on
the CPU (its kernels' plain versions).
"""
import dataclasses

import jax.core
import jax.extend.core

# The JAX package imports `jax.core.ClosedJaxpr`/`Jaxpr`, which jax 0.9
# moved to `jax.extend.core`: alias the missing public names back before
# anything of photon_tpu is imported.
for _name in dir(jax.extend.core):
    if not _name.startswith("_") and not hasattr(jax.core, _name):
        setattr(jax.core, _name, getattr(jax.extend.core, _name))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from photon_tpu.data import dataset as RD  # noqa: E402
from photon_tpu.data import matrix as RM  # noqa: E402
from photon_tpu.data import normalization as RN  # noqa: E402
from photon_tpu.game import estimator as RGE  # noqa: E402
from photon_tpu.models import training as RT  # noqa: E402
from photon_tpu.ops import losses as RL  # noqa: E402
from photon_tpu.ops.objective import Objective as RObjective  # noqa: E402
from photon_tpu.optim import regularization as RReg  # noqa: E402
from photon_tpu.optim.prior import (  # noqa: E402
    PriorDistribution as RPrior)
from photon_tpu.optim import streamed as RS  # noqa: E402
from photon_tpu.optim.config import OptimizerConfig as RConfig  # noqa: E402
from photon_tpu.optim.config import OptimizerType as ROpt  # noqa: E402

from photon_tpu_torch import kernels as K  # noqa: E402
from photon_tpu_torch import telemetry  # noqa: E402
from photon_tpu_torch.data import dataset as D  # noqa: E402
from photon_tpu_torch.data import matrix as M  # noqa: E402
from photon_tpu_torch.data import normalization as N  # noqa: E402
from photon_tpu_torch.game import dataset as GD  # noqa: E402
from photon_tpu_torch.game import estimator as GE  # noqa: E402
from photon_tpu_torch.game.scoring import (coordinate_scores,  # noqa: E402
                                           score_chunked_host)
from photon_tpu_torch.kernels import blocked_ell as KB  # noqa: E402
from photon_tpu_torch.models import training as T  # noqa: E402
from photon_tpu_torch.models.variance import (  # noqa: E402
    VarianceComputationType as Var)
from photon_tpu_torch.ops import losses as L  # noqa: E402
from photon_tpu_torch.ops.objective import Objective  # noqa: E402
from photon_tpu_torch.optim import regularization as Reg  # noqa: E402
from photon_tpu_torch.optim import streamed as S  # noqa: E402
from photon_tpu_torch.optim.config import OptimizerConfig  # noqa: E402
from photon_tpu_torch.optim.config import OptimizerType  # noqa: E402
from photon_tpu_torch.optim.prior import PriorDistribution  # noqa: E402

CPU = "cpu"
# Histories: both sides take the same steps over the same chunks, each
# chunk partial a sum over a few hundred rows in another order (XLA vs
# PyTorch), a few ulp apart; the difference feeds the next step.
HIST_RTOL = 1e-5
# Partials: sums over one chunk's rows, a few ulp apart.
PART_TOL = dict(rtol=1e-5, atol=1e-5)
# Streamed against resident: the reference's own tolerance
# (tests/test_streamed.py), the same steps summed chunk by chunk.
W_RTOL, W_ATOL = 2e-3, 2e-5


def coo(seed=0, n=1000, d=3000, k=12, zero_share=0.2):
    """Padded COO rows: k zipf(1.4) columns (some slots zero, so rows
    carry different tail counts) plus the intercept column d - 1, and
    labels from a planted model."""
    rng = np.random.default_rng(seed)
    ind = ((rng.zipf(1.4, (n, k)) - 1) % (d - 1)).astype(np.int32)
    val = rng.normal(size=(n, k)).astype(np.float32)
    val[rng.uniform(size=(n, k)) < zero_share] = 0.0
    ind = np.concatenate([ind, np.full((n, 1), d - 1, np.int32)], 1)
    val = np.concatenate([val, np.ones((n, 1), np.float32)], 1)
    w = np.zeros(d, np.float32)
    w[:200] = rng.normal(size=200) / np.sqrt(np.arange(1, 201))
    margin = np.einsum("nk,nk->n", val, w[ind])
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(np.float32)
    return ind, val, y


def ladders(chunk_rows=256, d_dense=32, **kw):
    """(reference, port) blocked-ELL chunk ladders of the same rows."""
    ind, val, y = coo(**kw)
    d = int(ind.max()) + 1
    ref = RD.chunk_blocked_ell(RD.make_batch(RM.SparseRows(ind, val, d), y),
                               chunk_rows, d_dense=d_dense)
    port = D.chunk_blocked_ell(
        D.make_batch(M.SparseRows(ind, val, d), y, device=CPU), chunk_rows,
        d_dense=d_dense)
    return ref, port


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# --------------------------------------------------------- the host ladder
@pytest.mark.parametrize("n_shards", [1, 4])
def test_shard_blocked_ell_equals_reference(n_shards):
    ind, val, _ = coo(seed=1, n=800)
    d = int(ind.max()) + 1
    ref = RM.shard_blocked_ell(RM.SparseRows(ind, val, d), n_shards, 32)
    port = M.shard_blocked_ell(M.SparseRows(ind, val, d), n_shards, 32)
    for f in ("dense", "row_pos", "perm_cols", "inv_perm"):
        np.testing.assert_array_equal(_np(getattr(port, f)),
                                      np.asarray(getattr(ref, f)), f)
    for f in ("ell_pcols", "ell_vals", "bucket_rows", "bucket_vals"):
        a, b = getattr(ref, f), getattr(port, f)
        assert len(a) == len(b)
        for x, z in zip(a, b):
            np.testing.assert_array_equal(_np(z), np.asarray(x), f)
    for f in ("n_features", "n_prefix", "last_col_pos", "tail_nnz",
              "n_shards", "n_local"):
        assert getattr(port, f) == getattr(ref, f), f
    sl = port.shard_slice(1, 2) if n_shards > 1 else port
    assert sl.n_shards == 1 and sl.n_local == port.n_local


def test_chunk_blocked_ell_equals_reference_with_padded_buckets():
    ref, port = ladders(n=1000)  # 4 chunks, the last one 232 rows
    assert port.n_chunks == ref.n_chunks == 4 and port.n == 1000
    free = 0
    for rc, pc in zip(ref.X.chunks, port.X.chunks):
        for f in ("dense", "row_pos"):
            np.testing.assert_array_equal(_np(getattr(pc, f)),
                                          np.asarray(getattr(rc, f)), f)
        for f in ("ell_pcols", "ell_vals", "bucket_rows", "bucket_vals"):
            for x, z in zip(getattr(rc, f), getattr(pc, f)):
                np.testing.assert_array_equal(_np(z), np.asarray(x), f)
        free += int((pc.tail_rows < 0).sum())
    assert free > 0  # some width bucket is padded past a chunk's rows
    np.testing.assert_array_equal(_np(port.X.perm_cols),
                                  np.asarray(ref.X.perm_cols))
    assert port.X.last_col_pos == ref.X.last_col_pos
    for f in ("y", "weights", "offsets"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f))
    # bf16 storage: every value leaf rounds to nearest even, the index
    # leaves stay int32
    ind, val, y = coo(n=1000)
    pb16 = D.chunk_blocked_ell(D.make_batch(M.SparseRows(ind, val, 3000), y,
                                            device=CPU), 256, 32,
                               feature_dtype=torch.bfloat16)
    for c16, c in zip(pb16.X.chunks, port.X.chunks):
        assert c16.row_pos.dtype == torch.int32
        for a, b in ((c16.dense, c.dense), (c16.ell_vals[0], c.ell_vals[0]),
                     (c16.bucket_vals[0], c.bucket_vals[0])):
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(_np(a.float()),
                                          _np(b.to(torch.bfloat16).float()))


def test_chunk_matrix_and_batch_equal_reference():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(700, 9)).astype(np.float32)
    y = rng.uniform(size=700).astype(np.float32)
    ref = RD.chunk_batch(RD.make_batch(X, y), 256)
    port = D.chunk_batch(D.make_batch(X, y, device=CPU), 256)
    assert port.n_chunks == 3 and port.X.n_padded == 768
    for rc, pc in zip(ref.X.chunks, port.X.chunks):
        np.testing.assert_array_equal(_np(pc), rc)
    for f in ("y", "weights", "offsets"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f))
    ind, val, _ = coo(n=700)
    sp = D.chunk_matrix(M.SparseRows(ind, val, 3000), 256)
    rsp = RD.chunk_matrix(RM.SparseRows(ind, val, 3000), 256)
    for rc, pc in zip(rsp.chunks, sp.chunks):
        np.testing.assert_array_equal(_np(pc.indices), rc.indices)
        np.testing.assert_array_equal(_np(pc.values), rc.values)
    b16 = D.chunk_matrix(torch.from_numpy(X).to(torch.bfloat16), 256)
    assert b16.chunks[0].dtype == torch.bfloat16  # storage dtype kept


# -------------------------------------------------- the ladder plan repair
def _layout_of(plan):
    for ref, pl in KB._PLANS.values():
        if pl is plan:
            return ref()
    raise AssertionError("no layout owns this plan")


def emulate_tail(name, plan, ranges, w, lanes, out, zero_bytes):
    """The tail kernel's write pattern on the CPU: position p of the
    width buckets' concatenation adds its row's dot into
    out[plan.tail_rows[p]], and a position mapped to -1 writes nothing."""
    X = _layout_of(plan)
    if zero_bytes:
        out.zero_()
    wt = w[X.d_sel:X.n_prefix]
    base = 0
    for pc, pv in zip(X.ell_pcols, X.ell_vals):
        vals = KB._rowdot(*KB._compute(pv, KB._gather(wt, pc)))
        rows = plan.tail_rows[base:base + pc.shape[0]].long()
        live = rows >= 0
        out[rows[live]] += vals[live]
        base += pc.shape[0]
    K.count_launch(name, ranges[2])


def emulate_rmatvec(name, plan, ranges, r, lanes, square, out):
    out.copy_(KB.bucket_rmatvec_reference(_layout_of(plan), r, square))
    K.count_launch(name, ranges[2])


@pytest.fixture
def emulated_kernels(monkeypatch):
    """Route the blocked-ELL wrappers to the emulated launches (the plan
    is built and used as on the card); ``scope("off")`` still gives the
    plain versions."""
    monkeypatch.setattr(K, "use_kernel", lambda t: K.mode() != "off")
    monkeypatch.setattr(KB, "_launch_tail", emulate_tail)
    monkeypatch.setattr(KB, "_launch_rmatvec", emulate_rmatvec)


def test_padded_ladder_chunk_plan_maps_real_positions_only(
        emulated_kernels):
    _, port = ladders(n=1000)
    for X in port.X.chunks:
        B = sum(int(v.shape[0]) for v in X.ell_vals)
        row_pos = _np(X.row_pos)
        plan = KB.layout_plan(X)
        tail_rows = _np(plan.tail_rows)
        live = row_pos < B
        # every real position maps to its row, every free one to -1
        np.testing.assert_array_equal(tail_rows[row_pos[live]],
                                      np.flatnonzero(live))
        assert (tail_rows >= 0).sum() == live.sum()
        # argsort(row_pos)[:B] is the inverse only when every position
        # is taken: on a padded chunk it shifts rows onto other positions
        if live.sum() < B:
            assert not np.array_equal(
                np.argsort(row_pos, kind="stable")[:B], tail_rows)
        for lanes in ((), (3,)):
            w = torch.from_numpy(np.random.default_rng(3).normal(
                size=(X.n_features,) + lanes).astype(np.float32))
            start = torch.ones((X.shape[0],) + lanes)
            got = KB.tail_matvec(X, w, out=start.clone())
            want = start + KB.tail_matvec_reference(X, w)
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_array_equal(_np(got)[~live], _np(start)[~live])


def test_streamed_solve_builds_one_plan_per_ring_slot(emulated_kernels):
    _, port = ladders(n=1000)
    cfg = OptimizerConfig(max_iters=6, reg=Reg.l2(), reg_weight=1.0,
                          history=4)
    before = KB.plan_builds()
    K.reset_launch_counts()
    telemetry.reset()
    _, res = T.train_glm(port, L.TaskType.LOGISTIC_REGRESSION, cfg,
                         device=CPU)
    builds = KB.plan_builds() - before
    passes = telemetry.snapshot()["counters"]["stream.passes"]
    counts = K.launch_counts()
    assert passes >= 2 * res.iterations and builds == 2  # one per slot
    assert counts[KB.TAIL] > 0 and counts[KB.RMATVEC] > 0
    with K.scope("off"):
        _, plain = T.train_glm(port, L.TaskType.LOGISTIC_REGRESSION, cfg,
                               device=CPU)
    np.testing.assert_allclose(res.history(), plain.history(), rtol=1e-6)


# ------------------------------------------------------ chunk partials
def _partial_inputs(kind, task, seed=4):
    """(reference ChunkedBatch, port ChunkedBatch) of ``kind`` chunks with
    labels fit for ``task``."""
    ind, val, y = coo(seed=seed, n=600, d=400, k=6)
    rng = np.random.default_rng(seed)
    if task == "linear":
        y = rng.normal(size=600).astype(np.float32)
    elif task == "poisson":
        y = rng.poisson(1.0, size=600).astype(np.float32)
    if kind == "ladder":
        ref = RD.chunk_blocked_ell(RD.make_batch(RM.SparseRows(ind, val, 400),
                                                 y), 256, d_dense=16)
        port = D.chunk_blocked_ell(D.make_batch(M.SparseRows(ind, val, 400),
                                                y, device=CPU), 256,
                                   d_dense=16)
        return ref, port
    X = (RM.SparseRows(ind, val, 400), M.SparseRows(ind, val, 400))
    if kind == "dense":
        Xd = np.zeros((600, 400), np.float32)
        np.add.at(Xd, (np.arange(600)[:, None], ind), val)
        X = (Xd, Xd)
    off = (0.1 * rng.normal(size=600)).astype(np.float32)
    return (RD.chunk_batch(RD.make_batch(X[0], y, offsets=off), 256),
            D.chunk_batch(D.make_batch(X[1], y, offsets=off, device=CPU),
                          256))


@pytest.mark.parametrize("kind", ["dense", "sparse", "ladder"])
@pytest.mark.parametrize("task", ["logistic", "linear", "poisson"])
def test_chunk_partials_match_reference(kind, task):
    ref, port = _partial_inputs(kind, task)
    rng = np.random.default_rng(5)
    d = 400
    w = (0.05 * rng.normal(size=d)).astype(np.float32)
    p = (0.05 * rng.normal(size=d)).astype(np.float32)
    W = (0.05 * rng.normal(size=(8, d))).astype(np.float32)
    robj = RObjective(task=RL.TaskType(task), l2=np.float32(0.4))
    pobj = Objective(task=L.TaskType(task), l2=0.4)
    racc = pacc = None
    for i in range(port.n_chunks):
        rb, pb = ref.chunk(i), port.chunk(i)
        rz, rparts = robj.chunk_value_grad_partials(w, rb)
        pz, pparts = pobj.chunk_value_grad_partials(torch.from_numpy(w), pb)
        np.testing.assert_allclose(_np(pz), np.asarray(rz), **PART_TOL)
        for a, b in zip(rparts[:2], pparts[:2]):
            np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-5,
                                       atol=1e-4)
        racc = rparts if racc is None else robj.add_partials(racc, rparts)
        pacc = pparts if pacc is None else Objective.add_partials(pacc,
                                                                  pparts)
        rdz = robj.direction_margin(p, rb)
        pdz = pobj.direction_margin(torch.from_numpy(p), pb)
        ra = robj.chunk_phi_partials(rz, rdz, np.float32(0.5), rb.y,
                                     rb.weights)
        pa = pobj.chunk_phi_partials(pz, pdz, 0.5, pb.y, pb.weights)
        np.testing.assert_allclose([float(v) for v in pa],
                                   [float(v) for v in ra], rtol=1e-5,
                                   atol=1e-4)
        rv = robj.chunk_value_partials_many(W, rb)
        pv = pobj.chunk_value_partials_many(torch.from_numpy(W), pb)
        np.testing.assert_allclose(_np(pv), np.asarray(rv), rtol=1e-5,
                                   atol=1e-4)
    rf, rg = robj.finish_value_grad(w, racc)
    pf, pg = pobj.finish_value_grad(torch.from_numpy(w), pacc)
    np.testing.assert_allclose(float(pf), float(rf), rtol=1e-5)
    np.testing.assert_allclose(_np(pg), np.asarray(rg), rtol=1e-5,
                               atol=1e-4)


# ------------------------------------------------------------ the solves
def _cfg_pair(reg="l2", lam=1.0, iters=8, opt=None):
    r = {"l2": (RReg.l2(), Reg.l2()), "l1": (RReg.l1(), Reg.l1())}[reg]
    common = dict(max_iters=iters, reg_weight=lam, history=5)
    extra = ({} if opt is None else
             ({"optimizer": ROpt(opt)}, {"optimizer": OptimizerType(opt)}))
    return (RConfig(reg=r[0], **common, **(extra[0] if extra else {})),
            OptimizerConfig(reg=r[1], **common, **(extra[1] if extra else {})))


def _hist(res):
    h = _np(res.loss_history)
    return h[~np.isnan(h)]


def _resident(port_cb):
    """The port's resident batch of the same rows as a ChunkedBatch's."""
    X = port_cb.X
    n = X.n_real
    if X.permuted:
        raise AssertionError("build the resident layout from the rows")
    if isinstance(X.chunks[0], M.SparseRows):
        Xr = M.SparseRows(torch.cat([c.indices for c in X.chunks])[:n],
                          torch.cat([c.values for c in X.chunks])[:n],
                          X.n_features)
    else:
        Xr = torch.cat(list(X.chunks))[:n]
    return D.make_batch(Xr, port_cb.y[:n], port_cb.weights[:n],
                        port_cb.offsets[:n], device=CPU)


CASES = {
    # name: (rows, chunk rows, matrix, task, reg, λ, extra)
    "ladder_uneven_lbfgs": (1000, 300, "ladder", "logistic", "l2", 1.0, None),
    "ladder_owlqn_l1": (1000, 256, "ladder", "logistic", "l1", 3.0, None),
    "dense_single_chunk": (400, 512, "dense", "linear", "l2", 1.0, None),
    "sparse_normalized": (600, 256, "sparse", "logistic", "l2", 1.0,
                          "norm"),
    "dense_diagonal_prior": (600, 256, "dense", "poisson", "l2", 1.0,
                             "prior"),
}


def _case_data(name):
    rows, chunk, kind, task, *_ = CASES[name]
    ind, val, y = coo(seed=6, n=rows, d=300, k=6)
    rng = np.random.default_rng(6)
    if task == "linear":
        y = (rng.normal(size=rows) + val[:, 0]).astype(np.float32)
    elif task == "poisson":
        y = rng.poisson(np.exp(0.3 * val[:, 0])).astype(np.float32)
    if kind == "dense":
        X = np.zeros((rows, 300), np.float32)
        np.add.at(X, (np.arange(rows)[:, None], ind), val)
        return (X, y, RD.chunk_batch(RD.make_batch(X, y), chunk),
                D.chunk_batch(D.make_batch(X, y, device=CPU), chunk))
    if kind == "sparse":
        return ((ind, val), y,
                RD.chunk_batch(RD.make_batch(RM.SparseRows(ind, val, 300), y),
                               chunk),
                D.chunk_batch(D.make_batch(M.SparseRows(ind, val, 300), y,
                                           device=CPU), chunk))
    return ((ind, val), y,
            RD.chunk_blocked_ell(RD.make_batch(RM.SparseRows(ind, val, 300),
                                               y), chunk, d_dense=16),
            D.chunk_blocked_ell(D.make_batch(M.SparseRows(ind, val, 300), y,
                                             device=CPU), chunk, d_dense=16))


@pytest.mark.parametrize("name", list(CASES))
def test_train_glm_streamed_matches_reference_and_resident(name):
    rows, chunk, kind, task, reg, lam, extra = CASES[name]
    X, y, rcb, pcb = _case_data(name)
    rcfg, pcfg = _cfg_pair(reg, lam)
    rkw, pkw = {}, {}
    if extra == "norm":
        ind, val = X
        rkw["normalization"] = RN.NormalizationContext.build(
            RM.SparseRows(ind, val, 300), RN.NormalizationType.STANDARDIZATION)
        pkw["normalization"] = N.NormalizationContext.build(
            M.SparseRows(ind, val, 300), N.NormalizationType.STANDARDIZATION)
    if extra == "prior":
        rng = np.random.default_rng(7)
        mu = (0.1 * rng.normal(size=300)).astype(np.float32)
        var = rng.uniform(0.5, 2.0, size=300).astype(np.float32)
        rkw["prior"] = RPrior.from_variances(mu, var)
        pkw["prior"] = PriorDistribution.from_variances(mu, var)
    task_r, task_p = RL.TaskType(task), L.TaskType(task)
    rm, rr = RT.train_glm(rcb, task_r, rcfg, **rkw)
    pm, pr = T.train_glm(pcb, task_p, pcfg, device=CPU, **pkw)
    assert pr.iterations == int(rr.iterations)
    np.testing.assert_allclose(pr.history(), _hist(rr), rtol=HIST_RTOL)
    wr, wp = np.asarray(rm.coefficients.means), _np(pm.coefficients.means)
    np.testing.assert_allclose(wp, wr, rtol=W_RTOL, atol=W_ATOL)
    if reg == "l1":
        np.testing.assert_array_equal(wp == 0.0, wr == 0.0)
        assert 0 < int((wp == 0.0).sum()) < wp.size
    # against the port's resident solve of the same rows
    if kind == "ladder":
        ind, val = X
        res_batch = D.make_batch(M.to_blocked_ell(M.SparseRows(ind, val, 300),
                                                  16, device=CPU), y,
                                 device=CPU)
    else:
        res_batch = _resident(pcb)
    bm, br = T.train_glm(res_batch, task_p, pcfg, device=CPU, **pkw)
    assert br.iterations == pr.iterations
    np.testing.assert_allclose(pr.history()[-1], br.history()[-1],
                               rtol=1e-5)
    wb = _np(bm.coefficients.means)
    np.testing.assert_allclose(wp, wb, rtol=W_RTOL, atol=W_ATOL)
    if reg == "l1":
        np.testing.assert_array_equal(wp == 0.0, wb == 0.0)


@pytest.mark.parametrize("solver", ["lbfgs", "owlqn"])
def test_minimize_streamed_matches_reference(solver):
    _, _, rcb, pcb = _case_data("ladder_uneven_lbfgs")
    d = pcb.X.n_features
    robj = RObjective(task=RL.TaskType.LOGISTIC_REGRESSION,
                      l2=np.float32(0.5))
    pobj = Objective(task=L.TaskType.LOGISTIC_REGRESSION, l2=0.5)
    w0 = np.zeros(d, np.float32)
    if solver == "lbfgs":
        rr = RS.minimize_lbfgs_streamed(robj, rcb, w0, max_iters=7,
                                        history=4)
        pr = S.minimize_lbfgs_streamed(pobj, pcb, torch.from_numpy(w0),
                                       max_iters=7, history=4)
    else:
        rr = RS.minimize_owlqn_streamed(robj, rcb, w0, 2.0, max_iters=7,
                                        history=4, ladder_lanes=3)
        pr = S.minimize_owlqn_streamed(pobj, pcb, torch.from_numpy(w0), 2.0,
                                       max_iters=7, history=4,
                                       ladder_lanes=3)
    assert pr.iterations == int(rr.iterations)
    np.testing.assert_allclose(pr.history(), _hist(rr), rtol=HIST_RTOL)
    np.testing.assert_allclose(pr.grad_history(),
                               np.asarray(rr.grad_norm_history)[
                                   :pr.iterations + 1], rtol=1e-4)
    assert bool(pr.converged) == bool(rr.converged)
    assert bool(pr.failed) == bool(rr.failed)


# ------------------------------------------------------------- the ring
def test_ring_pass_order_wraps_into_the_next_pass_and_resets():
    _, port = ladders(n=1000)
    ring = D.DeviceChunkRing(port, device=CPU, prefetch=2)
    uploads = []
    real = ring._upload
    ring._upload = lambda i, s: uploads.append(i) or real(i, s)
    order = [i for i, _ in ring.stream_pass()]
    assert order == [0, 1, 2, 3]
    # the window kept filling past the last chunk: the next pass's first
    # chunks are already in flight
    assert uploads == [0, 1, 2, 3, 0, 1]
    slots = []
    for i, b in ring.stream_pass():
        slots.append(id(b.X))
        np.testing.assert_array_equal(_np(b.X.dense),
                                      _np(port.X.chunks[i].dense))
        np.testing.assert_array_equal(_np(b.X.tail_rows),
                                      _np(port.X.chunks[i].tail_rows))
        np.testing.assert_array_equal(_np(b.y),
                                      port.y[i * 256:(i + 1) * 256])
    assert uploads[6:] == [2, 3, 0, 1] and len(set(slots)) == 2
    # a pass abandoned part way: the next one starts clean at chunk 0
    it = ring.stream_pass()
    next(it)
    next(it)
    it.close()
    assert [i for i, _ in ring.stream_pass()] == [0, 1, 2, 3]
    snap = telemetry.snapshot()
    assert snap["gauges"]["stream.prefetch_depth"] == 2
    # the one-pass form uploads nothing past the last chunk
    seen = [i for i, _ in port.iter_device(device=CPU, prefetch=3)]
    assert seen == [0, 1, 2, 3]


def test_ring_counts_the_reference_stream_counters():
    _, port = ladders(n=600)
    telemetry.reset()
    ring = port.device_ring(device=CPU, prefetch=1)
    for _ in range(3):
        for _ in ring.stream_pass():
            pass
    c = telemetry.snapshot()["counters"]
    assert c["stream.passes"] == 3
    assert c["stream.chunk_uploads"] == 3 * port.n_chunks
    assert c["stream.stall_seconds"] >= 0.0
    assert c["stream.compute_seconds"] >= 0.0
    assert port.X.chunk_nbytes() == sum(
        t.numel() * t.element_size() for t in D._leaves(port.X.chunks[0]))
    assert port.X.nbytes() == port.n_chunks * port.X.chunk_nbytes()


def test_score_chunked_host_matches_resident_scoring():
    X, y, _, pcb = _case_data("dense_diagonal_prior")
    w = torch.from_numpy(np.random.default_rng(8).normal(
        size=300).astype(np.float32))
    got = score_chunked_host(pcb.X, w)
    assert isinstance(got, np.ndarray) and got.shape == (600,)
    np.testing.assert_allclose(got, _np(torch.from_numpy(X) @ w), rtol=1e-5,
                               atol=1e-5)
    Xs, _, _, lcb = _case_data("ladder_uneven_lbfgs")
    ind, val = Xs
    resident = M.to_blocked_ell(M.SparseRows(ind, val, 300), 16, device=CPU)
    want = _np(M.matvec(resident, resident.from_model_space(w)))
    np.testing.assert_allclose(score_chunked_host(lcb.X, w), want,
                               rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------- GAME
def _game(kind):
    """(reference GameData, port GameData, resident port GameData): a
    fixed shard chunked as dense rows or a ladder, a dense per-user
    shard."""
    rng = np.random.default_rng(9)
    n = 500
    ind, val, y = coo(seed=9, n=n, d=200, k=5)
    Xu = np.concatenate([rng.normal(size=(n, 3)), np.ones((n, 1))],
                        1).astype(np.float32)
    uid = (rng.zipf(1.3, size=n) - 1) % 20
    if kind == "dense":
        Xf = np.zeros((n, 200), np.float32)
        np.add.at(Xf, (np.arange(n)[:, None], ind), val)
        rX, pX, resX = (RD.chunk_matrix(Xf, 128), D.chunk_matrix(Xf, 128),
                        Xf)
    else:
        rX = RD.chunk_blocked_ell(RD.make_batch(RM.SparseRows(ind, val, 200),
                                                y), 128, d_dense=8).X
        pX = D.chunk_blocked_ell(D.make_batch(M.SparseRows(ind, val, 200), y,
                                              device=CPU), 128, d_dense=8).X
        resX = M.to_blocked_ell(M.SparseRows(ind, val, 200), 8, device=CPU)
    ids = {"user": uid}
    return (RGE.GameData.build(y, shards={"fixed": rX, "u": Xu},
                               entity_ids=ids),
            GD.GameData.build(y, shards={"fixed": pX, "u": Xu},
                              entity_ids=ids),
            GD.GameData.build(y, shards={"fixed": resX, "u": Xu},
                              entity_ids=ids))


def _estimators():
    fr, fp = _cfg_pair("l2", 1.0, iters=6)
    ur, up = (RConfig(reg=RReg.l2(), reg_weight=2.0, max_iters=6,
                      tolerance=1e-3),
              OptimizerConfig(reg=Reg.l2(), reg_weight=2.0, max_iters=6,
                              tolerance=1e-3))
    ref = RGE.GameEstimator(
        task=RL.TaskType.LOGISTIC_REGRESSION, n_sweeps=2,
        coordinate_configs={
            "fixed": RGE.FixedEffectConfig("fixed", fr),
            "per_user": RGE.RandomEffectConfig("user", "u", ur)})
    port = GE.GameEstimator(
        task=L.TaskType.LOGISTIC_REGRESSION, n_sweeps=2, device=CPU,
        coordinate_configs={
            "fixed": GE.FixedEffectConfig("fixed", fp),
            "per_user": GE.RandomEffectConfig("user", "u", up)})
    return ref, port


@pytest.mark.parametrize("kind", ["dense", "ladder"])
def test_game_fit_with_a_chunked_fixed_shard(kind):
    rdata, pdata, resdata = _game(kind)
    rest, pest = _estimators()
    (rr,) = rest.fit(rdata)
    telemetry.reset()
    (pr,) = pest.fit(pdata)
    counters = telemetry.snapshot()["counters"]
    assert counters["game_e2e.streamed_fixed_updates"] == 2
    assert counters["game_e2e.chunked_fit_points"] == 1
    assert counters["game_e2e.host_offset_sums"] == 4
    np.testing.assert_allclose(pr.descent.objective_history,
                               rr.descent.objective_history, rtol=HIST_RTOL)
    np.testing.assert_allclose(
        _np(pr.model.coordinates["fixed"].model.weights),
        np.asarray(rr.model.coordinates["fixed"].model.weights),
        rtol=W_RTOL, atol=W_ATOL)
    np.testing.assert_allclose(
        _np(pr.model.coordinates["per_user"].coefficients),
        np.asarray(rr.model.coordinates["per_user"].coefficients),
        rtol=1e-4, atol=1e-5)
    _, resest = _estimators()
    (br,) = resest.fit(resdata)
    np.testing.assert_allclose(pr.descent.objective_history,
                               br.descent.objective_history, rtol=1e-5)
    np.testing.assert_allclose(
        _np(pr.model.coordinates["fixed"].model.weights),
        _np(br.model.coordinates["fixed"].model.weights), rtol=W_RTOL,
        atol=W_ATOL)
    # scoring a chunked shard equals scoring the resident one
    got = coordinate_scores(pr.model, pdata)["fixed"]
    want = coordinate_scores(pr.model, resdata)["fixed"]
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ what raises
def test_streamed_raises():
    _, _, _, pcb = _case_data("dense_single_chunk")
    task = L.TaskType.LINEAR_REGRESSION
    cfg = OptimizerConfig(max_iters=2, reg=Reg.l2(), reg_weight=1.0)

    def item(n, fn, exc=NotImplementedError):
        with pytest.raises(exc, match=f"ROADMAP queue A item {n}\\b"):
            fn()

    with pytest.raises(ValueError, match="TRON is not available"):
        T.train_glm(pcb, task, dataclasses.replace(
            cfg, optimizer=OptimizerType.TRON), device=CPU)
    with pytest.raises(ValueError, match="variances are not available"):
        T.train_glm(pcb, task, cfg, variance=Var.SIMPLE, device=CPU)
    full = PriorDistribution.from_hessian(np.zeros(300, np.float32),
                                          np.eye(300, dtype=np.float32))
    with pytest.raises(ValueError, match="full-covariance"):
        T.train_glm(pcb, task, cfg, prior=full, device=CPU)
    with pytest.raises(ValueError, match="no lane-minor grid"):
        T.train_glm_grid(pcb, task, cfg, [0.1, 1.0], device=CPU)
    item(10, lambda: T.train_glm(pcb, task, cfg, mesh=object(), device=CPU))
    item(10, lambda: S.minimize_lbfgs_streamed(
        Objective(task), pcb, torch.zeros(300), mesh=object()))
    item(11, lambda: S.minimize_lbfgs_streamed(
        Objective(task), pcb, torch.zeros(300), checkpoint=object()))
    item(11, lambda: S.minimize_owlqn_streamed(
        Objective(task), pcb, torch.zeros(300), 1.0, checkpoint=object()))

    item(10, lambda: pcb.device_ring(device=CPU, mesh=object()))
    item(10, lambda: next(pcb.iter_device(device=CPU, mesh=object())))
    item(10, lambda: pcb.mesh_chunk(0, object()))
    item(10, lambda: D.mesh_chunk_matrix(None, object()))
    item(10, lambda: score_chunked_host(pcb.X, torch.zeros(300),
                                       mesh=object()))
    ind, val, y = coo(n=64)
    sp = D.make_batch(M.SparseRows(ind, val, 3000), y, device=CPU)
    item(10, lambda: D.chunk_blocked_ell(sp, 32, n_shards=2))
    with pytest.raises(TypeError, match="chunk_blocked_ell"):
        D.chunk_matrix(M.to_blocked_ell(sp.X, 16, device=CPU), 16)
    with pytest.raises(TypeError, match="expects SparseRows"):
        D.chunk_blocked_ell(D.make_batch(np.zeros((4, 3)), np.zeros(4),
                                         device=CPU), 2)
    with pytest.raises(ValueError, match="must be >= 1"):
        D.chunk_matrix(np.zeros((4, 3)), 0)
    with pytest.raises(ValueError, match="do not divide"):
        M.shard_blocked_ell(sp.X, 5)
    bare = D.ChunkedMatrix((M.to_blocked_ell(sp.X, 16, device=CPU),), 64,
                           3000)
    with pytest.raises(ValueError, match="tail_rows"):
        D.DeviceChunkRing(D.make_chunked_batch(bare, np.zeros(64)),
                          device=CPU)
    # a random effect needs a resident shard
    _, pdata, _ = _game("dense")
    with pytest.raises(TypeError, match="resident shard"):
        GD.RandomEffectDataset.build(pdata, "user", "fixed", device=CPU)
