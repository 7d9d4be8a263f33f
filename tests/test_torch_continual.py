"""The port's continual refresh (delta plan → prior warm-started
compacted re-solve → parity-probed hot swap) and its compaction pieces
against the JAX package.

The world mirrors the reference's `tests/test_continual.py`: N = 600 rows
over E = 24 entities (DF = 6 fixed, DR = 4 per-entity features), a
previous model with SIMPLE variances and its manifest, and a delta drop
touching entities 3, 7, 11 and 19 plus one brand-new entity — built in
both packages from the same numpy arrays; the previous model is the same
arrays in both, so each refresh starts from the same bits. Refreshes stop
at tolerance 1e-3 (small entity problems reach the f32 floor within a few
iterations, where two f32 paths part on rounding; a stop at 1e-3 is a
decision rounding cannot flip). Touched coefficients and variances within
rtol 1e-4 / atol 1e-5 of the reference's with equal iterations and equal
stats; untouched entities and the fixed effect bit for bit; probes within
1e-9. The port runs on the CPU.
"""
import dataclasses
import json
import logging
import os

import jax.core
import jax.extend.core

# The JAX package imports `jax.core.ClosedJaxpr`/`Jaxpr`, which jax 0.9
# moved to `jax.extend.core`: alias the missing public names back before
# anything of photon_tpu is imported.
for _name in dir(jax.extend.core):
    if not _name.startswith("_") and not hasattr(jax.core, _name):
        setattr(jax.core, _name, getattr(jax.extend.core, _name))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from photon_tpu import continual as RC  # noqa: E402
from photon_tpu.continual import swap as RSW  # noqa: E402
from photon_tpu.data import matrix as RM  # noqa: E402
from photon_tpu.data import model_io as RIO  # noqa: E402
from photon_tpu.game import dataset as RGD  # noqa: E402
from photon_tpu.game import model as RGM  # noqa: E402
from photon_tpu.models import glm as RGLM  # noqa: E402
from photon_tpu.ops.losses import TaskType as RTask  # noqa: E402
from photon_tpu.optim import regularization as RReg  # noqa: E402
from photon_tpu.optim.config import OptimizerConfig as RConfig  # noqa: E402
from photon_tpu.optim.config import OptimizerType as ROpt  # noqa: E402
from photon_tpu.parallel import mesh as RMesh  # noqa: E402
from photon_tpu.serving.store import CoefficientStore as RStore  # noqa: E402

from photon_tpu_torch import continual as C  # noqa: E402
from photon_tpu_torch import telemetry  # noqa: E402
from photon_tpu_torch.checkpoint.faults import (  # noqa: E402
    FaultPlan, InjectedFault, fault_plan)
from photon_tpu_torch.continual import swap as SW  # noqa: E402
from photon_tpu_torch.data import matrix as M  # noqa: E402
from photon_tpu_torch.data import model_io as IO  # noqa: E402
from photon_tpu_torch.data.index_map import IndexMap, feature_key  # noqa: E402
from photon_tpu_torch.game import dataset as GD  # noqa: E402
from photon_tpu_torch.game import model as GM  # noqa: E402
from photon_tpu_torch.game import random_effect as RE  # noqa: E402
from photon_tpu_torch.game.estimator import RandomEffectConfig  # noqa: E402
from photon_tpu_torch.models import glm as GLM  # noqa: E402
from photon_tpu_torch.ops.losses import TaskType  # noqa: E402
from photon_tpu_torch.optim import regularization as Reg  # noqa: E402
from photon_tpu_torch.optim.config import OptimizerConfig  # noqa: E402
from photon_tpu_torch.optim.config import OptimizerType  # noqa: E402
from photon_tpu_torch.parallel import mesh as PM  # noqa: E402
from photon_tpu_torch.serving.store import CoefficientStore  # noqa: E402

CPU = "cpu"
W_RTOL, W_ATOL = 1e-4, 1e-5
N, E, DF, DR = 600, 24, 6, 4
TOUCHED = np.asarray([3, 7, 11, 19])


def cfg_pair(opt="lbfgs", reg="l2", lam=0.5, iters=25, tol=1e-3):
    r = {"l2": (RReg.l2(), Reg.l2()),
         "en": (RReg.elastic_net(0.5), Reg.elastic_net(0.5))}[reg]
    common = dict(max_iters=iters, reg_weight=lam, history=4, tolerance=tol)
    return (RConfig(optimizer=ROpt(opt), reg=r[0], **common),
            OptimizerConfig(optimizer=OptimizerType(opt), reg=r[1], **common))


CFG_R = cfg_pair()


def _labels(rng, Xf, Xr, ent, w_true, u_true):
    m = Xf @ w_true + np.einsum("nd,nd->n", Xr, u_true[ent])
    return (rng.uniform(size=m.shape[0])
            < 1 / (1 + np.exp(-m))).astype(np.float32)


def data_pair(y, shards, ent, weights=None):
    """(reference GameData, port GameData) of the same arrays; a
    ``(ind, val, d)`` shard becomes each package's `SparseRows`."""
    def build(pkg_sparse, GDm):
        sh = {k: (pkg_sparse(*v) if isinstance(v, tuple) else v)
              for k, v in shards.items()}
        return GDm.GameData.build(y, sh, {"e": ent}, weights=weights)

    return build(RM.SparseRows, RGD), build(M.SparseRows, GD)


def model_pair(w, C_, V, keys, rs="rs"):
    """(reference GameModel, port GameModel) of the same arrays: a fixed
    effect on "fx" and a per-entity effect "re" on ``rs`` with variances."""
    keys = np.asarray(keys)
    k2i = {k: i for i, k in enumerate(keys.tolist())}
    rt, pt = RTask.LOGISTIC_REGRESSION, TaskType.LOGISTIC_REGRESSION
    ref = RGM.GameModel({
        "fixed": RGM.FixedEffectModel(RGLM.GeneralizedLinearModel(
            RGLM.Coefficients(jnp.asarray(w)), rt), "fx"),
        "re": RGM.RandomEffectModel(
            entity_name="e", feature_shard=rs, task=rt,
            coefficients=jnp.asarray(C_), entity_keys=keys,
            key_to_index=dict(k2i), variances=jnp.asarray(V))}, rt)
    port = GM.GameModel({
        "fixed": GM.FixedEffectModel(GLM.GeneralizedLinearModel(
            GLM.Coefficients(torch.from_numpy(w.copy())), pt), "fx"),
        "re": GM.RandomEffectModel(
            entity_name="e", feature_shard=rs, task=pt,
            coefficients=torch.from_numpy(C_.copy()), entity_keys=keys,
            key_to_index=dict(k2i),
            variances=torch.from_numpy(V.copy()))}, pt)
    return ref, port


def _world(sparse: bool = False):
    """The reference test's world: a previous model (a posterior near the
    planted one, with variances), its training data and manifest, and a
    delta drop touching TOUCHED plus 16 rows of a brand-new entity."""
    rng = np.random.default_rng(0)
    ent = rng.integers(0, E, size=N)
    Xf = rng.normal(size=(N, DF)).astype(np.float32)
    dr = 8 if sparse else DR

    def re_rows(n):
        if not sparse:
            return rng.normal(size=(n, DR)).astype(np.float32)
        col = np.argsort(rng.uniform(size=(n, dr - 1)), axis=1)[:, :2]
        ind = np.concatenate([col, np.full((n, 1), dr - 1)], 1)
        val = np.concatenate([rng.normal(size=(n, 2)), np.ones((n, 1))], 1)
        return ind.astype(np.int32), val.astype(np.float32), dr

    def dense(rows):
        if not sparse:
            return rows
        ind, val, d = rows
        out = np.zeros((ind.shape[0], d), np.float32)
        np.add.at(out, (np.arange(ind.shape[0])[:, None], ind), val)
        return out

    Xr = re_rows(N)
    w_true = (rng.normal(size=DF) * 0.5).astype(np.float32)
    u_true = (rng.normal(size=(E, dr)) * 0.5).astype(np.float32)
    y = _labels(rng, Xf, dense(Xr), ent, w_true, u_true)
    ref_data, port_data = data_pair(y, {"fx": Xf, "rs": Xr}, ent)
    w_prev = (w_true + 0.05 * rng.normal(size=DF)).astype(np.float32)
    C_prev = (u_true + 0.1 * rng.normal(size=(E, dr))).astype(np.float32)
    V_prev = rng.uniform(0.05, 0.5, size=(E, dr)).astype(np.float32)
    ref_prev, port_prev = model_pair(w_prev, C_prev, V_prev, np.arange(E))

    n2 = 144
    ent2 = np.concatenate([
        rng.permutation(np.repeat(TOUCHED, (n2 - 16) // TOUCHED.size)),
        np.full(16, E + 3)])
    Xf2 = rng.normal(size=(ent2.shape[0], DF)).astype(np.float32)
    Xr2 = re_rows(ent2.shape[0])
    u_shift = np.vstack([u_true + 0.8, np.zeros((4, dr), np.float32)])
    y2 = _labels(rng, Xf2, dense(Xr2), ent2, w_true, u_shift)
    ref_drop, port_drop = data_pair(y2, {"fx": Xf2, "rs": Xr2}, ent2)
    ref_manifest = RC.build_manifest(ref_data)
    manifest = C.build_manifest(port_data)
    return {"ref_data": ref_data, "data": port_data, "ref_prev": ref_prev,
            "prev": port_prev, "ref_manifest": ref_manifest,
            "manifest": manifest, "ref_drop": ref_drop, "drop": port_drop,
            "ref_plan": RC.diff_manifest(ref_manifest, ref_drop, ref_prev),
            "plan": C.diff_manifest(manifest, port_drop, port_prev)}


@pytest.fixture(scope="module")
def world():
    return _world()


@pytest.fixture(scope="module")
def refreshed(world):
    """The reference's and the port's refresh of the world's drop."""
    return (RC.refresh_game_model(world["ref_prev"], world["ref_drop"],
                                  world["ref_plan"], {"re": CFG_R[0]}),
            C.refresh_game_model(world["prev"], world["drop"], world["plan"],
                                 {"re": CFG_R[1]}))


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def imaps():
    return {"fixed": IndexMap({feature_key(f"f{j}"): j for j in range(DF)},
                              frozen=True),
            "re": IndexMap({feature_key(f"r{j}"): j for j in range(DR)},
                           frozen=True)}


# ------------------------------------------------------------------ manifest
def test_manifest_counts_weight_carrying_rows_only():
    ids = np.asarray([0, 0, 1, 1, 2])
    w = np.asarray([1.0, 0.0, 1.0, 1.0, 0.0], np.float32)
    data = GD.GameData.build(np.zeros(5, np.float32),
                             {"x": np.zeros((5, 2), np.float32)},
                             {"e": ids}, weights=w)
    m = C.build_manifest(data)
    assert m["entities"]["e"] == {"0": 1, "1": 2} and m["n_rows"] == 5
    ref = RGD.GameData.build(np.zeros(5, np.float32),
                             {"x": np.zeros((5, 2), np.float32)},
                             {"e": ids}, weights=w)
    assert m == RC.build_manifest(ref)


def test_manifest_round_trip_beside_model(world, tmp_path):
    """The world's manifest equals the reference's dict; saved beside the
    port's model it loads back in both packages, and either package loads
    the model directory (variances included)."""
    assert world["manifest"] == world["ref_manifest"]
    out = str(tmp_path / "model")
    IO.save_game_model(out, world["prev"], imaps(),
                       manifest=world["manifest"])
    want = json.loads(json.dumps(world["manifest"]))
    assert IO.load_training_manifest(out) == want
    assert RIO.load_training_manifest(out) == want
    assert IO.load_training_manifest(str(tmp_path)) is None
    prev = world["prev"].coordinates["re"]
    for loaded in (IO.load_game_model(out, device=CPU)[0],
                   RIO.load_game_model(out)[0]):
        lre = loaded.coordinates["re"]
        pid = prev.dense_ids(np.asarray(lre.entity_keys))
        np.testing.assert_array_equal(_np(lre.coefficients),
                                      _np(prev.coefficients)[pid])
        np.testing.assert_array_equal(_np(lre.variances),
                                      _np(prev.variances)[pid])


# --------------------------------------------------------------------- delta
def _same_plan(got, want):
    assert set(got.coordinates) == set(want.coordinates)
    for name, g in got.coordinates.items():
        w = want.coordinates[name]
        np.testing.assert_array_equal(g.touched_keys, w.touched_keys)
        np.testing.assert_array_equal(g.new_keys, w.new_keys)
        assert (g.name, g.entity_name, g.n_touched_rows) == (
            w.name, w.entity_name, w.n_touched_rows)
    assert (got.n_drop_rows, got.n_prev_rows, got.n_touched) == (
        want.n_drop_rows, want.n_prev_rows, want.n_touched)


def test_delta_drop_matches_reference(world):
    cp = world["plan"].coordinates["re"]
    assert sorted(cp.touched_keys.tolist()) == sorted(
        str(k) for k in TOUCHED.tolist())
    assert cp.new_keys.tolist() == [str(E + 3)]
    assert cp.n_touched_rows == 128 and not world["plan"].is_empty()
    _same_plan(world["plan"], world["ref_plan"])


def test_new_key_deferral_is_counted_and_logged(world, caplog):
    telemetry.reset()
    with caplog.at_level(logging.INFO, logger="photon_tpu.continual"):
        C.diff_manifest(world["manifest"], world["drop"], world["prev"])
    assert telemetry.snapshot()["counters"][
        "continual.deferred_new_keys"] == 1.0
    msgs = [r.getMessage() for r in caplog.records
            if r.name == "photon_tpu.continual"]
    assert any("deferring 1 new" in m and "'re'" in m for m in msgs), msgs
    # a drop with NO new keys stays silent and uncounted
    caplog.clear()
    telemetry.reset()
    with caplog.at_level(logging.INFO, logger="photon_tpu.continual"):
        plan = C.diff_manifest(world["manifest"], world["data"],
                               world["prev"], full=True)
    assert "continual.deferred_new_keys" not in telemetry.snapshot()[
        "counters"]
    assert not [r for r in caplog.records if r.name == "photon_tpu.continual"]
    assert plan.is_empty()


def test_full_drop_touches_changed_only(world):
    rng = np.random.default_rng(9)
    extra = 8
    data = world["data"]
    ent_f = np.concatenate([np.asarray(data.entity_ids["e"]),
                            np.full(extra, 5)])
    y = np.concatenate([data.y, np.zeros(extra, np.float32)])
    shards = {"fx": np.vstack([data.shards["fx"], rng.normal(
                  size=(extra, DF)).astype(np.float32)]),
              "rs": np.vstack([data.shards["rs"], rng.normal(
                  size=(extra, DR)).astype(np.float32)])}
    ref_full, full = data_pair(y, shards, ent_f)
    plan = C.diff_manifest(world["manifest"], full, world["prev"], full=True)
    assert plan.coordinates["re"].touched_keys.tolist() == ["5"]
    _same_plan(plan, RC.diff_manifest(world["ref_manifest"], ref_full,
                                      world["ref_prev"], full=True))


def test_manifest_refusals(world):
    bad = dict(world["manifest"], version=99)
    with pytest.raises(ValueError, match="newer"):
        C.diff_manifest(bad, world["drop"], world["prev"])
    with pytest.raises(KeyError, match="retrain fully"):
        C.diff_manifest({"version": 1, "n_rows": 1, "entities": {}},
                        world["drop"], world["prev"])


# ------------------------------------------------------------------- refresh
def _same_refresh(ref_res, res, touched_rows, prev):
    """Untouched rows and the fixed effect bit for bit; touched rows and
    every stats field against the reference's refresh."""
    got, want = res.model.coordinates["re"], ref_res.model.coordinates["re"]
    pc = prev.coordinates["re"]
    untouched = np.setdiff1d(np.arange(pc.n_entities), touched_rows)
    for a, b in ((got.coefficients, pc.coefficients),
                 (got.variances, pc.variances)):
        np.testing.assert_array_equal(_np(a)[untouched], _np(b)[untouched])
    assert (_np(got.coefficients)[touched_rows]
            != _np(pc.coefficients)[touched_rows]).any()
    np.testing.assert_allclose(_np(got.coefficients), _np(want.coefficients),
                               rtol=W_RTOL, atol=W_ATOL)
    np.testing.assert_allclose(_np(got.variances), _np(want.variances),
                               rtol=W_RTOL, atol=W_ATOL)
    assert dataclasses.asdict(res.stats["re"]) == dataclasses.asdict(
        ref_res.stats["re"])
    np.testing.assert_array_equal(
        _np(res.model.coordinates["fixed"].model.coefficients.means),
        _np(prev.coordinates["fixed"].model.coefficients.means))


def test_refresh_matches_reference(world, refreshed):
    ref_res, res = refreshed
    _same_refresh(ref_res, res, TOUCHED, world["prev"])
    st = res.stats["re"]
    assert (st.n_touched, st.n_deferred_new, st.n_failed) == (4, 1, 0)
    assert res.failed_keys["re"].size == 0
    assert st.n_converged == 4 and st.solve_dispatches == \
        st.buckets_touched >= 1


def test_refresh_from_saved_model_alone(world, refreshed, tmp_path):
    """Coefficients, variances and manifest round-trip through disk, and
    the refresh built from the saved directory alone equals the in-memory
    one bit for bit (aligned by key: the loader sorts keys as strings)."""
    out = str(tmp_path / "saved")
    IO.save_game_model(out, world["prev"], imaps(),
                       manifest=world["manifest"])
    loaded, _ = IO.load_game_model(out, device=CPU)
    plan = C.diff_manifest(IO.load_training_manifest(out), world["drop"],
                           loaded)
    got = C.refresh_game_model(loaded, world["drop"], plan, {"re": CFG_R[1]})
    got_re = got.model.coordinates["re"]
    want_re = refreshed[1].model.coordinates["re"]
    pid = want_re.dense_ids(np.asarray(got_re.entity_keys))
    np.testing.assert_array_equal(_np(got_re.coefficients),
                                  _np(want_re.coefficients)[pid])
    np.testing.assert_array_equal(_np(got_re.variances),
                                  _np(want_re.variances)[pid])


def test_repeat_refresh_adds_no_signatures(world, refreshed):
    """A drop with another touched set and row count whose buckets pad to
    the same targets (2 entities of 24 rows: the m = 32 bucket, padded to
    64 lanes, like the world's 4 entities of 32) records no new solve
    signature, and no argument drifts off f32."""
    baseline = len(C.RefreshResult.signatures())
    assert baseline >= 1
    rng = np.random.default_rng(13)
    ent3 = np.repeat(TOUCHED[:2], 24)
    _, drop3 = data_pair(
        np.zeros(ent3.shape[0], np.float32),
        {"fx": rng.normal(size=(ent3.shape[0], DF)).astype(np.float32),
         "rs": rng.normal(size=(ent3.shape[0], DR)).astype(np.float32)},
        ent3)
    plan3 = C.diff_manifest(world["manifest"], drop3, world["prev"])
    assert plan3.n_touched == 2
    C.refresh_game_model(world["prev"], drop3, plan3, {"re": CFG_R[1]})
    assert C.RefreshResult.assert_no_retrace(baseline) == baseline


def test_refresh_refusals(world):
    with pytest.raises(KeyError, match="OptimizerConfig"):
        C.refresh_game_model(world["prev"], world["drop"], world["plan"], {})
    from photon_tpu_torch.game.projector import (ProjectionConfig,
                                                 ProjectorType)

    projected = RandomEffectConfig("e", "rs", CFG_R[1], projection=(
        ProjectionConfig(ProjectorType.INDEX_MAP, 3)))
    with pytest.raises(ValueError, match="projected"):
        C.refresh_game_model(world["prev"], world["drop"], world["plan"],
                             {"re": projected})
    # the estimator's unprojected config stands for its optimizer
    res = C.refresh_game_model(world["prev"], world["drop"], world["plan"],
                               {"re": RandomEffectConfig("e", "rs",
                                                         CFG_R[1])})
    assert res.stats["re"].n_touched == 4
    # the mesh refresh is ported (tests/test_torch_mesh_item10.py); a
    # mesh must be one
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        C.refresh_game_model(world["prev"], world["drop"], world["plan"],
                             {"re": CFG_R[1]}, mesh=object())


@pytest.mark.parametrize("opt", ["lbfgs", "owlqn", "tron"])
def test_sparse_refresh_matches_reference(opt):
    """A sparse (`SparseRows`) per-entity shard: the refresh gathers the
    padded-COO lanes and their column plan; held against the reference on
    each optimizer (OWL-QN on an elastic net)."""
    w = _world(sparse=True)
    reg = "en" if opt == "owlqn" else "l2"
    rcfg, pcfg = cfg_pair("lbfgs" if opt == "owlqn" else opt, reg=reg)
    ref_res = RC.refresh_game_model(w["ref_prev"], w["ref_drop"],
                                    w["ref_plan"], {"re": rcfg})
    res = C.refresh_game_model(w["prev"], w["drop"], w["plan"], {"re": pcfg})
    _same_refresh(ref_res, res, TOUCHED, w["prev"])


def test_failed_entity_is_reported_as_the_reference_fails_it():
    """ROADMAP §C12: a one-row entity predicted at margin ~7.5 (loss
    softplus(z) - y·z cancels to ~5.6e-4 with an absolute error of
    ulp(7.5)) starts at its prior mean; its first step's true decrease is
    ~1.7e-8, below that error, so the line search fails — in both
    packages, at tolerance 1e-3. The port names it in `failed_keys`."""
    rng = np.random.default_rng(0)
    for _ in range(121):  # the 121st draw of this generator is such a row
        x = rng.normal(size=(1, 4)).astype(np.float32)
        pm = rng.normal(size=4).astype(np.float32)
        tau = rng.uniform(10, 40, size=4).astype(np.float32)
        off = np.asarray([rng.normal() * 2], np.float32)
    y = np.asarray([1.0 if float((x @ pm)[0]) > 0 else 0.0], np.float32)
    keys = np.asarray([0, 1])
    C_prev = np.stack([pm, pm]).astype(np.float32)
    ref_prev, prev = model_pair(np.zeros(DF, np.float32), C_prev,
                                np.stack([1 / tau, 1 / tau]), keys)
    shards = {"fx": np.zeros((1, DF), np.float32), "rs": x}
    ref_drop, drop = (GDm.GameData.build(y, sh, {"e": np.asarray([1])},
                                         offsets=off)
                      for GDm, sh in ((RGD, shards), (GD, shards)))
    manifest = {"version": 1, "n_rows": 2, "entities": {"e": {"0": 1,
                                                              "1": 1}}}
    res = C.refresh_game_model(prev, drop, C.diff_manifest(
        manifest, drop, prev), {"re": CFG_R[1]})
    ref_res = RC.refresh_game_model(ref_prev, ref_drop, RC.diff_manifest(
        manifest, ref_drop, ref_prev), {"re": CFG_R[0]})
    assert dataclasses.asdict(res.stats["re"]) == dataclasses.asdict(
        ref_res.stats["re"])
    assert res.stats["re"].n_failed == 1
    assert res.failed_keys["re"].tolist() == [1]


def _one_entity_block(world, opt, sparse):
    """The world's drop bucketed on the CPU, one touched entity of its
    bucket gathered and padded to REFRESH_LANES lanes, through the
    coordinate's lane solvers with priors and warm start."""
    w = _world(sparse=True) if sparse else world
    reg = "en" if opt == "owlqn" else "l2"
    _, cfg = cfg_pair("lbfgs" if opt == "owlqn" else opt, reg=reg)
    cm = w["prev"].coordinates["re"]
    ds = GD.RandomEffectDataset.build(w["drop"], "e", "rs", device=CPU)
    block = max(ds.blocks, key=lambda b: b.n_entities)
    coord = RE.RandomEffectCoordinate(ds, TaskType.LOGISTIC_REGRESSION, cfg)
    offsets = torch.zeros(w["drop"].n)
    pid = cm.dense_ids(ds.entity_keys)[block.entity_index]
    pm, pp = RE.align_entity_priors(cm, ds.entity_keys[block.entity_index],
                                    cm.dim)
    w0 = _np(cm.coeffs_for(pid))
    keys = ds.entity_keys[block.entity_index].astype(str)
    lanes = np.nonzero(np.isin(keys, TOUCHED.astype(str)))[0][:1]
    pad = C.REFRESH_LANES
    batch = RE.take_lanes(ds.block_batch(block, offsets), lanes, pad)
    W0, P0, P1 = (t.t().contiguous() for t in PM.compact_rows(
        tuple(torch.from_numpy(a) for a in (w0, pm, pp)), lanes,
        pad_rows=pad))
    return coord, block, batch, (W0, P0, P1)


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("opt", ["lbfgs", "owlqn", "tron"])
def test_zero_lanes_converge_at_iteration_zero(world, opt, sparse):
    """One touched entity padded to 64 lanes: the 63 zero lanes (weight-0
    rows, start 0, prior precision 0) have a zero gradient and converge at
    iteration 0 — no NaN, none failed, coefficients 0 — and the real lane
    equals its solve alone."""
    coord, block, batch, (W0, P0, P1) = _one_entity_block(world, opt, sparse)
    res, _ = coord.solve_lanes(coord.block_objective(block), batch, W0, P0,
                               P1)
    its, conv, fail = (_np(t) for t in (res.iterations, res.converged,
                                        res.failed))
    assert its.shape == (C.REFRESH_LANES,)
    assert (its[1:] == 0).all() and conv[1:].all() and not fail.any()
    assert np.isfinite(_np(res.w)).all() and (_np(res.w)[1:] == 0).all()
    assert its[0] > 0
    alone, _ = coord.solve_lanes(
        coord.block_objective(block),
        RE.take_lanes(batch, [0]), W0[:, :1].contiguous(),
        P0[:, :1].contiguous(), P1[:, :1].contiguous())
    assert int(alone.iterations[0]) == int(its[0])
    np.testing.assert_allclose(_np(alone.w)[0], _np(res.w)[0], rtol=1e-5,
                               atol=1e-6)


def test_refresh_does_not_depend_on_chunking(world, refreshed, monkeypatch):
    """A touched entity's result is the same whether its padded block
    solves as one chunk or in chunks of 8 lanes."""
    one = refreshed[1].model.coordinates["re"]
    monkeypatch.setattr(RE, "LANE_ELEMS", 8 * 32)  # m = 32: 8-lane chunks
    assert RE.lane_chunk(32, 64) == 8
    many = C.refresh_game_model(world["prev"], world["drop"], world["plan"],
                                {"re": CFG_R[1]})
    got = many.model.coordinates["re"]
    np.testing.assert_allclose(_np(got.coefficients), _np(one.coefficients),
                               rtol=1e-5, atol=1e-6)
    assert many.stats["re"] == refreshed[1].stats["re"]


# ---------------------------------------------------------------------- swap
def _stores(world, refreshed):
    live = CoefficientStore.from_game_model(world["prev"], device=CPU)
    new = CoefficientStore.from_game_model(refreshed[1].model, device=CPU)
    return live, new


def test_publish_open_and_sweep(world, refreshed, tmp_path):
    root = str(tmp_path / "serve")
    live, new = _stores(world, refreshed)
    assert SW.current_version(root) is None
    with pytest.raises(FileNotFoundError):
        C.open_current(root, device=CPU)
    v0 = C.publish_store(root, live)
    v1 = C.publish_store(root, new)
    store, v = C.open_current(root, device=CPU)
    assert (v0, v1, v) == (0, 1, 1)
    np.testing.assert_array_equal(store.random["re"].coefficients,
                                  new.random["re"].coefficients)
    v2 = C.publish_store(root, live)
    assert v2 == 2 and not os.path.isdir(os.path.join(root, "v00000000"))


def test_versions_open_across_packages(world, refreshed, tmp_path):
    """A version the port publishes opens with the reference's
    `open_current`, and the reference's with the port's (both stores are
    `photon_tpu-serving-store-v1`)."""
    live, new = _stores(world, refreshed)
    root = str(tmp_path / "port")
    C.publish_store(root, new)
    rstore, v = RSW.open_current(root)
    assert v == 0
    for name in ("fixed",):
        np.testing.assert_array_equal(np.asarray(rstore.fixed[name].weights),
                                      new.fixed[name].weights)
    np.testing.assert_array_equal(np.asarray(rstore.random["re"]
                                             .coefficients),
                                  new.random["re"].coefficients)
    root2 = str(tmp_path / "ref")
    RC.publish_store(root2, RStore.from_game_model(world["ref_prev"]))
    pstore, v = C.open_current(root2, device=CPU)
    assert v == 0
    np.testing.assert_array_equal(pstore.random["re"].coefficients,
                                  live.random["re"].coefficients)


def test_kill_mid_swap_leaves_old_model_serving(world, refreshed, tmp_path):
    root = str(tmp_path / "serve")
    live, new = _stores(world, refreshed)
    C.publish_store(root, live)
    before = np.array(C.open_current(root, device=CPU)[0]
                      .random["re"].coefficients)
    for site, occ in (("swap_publish", 1), ("commit", 1), ("commit", 2)):
        with pytest.raises(InjectedFault):
            with fault_plan(FaultPlan.kill_at(site, occ)):
                C.hot_swap(None, new, root=root, probe=None)
        after, v = C.open_current(root, device=CPU)
        assert v == 0, (site, occ)
        np.testing.assert_array_equal(after.random["re"].coefficients,
                                      before, err_msg=f"{site}#{occ}")
    # the publish that is not killed completes from the same state (the
    # killed attempts' orphan directories only advance the numbering)
    out = C.hot_swap(None, new, root=root, probe=None)
    store, v = C.open_current(root, device=CPU)
    assert v == out["version"] > 0
    np.testing.assert_array_equal(store.random["re"].coefficients,
                                  new.random["re"].coefficients)


def test_probe_refuses_blown_up_model(world, refreshed):
    live, new = _stores(world, refreshed)
    broken = CoefficientStore.from_game_model(world["prev"], device=CPU)
    broken.random["re"] = dataclasses.replace(
        broken.random["re"],
        coefficients=broken.random["re"].coefficients + 1e6)
    telemetry.reset()
    with pytest.raises(C.SwapRefused):
        C.hot_swap(live, broken, probe=C.ParityProbe(bound=1.0))
    counters = telemetry.snapshot()["counters"]
    assert counters.get("continual.swap_refusals") == 1
    assert "serving.hot_swaps" not in counters
    np.testing.assert_array_equal(
        live.random["re"].coefficients[:-1],
        _np(world["prev"].coordinates["re"].coefficients))
    out = C.hot_swap(live, new, probe=C.ParityProbe(bound=1e3))
    assert out["report"].ok
    assert telemetry.snapshot()["counters"].get("serving.hot_swaps") == 1
    np.testing.assert_array_equal(live.random["re"].coefficients,
                                  new.random["re"].coefficients)


def test_staleness_gauge_rides_the_swap(world, refreshed):
    import time

    live, new = _stores(world, refreshed)
    changed = time.time() - 5.0
    telemetry.reset()
    out = C.hot_swap(live, new, probe=C.ParityProbe(bound=1e3),
                     rows_changed_unix=changed)
    assert 5.0 <= out["staleness_s"] < 60.0
    gauges = telemetry.snapshot()["gauges"]
    assert gauges["continual.staleness_s"] == pytest.approx(
        out["staleness_s"])
    live2, new2 = _stores(world, refreshed)
    out2 = C.hot_swap(live2, new2, probe=C.ParityProbe(bound=1e3))
    assert out2["staleness_s"] is None
    assert telemetry.snapshot()["gauges"]["continual.staleness_s"] == \
        gauges["continual.staleness_s"]


@pytest.mark.parametrize("sample", [5, 64])
def test_parity_probe_matches_reference(world, refreshed, sample):
    """The probe of the same old and new stores (the port's refresh as
    arrays in both packages) reads the same worst delta."""
    new = refreshed[1].model
    arrays = (_np(new.coordinates["fixed"].model.coefficients.means),
              _np(new.coordinates["re"].coefficients),
              _np(new.coordinates["re"].variances), np.arange(E))
    ref_new, port_new = model_pair(*arrays)
    probe = dict(sample=sample, bound=0.5, seed=3,
                 exclude=frozenset({"3"}))
    got = C.parity_probe(
        CoefficientStore.from_game_model(world["prev"], device=CPU),
        CoefficientStore.from_game_model(port_new, device=CPU),
        C.ParityProbe(**probe))
    want = RC.parity_probe(RStore.from_game_model(world["ref_prev"]),
                           RStore.from_game_model(ref_new),
                           RC.ParityProbe(**probe))
    assert got.n_probes == want.n_probes
    assert got.max_abs_delta == pytest.approx(want.max_abs_delta, abs=1e-9)
    assert got.ok == want.ok
    assert got.max_abs_delta > 0 or sample < E  # all 23 probed: 3 moved


# ---------------------------------------------------------------- compaction
@pytest.mark.parametrize("pad_rows", [None, 4, 16])
def test_compact_rows_matches_reference(pad_rows):
    rng = np.random.default_rng(4)
    a = rng.normal(size=(10, 3)).astype(np.float32)
    b = rng.integers(0, 9, size=(10, 2, 2)).astype(np.int32)
    c = rng.normal(size=10).astype(np.float32)
    idx = np.asarray([7, 2, 2, 9], np.int32)
    got = PM.compact_rows({"a": torch.from_numpy(a), "bc": (
        torch.from_numpy(b), torch.from_numpy(c))}, idx, pad_rows=pad_rows)
    want = RMesh.compact_rows({"a": jnp.asarray(a), "bc": (
        jnp.asarray(b), jnp.asarray(c))}, jnp.asarray(idx),
        pad_rows=pad_rows)
    for g, w in ((got["a"], want["a"]), (got["bc"][0], want["bc"][0]),
                 (got["bc"][1], want["bc"][1])):
        assert str(g.dtype).split(".")[-1] == str(np.asarray(w).dtype)
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    for n, m in ((0, 8), (5, 8), (8, 8), (9, 64), (65, 64)):
        assert PM.pad_to_multiple(n, m) == RMesh.pad_to_multiple(n, m)


def test_mesh_parts_raise_with_their_item():
    """The whole mesh module is ported: the hybrid replica x data mesh
    (tests/test_torch_mesh_item10.py holds it against the reference) and
    `compact_rows` onto a mesh, which shards the block over its slots
    (tests/test_torch_mesh.py holds the rest)."""
    assert PM.make_hybrid_mesh(n_devices=2, device="cpu").shape == (1, 2)
    mesh = PM.make_mesh(n_devices=2, device="cpu")
    got = PM.compact_rows((torch.arange(6.0),), [4, 0], mesh=mesh)[0]
    assert torch.equal(got.local(), torch.tensor([4.0, 0.0]))
    with pytest.raises(AttributeError):
        PM.no_such_name  # noqa: B018
    with pytest.raises(AttributeError):
        PM.data_sharding  # noqa: B018


@pytest.mark.parametrize("sparse", [False, True])
def test_entity_blocks_take(sparse):
    """`EntityBlocks.take` gives the block of the gathered lanes with zero
    lanes after them: equal to a block built from those tensors (its
    column plan gathered, not rebuilt, equal to the rebuilt one), and its
    lane passes equal the source's on the taken lanes."""
    rng = np.random.default_rng(8)
    m, k, Eb, d = 8, 3, 11, 9
    if sparse:
        ind = rng.integers(0, d, size=(m, k, Eb))
        val = rng.normal(size=(m, k, Eb)).astype(np.float32)
        X = M.EntityBlocks(None, torch.from_numpy(ind),
                           torch.from_numpy(val), d)
    else:
        dense = rng.normal(size=(m, d, Eb)).astype(np.float32)
        X = M.EntityBlocks(torch.from_numpy(dense), None, None, d)
    idx = np.asarray([6, 0, 9])
    got = X.take(idx, 64)
    pad = [(0, 0), (0, 0), (0, 64 - idx.size)]
    if sparse:
        want = M.EntityBlocks(None, torch.from_numpy(np.pad(ind[..., idx],
                                                            pad)),
                              torch.from_numpy(np.pad(val[..., idx], pad)),
                              d)
        for g, w in zip(got.segments, want.segments):
            assert torch.equal(g, w)
        assert torch.equal(got.indices, want.indices)
    else:
        want = M.EntityBlocks(torch.from_numpy(np.pad(dense[..., idx], pad)),
                              None, None, d)
        assert torch.equal(got.dense, want.dense)
    R = torch.from_numpy(rng.normal(size=(m, 64)).astype(np.float32))
    W = torch.from_numpy(rng.normal(size=(d, 64)).astype(np.float32))
    assert torch.equal(got.rmatvec_lanes(R), want.rmatvec_lanes(R))
    assert torch.equal(got.matvec_lanes(W), want.matvec_lanes(W))
    assert (got.rmatvec_lanes(R)[:, 3:] == 0).all()
    Rs = R[:, :Eb].contiguous()
    np.testing.assert_allclose(
        _np(X.take(idx).rmatvec_lanes(Rs[:, idx].contiguous())),
        _np(X.rmatvec_lanes(Rs))[:, idx], rtol=1e-6, atol=1e-6)
