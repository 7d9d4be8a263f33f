"""The port's lane tuner against the JAX package's, on the CPU.

`compact_rows` zero and edge padding on the reference test's halving
cases (bit for bit), `pad_proposals`, the modeled round cost
(`profiling.model.lane_grid_cost` within 2x of the reference's jaxpr
estimate on the selftest problem, the same admit/refuse under the default
budget and a starved one), one lane round in both packages (the same
proposals, per-lane screen and full-depth metrics within 1e-4, the same
survivors and winner), the signature log across tunes, the selftest, and
the training driver's ``tuning_iters`` on the drivers' test job.
"""
import jax.core
import jax.extend.core

# The JAX package imports `jax.core.ClosedJaxpr`/`Jaxpr`, which jax 0.9
# moved to `jax.extend.core`: alias the missing public names back before
# anything of photon_tpu is imported.
for _name in dir(jax.extend.core):
    if not _name.startswith("_") and not hasattr(jax.core, _name):
        setattr(jax.core, _name, getattr(jax.extend.core, _name))

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from photon_tpu import drivers as RD  # noqa: E402
from photon_tpu.data.dataset import make_batch as r_make_batch  # noqa: E402
from photon_tpu.ops.losses import TaskType as RTask  # noqa: E402
from photon_tpu.optim.config import OptimizerConfig as RConfig  # noqa: E402
from photon_tpu.optim.regularization import l2 as r_l2  # noqa: E402
from photon_tpu.parallel.mesh import compact_rows as r_compact  # noqa: E402
from photon_tpu.tuning import lane_tuner as RL  # noqa: E402

from photon_tpu_torch import drivers as PD  # noqa: E402
from photon_tpu_torch import telemetry  # noqa: E402
from photon_tpu_torch.data.dataset import make_batch  # noqa: E402
from photon_tpu_torch.data.matrix import (SparseRows,  # noqa: E402
                                          to_blocked_ell)
from photon_tpu_torch.kernels import blocked_ell as KB  # noqa: E402
from photon_tpu_torch.ops.losses import TaskType  # noqa: E402
from photon_tpu_torch.optim.config import OptimizerConfig  # noqa: E402
from photon_tpu_torch.optim.regularization import l2  # noqa: E402
from photon_tpu_torch.parallel.mesh import compact_rows  # noqa: E402
from photon_tpu_torch.profiling.model import lane_grid_cost  # noqa: E402
from photon_tpu_torch.tuning import __main__ as tuning_cli  # noqa: E402
from photon_tpu_torch.tuning import lane_tuner as PL  # noqa: E402
from test_torch_drivers import (COORDINATES, SHARDS,  # noqa: E402
                                write_game_avro)

CPU = "cpu"
TASK, RTASK = TaskType.LOGISTIC_REGRESSION, RTask.LOGISTIC_REGRESSION


# --------------------------------------------------------- compact_rows
def _both_compact(x, idx, **kw):
    want = np.asarray(r_compact(x, np.asarray(idx, np.int32), **kw))
    got = compact_rows(torch.from_numpy(x), np.asarray(idx, np.int64), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    return got.numpy()


@pytest.mark.parametrize("case", [
    "zero_survivors", "all_survivors", "non_pow2_zero", "non_pow2_edge",
    "edge_to_height", "tree"])
def test_compact_rows_zero_and_edge_match_reference(case):
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    idx = [1, 6, 3]
    if case == "zero_survivors":
        out = _both_compact(x[:6], np.zeros((0,), np.int64), pad_rows=4)
        assert (out == 0.0).all() and out.shape == (4, 4)
    elif case == "all_survivors":
        _both_compact(x[:5], np.arange(5))
    elif case == "non_pow2_zero":
        out = _both_compact(x, idx, pad_rows=4)
        assert (out[3] == 0.0).all()
    elif case == "non_pow2_edge":
        out = _both_compact(x, idx, pad_rows=4, pad_mode="edge")
        np.testing.assert_array_equal(out[3], x[3])  # the last gathered
    elif case == "edge_to_height":
        out = _both_compact(x, [5], pad_rows=8, pad_mode="edge")
        assert (out == x[5]).all()
    else:  # every leaf of a tree, edge-padded alike
        t = {"w": torch.from_numpy(x), "v": torch.arange(8.0)}
        got = compact_rows(t, [2, 7], pad_rows=4, pad_mode="edge")
        np.testing.assert_array_equal(got["v"].numpy(), [2.0, 7.0, 7.0, 7.0])
        np.testing.assert_array_equal(got["w"].numpy(),
                                      x[[2, 7, 7, 7]])


def test_compact_rows_edge_refusals():
    with pytest.raises(ValueError, match="at least one"):
        compact_rows(torch.ones(6, 4), np.zeros((0,), np.int64), pad_rows=4,
                     pad_mode="edge")
    with pytest.raises(ValueError, match="pad_mode"):
        compact_rows(torch.ones(4, 2), [0], pad_mode="mirror")


def test_pad_proposals_matches_reference():
    for ws, chunk in (([0.5], 4), ([1.0, 2.0, 3.0], 8), ([7.0] * 8, 8)):
        assert PL.pad_proposals(ws, chunk) == RL.pad_proposals(ws, chunk)
    for bad in (([], 4), ([1.0] * 5, 4)):
        with pytest.raises(ValueError):
            PL.pad_proposals(*bad)
        with pytest.raises(ValueError):
            RL.pad_proposals(*bad)


# ------------------------------------------------------- the selftest problem
def _selftest_problem():
    """The reference selftest's problem (`photon_tpu/tuning/__main__.py`):
    512 × 16 logistic, 32 iterations, history 5."""
    rng = np.random.default_rng(16)
    n, d = 512, 16
    w_true = rng.normal(size=d)
    Xtr = rng.normal(size=(n, d)).astype(np.float32)
    ytr = (Xtr @ w_true + 0.5 * rng.normal(size=n) > 0).astype(np.float32)
    Xv = rng.normal(size=(n, d)).astype(np.float32)
    yv = (Xv @ w_true + 0.5 * rng.normal(size=n) > 0).astype(np.float32)
    return Xtr, ytr, Xv, yv


def test_lane_grid_cost_against_reference_estimate():
    Xtr, ytr, _, _ = _selftest_problem()
    cfg_r = RConfig(max_iters=4, reg=r_l2(), history=5)
    cfg_p = OptimizerConfig(max_iters=4, reg=l2(), history=5)
    rb, pb = r_make_batch(Xtr, ytr), make_batch(Xtr, ytr, device=CPU)
    padded = RL.pad_proposals([0.1, 1.0, 10.0], 8)
    want = RL._lane_grid_cost(rb, RTASK, cfg_r, padded, None)
    got = lane_grid_cost(pb, TASK, cfg_p, 8, None)
    assert 0.5 <= got.flops / want.flops <= 2.0, (got.flops, want.flops)
    assert got.collective_bytes == want.collective_bytes == 0
    assert got.bytes > 0 and lane_grid_cost(pb, TASK, cfg_p, 8) is got
    for budget in (RL.LaneBudget(), RL.LaneBudget(max_round_flops=10.0),
                   RL.LaneBudget(cost_factor=1.0)):
        outcomes = []
        for enforce, cost, b in ((RL._enforce_budget, want, rb),
                                 (PL._enforce_budget, got, pb)):
            try:
                enforce(cost, b, 16, 8, 4, PL.LaneBudget(
                    **dataclasses.asdict(budget)), None)
                outcomes.append("admit")
            except (RL.RoundBudgetError, PL.RoundBudgetError):
                outcomes.append("refuse")
        assert outcomes[0] == outcomes[1], (budget, outcomes)
    # a mesh is priced with the reductions an evaluation makes
    from photon_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n_devices=2, device=CPU)
    assert lane_grid_cost(pb, TASK, cfg_p, 8, mesh).collective_bytes > 0


def test_lane_grid_cost_prices_the_layout():
    rng = np.random.default_rng(3)
    n, d, k = 256, 400, 6
    ind = np.concatenate([(rng.zipf(1.4, (n, k)) - 1) % (d - 1),
                          np.full((n, 1), d - 1)], 1).astype(np.int32)
    val = np.concatenate([rng.normal(size=(n, k)), np.ones((n, 1))],
                         1).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    cfg = OptimizerConfig(max_iters=5, reg=l2(), history=4)
    sparse = make_batch(SparseRows(ind, val, d), y, device=CPU)
    bell = make_batch(to_blocked_ell(SparseRows(ind, val, d), 16,
                                     device=CPU), y, device=CPU)
    dense = make_batch(np.zeros((n, d), np.float32), y, device=CPU)
    c_s, c_b, c_d = (lane_grid_cost(b, TASK, cfg, 4)
                     for b in (sparse, bell, dense))
    # the passes price the stored slots: k + 1 a row, the hot block and
    # the tail's slots, all d columns
    assert c_s.dot_flops < c_b.dot_flops < c_d.dot_flops
    assert c_s.gather_bytes > 0 and c_d.gather_bytes == 0


# --------------------------------------------------------- one lane round
def _record_scores(monkeypatch, module) -> list:
    seen = []
    real = module._lane_scores

    def spy(W, val_batch, evaluator, n_real):
        ys = real(W, val_batch, evaluator, n_real)
        seen.append(np.asarray(ys))
        return ys

    monkeypatch.setattr(module, "_lane_scores", spy)
    return seen


@pytest.fixture(scope="module")
def one_round():
    """One 8-lane round (no GP) in each package on the selftest problem,
    with every per-lane metric recorded."""
    Xtr, ytr, Xv, yv = _selftest_problem()
    mp = pytest.MonkeyPatch()
    try:
        seen_r = _record_scores(mp, RL)
        seen_p = _record_scores(mp, PL)
        _, w_r, res_r = RL.tune_glm_reg_lanes(
            r_make_batch(Xtr, ytr), RTASK,
            RConfig(max_iters=32, reg=r_l2(), history=5),
            r_make_batch(Xv, yv), n_configs=8, lane_chunk=8, seed=0)
        cfg = OptimizerConfig(max_iters=32, reg=l2(), history=5)
        train = make_batch(Xtr, ytr, device=CPU)
        val = make_batch(Xv, yv, device=CPU)
        base = PL.LaneTuningResult.signature_count()
        model, w_p, res_p = PL.tune_glm_reg_lanes(
            train, TASK, cfg, val, n_configs=8, lane_chunk=8, seed=0)
    finally:
        mp.undo()
    return dict(r=(w_r, res_r, seen_r), p=(w_p, res_p, seen_p, model),
                train=train, val=val, cfg=cfg, base=base)


def test_one_round_matches_reference(one_round):
    w_r, res_r, seen_r = one_round["r"]
    w_p, res_p, seen_p, model = one_round["p"]
    np.testing.assert_array_equal(res_p.xs, res_r.xs)
    assert len(seen_p) == len(seen_r) == 2  # the screen, the re-solve
    np.testing.assert_allclose(seen_p[0], seen_r[0], atol=1e-4)
    np.testing.assert_allclose(seen_p[1], seen_r[1], atol=1e-4)
    np.testing.assert_array_equal(np.argsort(seen_p[0], kind="stable")[:2],
                                  np.argsort(seen_r[0], kind="stable")[:2])
    assert w_p == w_r
    assert res_p.best_y == pytest.approx(res_r.best_y, abs=1e-4)
    rp, rr = res_p.rounds[0], res_r.rounds[0]
    assert (rp.n_proposed, rp.n_survivors, rp.screen_iters) == \
        (rr.n_proposed, rr.n_survivors, rr.screen_iters) == (8, 2, 4)
    assert rp.modeled_collective_bytes == 0 and rp.modeled_flops > 0
    assert model.coefficients.means.shape == (16,)


def test_signatures_across_tunes(one_round):
    train, val, cfg, base = (one_round[k]
                             for k in ("train", "val", "cfg", "base"))
    n = PL.LaneTuningResult.assert_no_retrace(base + 2)
    # a two-round tune (a GP round) of the same shapes adds none
    _, _, res = PL.tune_glm_reg_lanes(train, TASK, cfg, val, n_configs=16,
                                      lane_chunk=8, seed=3)
    assert len(res.rounds) == 2 and (np.diff(res.history()) <= 1e-12).all()
    assert PL.LaneTuningResult.assert_no_retrace(n) == n
    with pytest.raises(AssertionError, match="new shapes"):
        PL.LaneTuningResult.assert_no_retrace(n - 1)
    with pytest.raises(ValueError, match="pow2"):
        PL.tune_glm_reg_lanes(train, TASK, cfg, val, n_configs=12,
                              lane_chunk=6)
    with pytest.raises(ValueError, match="lane chunk"):
        PL.tune_glm_reg_lanes(train, TASK, cfg, val, n_configs=4,
                              lane_chunk=8)
    with pytest.raises(PL.RoundBudgetError):
        PL.tune_glm_reg_lanes(train, TASK, cfg, val, n_configs=8,
                              lane_chunk=8,
                              budget=PL.LaneBudget(max_round_flops=10.0))


def test_float_drift_reads_the_signature_format():
    # the lane tuner's and the continual refresh's dtype-drift checks read
    # `telemetry.run.signature`'s ("tensor", shape, dtype, device) leaves
    from photon_tpu_torch.continual.refresh import RefreshResult
    from photon_tpu_torch.telemetry.run import float_drift, signature

    sig = signature((torch.zeros(2, dtype=torch.bfloat16), torch.zeros(2),
                     np.zeros(2), [torch.zeros(1, dtype=torch.float64)],
                     torch.zeros(3, dtype=torch.int32), 4, "x"))
    assert sorted(float_drift(sig)) == ["float64", "torch.bfloat16",
                                        "torch.float64"]
    assert float_drift(signature((torch.zeros(2), np.zeros(2, np.float32),
                                  3, None))) == []
    assert RefreshResult.assert_no_retrace(10 ** 6) >= 0


def test_blocked_ell_tune_keeps_one_plan():
    rng = np.random.default_rng(5)
    n, d, k = 384, 300, 5
    w = rng.normal(size=d)

    def draw(m):
        ind = np.concatenate([(rng.zipf(1.4, (m, k)) - 1) % (d - 1),
                              np.full((m, 1), d - 1)], 1).astype(np.int32)
        val = np.concatenate([rng.normal(size=(m, k)), np.ones((m, 1))],
                             1).astype(np.float32)
        y = ((w[ind] * val).sum(1) + rng.normal(size=m) > 0)
        return ind, val, y.astype(np.float32)

    ind, val, y = draw(n)
    X = to_blocked_ell(SparseRows(ind, val, d), 16, device=CPU)
    iv, vv, yv = draw(n // 2)
    Xv = to_blocked_ell(SparseRows(iv, vv, d), 16, device=CPU)
    cfg = OptimizerConfig(max_iters=16, reg=l2(), history=4)
    before = KB.plan_builds()
    with telemetry.run("lane_tune") as run:
        _, best_w, res = PL.tune_glm_reg_lanes(
            make_batch(X, y, device=CPU), TASK, cfg,
            make_batch(Xv, yv, device=CPU), n_configs=8, lane_chunk=4,
            seed=2)
    assert KB.plan_builds() - before <= 2  # one a layout, none a round
    assert len(res.rounds) == 2 and 1e-4 <= best_w <= 1e4
    assert run.counters["tuning.rounds"] == 2
    assert run.counters["tuning.configs"] == 8
    assert run.counters["tuning.survivor_resolves"] == 2
    assert run.gauges["tuning.round_model_flops"] > 0


def test_selftest_on_cpu_exits_zero(capsys):
    assert tuning_cli.main(["--selftest", "--json", "--device", "cpu"]) == 0
    import json

    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["ok"] and set(report["checks"]) == {
        "lane_tune", "no_retrace", "gp_ladder", "qei_edges", "cost_budget",
        "telemetry", "contracts"}
    assert tuning_cli.main([]) == 2


# ------------------------------------------------- the driver's tuning_iters
def test_driver_tuning_iters_matches_reference(tmp_path):
    write_game_avro(tmp_path / "train.avro", 600, seed=1)
    write_game_avro(tmp_path / "validation.avro", 300, seed=2)
    coords = {n: {k: v for k, v in c.items() if k != "reg_weights"}
              for n, c in COORDINATES.items()}
    outs = []
    for pkg, kw in ((RD, {}), (PD, {"device": CPU})):
        params = pkg.TrainingParams(
            train_path=str(tmp_path / "train.avro"),
            validation_path=str(tmp_path / "validation.avro"),
            output_dir=str(tmp_path / pkg.__name__), feature_shards=SHARDS,
            coordinates=coords, entity_fields=["userId"], n_sweeps=2,
            tuning_iters=4, tuning_range=(1e-2, 1e2), seed=3)
        outs.append(pkg.run_training(params, **kw))
    ref, port = outs
    assert len(port.results) == len(ref.results) == 4  # the Sobol seed
    for p, r in zip(port.results, ref.results):
        assert {n: c.optimizer.reg_weight for n, c in p.configs.items()} \
            == {n: c.optimizer.reg_weight for n, c in r.configs.items()}
        assert p.validation_score == pytest.approx(r.validation_score,
                                                   abs=1e-4)
    assert port.best.validation_score == pytest.approx(
        ref.best.validation_score, abs=1e-4)
    # the reference's own refusals
    with pytest.raises(ValueError, match="regularized coordinate"):
        PD.run_training(dataclasses.replace(
            params, coordinates={n: dict(c, reg_type="none")
                                 for n, c in coords.items()}), device=CPU)
    with pytest.raises(ValueError, match="resume"):
        dataclasses.replace(params, resume=True, output_mode="ALL")
