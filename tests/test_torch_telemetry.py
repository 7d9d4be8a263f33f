"""The port's run telemetry spine (`photon_tpu_torch.telemetry`) against
the JAX package's, on the CPU.

- JSONL written by either package reads back in the other (`read_jsonl`,
  `load_report`, `repair_jsonl_tail` on a torn tail): the reports equal
  apart from times.
- `aggregate_cluster` over the same rank files (a straggler, a torn rank
  and a missing one) gives equal reports; `report_from_jsonl` gives the
  same `HealthReport` JSON and Prometheus text.
- The resident solvers' tap (L-BFGS, OWL-QN, TRON): armed, its events
  equal the port's `OptResult` histories exactly and the reference's
  armed tap events within 1e-5 (the solves' own parity bound; |g| at
  1e-5 of its starting value, as it falls to rounding level); the
  histories are bit-equal armed and off, and so is the number of
  host read-backs (one at the start, one an iteration for L-BFGS).
- The streamed solvers' and the GAME descent's iteration events, the
  training entry's signature records, the barrier span, the off state
  (nothing recorded, no read-back added) and the always-on registry's
  callers.
"""
import dataclasses
import json
import os

import jax.core
import jax.extend.core

for _name in dir(jax.extend.core):
    if not _name.startswith("_") and not hasattr(jax.core, _name):
        setattr(jax.core, _name, getattr(jax.extend.core, _name))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from photon_tpu import telemetry as RTel  # noqa: E402
from photon_tpu.data import dataset as RD  # noqa: E402
from photon_tpu.models import training as RT  # noqa: E402
from photon_tpu.ops import losses as RL  # noqa: E402
from photon_tpu.optim import regularization as RReg  # noqa: E402
from photon_tpu.optim.config import OptimizerConfig as RConfig  # noqa: E402
from photon_tpu.optim.config import OptimizerType as ROpt  # noqa: E402
from photon_tpu.telemetry import aggregate as RAgg  # noqa: E402
from photon_tpu.telemetry import health as RHealth  # noqa: E402
from photon_tpu.telemetry import sinks as RSinks  # noqa: E402

from photon_tpu_torch import telemetry  # noqa: E402
from photon_tpu_torch.data.dataset import chunk_batch, make_batch  # noqa: E402
from photon_tpu_torch.models import training as T  # noqa: E402
from photon_tpu_torch.ops.losses import TaskType  # noqa: E402
from photon_tpu_torch.optim import regularization as Reg  # noqa: E402
from photon_tpu_torch.optim.config import (OptimizerConfig,  # noqa: E402
                                           OptimizerType)
from photon_tpu_torch.telemetry import aggregate, health, sinks  # noqa: E402
from photon_tpu_torch.utils import profiling  # noqa: E402

CPU = "cpu"
LOGISTIC, RLOGISTIC = TaskType.LOGISTIC_REGRESSION, \
    RL.TaskType.LOGISTIC_REGRESSION
HIST_RTOL = 1e-5
TIME_KEYS = ("started_unix", "duration_s", "seconds", "t_s", "span_totals",
             "start_ns", "end_ns")


def _timeless(obj):
    """A report with every time field dropped (recursively)."""
    if isinstance(obj, dict):
        return {k: _timeless(v) for k, v in obj.items()
                if k not in TIME_KEYS}
    if isinstance(obj, list):
        return [_timeless(v) for v in obj]
    return obj


def _write_run(mod, path, name="r"):
    """The same run through either package's telemetry."""
    r = mod.start_run(name, jsonl_path=str(path))
    try:
        with mod.span("train"):
            with mod.span("solve", n=3):
                mod.count("solver.iterations", 2.0)
        try:
            with mod.span("boom"):
                raise KeyError("x")
        except KeyError:
            pass
        mod.gauge("stream.prefetch_depth", 2)
        mod.iteration("lbfgs_streamed", 0, np.float32(1.5), grad_norm=0.25)
        mod.iteration("lbfgs_streamed", 1, 1.25, grad_norm=0.125, step=0.5,
                      trials=2)
        mod.event("prefetch_decision", depth=3, verdict="widen")
    finally:
        mod.finish_run()
    return r


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_jsonl_reads_across_packages(tmp_path, writer):
    mods = {"port": telemetry, "reference": RTel}
    path = tmp_path / "run.jsonl"
    _write_run(mods[writer], path)
    port, ref = sinks.load_report(str(path)), RSinks.load_report(str(path))
    assert _timeless(port) == _timeless(ref)
    assert port["complete"] and port["n_iteration_events"] == 2
    assert [e["type"] for e in port["events"]] == ["prefetch_decision"]
    assert list(sinks.read_jsonl(str(path), "span")) == \
        list(RSinks.read_jsonl(str(path), "span"))


def test_both_packages_write_the_same_records(tmp_path):
    _write_run(telemetry, tmp_path / "p.jsonl")
    _write_run(RTel, tmp_path / "r.jsonl")
    port = [_timeless(json.loads(line))
            for line in open(tmp_path / "p.jsonl")]
    ref = [_timeless(json.loads(line))
           for line in open(tmp_path / "r.jsonl")]
    # the run_end gauges: the port samples device memory only with CUDA
    # up, the reference's CPU backend reports none either
    assert port == ref


ITER = '{"type": "iteration", "solver": "x", "it": 9, "loss": 1.0}'


@pytest.mark.parametrize("tear", ['{"type": "spa', ITER + '\n{"t', "",
                                  ITER + "\n", ITER])
def test_repair_jsonl_tail_matches_reference(tmp_path, tear):
    _write_run(telemetry, tmp_path / "a.jsonl")
    body = open(tmp_path / "a.jsonl").read() + tear
    for name in ("p.jsonl", "r.jsonl"):
        open(tmp_path / name, "w").write(body)
    cut_p = sinks.repair_jsonl_tail(str(tmp_path / "p.jsonl"))
    cut_r = RSinks.repair_jsonl_tail(str(tmp_path / "r.jsonl"))
    assert cut_p == cut_r
    assert open(tmp_path / "p.jsonl").read() == \
        open(tmp_path / "r.jsonl").read()
    assert list(sinks.read_jsonl(str(tmp_path / "p.jsonl"))) == \
        list(RSinks.read_jsonl(str(tmp_path / "r.jsonl")))
    # a resumed run appends cleanly after the repair
    r = telemetry.Run("again", jsonl_path=str(tmp_path / "p.jsonl"),
                      append=True)
    r.close()
    assert sinks.load_report(str(tmp_path / "p.jsonl"))["name"] == "again"


def _rank_files(root, waits, torn=(), skip=()):
    """Rank files in the reference's format, one per rank: a barrier
    span of the given wait, decoded chunks, a torn tail where asked."""
    for rank, wait in enumerate(waits):
        if rank in skip:
            continue
        lines = [{"type": "run_start", "name": f"rank{rank}",
                  "started_unix": 1000.0 + 0.25 * rank},
                 {"type": "span", "name": "ingest.decode",
                  "path": "ingest.decode", "seconds": 0.5, "depth": 0,
                  "t_s": 0.0},
                 {"type": "span", "name": "parallel.barrier_wait",
                  "path": "parallel.barrier_wait", "seconds": wait,
                  "depth": 0, "attrs": {"tag": "done"}, "t_s": 0.5}]
        if rank not in torn:
            lines.append({"type": "run_end", "duration_s": 1.0 + wait,
                          "counters": {"ingest.chunks": 3.0 + rank,
                                       "ingest.chunks_skipped": 1.0},
                          "gauges": {}, "n_iteration_events": 0})
        with open(os.path.join(root, f"p{rank}.jsonl"), "w") as f:
            for obj in lines:
                f.write(json.dumps(obj) + "\n")
            if rank in torn:
                f.write('{"type": "span", "na')


@pytest.mark.parametrize("case", ["clean", "torn", "missing"])
def test_aggregate_cluster_matches_reference(tmp_path, case):
    waits = [0.4, 0.05, 0.3, 0.2]
    kw = {"clean": {}, "torn": {"torn": (2,)},
          "missing": {"skip": (3,)}}[case]
    _rank_files(str(tmp_path), waits, **kw)
    assert aggregate.rank_files(str(tmp_path)) == \
        RAgg.rank_files(str(tmp_path))
    port = aggregate.aggregate_cluster(str(tmp_path), expect_ranks=4)
    ref = RAgg.aggregate_cluster(str(tmp_path), expect_ranks=4)
    assert port == ref
    assert port["skew"]["straggler_rank"] == 1
    assert port["complete"] == (case == "clean")
    if case == "missing":
        assert port["missing_ranks"] == [3]
    # an explicit {rank: path} map naming a file that is not there
    paths = {0: str(tmp_path / "p0.jsonl"), 5: str(tmp_path / "nope")}
    assert aggregate.aggregate_cluster(paths) == \
        RAgg.aggregate_cluster(paths)


@pytest.mark.parametrize("shed", [0, 3, 30])
def test_health_report_and_prometheus_match_reference(tmp_path, shed):
    path = tmp_path / "h.jsonl"
    r = telemetry.start_run("health", jsonl_path=str(path))
    telemetry.count("serving.admitted", 100.0)
    telemetry.count("serving.shed", float(shed))
    telemetry.count("serving.fleet_dispatches", 40.0)
    telemetry.count("serving.fleet_failovers", 1.0)
    telemetry.gauge("continual.staleness_s", 12.5)
    telemetry.gauge("serving.latency_p99_ms", 8.25)
    telemetry.finish_run()
    port = health.report_from_jsonl(str(path))
    ref = RHealth.report_from_jsonl(str(path))
    pj, rj = port.to_json(), ref.to_json()
    pj.pop("taken_unix"), rj.pop("taken_unix")
    assert pj == rj
    assert port.prometheus() == ref.prometheus()
    assert port.verdict == {0: "OK", 3: "OK", 30: "CRITICAL"}[shed]
    # the live face: one monitor's windows over the same counters
    mon, rmon = health.HealthMonitor(), RHealth.HealthMonitor()
    a = mon.snapshot(r).rules
    b = rmon.snapshot(r).rules
    assert a == b
    digest = health.QuantileDigest()
    digest.add_many(np.arange(1, 1001) * 1e6)
    snap = health.snapshot(r, latency=digest)
    assert snap.latency["n"] == 1000 and snap.staleness_s == 12.5


def test_health_cli_writes_prometheus(tmp_path):
    from photon_tpu_torch.telemetry.__main__ import main

    path = tmp_path / "c.jsonl"
    _write_run(telemetry, path)
    out = tmp_path / "health.prom"
    assert main(["--health", str(path), "--prom", str(out)]) == 0
    assert out.read_text() == RHealth.report_from_jsonl(
        str(path)).prometheus()
    assert main(["--report", str(path)]) == 0
    assert main([]) == 2


# ------------------------------------------------------------ solver taps
def _dense(seed=0, n=512, d=12):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, -1] = 1.0
    w = rng.normal(size=d).astype(np.float32)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-X @ w))).astype(np.float32)
    return X, y


SOLVERS = {
    "lbfgs_margin": (dict(reg="l2"), "lbfgs_margin"),
    "owlqn": (dict(reg="l1"), "owlqn"),
    "tron_margin": (dict(reg="l2", optimizer="TRON"), "tron_margin"),
}


def _cfgs(reg, optimizer=None, iters=8):
    rreg, preg = {"l1": (RReg.l1(), Reg.l1()), "l2": (RReg.l2(),
                                                       Reg.l2())}[reg]
    kw = dict(max_iters=iters, tolerance=1e-7, reg_weight=0.5, history=5)
    rc, pc = RConfig(reg=rreg, **kw), OptimizerConfig(reg=preg, **kw)
    if optimizer:
        rc = dataclasses.replace(rc, optimizer=ROpt[optimizer])
        pc = dataclasses.replace(pc, optimizer=OptimizerType[optimizer])
    return rc, pc


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_resident_tap_events_match_history_and_reference(solver):
    kw, name = SOLVERS[solver]
    X, y = _dense(seed=3)
    rc, pc = _cfgs(**kw)
    batch = make_batch(X, y, device=CPU)
    _, off = T.train_glm(batch, LOGISTIC, pc, device=CPU)
    with telemetry.run("tap", resident_tap=True) as r:
        assert telemetry.tap_enabled()
        _, on = T.train_glm(batch, LOGISTIC, pc, device=CPU)
    assert not telemetry.tap_enabled()
    assert torch.equal(off.loss_history.nan_to_num(),
                       on.loss_history.nan_to_num())
    assert torch.equal(off.grad_norm_history.nan_to_num(),
                       on.grad_norm_history.nan_to_num())
    assert torch.equal(off.w, on.w)
    events = [e for e in r.iterations if e["solver"] == name]
    n = on.iterations + 1
    assert [e["it"] for e in events] == list(range(n))
    assert all(e["tapped"] for e in events)
    assert [e["loss"] for e in events] == \
        on.loss_history[:n].tolist()
    assert [e["grad_norm"] for e in events] == \
        on.grad_norm_history[:n].tolist()
    assert events[0]["step"] == 0.0 and all(
        e["step"] > 0.0 for e in events[1:])

    with RTel.run("tap", resident_tap=True) as rr:
        RT.train_glm(RD.make_batch(X, y), RLOGISTIC, rc)
    ref = [e for e in rr.iterations if e["solver"] == name]
    ref = sorted(ref, key=lambda e: e["it"])
    assert [e["it"] for e in ref] == [e["it"] for e in events]
    np.testing.assert_allclose([e["loss"] for e in events],
                               [e["loss"] for e in ref], rtol=HIST_RTOL)
    # |g| shrinks to rounding level near the optimum: held at 1e-5 of
    # the starting gradient's norm
    np.testing.assert_allclose([e["grad_norm"] for e in events],
                               [e["grad_norm"] for e in ref], rtol=HIST_RTOL,
                               atol=HIST_RTOL * events[0]["grad_norm"])


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_resident_tap_adds_no_readback(solver):
    """The armed tap rides the solver's existing read-backs: the same
    count armed and off (L-BFGS: exactly one at the start and one an
    iteration), and a run-less solve records nothing."""
    kw, _ = SOLVERS[solver]
    X, y = _dense(seed=4, n=256, d=8)
    _, pc = _cfgs(**kw, iters=6)
    batch = make_batch(X, y, device=CPU)
    obj = T.make_objective(LOGISTIC, pc, 8, device=CPU,
                           fused=kw["reg"] == "l1")
    w0 = torch.zeros(8)
    with profiling.count_syncs(CPU) as off:
        res = T.solve(obj, batch, w0, pc)
    with telemetry.run("tap", resident_tap=True) as r:
        with profiling.count_syncs(CPU) as on:
            T.solve(obj, batch, w0, pc)
    assert on["n"] == off["n"] and len(r.iterations) == res.iterations + 1
    if solver == "lbfgs_margin":
        assert off["n"] == res.iterations + 1
    assert telemetry.current_run() is None
    with telemetry.run("quiet", resident_tap=True) as q:
        with telemetry.tap_disabled():
            T.solve(obj, batch, w0, pc)
    assert q.iterations == []


@pytest.mark.parametrize("l1", [False, True])
def test_streamed_iteration_events_match_reference(l1):
    X, y = _dense(seed=5, n=384, d=10)
    rc, pc = _cfgs("l1" if l1 else "l2", iters=6)
    name = "owlqn_streamed" if l1 else "lbfgs_streamed"
    cb = chunk_batch(make_batch(X, y, device=CPU), 128)
    with telemetry.run("s") as r:
        _, res = T.train_glm(cb, LOGISTIC, pc, device=CPU)
    events = [e for e in r.iterations if e["solver"] == name]
    hist = res.history()
    hist = np.asarray(hist.cpu() if torch.is_tensor(hist) else hist)
    assert [e["it"] for e in events] == list(range(hist.shape[0]))
    # the host loop keeps f64 scalars; its history stores them as f32
    np.testing.assert_array_equal(
        np.asarray([e["loss"] for e in events], np.float32), hist)
    assert all("trials" in e for e in events[1:])
    assert ("solve." + name) in r.span_totals()

    with RTel.run("s") as rr:
        RT.train_glm(RD.chunk_batch(RD.make_batch(X, y), 128), RLOGISTIC,
                     rc)
    ref = [e for e in rr.iterations if e["solver"] == name]
    assert [e["it"] for e in ref] == [e["it"] for e in events]
    np.testing.assert_allclose([e["loss"] for e in events],
                               [e["loss"] for e in ref], rtol=HIST_RTOL)
    assert [e.get("trials") for e in events] == \
        [e.get("trials") for e in ref]


def test_game_descent_events_equal_objective_history():
    from photon_tpu_torch.game.dataset import GameData
    from photon_tpu_torch.game.estimator import (FixedEffectConfig,
                                                 GameEstimator,
                                                 RandomEffectConfig)

    rng = np.random.default_rng(6)
    n = 300
    Xf = rng.normal(size=(n, 5)).astype(np.float32)
    Xr = rng.normal(size=(n, 3)).astype(np.float32)
    users = np.asarray([f"u{i % 7}" for i in range(n)])
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    data = GameData.build(y, {"g": Xf, "u": Xr}, {"user": users})
    cfg = OptimizerConfig(max_iters=5, reg=Reg.l2(), reg_weight=1.0)
    est = GameEstimator(LOGISTIC, {
        "fixed": FixedEffectConfig("g", cfg),
        "per_user": RandomEffectConfig("user", "u", cfg)},
        n_sweeps=2, device=CPU)
    with telemetry.run("game") as r:
        (fit,) = est.fit(data)
    events = [e for e in r.iterations if e["solver"] == "game_descent"]
    hist = fit.descent.objective_history
    assert [e["loss"] for e in events] == hist
    assert [(e["sweep"], e["coordinate"]) for e in events] == \
        [(0, "fixed"), (0, "per_user"), (1, "fixed"), (1, "per_user")]
    assert r.counters["game.sweeps"] == 2.0
    assert r.counters["game.coordinate_updates"] == 4.0


def test_record_signature_counts_new_programs():
    X, y = _dense(seed=7, n=128, d=6)
    _, pc = _cfgs("l2", iters=3)
    with telemetry.run("sig") as r:
        T.train_glm(make_batch(X, y, device=CPU), LOGISTIC, pc, device=CPU)
        T.train_glm(make_batch(X, y, device=CPU), LOGISTIC, pc, device=CPU)
        assert r.counters["retrace.new_signatures"] == 1.0
        X2, y2 = _dense(seed=7, n=64, d=6)
        T.train_glm(make_batch(X2, y2, device=CPU), LOGISTIC, pc,
                    device=CPU)
        T.train_glm_grid(make_batch(X, y, device=CPU), LOGISTIC, pc,
                         [0.1, 1.0], device=CPU)
    assert r.counters["retrace.new_signatures"] == 3.0
    assert len(r.signature_log.signatures("training._train_run")) == 2
    assert len(r.signature_log.signatures("training._train_run_grid")) == 1
    assert r.report()["retrace"] == {"programs": 2}


def test_off_state_records_nothing():
    assert telemetry.current_run() is None and not telemetry.enabled()
    cm = telemetry.span("x", a=1)
    assert cm is telemetry.span("y")  # the shared null span
    with cm as s:
        assert s is None
    telemetry.iteration("s", 0, 1.0)
    telemetry.event("e", a=1)
    telemetry.record_signature("p", (np.zeros(3),))
    telemetry.sample_device_memory("t")
    telemetry.solver_tap("lbfgs_margin", 0, 1.0)
    assert telemetry.finish_run() is None


def test_registry_callers_unchanged_with_a_run_attached():
    telemetry.reset()
    telemetry.count("serving.requests", 3)
    with telemetry.run("r") as r:
        telemetry.count("serving.requests", 2)
        telemetry.gauge("serving.batch_fill", 0.5)
        telemetry.gauge_max("ingest.staging_peak_depth", 4)
        telemetry.gauge_max("ingest.staging_peak_depth", 2)
    snap = telemetry.snapshot()
    assert snap["counters"]["serving.requests"] == 5.0
    assert snap["gauges"]["serving.batch_fill"] == 0.5
    assert snap["gauges"]["ingest.staging_peak_depth"] == 4
    assert r.counters == {"serving.requests": 2.0}
    assert r.gauges["ingest.staging_peak_depth"] == 4
    telemetry.reset()
    assert telemetry.snapshot() == {"counters": {}, "gauges": {}}
    # a second start closes the first run
    a = telemetry.start_run("a")
    b = telemetry.start_run("b")
    assert a._closed and telemetry.current_run() is b
    telemetry.finish_run()


def test_cpu_process_samples_no_device_memory():
    with telemetry.run("m") as r:
        telemetry.sample_device_memory("x")
    assert not any(k.startswith("hbm.") for k in r.gauges)


def test_barrier_span_and_profiler_trace(tmp_path):
    from photon_tpu_torch.parallel.mesh import cluster_barrier

    with telemetry.run("b") as r:
        with profiling.trace(str(tmp_path / "trace")):
            with profiling.annotate("region"):
                assert cluster_barrier("t") == 0.0
    assert "parallel.barrier_wait" in r.span_totals()
    assert r.spans[0].attrs == {"tag": "t"}
    assert any(f.endswith(".json") for f in os.listdir(tmp_path / "trace"))


def test_telemetry_selftest_cpu():
    from photon_tpu_torch.telemetry.__main__ import selftest

    report = selftest("cpu")
    assert report["ok"], report["checks"]
    tap = report["resident_tap"]
    assert tap["syncs_off"] == tap["syncs_armed"] == tap["iterations"] + 1


# ------------------------------------------- spans on the profiler's clock
def _kineto(prof) -> dict:
    """{name: (start_ns, end_ns)} of the profiler's host events."""
    return {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()}


def test_span_without_a_run_is_null_unless_the_profiler_collects():
    from torch.profiler import ProfilerActivity, profile

    assert telemetry.current_run() is None
    assert telemetry.span("solve.a") is telemetry.span("solve.b")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cm = telemetry.span("solve.lane_lbfgs.probe")
        assert cm is not telemetry.span("solve.b")
        with cm:
            torch.ones(3).sum()
    assert "solve.lane_lbfgs.probe" in _kineto(prof)
    # the profiler stopped: the null span again
    assert telemetry.span("solve.a") is telemetry.span("solve.b")


def test_run_spans_lie_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile

    names = [f"solve.timed{i}" for i in range(5)]
    with telemetry.run("clock") as r:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with telemetry.span("solve.warm"):
                pass
            for name in names:
                with telemetry.span(name):
                    torch.ones(64).cumsum(0)
    recs = {s.path: s for s in r.spans}
    kin = _kineto(prof)
    # the median of five: one span a busy host preempts does not decide
    offsets = sorted(max(abs(recs[n].start_ns - kin[n][0]),
                         abs(recs[n].end_ns - kin[n][1])) for n in names)
    assert offsets[2] < 500_000, offsets
    assert all(recs[n].end_ns >= recs[n].start_ns for n in names)


def test_span_records_carry_their_start_and_end(tmp_path):
    path = tmp_path / "run.jsonl"
    r = _write_run(telemetry, path)
    on_disk = list(sinks.read_jsonl(str(path), "span"))
    in_memory = r.report()["spans"]
    assert [s.to_json() for s in r.spans] == in_memory
    assert len(on_disk) == len(in_memory) == 3
    for disk, mem, span in zip(on_disk, in_memory, r.spans):
        assert disk["start_ns"] == mem["start_ns"] == span.start_ns
        assert disk["end_ns"] == mem["end_ns"] == span.end_ns
        assert span.start_ns <= span.end_ns
        # t_s is the same start, from the run's own start
        assert disk["t_s"] == pytest.approx(
            (span.start_ns - r.started_unix * 1e9) / 1e9, abs=1e-5)
    assert sinks.load_report(str(path))["spans"][0]["start_ns"] == \
        on_disk[0]["start_ns"]


def _blocked_ell(n=400, d=300, k=12, d_dense=16, seed=3):
    from photon_tpu_torch.data.matrix import SparseRows, to_blocked_ell

    rng = np.random.default_rng(seed)
    ind = rng.zipf(1.3, size=(n, k)).astype(np.int64) % d
    val = rng.normal(size=(n, k)).astype(np.float32)
    val[:, -2:] = 0.0  # padded slots
    return to_blocked_ell(SparseRows(ind.astype(np.int32), val, d), d_dense,
                          device=CPU)


@pytest.mark.parametrize("hot_dtype", [None, torch.bfloat16])
def test_layout_build_sets_its_gauges_within_its_wall(hot_dtype):
    import time

    from photon_tpu_torch.data.matrix import SparseRows, to_blocked_ell

    telemetry.reset()
    rng = np.random.default_rng(5)
    ind = rng.zipf(1.3, size=(2000, 16)).astype(np.int32) % 5000
    val = np.ones((2000, 16), np.float32)
    t = time.perf_counter()
    to_blocked_ell(SparseRows(ind, val, 5000), 64,
                   device_dense_dtype=hot_dtype, device=CPU)
    wall = time.perf_counter() - t
    g = telemetry.snapshot()["gauges"]
    host, dev = g["train.layout.host_pass_s"], g["train.layout.device_s"]
    assert host > 0.0 and dev > 0.0
    assert host + dev <= wall
    telemetry.reset()


def test_layout_build_spans_nest_under_train_layout():
    with telemetry.run("layout") as r:
        X = _blocked_ell()
    paths = set(r.span_totals())
    assert {"train.layout", "train.layout/train.layout.split",
            "train.layout/train.layout.buckets",
            "train.layout/train.layout.ladder",
            "train.layout/train.layout.upload"} <= paths
    assert r.gauges["train.layout.host_pass_s"] > 0.0
    assert X.tail_nnz > 0


@pytest.mark.parametrize("layout", ["to_hybrid", "to_permuted_hybrid"])
def test_other_layouts_open_no_layout_span(layout):
    from photon_tpu_torch.data import matrix

    rng = np.random.default_rng(7)
    ind = (rng.zipf(1.3, size=(400, 12)) % 300).astype(np.int32)
    val = rng.normal(size=(400, 12)).astype(np.float32)
    telemetry.reset()
    with telemetry.run("layout") as r:
        getattr(matrix, layout)(matrix.SparseRows(ind, val, 300), 16,
                                device=CPU)
    assert not any(p.startswith("train.layout")
                   for p in r.span_totals())
    assert "train.layout.host_pass_s" not in r.gauges
    telemetry.reset()
