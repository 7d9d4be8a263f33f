"""The port's request tracing (`photon_tpu_torch.telemetry.trace`) against
the JAX package's, on the CPU, and the traces the dispatcher and the
fleet write.

Under one injected clock (``time.perf_counter_ns`` replaced by a counter
both modules read) the same sequence of traces gives the same hop
records, breakdowns and K kept exemplars in both packages. The
dispatcher's traces hop ``queue_wait`` → ``device_flush`` →
``retire_wait`` (``shed`` for a dropped request), are closed once by the
retire thread, and their breakdown sums to the trace's total; a fleet
request adds ``fleet_route`` / ``replica_dispatch`` and, after an
injected replica death, ``failover_backoff``.
"""
import itertools
import time

import jax.core
import jax.extend.core

for _name in dir(jax.extend.core):
    if not _name.startswith("_") and not hasattr(jax.core, _name):
        setattr(jax.core, _name, getattr(jax.extend.core, _name))

import pytest  # noqa: E402

from photon_tpu.telemetry import trace as RTr  # noqa: E402

from photon_tpu_torch import checkpoint, serving  # noqa: E402
from photon_tpu_torch.telemetry import trace  # noqa: E402
from test_torch_serving import (K_MEMBER, _port_model,  # noqa: E402
                                _ref_game_model, _requests, _rows)

LADDER = dict(ladder=(8,), sparse_k={"member": K_MEMBER})


def _drive(mod, k: int) -> tuple:
    """Ten traces of known hop lengths (the clock ticks 1 µs a read; a
    trace's ``sleep`` reads add to its device_flush), deposited in a K
    reservoir."""
    res = mod.ExemplarReservoir(k)
    for i in range(10):
        tc = mod.TraceContext(trace_id=f"t{i}")
        tc.switch("queue_wait", slot=i)
        for _ in range(i % 4):
            time.perf_counter_ns()
        tc.switch("device_flush")
        for _ in range((7 * i) % 5):
            time.perf_counter_ns()
        tc.switch("retire_wait")
        tc.switch("retire_wait")  # a repeated hop sums by name
        assert tc.finish() and not tc.finish()
        tc.switch("late")  # after finish: a no-op
        res.offer(tc)
    return res.snapshot(), res.n_offered


@pytest.mark.parametrize("k", [1, 3, 8, 12])
def test_reservoir_keeps_the_same_k_traces(monkeypatch, k):
    tick = itertools.count(0, 1000)
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(tick))
    port = _drive(trace, k)
    tick2 = itertools.count(0, 1000)
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(tick2))
    ref = _drive(RTr, k)
    assert port == ref
    assert len(port[0]) == min(k, 10) and port[1] == 10
    totals = [ex["total_ms"] for ex in port[0]]
    assert totals == sorted(totals, reverse=True)
    with pytest.raises(ValueError):
        trace.ExemplarReservoir(0)


def test_arming_plane_matches_reference():
    for mod in (trace, RTr):
        assert not mod.armed() and mod.begin() is None
        assert mod.reservoir() is None
        mod.hop(None, "x")
        mod.finish(None)
        with mod.attach(None) as tc:
            assert tc is None
        with mod.tracing(k=2) as res:
            tc = mod.begin("fleet_route", primary=1)
            with mod.attach(tc):
                assert mod.current() is tc
                inner = mod.begin("queue_wait")  # continues the trace
            assert inner is tc and mod.current() is None
            with mod.trace_disabled():
                assert mod.begin() is None
            with mod.tracing(k=1) as inner_res:
                assert mod.reservoir() is inner_res
            assert mod.reservoir() is res  # restored
            mod.finish(tc)
            mod.finish(tc)  # one deposit per trace
            assert [h["name"] for h in res.slowest()["hops"]] == \
                ["fleet_route", "queue_wait"]
            assert res.n_offered == 1
        assert not mod.armed()


def _ladder(seed=0):
    store = serving.CoefficientStore.from_game_model(
        _port_model(_ref_game_model(seed=seed)), device="cpu")
    return store, serving.ProgramLadder(store, **LADDER)


def test_dispatcher_traces_every_request():
    store, ladder = _ladder()
    reqs = _requests(serving, _rows(20, seed=1))
    with trace.tracing(k=32) as res:
        d = serving.MicroBatchDispatcher(ladder, max_batch=8,
                                         max_delay_us=2000)
        try:
            futs = [d.submit(q) for q in reqs]
            [f.result(timeout=60) for f in futs]
        finally:
            d.close()
        shedder = serving.MicroBatchDispatcher(
            ladder, policy=serving.AdmissionPolicy(shed_watermark=0))
        try:
            assert not shedder.submit(reqs[0]).result(timeout=60)
        finally:
            shedder.close()
    exemplars = res.snapshot()
    assert res.n_offered == 21 and len(exemplars) == 21
    names = sorted({tuple(h["name"] for h in ex["hops"])
                    for ex in exemplars})
    assert names == [("queue_wait", "device_flush", "retire_wait"),
                     ("queue_wait", "shed")]
    for ex in exemplars:
        # the hops tile the trace: their sum is its total, to rounding
        assert sum(ex["breakdown_ms"].values()) == pytest.approx(
            ex["total_ms"], abs=0.05)
    # off: no trace rides a request
    d = serving.MicroBatchDispatcher(ladder)
    try:
        assert isinstance(d.score(reqs[0]), float)
    finally:
        d.close()
    assert trace.reservoir() is None


def test_fleet_trace_names_the_failover():
    store, _ = _ladder(seed=2)
    reqs = _requests(serving, _rows(4, seed=3))
    fl = serving.ReplicaFleet.build(
        store, 2, policy=serving.FleetPolicy(attempt_timeout_s=60.0,
                                             base_delay_s=0.02,
                                             max_delay_s=0.02),
        ladder_kwargs=LADDER, dispatcher_kwargs=dict(max_delay_us=200))
    try:
        with trace.tracing(k=8) as res:
            fl.score(reqs[0])
            with checkpoint.fault_plan(
                    checkpoint.FaultPlan.kill_at("rung_execute", 1)):
                fl.score(reqs[1])
    finally:
        fl.close()
    slow = res.slowest()
    hops = [h["name"] for h in slow["hops"]]
    assert hops[:2] == ["fleet_route", "replica_dispatch"]
    assert "failover_backoff" in hops and hops.count("replica_dispatch") == 2
    assert slow["slowest_hop"] == "failover_backoff"
    assert res.n_offered == 2
