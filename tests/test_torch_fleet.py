"""The port's replica fleet (`photon_tpu_torch.serving.fleet`) and the
serving selftest against the JAX package, on the CPU.

The same numpy-seeded GAME model as `test_torch_serving.py` (one dense
fixed effect, one sparse and one dense random effect), built in
`photon_tpu` and carried across by `photon_tpu_torch.convert`:
`shard_bounds`, `shard_store` (blocks and directories) and
`ReplicaFleet.replica_for` equal the reference's exactly; the fleets'
answers agree at the serving tests' tolerance (rtol = atol = 1e-6: the
two frameworks add the same products in another order), with and
without an injected replica death at the ``replica_dispatch`` site (a
failover answer is the degraded fixed-effect-only score in both).
"""
import jax.core
import jax.extend.core

for _name in dir(jax.extend.core):
    if not _name.startswith("_") and not hasattr(jax.core, _name):
        setattr(jax.core, _name, getattr(jax.extend.core, _name))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from photon_tpu import checkpoint as ref_checkpoint  # noqa: E402
from photon_tpu import serving as ref_serving  # noqa: E402
from photon_tpu.serving import fleet as ref_fleet  # noqa: E402

from photon_tpu_torch import checkpoint, serving, telemetry  # noqa: E402
from photon_tpu_torch.serving import fleet  # noqa: E402
from test_torch_serving import (K_MEMBER, _port_model,  # noqa: E402
                                _ref_game_model, _requests, _rows)

TOL = dict(rtol=1e-6, atol=1e-6)
CPU = "cpu"
LADDER = dict(ladder=(8,), sparse_k={"member": K_MEMBER})
DISPATCH = dict(max_batch=8, max_delay_us=200)


def _stores(seed=0):
    ref = _ref_game_model(seed=seed)
    return (ref_serving.CoefficientStore.from_game_model(ref),
            serving.CoefficientStore.from_game_model(_port_model(ref),
                                                     device=CPU))


@pytest.mark.parametrize("n_entities,n_shards",
                         [(12, 1), (12, 2), (12, 5), (7, 3), (3, 4)])
def test_shard_bounds_match_reference(n_entities, n_shards):
    assert fleet.shard_bounds(n_entities, n_shards) == \
        ref_fleet.shard_bounds(n_entities, n_shards)


@pytest.mark.parametrize("n_shards", [1, 2, 3])
def test_shard_store_matches_reference(n_shards):
    rs, ps = _stores(seed=2)
    r_shards = ref_fleet.shard_store(rs, n_shards)
    p_shards = fleet.shard_store(ps, n_shards)
    assert len(p_shards) == len(r_shards) == n_shards
    for r, p in zip(r_shards, p_shards):
        assert p.order == r.order and p.device.type == "cpu"
        for name in r.fixed:
            np.testing.assert_array_equal(p.fixed[name].weights,
                                          np.asarray(r.fixed[name].weights))
        for name, rb in r.random.items():
            pb = p.random[name]
            np.testing.assert_array_equal(pb.coefficients, rb.coefficients)
            assert pb.directory.keys_in_order() == \
                rb.directory.keys_in_order()
            assert (pb.entity_name, pb.feature_shard) == \
                (rb.entity_name, rb.feature_shard)
    with pytest.raises(ValueError, match="n_shards"):
        fleet.shard_store(ps, 0)


def test_replica_for_matches_reference():
    rs, ps = _stores(seed=3)
    reqs = _requests(serving, _rows(40, seed=5))
    rreqs = _requests(ref_serving, _rows(40, seed=5))
    # keyless requests hash on their (empty) entity map
    reqs.append(serving.ScoreRequest(features=reqs[0].features))
    rreqs.append(ref_serving.ScoreRequest(features=rreqs[0].features))
    for n in (1, 2, 3):
        rf = ref_serving.ReplicaFleet.build(rs, n, ladder_kwargs=LADDER,
                                            dispatcher_kwargs=DISPATCH)
        pf = serving.ReplicaFleet.build(ps, n, ladder_kwargs=LADDER,
                                        dispatcher_kwargs=DISPATCH)
        try:
            want = [rf.replica_for(q) for q in rreqs]
            got = [pf.replica_for(q) for q in reqs]
        finally:
            rf.close()
            pf.close()
        assert got == want
        if n > 1:
            assert len(set(got)) == n


def _fleet_scores(mod, store, reqs, plan=None, faults=None):
    fl = mod.ReplicaFleet.build(
        store, 2, policy=mod.FleetPolicy(attempt_timeout_s=60.0,
                                         base_delay_s=0.001,
                                         max_delay_s=0.002),
        ladder_kwargs=LADDER, dispatcher_kwargs=DISPATCH)
    try:
        if plan is None:
            return np.asarray([fl.score(q) for q in reqs], np.float64)
        with faults.fault_plan(plan):
            return np.asarray([fl.score(q) for q in reqs], np.float64)
    finally:
        fl.close()


@pytest.mark.parametrize("kill", [None, 1, 4, 9])
def test_fleet_answers_match_reference(kill):
    """Both fleets score the same requests, with and without a kill at
    the n-th ``replica_dispatch`` occurrence, to the same answers."""
    rs, ps = _stores(seed=4)
    rows = _rows(12, seed=6)
    reqs, rreqs = _requests(serving, rows), _requests(ref_serving, rows)
    plans = (None, None) if kill is None else (
        checkpoint.FaultPlan.kill_at("replica_dispatch", kill),
        ref_checkpoint.FaultPlan.kill_at("replica_dispatch", kill))
    telemetry.reset()
    got = _fleet_scores(serving, ps, reqs, plans[0], checkpoint)
    c = telemetry.snapshot()["counters"]
    want = _fleet_scores(ref_serving, rs, rreqs, plans[1], ref_checkpoint)
    np.testing.assert_allclose(got, want, **TOL)
    assert c["serving.fleet_dispatches"] == len(reqs)
    if kill is not None:
        # the kill fires before the attempt runs: the retry pays a backoff
        # and goes on as that attempt would have, in both packages
        assert c["faults.injected_kills"] == 1
        assert c["faults.io_retries.replica_dispatch"] == 1


def test_fleet_kill_answers_exact_or_degraded():
    """Every kill site × occurrence: no hung future, no torn answer —
    each answer is the owning replica's (exact) or another replica's
    (the degraded answer: its out-of-range entities score as cold
    misses)."""
    _, ps = _stores(seed=7)
    rows = _rows(8, seed=8)
    reqs = _requests(serving, rows)
    fl = serving.ReplicaFleet.build(
        ps, 2, policy=serving.FleetPolicy(attempt_timeout_s=60.0,
                                          base_delay_s=0.001,
                                          max_delay_s=0.002),
        ladder_kwargs=LADDER, dispatcher_kwargs=DISPATCH)
    try:
        clean = [fl.score(q) for q in reqs]
        answers = [{r.dispatcher.score(q) for r in fl.replicas}
                   for q in reqs]
        assert all(c in a for c, a in zip(clean, answers))
        assert any(len(a) > 1 for a in answers)
        with checkpoint.record_sites() as rec:
            assert [fl.score(q) for q in reqs] == clean
        assert rec.hits["replica_dispatch"] == len(reqs)
        for site in ("replica_dispatch", "rung_execute"):
            total = rec.hits[site]
            for occ in sorted({1, total // 2, total}):
                with checkpoint.fault_plan(
                        checkpoint.FaultPlan.kill_at(site, occ)):
                    futs = [fl.submit(q) for q in reqs]
                    got = [f.result(timeout=60) for f in futs]
                for g, a in zip(got, answers):
                    assert g in a
        assert fl.assert_no_retrace() <= 2
        stats = fl.latency_stats()
        assert stats["n"] == fl.replicas[0].dispatcher.latency_stats()["n"] \
            + fl.replicas[1].dispatcher.latency_stats()["n"]
        assert stats["p50_ms"] <= stats["p99_ms"]
    finally:
        fl.close()
    fl.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        fl.score(reqs[0])


def test_fleet_open_from_saved_shards(tmp_path):
    _, ps = _stores(seed=9)
    dirs = []
    for j, shard in enumerate(fleet.shard_store(ps, 2)):
        shard.save(tmp_path / f"s{j}")
        dirs.append(tmp_path / f"s{j}")
    reqs = _requests(serving, _rows(10, seed=10))
    built = serving.ReplicaFleet.build(ps, 2, ladder_kwargs=LADDER,
                                       dispatcher_kwargs=DISPATCH)
    with checkpoint.fault_plan(checkpoint.FaultPlan(
            errors={"store_open": 1})):
        opened = serving.ReplicaFleet.open(
            dirs, routing_store=ps, ladder_kwargs=LADDER,
            dispatcher_kwargs=DISPATCH, device=CPU)
    try:
        assert [opened.replica_for(q) for q in reqs] == \
            [built.replica_for(q) for q in reqs]
        np.testing.assert_array_equal([opened.score(q) for q in reqs],
                                      [built.score(q) for q in reqs])
    finally:
        built.close()
        opened.close()
    with checkpoint.fault_plan(
            checkpoint.FaultPlan.kill_at("store_open", 2)):
        with pytest.raises(checkpoint.InjectedFault):
            serving.ReplicaFleet.open(dirs, ladder_kwargs=LADDER,
                                      device=CPU)


def test_fleet_overload_sheds_without_failover():
    _, ps = _stores(seed=11)
    reqs = _requests(serving, _rows(6, seed=12))
    telemetry.reset()
    fl = serving.ReplicaFleet.build(
        ps, 2, admission=serving.AdmissionPolicy(shed_watermark=0),
        ladder_kwargs=LADDER, dispatcher_kwargs=DISPATCH)
    try:
        out = [fl.score(q) for q in reqs]
    finally:
        fl.close()
    assert all(isinstance(v, serving.Shed) and v.reason == "watermark"
               for v in out)
    c = telemetry.snapshot()["counters"]
    assert "serving.fleet_failovers" not in c
    assert "serving.fleet_degraded" not in c
    assert telemetry.snapshot()["gauges"]["serving.fleet_replicas"] == 2


def test_serving_selftest_cpu():
    from photon_tpu_torch.serving.__main__ import selftest

    report = selftest("cpu")
    assert report["ok"], report["checks"]
    assert report["fleet_latency"]["n"] > 0
