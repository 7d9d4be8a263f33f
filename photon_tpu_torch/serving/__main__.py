"""CLI: smoke-check the serving tier in-process (port of
`photon_tpu/serving/__main__.py`).

    python -m photon_tpu_torch.serving --selftest [--json] [--device cpu]

Runs on the card unless given ``--device cpu``. The selftest builds a
tiny GameModel, freezes it into a `CoefficientStore`, spins up the
`ProgramLadder` + `MicroBatchDispatcher`, scores a canned request mix
(ragged batches, seen and unseen entities), and checks:

- **parity**: the dispatcher's f32 scores equal the offline `score_game`
  on the same rows within 1e-6 (cold misses included: they fall back to
  the fixed-effect-only score), and an int8 ladder's margins (one
  ``serving_int8`` kernel launch a flush on the card) sit within its
  accuracy gate's epsilon of them;
- **no retrace**: at most one argument signature per ladder rung;
- **latency accounting**: one recorded latency per request, ordered
  percentiles, and the ``serving.*`` counters adding up;
- **overload semantics**: an open-loop burst with the admission policy
  armed resolves EVERY future (scored or a typed `Shed`), deadline-0
  requests expire, a watermark-0 dispatcher sheds every submit, the
  admitted/shed/deadline_expired counters add up, and the retrace bound
  holds with admission on and off;
- **the replica fleet**: a 2-replica entity-range fleet answers as the
  single dispatcher does; its per-request device path is its replica's
  rung and nothing else (``fleet_request_path``: the same kernel
  launches as the single ladder's on the card, no collective); kills at
  every serving fault site (``replica_dispatch``, ``rung_execute``) ×
  first/middle/last occurrence leave no hung future and no torn
  response, every answer exact or the degraded-but-correct
  fixed-effect-only one; and ``store_open`` retries transient errors,
  propagates a kill and reopens clean.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

D_FIXED, D_RE, SPARSE_K, N_ENTITIES = 6, 4, 3, 16


def build_demo_model(seed: int = 0, n_entities: int = N_ENTITIES,
                     d_fixed: int = D_FIXED, d_re: int = D_RE, device=None):
    """A tiny two-coordinate GAME model (dense fixed shard ``global``,
    sparse random-effect shard ``member`` keyed by ``memberId``) on
    ``device``, and the seeded generator that made it."""
    import numpy as np

    from photon_tpu_torch.convert import game_model_from_arrays
    from photon_tpu_torch.ops.losses import TaskType

    rng = np.random.default_rng(seed)
    keys = np.asarray(sorted(f"e{i:03d}" for i in range(n_entities)))
    arrays = {
        "fixed": {"type": "fixed", "feature_shard": "global",
                  "means": rng.normal(size=d_fixed).astype(np.float32)},
        "perEntity": {"type": "random", "feature_shard": "member",
                      "entity_name": "memberId",
                      "coefficients": rng.normal(
                          size=(n_entities, d_re)).astype(np.float32),
                      "entity_keys": keys},
    }
    return game_model_from_arrays(TaskType.LOGISTIC_REGRESSION, arrays,
                                  device=device), rng


def demo_rows(rng, n: int, n_keys: int = 20):
    """n request rows: dense ``global``, ``SPARSE_K``-slot ``member``, an
    offset each; entities ``e000``… cycling over ``n_keys`` keys (keys
    past the model's are unseen)."""
    import numpy as np

    return {"xg": rng.normal(size=(n, D_FIXED)).astype(np.float32),
            "ind": rng.integers(0, D_RE, size=(n, SPARSE_K)).astype(
                np.int32),
            "val": rng.normal(size=(n, SPARSE_K)).astype(np.float32),
            "offs": rng.normal(size=n).astype(np.float32),
            "ents": [f"e{i % n_keys:03d}" for i in range(n)]}


def rows_requests(rows: dict, ents=None) -> list:
    from photon_tpu_torch.serving.dispatcher import ScoreRequest

    ents = rows["ents"] if ents is None else ents
    return [ScoreRequest(
        features={"global": rows["xg"][i],
                  "member": (rows["ind"][i], rows["val"][i])},
        entities={"memberId": ents[i]}, offset=float(rows["offs"][i]))
        for i in range(len(ents))]


def demo_requests(model, rng, n: int) -> list:
    """n seeded requests for `build_demo_model`'s model."""
    return rows_requests(demo_rows(rng, n))


def _offline(model, rows: dict, ents, mean: bool):
    import numpy as np

    from photon_tpu_torch.data.matrix import SparseRows
    from photon_tpu_torch.game.dataset import GameData
    from photon_tpu_torch.game.scoring import score_game

    n = len(ents)
    data = GameData.build(
        np.zeros(n, np.float32),
        {"global": rows["xg"][:n],
         "member": SparseRows(rows["ind"][:n], rows["val"][:n], D_RE)},
        {"memberId": np.asarray(ents)}, offsets=rows["offs"][:n])
    s = score_game(model, data)
    return (model.mean(s) if mean else s).detach().cpu().numpy()


def selftest(device: str = "cuda") -> dict:
    import numpy as np

    from photon_tpu_torch import checkpoint, serving, telemetry
    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.device import resolve_device
    from photon_tpu_torch.kernels import serving as K_SERVING

    dev = resolve_device(device)
    checks: dict = {}

    def check(name: str, ok: bool, detail: str = "") -> None:
        checks[name] = "" if ok else (detail or "failed")

    model, rng = build_demo_model(device=dev)
    store = serving.CoefficientStore.from_game_model(model, device=dev)
    ladder = serving.ProgramLadder(store, ladder=(8, 16),
                                   sparse_k={"member": SPARSE_K},
                                   output_mean=True)
    ladder.warmup()

    n_req = 37
    rows = demo_rows(rng, n_req)
    ents = rows["ents"]
    reqs = rows_requests(rows)

    r = telemetry.start_run("serving_selftest")
    d = serving.MicroBatchDispatcher(ladder, max_batch=16, max_delay_us=2000)
    try:
        got = np.asarray([f.result(timeout=60) for f in
                          [d.submit(q) for q in reqs]], np.float32)
    finally:
        d.close()
        telemetry.finish_run()

    want = _offline(model, rows, ents, mean=True)
    check("offline_parity", np.allclose(got, want, rtol=1e-6, atol=1e-6),
          f"max |Δ| = {np.abs(got - want).max()}")
    miss = np.asarray([int(e[1:]) >= N_ENTITIES for e in ents])
    fixed_only = _offline(model, rows, ["zz"] * n_req, mean=True)
    check("cold_miss_fallback",
          np.allclose(got[miss], fixed_only[miss], rtol=1e-6, atol=1e-6)
          and int(miss.sum()) > 0,
          "cold-miss rows differ from the fixed-effect-only score")

    # the int8 rung (the serving_int8 kernel on the card): its margins
    # within the accuracy gate's epsilon of the offline f32 margins
    qladder = serving.ProgramLadder(store, ladder=(8, 16),
                                    sparse_k={"member": SPARSE_K},
                                    output_mean=False, quantize="int8",
                                    quant_epsilon=0.5)
    qladder.warmup()
    K.reset_launch_counts()
    qd = serving.MicroBatchDispatcher(qladder, max_batch=16,
                                      max_delay_us=2000)
    try:
        qgot = np.asarray([f.result(timeout=60) for f in
                           [qd.submit(q) for q in reqs]], np.float32)
    finally:
        qd.close()
    q_launches = K.launch_counts()
    qwant = _offline(model, rows, ents, mean=False)
    check("int8_parity",
          float(np.abs(qgot - qwant).max()) <= qladder.quant_epsilon
          and (dev.type != "cuda"
               or q_launches.get(K_SERVING.KERNEL, 0) >= 3),
          f"max |Δ| = {np.abs(qgot - qwant).max()}, launches {q_launches}")

    try:
        n_sigs = ladder.assert_no_retrace()
        check("no_retrace", True)
        check("ladder_bounded", n_sigs <= len(ladder.ladder),
              f"{n_sigs} sigs > {len(ladder.ladder)} rungs")
    except AssertionError as e:
        check("no_retrace", False, str(e))

    stats = d.latency_stats()
    check("latency_accounting",
          stats["n"] == n_req
          and stats["p50_ms"] <= stats["p95_ms"] <= stats["p99_ms"],
          f"stats: {stats}")
    counters = r.counters
    check("counter_accounting",
          counters.get("serving.requests") == float(n_req)
          and counters.get("serving.batches", 0) >= 1
          and counters.get("serving.cold_misses") == float(miss.sum()),
          f"counters: { {k: v for k, v in sorted(counters.items())} }")

    # ---------------- overload semantics ----------------
    r2 = telemetry.start_run("serving_selftest_overload")
    burst = serving.MicroBatchDispatcher(
        ladder, max_batch=16, max_delay_us=2000,
        policy=serving.AdmissionPolicy(deadline_ms=500.0,
                                       submit_timeout_s=0.0))
    try:
        futs = [burst.submit(q) for q in reqs[:24]]
        expired = [burst.submit(serving.ScoreRequest(
            features=q.features, entities=q.entities, offset=q.offset,
            deadline_ms=0.0)) for q in reqs[24:32]]
        burst_res = [f.result(timeout=60) for f in futs]
        expired_res = [f.result(timeout=60) for f in expired]
    finally:
        burst.close()
    shedder = serving.MicroBatchDispatcher(
        ladder, max_batch=16, max_delay_us=2000,
        policy=serving.AdmissionPolicy(shed_watermark=0))
    try:
        shed_res = [shedder.submit(q).result(timeout=60) for q in reqs[:8]]
    finally:
        shedder.close()
        telemetry.finish_run()
    check("overload_all_futures_resolve",
          len(burst_res) == 24 and len(expired_res) == 8
          and len(shed_res) == 8
          and all(isinstance(v, (float, serving.Shed))
                  for v in burst_res + expired_res + shed_res),
          "an overload future leaked or resolved to a foreign type")
    check("overload_deadline_expiry",
          all(isinstance(v, serving.Shed)
              and v.reason == "deadline_expired" for v in expired_res),
          f"deadline-0 requests did not all expire: {expired_res[:3]}")
    check("overload_watermark_shed",
          all(isinstance(v, serving.Shed) and v.reason == "watermark"
              for v in shed_res),
          f"watermark-0 submits did not all shed: {shed_res[:3]}")
    c2 = r2.counters
    scored = sum(1 for v in burst_res if isinstance(v, float))
    check("overload_counter_accounting",
          c2.get("serving.admitted", 0) == float(len(futs) + len(expired))
          and c2.get("serving.deadline_expired", 0) == float(
              len(expired) + (24 - scored))
          and c2.get("serving.shed", 0) == 8.0,
          f"counters: { {k: v for k, v in sorted(c2.items())} }")
    try:
        ladder.assert_no_retrace()
        check("admission_no_retrace_on_off", True)
    except AssertionError as e:
        check("admission_no_retrace_on_off", False, str(e))

    # --------------- replica fleet: kill matrix + retry/backoff ------------
    fleet_policy = serving.FleetPolicy(attempt_timeout_s=60.0,
                                       base_delay_s=0.001,
                                       max_delay_s=0.01)
    lk = dict(ladder=(8,), sparse_k={"member": SPARSE_K}, quantize="int8",
              quant_epsilon=0.5)
    dk = dict(max_batch=8, max_delay_us=200)
    single = serving.ProgramLadder(store, **lk)
    single.warmup()
    fleet = serving.ReplicaFleet.build(store, 2, policy=fleet_policy,
                                       ladder_kwargs=lk,
                                       dispatcher_kwargs=dk, warmup=True)
    kidx = list(range(8))
    kents = [f"e{(2 * i) % N_ENTITIES:03d}" for i in kidx]
    kreqs = rows_requests(rows, kents)
    freqs = rows_requests(rows, ["zz-unseen"] * 8)
    sd = serving.MicroBatchDispatcher(single, **dk)
    try:
        one = [sd.score(q) for q in kreqs]
        K.reset_launch_counts()
        one_launch = [sd.score(kreqs[0])]
        single_launches = K.launch_counts()
    finally:
        sd.close()
    try:
        K.reset_launch_counts()
        fleet_launch = [fleet.score(kreqs[0])]
        fleet_launches = K.launch_counts()
        # one request's device work: its replica's one rung launch (the
        # single ladder's, on the card), and no collective anywhere
        check("fleet_request_path",
              fleet_launch == one_launch
              and fleet_launches == single_launches
              and (dev.type != "cuda"
                   or fleet_launches == {K_SERVING.KERNEL: 1}),
              f"fleet {fleet_launches} vs single {single_launches}")
        clean = [fleet.score(q) for q in kreqs]
        fixed_only = [fleet.score(q) for q in freqs]
        routed = [fleet.replica_for(q) for q in kreqs]
        q_scale = np.asarray(clean) - np.asarray(one)
        check("fleet_parity",
              all(isinstance(v, float) for v in clean + fixed_only)
              and any(c != f for c, f in zip(clean, fixed_only))
              and float(np.abs(q_scale).max()) <= 0.5 / 4
              and sorted(set(routed)) == [0, 1],
              f"fleet vs single max |Δ| {np.abs(q_scale).max()}, "
              f"routes {routed}")
        with checkpoint.record_sites() as rec:
            dry = [fleet.score(q) for q in kreqs]
        check("fleet_dry_run_deterministic", dry == clean,
              "an unarmed recorder changed fleet answers")
        matrix_ok, matrix_detail, fired = True, [], {}
        for site in ("replica_dispatch", "rung_execute"):
            total = rec.hits.get(site, 0)
            for occ in sorted({1, max(total // 2, 1), max(total, 1)}):
                telemetry.reset()
                with checkpoint.fault_plan(
                        checkpoint.FaultPlan.kill_at(site, occ)):
                    got = [fleet.score(q) for q in kreqs]
                fired[f"{site}@{occ}"] = telemetry.snapshot()[
                    "counters"].get("faults.injected_kills", 0)
                bad = [i for i, (g, c, f) in enumerate(
                    zip(got, clean, fixed_only))
                    if not (g == c or g == f)]
                if bad:
                    matrix_ok = False
                    matrix_detail.append(f"{site}@{occ}: torn rows {bad}")
        check("fleet_kill_matrix",
              matrix_ok and all(v == 1 for v in fired.values()),
              "; ".join(matrix_detail) + f" kills fired {fired}")
        try:
            fleet.assert_no_retrace()
            check("fleet_no_retrace_after_kills", True)
        except AssertionError as e:
            check("fleet_no_retrace_after_kills", False, str(e))
        fstats = fleet.latency_stats()
    finally:
        fleet.close()

    with tempfile.TemporaryDirectory(prefix="photon_selftest_") as root:
        sdir = os.path.join(root, "shard0")
        serving.shard_store(store, 2)[0].save(sdir)
        try:
            with checkpoint.fault_plan(
                    checkpoint.FaultPlan(errors={"store_open": 2})):
                back = serving.CoefficientStore.open(sdir, mmap=False,
                                                     device=dev)
            check("store_open_transient_retry",
                  back.order == store.order, "retried open lost the store")
        except OSError as e:
            check("store_open_transient_retry", False, str(e))
        killed = False
        try:
            with checkpoint.fault_plan(
                    checkpoint.FaultPlan.kill_at("store_open", 1)):
                serving.CoefficientStore.open(sdir, mmap=False, device=dev)
        except checkpoint.InjectedFault:
            killed = True
        reopened = serving.CoefficientStore.open(sdir, mmap=False,
                                                 device=dev)
        check("store_open_kill_then_clean_reopen",
              killed and reopened.order == store.order,
              "kill did not propagate or poisoned the store")

    failures = {k: v for k, v in checks.items() if v}
    return {"ok": not failures, "device": str(dev),
            "checks": {k: (v or "ok") for k, v in checks.items()},
            "latency": stats, "fleet_latency": fstats,
            "int8_launches": q_launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m photon_tpu_torch.serving",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not args.selftest:
        ap.print_help()
        return 2
    report = selftest(args.device)
    if args.json:
        print(json.dumps(report, default=str))
    else:
        for name, v in report["checks"].items():
            print(("ok   " if v == "ok" else "FAIL ") + name
                  + ("" if v == "ok" else f": {v}"))
        print(f"{len(report['checks'])} check(s), "
              f"{sum(v != 'ok' for v in report['checks'].values())} "
              f"failure(s) on {report['device']}")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
