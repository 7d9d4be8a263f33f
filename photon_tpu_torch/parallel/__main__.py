"""CLI: the multi-process mesh spine's self-test (port of
`photon_tpu/parallel/__main__.py`).

    python -m photon_tpu_torch.parallel --selftest [--device cpu|cuda]
        [--backend gloo|nccl] [--json]

Runs on the card unless given ``--device cpu``; ``--backend`` is the
launched groups' (default: NCCL on CUDA, which needs a card per process;
name gloo to run every process on one card). The legs, each in SPAWNED
cluster members (`parallel.launch`; the independent launches of a leg
run side by side, each cluster on its own rendezvous port):

1. spine bit-identity: the `psum_signature` program at 1, 2 and 4
   processes over the same 8-slot mesh gives one digest, equal to this
   process's in-process mesh;
2. the per-process ingest, in the same launches:
   ``stream_to_device(local_only=True)`` then a resident mesh solve at 1,
   2 and 4 processes — coefficients bit for bit equal to this process's
   8-slot mesh's, and every rank of 2 and 4 skipped chunks
   (``ingest.chunks_skipped`` > 0) and decoded some; and GAME on the
   mesh (`selfcheck.game_fit`: entity lanes over the slots, one gather a
   bucket) — one digest at 1, 2 and 4 processes, equal to this
   process's;
3. elastic restore: a 2-process mesh-streamed solve killed mid-run
   commits ``p<k>_`` payloads with per-slot row caches; 1- and 4-process
   clusters restore them (each from its own copy of the snapshot) and
   finish bit for bit equal to an uninterrupted run in this process;
4. barrier-correct commits: rank 1 killed between its durable payload
   and the commit barrier — rank 0's commit fails loudly within
   ``PHOTON_TPU_BARRIER_TIMEOUT_S`` and the previous manifest still
   restores;
5. cross-rank aggregation: the 2-process launch of leg 1 writes one
   telemetry file a rank (``p<k>.jsonl``), merged by
   `telemetry.aggregate.aggregate_cluster` into one complete report —
   both ranks, none missing, the straggler named, and the decoded
   chunks summed to the ranks' own counts.

Exit 1 on any failure (a host that cannot form even a localhost group
fails too).
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor


def _build_first(device: str) -> None:
    """Everything a child would build, built here before any child
    starts: a child killed mid-build would leave the build's lock."""
    from photon_tpu_torch import native

    native.get_lib()
    if device.startswith("cuda"):
        from photon_tpu_torch.kernels import blocked_ell, fused, serving

        for mod in (serving, blocked_ell, fused):
            mod.library()


def selftest(device: str = "cuda", backend=None) -> dict:
    import pathlib

    from photon_tpu_torch.checkpoint import SnapshotStore
    from photon_tpu_torch.device import resolve_device
    from photon_tpu_torch.parallel import selfcheck as sc
    from photon_tpu_torch.parallel.launch import launch
    from photon_tpu_torch.parallel.mesh import make_mesh

    device = str(resolve_device(device))
    _build_first(device)
    report: dict = {"checks": {}, "device": device, "backend": backend}
    ok = True

    def check(name: str, passed: bool, detail: str = "") -> None:
        nonlocal ok
        report["checks"][name] = {"ok": bool(passed),
                                  **({"detail": detail} if detail else {})}
        ok = ok and bool(passed)

    def run(target, n, *args, **kw):
        return launch(target, n, args=args, device=device, backend=backend,
                      timeout_s=300, **kw)

    def run_side_by_side(calls):
        """[run(target, n, *args)] of each (target, n, args), the
        clusters launched together."""
        with ThreadPoolExecutor(len(calls)) as pool:
            futures = [pool.submit(run, t, n, *a) for t, n, a in calls]
            return [f.result() for f in futures]

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="photon_mesh_selftest_"))
    try:
        # ---- 1.-2. one digest and one local_only solve at every process
        # count and in-process (each launch runs both)
        mesh8 = make_mesh(n_devices=8, device=device)
        data = sc.write_e2e_dataset(tmp / "data")
        want = sc.stream_solve(data, mesh8)
        digests = {"in-process": [sc.psum_signature(mesh8)]}
        counts = (1, 2, 4)
        tele = tmp / "telemetry"  # the 2-process launch's rank files
        solved = dict(zip(counts, run_side_by_side(
            [(sc.target_stream_solve, n,
              (str(data), str(tele)) if n == 2 else (str(data),))
             for n in counts])))
        for n, res in solved.items():
            digests[n] = sorted({r["psum_digest"] for r in res})
        one = {d for ds in digests.values() for d in ds}
        report["digest"] = sorted(one)[0] if len(one) == 1 else None
        check("psum_bit_identity_1_2_4", len(one) == 1, f"{digests}")
        report["ingest_split"] = {
            n: [(r["rank"], r["chunks_decoded"], r["chunks_skipped"])
                for r in res] for n, res in solved.items() if n > 1}
        got = {n: sorted({r["digest"] for r in res})
               for n, res in solved.items()}
        check("local_only_solve_bit_identical",
              all((r["w"] == want["w"]).all()
                  for res in solved.values() for r in res),
              f"in-process {want['digest']}, by process count {got}")
        games = {n: sorted({r["game_digest"] for r in res})
                 for n, res in solved.items()}
        game_want = sc.game_fit(mesh8)["digest"]
        report["game_digest"] = game_want
        check("game_bit_identity_1_2_4",
              all(g == [game_want] for g in games.values()),
              f"in-process {game_want}, by process count {games}")
        check("local_only_ingest_split",
              all(r["chunks_skipped"] > 0 and r["chunks_decoded"] > 0
                  for n, res in solved.items() if n > 1 for r in res),
              f"(rank, decoded, skipped)={report['ingest_split']}")

        # ---- 5. the 2-process launch's rank files -> one cluster report
        from photon_tpu_torch.telemetry.aggregate import aggregate_cluster

        agg = aggregate_cluster(str(tele), expect_ranks=2)
        decoded = sum(r["chunks_decoded"] for r in solved[2])
        report["aggregate"] = {
            "straggler_rank": agg["skew"]["straggler_rank"],
            "barrier_wait_s": agg["skew"]["barrier_wait_s"]["per_rank"],
            "clock_skew_s": agg["clock_skew_s"]}
        check("cross_rank_aggregation",
              agg["complete"] and agg["n_ranks"] == 2
              and not agg["missing_ranks"]
              and agg["skew"]["straggler_rank"] in (0, 1)
              and agg["counters_total"].get("ingest.chunks", 0) == decoded,
              f"n_ranks={agg['n_ranks']} missing={agg['missing_ranks']} "
              f"straggler={agg['skew']['straggler_rank']} "
              f"chunks={agg['counters_total'].get('ingest.chunks')} "
              f"decoded={decoded}")

        # ---- 3. a 2-process snapshot restored at 1 and at 4 processes
        ref = sc._digest(sc.solve_chunked(mesh8))
        ck = tmp / "snap"
        killed = run(sc.target_snapshot_kill, 2, str(ck), "evaluation", 7)
        check("two_proc_kill_commits",
              all(r["killed"] and r["latest_seq"] >= 0 for r in killed),
              f"{[(r['rank'], r['killed'], r['latest_seq']) for r in killed]}")
        shutil.copytree(ck, tmp / "snap_4")
        resumed = run_side_by_side([(sc.target_resume_solve, 1, (str(ck),)),
                                    (sc.target_resume_solve, 4,
                                     (str(tmp / "snap_4"),))])
        for resume_n, res in zip((1, 4), resumed):
            check(f"restore_at_{resume_n}_bit_identical",
                  all(r["digest"] == ref and r["restored"] >= 1
                      for r in res),
                  f"ref={ref} got={[r['digest'] for r in res]}")

        # ---- 4. a kill between the payload write and the commit barrier
        ck2 = tmp / "commit_kill"
        res = run(sc.target_commit_kill, 2, str(ck2), 1, 2,
                  env={"PHOTON_TPU_BARRIER_TIMEOUT_S": "8"})
        by_rank = {r["rank"]: r for r in res}
        report["commit_kill"] = {r: (v["outcome"], round(v["seconds"], 3))
                                 for r, v in by_rank.items()}
        check("commit_kill_is_loud",
              by_rank[1]["outcome"] == "killed"
              and by_rank[0]["outcome"] == "commit_failed",
              f"{report['commit_kill']}")
        store = SnapshotStore(str(ck2))
        loaded = store.load_latest()
        check("previous_manifest_still_restores",
              store.latest_seq() == 0 and loaded is not None,
              f"latest_seq={store.latest_seq()}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report["ok"] = ok
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m photon_tpu_torch.parallel",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    if not args.selftest:
        ap.print_help()
        return 2
    report = selftest(args.device, args.backend)
    if args.json:
        print(json.dumps(report, default=str))
    else:
        for name, entry in report["checks"].items():
            status = "ok" if entry["ok"] else "FAIL"
            detail = f"  ({entry['detail']})" if entry.get("detail") else ""
            print(f"  {name}: {status}{detail}")
        print(f"parallel selftest ({report['device']}, backend "
              f"{report['backend'] or 'default'}):",
              "ok" if report["ok"] else "FAILED")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
