"""Ingest-plane selftest CLI (port of `photon_tpu/ingest/__main__.py`):
the whole data plane as one smoke.

    python -m photon_tpu_torch.ingest --selftest [--json] [--device cpu]

Runs on a canned Avro container directory under a temporary directory;
the decoded chunks go onto the card unless given ``--device cpu``:

- ``scan``          — `scan_ingest` builds the maps and the block index
  in ONE pass; `scan_row_counts` answers from the index without
  reopening the files.
- ``decode_parity`` — worker-pool chunks (thread and process modes) equal
  the serial stream's bit for bit, in order, also under an injected
  ``ingest_worker`` kill (that chunk decodes in-process; never a hung
  iterator).
- ``cache``         — a cold decode commits the columnar cache and the
  cached epoch re-reads bit for bit with Avro untouched; a kill at the
  last ``cache_commit`` leaves a manifest-less (torn) entry that reads as
  a miss and falls back to Avro; a corrupted payload is caught by its
  CRC; a changed chunk layout misses under its new key.
- ``ladder``        — the direct-to-blocked-ELL build round-trips the
  ladder cache leaf for leaf, and both ladders stream onto the device
  through the upload ring with equal chunks.
- ``prefetch``      — the stall-driven controller widens under stall,
  narrows when stall-free, and honors its byte budget.

- ``contracts`` — the plane's contract (`analysis/`:
  ``ingest_plane_chunk_invariance``) holds on the same device.

Exit status: 0 iff every check passed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def _same(a, b) -> bool:
    import numpy as np
    import torch

    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return bool(torch.equal(torch.as_tensor(a), torch.as_tensor(b)))
    return bool(np.array_equal(np.asarray(a), np.asarray(b)))


def _chunks_equal(a, b) -> bool:
    from photon_tpu_torch.data.matrix import SparseRows

    if not (_same(a.y, b.y) and _same(a.weights, b.weights)
            and _same(a.offsets, b.offsets)):
        return False
    for s, X in a.shards.items():
        Y = b.shards[s]
        if isinstance(X, SparseRows):
            if not (_same(X.indices, Y.indices)
                    and _same(X.values, Y.values)):
                return False
        elif not _same(X, Y):
            return False
    return all(_same(col, b.entity_ids[e])
               for e, col in a.entity_ids.items())


def _write_data(root: str) -> tuple:
    """Two Avro parts of 420 rows (blocks of 110) and their config."""
    import numpy as np

    from photon_tpu_torch.data.avro_io import write_avro
    from photon_tpu_torch.data.feature_bags import FeatureShardConfig
    from photon_tpu_torch.data.ingest import (GameDataConfig,
                                              training_example_schema)

    rng = np.random.default_rng(14)
    schema = training_example_schema(feature_bags=("f", "g"),
                                     entity_fields=("member",))
    for fi in range(2):
        records = []
        for i in range(420):
            fb = [{"name": "age", "term": "", "value": float(rng.normal())},
                  {"name": "ctr", "term": "", "value": float(rng.normal())}]
            gb = [{"name": f"id{int(v)}", "term": "t",
                   "value": float(rng.normal())}
                  for v in rng.integers(0, 300, size=3)]
            records.append({"response": float(rng.integers(0, 2)),
                            "offset": float(rng.normal()) if i % 3 == 0
                            else None,
                            "weight": 2.0 if i % 5 == 0 else None,
                            "uid": f"r{fi}_{i}",
                            "member": f"m{int(rng.integers(0, 23))}",
                            "f": fb, "g": gb})
        write_avro(os.path.join(root, f"part-{fi:03d}.avro"), records,
                   schema, block_records=110)
    return GameDataConfig(
        shards={"dense": FeatureShardConfig(bags=("f",), has_intercept=True),
                "wide": FeatureShardConfig(bags=("g",), has_intercept=False,
                                           dense_threshold=4)},
        entity_fields=("member",))


def run_selftest(device: str = "cuda") -> dict:
    import shutil
    import tempfile

    from photon_tpu_torch.checkpoint.faults import (FaultPlan, InjectedFault,
                                                    fault_plan, record_sites)
    from photon_tpu_torch.data import chunk_cache as cc
    from photon_tpu_torch.data.ingest_plane import (AdaptivePrefetch,
                                                    chunk_blocked_ell_from_avro,
                                                    iter_game_chunks_parallel,
                                                    open_chunk_source)
    from photon_tpu_torch.data.streaming import (iter_game_chunks,
                                                 scan_ingest,
                                                 scan_row_counts)
    from photon_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    checks: dict = {}
    tmp = tempfile.mkdtemp(prefix="photon_ingest_selftest_")
    try:
        root = os.path.join(tmp, "data")
        os.makedirs(root)
        config = _write_data(root)

        # --- scan: one pass, counts answered from the index -------------
        scan = scan_ingest(root, config)
        maps = scan.index_maps
        counts = scan_row_counts(root, block_index=scan.block_index)
        checks["scan"] = {"ok": scan.n_rows == 840 and counts == [420, 420]
                          and len(scan.block_index) == 2,
                          "n_rows": scan.n_rows, "counts": counts}

        _, c0 = iter_game_chunks(root, config, maps, chunk_rows=250,
                                 sparse_k=4)
        ref = list(c0)

        # --- decode parity: thread + process pools, worker-kill degrade --
        def parity(mode, plan=None):
            def read():
                _, c = iter_game_chunks_parallel(
                    root, config, maps, chunk_rows=250, sparse_k=4,
                    workers=2, mode=mode, block_index=scan.block_index)
                return list(c)

            if plan is not None:
                with fault_plan(plan):
                    got = read()
            else:
                got = read()
            return (len(got) == len(ref)
                    and all(_chunks_equal(a, b) for a, b in zip(ref, got)))

        ok_thread = parity("thread")
        ok_proc = parity("process")
        ok_killed = parity("thread", FaultPlan.kill_at("ingest_worker", 2))
        checks["decode_parity"] = {
            "ok": ok_thread and ok_proc and ok_killed, "thread": ok_thread,
            "process": ok_proc, "worker_kill_degrade": ok_killed,
            "n_chunks": len(ref)}

        # --- cache: cold -> cached parity, torn commit, CRC, key ---------
        cache = os.path.join(tmp, "cache")

        def source():
            _, c = open_chunk_source(root, config, maps, chunk_rows=250,
                                     sparse_k=4, cache_dir=cache)
            return list(c)

        # a dry run counts the cache_commit occurrences; the kill lands at
        # the LAST (the manifest commit itself)
        with record_sites() as rec:
            cold = source()
        n_hits = rec.hits.get("cache_commit", 0)
        shutil.rmtree(cache)
        killed = False
        try:
            with fault_plan(FaultPlan.kill_at("cache_commit", n_hits)):
                source()
        except InjectedFault:
            killed = True
        key = cc.cache_key(root, config, maps, 250, 4)
        torn_is_miss = cc.open_cache(cache, key, "game_chunks") is None
        rebuilt = source()
        cached = source()
        cache_parity = all(
            len(got) == len(ref)
            and all(_chunks_equal(a, b) for a, b in zip(ref, got))
            for got in (cold, rebuilt, cached))
        # corruption: flip payload bytes, expect detection
        bag = cc.open_cache(cache, key, "game_chunks")
        f0 = os.path.join(bag.dir, bag.manifest["entries"][0]["file"])
        with open(f0, "rb") as fh:
            raw = fh.read()
        # photon: allow(durable_write, deliberate corruption of a scratch cache payload — the CRC-detection selftest)
        with open(f0, "wb") as fh:  # a scratch cache payload, corrupted
            fh.write(raw[:-4] + b"\x00\x01\x02\x03")
        corrupt_detected = False
        try:
            source()
        except cc.ChunkCacheCorrupt:
            corrupt_detected = True
        # a changed layout keys elsewhere: a cold decode, no corrupt read
        key2 = cc.cache_key(root, config, maps, 300, 4)
        new_key_missed = (key2 != key and cc.open_cache(
            cache, key2, "game_chunks") is None)
        checks["cache"] = {
            "ok": bool(killed and torn_is_miss and cache_parity
                       and corrupt_detected and new_key_missed),
            "kill_mid_commit": killed, "torn_is_miss": torn_is_miss,
            "parity": cache_parity, "corruption_detected": corrupt_detected,
            "layout_change_misses": new_key_missed,
            "commit_occurrences": n_hits}

        # --- ladder: the direct build round-trips its cache --------------
        lcache = os.path.join(tmp, "ladder")
        cbs = [chunk_blocked_ell_from_avro(root, config, maps, "wide", 256,
                                           d_dense=64, sparse_k=4,
                                           cache_dir=lcache)
               for _ in range(2)]
        from photon_tpu_torch.data.dataset import _leaves

        host_ok = (cbs[0].X.n_chunks == cbs[1].X.n_chunks
                   and all(_same(a, b) for c0_, c1_ in zip(cbs[0].X.chunks,
                                                           cbs[1].X.chunks)
                           for a, b in zip(_leaves(c0_), _leaves(c1_)))
                   and _same(cbs[0].y, cbs[1].y)
                   and _same(cbs[0].X.perm_cols, cbs[1].X.perm_cols))
        rings = [cb.device_ring(device=dev) for cb in cbs]
        dev_ok = all(
            i == j and all(_same(a, b) for a, b in zip(_leaves(b0.X),
                                                       _leaves(b1.X)))
            for (i, b0), (j, b1) in zip(rings[0].stream_pass(prime=False),
                                        rings[1].stream_pass(prime=False)))
        checks["ladder"] = {"ok": bool(host_ok and dev_ok),
                            "n_chunks": cbs[0].X.n_chunks,
                            "device": str(dev)}

        # --- prefetch controller -----------------------------------------
        ap = AdaptivePrefetch(depth=2, max_depth=8, byte_budget=1000)
        ap.observe(stall_s=1.0, compute_s=0.1, n_items=4, item_bytes=100)
        widened = ap.depth == 4
        ap.observe(stall_s=0.0, compute_s=1.0, n_items=4, item_bytes=100)
        narrowed = ap.depth == 3
        ap.observe(stall_s=5.0, compute_s=0.1, n_items=4, item_bytes=200)
        capped = ap.depth == 5  # byte budget 1000 // 200
        checks["prefetch"] = {"ok": widened and narrowed and capped,
                              "decisions": [d["why"] for d in ap.decisions]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    from photon_tpu_torch.analysis.contracts import check_names

    checks["contracts"] = check_names(("ingest_plane_chunk_invariance",),
                                      str(dev))
    return {"ok": all(c["ok"] for c in checks.values()), "checks": checks,
            "device": str(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m photon_tpu_torch.ingest",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not args.selftest:
        ap.print_help()
        return 2
    report = run_selftest(args.device)
    if args.json:
        print(json.dumps(report))
    else:
        parts = [f"{k}={'ok' if v['ok'] else 'FAIL'}"
                 for k, v in report["checks"].items()]
        print("ingest selftest: " + " ".join(parts))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
