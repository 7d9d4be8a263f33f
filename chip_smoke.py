#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's GAME serving path on one GPU.

    python3 chip_smoke.py [--seed N] [--requests N]

Phases (any failure exits non-zero):

1. build every kernel of the path from the sources in the checkout and
   hold each against its plain PyTorch version: the int8 serving rung on
   each of its four branches alone, then all four together, at small
   shapes (margins within rtol=1e-5, atol=1e-5: the kernel sums each row
   in another order than PyTorch; cold-miss rows equal the fixed-only
   margin exactly);
2. serve a seeded GAME model at the repo's widths — a fixed effect over a
   10,000,000-feature sparse space with 32 nonzeros per row and two
   random effects (100,000 users, 50,000 items, d=8, 8 slots per row) —
   from an int8 `ProgramLadder` (rungs 8–64, epsilon 0.5) through
   `MicroBatchDispatcher(max_batch=64, max_delay_us=200)`, with zipf(1.2)
   entity popularity (cold tail included) from 32 client threads; checks
   a sample of the answers against the f32 ladder and the plain int8
   version, `assert_no_retrace`, and that the rung went through the
   kernel (launch counts, reset just before the run, read just after);
3. time each kernel at the main path's shapes (CUDA events) beside its
   plain version and its bound, and print QPS and latency percentiles.

Output: the run's lines, then one ``{"kernels": [...]}`` JSON line, the
card's name and power limit as nvidia-smi reports them, and last
``{"ok": true, "device": {...}}``. Needs one CUDA device; exits non-zero
without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
TOL = dict(rtol=1e-5, atol=1e-5)

D_FIXED, K_FIXED = 10_000_000, 32
N_USERS, N_ITEMS, D_RE, K_RE = 100_000, 50_000, 8, 8
MAX_BATCH, MAX_DELAY_US, CLIENTS, WINDOW = 64, 200, 32, 4
EPSILON = 0.5


def log(*a) -> None:
    print(*a, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


# ------------------------------------------------------------ phase 1: kernels
def small_case(rng, parts, dev, B=33, E=9):
    """Rung operands for coordinates ``parts`` = [(kind, sparse), ...];
    sparse rows end in two padded slots (index 0, value 0)."""
    import torch

    from photon_tpu_torch.data.matrix import SparseRows, quantize_blocks

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    coords, shards, ids, fixed_ws, re_cs = [], {}, {}, {}, {}
    for c, (kind, sparse) in enumerate(parts):
        name, shard = f"c{c}", f"s{c}"
        d = 300 if kind == "fixed" else 12
        if sparse:
            idx = rng.integers(0, d, size=(B, 7))
            val = rng.normal(size=(B, 7))
            idx[:, -2:], val[:, -2:] = 0, 0.0
            shards[shard] = SparseRows(t(idx, np.int32), t(val, np.float32),
                                       d)
        else:
            shards[shard] = t(rng.normal(size=(B, d)), np.float32)
        if kind == "fixed":
            q, s = quantize_blocks(rng.normal(size=d), "int8")
            fixed_ws[name] = (t(q, np.int8), t([s], np.float32))
        else:
            w = rng.normal(size=(E + 1, d))
            w[E] = 0.0  # the cold-miss row
            q, s = quantize_blocks(w, "int8")
            re_cs[name] = (t(q, np.int8), t(s, np.float32))
            ids[name] = t(rng.integers(0, E + 1, size=B), np.int32)
        coords.append((name, kind, shard))
    offsets = t(rng.normal(size=B), np.float32)
    return [tuple(coords), offsets, shards, ids, fixed_ws, re_cs], E


def phase_kernels(dev) -> None:
    import torch

    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.kernels import serving as KS

    t0 = time.perf_counter()
    KS.library()
    log(f"phase 1: built {KS.KERNEL} from {KS.SOURCE.name} in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(11)
    cases = {"fixed dense": [("fixed", False)],
             "fixed sparse": [("fixed", True)],
             "random dense": [("random", False)],
             "random sparse": [("random", True)]}
    cases["all four"] = [p for ps in cases.values() for p in ps]
    with K.scope("on"):
        for label, parts in cases.items():
            args, E = small_case(rng, parts, dev)
            got = KS.int8_margin(*args)
            want = KS.int8_margin_reference(*args)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       **TOL, err_msg=label)
            log(f"phase 1: {label:13s} kernel vs plain max |err| {err:.3g}")
        # cold-miss rows: every entity unseen -> exactly the fixed margin
        args, E = small_case(rng, cases["all four"], dev)
        coords, offsets, shards, ids, fixed_ws, re_cs = args
        ids = {n: torch.full_like(e, E) for n, e in ids.items()}
        got = KS.int8_margin(coords, offsets, shards, ids, fixed_ws, re_cs)
        fixed_only = KS.int8_margin(
            tuple(c for c in coords if c[1] == "fixed"), offsets, shards,
            ids, fixed_ws, re_cs)
        torch.cuda.synchronize()
        if not torch.equal(got, fixed_only):
            raise AssertionError("cold-miss rows differ from the fixed-only "
                                 "margin")
        log("phase 1: cold-miss rows equal the fixed-only margin exactly")


# ------------------------------------------------------------- phase 2: serve
def build_store(seed: int, dev):
    from photon_tpu_torch.convert import game_model_from_arrays
    from photon_tpu_torch.serving import CoefficientStore

    rng = np.random.default_rng(seed)
    users = np.asarray([f"u{i:06d}" for i in range(N_USERS)])
    items = np.asarray([f"i{i:06d}" for i in range(N_ITEMS)])
    model = game_model_from_arrays("logistic", {
        "global": {"type": "fixed", "feature_shard": "global",
                   "means": 0.1 * rng.standard_normal(D_FIXED,
                                                      np.float32)},
        "perUser": {"type": "random", "feature_shard": "userFeatures",
                    "entity_name": "userId", "entity_keys": users,
                    "coefficients": 0.3 * rng.standard_normal(
                        (N_USERS, D_RE), np.float32)},
        "perItem": {"type": "random", "feature_shard": "itemFeatures",
                    "entity_name": "itemId", "entity_keys": items,
                    "coefficients": 0.3 * rng.standard_normal(
                        (N_ITEMS, D_RE), np.float32)},
    }, device=dev)
    return CoefficientStore.from_game_model(model, device=dev)


def make_requests(seed: int, n: int) -> list:
    from photon_tpu_torch.serving import ScoreRequest

    rng = np.random.default_rng(seed + 1)
    g_idx = rng.integers(0, D_FIXED, size=(n, K_FIXED), dtype=np.int32)
    g_val = rng.standard_normal((n, K_FIXED), np.float32)
    u_idx = rng.integers(0, D_RE, size=(n, K_RE), dtype=np.int32)
    u_val = rng.standard_normal((n, K_RE), np.float32)
    i_idx = rng.integers(0, D_RE, size=(n, K_RE), dtype=np.int32)
    i_val = rng.standard_normal((n, K_RE), np.float32)
    # zipf(1.2) popularity; ranks past the entity count are the cold tail
    u_rank = rng.zipf(1.2, size=n) - 1
    i_rank = rng.zipf(1.2, size=n) - 1
    return [ScoreRequest(
        features={"global": (g_idx[r], g_val[r]),
                  "userFeatures": (u_idx[r], u_val[r]),
                  "itemFeatures": (i_idx[r], i_val[r])},
        entities={"userId": f"u{u_rank[r]:06d}",
                  "itemId": f"i{i_rank[r]:06d}"},
        offset=0.0) for r in range(n)]


def serve(ladder, reqs: list) -> tuple:
    """Send ``reqs`` from CLIENTS threads (each keeps WINDOW in flight);
    returns (scores, wall_s, latency_stats, batches)."""
    from photon_tpu_torch import telemetry
    from photon_tpu_torch.serving import MicroBatchDispatcher

    scores = [None] * len(reqs)
    errors: list = []
    disp = MicroBatchDispatcher(ladder, max_batch=MAX_BATCH,
                                max_delay_us=MAX_DELAY_US)

    def client(c: int) -> None:
        try:
            mine = list(range(c, len(reqs), CLIENTS))
            for lo in range(0, len(mine), WINDOW):
                window = mine[lo:lo + WINDOW]
                futs = [disp.submit(reqs[r]) for r in window]
                for r, f in zip(window, futs):
                    scores[r] = f.result(timeout=120)
        except Exception as e:  # reported by the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(CLIENTS)]
    batches0 = telemetry.snapshot()["counters"].get("serving.batches", 0)
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    disp.close()
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise AssertionError("a client thread did not finish")
    batches = telemetry.snapshot()["counters"]["serving.batches"] - batches0
    return np.asarray(scores, np.float64), wall, disp.latency_stats(), batches


def score_direct(ladder, reqs: list):
    """Score ``reqs`` through ``ladder`` in top-rung batches on the calling
    thread (the reference answers for the sample check)."""
    from photon_tpu_torch.serving.dispatcher import _Pending, collate_rung_args

    out = []
    for lo in range(0, len(reqs), ladder.max_batch):
        chunk = [_Pending(r) for r in reqs[lo:lo + ladder.max_batch]]
        offsets, shards, ids, _ = collate_rung_args(
            ladder, chunk, ladder.bucket_for(len(chunk)))
        out.append(ladder.score_padded(offsets, shards, ids)
                   .cpu().numpy()[:len(chunk)])
    return np.concatenate(out).astype(np.float64)


# ------------------------------------------------------------ phase 3: timing
def time_ms(fn, n: int = 200, warm: int = 20) -> float:
    import torch

    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def device_ms(fn, kernel_symbol: str, n: int = 50):
    """Mean device time of the CUDA kernels whose name holds
    ``kernel_symbol`` per call of ``fn``, from a `torch.profiler` trace;
    None when the trace holds no device time for them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.key_averages():
        if kernel_symbol in ev.key:
            total_us += getattr(ev, "device_time_total",
                                getattr(ev, "cuda_time_total", 0.0))
    return total_us / n / 1e3 if total_us > 0 else None


def rung_bound(coords, offsets, shards, ids, fixed_ws, re_cs) -> tuple:
    """(bound_ms, bound_by) of one int8 rung on these inputs: the bytes it
    must move (request slots, ids, offsets, the margin, and the distinct
    int8 coefficients and scales these rows touch) over HBM bandwidth, vs
    its f32 operations (dequant multiply + multiply-add per slot) over
    the f32 peak."""
    B = int(offsets.shape[0])
    nbytes = 8 * B  # offsets in, margin out
    ops = 0
    for name, kind, shard in coords:
        X = shards[shard]
        idx = X.indices.cpu().numpy().astype(np.int64)
        slots = idx.size
        nbytes += 8 * slots  # int32 index + f32 value per slot
        ops += 3 * slots
        if kind == "fixed":
            nbytes += np.unique(idx).size + 4
        else:
            e = ids[name].cpu().numpy().astype(np.int64)
            d = int(re_cs[name][0].shape[1])
            nbytes += 4 * B  # ids
            nbytes += np.unique(e[:, None] * d + idx).size  # int8 q
            nbytes += 4 * np.unique(e).size  # row scales
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=4096)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.kernels import serving as KS
    from photon_tpu_torch.serving import ProgramLadder
    from photon_tpu_torch.serving.dispatcher import _Pending, collate_rung_args

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gpu = gpu_line()
    log(f"device: {torch.cuda.get_device_name(0)} ({gpu}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    phase_kernels(dev)

    t0 = time.perf_counter()
    store = build_store(args.seed, dev)
    spec = dict(floor=8, max_batch=MAX_BATCH, output_mean=True,
                sparse_k={"global": K_FIXED, "userFeatures": K_RE,
                          "itemFeatures": K_RE})
    ladder = ProgramLadder(store, quantize="int8", quant_epsilon=EPSILON,
                           **spec)
    ladder.warmup()
    f32 = ProgramLadder(store, **spec)
    f32.warmup()
    reqs = make_requests(args.seed, args.requests)
    log(f"phase 2: model + ladders ready in {time.perf_counter() - t0:.1f} s;"
        f" rungs {ladder.ladder}; int8 gate {ladder.quant_report}")

    K.reset_launch_counts()
    scores, wall, lat, batches = serve(ladder, reqs)
    launches = K.launch_counts()
    if not np.isfinite(scores).all() or not ((scores > 0)
                                             & (scores < 1)).all():
        raise AssertionError("served scores are not finite probabilities")
    if launches.get(KS.KERNEL, 0) == 0:
        raise AssertionError(f"{KS.KERNEL} was never launched while serving")
    n_sigs = ladder.assert_no_retrace()
    n_cold = sum(1 for r in reqs
                 if int(r.entities["userId"][1:]) >= N_USERS
                 or int(r.entities["itemId"][1:]) >= N_ITEMS)
    log(f"phase 2: served {len(reqs)} requests ({n_cold} with a cold "
        f"entity) in {batches} batches; {n_sigs} rung signatures; "
        f"launches {launches}")

    sample = np.random.default_rng(args.seed + 2).choice(
        len(reqs), size=256, replace=False)
    picked = [reqs[i] for i in sample]
    want32 = score_direct(f32, picked)
    with K.scope("off"):
        want_plain = score_direct(ladder, picked)
    got = scores[sample]
    np.testing.assert_allclose(got, want_plain, **TOL)
    d32 = float(np.abs(got - want32).max())
    if d32 > EPSILON / 4:  # sigmoid is 1/4-Lipschitz in the margin
        raise AssertionError(f"int8 answers differ from the f32 ladder by "
                             f"{d32} > {EPSILON / 4}")
    log(f"phase 2: sample of 256 answers: max |int8 - plain int8| "
        f"{float(np.abs(got - want_plain).max()):.3g}, max |int8 - f32| "
        f"{d32:.3g} (probabilities)")

    # phase 3: each rung's operands from real requests, kernel vs plain
    quant = ladder._quant_blocks()
    rows = {}
    for B in ladder.ladder:
        pend = [_Pending(r) for r in reqs[:B]]
        offsets, shards, ids, _ = collate_rung_args(ladder, pend, B)
        rung = (ladder.coords,) + ladder._upload(offsets, shards, ids) + quant
        with K.scope("on"):
            got = KS.int8_margin(*rung)
            want = KS.int8_margin_reference(*rung)
            torch.cuda.synchronize()
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       **TOL)
            err = float((got - want).abs().max().item())
            ms = time_ms(lambda: KS.int8_margin(*rung))
            plain_ms = time_ms(lambda: KS.int8_margin_reference(*rung))
            dev_ms = device_ms(lambda: KS.int8_margin(*rung),
                               "serving_int8_margin_kernel")
        bound_ms, bound_by = rung_bound(*rung)
        rows[B] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by)
        dev_txt = ("not measured" if dev_ms is None
                   else f"{dev_ms * 1e3:.2f} us")
        log(f"phase 3: rung B={B:3d}: kernel {ms * 1e3:.2f} us per call "
            f"(device time of the kernel alone {dev_txt}), plain "
            f"{plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.4f} us "
            f"({bound_by}), max |err| {err:.3g}  [{gpu}]")
    # one top-rung flush's host side, on this thread alone (no clients)
    pend = [_Pending(r) for r in reqs[:MAX_BATCH]]
    t0 = time.perf_counter()
    for _ in range(50):
        host_args = collate_rung_args(ladder, pend, MAX_BATCH)[:3]
    collate_ms = (time.perf_counter() - t0) / 50 * 1e3
    t0 = time.perf_counter()
    for _ in range(50):
        ladder.score_padded(*host_args)
        torch.cuda.synchronize()
    flush_ms = (time.perf_counter() - t0) / 50 * 1e3
    log(f"phase 3: one B={MAX_BATCH} flush on an idle thread: collate "
        f"{collate_ms:.3f} ms, upload + rung + synchronize {flush_ms:.3f} ms"
        f"  [{gpu}]")
    top = rows[MAX_BATCH]
    log(f"phase 3: QPS {len(reqs) / wall:.1f}; latency p50 "
        f"{lat['p50_ms']:.3f} ms, p99 {lat['p99_ms']:.3f} ms over "
        f"{lat['n']} requests; mean {KS.KERNEL} time per B={MAX_BATCH} rung "
        f"{top['ms'] * 1e3:.2f} us  [{gpu}]")
    print(json.dumps({"kernels": [{
        "name": KS.KERNEL, "route": "cuda",
        "source": "photon_tpu_torch/kernels/csrc/serving_int8.cu",
        "replaces": "photon_tpu/kernels/serving.py:69",
        "launches": int(launches[KS.KERNEL]), "max_abs_err": top["err"],
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": None}]}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
