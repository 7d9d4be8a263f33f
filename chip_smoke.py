#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's GAME serving path, its sparse logistic
GLM training path, its dense OWL-QN / TRON training path, its
reg-weight grids, its streamed (out-of-device-memory) training, its
GAME training, its validation-driven model selection (the vectorized
fixed-effect and GAME grids), its drivers (Avro in, model directory
and scored Avro out) and its streamed data plane (the native Avro
decoder, the ingest plane, the training driver's streamed regimes) and
its continual refresh (delta plan, compacted re-solve, hot swap into a
live int8 ladder), its elastic runs (checkpoint/restore of the
streamed solvers, GAME's descent and the training driver), its
multi-GPU GLM training (the slot mesh in one process and in several) and
GAME on the mesh (entity lanes over the slots, the mesh refresh, the
driver and the GAME grid on a mesh), its run telemetry (JSONL runs, the
solver taps, request tracing), its replica fleet on one GPU, its
Bayesian reg-weight tuners and model diagnostics, and its attribution
ledger and self-test CLIs.

    python3 chip_smoke.py [--seed N] [--requests N]

Phases (any failure exits non-zero):

0. build every kernel source in the checkout (serving_int8.cu,
   blocked_ell.cu, fused_vg.cu), all three builds started together beside
   an ``nvcc -Xptxas -v`` compile of each and the native Avro decoder's
   host library (g++), and print each one's build seconds, and the
   registers and spills of the blocked-ELL kernels' 8-lane
   instantiations (the lane grid's);
1. print the int8 serving rung's registers and spills (ptxas -v) and hold
   it against its plain PyTorch version: each of its four branches alone,
   all four together, and 20 coordinates (two launches; equal bit for bit
   to the first 16 then the last 4 from their margins), at small shapes
   (margins within rtol=1e-5, atol=1e-5: the kernel sums each row in
   another order than PyTorch; cold-miss rows equal the fixed-only margin
   exactly, with 4 and with 20 coordinates);
2. serve a seeded GAME model at the repo's widths — a fixed effect over a
   10,000,000-feature sparse space with 32 nonzeros per row and two
   random effects (100,000 users, 50,000 items, d=8, 8 slots per row) —
   from an int8 `ProgramLadder` (rungs 8–64, epsilon 0.5) through
   `MicroBatchDispatcher(max_batch=64, max_delay_us=200)`, with zipf(1.2)
   entity popularity (cold tail included) from 32 client threads; checks
   a sample of the answers against the f32 ladder and the plain int8
   version, `assert_no_retrace`, and that the rung went through the
   kernel (launch counts, reset just before the run, read just after);
3. time the serving kernel at the main path's shapes (CUDA events) beside
   its plain version and its bound, the top rung's device time with a warm
   and a cold L2 beside an empty kernel of the same grid (the floor of any
   launch), and print QPS and latency percentiles;
T1. print the tail matvec and rmatvec kernels' registers and spills
   (ptxas -v); hold the four blocked-ELL kernels (fused and tiled tail
   matvec, fused and tiled occurrence-bucket rmatvec) against their plain
   versions at small shapes (rtol=atol=1e-5), f32 and bf16 storage, a
   vector and 1, 3 and 8 lanes, ``square`` on and off, on layouts with a
   bucket smaller than one tile, buckets of many tiles, rows with no tail,
   and occurrence buckets of every width from 1 to 4,096 slots (every
   class of the rmatvec's work plan) with one of a single column; the tail
   matvec's fused form, a second fused launch and the tiled form agree bit
   for bit, and both forms added into an ``out=`` slice (NaN guard rows
   around it) give its starting values + the fused form, bit for bit; the
   rmatvec's fused form, a second fused launch, the tiled form and the
   tiled form into a preallocated ``out=`` slice agree bit for bit; and
   the hot block's bf16 product (cuBLAS, f32 output);
T2. train L2 logistic regression at the bench headline's width — 10,000,000
   features, 32 zipf(1.4) nonzeros + an intercept per row, a 1,024-column
   bf16 hot block, 2^21 rows, reg 1e-3, history 5, tolerance 0 —
   through `train_glm`: (a) 40 iterations on the default route (timed;
   the launch counts are reset just before and read just after, SIMPLE
   variances included), (b) 5 iterations with the kernels' budget at 0
   (the tiled forms), (c) 5 iterations under ``scope("off")`` (the plain
   versions on the card); the loss histories agree within rtol 1e-5, the
   variances within rtol 1e-4 of the plain version's; (a) launches only
   the fused forms, (b) only the tiled ones; peak device memory after the
   layout, over solve (a) and over its SIMPLE variances with the hot
   block squared in row chunks and squared whole; a profiled 5-iteration
   solve's device-busy share, the blocked-ELL kernels' shares of it and
   every device op it ran; the device ops of one matvec on each route;
T3. time each blocked-ELL kernel at (a)'s shapes beside its plain version,
   its bound and cuSPARSE's SpMV of the same tail as f32 CSR, with a warm
   L2 (a loop of calls; device time from the profiler and from CUDA
   events over the whole call) and a cold one (a 256 MB write before each
   call; device time from CUDA events with the host's enqueue hidden
   behind a spin kernel, and per call from an idle stream); both tiled
   forms' device time per launch; the tail step as the X pass takes it
   (added into the hot product);
T2(d). OWL-QN (L1, reg 1.0, 5 iterations) on T2's layout: the kernel
   route (the blocked-ELL kernels, launch counts) against ``scope("off")``,
   loss histories within rtol 1e-5;
G. the reg-weight grid on T2's layout (built once, for T2): (a) bench.py's
   run_sparse_grid — 8 L2 lanes (S_GRID, geomspace(1e-4, 1e-2)), history
   5 stored bf16, tolerance 0, 40 iterations — through
   `train_glm_grid(device_results=True)` (timed; launch counts reset just
   before and read just after): rows x sum of per-lane iterations over
   the wall, per-lane iterations, line-search trials per iteration, peak
   device memory beside the reckoned solver state, and a profiled
   5-iteration grid's device-busy share and device ops per iteration;
   (b) 5 iterations with f32 history on the kernels, on the tiled forms,
   on the plain versions (``scope("off")``) and as 8 single-lane
   `train_glm` solves: per-lane iterations equal, loss histories within
   rtol 1e-5; (c) 4 OWL-QN lanes (an L1 sweep) and 4 TRON lanes on the
   same layout against their plain versions, rtol 1e-5; then each
   blocked-ELL kernel at 8 lanes (the grid's coefficients; a seeded
   cotangent) beside its plain version, cuSPARSE's SpMM and its 8-lane
   bound, warm and cold, the fused and tiled forms bit-identical; and the
   hot block's Xᵀr over all rows against an f64 product, as one cuBLAS
   call and as the X pass sums it in row chunks (at most 1e-5 of the
   largest output);
E. validation-driven selection on T2's layout: 2^19 held-out rows drawn
   from T2's planted w_true with their own seed, laid out on their own
   (`to_blocked_ell`, 1,024 bf16 hot columns); `GameEstimator.fit(data,
   validation=..., config_grid=S_GRID)` on a fixed-effect-only model,
   one sweep, no warm starts — the one-program fixed-effect grid (one
   `train_glm_grid` at G (a)'s settings, then one 8-lane tail-matvec
   launch each to score the training and the validation rows) — timed,
   its launches and plan builds counted (reset just before, read just
   after), peak memory; the validation pass's ms (score_models + 8 AUCs
   on the card), per-lane AUC and the pick; held: each lane equals a
   direct `train_glm_grid` bit for bit, the validation margins within
   rtol=atol=1e-5 of ``scope("off")`` and of each model's single-lane
   score, each AUC within 1e-4 of a numpy f64 rank sum of the same
   margins, `best_model` picks `evaluate_glm_grid`'s lane, and 5-iteration
   fits on the kernels and under ``scope("off")`` give per-lane AUCs
   within 1e-5;
S. streamed training (a host dataset streamed through the card two
   chunks deep): T2's problem laid out as a bf16 host ladder
   (`chunk_blocked_ell`, 8 chunks of 2^18 rows) — its build seconds,
   chunk and pass bytes, this host's pinned host-to-device rate (one
   chunk's copy) —; the tail matvec (1 and 8 lanes) and the rmatvec on
   device ladder chunks with padded width buckets against their plain
   versions; (a) streamed L-BFGS at T2's settings through
   `train_glm(ChunkedBatch)` (timed; counts reset just before and read
   just after): rows·iters/s, feature streams and bytes per iteration,
   the link bound's share, the stall share, plan builds (at most one per
   ring slot), launches per pass, peak device memory beside the reckoned
   two chunks plus solver state; held against ``scope("off")``
   (iterations equal, histories within rtol 1e-5) and against resident
   T2 (a) (histories within 1e-5 over the first 5 iterations and a
   5-iteration streamed solve's coefficients within rtol 2e-3 / atol
   2e-5 of T2 (b)'s; where the 40-iteration histories part is reported:
   ROADMAP.md §C6); a profiled 5-iteration solve's device-busy share,
   copies apart; (b) streamed OWL-QN (L1 1.0, 5 iterations, 8 ladder
   lanes) against ``scope("off")`` and resident T2(d) (final value rtol
   1e-5, equal zero sets); (c) bench.py's streamed leg (D2's 2^19 x 256
   f32 in 2^16-row chunks, L-BFGS, 40 iterations) against the resident
   solve (final value rtol 1e-5, coefficients rtol 2e-3 / atol 2e-5),
   and at 2^18 rows its peak memory, which must not grow by a chunk;
D1. print the fused value+grad kernel's registers and spills (ptxas -v)
   and hold it against its plain version: all four tasks, f32 and bf16
   storage, n = 1,000 and 4,097 (a ragged last tile), d = 37 (rows not a
   multiple of 16 bytes: the element-copy branch), 40, 256 and the
   kernel's widest d, and an f32 X at a misaligned address (the
   element-copy branch at d = 256), zero-weight rows and non-zero offsets
   (loss within rtol 1e-5, max |dg| <= 1e-5 * max |g|); a second call
   repeats each bit for bit;
D2. train L1 logistic regression at the bench's dense width — bench.py's
   dense_problem, 2^19 rows x 256 f32 features, reg 1e4, history 10,
   tolerance 0, 40 iterations — through `train_glm` (OWL-QN): (a) on the
   default route (timed; the fused kernel's launches, reset just before and
   read just after, equal the solve's evaluations), (b) 5 iterations under
   ``scope("off")``, (c) 5 iterations on the unfused objective; histories
   within rtol 1e-5; some but not all coefficients exactly zero; a
   profiled 5-iteration solve's device-busy share;
D3. TRON (L2, reg 1.0, 10 iterations, 20 CG steps) at the same width,
   kernel route against ``scope("off")``; iterations, HVPs, rows*iters/s;
D5. bench.py's run_dense on D2's data: the 16-lane L2 grid (D_GRID,
   history 10, tolerance 0, 40 iterations) through `train_glm_grid`, no
   hand-written kernel (its lanes' products are cuBLAS GEMMs), twice:
   rows x sum of per-lane iterations over the wall;
D4. time the fused kernel at D2's shape (CUDA events; device time from the
   profiler, and from events with a warm and a cold L2) beside its plain
   version, the unfused route's two cuBLAS GEMVs (the library yardstick,
   warm and cold) and its bound;
GM. GAME at benches/game_10m.py's full width — 10,000,000 rows, 100,000
   users, 50,000 items, a 32-wide fixed shard in bf16 on the card, 4-wide
   per-user and per-item shards, 2 sweeps (the rows made in MG's wait);
   logistic, the fixed effect L2 1.0 for 30 iterations, each random
   effect L2 5.0 for 15 — through
   `GameEstimator.fit`: the entity bucketing's seconds and buckets (m, E,
   lane chunk), a cold fit and a warm refit (row-sweeps/s = rows x sweeps
   / warm wall), peak device memory, the objective history, each random
   effect's iterations per entity (median, max) and converged and failed
   counts per sweep, seconds per coordinate update, a profiled warm
   sweep's device-busy share and top device ops, scoring time, AUC of
   GAME against the fixed effect alone (numpy rank sum; GAME must win);
   then GM_CHECK entities of each random effect drawn from the seed,
   solved as lanes of their buckets and each alone through `train_glm` on its
   bucket's rows with the same offsets (solves stopped at tolerance
   1e-3): iterations equal, loss histories within rtol 1e-5;
GG. GM's model as a 4-lane grid over the per-user L2 weight (1.25, 2.5,
   5, 10; no warm starts) through `GameEstimator.fit`'s lane-axis path
   (`game.grid.fit_game_grid`: every grid point a lane of one
   coordinate descent, GM's bucketed datasets), with 2^20 held-out rows
   from GM's planted model: a cold fit (AUC) and a warm refit
   (SHARDED_AUC by user) — grid row-sweeps/s = rows x sweeps x lanes /
   warm wall —, peak memory, seconds per coordinate update, per-lane
   objective histories and iterations per entity, a profiled warm
   sweep's device-busy share, the validation pass's seconds; held: every
   lane's AUC and SHARDED_AUC within 1e-4 of numpy f64 on the same
   scores, `grouped_auc` twice on the card bit for bit, `best_model`
   under each evaluator picks numpy's lane, and each lane against a
   sequential fit of its point (every solve stopped at a relative
   progress of 1e-3): objective histories within rtol 1e-5, the fixed
   effect within 1e-5 of its largest coefficient, each random effect's
   entities apart beyond rtol 1e-5 at most 0.1% of them or twice as many
   as a one-ulp nudge of the row weights moves apart in the sequential
   fits themselves (the chained entity solves amplify a rounding);
GS. GM again with its fixed shard as 10 host chunks of 2^20 bf16 rows (the
   random effects' buckets reused): cold fit, warm refit row-sweeps/s,
   peak memory, seconds per update, the ``game_e2e.*`` counters (the
   descent's scores host caches); held against GM's warm fit (objective
   rtol 1e-5, AUC within 1e-4) and, on the fixed shard alone stopped at
   a relative progress of 1e-3, the streamed fixed solve against the
   resident one (iterations equal, coefficients rtol 2e-3 / atol 2e-5);
   after GK, GK (a)'s sparse fixed shard as a 4-chunk bf16 ladder, one
   sweep through the kernels against ``scope("off")``;
GK. GAME through the kernels, one sweep, random effects with the serving
   phase's shards (d 8, 8 slots): (a) a `BlockedEllRows` fixed shard at
   T2's width and 2^19 rows (L-BFGS, SIMPLE variances), (b) D2's dense
   shard (OWL-QN, L1 1e4); each fit's kernel launches inside the descent
   (reset just before, read just after), and the fit held against
   ``scope("off")``: objective histories and the fixed effect's
   coefficients and variances within rtol 1e-5 (of the largest), each
   random effect's entity by entity, all but at most 0.1% of them (each
   entity decides its own steps and stop, and a few in 10^5 decide on
   the rounding their offsets differ by; they are counted).
DRV. the drivers on local Avro (a temporary directory beside this script):
   (a) benches/game_10m.py's widths and settings at 2^17 training and
   2^15 validation rows (cut from 2^18 and 2^16 for AN's time; GM's
   planted model; written in MG's wait as deflate Avro by a vectorized
   encoder through the port's `AvroBlockWriter`, its first 256 records
   held against `write_datum`) through `run_indexing`,
   `run_training` (a 2-point grid over the per-user L2, 2.5 and 5.0;
   validation with AUC and SHARDED_AUC by user; ``output_mode="ALL"``)
   and `run_scoring` of ``best_model/`` on the validation file, the
   kernels' launch counts reset just before the indexing and read just
   after the scoring: each driver's phase seconds, read rows/s, model
   directory bytes, peak device memory; held: ``best_model/`` loads back
   bit for bit, the records of ``scores.avro`` equal the scores
   returned, the scoring driver's AUC within 1e-6 of the estimator's
   validation AUC and within 1e-4 of a numpy f64 rank sum of the best
   model's margins, every point's ``training_manifest.json`` the row
   manifest (ROADMAP §C9); (b) a fixed-effect-only job over one bag of
   32 zipf(1.4) names a row out of 2^16 (2^15 rows, so a `SparseRows`
   shard) trained twice: equal coefficient records; (c) the `SparseRows`
   Xᵀr at T2's widths (2^19 rows): 3 calls equal bit for bit, within
   1e-5 of the largest output of a numpy f64 Xᵀr, its ms a call and its
   plan's build seconds beside the parent's ``index_add_`` form (its
   ms, its error and how many outputs its own calls disagree on). The
   drivers decode natively (a fallback to Python fails the phase).
DRV-S. the streamed data plane on local Avro (a `_drvs*` temporary
   directory): GM's widths at 2^18 training rows (cut from 2^21 for TU's,
   HY's and AN's time; over a streaming threshold of DRVS_THRESHOLD rows,
   where 2^21 rows were just over the default 2,000,000) as 8 deflate part
   files and 2^16 validation rows, written in MG's wait by a spawn process
   pool, the largest file first; (a) a part file of
   DRVS_PY_ROWS rows written beside them through `read_game_data` native
   and Python (equal bit for bit, rows/s each), then half the training
   part files (cut: depth) through `iter_game_chunks_parallel` with 0 and
   4 process workers, a chunk-cache build and a cache hit (every chunk
   bit-identical, rows/s each); (b) `run_indexing`, then
   `run_training` with `streaming=None` (it trips), 4 workers, a chunk
   cache, GM's coordinates stopped at a relative progress of 1e-3, AUC
   and SHARDED_AUC — phase seconds, read rows/s, the staging stall share,
   the prefetch widenings, staging bytes, peak device memory —, held bit
   for bit against a `streaming=False` run (model, validation data,
   margins; the AUC within 1e-6), and a rerun that hits the cache (no
   decode) and trains the same model; (c) the streamed objective under
   half the estimated device bytes (the fixed shard as host chunks):
   seconds per update, `game_e2e.*`, within 1e-3 of (b) (at most 0.1% of
   an effect's entities beyond); (d) 2^17 rows at T2's widths written as
   per-row names, the ladder built from Avro with 4 workers, cold and
   from its cache, equal to `chunk_blocked_ell` of the in-memory read bit
   for bit, and 10 streamed L-BFGS iterations through the tail matvec
   and rmatvec kernels (rows·iters/s, launches), the first 5 within 1e-5
   of ``scope("off")``. No leg meant to be native decodes in Python.
CR. continual refresh at GM's widths: (a) the previous model
   (`GameEstimator.fit` on GM's data, SIMPLE variances) and its
   `build_manifest`; (b) a delta drop of 2^20 zipf(1.2) user rows (users
   shifted +0.3) plus 4,096 rows of 1,000 unseen users, `diff_manifest`
   and `refresh_game_model` with GM's random-effect configs stopped at
   1e-3 — diff and refresh seconds, per coordinate touched and deferred
   entities, buckets, solves, iterations, seconds, rows/s, peak memory;
   held: untouched rows and the fixed effect bit for bit, no failed
   entity, 1,000 deferred, GM_CHECK touched users against `train_glm`
   alone (prior, warm start, offsets) and against a refresh of those
   alone;
   (c) a second drop with 8 more touched users in a bucket with free
   lanes, refreshed at GM's config as it is: no new solve signature
   (`assert_no_retrace`); (d) `hot_swap` into a live store behind an int8
   and an f32 `ProgramLadder` under 32 client threads, mid-stream — probe
   ms, publish s and bytes, reload ms, staleness, the first flush after
   it, QPS and p50/p99 on each side, the rung kernel's launches after the
   swap (counts reset just before it); held: answers on each side equal
   the plain int8 version of their generation (rtol = atol = 1e-5) and
   the f32 ladder within ε/4, no retrace, one hot swap; (e) a publish
   killed at ``swap_publish#1`` leaves ``CURRENT`` and its bytes, a store
   with +1e6 added is refused (counted) and the live store untouched;
   (f) the per-user coordinate on (a)'s data with ``straggler_budget`` 5
   against none at GM's config (coefficients within 1e-3) and with 2
   against none at 1e-3 (equal failed counts): straggler entities,
   lock-step iterations of both passes, ``game_re.iters_saved``.
MG. the slot mesh, after S (the multi-GPU GLM slice at T2's widths,
   with every slot on the visible cards — all eight on one card when
   there is one): (a) T2's L2 logistic L-BFGS (reg 1e-3, history 5,
   tolerance 0, 40 iterations) on an in-process 8-slot mesh
   (`cast_features(shard_blocked_ell_batch(...))`, every value leaf bf16
   as T2's; `train_glm(mesh=)`: rows 2 and 4 on every slot's shard):
   first rows 2 and 4 on each slot's shard (1 and 8 lanes, (X∘X)ᵀr too)
   against their plain versions, rtol=atol=1e-5; rows·iters/s,
   reductions an iteration (one an evaluation), one reduction's ms,
   launches, peak memory, a profiled solve's idle share; held against
   T2: histories within rtol 1e-5 over the first T_SHORT iterations of
   (a) (where the 40-iteration paths part, and their last gaps, are
   printed: §C13), the 40th value within MG_PART_RTOL, and a
   T_SHORT-iteration mesh solve's value within rtol 1e-5 and coefficients
   within atol 1e-4 of T2's T_SHORT-iteration solve;
   (b) S's ladder as mesh chunks (`chunk_blocked_ell(n_shards=8)`): rows
   2 and 4 on every slot's shard of the first and last mesh chunk
   against their plain versions as in (a); L-BFGS
   MG_ITERS_C iterations and OWL-QN T_SHORT against S's one-device
   histories (the same bounds), rows·iters/s against the link bound, the
   stall share; (d) PF (c)'s ``parallel`` suite (``python -m
   photon_tpu_torch.parallel --selftest --backend gloo --json`` on the
   card): one digest and one ``local_only`` solve at 1, 2 and 4
   processes, the ingest split on every rank of 2 and 4, a 2-process
   snapshot restored at 1 and 4 bit for bit, the commit kill loud; (c)
   that digest equal to this process's mesh's, a line naming the
   backend, and (a)'s solve cut to MG_ITERS_C iterations at 2 processes
   (each mapping its own slots' shards from a ``_drv_mg*`` directory
   beside this script; launched beside PF (c) and (b)'s layout build,
   before any timed solve) bit for bit equal to the in-process mesh's,
   with collectives, reductions and wire bytes; with two cards
   or more the same over NCCL, a card per rank. Every kernel and the
   native library are built (phase 0) before any child starts.
CK. elastic runs (in-process kills: an injected fault, then a fresh
   `checkpoint` session resuming from the last commit; snapshot
   directories under ``_drv_ck*`` temporary directories beside this
   script, each removed after its leg): (a) after S (b), on S's ladder:
   streamed L-BFGS (CK_ITERS iterations, tolerance 0, the default kernel
   route) session-less, armed and unkilled with a synchronous and an
   asynchronous writer (about CK_SNAPSHOTS snapshots a run, CK_KEEP kept),
   killed at the middle ``evaluation``, the middle ``chunk_upload``,
   ``snapshot_write`` #2 and ``commit`` #2 and resumed, and S (b)'s
   OWL-QN killed at its middle evaluation and resumed — state bytes,
   snapshots, pack ms (the caller's part), commit and restore s,
   rows·iters/s session-less against armed, the tail matvec and rmatvec
   launches after each resume; held: every armed and resumed result (w,
   loss history, iterations) equals the session-less one bit for bit; (b)
   inside GM: GM's model at full width with every solve stopped at
   RE_CHECK_TOL and ``straggler_budget`` CR_BUDGET_CHECK, fitted at
   ``pipeline_depth`` 1, 0 and 2 (seconds each, no claim; equal bit for
   bit), armed and unkilled (async writer), killed at the middle
   ``bucket_retire`` and a mid-run ``commit`` and resumed (snapshots at
   every retire and update) — snapshot bytes, ``checkpoint.re_restores``
   and ``checkpoint.descent_restores``; held: every model and objective
   history equals the session-less fit's bit for bit (the scores, a
   function of the model, are not recomputed: cut for MG's time); (c)
   inside DRV, after (a): DRV (a)'s `run_training` with a
   ``checkpoint_dir`` killed at its middle ``bucket_retire`` and rerun:
   ``best_model/`` equals DRV (a)'s bit for bit (the checkpoint
   selftest runs once, as PF (c)'s ``checkpoint`` suite);
   (d) after T2(d): T2's resident L-BFGS (T_SHORT iterations) session-less,
   under an armed session with the tap off (the same launches, the same
   device ops — every aten operator the solve dispatches, counted by a
   dispatch mode —, the same bits) and with ``resident_tap=True``
   (the tapped iteration count and w, mapped back to model order, equal
   the result's bit for bit).
GMM. GAME on the in-process MG_SLOTS-slot mesh (all slots on the one
   card), its legs inside the phases whose data they reuse: (a) after
   GM's scoring, GM's estimator and data with ``mesh=`` (the fixed shard
   row-sharded, every bucket's lanes split over the slots): sharding
   seconds, a cold fit and a warm refit (row-sweeps/s), peak memory,
   random-effect lock-step solves a sweep (at most 8x GM's), a profiled
   warm sweep's idle share; held against GM's warm fit: the fixed effect
   within atol 2e-3 (the reference's mesh bound) and the AUC on 2^18
   held-out rows within 1e-4, the entities apart beyond rtol 1e-5
   reported (§C16: every solve runs to the f32 floor), then both fits
   again with every solve stopped at RE_CHECK_TOL, where at most 0.1% of
   each random effect's entities (or twice the one-ulp nudge's count)
   may part, none by more than twice the nudge's largest gap; (b) after
   GK (a): GK (a)'s
   fixed shard laid for the slots (every value leaf bf16), rows 2 and 4
   on every slot's shard against their plain versions (1 and 8 lanes,
   (X∘X)ᵀr too), the one-sweep fit through them (launches counted,
   reset just before and read just after) held against GK (a) at those
   bounds; (d) beside GK: (b)'s problem at 2^16 rows and one sweep
   fitted by 2 gloo processes sharing the card (`parallel.launch`), its
   digest (every table) equal to the in-process mesh's bit for bit, then
   killed at ``bucket_retire#2`` on both ranks and resumed in this
   process to the same digest; (c) in CR after (b): the same refresh on
   the mesh (touched lanes padded to a slot multiple, solved slot by
   slot), held against CR (b)'s at (a)'s entity bounds — its generation
   is the one CR (d) hot-swaps into the live int8 ladder; (e) in DRV
   after CK (c): DRV (a)'s Avro and parameters, every solve stopped at
   RE_CHECK_TOL, through `run_training(mesh=)` and `run_training` on one
   device (the best model only; a third run on one device reads a copy
   of the training Avro whose row weights sit one ulp above 1), the same
   best point, held at (a)'s bounds; (f) after GG: GG's 4-lane grid at
   2^20 rows (cut from 2^21 for AN's time), every solve at
   RE_CHECK_TOL, on one device and on the mesh (`fit_game_grid(mesh=)`),
   each lane at (a)'s bounds.
TF. the run telemetry spine and the replica fleet: (a) after CK (d):
   T2's resident L-BFGS (T_SHORT iterations, rows 2 and 4) under
   ``telemetry.run(jsonl_path=..., resident_tap=True)`` against telemetry
   off — the JSONL's iteration events equal the loss and |g| histories
   bit for bit, the syncs (torch's sync debug mode) equal armed and off,
   TF_CALLS solves of each in turns with the armed/off wall by median
   within the runs' spread (or TF_FLOOR), the run's
   `sample_device_memory` peak equal to `max_memory_allocated`; (b)
   after phase 3: bench.py's serving configuration (:630-636: 4,096
   members, a 64-wide dense fixed effect, d 8 with 8 slots, zipf(1.2)
   with its cold tail, 32 clients) as a TF_REPLICAS-replica
   `ReplicaFleet` on the one card — an f32 fleet within 1e-6 of a single
   f32 dispatcher, the int8 fleet (row 1 on every replica) within
   EPSILON / 4 of it, each replica serving exactly `replica_for`'s
   share, QPS and p50/p99 with tracing off and on, the p99 exemplars'
   split into fleet_route / replica_dispatch / queue_wait / device_flush
   / retire_wait, and a kill at ``replica_dispatch`` and at
   ``rung_execute`` each ending in the owner's or another replica's
   (degraded) answer; (c) the serving and telemetry selftests run once,
   as PF (c)'s suites; the host cost of a span and a trace off and on;
   (d) MG (d)'s selftest includes ``cross_rank_aggregation`` (its
   2-process launch's rank files merged, the straggler named).
TU. the tuners and the diagnostics: (a) after TF (c): bench.py's
   tuning_e2e (:1166-1240: 2^15 x 64 dense logistic, 24 iterations, 256
   configs in lane chunks of 64) through `tune_glm_reg_lanes` on the card
   — a warm tune, then a timed one adding no dispatch signature —:
   configs/s against the point-at-a-time loop (a full-depth one-lane
   `train_glm_grid` and its validation pass per point, 16 points), their
   ratio (the reference's acceptance: 8x), rounds, the round's modeled
   FLOPs, peak memory, and each round's GP fit on the card and on the
   CPU; (c) the tuning selftest runs once, as PF (c)'s suite; (b) after
   E: T2's layout (G's
   configuration) through the lane tuner with E's held-out rows (cut:
   TU_T2_CONFIGS configs in chunks of TU_T2_CHUNK, 4 rounds; a 64-lane
   T2 state would need ~64 GB) — rows 2 and 4 launched, no plan build
   (both layouts' exist), two dispatch signatures, peak memory —, the
   first round's screen held against ``scope("off")`` (final objectives
   within rtol 1e-5) and rows 2 and 4 at its lanes against their plain
   versions;
   (e) Hosmer–Lemeshow on the winner's held-out probabilities and both
   feature importances on the SparseRows T2 is laid out from, each
   against numpy f64 (1e-5 relative; the variance importance squared) and
   repeated bit for bit over 5 calls; after D2-D5, `bootstrap_glm` with
   TU_BOOT Poisson replicates of D2's L1 OWL-QN solve at the default
   tolerance (row 6, a launch an evaluation), the first replicate re-solved
   bit for bit and its first D_SHORT iterations within rtol 1e-5 of the
   plain version's; (d) after GMM (e): DRV (a)'s Avro through
   `run_training` with ``tuning_iters=8``, ``tuning_batch=4`` (a narrower
   reg range whose batches vectorize; cut: solves stopped at
   RE_CHECK_TOL), each result's validation score within 1e-6 of the same
   configurations refitted by `GameEstimator.fit(config_grid=...)`.
PF. the attribution ledger and the self-test CLIs: (a) after CK (a), on
   S's ladder (T2 as 8 bf16 host chunks; cut: PF_ITERS L-BFGS
   iterations, as MG (b) and CK (a)): PF_CALLS solves in turns disarmed,
   armed, armed, disarmed, each under `utils.profiling.count_syncs`
   (launches counted, reset just before the first armed solve and read
   just after it) — every attribution entry's static FLOPs and bytes,
   seconds and roofline share; for ``chunk_dz_phi`` and ``chunk_init``
   the modeled bytes over (seconds · 3.35e12) beside rows 2 and 4's
   device share of that pass (torch.profiler over one armed solve); the
   first-call account (the kernel library's load, the plan); per-phase
   device memory; held: the armed and disarmed coefficients equal bit
   for bit and their sync counts equal, the armed wall against the
   disarmed by median; (b) at the end: ``python -m
   photon_tpu_torch.profiling --report --json`` at its defaults and
   ``--selftest --json``, side by side, each exiting 0 with every
   streamed entry's roofline share in (0, 1]; (c) started where MG
   begins, beside its host layout builds, (c)'s 2-process solve and the
   later phases' host data (GM's rows, DRV's and DRV-S's Avro files, none
   of it timed), and waited for before MG's timed solves: ``python -m
   photon_tpu_torch --selfcheck --json --jobs PF_JOBS`` — all 13 suites
   (parallel, analysis, telemetry, serving, checkpoint, profiling, game,
   continual, ingest, kernels, tuning, lint, threads) exiting 0 on the
   card, with their seconds, and none pending.

HY. the hybrid layouts on T2's data (after MG): (a) `to_permuted_hybrid`
   at full width, every value leaf bf16 (build s, bytes on the card); the
   occurrence-bucket rmatvec at its unrounded instantiation (rows 4 and 5,
   1 and 8 lanes, square off and on) and the whole Xᵀr against their
   plain versions (rtol=atol=1e-5, max |err| stated), the flat tail's
   per-row sums against f64 on HY_SAMPLE rows, a 5-iteration L-BFGS
   `train_glm` (counts reset just before, read just after; the model's
   margins, original order, against f64), the same on the tiled forms,
   5 Xᵀr calls bit for bit, row 4's unrounded time beside its bound, its
   plain version and cuSPARSE; (b) `to_hybrid` at the same widths (hot
   block built on the card in bf16): its passes against (a)'s (one
   function at bf16), a 5-iteration solve within rtol 1e-5 of (a)'s,
   5 Xᵀr calls bit for bit, its tail sums against f64; (c) the first
   HY_C_ROWS rows at f32 storage as `BlockedEllRows`, `HybridRows` and
   `PermutedHybridRows`: 5-iteration histories within rtol 1e-5, each
   layout's margins against f64 on sampled rows; (d) the sharded pair on
   MG_SLOTS slots of the card (`shard_permuted_batch`, built on the host
   beside (a)-(c); `shard_hybrid` of (b)'s layout): the bucket bytes
   reckoned first, every slot's rmatvec against its plain version, 5
   iterations each within rtol 1e-5 of (a)'s and (b)'s, row 4 launched
   once per slot and pass; (e) bench.py's 8-lane grid (S_GRID, G (a)'s
   settings) on (a)'s layout, rows*sum(iters)/s beside G's.

AN. the hot-path contracts and the source auditor (last): (a) every
   contract of `photon_tpu_torch.analysis.registry` run twice in this
   process on the card under the recorder (`analysis.walker`), one line
   each — psum count, host syncs against the contract's budget, kernel
   launches, plans built on the second call, violations —, every
   contract holding, and the kernel contracts of rows 1-5
   (``blocked_ell_kernel_x_passes``, ``blocked_ell_kernel_no_retrace``,
   ``blocked_ell_tiled_x_passes``, ``serving_kernel_fused_rung``,
   ``serving_kernel_mode_invariance``) launching their kernels with no
   host sync and no plan on the second call (the counts reset just before
   and read just after); (b) beside (a), ``python -m
   photon_tpu_torch.lint --json`` and ``--threads --json``, both ``ok``
   with zero findings and no stale waiver. PF (c)'s umbrella runs the
   same contracts (``analysis``) and audits (``lint``, ``threads``) as
   suites of their own.

Output: the run's lines, then one ``{"kernels": [...]}`` JSON line (the
blocked-ELL entries carry their 8-lane figures under ``lanes8_*`` and
their launches in the grid's solves under ``grid_launches``; every
entry its launches in GM's fits and GK's default-route fits under
``gm_launches`` and ``gk_launches``, in phase S's main-path solves under
``s_launches``, in GS's fits under ``gs_launches``, in E's fit under
``e_launches``, in GG's fits under ``gg_launches``, in DRV (a)
under ``drv_launches`` and in DRV-S's main-path runs — (b)'s streamed
driver run, (c)'s streamed objective and (d)'s ladder solve, each
counted alone — under ``drvs_launches``, after CR (d)'s hot swap
under ``cr_launches``, in CK's armed and resumed runs and (d)'s
tapped solve under ``ck_launches``, in MG (a)'s mesh solve under
``mg_launches``, and in GMM's legs — (b)'s mesh fit, (d)'s two
processes, the rung after (c)'s swap — under ``gmm_launches``, and in
TF's (a) armed solve, (b)'s fleet legs and kills under ``tf_launches``,
and in TU's (b) tune and (e) bootstrap under ``tu_launches``, and in
PF (a)'s first armed solve under ``pf_launches``, and in HY's solves and
grid under ``hy_launches``, and in AN (a)'s contract runs under
``an_launches``; rows 4 and 5 carry HY's unrounded timings under
``hy_*``),
the
card's name and power limit as nvidia-smi reports them, and last
``{"ok": true, "device": {...}}``. Needs one CUDA device; exits non-zero
without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
TOL = dict(rtol=1e-5, atol=1e-5)
FLUSH_BYTES = 256 << 20     # written before each cold call: 5x the 50 MB L2
SPIN_CYCLES = 2_000_000     # ~1 ms of spin kernel at the H100's 1.98 GHz

D_FIXED, K_FIXED = 10_000_000, 32
N_USERS, N_ITEMS, D_RE, K_RE = 100_000, 50_000, 8, 8
MAX_BATCH, MAX_DELAY_US, CLIENTS, WINDOW = 64, 200, 32, 4
EPSILON = 0.5

# the training path: bench.py's sparse_problem + run_sparse shape
T_ROWS, T_FEATURES, T_NNZ, T_ZIPF, T_DENSE = 1 << 21, 10_000_000, 32, 1.4, 1024
T_ITERS, T_SHORT, T_REG, T_HISTORY = 40, 5, 1e-3, 5

# the dense path: bench.py's dense leg (D_ROWS, D_FEATURES, dense_problem)
D_ROWS, D_FEATURES, D_ITERS, D_SHORT = 1 << 19, 256, 40, 5
D_L1, D_HISTORY, D_TRON_ITERS, D_TRON_REG, D_CG = 1e4, 10, 10, 1.0, 20

# the reg-weight grids: bench.py's run_sparse_grid (S_GRID, 8 L2 lanes,
# bf16 history) on T2's problem, and run_dense (D_GRID, 16 lanes) on D2's
S_GRID = list(np.geomspace(1e-4, 1e-2, 8))
D_GRID = list(np.geomspace(1e-4, 1e-2, 16))
G_L1 = [0.5, 1.0, 2.0, 4.0]        # the OWL-QN lanes on T2's layout
G_TRON = [1.0, 3.0, 10.0, 30.0]    # the TRON lanes on T2's layout

# GAME at full width: benches/game_10m.py (rows, entities, widths, sweeps;
# (max_iters, L2 weight) of the fixed effect and of each random effect)
GM_ROWS, GM_USERS, GM_ITEMS = 10_000_000, 100_000, 50_000
GM_D_FIXED, GM_D_RE, GM_SWEEPS = 32, 4, 2
GM_FIXED, GM_RE = (30, 1.0), (15, 5.0)
# GM's check re-solves this many entities of each random effect alone
# (and CR (b)'s this many touched users; cut from 64 for GMM's time).
# Its gate and GK stop each entity's solve at a relative progress of
# RE_CHECK_TOL: these small entity problems reach the f32 floor within a
# few iterations, where two solves that sum in other orders (a lane and a
# single solve; runs on offsets a rounding apart) stop or step on
# rounding; a stop at 1e-3 is a decision rounding cannot flip. GM also
# runs the check at its timed configuration and reports where it parts
GM_CHECK, RE_CHECK_TOL = 32, 1e-3
GK_ROWS = 1 << 19  # GAME through the kernels: T2's width at this depth
# validation-driven selection: E's held-out rows on their own layout (T2's
# planted w_true, rows from seed + E_SEED); GG's grid over the per-user L2
# weight and its held-out rows (GM's planted model, rows from seed +
# GG_SEED)
E_ROWS, E_SEED = 1 << 19, 101
GG_USER_L2, GG_VAL_ROWS, GG_SEED = [1.25, 2.5, 5.0, 10.0], 1 << 20, 202
# the streamed phases' chunk heights: T2's ladder (8 chunks), bench.py's
# streamed leg on D2's data (run_streamed, 2^16), GM's fixed shard and
# GK's ladder
S_CHUNK, S_DENSE_CHUNK, GS_CHUNK, GK_S_CHUNK = 1 << 18, 1 << 16, 1 << 20, \
    1 << 17
# the drivers on local Avro: GM's widths at 2^17 training and 2^15
# validation rows (cut from 2^18 and 2^16 for AN's time; a pure-Python
# Avro decode is ~100 µs a row), a grid
# over the per-user L2 weight; (b) a wide sparse fixed effect; (c) the
# SparseRows Xᵀr at T2's widths
DRV_ROWS, DRV_VAL_ROWS, DRV_SEED, DRV_BLOCK = 1 << 17, 1 << 15, 303, 4096
DRV_USER_L2 = [2.5, 5.0]
DRV_WIDE_ROWS, DRV_WIDE_D, DRV_WIDE_K, DRV_WIDE_ITERS = 1 << 15, 1 << 16, \
    32, 20
DRV_XTR_ROWS = 1 << 19
# the streamed data plane (DRV-S): GM's widths at 2^18 training rows (cut
# from 2^21, which sat just over the training driver's default streaming
# threshold of 2,000,000, to 2^20 for TU's time, to 2^19 for HY's and to
# 2^18 for AN's; the threshold is set to DRVS_THRESHOLD) in 8 part files
# and 2^16 validation rows, 4 ingest workers,
# 2^16-row decode chunks and 2^17-row objective chunks, solves stopped at
# a relative progress of DRVS_TOL (the (b)/(c) comparison's tolerance);
# (d) T2's widths at 2^17 rows (cut from 2^18 for the script's time), a
# ladder of 2^15-row chunks, 10 iterations
DRVS_ROWS, DRVS_VAL_ROWS, DRVS_PARTS, DRVS_SEED = 1 << 18, 1 << 16, 8, 404
DRVS_THRESHOLD = 200_000
DRVS_WORKERS, DRVS_CHUNK, DRVS_OBJ_CHUNK, DRVS_TOL = 4, 1 << 16, 1 << 17, \
    1e-3
DRVS_LADDER_ROWS, DRVS_LADDER_CHUNK, DRVS_LADDER_ITERS = 1 << 17, 1 << 15, 10
DRVS_AUC_CALLS = 20  # (b): the same margins' AUC, call after call
# (a)'s native-against-Python decode reads a part of this many rows of its
# own (cut for MG's time: a whole 2^18-row part took the pure Python
# decoder ~35 s)
DRVS_PY_ROWS = 1 << 15
# the tuners: bench.py's tuning_e2e (:1177-1182) on the card; T2's layout
# through the lane tuner (cut: TU_T2_CONFIGS configs, chunks of
# TU_T2_CHUNK); the bootstrap's replicates of D2's solve; the training
# driver's tuning_iters and tuning_batch on DRV (a)'s Avro
TU_ROWS, TU_FEATURES, TU_ITERS, TU_CONFIGS, TU_CHUNK, TU_SEQ_SAMPLE = \
    1 << 15, 64, 24, 256, 64, 16
TU_T2_CONFIGS, TU_T2_CHUNK, TU_BOOT = 32, 8, 16
TU_DRV_ITERS, TU_DRV_BATCH = 8, 4
# a reg-weight range whose spread (1e3) the GAME grid's lane gate takes
TU_DRV_RANGE = (0.1, 100.0)
# continual refresh (CR): the previous model on GM's data (GM's own
# GameData), a delta drop of 2^20 zipf(1.2) user rows plus 4,096 rows of
# 1,000 users
# the model never saw (from seed + CR_SEED), the drop's users shifted by
# CR_SHIFT; the hot swap's requests and its probe bound (a refreshed user
# moves its margin by a few units, a blown-up store by ~1e6); (f)'s budget
CR_DROP_ROWS, CR_NEW_USERS, CR_NEW_ROWS = 1 << 20, 1000, 4096
CR_SEED, CR_SHIFT, CR_REQUESTS, CR_PROBE_BOUND, CR_BUDGET = 505, 0.3, \
    4096, 25.0, 5
W_CHECK_RTOL = 1e-4  # coefficients of one entity solved two ways
# (f) again at RE_CHECK_TOL, where GM's entities stop within 4 iterations:
# a budget of 2 leaves most of them to the tail pass
CR_BUDGET_CHECK = 2
# elastic runs (CK): (a)'s streamed solves run CK_ITERS iterations with a
# cadence of about CK_SNAPSHOTS snapshots a run; every snapshot directory
# keeps CK_KEEP (about 1 GB at T2's widths)
CK_ITERS, CK_SNAPSHOTS, CK_KEEP = 10, 3, 2
# phase PF: (a)'s ladder solve cut to PF_ITERS iterations (as MG (b) and
# CK (a)), PF_CALLS solves in turns disarmed, armed, armed, disarmed;
# (c)'s umbrella runs PF_JOBS suites at a time (raised from 3 for AN's
# time: the 13 suites wait for no GPU work of each other); the card's
# HBM rate that
# (a)'s bytes divide by (the kernel bounds' pair, PERF.md §6)
PF_ITERS, PF_CALLS, PF_JOBS, PF_HBM_BYTES_PER_S = 10, 4, 6, 3.35e12
# PF (a)'s kernel launches, its first armed solve's (reset just before it
# and read just after)
PF_LAUNCHES: dict = {}
# phase HY: the solves' iterations, (c)'s f32 rows, the rows whose margins
# and tail sums are held against f64; HY's kernel launches over its main
# paths ((a)'s solves, (d)'s mesh solves, (e)'s grid; each reset just
# before and read just after); G (a)'s rows*sum(iters)/s, for (e)
HY_ITERS, HY_C_ROWS, HY_SAMPLE = 5, 1 << 19, 4096
HY_LAUNCHES: dict = {}
GRID_RATE: dict = {}
# phase MG: the in-process mesh's slots (T2's rows split eight ways), and
# the iterations of (a)'s solve repeated across processes and of (b)'s
# streamed L-BFGS
MG_SLOTS, MG_ITERS_C = 8, 10
# MG (a)'s 40th loss against T2 (a)'s: past the reference's 1e-5 once the
# tolerance-0 paths part (ROADMAP §C13; mesh_parting.py on the CPU, every
# leaf bf16: the port 1.65e-4 and 4.98e-4 at the 40th at 2^16 and 2^18
# rows, 1.15e-3 at most on the way, the JAX package's own mesh 6.06e-5
# from its one device), so held at 10x the largest 40th reading; a slot
# dropped from the reduction moves the loss by about 1/8
MG_PART_RTOL = 5e-3
# phase GMM: GAME on the in-process MG_SLOTS-slot mesh, its legs inside the
# phases whose data they reuse. Bounds against one device: the fixed
# effect within the reference's own mesh-against-single atol
# (tests/test_game.py:226-233), the validation AUC within GMM_AUC_GAP,
# and at most GMM_ENTITY_SHARE of each random effect's entities beyond
# rtol 1e-5 (ROADMAP §C8's bound; or twice as many as a one-ulp nudge of
# the row weights moves apart on one device, none by more than
# GMM_GAP_FACTOR times the nudge's largest gap) where every solve stops at
# a relative progress of RE_CHECK_TOL: at GM's timed configuration (1e-7) a fixed
# effect stops at the f32 floor a rounding apart on each side and every
# entity follows its offsets (§C16), so there the share is reported. (d)
# cuts GK (b) to GMM_D_ROWS rows and one sweep, (f) GG to GMM_F_ROWS rows
# at RE_CHECK_TOL; (a) and (f) score GMM_VAL_ROWS held-out rows of GM's
# planted model (from seed + GMM_SEED)
GMM_FIXED_ATOL, GMM_ENTITY_SHARE, GMM_AUC_GAP = 2e-3, 1e-3, 1e-4
GMM_GAP_FACTOR = 2.0
# GMM (d)'s two clusters each ran in under 30 s with their start; a hung
# one is stopped and fails the phase well inside the script's limit
GMM_D_TIMEOUT_S = 180.0
GMM_D_ROWS, GMM_F_ROWS, GMM_VAL_ROWS, GMM_SEED = 1 << 16, 1 << 20, 1 << 18, \
    606
# GMM's kernel launches, summed over its legs (each reset just before its
# main path and read just after): (b)'s mesh fit, (d)'s processes, the
# rung after (c)'s swap
GMM_LAUNCHES: dict = {}


def log(*a) -> None:
    print(*a, flush=True)


LAPS: dict = {}
_LAP_T = [time.perf_counter()]


def lap(name: str) -> None:
    """Record the seconds since the previous lap (or the start) under
    ``name``: the per-phase wall `main` prints before the kernels line."""
    now = time.perf_counter()
    LAPS[name] = round(now - _LAP_T[0], 1)
    _LAP_T[0] = now


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


PTXAS_KERNELS = ("bell_tail_matvec_kernel", "bell_bucket_rmatvec_kernel",
                 "serving_int8_margin_kernel", "fused_vg_tile_kernel")


def _ptxas_label(kernel: str, name: str) -> str:
    """A kernel instantiation's template arguments, from its mangled
    ``name``."""
    import re

    m = re.search(r"ILb(\d)ELb(\d)ELb(\d)ELi(\d+)E", name)
    if m:
        return (f"bf16={m.group(1)} square={m.group(2)} "
                f"round_r={m.group(3)} lane_chunk={m.group(4)}")
    m = re.search(r"ILb(\d)ELb(\d)ELi(\d+)E", name)
    if m:
        return (f"bf16={m.group(1)} square={m.group(2)} "
                f"lane_chunk={m.group(3)}")
    m = re.search(r"ILb(\d)ELi(\d+)E", name)
    if m:
        last = "task" if kernel.startswith("fused") else "lane_chunk"
        return f"bf16={m.group(1)} {last}={m.group(2)}"
    m = re.search(r"ILi(\d+)EE", name)
    if m:
        return f"coords<={m.group(1)}"
    return ""


def ptxas_report(source) -> list:
    """[(kernel, registers, spill store bytes, spill load bytes)] of every
    instantiation of the `PTXAS_KERNELS` in ``source``, from ``nvcc -O3
    -Xptxas -v`` for sm_90a (the flags the build gives it), compiled to a
    cubin under the kernels' build directory."""
    import re

    from torch.utils.cpp_extension import CUDA_HOME

    from photon_tpu_torch import kernels as K

    out_dir = K.BUILD_DIR / "ptxas"
    out_dir.mkdir(parents=True, exist_ok=True)
    res = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "nvcc"), "-O3", "-std=c++17",
         "-arch=sm_90a", "-cubin", "-Xptxas", "-v",
         "-o", str(out_dir / f"{source.stem}.cubin"), str(source)],
        capture_output=True, text=True, timeout=300, check=True)
    stats, cur = {}, None
    for line in (res.stdout + res.stderr).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            cur = m.group(1)
            continue
        if cur is None or not any(k in cur for k in PTXAS_KERNELS):
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            stats.setdefault(cur, {}).update(st=int(m.group(1)),
                                             ld=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            stats.setdefault(cur, {})["regs"] = int(m.group(1))
    rows = []
    for name, st in sorted(stats.items()):
        kernel = next(k for k in PTXAS_KERNELS if k in name)
        rows.append((f"{kernel} {_ptxas_label(kernel, name)}".strip(),
                     st.get("regs"), st.get("st"), st.get("ld")))
    return rows


def ptxas_text(rows: list) -> str:
    return "; ".join(f"{label}: {regs} registers, {st} B spill stores, "
                     f"{ld} B spill loads" for label, regs, st, ld in rows)


def phase_build() -> dict:
    """Phase 0: build every kernel source at once, one thread each (a
    build is mostly a compiler process), beside an ``-Xptxas -v`` compile
    of each; returns those reports by source stem."""
    from photon_tpu_torch.kernels import blocked_ell as KB
    from photon_tpu_torch.kernels import fused as KF
    from photon_tpu_torch.kernels import serving as KS

    secs, errors, ptxas = {}, [], {}

    def build(mod) -> None:
        t0 = time.perf_counter()
        try:
            mod.library()
        except Exception as e:  # reported by the main thread
            errors.append(e)
        secs[mod.SOURCE.name] = time.perf_counter() - t0

    def report(mod) -> None:
        try:
            ptxas[mod.SOURCE.stem] = ptxas_report(mod.SOURCE)
        except Exception as e:  # reported by the main thread
            errors.append(e)

    def build_native() -> None:
        from photon_tpu_torch import native

        t0 = time.perf_counter()
        if not native.available():
            errors.append(RuntimeError(
                f"the native library did not build: {native.build_error()}"))
        secs["native/src/photon_native.cc (g++)"] = time.perf_counter() - t0

    mods = (KS, KB, KF)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=fn, args=(m,))
               for m in mods for fn in (build, report)]
    threads.append(threading.Thread(target=build_native))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    missing = [k for k in PTXAS_KERNELS
               if not any(k in r[0] for rows in ptxas.values() for r in rows)]
    if missing:
        raise AssertionError(f"ptxas -v reported no {missing}")
    log(f"phase 0: built {len(secs) - 1} kernel sources and the native "
        f"Avro decoder's host library together in "
        f"{time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    eight = [r for r in ptxas["blocked_ell"] if "lane_chunk=8" in r[0]]
    spilled = [r[0] for r in eight if r[2] or r[3]]
    log("phase 0: the blocked-ELL kernels' 8-lane instantiations (ptxas "
        "-v), the lane grid's: " + ptxas_text(eight) + "; spills: "
        + (", ".join(spilled) if spilled else "none"))
    return ptxas


def phase_kernels(dev, ptxas: list) -> None:
    import torch

    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.kernels import serving as KS

    log(f"phase 1: {KS.KERNEL} (nvcc -O3 -Xptxas -v, sm_90a): "
        + ptxas_text(ptxas))
    rng = np.random.default_rng(11)
    cases = {"fixed dense": [("fixed", False)],
             "fixed sparse": [("fixed", True)],
             "random dense": [("random", False)],
             "random sparse": [("random", True)]}
    cases["all four"] = [p for ps in cases.values() for p in ps]
    cases["20 coords"] = cases["all four"] * 5  # two launches
    with K.scope("on"):
        for label, parts in cases.items():
            args, E = small_case(rng, parts, dev)
            K.reset_launch_counts()
            got = KS.int8_margin(*args)
            launches = K.launch_counts().get(KS.KERNEL, 0)
            want = KS.int8_margin_reference(*args)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       **TOL, err_msg=label)
            if launches != -(-len(parts) // KS.MAX_COORDS):
                raise AssertionError(f"{label}: {launches} launches")
            log(f"phase 1: {label:13s} kernel vs plain max |err| {err:.3g} "
                f"({launches} launch{'es' if launches > 1 else ''})")
        # the two launches of 20 coordinates = 16, then 4 from its margins
        coords, offsets, shards, ids, fixed_ws, re_cs = args
        m = KS.MAX_COORDS
        first = KS.int8_margin(coords[:m], offsets, shards, ids, fixed_ws,
                               re_cs)
        chained = KS.int8_margin(coords[m:], first, shards, ids, fixed_ws,
                                 re_cs)
        torch.cuda.synchronize()
        if not torch.equal(chained, got):
            raise AssertionError("20 coordinates in one call differ from 16 "
                                 "then 4 chained")
        log(f"phase 1: 20 coordinates in one call == the first {m} then the "
            f"last {len(coords) - m} from their margins, bit for bit")
        # cold-miss rows: every entity unseen -> exactly the fixed margin
        for label in ("all four", "20 coords"):
            args, E = small_case(rng, cases[label], dev)
            coords, offsets, shards, ids, fixed_ws, re_cs = args
            ids = {n: torch.full_like(e, E) for n, e in ids.items()}
            got = KS.int8_margin(coords, offsets, shards, ids, fixed_ws,
                                 re_cs)
            fixed_only = KS.int8_margin(
                tuple(c for c in coords if c[1] == "fixed"), offsets, shards,
                ids, fixed_ws, re_cs)
            torch.cuda.synchronize()
            if not torch.equal(got, fixed_only):
                raise AssertionError(f"{label}: cold-miss rows differ from "
                                     "the fixed-only margin")
        log("phase 1: cold-miss rows equal the fixed-only margin exactly "
            "(4 and 20 coordinates)")


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
def time_ms(fn, n: int = 200, warm: int = 20, windows: int = 5) -> float:
    """ms per call of ``fn``: CUDA events around ``windows`` loops of ``n``
    calls each, the median loop's time over n. A loop that the host stalls
    in (a one-card machine shares its host's cores) does not set it."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / n)
    return float(np.median(times))


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


def launch_us(fn, kernel_symbol: str, launches: int, n: int = 10) -> list:
    """Mean device us of each of the ``launches`` launches of the CUDA
    kernels whose name holds ``kernel_symbol`` that one call of ``fn``
    makes, in launch order: ``n`` profiles of three calls each, the last
    call's launches kept (a trace can miss its first few kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    rows = []
    for _ in range(n):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        evs = sorted((ev for ev in prof.events()
                      if str(getattr(ev, "device_type", "")).endswith("CUDA")
                      and kernel_symbol in ev.name),
                     key=lambda ev: ev.time_range.start)
        if len(evs) >= 2 * launches:
            rows.append([ev.time_range.elapsed_us()
                         for ev in evs[-launches:]])
    return list(np.mean(rows, axis=0)) if rows else []


def events_ms(fn, cold: bool, hide_host: bool = True, n: int = 20) -> float:
    """Median ms of one call of ``fn`` between two CUDA events. ``cold``: a
    FLUSH_BYTES write before each call evicts the L2, as the training
    path's hot-block GEMVs (GBs) do between its sparse passes.
    ``hide_host``: a spin kernel holds the stream while the host enqueues
    the call, so the events time its device work alone; otherwise the
    stream is idle at the first event and the time includes the host side
    of the call."""
    import torch

    flush = (torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                         device="cuda") if cold else None)
    fn()
    torch.cuda.synchronize()
    pairs = []
    for i in range(n):
        if cold:
            flush.fill_(float(i))
        if hide_host:
            torch.cuda._sleep(SPIN_CYCLES)
        else:
            torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


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


# ------------------------------------------ phase T1: blocked-ELL kernels
def coo_rows(rng, n, d, k, zipf):
    """bench.py's padded COO recipe: k zipf columns (column 0 = most
    frequent) with N(0, 1) values, plus the intercept column d - 1."""
    col = (rng.zipf(zipf, size=(n, k)).astype(np.int64) - 1) % (d - 1)
    val = rng.normal(size=(n, k)).astype(np.float32)
    ind = np.concatenate([col, np.full((n, 1), d - 1)], axis=1).astype(
        np.int32)
    va = np.concatenate([val, np.ones((n, 1), np.float32)], axis=1)
    return ind, va


def small_layout(dev, bf16: bool):
    """A small blocked-ELL layout on ``dev`` whose width and occurrence
    buckets include one smaller than a tile (32 rows at 8 lanes) and one
    of many tiles (256 rows at 1 lane), with rows that have no tail; its
    8-column hot block leaves occurrence buckets of every width from 1 to
    4,096 slots, so the rmatvec's plan has every class (scalar and vector
    slot loads, groups of 1 to 256 threads per column, walks of 8 and 16
    slots) and a bucket of one column."""
    from photon_tpu_torch.data.matrix import SparseRows, to_blocked_ell
    from photon_tpu_torch.kernels import blocked_ell as KB

    rng = np.random.default_rng(21)
    ind, va = coo_rows(rng, 6000, 20_000, 24, 1.4)
    ind[:500, :-1], va[:500, :-1] = 0, 0.0  # rows 0..499: hot column 0 only
    X = to_blocked_ell(SparseRows(ind, va, 20_000), 8, device=dev)
    for group in (X.ell_vals, X.bucket_vals):
        sizes = [int(v.shape[0]) for v in group]
        if not (min(sizes) < 32 and max(sizes) > 256):
            raise AssertionError(f"T1 layout buckets {sizes} miss a sub-tile "
                                 "or a many-tile bucket")
    B = sum(int(v.shape[0]) for v in X.ell_vals)
    if not bool((X.row_pos == B).any()):
        raise AssertionError("T1 layout has no row without a tail")
    shapes = [tuple(int(s) for s in v.shape) for v in X.bucket_vals]
    widths = {k for _, k in shapes}
    tpcs = {KB.threads_per_column(k) for k in widths}
    if not ({1 << e for e in range(12)} <= widths
            and tpcs == {1 << e for e in range(9)}
            and min(c for c, _ in shapes) == 1):
        raise AssertionError(f"T1 occurrence buckets {shapes} miss a class "
                             "of the rmatvec's plan or a one-column bucket")
    return X.astype(torch_dtype(bf16))


def torch_dtype(bf16: bool):
    import torch

    return torch.bfloat16 if bf16 else torch.float32


def phase_training_kernels(dev, ptxas: list) -> None:
    import torch

    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.data import matrix as M
    from photon_tpu_torch.kernels import blocked_ell as KB

    log("T1: blocked-ELL kernels (nvcc -O3 -Xptxas -v, sm_90a): "
        + ptxas_text(ptxas))
    rng = np.random.default_rng(22)
    worst = {}
    n_bits = n_tail_bits = 0

    def check(name, label, got, want):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   **TOL, err_msg=f"{name} {label}")
        err = float((got - want).abs().max().item())
        worst[name] = max(worst.get(name, 0.0), err)

    for bf16 in (False, True):
        X = small_layout(dev, bf16)
        n, d = X.shape
        U = X.n_prefix - X.d_sel
        for lanes in (None, 1, 3, 8):
            shape = () if lanes is None else (lanes,)
            w = torch.from_numpy(rng.normal(size=(d,) + shape).astype(
                np.float32)).to(dev)
            r = torch.from_numpy(rng.normal(size=(n,) + shape).astype(
                np.float32)).to(dev)
            label = f"{'bf16' if bf16 else 'f32'} lanes={lanes}"
            want = KB.tail_matvec_reference(X, w)
            # out= slices starting from h0, with NaN guard rows around them
            h0 = torch.from_numpy(rng.normal(size=(n,) + shape).astype(
                np.float32)).to(dev)
            bufs = []
            with K.scope("on"):
                fused = KB.tail_matvec(X, w)
                again = KB.tail_matvec(X, w)
                tiled = KB.tail_matvec_tiled(X, w)
                for fn in (KB.tail_matvec, KB.tail_matvec_tiled):
                    buf = torch.full((n + 7,) + shape, float("nan"),
                                     device=dev)
                    buf[3:3 + n] = h0
                    fn(X, w, out=buf[3:3 + n])
                    bufs.append(buf)
            check(KB.TAIL, label, fused, want)
            check(KB.TAIL_TILED, label, tiled, want)
            start_plus = h0 + fused
            if not (torch.equal(fused, tiled) and torch.equal(fused, again)
                    and all(torch.equal(b[3:3 + n], start_plus)
                            and bool(b[:3].isnan().all())
                            and bool(b[3 + n:].isnan().all())
                            for b in bufs)):
                raise AssertionError(
                    f"tail matvec {label}: fused, repeated, tiled and out= "
                    "launches are not bit-identical")
            n_tail_bits += 1
            for sq in (False, True):
                lab = f"{label} square={sq}"
                want = KB.bucket_rmatvec_reference(X, r, sq)
                # a preallocated output with guard rows on both sides
                buf = torch.full((U + 7,) + shape, float("nan"),
                                 device=dev)
                with K.scope("on"):
                    fused = KB.bucket_rmatvec(X, r, square=sq)
                    again = KB.bucket_rmatvec(X, r, square=sq)
                    tiled = KB.bucket_rmatvec_tiled(X, r, square=sq)
                    KB.bucket_rmatvec_tiled(X, r, square=sq,
                                            out=buf[3:3 + U])
                check(KB.RMATVEC, lab, fused, want)
                check(KB.RMATVEC_TILED, lab, tiled, want)
                if not (torch.equal(fused, tiled) and torch.equal(fused, again)
                        and torch.equal(buf[3:3 + U], fused)
                        and bool(buf[:3].isnan().all())
                        and bool(buf[3 + U:].isnan().all())):
                    raise AssertionError(
                        f"rmatvec {lab}: fused, repeated, tiled and out= "
                        "launches are not bit-identical")
                n_bits += 1
        # the hot block: a bf16 product on cuBLAS with an f32 output
        w16 = torch.from_numpy(rng.normal(size=X.d_sel).astype(
            np.float32)).to(dev).to(X.dense.dtype)
        hot = M._mm_f32(X.dense, w16)
        want = X.dense.float() @ w16.float()
        if hot.dtype != torch.float32:
            raise AssertionError(f"hot block product is {hot.dtype}")
        np.testing.assert_allclose(hot.cpu().numpy(), want.cpu().numpy(),
                                   **TOL, err_msg="hot block")
    log("T1: every blocked-ELL kernel matches its plain version (f32/bf16, "
        "vector/1/3/8 lanes, square on/off; sub-tile and many-tile buckets, "
        "rows with no tail, occurrence buckets of 1 to 4,096 slots and one of "
        "a single column); max |err| "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        + f"; tail matvec fused == repeated == tiled, and both forms added "
        f"into out= == start + fused (guard rows untouched), bit for bit, in "
        f"all {n_tail_bits} cases;"
        f" rmatvec fused == repeated == tiled == tiled into out=, bit for "
        f"bit, in all {n_bits} cases; hot block bf16 product returns f32")


# ------------------------------------------------ phase T2: train at width
def planted_labels(rng, ind, va, w_true) -> np.ndarray:
    """Logistic labels of padded COO rows under ``w_true``."""
    margin = np.einsum("nk,nk->n", va, w_true[ind])
    return (rng.uniform(size=len(ind)) < 1 / (1 + np.exp(-margin))).astype(
        np.float32)


def sparse_planted(seed: int, rows: int):
    """bench.py's sparse_problem recipe with numpy from ``seed``: padded
    COO rows, a planted hot-end signal ``w_true`` and labels from it;
    returns (ind, va, y, w_true)."""
    rng = np.random.default_rng(seed)
    ind, va = coo_rows(rng, rows, T_FEATURES, T_NNZ, T_ZIPF)
    d = T_FEATURES
    w_true = np.zeros(d, np.float32)
    hot = 200_000
    w_true[:hot] = rng.normal(size=hot) / np.sqrt(np.arange(1, hot + 1))
    w_true[d - 1] = -0.2
    return ind, va, planted_labels(rng, ind, va, w_true), w_true


def sparse_problem(seed: int, rows: int):
    """(ind, va, y) of `sparse_planted`."""
    return sparse_planted(seed, rows)[:3]


def heldout_rows(seed: int, rows: int, w_true):
    """Held-out rows of the same recipe drawn from ``seed``, labelled by
    the same planted ``w_true``: (ind, va, y)."""
    rng = np.random.default_rng(seed)
    ind, va = coo_rows(rng, rows, T_FEATURES, T_NNZ, T_ZIPF)
    return ind, va, planted_labels(rng, ind, va, w_true)


def solve_timed(batch, cfg, dev, solve=None):
    """(model, result, wall s) of one logistic `train_glm` (or of ``solve``
    (batch, cfg), when given) closed by a synchronize."""
    import torch

    from photon_tpu_torch.models.training import train_glm
    from photon_tpu_torch.ops.losses import TaskType

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if solve is None:
        model, res = train_glm(batch, TaskType.LOGISTIC_REGRESSION, cfg,
                               device=dev)
    else:
        model, res = None, solve(batch, cfg)
    torch.cuda.synchronize()
    return model, res, time.perf_counter() - t0


def phase_training(args, dev, gpu) -> dict:
    """T2; returns what T3 and the kernel line need."""
    import torch

    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.data import matrix as M
    from photon_tpu_torch.data.dataset import cast_features, make_batch
    from photon_tpu_torch.data.matrix import SparseRows, to_blocked_ell
    from photon_tpu_torch.kernels import blocked_ell as KB
    from photon_tpu_torch.models.training import make_objective
    from photon_tpu_torch.models.variance import (VarianceComputationType,
                                                  compute_variances)
    from photon_tpu_torch.ops.losses import TaskType
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l2

    rows = T_ROWS
    t0 = time.perf_counter()
    ind, va, y, w_true = sparse_planted(args.seed, rows)
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    X = to_blocked_ell(SparseRows(ind, va, T_FEATURES), T_DENSE,
                       device_dense_dtype=torch.bfloat16, device=dev)
    batch = cast_features(make_batch(X, y, device=dev))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    X = batch.X
    U = X.n_prefix - X.d_sel
    facts = dict(tail_pad_waste=X.tail_pad_waste,
                 tail_nnz_share=X.tail_nnz / (rows * (T_NNZ + 1)),
                 ell_buckets=len(X.ell_vals),
                 ell_bucket_shapes=[tuple(int(s) for s in v.shape)
                                    for v in X.ell_vals],
                 occurrence_buckets=len(X.bucket_vals), U=U,
                 occurrence_bucket_shapes=[tuple(int(s) for s in v.shape)
                                           for v in X.bucket_vals])
    log(f"T2: data made in {gen_s:.1f} s; layout built in {build_s:.1f} s "
        f"on the host + device (hot block on the card); "
        + "; ".join(f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in facts.items()))
    cfg = OptimizerConfig(max_iters=T_ITERS, tolerance=0.0, reg=l2(),
                          reg_weight=T_REG, history=T_HISTORY)
    short = dataclasses.replace(cfg, max_iters=T_SHORT)
    if K.route(X, torch.zeros(T_FEATURES, device=dev)) != "fused" or \
            K.route(X, batch.y) != "fused":
        raise AssertionError("solve (a) must take the fused route")

    # (a): the main path — counts reset just before, read just after
    K.reset_launch_counts()
    torch.cuda.synchronize()
    resident_gb = torch.cuda.memory_allocated(dev) / 1e9
    build_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    model, res_a, solve_s = solve_timed(batch, cfg, dev)
    solve_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    obj = make_objective(TaskType.LOGISTIC_REGRESSION, cfg, T_FEATURES,
                         intercept_index=X.last_col_pos, device=dev)
    w_perm = X.from_model_space(model.coefficients.means)
    torch.cuda.reset_peak_memory_stats(dev)
    var = compute_variances(obj, w_perm, batch,
                            VarianceComputationType.SIMPLE)
    torch.cuda.synchronize()
    launches_a = K.launch_counts()
    var_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    peak_gb = max(build_peak_gb, solve_peak_gb, var_peak_gb)
    # the same variances with the hot block squared whole, as before the
    # (X∘X)ᵀr pass squared it in row chunks
    sq_rows = M._SQ_ROWS
    M._SQ_ROWS = rows
    torch.cuda.reset_peak_memory_stats(dev)
    var_whole = compute_variances(obj, w_perm, batch,
                                  VarianceComputationType.SIMPLE)
    torch.cuda.synchronize()
    whole_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    M._SQ_ROWS = sq_rows
    np.testing.assert_allclose(var_whole.cpu().numpy(), var.cpu().numpy(),
                               rtol=1e-5, err_msg="variances, whole square")
    del var_whole
    with K.scope("off"):
        var_plain = compute_variances(obj, w_perm, batch,
                                      VarianceComputationType.SIMPLE)
    np.testing.assert_allclose(var.cpu().numpy(), var_plain.cpu().numpy(),
                               rtol=1e-4, err_msg="SIMPLE variances")
    var_err = float(((var - var_plain).abs() / var_plain.abs()).max())
    it_a = res_a.iterations
    rate = rows * it_a / solve_s

    # (b): the tiled forms carry the path at full width
    K.reset_launch_counts()
    _, res_b, b_s = with_budget("0", lambda: solve_timed(batch, short, dev))
    launches_b = K.launch_counts()
    w5_model = res_b.w.cpu().numpy()  # train_glm returns model order
    # (c): the plain versions on the card
    K.reset_launch_counts()
    _, res_c, c_s = solve_timed(batch, dataclasses.replace(short,
                                                           kernels="off"),
                                dev)
    if K.launch_counts():
        raise AssertionError(f"scope off launched {K.launch_counts()}")

    ha, hb, hc = res_a.history(), res_b.history(), res_c.history()
    for label, h in (("a", ha), ("b", hb), ("c", hc)):
        if not np.isfinite(h).all():
            raise AssertionError(f"solve ({label}) has a non-finite loss")
    np.testing.assert_allclose(hb, ha[:T_SHORT + 1], rtol=1e-5,
                               err_msg="tiled vs fused loss history")
    np.testing.assert_allclose(hc, ha[:T_SHORT + 1], rtol=1e-5,
                               err_msg="plain vs fused loss history")
    for name in (KB.TAIL, KB.RMATVEC):
        if launches_a.get(name, 0) == 0:
            raise AssertionError(f"{name} never launched in solve (a)")
    for name in (KB.TAIL_TILED, KB.RMATVEC_TILED):
        if launches_b.get(name, 0) == 0:
            raise AssertionError(f"{name} never launched in solve (b)")
    if set(launches_a) != {KB.TAIL, KB.RMATVEC}:
        raise AssertionError(f"solve (a) launched {launches_a}")
    if set(launches_b) != {KB.TAIL_TILED, KB.RMATVEC_TILED}:
        raise AssertionError(f"solve (b) launched {launches_b}")
    log(f"T2: (a) {it_a} iterations (cap {T_ITERS}) in {solve_s:.3f} s: "
        f"{rate:.6g} rows*iters/s; loss {ha[0]:.7g} -> {ha[-1]:.7g}; "
        f"launches (solve + SIMPLE variances) {launches_a}  [{gpu}]")
    log(f"T2: (b) tiled, {res_b.iterations} iterations in {b_s:.3f} s, "
        f"launches {launches_b}; (c) plain, {res_c.iterations} iterations "
        f"in {c_s:.3f} s; max rel loss gap to (a): tiled "
        f"{np.max(np.abs(hb - ha[:T_SHORT + 1]) / np.abs(ha[:T_SHORT + 1])):.3g}"
        f", plain "
        f"{np.max(np.abs(hc - ha[:T_SHORT + 1]) / np.abs(ha[:T_SHORT + 1])):.3g}")
    log(f"T2: SIMPLE variances vs plain: max rel err {var_err:.3g}; peak "
        f"device memory {peak_gb:.3f} GB  [{gpu}]")
    log(f"T2: peak device memory: {resident_gb:.3f} GB resident after the "
        f"layout (build peak {build_peak_gb:.3f}); solve (a) without "
        f"variances {solve_peak_gb:.3f} GB; its SIMPLE variances "
        f"{var_peak_gb:.3f} GB with the hot block squared in chunks of "
        f"{sq_rows} rows, {whole_peak_gb:.3f} GB squared whole  [{gpu}]")
    busy, n_ops, top, wall, by_name, counts = solve_profile(batch, short,
                                                           dev)
    rmv_us = sum(us for name, us in by_name.items()
                 if "bell_bucket_rmatvec_kernel" in name)
    tail_us = sum(us for name, us in by_name.items()
                  if "bell_tail_matvec_kernel" in name)
    log(f"T2: profiled {T_SHORT}-iteration solve: device busy "
        + ("not measured" if busy is None else
           f"{busy * 1e3:.3f} ms of {wall * 1e3:.3f} ms wall "
           f"({busy / wall:.3f} busy, {1 - busy / wall:.3f} idle); "
           f"bucket_rmatvec kernel {rmv_us / 1e3:.3f} ms "
           f"({rmv_us / 1e6 / busy:.4f} of device busy), tail_matvec "
           f"kernel {tail_us / 1e3:.3f} ms "
           f"({tail_us / 1e6 / busy:.4f})")
        + f", {n_ops} device kernels and "
        f"copies (host sync once per iteration); rows*iters/s "
        f"{rows * T_SHORT / wall:.6g}; most device time: "
        + "; ".join(f"{name[:60]} {us / 1e3:.3f} ms" for name, us in top)
        + f"  [{gpu}]")
    log("T2: the profiled solve's device ops (name: launches, ms): "
        + "; ".join(f"{name[:70]}: {counts[name]}, {us / 1e3:.3f}"
                    for name, us in sorted(by_name.items(),
                                           key=lambda kv: -kv[1])))
    # the X pass on each route: no add, no concatenation, no gather
    for route, budget in (("fused", None), ("tiled", "0")):
        ops = device_ops(lambda: M.matvec(X, w_perm), budget)
        log(f"T2: device ops of three matvecs on the {route} route (a trace "
            f"can miss its first kernels): "
            + "; ".join(f"{name[:70]} x{c}" for name, c in ops.items()))
    return dict(batch=batch, launches_a=launches_a, launches_b=launches_b,
                w=w_perm, facts=facts, coo=(ind, va, y), w_true=w_true,
                hist_a=ha, w40_model=model.coefficients.means.cpu().numpy(),
                w5_model=w5_model, solve_peak=solve_peak_gb)


def device_ops(fn, budget=None) -> dict:
    """{device op name: count} over three calls of ``fn`` under
    torch.profiler (kernels, copies and memsets), with the kernels' byte
    budget set to ``budget`` (None: unset) for the calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from photon_tpu_torch import kernels as K

    old = os.environ.pop(K.ENV_BUDGET, None)
    if budget is not None:
        os.environ[K.ENV_BUDGET] = budget
    try:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
    finally:
        os.environ.pop(K.ENV_BUDGET, None)
        if old is not None:
            os.environ[K.ENV_BUDGET] = old
    ops: dict = {}
    for name, _ in device_events(prof):
        ops[name] = ops.get(name, 0) + 1
    return ops


def solve_profile(batch, cfg, dev, solve=None):
    """(device busy s, device op count, the five device ops that took the
    most time [(name, us)], wall s, {name: us} and {name: count} of every
    device op) of one short solve (`solve_timed`'s) under torch.profiler:
    the summed time of the CUDA kernels and copies against the wall
    clock. Only device activity is traced, as in `profiled_busy`."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, wall = solve_timed(batch, cfg, dev, solve)
    by_name, counts, n_ops = {}, {}, 0
    for name, t in device_events(prof):
        by_name[name] = by_name.get(name, 0.0) + t
        counts[name] = counts.get(name, 0) + 1
        n_ops += 1
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return ((busy_us / 1e6 if busy_us > 0 else None), n_ops, top, wall,
            by_name, counts)


# ----------------------------------------------- phase T3: kernel timings
def tail_csr(X, transpose: bool):
    """The layout's tail as an f32 CSR (n, U), or its transpose (U, n), on
    the device — cuSPARSE's operand for the library yardstick."""
    import torch

    n, U = int(X.shape[0]), X.n_prefix - X.d_sel
    order = torch.argsort(X.row_pos)  # position in the concat -> row
    rows, cols, vals, base = [], [], [], 0
    for pc, pv in zip(X.ell_pcols, X.ell_vals):
        r_b, W = pc.shape
        orig = order[base:base + r_b]
        base += r_b
        keep = pv != 0
        rows.append(orig[:, None].expand(r_b, W)[keep])
        cols.append(pc[keep].long())
        vals.append(pv[keep].float())
    r, c, v = torch.cat(rows), torch.cat(cols), torch.cat(vals)
    if transpose:
        r, c, n, U = c, r, U, n
    return torch.sparse_coo_tensor(torch.stack([r, c]), v, (n, U)) \
        .coalesce().to_sparse_csr()


def blocked_ell_bounds(X, lanes: int = 1) -> dict:
    """(bound_ms, bound_by) per kernel name for this layout at ``lanes``
    lanes: the bytes each must move (every ELL / bucket slot: int32 index
    + stored value, once; the distinct vector entries it reads, G floats
    each; row_pos; its f32 output, G floats a row or column) over HBM
    bandwidth vs its f32 operations (a multiply-add per slot and lane,
    one more multiply per slot for ``square``) over the f32 peak. A
    layout without an ELL tail (`PermutedHybridRows`) has only the
    rmatvec's, whose rows read are those with a flat-tail entry."""
    n, U, G = int(X.shape[0]), X.n_prefix - X.d_sel, lanes
    vb = X.bucket_vals[0].element_size()
    occ = sum(int(v.numel()) for v in X.bucket_vals)

    def bound(nbytes, ops):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        return max(tb, to), ("bytes" if tb >= to else "operations")

    out = {}
    if hasattr(X, "row_pos"):
        ell = sum(int(v.numel()) for v in X.ell_vals)
        B = sum(int(v.shape[0]) for v in X.ell_vals)
        tail_rows = int((X.row_pos != B).sum().item())  # rows it reads
        tail = bound(ell * (4 + vb) + 4 * U * G + 4 * n + 4 * n * G,
                     2 * ell * G)
        out = {"tail_matvec": tail, "tail_matvec_tiled": tail}
    else:
        tail_rows = int(((X.row_bounds[1:] - X.row_bounds[:-1]) > 0).sum())
    rmv = bound(occ * (4 + vb) + 4 * tail_rows * G + 4 * U * G,
                2 * occ * G)
    out.update({"bucket_rmatvec": rmv, "bucket_rmatvec_tiled": rmv})
    return out


def phase_training_timings(state: dict, gpu) -> list:
    """T3: each blocked-ELL kernel at solve (a)'s shapes; returns the
    kernel line's entries."""
    import torch

    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.data import matrix as M
    from photon_tpu_torch.kernels import blocked_ell as KB

    X = state["batch"].X
    n = int(X.shape[0])
    rng = np.random.default_rng(23)
    w = state["w"]
    r = torch.from_numpy(rng.uniform(-1, 1, size=n).astype(np.float32)).to(
        w.device)
    bounds = blocked_ell_bounds(X)
    csr = tail_csr(X, transpose=False)
    csr_t = tail_csr(X, transpose=True)
    wt = w[X.d_sel:X.n_prefix].to(X.dense.dtype).float()[:, None]
    r16 = r.to(X.dense.dtype).float()[:, None]
    specs = [
        (KB.TAIL, "tail_matvec", KB.tail_matvec, KB.tail_matvec_reference,
         w, "bell_tail_matvec_kernel", lambda: torch.sparse.mm(csr, wt),
         "photon_tpu/kernels/blocked_ell.py:187", state["launches_a"]),
        (KB.TAIL_TILED, "tail_matvec_tiled", KB.tail_matvec_tiled,
         KB.tail_matvec_reference, w, "bell_tail_matvec_kernel",
         lambda: torch.sparse.mm(csr, wt),
         "photon_tpu/kernels/blocked_ell.py:254", state["launches_b"]),
        (KB.RMATVEC, "bucket_rmatvec", KB.bucket_rmatvec,
         KB.bucket_rmatvec_reference, r, "bell_bucket_rmatvec_kernel",
         lambda: torch.sparse.mm(csr_t, r16),
         "photon_tpu/kernels/blocked_ell.py:340", state["launches_a"]),
        (KB.RMATVEC_TILED, "bucket_rmatvec_tiled", KB.bucket_rmatvec_tiled,
         KB.bucket_rmatvec_reference, r, "bell_bucket_rmatvec_kernel",
         lambda: torch.sparse.mm(csr_t, r16),
         "photon_tpu/kernels/blocked_ell.py:408", state["launches_b"]),
    ]
    out = []
    for name, key, fn, plain, v, symbol, lib, replaces, launches in specs:
        with K.scope("on"):
            got = fn(X, v)
            want = plain(X, v)
            torch.cuda.synchronize()
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       **TOL, err_msg=name)
            err = float((got - want).abs().max().item())
            ms = time_ms(lambda: fn(X, v), n=50, warm=5)
            dev_ms = device_ms(lambda: fn(X, v), symbol, n=20)
            ev_ms = events_ms(lambda: fn(X, v), cold=False)
            ev_cold = events_ms(lambda: fn(X, v), cold=True)
            ms_cold = events_ms(lambda: fn(X, v), cold=True, hide_host=False)
        plain_ms = time_ms(lambda: plain(X, v), n=20, warm=3)
        lib_ms = time_ms(lib, n=20, warm=3)
        lib_ev = events_ms(lib, cold=False)
        lib_ev_cold = events_ms(lib, cold=True)
        lib_ms_cold = events_ms(lib, cold=True, hide_host=False)
        bound_ms, bound_by = bounds[key]
        dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
        log(f"T3: {name}: warm L2: {ms:.4f} ms per call, device time of its "
            f"kernels {dev_txt} (profiler) / {ev_ms:.4f} ms (events, the "
            f"whole call); cold "
            f"L2: {ms_cold:.4f} ms per call, {ev_cold:.4f} ms device "
            f"(events); plain {plain_ms:.4f} ms; cuSPARSE f32 CSR warm "
            f"{lib_ms:.4f} ms per call, {lib_ev:.4f} ms device, cold "
            f"{lib_ms_cold:.4f} ms per call, {lib_ev_cold:.4f} ms device; "
            f"bound {bound_ms:.4f} ms ({bound_by}), launches "
            f"{launches.get(name, 0)}, max |err| {err:.3g}  [{gpu}]")
        out.append({"name": name, "route": "cuda",
                    "source": "photon_tpu_torch/kernels/csrc/blocked_ell.cu",
                    "replaces": replaces,
                    "launches": int(launches.get(name, 0)),
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": lib_ms, "device_ms": dev_ms,
                    "device_ms_events": ev_ms,
                    "ms_cold": ms_cold, "device_ms_cold": ev_cold,
                    "library_device_ms": lib_ev,
                    "library_ms_cold": lib_ms_cold,
                    "library_device_ms_cold": lib_ev_cold})
    per_launch = launch_us(lambda: KB.bucket_rmatvec_tiled(X, r),
                           "bell_bucket_rmatvec_kernel", len(X.bucket_vals))
    log("T3: bucket_rmatvec_tiled per launch, warm L2 (k_b: device us): "
        + (", ".join(f"{int(v.shape[1])}: {us:.2f}"
                     for v, us in zip(X.bucket_vals, per_launch))
           or "not measured (no trace held every launch)")
        + f"  [{gpu}]")
    per_launch = launch_us(lambda: KB.tail_matvec_tiled(X, w),
                           "bell_tail_matvec_kernel", len(X.ell_vals))
    log("T3: tail_matvec_tiled per launch, warm L2 (W_b x r_b: device us): "
        + (", ".join(f"{int(v.shape[1])} x {int(v.shape[0])}: {us:.2f}"
                     for v, us in zip(X.ell_vals, per_launch))
           or "not measured (no trace held every launch)")
        + f"  [{gpu}]")
    # the tail step as _bell_matvec takes it: added into the hot product
    hot = M._mm_f32(X.dense, w[:X.d_sel].to(X.dense.dtype))
    steps = {}
    with K.scope("on"):
        for form, fn in (("fused", KB.tail_matvec),
                         ("tiled", KB.tail_matvec_tiled)):
            h = hot.clone()
            steps[form] = (time_ms(lambda: fn(X, w, out=h), n=50, warm=5),
                           events_ms(lambda: fn(X, w, out=h), cold=False),
                           events_ms(lambda: fn(X, w, out=h), cold=True))
        whole = (time_ms(lambda: M.matvec(X, w), n=50, warm=5),
                 events_ms(lambda: M.matvec(X, w), cold=False))
    log("T3: _bell_matvec's tail step (added into the hot product, out=): "
        + "; ".join(f"{form} {a:.4f} ms per call, {b:.4f} ms device warm, "
                    f"{c:.4f} cold (events)"
                    for form, (a, b, c) in steps.items())
        + f"; the whole matvec (hot bf16 GEMV + fused tail) {whole[0]:.4f} "
        f"ms per call, {whole[1]:.4f} ms device warm  [{gpu}]")
    return out


def histories_agree(label: str, want, got) -> float:
    """Raise unless ``got`` has ``want``'s length and agrees within rtol
    1e-5; returns the largest relative gap."""
    if len(got) != len(want) or not np.isfinite(got).all():
        raise AssertionError(f"{label}: history {got} against {want}")
    np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=label)
    return float(np.max(np.abs(got - want) / np.abs(want)))


# ----------------------------------------- phase T2(d): OWL-QN on T2's layout
def phase_sparse_owlqn(state: dict, dev, gpu) -> None:
    """OWL-QN through the blocked-ELL kernels, against the plain
    versions."""
    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.kernels import blocked_ell as KB
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l1

    batch = state["batch"]
    cfg = OptimizerConfig(max_iters=T_SHORT, tolerance=0.0, reg=l1(),
                          reg_weight=1.0, history=T_HISTORY)
    K.reset_launch_counts()
    model, res_a, a_s = solve_timed(batch, cfg, dev)
    launches = K.launch_counts()
    _, res_b, b_s = solve_timed(batch, dataclasses.replace(cfg,
                                                           kernels="off"),
                                dev)
    gap = histories_agree("T2(d) plain vs kernels", res_a.history(),
                          res_b.history())
    if set(launches) != {KB.TAIL, KB.RMATVEC} \
            or launches[KB.RMATVEC] != res_a.evaluations:
        raise AssertionError(f"T2(d) launched {launches} for "
                             f"{res_a.evaluations} evaluations")
    w = model.coefficients.means
    zeros = int((w == 0).sum().item())
    state["owlqn"] = (res_a.history(), w.cpu().numpy())
    log(f"T2(d): OWL-QN on the blocked-ELL layout, {res_a.iterations} "
        f"iterations, {res_a.evaluations} evaluations in {a_s:.3f} s "
        f"(plain {b_s:.3f} s); launches {launches}; {zeros} of "
        f"{w.numel()} coefficients exactly zero; loss {res_a.history()[0]:.7g}"
        f" -> {res_a.history()[-1]:.7g}; max rel gap to plain {gap:.3g}  "
        f"[{gpu}]")


# ------------------------------------------- phase G: the reg-weight grid
def grid_timed(batch, cfg, weights, dev, **kw):
    """(train_glm_grid's result, wall s) of one logistic grid closed by a
    synchronize."""
    import torch

    from photon_tpu_torch.models.training import train_glm_grid
    from photon_tpu_torch.ops.losses import TaskType

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = train_glm_grid(batch, TaskType.LOGISTIC_REGRESSION, cfg, weights,
                         device=dev, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def lane_histories(res) -> list:
    """Each lane's loss history (NaN padding dropped) of a lane-major
    grid result."""
    h = res.loss_history.cpu().numpy()
    return [row[~np.isnan(row)] for row in h]


def grids_agree(label: str, want, got) -> float:
    """Raise unless two lane-major grid results took the same per-lane
    iterations and their loss histories agree within rtol 1e-5; returns
    the largest relative gap."""
    if want.iterations.tolist() != got.iterations.tolist():
        raise AssertionError(f"{label}: iterations {got.iterations} "
                             f"against {want.iterations}")
    return max(histories_agree(f"{label} lane {i}", a, b)
               for i, (a, b) in enumerate(zip(lane_histories(want),
                                               lane_histories(got))))


def with_budget(budget, fn):
    """``fn()`` with the kernels' byte budget knob set to ``budget``."""
    from photon_tpu_torch import kernels as K

    old = os.environ.get(K.ENV_BUDGET)
    os.environ[K.ENV_BUDGET] = budget
    try:
        return fn()
    finally:
        if old is None:
            del os.environ[K.ENV_BUDGET]
        else:
            os.environ[K.ENV_BUDGET] = old


def phase_grid(state: dict, dev, gpu) -> dict:
    """G: the headline 8-lane grid at full width (a), its agreement with
    the tiled forms, the plain versions and 8 single-lane solves (b), and
    OWL-QN and TRON lanes against their plain versions (c); returns what
    the 8-lane kernel timings need."""
    import torch

    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.kernels import blocked_ell as KB
    from photon_tpu_torch.optim.config import OptimizerConfig, OptimizerType
    from photon_tpu_torch.optim.regularization import l1, l2

    batch = state["batch"]
    X = batch.X
    rows, d, G, m = int(X.shape[0]), T_FEATURES, len(S_GRID), T_HISTORY
    cfg = OptimizerConfig(max_iters=T_ITERS, tolerance=0.0, reg=l2(),
                          reg_weight=0.0, history=m,
                          lane_history_dtype="bfloat16")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)

    # (a): the main path — counts reset just before, read just after
    K.reset_launch_counts()
    (res, var), wall = grid_timed(batch, cfg, S_GRID, dev,
                                  device_results=True)
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    its = res.iterations.cpu().numpy()
    hists = lane_histories(res)
    if var is not None or tuple(res.w.shape) != (G, d) \
            or not bool(torch.isfinite(res.w).all()):
        raise AssertionError(f"G (a): result w {tuple(res.w.shape)}, "
                             f"variances {var}")
    for i, h in enumerate(hists):
        if not np.isfinite(h).all() or not h[-1] < h[0]:
            raise AssertionError(f"G (a) lane {i}: loss history {h}")
    if set(launches) != {KB.TAIL, KB.RMATVEC}:
        raise AssertionError(f"G (a) launched {launches}")
    steps = int(its.max())
    rate = rows * int(its.sum()) / wall
    GRID_RATE["G"] = rate
    layout_b = sum(t.numel() * t.element_size() for t in X._tensors())
    lane_b = 4 * d * G
    state_b = 10 * lane_b + 2 * m * d * G * 2 + 8 * rows * G * 4
    log(f"G: (a) {G}-lane L2 grid (S_GRID {S_GRID[0]:g}..{S_GRID[-1]:g}, "
        f"history {m} bf16, tolerance 0) through train_glm_grid"
        f"(device_results=True): per-lane iterations {its.tolist()} in "
        f"{wall:.3f} s: {rate:.6g} rows*sum(iters)/s "
        f"({rows * steps / wall:.6g} rows*iters/s per lock-step iteration "
        f"count); line-search trials {res.trials} over {steps} "
        f"iterations ({res.trials / steps:.3f} per iteration); launches "
        f"{launches}; loss lane 0 {hists[0][0]:.7g} -> {hists[0][-1]:.7g}, "
        f"lane {G - 1} {hists[-1][0]:.7g} -> {hists[-1][-1]:.7g}  [{gpu}]")
    log(f"G: (a) peak device memory {peak / 1e9:.3f} GB ({base / 1e9:.3f} GB "
        f"resident before: the layout {layout_b / 1e9:.3f} GB and T2's "
        f"tensors), {(peak - base) / 1e9:.3f} GB for the solve against a "
        f"reckoned {state_b / 1e9:.3f} GB (10 (d, G) f32 tensors of "
        f"{lane_b / 1e9:.3f} GB, the bf16 S/Y history "
        f"{2 * m * d * G * 2 / 1e9:.3f} GB, 8 (n, G) f32 tensors)  [{gpu}]")
    del var
    short = dataclasses.replace(cfg, max_iters=T_SHORT)
    busy, n_ops, top, pwall, by_name, _ = solve_profile(
        batch, short, dev,
        lambda b, c: grid_timed(b, c, S_GRID, dev, device_results=True))
    kern_us = {k: sum(us for name, us in by_name.items() if k in name)
               for k in ("bell_tail_matvec_kernel",
                         "bell_bucket_rmatvec_kernel", "nvjet")}
    log(f"G: profiled {T_SHORT}-iteration grid: device busy "
        + ("not measured" if busy is None else
           f"{busy * 1e3:.3f} ms of {pwall * 1e3:.3f} ms wall "
           f"({busy / pwall:.3f} busy, {1 - busy / pwall:.3f} idle); "
           + ", ".join(f"{k} {us / 1e3:.3f} ms ({us / 1e6 / busy:.4f})"
                       for k, us in kern_us.items()))
        + f", {n_ops} device kernels and copies ({n_ops / T_SHORT:.1f} per "
        f"iteration); most device time: "
        + "; ".join(f"{name[:60]} {us / 1e3:.3f} ms" for name, us in top)
        + f"  [{gpu}]")

    # (b): 5 iterations, f32 history: kernels, tiled forms, plain versions
    # on the card, and 8 single-lane solves at each lane's weight
    f32 = dataclasses.replace(short, lane_history_dtype=None)
    K.reset_launch_counts()
    (res_k, _), k_s = grid_timed(batch, f32, S_GRID, dev,
                                 device_results=True)
    launches_k = K.launch_counts()
    K.reset_launch_counts()
    (res_t, _), t_s = with_budget("0", lambda: grid_timed(
        batch, f32, S_GRID, dev, device_results=True))
    launches_t = K.launch_counts()
    K.reset_launch_counts()
    (res_p, _), p_s = grid_timed(batch, dataclasses.replace(f32,
                                                            kernels="off"),
                                 S_GRID, dev, device_results=True)
    if K.launch_counts():
        raise AssertionError(f"scope off launched {K.launch_counts()}")
    if set(launches_t) != {KB.TAIL_TILED, KB.RMATVEC_TILED}:
        raise AssertionError(f"G (b) tiled launched {launches_t}")
    gap_t = grids_agree("G (b) tiled vs kernels", res_k, res_t)
    gap_p = grids_agree("G (b) plain vs kernels", res_k, res_p)
    single = OptimizerConfig(max_iters=T_SHORT, tolerance=0.0, reg=l2(),
                             history=m)
    gap_s, s_s, k_h = 0.0, 0.0, lane_histories(res_k)
    for i, wt in enumerate(S_GRID):
        _, r1, t1 = solve_timed(batch, dataclasses.replace(
            single, reg_weight=float(wt)), dev)
        s_s += t1
        if r1.iterations != int(res_k.iterations[i]):
            raise AssertionError(f"G (b) lane {i}: {r1.iterations} "
                                 f"iterations alone, "
                                 f"{int(res_k.iterations[i])} in the grid")
        gap_s = max(gap_s, histories_agree(f"G (b) single vs lane {i}",
                                           r1.history(), k_h[i]))
    log(f"G: (b) {T_SHORT} iterations, f32 history: kernels {k_s:.3f} s "
        f"(launches {launches_k}), tiled {t_s:.3f} s (launches "
        f"{launches_t}), plain {p_s:.3f} s, {G} single-lane train_glm "
        f"{s_s:.3f} s; max rel loss gap to the kernels: tiled {gap_t:.3g}, "
        f"plain {gap_p:.3g}, single-lane {gap_s:.3g}; iterations equal  "
        f"[{gpu}]")

    # (c): OWL-QN (L1) and TRON lanes on the same layout vs plain
    for label, c, wts in (
            ("OWL-QN", OptimizerConfig(max_iters=T_SHORT, tolerance=0.0,
                                       reg=l1(), history=m), G_L1),
            ("TRON", OptimizerConfig(optimizer=OptimizerType.TRON,
                                     max_iters=T_SHORT, tolerance=0.0,
                                     reg=l2(), cg_max_iters=D_CG), G_TRON)):
        K.reset_launch_counts()
        (ra, _), a_s = grid_timed(batch, c, wts, dev, device_results=True)
        la = K.launch_counts()
        (rb, _), b_s = grid_timed(batch, dataclasses.replace(c,
                                                             kernels="off"),
                                  wts, dev, device_results=True)
        gap = grids_agree(f"G (c) {label} plain vs kernels", ra, rb)
        if set(la) != {KB.TAIL, KB.RMATVEC}:
            raise AssertionError(f"G (c) {label} launched {la}")
        zeros = int((ra.w == 0).sum(dim=1).max()) if label == "OWL-QN" \
            else None
        log(f"G: (c) {label} {len(wts)} lanes {wts}: iterations "
            f"{ra.iterations.tolist()} in {a_s:.3f} s (plain {b_s:.3f} s), "
            f"trials {ra.trials}, HVPs {ra.hvps}, launches {la}"
            + ("" if zeros is None else
               f", most exact zeros in a lane {zeros} of {d}")
            + f"; max rel loss gap to plain {gap:.3g}  [{gpu}]")
    W8 = X.from_model_space(res.w.t().contiguous())
    return dict(w8=W8, launches=launches, launches_tiled=launches_t)


def phase_grid_timings(state: dict, grid: dict, gpu) -> dict:
    """G: the four blocked-ELL kernels at 8 lanes on T2's layout (the grid's
    final coefficients; a seeded (n, 8) cotangent) against their plain
    versions, cuSPARSE's SpMM and their 8-lane bounds; the tail and
    rmatvec forms bit-identical. Returns each kernel's 8-lane figures by
    name."""
    import torch

    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.kernels import blocked_ell as KB

    X = state["batch"].X
    n, G = int(X.shape[0]), 8
    w8 = grid["w8"]
    r8 = torch.from_numpy(np.random.default_rng(24).uniform(
        -1, 1, size=(n, G)).astype(np.float32)).to(w8.device)
    bounds = blocked_ell_bounds(X, lanes=G)
    csr, csr_t = tail_csr(X, transpose=False), tail_csr(X, transpose=True)
    wt = w8[X.d_sel:X.n_prefix].to(X.dense.dtype).float()
    r16 = r8.to(X.dense.dtype).float()
    specs = [
        (KB.TAIL, "tail_matvec", KB.tail_matvec, KB.tail_matvec_reference,
         w8, "bell_tail_matvec_kernel", lambda: torch.sparse.mm(csr, wt),
         grid["launches"]),
        (KB.TAIL_TILED, "tail_matvec_tiled", KB.tail_matvec_tiled,
         KB.tail_matvec_reference, w8, "bell_tail_matvec_kernel",
         lambda: torch.sparse.mm(csr, wt), grid["launches_tiled"]),
        (KB.RMATVEC, "bucket_rmatvec", KB.bucket_rmatvec,
         KB.bucket_rmatvec_reference, r8, "bell_bucket_rmatvec_kernel",
         lambda: torch.sparse.mm(csr_t, r16), grid["launches"]),
        (KB.RMATVEC_TILED, "bucket_rmatvec_tiled", KB.bucket_rmatvec_tiled,
         KB.bucket_rmatvec_reference, r8, "bell_bucket_rmatvec_kernel",
         lambda: torch.sparse.mm(csr_t, r16), grid["launches_tiled"]),
    ]
    out, bits = {}, {}
    for name, key, fn, plain, v, symbol, lib, launches in specs:
        with K.scope("on"):
            got = fn(X, v)
            want = plain(X, v)
            torch.cuda.synchronize()
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       **TOL, err_msg=f"{name} at 8 lanes")
            bits[name] = got
            err = float((got - want).abs().max().item())
            ms = time_ms(lambda: fn(X, v), n=50, warm=5)
            dev_ms = device_ms(lambda: fn(X, v), symbol, n=20)
            ev_ms = events_ms(lambda: fn(X, v), cold=False)
            ev_cold = events_ms(lambda: fn(X, v), cold=True)
            ms_cold = events_ms(lambda: fn(X, v), cold=True, hide_host=False)
        plain_ms = time_ms(lambda: plain(X, v), n=10, warm=2)
        lib_ms = time_ms(lib, n=20, warm=3)
        lib_ev = events_ms(lib, cold=False)
        lib_cold = events_ms(lib, cold=True)
        bound_ms, bound_by = bounds[key]
        dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
        log(f"G: {name} at 8 lanes: warm L2 {ms:.4f} ms per call, device "
            f"{dev_txt} (profiler) / {ev_ms:.4f} ms (events); cold L2 "
            f"{ms_cold:.4f} ms per call, {ev_cold:.4f} ms device (events); "
            f"plain {plain_ms:.4f} ms; cuSPARSE SpMM f32 CSR x (., 8) warm "
            f"{lib_ms:.4f} ms per call, {lib_ev:.4f} ms device, cold "
            f"{lib_cold:.4f} ms device; bound {bound_ms:.4f} ms ({bound_by}); "
            f"launches in the grid's solves {launches.get(name, 0)}; max "
            f"|err| {err:.3g}  [{gpu}]")
        out[name] = {"lanes8_ms": ms, "lanes8_device_ms": dev_ms,
                     "lanes8_device_ms_events": ev_ms,
                     "lanes8_ms_cold": ms_cold,
                     "lanes8_device_ms_cold": ev_cold,
                     "lanes8_plain_ms": plain_ms,
                     "lanes8_library_ms": lib_ms,
                     "lanes8_library_device_ms": lib_ev,
                     "lanes8_library_device_ms_cold": lib_cold,
                     "lanes8_bound_ms": bound_ms,
                     "lanes8_max_abs_err": err,
                     "grid_launches": int(launches.get(name, 0))}
    for a, b in ((KB.TAIL, KB.TAIL_TILED), (KB.RMATVEC, KB.RMATVEC_TILED)):
        if not torch.equal(bits[a], bits[b]):
            raise AssertionError(f"{a} and {b} differ at 8 lanes")
    log("G: at 8 lanes the fused and tiled forms agree bit for bit (tail "
        "matvec, rmatvec)")
    hot_rmatvec_accuracy(X, r8, gpu)
    return out


def hot_rmatvec_accuracy(X, r, gpu) -> None:
    """G: the hot block's Xᵀr over all n rows against an f64 product, as
    one cuBLAS call over the whole contraction and as the X pass sums it
    (`_mm_f32`: chunks of `_MM_CHUNK` rows), for 1 and 8 columns of the
    bf16-rounded cotangent ``r``; raises if the X pass is off by more than
    1e-5 of the largest output."""
    import torch

    from photon_tpu_torch.data import matrix as M

    r16 = r.to(X.dense.dtype)
    n, step = int(X.shape[0]), 1 << 17
    exact = sum(X.dense[k:k + step].double().t() @ r16[k:k + step].double()
                for k in range(0, n, step))
    parts = []
    for G in (1, 8):
        rg = r16[:, :G].contiguous()
        want = exact[:, :G]
        errs = {}
        for form, fn in (("one cuBLAS call", lambda: M._mm(X.dense.t(), rg)),
                         ("chunked", lambda: M._mm_f32(X.dense.t(), rg))):
            got = fn().double()
            errs[form] = (float((got - want).abs().max()
                                / want.abs().max()),
                          time_ms(fn, n=20, warm=3))
        if errs["chunked"][0] > 1e-5:
            raise AssertionError(f"hot-block Xᵀr at {G} columns: {errs}")
        parts.append(f"{G} column(s): " + ", ".join(
            f"{form} max |err| {e:.3g} of max |exact|, {ms:.4f} ms"
            for form, (e, ms) in errs.items()))
    log(f"G: the hot block's Xᵀr over {n} rows (bf16, f32 output) against "
        f"f64, chunks of {M._MM_CHUNK} rows: " + "; ".join(parts)
        + f"  [{gpu}]")


# --------------------------------------------- phases D1-D4: dense OWL-QN
def fused_case(gen, task, n: int, d: int, dtype, dev):
    """Seeded operands of one fused call: N(0, 1) rows, margins of order
    2, non-zero offsets, weights in [0.5, 2) with every seventh row 0, and
    labels of the task's kind."""
    import torch

    from photon_tpu_torch.ops.losses import TaskType

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    X = randn(n, d).to(dtype)
    w = 2.0 * randn(d) / np.sqrt(d)
    offsets = 0.1 * randn(n)
    weights = 0.5 + 1.5 * torch.rand((n,), generator=gen, device=dev)
    weights[::7] = 0.0
    u = torch.rand((n,), generator=gen, device=dev)
    if task is TaskType.LINEAR_REGRESSION:
        y = randn(n)
    elif task is TaskType.POISSON_REGRESSION:
        y = torch.poisson(torch.full((n,), 2.0, device=dev), generator=gen)
    else:
        y = (u < 0.5).float()
    return X, w, y, weights, offsets


def fused_errors(got, want) -> tuple:
    """(relative loss error, max |dg| / max |g|) of a kernel result."""
    (gl, gg), (wl, wg) = got, want
    rel_loss = abs(float(gl) - float(wl)) / max(abs(float(wl)), 1e-30)
    rel_g = float((gg - wg).abs().max()) / max(float(wg.abs().max()), 1e-30)
    return rel_loss, rel_g


def phase_fused_kernel(dev, ptxas: list) -> None:
    """D1: the fused value+grad kernel against its plain version."""
    import torch

    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.kernels import fused as KF
    from photon_tpu_torch.ops.losses import TaskType

    log(f"D1: {KF.KERNEL} (nvcc -O3 -Xptxas -v, sm_90a): " + ptxas_text(ptxas))
    gen = torch.Generator(device=dev).manual_seed(31)
    worst = [0.0, 0.0]
    n_cases = 0

    def check(label, args) -> None:
        nonlocal worst, n_cases
        with K.scope("on"):
            got = KF.fused_value_and_grad(*args)
            again = KF.fused_value_and_grad(*args)
        want = KF.fused_value_and_grad_reference(*args)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], again[0])
                and torch.equal(got[1], again[1])):
            raise AssertionError(f"{label}: a second call differs")
        rel_loss, rel_g = fused_errors(got, want)
        if not (rel_loss <= 1e-5 and rel_g <= 1e-5):
            raise AssertionError(
                f"{label}: loss rel err {rel_loss:.3g}, max "
                f"|dg|/max|g| {rel_g:.3g} (limit 1e-5 each)")
        worst = [max(worst[0], rel_loss), max(worst[1], rel_g)]
        n_cases += 1

    for dtype in (torch.float32, torch.bfloat16):
        for d in (37, 40, 256, KF.max_features(dtype)):
            for n in (1000, 4097):
                for task in TaskType:
                    args = (task,) + fused_case(gen, task, n, d, dtype, dev)
                    check(f"D1 {task.value} {dtype} n={n} d={d}", args)
    # X one element past a 16-byte boundary: the element-copy branch at a
    # width the bulk copies take
    n, d = 4097, 256
    for task in TaskType:
        X, *rest = fused_case(gen, task, n, d, torch.float32, dev)
        flat = torch.empty(n * d + 1, device=dev)
        Xm = flat[1:].view(n, d)
        Xm.copy_(X)
        check(f"D1 {task.value} misaligned X", (task, Xm, *rest))
    log(f"D1: {KF.KERNEL} matches its plain version in {n_cases} cases "
        f"(4 tasks, f32/bf16, n 1000/4097, d 37/40/256/"
        f"{KF.max_features(torch.float32)} f32 and "
        f"{KF.max_features(torch.bfloat16)} bf16 — d = 37 rows are not a "
        f"multiple of 16 bytes and take the element-copy branch, as does a "
        f"misaligned f32 X at d = 256 —, zero-weight rows, offsets), and a "
        f"second call repeats each bit for bit: worst loss rel err "
        f"{worst[0]:.3g}, worst max|dg|/max|g| {worst[1]:.3g}; ring at "
        f"d = 256 f32: {KF.tile_rows(256, 4)} rows x {KF.stages(256, 4)} "
        f"stages, {KF.smem_bytes(KF.tile_rows(256, 4), KF.stages(256, 4), 256, 4)} "
        f"B of shared memory a block")


def dense_problem(seed: int):
    """bench.py's dense_problem with numpy from ``seed``: N(0, 1) rows and
    labels from a planted N(0, 1) signal."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(D_ROWS, D_FEATURES)).astype(np.float32)
    w_true = rng.normal(size=D_FEATURES).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-(X @ w_true)))
    y = (rng.uniform(size=D_ROWS) < p).astype(np.float32)
    return X, y


def phase_dense_owlqn(args, dev, gpu) -> dict:
    """D2; returns what D3, D4 and the kernel line need."""
    import torch

    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.data.dataset import make_batch
    from photon_tpu_torch.kernels import fused as KF
    from photon_tpu_torch.models.training import make_objective, solve
    from photon_tpu_torch.ops.losses import TaskType
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l1

    t0 = time.perf_counter()
    X, y = dense_problem(args.seed)
    batch = make_batch(X, y, device=dev)
    torch.cuda.synchronize()
    # the L1 weight against the smooth gradient at 0, Xᵀ(½ − y)
    g0 = (batch.X.t() @ (0.5 - batch.y)).abs()
    log(f"D2: data made and uploaded in {time.perf_counter() - t0:.1f} s "
        f"({D_ROWS} x {D_FEATURES} f32, {X.nbytes / 1e6:.1f} MB); "
        f"|grad f(0)| per coordinate min {float(g0.min()):.6g}, median "
        f"{float(g0.quantile(0.5)):.6g}, max {float(g0.max()):.6g} "
        f"against L1 {D_L1:g}")
    del X
    cfg = OptimizerConfig(max_iters=D_ITERS, tolerance=0.0, reg=l1(),
                          reg_weight=D_L1, history=D_HISTORY)
    short = dataclasses.replace(cfg, max_iters=D_SHORT)

    # (a): the main path — counts reset just before, read just after
    K.reset_launch_counts()
    model, res_a, solve_s = solve_timed(batch, cfg, dev)
    launches_a = K.launch_counts()
    it_a, ev_a = res_a.iterations, res_a.evaluations
    if launches_a != {KF.KERNEL: ev_a}:
        raise AssertionError(f"solve (a) launched {launches_a} for {ev_a} "
                             "evaluations")
    # (b): the plain version on the card
    K.reset_launch_counts()
    _, res_b, b_s = solve_timed(batch, dataclasses.replace(short,
                                                           kernels="off"),
                                dev)
    if K.launch_counts():
        raise AssertionError(f"scope off launched {K.launch_counts()}")
    # (c): the unfused objective (a margin pass and an Xᵀr pass)
    obj = make_objective(TaskType.LOGISTIC_REGRESSION, short, D_FEATURES,
                         fused=False, device=dev)
    w0 = torch.zeros(D_FEATURES, dtype=torch.float32, device=dev)
    _, res_c, c_s = solve_timed(batch, short, dev,
                                solve=lambda b, c: solve(obj, b, w0, c))
    ha = res_a.history()
    k = min(len(ha), D_SHORT + 1)
    gap_b = histories_agree("D2 plain vs kernel", ha[:k], res_b.history())
    gap_c = histories_agree("D2 unfused vs fused", ha[:k], res_c.history())
    w = model.coefficients.means
    zeros = int((w == 0).sum().item())
    if not 0 < zeros < D_FEATURES:
        raise AssertionError(f"D2: {zeros} of {D_FEATURES} coefficients are "
                             "zero; the L1 weight does no work")
    rate = D_ROWS * it_a / solve_s
    log(f"D2: (a) {it_a} iterations (cap {D_ITERS}), {ev_a} evaluations "
        f"({ev_a / max(it_a, 1):.3f} per iteration) in {solve_s:.4f} s: "
        f"{rate:.6g} rows*iters/s; converged {bool(res_a.converged)}; loss "
        f"{ha[0]:.8g} -> {ha[-1]:.8g}; {zeros} of {D_FEATURES} coefficients "
        f"exactly zero; {KF.KERNEL} launches {launches_a[KF.KERNEL]} = "
        f"evaluations  [{gpu}]")
    log(f"D2: (b) plain, {res_b.iterations} iterations in {b_s:.4f} s; (c) "
        f"unfused, {res_c.iterations} iterations, {res_c.evaluations} "
        f"evaluations in {c_s:.4f} s; max rel loss gap to (a): plain "
        f"{gap_b:.3g}, unfused {gap_c:.3g}")
    busy, n_ops, top, wall, _, _ = solve_profile(batch, short, dev)
    log(f"D2: profiled {D_SHORT}-iteration solve: device busy "
        + ("not measured" if busy is None else
           f"{busy * 1e3:.3f} ms of {wall * 1e3:.3f} ms wall "
           f"({busy / wall:.3f} busy, {1 - busy / wall:.3f} idle)")
        + f", {n_ops} device kernels and copies; most device time: "
        + "; ".join(f"{name[:60]} {us / 1e3:.3f} ms" for name, us in top)
        + f"  [{gpu}]")
    return dict(batch=batch, w=w, launches=launches_a)


def phase_dense_tron(state: dict, dev, gpu) -> None:
    """D3: TRON at D2's width, kernel route against scope("off")."""
    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.optim.config import OptimizerConfig, OptimizerType
    from photon_tpu_torch.optim.regularization import l2

    batch = state["batch"]
    cfg = OptimizerConfig(optimizer=OptimizerType.TRON,
                          max_iters=D_TRON_ITERS, tolerance=0.0, reg=l2(),
                          reg_weight=D_TRON_REG, cg_max_iters=D_CG)
    K.reset_launch_counts()
    _, res_a, a_s = solve_timed(batch, cfg, dev)
    launches = K.launch_counts()
    _, res_b, b_s = solve_timed(batch, dataclasses.replace(cfg,
                                                           kernels="off"),
                                dev)
    gap = histories_agree("D3 plain vs kernel route", res_a.history(),
                          res_b.history())
    if launches:  # dense TRON is margin-cached: cuBLAS passes only
        raise AssertionError(f"D3 launched {launches}")
    h = res_a.history()
    log(f"D3: TRON {res_a.iterations} iterations, {res_a.hvps} HVPs "
        f"({2 * res_a.hvps} X passes in CG) in {a_s:.4f} s: "
        f"{D_ROWS * res_a.iterations / a_s:.6g} rows*iters/s; loss "
        f"{h[0]:.8g} -> {h[-1]:.8g}; plain route {b_s:.4f} s, max rel gap "
        f"{gap:.3g}  [{gpu}]")


def phase_dense_grid(state: dict, dev, gpu) -> None:
    """D5: bench.py's run_dense — the 16-lane L2 grid (D_GRID, history 10,
    tolerance 0, 40 iterations) on D2's data through train_glm_grid,
    host results (the transfer closes the timing), twice."""
    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l2

    cfg = OptimizerConfig(max_iters=D_ITERS, tolerance=0.0, reg=l2(),
                          reg_weight=0.0)
    for run in (1, 2):
        K.reset_launch_counts()
        grid, wall = grid_timed(state["batch"], cfg, D_GRID, dev)
        if K.launch_counts():  # the lanes' products are cuBLAS GEMMs
            raise AssertionError(f"D5 launched {K.launch_counts()}")
        its = [r.iterations for _, r in grid]
        for i, (model, r) in enumerate(grid):
            h = r.history()
            if not np.isfinite(h).all() or not h[-1] < h[0] or not bool(
                    model.coefficients.means.isfinite().all()):
                raise AssertionError(f"D5 lane {i}: loss history {h}")
        log(f"D5: run {run}: {len(D_GRID)}-lane L2 grid (D_GRID "
            f"{D_GRID[0]:g}..{D_GRID[-1]:g}) at {D_ROWS} x {D_FEATURES} "
            f"f32, per-lane iterations {its} in {wall:.4f} s: "
            f"{D_ROWS * sum(its) / wall:.6g} rows*sum(iters)/s; trials "
            f"{grid[0][1].trials}; loss lane 0 {grid[0][1].history()[-1]:.8g}"
            f", lane 15 {grid[-1][1].history()[-1]:.8g}  [{gpu}]")


def phase_dense_timings(state: dict, gpu) -> dict:
    """D4: the fused kernel at D2's shape; returns its kernel-line entry."""
    import torch

    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.kernels import fused as KF
    from photon_tpu_torch.ops.losses import TaskType, loss_fns

    b = state["batch"]
    task = TaskType.LOGISTIC_REGRESSION
    X, w = b.X, state["w"]
    args = (task, X, w, b.y, b.weights, b.offsets)
    with K.scope("on"):
        got = KF.fused_value_and_grad(*args)
    want = KF.fused_value_and_grad_reference(*args)
    torch.cuda.synchronize()
    rel_loss, rel_g = fused_errors(got, want)
    if not (rel_loss <= 1e-5 and rel_g <= 1e-5):
        raise AssertionError(f"D4: loss rel err {rel_loss:.3g}, max |dg|/"
                             f"max|g| {rel_g:.3g} at D2's shape")
    err = float((got[1] - want[1]).abs().max())
    with K.scope("on"):
        ms = time_ms(lambda: KF.fused_value_and_grad(*args), n=100, warm=10)
        dev_ms = device_ms(lambda: KF.fused_value_and_grad(*args),
                           "fused_vg", n=50)
        warm_ev = events_ms(lambda: KF.fused_value_and_grad(*args),
                            cold=False)
        cold_ev = events_ms(lambda: KF.fused_value_and_grad(*args),
                            cold=True)
        cold_call = events_ms(lambda: KF.fused_value_and_grad(*args),
                              cold=True, hide_host=False)
    plain_ms = time_ms(lambda: KF.fused_value_and_grad_reference(*args),
                       n=20, warm=3)
    _, d1, _ = loss_fns(task)
    r = b.weights * d1(X @ w + b.offsets, b.y)
    lib_ms = time_ms(lambda: (torch.mv(X, w), torch.mv(X.t(), r)), n=100,
                     warm=10)
    lib_cold = events_ms(lambda: (torch.mv(X, w), torch.mv(X.t(), r)),
                         cold=True)
    n, d = (int(s) for s in X.shape)
    nbytes = n * d * X.element_size() + 3 * n * 4 + 2 * d * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * n * d / F32_OPS_PER_S * 1e3
    bound_ms, bound_by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                               else "operations")
    launches = int(state["launches"].get(KF.KERNEL, 0))
    dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
    log(f"D4: {KF.KERNEL} at {n} x {d} f32: {ms:.4f} ms per call (device "
        f"time of its two kernels {dev_txt}), plain {plain_ms:.4f} ms, "
        f"library yardstick (the unfused route's two cuBLAS GEMVs, "
        f"torch.mv(X, w) + torch.mv(X.T, r)) {lib_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB), "
        f"{nbytes / 1e9 / (ms / 1e3):.1f} GB/s per call; launches in D2 (a) "
        f"{launches}; loss rel err {rel_loss:.3g}, max |dg| {err:.3g}  "
        f"[{gpu}]")
    rows, ring = KF.tile_rows(d, X.element_size()), KF.stages(
        d, X.element_size())
    log(f"D4: device ms by CUDA events (host hidden): warm L2 "
        f"{warm_ev:.4f}, cold L2 (a {FLUSH_BYTES >> 20} MB write before "
        f"each call) {cold_ev:.4f}; a cold call from an idle stream "
        f"{cold_call:.4f}; the two GEMVs cold {lib_cold:.4f}; "
        f"{bound_ms / warm_ev:.3f} of the bound warm; ring {rows} rows x "
        f"{ring} stages, {KF._plan(X.device, n, d, False)[2]} blocks  "
        f"[{gpu}]")
    return {"name": KF.KERNEL, "route": "cuda",
            "source": "photon_tpu_torch/kernels/csrc/fused_vg.cu",
            "replaces": "photon_tpu/ops/fused.py:204", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            # no one PyTorch call computes the loss and Xᵀr: the two GEMVs
            # above are a yardstick, not the library's version
            "library_ms": None}


def phase_serving(args, dev, gpu) -> dict:
    """Phases 2 and 3; returns the serving kernel's entry of the kernel
    line."""
    import torch

    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.kernels import serving as KS
    from photon_tpu_torch.serving import ProgramLadder
    from photon_tpu_torch.serving.dispatcher import _Pending, collate_rung_args

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
        top_rung = rung
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
    # the top rung with a cold L2, and the floor of any launch of its grid
    rung = top_rung
    lib = KS.library()
    with K.scope("on"):
        warm_ev = events_ms(lambda: KS.int8_margin(*rung), cold=False)
        cold_ev = events_ms(lambda: KS.int8_margin(*rung), cold=True)
        cold_call = events_ms(lambda: KS.int8_margin(*rung), cold=True,
                              hide_host=False)

    def empty():
        K.launch(lib.photon_serving_int8_empty, dev.index or 0, MAX_BATCH)

    empty_dev = device_ms(empty, "serving_int8_empty_kernel")
    empty_ev = events_ms(empty, cold=False)
    log(f"phase 3: rung B={MAX_BATCH} device time by CUDA events (host "
        f"hidden): warm L2 {warm_ev * 1e3:.2f} us, cold L2 (a "
        f"{FLUSH_BYTES >> 20} MB write before each call) "
        f"{cold_ev * 1e3:.2f} us; a cold call from an idle stream "
        f"{cold_call * 1e3:.2f} us; an empty kernel of the same grid "
        + ("not measured" if empty_dev is None
           else f"{empty_dev * 1e3:.2f} us")
        + f" by the profiler, {empty_ev * 1e3:.2f} us by events  [{gpu}]")
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
    return {"name": KS.KERNEL, "route": "cuda",
            "source": "photon_tpu_torch/kernels/csrc/serving_int8.cu",
            "replaces": "photon_tpu/kernels/serving.py:69",
            "launches": int(launches[KS.KERNEL]), "max_abs_err": top["err"],
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": None}


# ------------------------------------ phase E: validation-driven selection
def validation_pass(models, Xv, y_t, G: int):
    """One validation pass over ``Xv``: the G models' margins in one lane
    pass and each lane's AUC on the card; returns (margins, AUC tensor)."""
    import torch

    from photon_tpu_torch.evaluation import auc as auc_t
    from photon_tpu_torch.models.glm import score_models

    m = score_models(models, Xv)
    return m, torch.stack([auc_t(m[i], y_t) for i in range(G)])


def phase_validation(args, state: dict, dev, gpu) -> dict:
    """E: the fixed-effect grid (S_GRID) through GameEstimator.fit with
    held-out rows on their own blocked-ELL layout; returns the kernels'
    launches inside the fit."""
    import torch

    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.data.dataset import cast_features, make_batch
    from photon_tpu_torch.data.matrix import SparseRows, to_blocked_ell
    from photon_tpu_torch.game.dataset import GameData
    from photon_tpu_torch.game.estimator import (FixedEffectConfig,
                                                 GameEstimator)
    from photon_tpu_torch.kernels import blocked_ell as KB
    from photon_tpu_torch.models.glm import score_models
    from photon_tpu_torch.models.training import (evaluate_glm_grid,
                                                  train_glm_grid)
    from photon_tpu_torch.ops.losses import TaskType
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l2

    batch = state["batch"]
    X, y = batch.X, state["coo"][2]
    G = len(S_GRID)
    t0 = time.perf_counter()
    ind, va, vy = heldout_rows(args.seed + E_SEED, E_ROWS, state["w_true"])
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vbatch = cast_features(make_batch(to_blocked_ell(
        SparseRows(ind, va, T_FEATURES), T_DENSE,
        device_dense_dtype=torch.bfloat16, device=dev), vy, device=dev))
    torch.cuda.synchronize()
    lay_s = time.perf_counter() - t0
    Xv = vbatch.X
    del ind, va
    shared = np.intersect1d(X.perm_cols[:X.d_sel].cpu().numpy(),
                            Xv.perm_cols[:Xv.d_sel].cpu().numpy()).size
    log(f"E: {E_ROWS} held-out rows from T2's planted w_true (seed "
        f"{args.seed + E_SEED}) made in {gen_s:.1f} s, laid out in "
        f"{lay_s:.1f} s: {T_DENSE}-column bf16 hot block ({shared} of its "
        f"columns also hot in T2's layout), {Xv.n_prefix - Xv.d_sel} tail "
        f"columns, {len(Xv.ell_vals)} width and {len(Xv.bucket_vals)} "
        "occurrence buckets")
    cfg = OptimizerConfig(max_iters=T_ITERS, tolerance=0.0, reg=l2(),
                          reg_weight=0.0, history=T_HISTORY,
                          lane_history_dtype="bfloat16")
    train = GameData.build(y, shards={"fixed": X})
    val = GameData.build(vy, shards={"fixed": Xv})

    def estimator(c):
        return GameEstimator(
            task=TaskType.LOGISTIC_REGRESSION, n_sweeps=1,
            warm_start=False, device=dev,
            coordinate_configs={"fixed": FixedEffectConfig("fixed", c)})

    def grid_of(c):
        return [{"fixed": FixedEffectConfig(
            "fixed", dataclasses.replace(c, reg_weight=float(w)))}
            for w in S_GRID]

    est = estimator(cfg)
    if not est.would_vectorize(grid_of(cfg), data=train):
        raise AssertionError("E: the grid must take _fit_fixed_grid")
    builds0 = KB.plan_builds()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    # the main path — counts reset just before, read just after
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = est.fit(train, validation=val, config_grid=grid_of(cfg))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = K.launch_counts()
    builds = KB.plan_builds() - builds0
    peak = torch.cuda.max_memory_allocated(dev)
    its = [int(r.descent.coordinate_stats["fixed"][0].iterations)
           for r in res]
    aucs = [r.validation_score for r in res]
    best = est.best_model(res)
    best_i = [r is best for r in res].index(True)
    if set(launches) != {KB.TAIL, KB.RMATVEC}:
        raise AssertionError(f"E: the fit launched {launches}")
    if builds != 1:
        raise AssertionError(f"E: {builds} plan builds in the fit (one, "
                             "for the validation layout, expected)")
    models = [r.model["fixed"].model for r in res]
    vy_t = torch.from_numpy(vy).to(dev)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        margins, aucs_t = validation_pass(models, Xv, vy_t, G)
        aucs_t.cpu()
        times.append(time.perf_counter() - t0)
    log(f"E: GameEstimator.fit(validation=..., config_grid=S_GRID) through "
        f"_fit_fixed_grid ({G} L2 lanes {S_GRID[0]:g}..{S_GRID[-1]:g}, "
        f"history {T_HISTORY} bf16, tolerance 0): {fit_s:.3f} s; per-lane "
        f"iterations {its}; launches in the fit {launches}; plan builds "
        f"{builds}; peak device memory {peak / 1e9:.3f} GB "
        f"({(peak - base) / 1e9:.3f} GB above the {base / 1e9:.3f} GB "
        f"resident)  [{gpu}]")
    log(f"E: validation AUC per lane "
        + ", ".join(f"{a:.6f}" for a in aucs) + f"; best index {best_i} "
        f"(L2 {S_GRID[best_i]:g}); the validation pass (score_models + {G} "
        f"AUCs on the card) {1e3 * float(np.median(times)):.3f} ms "
        f"(median of 3)  [{gpu}]")

    # each lane equals a direct train_glm_grid with the same config
    direct = train_glm_grid(batch, TaskType.LOGISTIC_REGRESSION, cfg,
                            S_GRID, device=dev)
    for i, (m, r) in enumerate(direct):
        if not torch.equal(m.coefficients.means,
                           models[i].coefficients.means.cpu()):
            raise AssertionError(f"E: lane {i} is not train_glm_grid's "
                                 "bit for bit")
        if int(r.iterations) != its[i]:
            raise AssertionError(f"E: lane {i} iterations {its[i]} against "
                                 f"train_glm_grid's {int(r.iterations)}")
    # the validation margins: kernels against scope("off") and against
    # each model's single-lane score
    margins = score_models(models, Xv)
    with K.scope("off"):
        plain = score_models(models, Xv)
    np.testing.assert_allclose(margins.cpu().numpy(), plain.cpu().numpy(),
                               **TOL, err_msg="E: margins vs scope off")
    gap_single = 0.0
    for i, m in enumerate(models):
        one = m.score(Xv).cpu().numpy()
        np.testing.assert_allclose(margins[i].cpu().numpy(), one, **TOL,
                                   err_msg=f"E: lane {i} vs its own score")
        gap_single = max(gap_single, float(np.abs(
            margins[i].cpu().numpy() - one).max()))
    gap_off = float((margins - plain).abs().max())
    # each lane's AUC against numpy f64 on the same margins
    np_aucs = [auc(margins[i].cpu().numpy(), vy) for i in range(G)]
    auc_gap = max(abs(a - b) for a, b in zip(aucs, np_aucs))
    if auc_gap > 1e-4:
        raise AssertionError(f"E: AUC {aucs} against numpy f64 {np_aucs}")
    sel, sel_scores = evaluate_glm_grid(direct, vbatch)
    if sel != best_i:
        raise AssertionError(f"E: best_model {best_i}, evaluate_glm_grid "
                             f"{sel}")
    # 5 iterations on the kernels and under scope("off"): the same AUCs
    short = dataclasses.replace(cfg, max_iters=T_SHORT)
    res_k = estimator(short).fit(train, validation=val,
                                 config_grid=grid_of(short))
    with K.scope("off"):
        res_p = estimator(short).fit(train, validation=val,
                                     config_grid=grid_of(short))
    gap5 = max(abs(a.validation_score - b.validation_score)
               for a, b in zip(res_k, res_p))
    if gap5 > 1e-5:
        raise AssertionError(f"E: 5-iteration AUCs part by {gap5:.3g}")
    log(f"E: lanes equal a direct train_glm_grid bit for bit; validation "
        f"margins within rtol=atol=1e-5 of scope(\"off\") (max |diff| "
        f"{gap_off:.3g}) and of each model's single-lane score "
        f"({gap_single:.3g}); AUC vs numpy f64 rank sum max |diff| "
        f"{auc_gap:.3g}; evaluate_glm_grid picks {sel} (AUCs within "
        f"{max(abs(a - b) for a, b in zip(sel_scores, aucs)):.3g}); "
        f"{T_SHORT}-iteration fits on the kernels and under scope(\"off\"): "
        f"per-lane AUCs within {gap5:.3g}  [{gpu}]")
    state["e_val"] = (vbatch, vy)  # TU (b)'s validation rows
    del vbatch, Xv, margins, plain, direct, res, res_k, res_p
    torch.cuda.empty_cache()
    return launches


# ------------------------------------- phase S: streamed (out-of-memory)
def h2d_gbs(X, dev) -> float:
    """This host's pinned host-to-device rate: one chunk's per-chunk
    tensors (pinned) copied onto the card, best of three, GB/s."""
    import torch

    from photon_tpu_torch.data.dataset import _leaves

    src = _leaves(X.chunks[0])
    dst = [torch.empty(t.shape, dtype=t.dtype, device=dev) for t in src]
    nbytes = sum(t.numel() * t.element_size() for t in src)
    best = float("inf")
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for d_, s_ in zip(dst, src):
            d_.copy_(s_, non_blocking=True)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return nbytes / best / 1e9


def shard_kernels_agree(X, gen, label: str, square=(False,)) -> tuple:
    """The tail matvec and the rmatvec (1 and 8 lanes; (X∘X)ᵀr too when
    ``square`` holds True) on one device `BlockedEllRows` (a ladder chunk
    or a mesh slot's shard) against their plain versions: the tail added
    into random starting values (rows with no tail keep theirs bit for
    bit, so no padded position wrote anywhere), rtol=atol=1e-5. Returns
    (concatenation positions, positions taken by no row, max |err|)."""
    import torch

    from photon_tpu_torch.kernels import blocked_ell as KB

    dev = X.row_pos.device
    n_local, d = int(X.row_pos.shape[0]), X.n_features
    B = sum(int(v.shape[0]) for v in X.ell_vals)
    free = int((X.tail_rows < 0).sum())
    no_tail = X.row_pos == B
    err = 0.0
    for lanes in (1, 8):
        shape = (d,) if lanes == 1 else (d, lanes)
        w = torch.randn(shape, generator=gen, device=dev) * 0.01
        start = torch.randn((n_local,) + shape[1:], generator=gen,
                            device=dev)
        got = KB.tail_matvec(X, w, out=start.clone())
        want = start + KB.tail_matvec_reference(X, w)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   **TOL, err_msg=f"{label} tail, {lanes} "
                                   "lanes")
        err = max(err, float((got - want).abs().max()))
        if not torch.equal(got[no_tail], start[no_tail]):
            raise AssertionError(f"{label} tail: a row with no tail moved")
        r = torch.randn((n_local,) + shape[1:], generator=gen, device=dev)
        for sq in square:
            got_r = KB.bucket_rmatvec(X, r, square=sq)
            want_r = KB.bucket_rmatvec_reference(X, r, square=sq)
            torch.cuda.synchronize()
            np.testing.assert_allclose(got_r.cpu().numpy(),
                                       want_r.cpu().numpy(), **TOL,
                                       err_msg=f"{label} rmatvec, {lanes} "
                                       f"lanes, square={sq}")
            err = max(err, float((got_r - want_r).abs().max()))
    return B, free, err


def ladder_kernels_agree(cb, dev, gpu) -> None:
    """`shard_kernels_agree` on the first and last device chunks of a
    ladder (each width bucket padded to the largest count over the
    chunks)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(7)
    for i, b in cb.iter_device(device=dev):
        if i not in (0, cb.n_chunks - 1):
            continue
        B, free, _ = shard_kernels_agree(b.X, gen, f"ladder chunk {i}")
        log(f"S: ladder chunk {i}: {B} concatenation positions, {free} "
            "taken by no row (padded bucket rows): the tail matvec (1 and 8 "
            "lanes, added into random values; rows with no tail unchanged "
            "bit for bit) and the rmatvec (1 and 8 lanes) agree with their "
            "plain versions within rtol=atol=1e-5  [" + gpu + "]")


def mesh_kernels_agree(X, gen, label: str, gpu) -> None:
    """`shard_kernels_agree`, (X∘X)ᵀr included, on every slot's shard of
    a mesh matrix (a `SlotRows` of `BlockedEllRows`), logged."""
    shapes, free, err = set(), 0, 0.0
    for j, part in enumerate(X.parts):
        B, f, e = shard_kernels_agree(part, gen, f"{label} slot {j}",
                                      square=(False, True))
        shapes.add(B)
        free, err = free + f, max(err, e)
    log(f"{label}: on each of the {len(X.parts)} slots' shards "
        f"({X.rows_per_slot} rows, {sorted(shapes)} concatenation positions, "
        f"{free} taken by no row in all) the tail matvec (1 and 8 lanes, "
        f"added into random values; rows with no tail unchanged bit for "
        f"bit) and the rmatvec (1 and 8 lanes, square off and on) agree "
        f"with their plain versions within rtol=atol=1e-5 (max |err| "
        f"{err:.3g})  [{gpu}]")


def streamed_solve(cb, cfg, dev):
    """(model, result, wall s, launches, telemetry counters, plan builds,
    peak GB over the solve beyond what was allocated before it) of one
    streamed `train_glm`, counts reset just before and read just
    after."""
    import torch

    from photon_tpu_torch import kernels as K
    from photon_tpu_torch import telemetry
    from photon_tpu_torch.kernels import blocked_ell as KB

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    builds = KB.plan_builds()
    telemetry.reset()
    K.reset_launch_counts()
    model, res, wall = solve_timed(cb, cfg, dev)
    launches = K.launch_counts()
    counters = telemetry.snapshot()["counters"]
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    return (model, res, wall, launches, counters, KB.plan_builds() - builds,
            peak)


def phase_streamed(args, t2: dict, dev, gpu) -> dict:
    """S: (a) streamed L-BFGS on T2's problem as a bf16 host ladder, (b)
    streamed OWL-QN on it, (c) bench.py's streamed leg on D2's data;
    returns the kernels' launches in the main-path solves."""
    import torch

    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.data.dataset import (chunk_batch,
                                               chunk_blocked_ell, make_batch)
    from photon_tpu_torch.data.matrix import SparseRows
    from photon_tpu_torch.kernels import blocked_ell as KB
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l1, l2

    ind, va, y = t2["coo"]
    t0 = time.perf_counter()
    cb = chunk_blocked_ell(make_batch(SparseRows(ind, va, T_FEATURES), y,
                                      device="cpu"),
                           S_CHUNK, T_DENSE, feature_dtype=torch.bfloat16)
    build_s = time.perf_counter() - t0
    c0 = cb.X.chunks[0]
    chunk_gb = (cb.X.chunk_nbytes() + 12 * S_CHUNK) / 1e9
    pass_gb = chunk_gb * cb.n_chunks
    rate = h2d_gbs(cb.X, dev)
    log(f"S: T2's problem as a host ladder in {build_s:.1f} s: "
        f"{cb.n_chunks} chunks of {S_CHUNK} rows (pinned), ELL width "
        f"buckets {[tuple(v.shape) for v in c0.ell_vals]}, "
        f"{len(c0.bucket_vals)} occurrence buckets, "
        f"{c0.n_prefix - c0.d_sel} tail columns; {chunk_gb:.4f} GB a chunk "
        f"(hot block {c0.dense.numel() * 2 / 1e9:.4f} GB), {pass_gb:.4f} GB "
        f"a pass; pinned host-to-device {rate:.2f} GB/s (one chunk's "
        f"copy, best of 3)  [{gpu}]")
    ladder_kernels_agree(cb, dev, gpu)

    # (a) the main path: streamed L-BFGS at T2's settings
    cfg = OptimizerConfig(max_iters=T_ITERS, tolerance=0.0, reg=l2(),
                          reg_weight=T_REG, history=T_HISTORY)
    model, res, wall, la, tele, builds, peak = streamed_solve(cb, cfg, dev)
    it = res.iterations
    passes = tele["stream.passes"]
    streams = tele["solver.feature_streams"]
    stall, comp = tele["stream.stall_seconds"], tele["stream.compute_seconds"]
    for name in (KB.TAIL, KB.RMATVEC):
        if la.get(name, 0) == 0:
            raise AssertionError(f"S (a): {name} never launched ({la})")
    if builds > 2:
        raise AssertionError(f"S (a): {builds} plan builds (at most one per "
                             "ring slot, 2)")
    _, res_off, off_s, l_off, _, _, _ = streamed_solve(
        cb, dataclasses.replace(cfg, kernels="off"), dev)
    if l_off:
        raise AssertionError(f"S (a) scope off launched {l_off}")
    if res_off.iterations != it:
        raise AssertionError(f"S (a): {it} iterations, scope off "
                             f"{res_off.iterations}")
    gap_off = histories_agree("S (a) kernels vs scope off",
                              res_off.history(), res.history())
    # against resident T2 (a): the two sum the same rows in other groups
    # (chunk partials against one pass), and at tolerance 0 on this
    # ill-conditioned problem L-BFGS amplifies that rounding step by step
    # (a CPU run of the port at 2^16 rows parts the same way: 1e-7 for 10
    # iterations, 1e-5 by 20, 1e-3 by 40), so the gate holds the first
    # T_SHORT iterations, and a T_SHORT-iteration streamed solve's
    # coefficients against the resident T_SHORT-iteration solve's (T2
    # (b)); the 40-iteration gap is reported
    h, hr = res.history(), t2["hist_a"]
    if len(h) != len(hr):
        raise AssertionError(f"S (a): {it} iterations, resident "
                             f"{len(hr) - 1}")
    rel = np.abs(h - hr) / np.abs(hr)
    parts = np.flatnonzero(rel > 1e-5)
    gap5 = histories_agree("S (a) vs resident T2 (a), first iterations",
                           hr[:T_SHORT + 1], h[:T_SHORT + 1])
    m5, r5, _, _, _, _, _ = streamed_solve(
        cb, dataclasses.replace(cfg, max_iters=T_SHORT), dev)
    w_s, w_r = m5.coefficients.means.cpu().numpy(), t2["w5_model"]
    off = np.abs(w_s - w_r) > 2e-5 + 2e-3 * np.abs(w_r)
    log(f"S (a): against resident T2 (a): histories within {gap5:.3g} over "
        f"the first {T_SHORT} iterations; {T_SHORT}-iteration coefficients "
        f"max |dw| {np.abs(w_s - w_r).max():.4g}, {int(off.sum())} of "
        f"{w_s.size} outside rtol 2e-3 / atol 2e-5; over {it} iterations the "
        f"histories part by more than 1e-5 first at iteration "
        f"{parts[0] if parts.size else 'none'}, "
        f"{rel[-1]:.3g} apart at the last (losses {h[-1]:.8g} and "
        f"{hr[-1]:.8g})")
    np.testing.assert_allclose(w_s, w_r, rtol=2e-3, atol=2e-5,
                               err_msg="S (a) coefficients vs resident")
    it_s = wall / max(it, 1)
    bound_s = pass_gb * streams / max(it, 1) / rate
    reckoned = 2 * chunk_gb + (2 * T_HISTORY + 8) * 4 * T_FEATURES / 1e9
    log(f"S (a): streamed L-BFGS, {it} iterations (cap {T_ITERS}) in "
        f"{wall:.3f} s: {T_ROWS * it / wall:.6g} rows*iters/s (resident T2 "
        f"(a) above); {streams:g} feature streams ({streams / it:.4g} an "
        f"iteration), {passes:g} passes, {pass_gb * streams / it:.4f} GB "
        f"uploaded an iteration, link bound {bound_s * 1e3:.2f} ms of "
        f"{it_s * 1e3:.2f} ms an iteration ({bound_s / it_s:.3f} of it); "
        f"stall share {stall / max(stall + comp, 1e-12):.3f} (stall "
        f"{stall:.3f} s, compute {comp:.3f} s); plan builds {builds}; "
        f"launches {la} ({', '.join(f'{k} {v / (it + 1):.3g}' for k, v in la.items())} "
        f"a pass that runs it: the first pass and each direction or "
        f"gradient pass); "
        f"peak device memory {peak:.3f} GB beside the reckoned "
        f"{reckoned:.3f} GB (2 chunks + {2 * T_HISTORY + 8} vectors of d) "
        f"and resident T2 (a)'s {t2['solve_peak']:.3f} GB; loss {h[0]:.7g} -> {h[-1]:.7g}, "
        f"{abs(h[-1] - hr[-1]) / abs(hr[-1]):.3g} from resident T2 (a)  "
        f"[{gpu}]")
    log(f"S (a): scope('off') {res_off.iterations} iterations in "
        f"{off_s:.3f} s; max rel history gap {gap_off:.3g}")
    short = dataclasses.replace(cfg, max_iters=T_SHORT)
    busy, n_ops, top, pwall, by_name, _ = solve_profile(cb, short, dev)
    copy_us = sum(us for k, us in by_name.items() if "Memcpy" in k)
    log(f"S (a): profiled {T_SHORT}-iteration solve: device busy "
        + ("not measured" if busy is None else
           f"{busy * 1e3:.3f} ms of {pwall * 1e3:.3f} ms wall "
           f"({busy / pwall:.3f}; copies {copy_us / 1e3:.3f} ms, "
           f"{copy_us / 1e6 / pwall:.3f} of the wall, kernels and the "
           f"rest {(busy - copy_us / 1e6) / pwall:.3f})")
        + f", {n_ops} device ops; most device time: "
        + "; ".join(f"{name[:50]} {us / 1e3:.3f} ms" for name, us in top)
        + f"  [{gpu}]")
    launches = dict(la)
    s_ref = dict(hist_lbfgs=h, h2d_gbs=rate, pass_gb=pass_gb)

    # (b) streamed OWL-QN on the same ladder, T2(d)'s settings
    cfg_b = OptimizerConfig(max_iters=T_SHORT, tolerance=0.0, reg=l1(),
                            reg_weight=1.0, history=T_HISTORY)
    model_b, res_b, wall_b, lb, tele_b, _, peak_b = streamed_solve(
        cb, cfg_b, dev)
    _, res_boff, _, lboff, _, _, _ = streamed_solve(
        cb, dataclasses.replace(cfg_b, kernels="off"), dev)
    if lboff:
        raise AssertionError(f"S (b) scope off launched {lboff}")
    gap_b = histories_agree("S (b) kernels vs scope off",
                            res_boff.history(), res_b.history())
    hd, wd = t2["owlqn"]
    np.testing.assert_allclose(res_b.history()[-1], hd[-1], rtol=1e-5,
                               err_msg="S (b) final value vs T2(d)")
    wb = model_b.coefficients.means.cpu().numpy()
    zs = int(((wb == 0) != (wd == 0)).sum())
    ladders = tele_b["solver.feature_streams"] - (res_b.iterations + 1)
    log(f"S (b): streamed OWL-QN, {res_b.iterations} iterations in "
        f"{wall_b:.3f} s, {tele_b['solver.feature_streams']:g} feature "
        f"streams ({ladders:g} 8-lane ladder passes); launches {lb}; "
        f"{int((wb == 0).sum())} coefficients zero, {zs} differ in zero "
        f"set from resident T2(d); loss {res_b.history()[-1]:.7g} vs "
        f"T2(d) {hd[-1]:.7g}; max rel gap to scope off {gap_b:.3g}; peak "
        f"{peak_b:.3f} GB  [{gpu}]")
    if zs:
        raise AssertionError(f"S (b): {zs} coefficients differ in zero set")
    s_ref.update(hist_owlqn=res_b.history(), w_owlqn=wb)
    for name, c in lb.items():
        launches[name] = launches.get(name, 0) + c
    lap("S (a), (b)")
    phase_ck_streamed(cb, res_b, cfg_b,
                      int(tele_b["solver.feature_streams"]), dev, gpu)
    lap("CK (a)")
    phase_pf_ledger(cb, dev, gpu)
    lap("PF (a)")
    del cb, model, model_b
    torch.cuda.empty_cache()

    # (c) bench.py's streamed leg: D2's data in 2^16-row chunks
    X, yd = dense_problem(args.seed)
    cfg_c = OptimizerConfig(max_iters=T_ITERS, tolerance=0.0, reg=l2(),
                            reg_weight=T_REG, history=T_HISTORY)
    rb = make_batch(X, yd, device=dev)
    m_r, res_r, wall_r = solve_timed(rb, cfg_c, dev)
    del rb
    torch.cuda.empty_cache()
    peaks = {}
    for rows in (D_ROWS, D_ROWS // 2):
        cbd = chunk_batch(make_batch(X[:rows], yd[:rows], device="cpu"),
                          S_DENSE_CHUNK)
        m_c, res_c, wall_c, lc, _, _, peaks[rows] = streamed_solve(
            cbd, cfg_c, dev)
        if rows == D_ROWS:
            np.testing.assert_allclose(res_c.history()[-1],
                                       res_r.history()[-1], rtol=1e-5,
                                       err_msg="S (c) final value")
            np.testing.assert_allclose(
                m_c.coefficients.means.cpu().numpy(),
                m_r.coefficients.means.cpu().numpy(), rtol=2e-3, atol=2e-5,
                err_msg="S (c) coefficients")
            log(f"S (c): D2's {D_ROWS} x {D_FEATURES} f32 in "
                f"{cbd.n_chunks} chunks of {S_DENSE_CHUNK} rows: streamed "
                f"{res_c.iterations} iterations in {wall_c:.3f} s, "
                f"{D_ROWS * res_c.iterations / wall_c:.6g} rows*iters/s "
                f"against resident {D_ROWS * res_r.iterations / wall_r:.6g}"
                f" ({res_r.iterations} iterations in {wall_r:.3f} s); "
                f"final loss {res_c.history()[-1]:.8g} vs "
                f"{res_r.history()[-1]:.8g}; launches {lc or 'none'}  "
                f"[{gpu}]")
        del cbd
    chunk_c = (S_DENSE_CHUNK * D_FEATURES * 4 + 12 * S_DENSE_CHUNK) / 1e9
    grow = peaks[D_ROWS] - peaks[D_ROWS // 2]
    log(f"S (c): peak device memory over the streamed solve {peaks[D_ROWS]:.4f}"
        f" GB at {D_ROWS} rows, {peaks[D_ROWS // 2]:.4f} GB at "
        f"{D_ROWS // 2}: grows {grow:.4f} GB (one chunk {chunk_c:.4f} GB)  "
        f"[{gpu}]")
    if grow > chunk_c:
        raise AssertionError("S (c): peak memory grew with the row count")
    torch.cuda.empty_cache()
    return launches, s_ref


# --------------------------------------------- phase MG: the slot mesh
def mesh_solve(batch, cfg, mesh):
    """(model, result, wall s) of one logistic `train_glm` on ``mesh``,
    closed by a synchronize."""
    import torch

    from photon_tpu_torch.models.training import train_glm
    from photon_tpu_torch.ops.losses import TaskType

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, res = train_glm(batch, TaskType.LOGISTIC_REGRESSION, cfg,
                           mesh=mesh)
    torch.cuda.synchronize()
    return model, res, time.perf_counter() - t0


def first_apart(h, hr, rtol: float = 1e-5):
    """The first iteration where two loss histories part by more than
    ``rtol`` (None if they never do), and their relative gap at the last."""
    rel = np.abs(h - hr) / np.abs(hr)
    over = np.flatnonzero(rel > rtol)
    return (int(over[0]) if over.size else None), float(rel[-1])


def psum_ms(mesh, d: int, dev, n: int = 20) -> float:
    """Median ms (CUDA events) of one slot-ordered reduction of MG_SLOTS
    (d + 1)-float slot partials, the payload a value-and-gradient
    evaluation closes with."""
    import torch

    parts = [(torch.randn((), device=dev), torch.randn(d, device=dev))
             for _ in range(mesh.n_local)]
    ts = []
    for _ in range(n + 3):
        a, b = torch.cuda.Event(True), torch.cuda.Event(True)
        a.record()
        mesh.psum(parts)
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts[3:]))


def phase_mesh(t2: dict, s_ref: dict, dev, gpu, setup) -> tuple:
    """MG: (a) T2's L-BFGS on an in-process 8-slot mesh (every slot on
    the visible cards) against T2 (a); (b) S's ladder as mesh chunks
    (L-BFGS, OWL-QN) against S; (d) PF (c)'s umbrella selfcheck, whose
    parallel suite (gloo on the card) gives the digests at 1, 2 and 4
    processes that (c) holds against this process's mesh; (c) (a)'s
    solve cut to MG_ITERS_C
    iterations at 2 processes from a saved sharded batch, bit for bit
    against the in-process mesh; NCCL legs with two cards or more.
    ``setup()`` (later phases' host data, nothing in it timed) runs in
    the wait for the umbrella. Returns the kernels' launches in (a)'s
    main-path solve and what ``setup()`` returned."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    # PF (c)'s umbrella (the parallel suite among its 13) runs beside the
    # host layout builds below and the later phases' host data (its
    # spawned processes on the card, the builds and the data numpy on
    # this host), and so do (c)'s multi-process solves once their shards
    # are saved; both are waited for before any timed solve
    selfcheck = subprocess.Popen(
        [sys.executable, "-m", "photon_tpu_torch", "--selfcheck", "--json",
         "--jobs", str(PF_JOBS)], cwd=here, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    root = tempfile.mkdtemp(prefix="_drv_mg", dir=here)
    threads: list = []
    try:
        return _phase_mesh(t2, s_ref, dev, gpu, selfcheck, t_phase, root,
                           threads, setup)
    finally:
        if selfcheck.poll() is None:
            selfcheck.kill()
            selfcheck.wait()
        for t in threads:
            t.join()
        shutil.rmtree(root, ignore_errors=True)


def _phase_mesh(t2: dict, s_ref: dict, dev, gpu, selfcheck, t_phase: float,
                root: str, threads: list, setup) -> tuple:
    import threading

    import torch

    from photon_tpu_torch import kernels as K
    from photon_tpu_torch import telemetry
    from photon_tpu_torch.data.dataset import (cast_features,
                                               chunk_blocked_ell,
                                               make_batch, mesh_batch,
                                               shard_blocked_ell_batch)
    from photon_tpu_torch.data.matrix import SparseRows
    from photon_tpu_torch.kernels import blocked_ell as KB
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l1, l2
    from photon_tpu_torch.parallel import selfcheck as sc
    from photon_tpu_torch.parallel.launch import launch
    from photon_tpu_torch.parallel.mesh import make_mesh

    ind, va, y = t2["coo"]
    cards = torch.cuda.device_count()
    mesh = make_mesh(n_devices=MG_SLOTS)
    host = make_batch(SparseRows(ind, va, T_FEATURES), y, device="cpu")
    t0 = time.perf_counter()
    # every value leaf bf16, as T2 (a)'s `cast_features`: the same problem
    sb = cast_features(shard_blocked_ell_batch(host, MG_SLOTS, T_DENSE))
    build_s = time.perf_counter() - t0
    # (c)'s multi-process solves start here, from the saved shards, beside
    # PF (c) and (b)'s host layout build; they are waited for before
    # any timed solve, and checked against (a)'s in-process mesh below
    t0 = time.perf_counter()
    sc.save_sharded_batch(sb, root)
    save_s = time.perf_counter() - t0
    cfgd = dict(max_iters=MG_ITERS_C, tolerance=0.0, reg_weight=T_REG,
                history=T_HISTORY)
    # NCCL needs a card per process, and the slots must split evenly
    legs = [("gloo", 2)] + ([("nccl", 4 if cards >= 4 else 2)]
                            if cards >= 2 else [])
    runs: dict = {}

    def run_legs():
        for backend, n in legs:
            t0 = time.perf_counter()
            try:
                runs[backend, n] = (launch(
                    sc.target_saved_solve, n, args=(root, cfgd),
                    device="cuda", backend=backend, timeout_s=600),
                    time.perf_counter() - t0)
            except Exception as e:  # raised in the main thread below
                runs[backend, n] = (e, time.perf_counter() - t0)

    legs_c = threading.Thread(target=run_legs)
    threads.append(legs_c)
    legs_c.start()
    t0 = time.perf_counter()
    cbm = chunk_blocked_ell(host, S_CHUNK, T_DENSE,
                            feature_dtype=torch.bfloat16, n_shards=MG_SLOTS)
    lad_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    made = setup()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out, err = selfcheck.communicate(timeout=900)
    wait_s = time.perf_counter() - t0
    st_s = time.perf_counter() - t_phase
    log(f"MG: the later phases' host data (GM's rows, DRV's and DRV-S's "
        f"Avro files) made in {setup_s:.1f} s while PF (c)'s umbrella ran, "
        f"then {wait_s:.1f} s waiting for it  [{gpu}]")
    report = pf_selfcheck(selfcheck.returncode, out, err, st_s, gpu)
    legs_c.join()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    mb = mesh_batch(sb, mesh)
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t0
    log(f"MG (a): T2's problem laid for {MG_SLOTS} slots in {build_s:.1f} s "
        f"on the host ({mb.X.rows_per_slot} rows a slot, one column "
        f"permutation), uploaded in {up_s:.2f} s; slots on "
        f"{sorted({str(d) for d in mesh.slot_devices})} ({cards} visible "
        f"card(s))  [{gpu}]")
    gen = torch.Generator(device=dev).manual_seed(11)
    mesh_kernels_agree(mb.X, gen, "MG (a) mesh batch", gpu)

    # (a) the main path: counts reset just before, read just after
    cfg = OptimizerConfig(max_iters=T_ITERS, tolerance=0.0, reg=l2(),
                          reg_weight=T_REG, history=T_HISTORY)
    K.reset_launch_counts()
    telemetry.reset()
    model, res, wall = mesh_solve(mb, cfg, mesh)
    launches = K.launch_counts()
    red = telemetry.snapshot()["counters"].get("mesh.reductions", 0)
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    for name in (KB.TAIL, KB.RMATVEC):
        if launches.get(name, 0) == 0:
            raise AssertionError(f"MG (a): {name} never launched "
                                 f"({launches})")
    it = res.iterations
    h, hr = res.history(), t2["hist_a"]
    if len(h) != len(hr):
        raise AssertionError(f"MG (a): {it} iterations, T2 (a) "
                             f"{len(hr) - 1}")
    gap5 = histories_agree("MG (a) vs T2 (a), first iterations",
                           hr[:T_SHORT + 1], h[:T_SHORT + 1])
    apart, last = first_apart(h, hr)
    w_m, w_r = model.coefficients.means.cpu().numpy(), t2["w40_model"]
    dw = float(np.abs(w_m - w_r).max())
    log(f"MG (a): against T2 (a): histories within {gap5:.3g} over the "
        f"first {T_SHORT} iterations; apart by more than 1e-5 first at "
        f"iteration {apart if apart is not None else 'none'} of {it}, "
        f"{last:.3g} apart at the last (losses {h[-1]:.8g} and "
        f"{hr[-1]:.8g}); final coefficients max |dw| {dw:.4g}  [{gpu}]")
    # at tolerance 0 on this ill-conditioned problem the two paths part
    # where the reassociated sums (8 slot partials against one pass) have
    # grown past 1e-5 (§C6, §C13; the JAX package's own mesh and one
    # device part the same way: mesh_parting.py), so the reference's
    # coefficient and value bounds are held where the paths still agree
    # (a T_SHORT-iteration mesh solve against T2's T_SHORT-iteration
    # coefficients), and the 40th value at MG_PART_RTOL
    np.testing.assert_allclose(h[-1], hr[-1], rtol=MG_PART_RTOL,
                               err_msg="MG (a) 40th value vs T2 (a)")
    short = dataclasses.replace(cfg, max_iters=T_SHORT)
    m5, r5, _ = mesh_solve(mb, short, mesh)
    w5 = m5.coefficients.means.cpu().numpy()
    dw5 = float(np.abs(w5 - t2["w5_model"]).max())
    log(f"MG (a): {T_SHORT}-iteration coefficients against T2's: max |dw| "
        f"{dw5:.4g}; final values {r5.history()[-1]:.8g} and "
        f"{hr[T_SHORT]:.8g}")
    np.testing.assert_allclose(w5, t2["w5_model"], atol=1e-4,
                               err_msg="MG (a) coefficients vs T2")
    np.testing.assert_allclose(r5.history()[-1], hr[T_SHORT], rtol=1e-5,
                               err_msg="MG (a) value vs T2 (a)")
    del m5
    red_ms = psum_ms(mesh, T_FEATURES, dev)
    busy, n_ops, top, pwall, _, _ = solve_profile(
        mb, short, dev, solve=lambda b, c: mesh_solve(b, c, mesh)[1])
    log(f"MG (a): {it} iterations in {wall:.3f} s: "
        f"{T_ROWS * it / wall:.6g} rows*iters/s (T2 (a), one device, "
        f"above); {red:g} reductions ({red / it:.4g} an iteration: one per "
        f"evaluation, the line search's trials included; no collective in "
        f"one process, 0 wire bytes); one reduction of the {MG_SLOTS} "
        f"(d + 1)-float slot partials {red_ms:.4f} ms; launches "
        f"{launches}; peak device memory {peak:.3f} GB over the upload and "
        f"solve (T2 (a) one device {t2['solve_peak']:.3f} GB); profiled "
        f"{T_SHORT}-iteration solve: "
        + ("device busy not measured" if busy is None else
           f"{busy / pwall:.3f} busy, {1 - busy / pwall:.3f} idle of "
           f"{pwall * 1e3:.1f} ms")
        + f", {n_ops} device ops; most device time: "
        + "; ".join(f"{name[:50]} {us / 1e3:.3f} ms" for name, us in top)
        + f"  [{gpu}]")
    cfg_c = dataclasses.replace(cfg, max_iters=MG_ITERS_C)
    m_c, res_c, wall_c = mesh_solve(mb, cfg_c, mesh)
    w_c = m_c.coefficients.means.cpu().numpy().astype(np.float64)
    del mb, model, m_c
    torch.cuda.empty_cache()

    # (b) S's ladder as mesh chunks: every chunk row-sharded over the slots
    cfg_b = dataclasses.replace(cfg, max_iters=MG_ITERS_C)
    for i in (0, cbm.n_chunks - 1):
        mesh_kernels_agree(cbm.mesh_chunk(i, mesh).X, gen,
                           f"MG (b) mesh chunk {i}", gpu)
    telemetry.reset()
    K.reset_launch_counts()
    _, rb, wall_b = mesh_solve(cbm, cfg_b, mesh)
    tele = telemetry.snapshot()["counters"]
    lb = K.launch_counts()
    hs = s_ref["hist_lbfgs"][:MG_ITERS_C + 1]
    gap_b = histories_agree("MG (b) L-BFGS vs S (a), first iterations",
                            hs[:T_SHORT + 1], rb.history()[:T_SHORT + 1])
    apart_b, last_b = first_apart(rb.history(), hs)
    np.testing.assert_allclose(rb.history()[-1], hs[-1], rtol=1e-5,
                               err_msg="MG (b) L-BFGS final value vs S (a)")
    streams = tele["solver.feature_streams"]
    stall, comp = tele["stream.stall_seconds"], tele["stream.compute_seconds"]
    it_s = wall_b / max(rb.iterations, 1)
    bound_s = s_ref["pass_gb"] * streams / max(rb.iterations, 1) \
        / s_ref["h2d_gbs"]
    cfg_o = OptimizerConfig(max_iters=T_SHORT, tolerance=0.0, reg=l1(),
                            reg_weight=1.0, history=T_HISTORY)
    mo, ro, wall_o = mesh_solve(cbm, cfg_o, mesh)
    gap_o = histories_agree("MG (b) OWL-QN vs S (b)", s_ref["hist_owlqn"],
                            ro.history())
    wo = mo.coefficients.means.cpu().numpy()
    np.testing.assert_allclose(wo, s_ref["w_owlqn"], atol=1e-4,
                               err_msg="MG (b) OWL-QN coefficients vs S (b)")
    log(f"MG (b): S's ladder for {MG_SLOTS} slots ({cbm.n_chunks} chunks of "
        f"{S_CHUNK} rows, {cbm.mesh_chunk_rows(mesh) // MG_SLOTS} rows a "
        f"slot a chunk) in {lad_s:.1f} s; L-BFGS {rb.iterations} iterations "
        f"in {wall_b:.3f} s: {T_ROWS * rb.iterations / wall_b:.6g} "
        f"rows*iters/s, link bound {bound_s * 1e3:.2f} ms of "
        f"{it_s * 1e3:.2f} ms an iteration ({bound_s / it_s:.3f} of it), "
        f"stall share {stall / max(stall + comp, 1e-12):.3f}; "
        f"{tele['mesh.reductions']:g} reductions for {rb.evaluations} "
        f"evaluations; launches {lb}; vs S (a): within {gap_b:.3g} over "
        f"{T_SHORT} iterations, apart by more than 1e-5 first at "
        f"{apart_b if apart_b is not None else 'none'}, {last_b:.3g} at the "
        f"last; OWL-QN {ro.iterations} iterations in {wall_o:.3f} s, within "
        f"{gap_o:.3g} of S (b), coefficients max |dw| "
        f"{np.abs(wo - s_ref['w_owlqn']).max():.4g}  [{gpu}]")
    for name in (KB.TAIL, KB.RMATVEC):
        if lb.get(name, 0) == 0:
            raise AssertionError(f"MG (b): {name} never launched ({lb})")
    del cbm
    torch.cuda.empty_cache()

    # (d) PF (c)'s parallel suite on the card (gloo: one card, 4 ranks)
    log(f"MG (d): PF (c)'s parallel suite (python -m "
        f"photon_tpu_torch.parallel --selftest --backend gloo on the card, "
        f"beside (a)'s and (b)'s host layout builds): digest "
        f"{report['digest']}; the local_only solve at 1, 2 and 4 processes "
        f"bit for bit equal to the selftest's in-process mesh "
        f"({report['checks']['local_only_solve_bit_identical']['detail']}), "
        f"(rank, decoded, skipped) by process count "
        f"{report['ingest_split']}; 2-process snapshot restored at 1 and 4 "
        f"bit for bit; commit kill (outcome, s) {report['commit_kill']}  "
        f"[{gpu}]")
    agg = report["checks"].get("cross_rank_aggregation", {})
    if not agg.get("ok"):
        raise AssertionError(f"MG (d): no cross_rank_aggregation check: "
                             f"{report['checks']}")
    log(f"MG (d): cross_rank_aggregation ok: the 2-process launch's p0/p1 "
        f"telemetry files merged into one complete report, straggler rank "
        f"{report['aggregate']['straggler_rank']}, barrier wait by rank "
        f"{report['aggregate']['barrier_wait_s']} s, rank start spread "
        f"{report['aggregate']['clock_skew_s']} s  [{gpu}]")

    # (c) the multi-process spine: the selftest's digests against this
    # process's mesh, and (a)'s solve at 2 processes from saved shards
    mine = sc.psum_signature(mesh)
    digests = report["checks"]["psum_bit_identity_1_2_4"]["detail"]
    if report["digest"] != mine:
        raise AssertionError(f"MG (c): selftest digest {report['digest']} "
                             f"against this process's mesh {mine}")
    log(f"MG (c): psum-signature digest at 1, 2, 4 processes (gloo, one "
        f"card) and in the selftest's process {digests}; this process's "
        f"8-slot mesh {mine}: one value")
    if cards < 2:
        log(f"MG (c): one visible card: every multi-process leg runs gloo "
            f"(backend named; NCCL refuses two ranks on one card), the "
            f"partials copied through host memory; no NCCL leg")
    for backend, n in legs:
        res2, l_s = runs[backend, n]
        if isinstance(res2, Exception):
            raise res2
        want = sc._digest(w_c)
        got = [r["digest"] for r in res2]
        if any(g != want for g in got):
            raise AssertionError(f"MG (c) {backend}: {n}-process "
                                 f"coefficients {got} vs in-process "
                                 f"{want}")
        r0 = res2[0]
        log(f"MG (c): (a)'s solve cut to {MG_ITERS_C} iterations at {n} "
            f"processes ({backend}; each maps its own {MG_SLOTS // n} "
            f"slots' shards from disk, {save_s:.1f} s to save them): "
            f"coefficients {got} bit for bit equal to the in-process "
            f"mesh's {want} ({wall_c:.3f} s); {r0['collectives']} "
            f"collectives for {r0['reductions']} reductions (one each), "
            f"{r0['wire_bytes']:.6g} bytes on the wire from rank 0 "
            f"({(T_FEATURES + 1) * 4 * (n - 1):.6g} a value-and-gradient "
            f"reduction); launch + load + solve {l_s:.1f} s, beside PF "
            f"(c) and (b)'s layout build  [{gpu}]")
    del sb, host
    torch.cuda.empty_cache()
    log(f"MG: {time.perf_counter() - t_phase:.1f} s  [{gpu}]")
    return launches, made


# ------------------------------------------ phases GM and GK: GAME training
def game_10m_model(rng) -> tuple:
    """benches/game_10m.py's planted logistic GAME model: (fixed, per-user,
    per-item) coefficients."""
    w_true = (rng.normal(size=GM_D_FIXED) * 0.3).astype(np.float32)
    u_true = rng.normal(size=(GM_USERS, GM_D_RE)).astype(np.float32)
    i_true = rng.normal(size=(GM_ITEMS, GM_D_RE)).astype(np.float32)
    return w_true, u_true, i_true


def game_10m_data(seed: int, rows: int = GM_ROWS, model_seed=None):
    """benches/game_10m.py's data with numpy from ``seed``: N(0, 1) rows
    of the fixed shard and both per-entity shards, uniform user and item
    ids, labels from a planted logistic GAME model — drawn from ``seed``
    first, or, for held-out rows, from ``model_seed``."""
    df, dr = GM_D_FIXED, GM_D_RE
    rng = np.random.default_rng(seed)
    planted = game_10m_model(
        rng if model_seed is None else np.random.default_rng(model_seed))
    w_true, u_true, i_true = planted
    users, items = GM_USERS, GM_ITEMS
    Xf = rng.normal(size=(rows, df)).astype(np.float32)
    Xu = rng.normal(size=(rows, dr)).astype(np.float32)
    Xi = rng.normal(size=(rows, dr)).astype(np.float32)
    uid = rng.integers(0, users, size=rows)
    iid = rng.integers(0, items, size=rows)
    margin = (Xf @ w_true + np.einsum("nd,nd->n", Xu, u_true[uid])
              + np.einsum("nd,nd->n", Xi, i_true[iid]))
    y = (rng.uniform(size=rows) < 1 / (1 + np.exp(-margin))).astype(
        np.float32)
    return Xf, Xu, Xi, uid, iid, y


def game_estimator(dev, fixed_cfg, re_cfg, sweeps: int, variance=None,
                   shards=("fixed", "u_re", "i_re")):
    """benches/game_10m.py's estimator: a fixed effect and per-user and
    per-item random effects, logistic."""
    from photon_tpu_torch.game.estimator import (FixedEffectConfig,
                                                 GameEstimator,
                                                 RandomEffectConfig)
    from photon_tpu_torch.models.variance import VarianceComputationType
    from photon_tpu_torch.ops.losses import TaskType

    return GameEstimator(
        task=TaskType.LOGISTIC_REGRESSION, n_sweeps=sweeps, device=dev,
        variance=variance or VarianceComputationType.NONE,
        coordinate_configs={
            "fixed": FixedEffectConfig(shards[0], fixed_cfg),
            "per_user": RandomEffectConfig("user", shards[1], re_cfg),
            "per_item": RandomEffectConfig("item", shards[2], re_cfg)})


def fit_timed(est, data):
    """(the fit's one GameFitResult, wall s) closed by a synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (res,) = est.fit(data)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


class CoordinateTimer:
    """Seconds of every coordinate update (its train call, closed by a
    synchronize), by feature shard, while the context is open."""

    def __enter__(self):
        import torch

        from photon_tpu_torch.game.fixed_effect import FixedEffectCoordinate
        from photon_tpu_torch.game.random_effect import \
            RandomEffectCoordinate

        self.secs: dict = {}
        self._saved = []
        for cls in (FixedEffectCoordinate, RandomEffectCoordinate):
            train = cls.train

            def timed(coord, *a, _train=train, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _train(coord, *a, **kw)
                torch.cuda.synchronize()
                self.secs.setdefault(coord.dataset.shard_name, []).append(
                    time.perf_counter() - t0)
                return out

            self._saved.append((cls, train))
            cls.train = timed
        return self

    def __exit__(self, *exc):
        for cls, train in self._saved:
            cls.train = train


def auc(scores: np.ndarray, y: np.ndarray) -> float:
    """Area under the ROC curve by the rank sum (ties averaged)."""
    order = np.argsort(scores, kind="stable")
    s = scores[order]
    ranks = np.empty(len(s), np.float64)
    starts = np.flatnonzero(np.r_[True, s[1:] != s[:-1]])
    ends = np.r_[starts[1:], len(s)]
    avg = (starts + ends + 1) / 2.0  # 1-based average rank of each run
    ranks[order] = np.repeat(avg, ends - starts)
    pos = y > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def device_events(prof) -> list:
    """[(name, us)] of every device op (kernel, copy, set) a torch.profiler
    run recorded, read from its raw trace: the profiler's own event
    objects take about 0.1 ms each to build on the host, a minute for the
    ~4e5 ops of a mesh sweep."""
    return [(ev.name(), ev.duration_ns() / 1e3)
            for ev in prof.profiler.kineto_results.events()
            if str(ev.device_type()).endswith("CUDA")]


def profiled_busy(fn):
    """(device busy s, wall s, device op count, the five device ops that
    took the most time [(name, us, launches)]) of ``fn()`` under
    torch.profiler, closed by a synchronize. Only device activity is
    traced: the host's ops would add their recording to the wall, and
    their events take longer to read back than the run itself."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    for name, t in device_events(prof):
        us, n = by_name.get(name, (0.0, 0))
        by_name[name] = (us + t, n + 1)
    us = sum(v[0] for v in by_name.values())
    n_ops = sum(v[1] for v in by_name.values())
    top = sorted(((k, v[0], v[1]) for k, v in by_name.items()),
                 key=lambda t: -t[1])[:5]
    return (us / 1e6 if us > 0 else None), wall, n_ops, top


def entity_check(coord, offsets, seed: int, cfg, dev, gpu, label,
                 strict: bool = True) -> int:
    """GM's check: ``GM_CHECK`` entities drawn from ``seed``, solved as
    lanes of their buckets' lock-step solves (``coord.solve_block``, the
    coordinate's own route) and each alone through `train_glm` on its
    bucket's rows with the same offsets, both under ``cfg``. ``strict``:
    equal iterations and loss histories within rtol 1e-5, else raise.
    Otherwise (the timed configuration, whose solves run to the f32
    floor) report how many agree so, and for each that parts its
    iterations, the first iteration whose losses part and its final
    losses' gap; raise unless every final loss agrees within rtol 1e-5.
    Returns the number of entities checked."""
    import torch

    from photon_tpu_torch.data.dataset import GLMBatch
    from photon_tpu_torch.game.random_effect import RandomEffectCoordinate
    from photon_tpu_torch.models.training import train_glm

    ds = coord.dataset
    check = RandomEffectCoordinate(ds, coord.task, cfg)
    rng = np.random.default_rng(seed)
    picked = set(rng.choice(ds.n_entities, size=min(GM_CHECK,
                                                    ds.n_entities),
                            replace=False).tolist())
    gaps, parted, n = [], [], 0
    for block in ds.blocks:
        lanes = [j for j, e in enumerate(block.entity_index.tolist())
                 if e in picked]
        if not lanes:
            continue
        res, _ = check.solve_block(block, offsets)
        batch = ds.block_batch(block, offsets)
        for j in lanes:
            one = GLMBatch(*(t.contiguous() for t in (
                block.X[j], batch.y[:, j], batch.weights[:, j],
                batch.offsets[:, j])))
            _, single = train_glm(one, coord.task, cfg, device=dev)
            lane_its = int(res.iterations[j])
            entity = int(block.entity_index[j])
            hist = res.loss_history[j].cpu().numpy()
            hist, alone = hist[~np.isnan(hist)], single.history()
            n += 1
            if strict:
                if lane_its != single.iterations:
                    raise AssertionError(
                        f"{label}: entity {entity} took {lane_its} "
                        f"iterations as a lane, {single.iterations} alone")
                gaps.append(histories_agree(f"{label} entity {entity}",
                                            alone, hist))
                continue
            final = float(abs(hist[-1] - alone[-1]) / abs(alone[-1]))
            gaps.append(final)
            c = min(len(hist), len(alone))
            rel = np.abs(hist[:c] - alone[:c]) / np.abs(alone[:c])
            if lane_its != single.iterations or len(hist) != len(alone) \
                    or (rel > 1e-5).any():
                first = int(np.argmax(rel > 1e-5)) if (rel > 1e-5).any() \
                    else c
                parted.append(f"{entity}: {lane_its}/{single.iterations} "
                              f"iterations, losses part at {first}, final "
                              f"gap {final:.3g}")
            if final > 1e-5:
                raise AssertionError(
                    f"{label}: entity {entity}'s final loss {hist[-1]} as a "
                    f"lane, {alone[-1]} alone ({lane_its}/"
                    f"{single.iterations} iterations)")
    torch.cuda.synchronize()
    how = ("iterations equal, max rel loss gap" if strict else
           f"{n - len(parted)} agree (iterations equal, histories within "
           f"rtol 1e-5); parted (lane/alone) [{'; '.join(parted)}]; max "
           "rel gap of the final losses")
    log(f"GM: {label}: {n} entities drawn from the seed, solved as lanes of "
        f"their buckets and each alone through train_glm on its bucket's "
        f"rows with the same offsets ({cfg.max_iters} iterations, tolerance "
        f"{cfg.tolerance:g}): {how} {max(gaps):.3g}  [{gpu}]")
    return n


def phase_game(args, gm_rows: tuple, dev, gpu) -> tuple:
    """GM: benches/game_10m.py at full width through GameEstimator.fit, on
    ``gm_rows`` (`game_10m_data(args.seed)` and the seconds it took);
    returns the kernels' launches in its fits, GS's and GG's, and the
    data CR refreshes."""
    import torch

    from photon_tpu_torch import kernels as K
    from photon_tpu_torch import telemetry
    from photon_tpu_torch.data.dataset import make_batch
    from photon_tpu_torch.game.dataset import GameData
    from photon_tpu_torch.game.random_effect import lane_chunk
    from photon_tpu_torch.game.scoring import coordinate_scores, score_game
    from photon_tpu_torch.models.training import train_glm
    from photon_tpu_torch.ops.losses import TaskType
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l2

    n, sweeps = GM_ROWS, GM_SWEEPS
    (Xf, Xu, Xi, uid, iid, y), gen_s = gm_rows
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    Xf_dev = torch.from_numpy(Xf).to(dev).to(torch.bfloat16)
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t0
    del Xf
    data = GameData.build(y, shards={"fixed": Xf_dev, "u_re": Xu,
                                     "i_re": Xi},
                          entity_ids={"user": uid, "item": iid})
    cfg_f = OptimizerConfig(max_iters=GM_FIXED[0], reg=l2(),
                            reg_weight=GM_FIXED[1])
    cfg_r = OptimizerConfig(max_iters=GM_RE[0], reg=l2(),
                            reg_weight=GM_RE[1])
    est = game_estimator(dev, cfg_f, cfg_r, sweeps)
    log(f"GM: data made in {gen_s:.1f} s in MG's wait ({n} rows, "
        f"{GM_USERS} users + "
        f"{GM_ITEMS} items, d_fixed {GM_D_FIXED} bf16 on the card "
        f"({Xf_dev.numel() * 2 / 1e9:.2f} GB, uploaded in {up_s:.2f} s), "
        f"d_re {GM_D_RE} f32)")

    # the entity bucketing, into the estimator's own dataset cache
    dcache, ccache = est._caches_for(data)
    bucket_s = {}
    for name, cfg in est.coordinate_configs.items():
        t0 = time.perf_counter()
        dcache[est._dataset_key(cfg)] = est._build_dataset(data, cfg)
        torch.cuda.synchronize()
        bucket_s[name] = time.perf_counter() - t0
    datasets = {name: dcache[est._dataset_key(cfg)]
                for name, cfg in est.coordinate_configs.items()}
    for name in ("per_user", "per_item"):
        ds = datasets[name]
        log(f"GM: {name}: bucketed in {bucket_s[name]:.2f} s on the host "
            f"and uploaded: {ds.n_entities} entities, buckets (m, E, lane "
            "chunk) "
            + ", ".join(f"({b.m}, {b.n_entities}, "
                        f"{lane_chunk(b.m, b.n_entities)})"
                        for b in ds.blocks)
            + f"; {ds.n_active} active rows")
    lap("GM data")
    K.reset_launch_counts()
    cold, cold_s = fit_timed(est, data)
    telemetry.reset()
    warm, warm_s = fit_timed(est, data)
    warm_counters = dict(telemetry.snapshot()["counters"])
    launches = K.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    hist = warm.descent.objective_history
    if len(hist) != 3 * sweeps or not np.isfinite(hist).all():
        raise AssertionError(f"GM: objective history {hist}")
    np.testing.assert_allclose(cold.descent.objective_history, hist,
                               rtol=1e-5, err_msg="GM cold vs warm fit")
    if not hist[-1] < n * np.log(2.0):
        raise AssertionError(f"GM: objective {hist[-1]} not below the "
                             f"zero model's {n * np.log(2.0)}")
    log(f"GM: cold fit ({sweeps} sweeps, 3 coordinates, datasets bucketed "
        f"above) {cold_s:.3f} s; warm refit {warm_s:.3f} s: "
        f"{n * sweeps / warm_s:.6g} row-sweeps/s; peak device memory "
        f"{peak_gb:.3f} GB; hand-written kernel launches in both fits "
        f"{launches or 'none'}  [{gpu}]")
    log("GM: objective history (after each update): "
        + ", ".join(f"{v:.8g}" for v in hist))
    for name in ("per_user", "per_item"):
        for sweep, st in enumerate(warm.descent.coordinate_stats[name]):
            its = st.iterations_per_entity
            log(f"GM: {name} sweep {sweep}: iterations median "
                f"{np.median(its):g}, max {its.max()} (cap {GM_RE[0]}); "
                f"{st.n_converged} converged, {st.n_failed} failed of "
                f"{st.n_entities}")
    fixed_its = [int(r.iterations)
                 for r in warm.descent.coordinate_stats["fixed"]]
    with CoordinateTimer() as timer:
        fit_timed(est, data)
    log("GM: seconds per coordinate update (sweep by sweep): "
        + "; ".join(f"{shard} " + ", ".join(f"{v:.3f}" for v in secs)
                    for shard, secs in timer.secs.items())
        + f"; fixed-effect iterations {fixed_its}  [{gpu}]")
    est.n_sweeps = 1
    busy, wall, n_ops, top = profiled_busy(lambda: est.fit(data))
    est.n_sweeps = sweeps
    log("GM: profiled warm sweep: device busy "
        + ("not measured" if busy is None else
           f"{busy:.3f} s of {wall:.3f} s wall ({busy / wall:.3f} busy, "
           f"{1 - busy / wall:.3f} idle)")
        + f", {n_ops} device ops; most device time (ms, launches): "
        + "; ".join(f"{name[:60]} {us / 1e3:.3f}, {k}"
                    for name, us, k in top) + f"  [{gpu}]")
    lap("GM fits")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    total = score_game(warm.model, data)
    scores = total.cpu().numpy()
    score_s = time.perf_counter() - t0
    if scores.shape != (n,) or not np.isfinite(scores).all():
        raise AssertionError("GM: scores are not finite (n,)")
    fixed_only, _ = train_glm(make_batch(Xf_dev, y, device=dev),
                              TaskType.LOGISTIC_REGRESSION, cfg_f,
                              device=dev)
    f_scores = fixed_only.score(Xf_dev).cpu().numpy()
    game_auc, f_auc = auc(scores, y), auc(f_scores, y)
    if not game_auc > f_auc:
        raise AssertionError(f"GM: GAME AUC {game_auc} not above the fixed "
                             f"effect's {f_auc}")
    log(f"GM: scoring {n} rows: {score_s:.3f} s; AUC GAME {game_auc:.6f} vs "
        f"fixed-only {f_auc:.6f}")

    lap("GM scoring")
    gmm_val = gmm_data(args.seed + GMM_SEED, GMM_VAL_ROWS, dev,
                       model_seed=args.seed)
    gmm_game(est, data, warm, warm_counters, gmm_val, dev, gpu)
    lap("GMM (a)")
    # the lane-batched per-entity solves against single solves
    parts = coordinate_scores(warm.model, data)
    coords = {c.dataset.shard_name: c for c in ccache.values()}
    check_cfg = dataclasses.replace(cfg_r, tolerance=RE_CHECK_TOL)
    for name, shard in (("per_user", "u_re"), ("per_item", "i_re")):
        offsets = torch.zeros(n, dtype=torch.float32, device=dev)
        for other, s in parts.items():
            if other != name:
                offsets = offsets + s
        entity_check(coords[shard], offsets, args.seed + 11, check_cfg, dev,
                     gpu, name)
        entity_check(coords[shard], offsets, args.seed + 11, cfg_r, dev,
                     gpu, f"{name} at the timed configuration",
                     strict=False)
    del Xf_dev, parts, coords
    lap("GM entity checks")
    gg = phase_game_grid(args, est, data, dev, gpu)
    lap("GG")
    gmm_grid(est, data, gmm_val, dev, gpu)
    del gmm_val
    lap("GMM (f)")
    # CR's previous model is fitted on this data: its arrays, the fixed
    # shard kept on the host (GS swaps a chunked one into ``data``)
    cr_data = dataclasses.replace(
        data, shards={**data.shards, "fixed": data.shards["fixed"].cpu()},
        entity_ids=dict(data.entity_ids))
    gs = game_streamed(est, data, warm, game_auc, cfg_f, dev, gpu)
    lap("GS")
    phase_ck_game(est, data, dev, gpu)
    del data, est, cold, warm
    torch.cuda.empty_cache()
    return launches, gs, gg, cr_data


def sharded_auc_np(scores: np.ndarray, y: np.ndarray, groups) -> float:
    """The mean over groups holding both classes of each group's AUC by
    the rank sum (ties averaged), in f64."""
    s = scores.astype(np.float64)
    order = np.lexsort((s, groups))
    s, pos, g = s[order], y[order] > 0.5, np.asarray(groups)[order]
    n = len(s)
    starts = np.flatnonzero(np.r_[True, (s[1:] != s[:-1])
                                  | (g[1:] != g[:-1])])
    ends = np.r_[starts[1:], n]
    avg = np.repeat((starts + ends + 1) / 2.0, ends - starts)
    g0 = np.flatnonzero(np.r_[True, g[1:] != g[:-1]])
    size = np.diff(np.r_[g0, n])
    ranks = avg - np.repeat(g0, size)  # 1-based within the group
    n_pos = np.add.reduceat(pos.astype(np.float64), g0)
    n_neg = size - n_pos
    rsum = np.add.reduceat(np.where(pos, ranks, 0.0), g0)
    valid = (n_pos > 0) & (n_neg > 0)
    per = (rsum - n_pos * (n_pos + 1) / 2.0) / np.where(valid,
                                                         n_pos * n_neg, 1.0)
    return float(per[valid].mean())


class UpdateTimer:
    """Seconds of each coordinate update of a lane-axis grid fit (closed by
    a synchronize where the update's lane objective is taken), in update
    order, while the context is open."""

    def __enter__(self):
        import torch

        from photon_tpu_torch.game import grid as GR

        self.secs: list = []
        self._saved = (GR.fit_game_grid, GR._lane_objective)
        fit, objective = self._saved

        def timed_fit(*a, **kw):
            torch.cuda.synchronize()
            self._t = time.perf_counter()
            return fit(*a, **kw)

        def timed_objective(*a, **kw):
            out = objective(*a, **kw)
            torch.cuda.synchronize()
            t = time.perf_counter()
            self.secs.append(t - self._t)
            self._t = t
            return out

        GR.fit_game_grid, GR._lane_objective = timed_fit, timed_objective
        return self

    def __exit__(self, *exc):
        from photon_tpu_torch.game import grid as GR

        GR.fit_game_grid, GR._lane_objective = self._saved


def phase_game_grid(args, est_gm, data, dev, gpu) -> dict:
    """GG: GM's model as a 4-lane grid over the per-user L2 weight through
    GameEstimator.fit's lane-axis path (game.grid.fit_game_grid), with
    held-out rows; returns the kernels' launches in its fits."""
    import torch

    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.evaluation import auc as auc_t
    from photon_tpu_torch.evaluation import grouped_auc
    from photon_tpu_torch.evaluation.evaluator import (Evaluator,
                                                       EvaluatorType)
    from photon_tpu_torch.game.dataset import GameData
    from photon_tpu_torch.game.scoring import score_game

    G, sweeps = len(GG_USER_L2), est_gm.n_sweeps
    base = est_gm.coordinate_configs

    def grid_estimator(check: bool, **kw):
        cfgs = dict(base)
        if check:  # stops at a relative progress of RE_CHECK_TOL
            cfgs = {name: dataclasses.replace(c, optimizer=dataclasses.replace(
                c.optimizer, tolerance=RE_CHECK_TOL))
                for name, c in cfgs.items()}
        est = dataclasses.replace(est_gm, coordinate_configs=cfgs,
                                  warm_start=False, **kw)
        # GM's bucketed datasets and coordinates, shared
        est._caches[id(data)] = est_gm._caches[id(data)]
        grid = [{"per_user": dataclasses.replace(
            cfgs["per_user"], optimizer=dataclasses.replace(
                cfgs["per_user"].optimizer, reg_weight=w))}
            for w in GG_USER_L2]
        return est, grid

    t0 = time.perf_counter()
    Xf, Xu, Xi, uid, iid, vy = game_10m_data(args.seed + GG_SEED,
                                             GG_VAL_ROWS,
                                             model_seed=args.seed)
    val = GameData.build(vy, shards={
        "fixed": torch.from_numpy(Xf).to(dev).to(torch.bfloat16),
        "u_re": Xu, "i_re": Xi}, entity_ids={"user": uid, "item": iid})
    gen_s = time.perf_counter() - t0
    del Xf, Xu, Xi
    est, grid = grid_estimator(
        False, evaluator=Evaluator(EvaluatorType.AUC))
    if not est.would_vectorize(grid, data=data):
        raise AssertionError("GG: the grid must take the lane-axis path")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    # the main path — counts reset just before, read just after
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cold = est.fit(data, validation=val, config_grid=grid)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    est_sh = dataclasses.replace(
        est, evaluator=Evaluator(EvaluatorType.SHARDED_AUC),
        evaluator_entity="user")
    est_sh._caches = est._caches
    with UpdateTimer() as timer:
        t0 = time.perf_counter()
        warm = est_sh.fit(data, validation=val, config_grid=grid)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    launches = K.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    n = data.n
    grid_s = sum(timer.secs)
    log(f"GG: {G}-lane GAME grid (per-user L2 {GG_USER_L2}, the rest GM's) "
        f"through GameEstimator.fit's lane-axis path, GM's datasets: cold "
        f"fit {cold_s:.3f} s, warm refit {warm_s:.3f} s: "
        f"{n * sweeps * G / warm_s:.6g} grid row-sweeps/s (rows x sweeps x "
        f"lanes / warm wall); peak device memory {peak_gb:.3f} GB; "
        f"hand-written kernel launches in both fits {launches or 'none'}  "
        f"[{gpu}]")
    names = list(est.update_sequence or base)
    log("GG: seconds per coordinate update (all lanes): "
        + "; ".join(f"{names[i % len(names)]} {v:.3f}"
                    for i, v in enumerate(timer.secs))
        + f"; the validation pass ({GG_VAL_ROWS} rows made in {gen_s:.1f} "
        f"s: scoring every lane + {G} SHARDED_AUCs) "
        f"{warm_s - grid_s:.3f} s  [{gpu}]")
    for g, r in enumerate(warm):
        its = {name: [f"{np.median(st.iterations_per_entity):g}/"
                      f"{st.iterations_per_entity.max()}"
                      for st in r.descent.coordinate_stats[name]]
               for name in ("per_user", "per_item")}
        log(f"GG: lane {g} (user L2 {GG_USER_L2[g]:g}): objective history "
            + ", ".join(f"{v:.8g}" for v in r.descent.objective_history)
            + f"; iterations per entity median/max by sweep {its}; "
            f"validation AUC {cold[g].validation_score:.6f}, SHARDED_AUC "
            f"{r.validation_score:.6f}")
        np.testing.assert_allclose(r.descent.objective_history,
                                   cold[g].descent.objective_history,
                                   rtol=1e-5, err_msg="GG cold vs warm")
    est1 = dataclasses.replace(est, n_sweeps=1)
    est1._caches = est._caches
    busy, wall, n_ops, top = profiled_busy(
        lambda: est1.fit(data, config_grid=grid))
    log("GG: profiled warm sweep: device busy "
        + ("not measured" if busy is None else
           f"{busy:.3f} s of {wall:.3f} s wall ({busy / wall:.3f} busy, "
           f"{1 - busy / wall:.3f} idle)")
        + f", {n_ops} device ops; most device time (ms, launches): "
        + "; ".join(f"{name[:60]} {us / 1e3:.3f}, {k}"
                    for name, us, k in top) + f"  [{gpu}]")

    # every lane's validation metrics against numpy f64 on the same scores
    val_dev = val.to_device(dev)
    groups = np.unique(uid, return_inverse=True)[1].reshape(-1)
    gap_auc = gap_sh = 0.0
    np_auc, np_sh = [], []
    for g in range(G):
        s = score_game(warm[g].model, val_dev)
        sh = s.cpu().numpy()
        a_np, sh_np = auc(sh, vy), sharded_auc_np(sh, vy, groups)
        np_auc.append(a_np)
        np_sh.append(sh_np)
        a_port = float(auc_t(s, val_dev.y))
        _, _, sh_port = grouped_auc(s, val_dev.y, val_dev.weights, groups,
                                    int(groups.max()) + 1)
        for label, got, want in (
                ("AUC", a_port, a_np), ("SHARDED_AUC", float(sh_port), sh_np),
                ("fit's AUC", cold[g].validation_score, a_np),
                ("fit's SHARDED_AUC", warm[g].validation_score, sh_np)):
            if abs(got - want) > 1e-4:
                raise AssertionError(f"GG lane {g}: {label} {got} against "
                                     f"numpy f64 {want}")
        gap_auc = max(gap_auc, abs(a_port - a_np),
                      abs(cold[g].validation_score - a_np))
        gap_sh = max(gap_sh, abs(float(sh_port) - sh_np),
                     abs(warm[g].validation_score - sh_np))
    s = score_game(warm[0].model, val_dev)
    runs = [grouped_auc(s, val_dev.y, val_dev.weights, groups,
                        int(groups.max()) + 1)[0] for _ in range(2)]
    if not torch.equal(runs[0].nan_to_num(7.0), runs[1].nan_to_num(7.0)):
        raise AssertionError("GG: grouped_auc differs between two runs")
    picks = []
    for label, e, res, want in (("AUC", est, cold, np_auc),
                                ("SHARDED_AUC", est_sh, warm, np_sh)):
        best = e.best_model(res)
        i = [r is best for r in res].index(True)
        j = int(np.argmax(want))
        if i != j and want[j] - want[i] > 1e-6:
            raise AssertionError(f"GG: best_model under {label} picks lane "
                                 f"{i}, numpy lane {j} ({want})")
        picks.append(f"{label} lane {i} (numpy {j})")
    log(f"GG: validation metrics against numpy f64 on the same scores: AUC "
        f"max |diff| {gap_auc:.3g}, SHARDED_AUC {gap_sh:.3g}; grouped_auc "
        f"twice on the card bit for bit; best_model picks "
        + ", ".join(picks) + f"  [{gpu}]")

    # each lane against a sequential fit of its point, every solve
    # stopped at a relative progress of RE_CHECK_TOL, beside the
    # sequential fits' own spread: the same fits with the row weights one
    # ulp above 1 (the chained entity solves amplify a rounding; ROADMAP.md
    # §C8)
    chk, cgrid = grid_estimator(True)
    seq, _ = grid_estimator(True, vectorized_grid=False)
    t0 = time.perf_counter()
    lanes = chk.fit(data, config_grid=cgrid)
    torch.cuda.synchronize()
    lane_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    alone = seq.fit(data, config_grid=cgrid)
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    nudged = seq.fit(dataclasses.replace(data, weights=np.nextafter(
        data.weights, np.float32(2.0))), config_grid=cgrid)
    worst, apart_all = 0.0, []
    for g in range(G):
        gap, apart = fits_agree(f"GG lane {g}", alone[g], lanes[g],
                                strict=False)
        spread = entities_apart(alone[g], nudged[g])
        worst = max(worst, gap)
        for name, (k, k_its, big) in apart.items():
            E = alone[g].model[name].n_entities
            k_sp, _, big_sp = spread[name]
            apart_all.append(f"lane {g} {name} {k}/{E} ({k_its} at another "
                             f"iteration, largest {big:.3g}; nudged "
                             f"{k_sp}, largest {big_sp:.3g})")
            if k > max(1e-3 * E, 2 * k_sp):
                raise AssertionError(
                    f"GG lane {g} {name}: {k} of {E} entities apart, the "
                    f"sequential fits' own one-ulp spread {k_sp}")
    log(f"GG: each lane against a sequential fit of its point (tolerance "
        f"{RE_CHECK_TOL:g}; grid {lane_s:.3f} s, {G} sequential fits "
        f"{seq_s:.3f} s): objective histories within rtol {worst:.3g}, the "
        f"fixed effect within 1e-5 of the largest; entities apart beyond "
        f"rtol 1e-5 (at most 0.1% or twice the sequential fits' own "
        f"spread under a one-ulp nudge of the row weights): "
        + "; ".join(apart_all) + f"  [{gpu}]")
    del cold, warm, lanes, alone, nudged, val, val_dev
    for e in (est, est_sh, est1, chk, seq):
        e._caches.clear()
    torch.cuda.empty_cache()
    return launches


def gk_data(seed: int, rows: int):
    """GK's rows: T2's sparse fixed shard recipe (10,000,000 features, 32
    zipf(1.4) nonzeros + the intercept) and the serving phase's per-user
    and per-item shards (d 8, 8 slots), labels from a planted model."""
    rng = np.random.default_rng(seed)
    ind, va = coo_rows(rng, rows, T_FEATURES, T_NNZ, T_ZIPF)
    w_true = np.zeros(T_FEATURES, np.float32)
    hot = 200_000
    w_true[:hot] = rng.normal(size=hot) / np.sqrt(np.arange(1, hot + 1))
    uid = rng.integers(0, N_USERS, size=rows)
    iid = rng.integers(0, N_ITEMS, size=rows)
    re = {}
    margin = np.einsum("nk,nk->n", va, w_true[ind])
    for name, ids, E in (("u", uid, N_USERS), ("i", iid, N_ITEMS)):
        idx = rng.integers(0, D_RE, size=(rows, K_RE)).astype(np.int32)
        val = rng.normal(size=(rows, K_RE)).astype(np.float32)
        coef = (0.3 * rng.normal(size=(E, D_RE))).astype(np.float32)
        margin += np.einsum("nk,nk->n", val, coef[ids[:, None], idx])
        re[name] = (idx, val)
    y = (rng.uniform(size=rows) < 1 / (1 + np.exp(-margin))).astype(
        np.float32)
    return ind, va, re, uid, iid, y


def entities_apart(want, got) -> dict:
    """{random effect: (entities whose coefficients or variances part
    beyond rtol 1e-5 of the largest, of them stopped at another
    iteration, largest gap)} between two GAME fits."""
    apart = {}
    for name, wm in want.model.coordinates.items():
        if hasattr(wm, "model"):
            continue
        gm = got.model.coordinates[name]
        bad, worst = None, 0.0
        for a, b in ((wm.coefficients, gm.coefficients),
                     (wm.variances, gm.variances)):
            if a is None:
                continue
            a, b = a.cpu().numpy(), b.cpu().numpy()
            off = np.abs(b - a) > 1e-5 * float(np.abs(a).max()) \
                + 1e-5 * np.abs(a)
            rows = off.any(axis=1)
            bad = rows if bad is None else bad | rows
            if rows.any():
                worst = max(worst, float(np.abs(b - a)[off].max()))
        its = [f.descent.coordinate_stats[name][-1].iterations_per_entity
               for f in (want, got)]
        apart[name] = (int(bad.sum()), int((bad & (its[0] != its[1])).sum()),
                       worst)
    return apart


def fits_agree(label: str, want, got, strict: bool) -> tuple:
    """Raise unless two GAME fits' objective histories agree within rtol
    1e-5 and the fixed effect's coefficients and variances within rtol
    1e-5 of the largest of each; ``strict``: every random-effect entity's
    too. Returns (the largest relative history gap, `entities_apart`)."""
    gap = histories_agree(f"{label} objective history",
                          np.asarray(want.descent.objective_history),
                          np.asarray(got.descent.objective_history))
    for name, wm in want.model.coordinates.items():
        if not hasattr(wm, "model"):
            continue
        gm = got.model.coordinates[name]
        for a, b in ((wm.model.coefficients.means,
                      gm.model.coefficients.means),
                     (wm.model.coefficients.variances,
                      gm.model.coefficients.variances)):
            if a is None:
                continue
            a, b = a.cpu().numpy(), b.cpu().numpy()
            np.testing.assert_allclose(b, a, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(a).max()),
                                       err_msg=f"{label} {name}")
    apart = entities_apart(want, got)
    for name, (k, _, worst) in apart.items():
        if strict and k:
            E = want.model.coordinates[name].n_entities
            raise AssertionError(
                f"{label} {name}: {k} of {E} entities apart (largest gap "
                f"{worst:.3g})")
    return gap, apart


def resolve_agree(label: str, est, data, want, dev) -> None:
    """Re-solve each random effect of ``want`` (a one-sweep fit of
    ``est`` on scope("off")) from the offsets it saw there, recomputed
    from ``want``'s scores in the descent's order, once on the default
    route and once on scope("off"): raise unless both give ``want``'s
    tables bit for bit. Their solves reach no kernel, so a fit on the
    default route parts from ``want`` only through its offsets."""
    import torch

    from photon_tpu_torch import kernels as K

    dcache, ccache = est._caches_for(data)
    configs = est.coordinate_configs
    coords = est._build_coordinates(
        {name: dcache[est._dataset_key(cfg)] for name, cfg in
         configs.items()}, configs, ccache)
    base = torch.as_tensor(data.offsets).to(dev, torch.float32)
    scores = {}
    with K.scope("off"):
        scores["fixed"] = coords["fixed"].score(
            want.model.coordinates["fixed"])
    for name in ("per_user", "per_item"):
        offsets = base
        for s in scores.values():
            offsets = offsets + s
        wm = want.model.coordinates[name]
        for route in ("default", "off"):
            if route == "off":
                with K.scope("off"):
                    model, _ = coords[name].train(offsets)
            else:
                model, _ = coords[name].train(offsets)
            for part, a, b in (("coefficients", wm.coefficients,
                                model.coefficients),
                               ("variances", wm.variances, model.variances)):
                if (a is None) != (b is None) or (
                        a is not None and not torch.equal(a.cpu(), b.cpu())):
                    raise AssertionError(
                        f"{label} {name}: re-solved on the {route} route "
                        f"from the same offsets, the {part} are not the "
                        "fit's bit for bit")
        scores[name] = coords[name].score(wm)


def entity_pass_costs(est, data, gpu) -> None:
    """GK's sparse entity blocks: per bucket, the device ms (events, host
    hidden, warm L2) of the lane Xᵀr as the port sums it (a segmented
    scan over each lane's slots sorted by column), of d masked column
    sums (one pass over the slots per column, slot order) and of
    PyTorch's `scatter_add_` (atomic adds, the order left to the run),
    with the scan's largest gap to the masked sums."""
    import torch

    dcache, _ = est._caches_for(data)
    for name in ("per_user", "per_item"):
        ds = dcache[est._dataset_key(est.coordinate_configs[name])]
        rows = []
        for block in ds.blocks:
            X = block.lanes
            if X.indices is None:
                continue
            m, k, E = X.indices.shape
            d = X.n_features
            R = torch.randn((m, E), generator=torch.Generator(
                X.indices.device).manual_seed(m), device=X.indices.device)
            idx = X.indices.reshape(m * k, E)
            contrib = (X.values * R[:, None, :]).reshape(m * k, E)

            def masked():
                return torch.stack([torch.sum(torch.where(
                    idx == j, contrib, 0.0), dim=0) for j in range(d)])

            def scattered():
                return torch.zeros((d, E), device=R.device).scatter_add_(
                    0, idx, contrib)

            gap = float((X.rmatvec_lanes(R) - masked()).abs().max())
            rows.append(f"({m}, {E}, {m * k} slots): scan "
                        f"{events_ms(lambda: X.rmatvec_lanes(R), False):.4f}"
                        f", masked {events_ms(masked, False):.4f}, "
                        f"scatter_add_ {events_ms(scattered, False):.4f}, "
                        f"max |scan - masked| {gap:.3g}")
        log(f"GK: {name}'s lane Xᵀr per bucket (m, E, slots a lane), "
            f"device ms: " + "; ".join(rows) + f"  [{gpu}]")


def game_streamed(est, data, warm, game_auc: float, cfg_f, dev,
                  gpu) -> dict:
    """GS: GM's fit with the fixed shard as a host ChunkedMatrix of dense
    bf16 chunks (GS_CHUNK rows), the random effects' bucketed datasets
    reused from GM's fits; held against GM's warm fit (objective rtol
    1e-5, AUC within 1e-4) and, on the fixed shard alone, its streamed
    fixed-effect solve against the resident one stopped at a relative
    progress of RE_CHECK_TOL (iterations equal, coefficients rtol 2e-3 /
    atol 2e-5). The fits' own fixed-effect solves run on to a relative
    progress of 1e-7, the f32 floor of a 10M-row sum, where the two sides
    step on rounding (the coefficients move ~1e-4 while the loss moves
    below its f32 resolution), so their coefficient gap is reported;
    returns the kernels' launches in its fits."""
    import torch

    from photon_tpu_torch import kernels as K
    from photon_tpu_torch import telemetry
    from photon_tpu_torch.data.dataset import (chunk_matrix, make_batch,
                                               make_chunked_batch)
    from photon_tpu_torch.game.scoring import score_game
    from photon_tpu_torch.models.training import train_glm
    from photon_tpu_torch.ops.losses import TaskType

    n, sweeps = GM_ROWS, GM_SWEEPS
    t0 = time.perf_counter()
    chunked = chunk_matrix(data.shards["fixed"], GS_CHUNK)
    build_s = time.perf_counter() - t0
    pair = dataclasses.replace(cfg_f, tolerance=RE_CHECK_TOL)
    logistic = TaskType.LOGISTIC_REGRESSION
    m_r, r_r = train_glm(make_batch(data.shards["fixed"], data.y,
                                    device=dev), logistic, pair, device=dev)
    m_s, r_s = train_glm(make_chunked_batch(chunked, data.y), logistic, pair,
                         device=dev)
    w5_s = m_s.coefficients.means.cpu().numpy()
    w5_r = m_r.coefficients.means.cpu().numpy()
    if r_s.iterations != r_r.iterations:
        raise AssertionError(f"GS: streamed fixed solve {r_s.iterations} "
                             f"iterations, resident {r_r.iterations}")
    np.testing.assert_allclose(w5_s, w5_r, rtol=2e-3, atol=2e-5,
                               err_msg="GS streamed vs resident fixed solve")
    del m_r
    # the resident shard and its coordinate leave the caches; the random
    # effects' datasets and coordinates stay
    dcache, ccache = est._caches_for(data)
    key = est._dataset_key(est.coordinate_configs["fixed"])
    dcache.pop(key)
    for k in [k for k in ccache if k[0] == key]:
        ccache.pop(k)
    data.shards["fixed"] = chunked
    torch.cuda.empty_cache()
    telemetry.reset()
    K.reset_launch_counts()
    cold, cold_s = fit_timed(est, data)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    warm_s_fit, warm_s = fit_timed(est, data)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    launches = K.launch_counts()
    counters = telemetry.snapshot()["counters"]
    e2e = {k: v for k, v in counters.items() if k.startswith("game_e2e.")}
    if not e2e.get("game_e2e.host_offset_sums"):
        raise AssertionError(f"GS: no host offset sums ({e2e})")
    hist = np.asarray(warm_s_fit.descent.objective_history)
    want = np.asarray(warm.descent.objective_history)
    gap = histories_agree("GS streamed vs resident objective", want, hist)
    w_s = warm_s_fit.model.coordinates["fixed"].model.weights.cpu().numpy()
    w_r = warm.model.coordinates["fixed"].model.weights.cpu().numpy()
    off = np.abs(w_s - w_r) > 2e-5 + 2e-3 * np.abs(w_r)
    its_r = [int(r.iterations) for r in warm.descent.coordinate_stats["fixed"]]
    t0 = time.perf_counter()
    scores = score_game(warm_s_fit.model, data).cpu().numpy()
    score_s = time.perf_counter() - t0
    s_auc = auc(scores, data.y)
    if abs(s_auc - game_auc) > 1e-4:
        raise AssertionError(f"GS: AUC {s_auc} against GM's {game_auc}")
    its = [int(r.iterations)
           for r in warm_s_fit.descent.coordinate_stats["fixed"]]
    with CoordinateTimer() as timer:
        fit_timed(est, data)
    log(f"GS: the fixed shard as {chunked.n_chunks} host chunks of "
        f"{GS_CHUNK} rows, bf16 ({chunked.nbytes() / 1e9:.3f} GB pinned, "
        f"chunked in {build_s:.2f} s); cold fit {cold_s:.3f} s, warm refit "
        f"{warm_s:.3f} s: {n * sweeps / warm_s:.6g} row-sweeps/s; peak "
        f"device memory over the warm refit {peak_gb:.3f} GB "
        f"({base / 1e9:.3f} GB held before it); fixed-effect iterations "
        f"{its} (GM's {its_r}); fixed coefficients max |dw| "
        f"{np.abs(w_s - w_r).max():.3g} from GM's, {int(off.sum())} of "
        f"{w_s.size} outside rtol 2e-3 / atol 2e-5; the fixed shard alone "
        f"stopped at a relative progress of {RE_CHECK_TOL:g}, streamed vs "
        f"resident: {r_s.iterations} iterations each, max |dw| "
        f"{np.abs(w5_s - w5_r).max():.3g} (within rtol 2e-3 / atol 2e-5); "
        f"objective max rel gap to GM's resident fit {gap:.3g}; "
        f"AUC {s_auc:.6f} vs {game_auc:.6f}; scoring {score_s:.3f} s; "
        f"kernel launches {launches or 'none'}; counters over both fits "
        f"{e2e}  [{gpu}]")
    log("GS: seconds per coordinate update (sweep by sweep): "
        + "; ".join(f"{shard} " + ", ".join(f"{v:.3f}" for v in secs)
                    for shard, secs in timer.secs.items()) + f"  [{gpu}]")
    return launches


def phase_gk_ladder(args, dev, gpu) -> dict:
    """GS, GK (a)'s sparse fixed shard as a bf16 host ladder (chunks of
    GK_S_CHUNK rows), one sweep through the blocked-ELL kernels against
    scope("off"); returns the kernels' launches in the default-route
    fit."""
    import torch

    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.data.dataset import chunk_blocked_ell, make_batch
    from photon_tpu_torch.data.matrix import SparseRows
    from photon_tpu_torch.game.dataset import GameData
    from photon_tpu_torch.kernels import blocked_ell as KB
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l2

    rows = GK_ROWS
    t0 = time.perf_counter()
    ind, va, re, uid, iid, y = gk_data(args.seed + 5, rows)
    cb = chunk_blocked_ell(make_batch(SparseRows(ind, va, T_FEATURES), y,
                                      device="cpu"),
                           GK_S_CHUNK, T_DENSE, feature_dtype=torch.bfloat16)
    del ind, va
    log(f"GS: GK's rows as a ladder of {cb.n_chunks} chunks of {GK_S_CHUNK} "
        f"rows in {time.perf_counter() - t0:.1f} s")
    data = GameData.build(y, shards={"fixed": cb.X,
                                     "u": SparseRows(*re["u"], D_RE),
                                     "i": SparseRows(*re["i"], D_RE)},
                          entity_ids={"user": uid, "item": iid})
    re_cfg = OptimizerConfig(max_iters=GM_RE[0], tolerance=RE_CHECK_TOL,
                             reg=l2(), reg_weight=GM_RE[1])
    cfg_f = OptimizerConfig(max_iters=T_SHORT, tolerance=0.0, reg=l2(),
                            reg_weight=GM_FIXED[1], history=T_HISTORY)
    est = game_estimator(dev, cfg_f, re_cfg, 1, shards=("fixed", "u", "i"))
    K.reset_launch_counts()
    got, wall = fit_timed(est, data)
    launches = K.launch_counts()
    for name in (KB.TAIL, KB.RMATVEC):
        if launches.get(name, 0) == 0:
            raise AssertionError(f"GS ladder: {name} never launched "
                                 f"({launches})")
    est_off = game_estimator(dev, cfg_f, re_cfg, 1,
                             shards=("fixed", "u", "i"))
    with K.scope("off"):
        want, off_wall = fit_timed(est_off, data)
    gap, apart = fits_agree("GS ladder", want, got, strict=False)
    log(f"GS: GK (a)'s fixed shard as a host ladder, one sweep in "
        f"{wall:.3f} s on the kernels, {off_wall:.3f} s on the plain "
        f"versions; launches {launches}; objective history "
        + ", ".join(f"{v:.8g}" for v in got.descent.objective_history)
        + f"; max rel gap to scope('off') {gap:.3g}; the fixed effect "
        f"within rtol 1e-5 of its largest; random effects (entities apart, "
        f"of them at another iteration, largest gap) {apart}  [{gpu}]")
    del data, est, est_off, got, want, cb
    torch.cuda.empty_cache()
    return launches


def phase_game_kernels(args, dev, gpu) -> dict:
    """GK: GAME through the kernels — (a) a BlockedEllRows fixed shard
    at T2's width (L-BFGS, SIMPLE variances), (b) a dense fixed shard at
    D2's shape (OWL-QN, L1 1e4), both with T2's per-entity shards, each
    fit held against scope("off"); returns the kernels' launches in the
    default-route fits. (a)'s random-effect tables must agree entity by
    entity. (b)'s fixed effect parts from scope("off") by a rounding (the
    fused kernel sums in its own order), so its random effects see
    offsets a rounding apart, and an entity whose line search or stop
    decides on that rounding parts: those are counted with their largest
    gap, and both fits' random effects re-solved from the same offsets
    must agree bit for bit."""
    import shutil
    import tempfile

    import torch

    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.data.matrix import SparseRows, to_blocked_ell
    from photon_tpu_torch.game.dataset import GameData
    from photon_tpu_torch.kernels import blocked_ell as KB
    from photon_tpu_torch.kernels import fused as KF
    from photon_tpu_torch.models.variance import VarianceComputationType
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l1, l2

    rows = GK_ROWS
    t0 = time.perf_counter()
    ind, va, re, uid, iid, y = gk_data(args.seed + 5, rows)
    X = to_blocked_ell(SparseRows(ind, va, T_FEATURES), T_DENSE,
                       device_dense_dtype=torch.bfloat16,
                       device=dev).astype(torch.bfloat16)
    shards = {"u": SparseRows(*re["u"], D_RE), "i": SparseRows(*re["i"],
                                                                D_RE)}
    ids = {"user": uid, "item": iid}
    torch.cuda.synchronize()
    log(f"GK: data and layout in {time.perf_counter() - t0:.1f} s: {rows} "
        f"rows, fixed shard BlockedEllRows over {T_FEATURES} features "
        f"({T_DENSE}-column bf16 hot block, {X.n_prefix - X.d_sel} tail "
        f"columns), per-user and per-item shards d {D_RE}, {K_RE} slots")
    re_cfg = OptimizerConfig(max_iters=GM_RE[0], tolerance=RE_CHECK_TOL,
                             reg=l2(), reg_weight=GM_RE[1])
    launches = {}
    cases = (
        ("(a) blocked-ELL L-BFGS, SIMPLE variances", X,
         OptimizerConfig(max_iters=T_SHORT, tolerance=0.0, reg=l2(),
                         reg_weight=GM_FIXED[1], history=T_HISTORY),
         VarianceComputationType.SIMPLE,
         (KB.TAIL, KB.RMATVEC), True),
        ("(b) dense OWL-QN, L1 1e4", None,
         OptimizerConfig(max_iters=D_SHORT, tolerance=0.0, reg=l1(),
                         reg_weight=D_L1, history=D_HISTORY),
         VarianceComputationType.NONE, (KF.KERNEL,), False))
    # GMM (d): (a)'s configuration cut in depth, fitted by 2 processes
    # beside (a) and (b) here
    here = os.path.dirname(os.path.abspath(__file__))
    ckdir = tempfile.mkdtemp(prefix="_drv_gmm", dir=here)
    gmm_cfgs = game_estimator(dev, cases[0][2], re_cfg, 1, shards=(
        "fixed", "u", "i")).coordinate_configs
    started = gmm_processes_start(args.seed + 5 + GMM_SEED, gmm_cfgs,
                                  cases[0][3], ckdir)
    for label, Xfix, cfg_f, var, names, strict in cases:
        if Xfix is None:
            Xd, yd = dense_problem(args.seed)
            Xfix = torch.from_numpy(Xd).to(dev)
            y_case = yd[:rows]
            del Xd
        else:
            y_case = y
        data = GameData.build(y_case, shards={"fixed": Xfix, **shards},
                              entity_ids=ids)
        est = game_estimator(dev, cfg_f, re_cfg, 1, variance=var,
                             shards=("fixed", "u", "i"))
        K.reset_launch_counts()
        got, wall = fit_timed(est, data)
        counts = K.launch_counts()
        for name in names:
            if counts.get(name, 0) == 0:
                raise AssertionError(f"GK {label}: {name} never launched "
                                     f"inside the descent ({counts})")
        est_off = game_estimator(dev, cfg_f, re_cfg, 1, variance=var,
                                 shards=("fixed", "u", "i"))
        K.reset_launch_counts()
        with K.scope("off"):
            want, off_wall = fit_timed(est_off, data)
            off_counts = K.launch_counts()
        if off_counts:
            raise AssertionError(f"GK {label}: scope off launched "
                                 f"{off_counts}")
        gap, apart = fits_agree(f"GK {label}", want, got, strict)
        resolve_agree(f"GK {label}", est_off, data, want, dev)
        if strict:
            entity_pass_costs(est, data, gpu)
            lap("GK (a)")
            gmm_kernels(ind, va, y, shards, ids, cfg_f, re_cfg, var, got,
                        data, dev, gpu)
            del ind, va
            lap("GMM (b)")
        for name, c in counts.items():
            launches[name] = launches.get(name, 0) + c
        log(f"GK {label}: one sweep in {wall:.3f} s on the default route, "
            f"{off_wall:.3f} s on the plain versions; kernel launches "
            f"inside the descent {counts}; objective history "
            + ", ".join(f"{v:.8g}" for v in got.descent.objective_history)
            + f"; max rel gap to scope('off') {gap:.3g}; the fixed "
            f"effect's coefficients and variances within rtol 1e-5 of "
            f"their largest, and each random effect's"
            + (" too" if strict else
               " but for (entities apart, of them stopped at another "
               f"iteration, largest gap) {apart}")
            + "; each random effect re-solved from scope('off')'s offsets "
            "on both routes: its tables bit for bit  [" + gpu + "]")
        del data, est, est_off, got, want, Xfix
        torch.cuda.empty_cache()
    del X
    torch.cuda.empty_cache()
    lap("GK (b)")
    try:
        gmm_processes_finish(started, gmm_cfgs, cases[0][3], ckdir, gpu)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    lap("GMM (d)")
    return launches


# ---------------------------------------- phase GMM: GAME on the mesh
def gmm_count(launches: dict) -> None:
    for name, c in launches.items():
        GMM_LAUNCHES[name] = GMM_LAUNCHES.get(name, 0) + c


def gmm_mesh():
    """The in-process MG_SLOTS-slot mesh on the visible cards."""
    from photon_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n_devices=MG_SLOTS)


def gmm_data(seed: int, rows: int, dev, model_seed=None):
    """GM's rows (`game_10m_data`) as a GameData: the fixed shard bf16 on
    the card, the per-entity shards host numpy."""
    import torch

    from photon_tpu_torch.game.dataset import GameData

    Xf, Xu, Xi, uid, iid, y = game_10m_data(seed, rows, model_seed)
    return GameData.build(y, shards={
        "fixed": torch.from_numpy(Xf).to(dev).to(torch.bfloat16),
        "u_re": Xu, "i_re": Xi}, entity_ids={"user": uid, "item": iid})


def model_auc(model, data) -> float:
    """A GAME model's AUC on ``data`` (numpy f64 rank sum of its scores)."""
    from photon_tpu_torch.game.scoring import score_game

    y = data.y.cpu().numpy() if hasattr(data.y, "cpu") else data.y
    return auc(score_game(model, data).cpu().numpy().astype(np.float64),
               np.asarray(y))


def entities_off(want, got) -> dict:
    """{random effect: (entities of two GameModels with a coefficient
    apart beyond rtol 1e-5 and 1e-5 of the table's largest, of them,
    largest gap)}."""
    out = {}
    for name, wm in want.coordinates.items():
        if hasattr(wm, "model"):
            continue
        a = wm.coefficients.cpu().numpy()
        b = got.coordinates[name].coefficients.cpu().numpy()
        off = (np.abs(b - a) > 1e-5 * float(np.abs(a).max())
               + 1e-5 * np.abs(a)).any(axis=1)
        out[name] = (int(off.sum()), int(a.shape[0]),
                     float(np.abs(b - a).max()))
    return out


def gmm_agree(label: str, want, got, auc_want: float, auc_got: float,
              nudged=None) -> str:
    """Hold a mesh fit's GameModel ``got`` against the one-device
    ``want`` at GMM's bounds — the fixed effect within GMM_FIXED_ATOL, the
    AUC within GMM_AUC_GAP and, given ``nudged`` (``want``'s fit again
    with the row weights one ulp above 1; fits stopped at RE_CHECK_TOL),
    §C8's bound as GG holds it: at most GMM_ENTITY_SHARE of each random
    effect's entities apart (`entities_off`), or twice as many as the
    nudge moves apart in the one-device fit itself, and none of them
    further apart than GMM_GAP_FACTOR times the nudge's largest gap —
    and return the figures as text."""
    parts = []
    for name, wm in want.coordinates.items():
        if not hasattr(wm, "model"):
            continue
        a = wm.model.weights.float().cpu().numpy()
        b = got.coordinates[name].model.weights.float().cpu().numpy()
        gap = float(np.abs(a - b).max())
        parts.append(f"{name} max |dw| {gap:.3g}")
        if gap > GMM_FIXED_ATOL:
            raise AssertionError(f"{label}: {name} {gap} apart (atol "
                                 f"{GMM_FIXED_ATOL})")
    spread = None if nudged is None else entities_off(want, nudged)
    for name, (k, E, worst) in entities_off(want, got).items():
        text = (f"{name} {k} of {E} entities beyond rtol 1e-5 ({k / E:.3%};"
                f" largest gap {worst:.3g})")
        if spread is not None:
            k_sp, _, big_sp = spread[name]
            text += f" [one-ulp nudge on one device: {k_sp}, {big_sp:.3g}]"
            held_entities(label, name, k, E, worst, k_sp, big_sp)
        parts.append(text)
    d_auc = abs(auc_got - auc_want)
    parts.append(f"AUC {auc_got:.8g} against {auc_want:.8g} ({d_auc:.3g})")
    if d_auc > GMM_AUC_GAP:
        raise AssertionError(f"{label}: AUC {d_auc} apart")
    return "; ".join(parts)


def held_entities(label: str, name: str, k: int, E: int, worst: float,
                  k_sp: int, big_sp: float) -> None:
    """GMM's entity bound: ``k`` of ``E`` entities apart (largest gap
    ``worst``) against a one-ulp nudge's ``k_sp`` (largest ``big_sp``) —
    at most GMM_ENTITY_SHARE of them or twice the nudge's count, and, when
    any is apart, none beyond GMM_GAP_FACTOR times the nudge's gap (a
    wrong lane parts by far more than rounding moves one)."""
    if k > max(GMM_ENTITY_SHARE * E, 2 * k_sp):
        raise AssertionError(
            f"{label}: {name}: {k} of {E} entities apart, over "
            f"{GMM_ENTITY_SHARE:.1%} and twice the one-ulp spread {k_sp}")
    if k and worst > GMM_GAP_FACTOR * big_sp:
        raise AssertionError(
            f"{label}: {name}: an entity {worst:.3g} apart, over "
            f"{GMM_GAP_FACTOR:g} times the one-ulp nudge's largest gap "
            f"{big_sp:.3g}")


def nudged_weights(data):
    """``data`` with every row weight one ulp above its own."""
    w = data.weights
    if hasattr(w, "cpu"):
        w = w.cpu().numpy()
    return dataclasses.replace(data, weights=np.nextafter(
        np.asarray(w, np.float32), np.float32(2.0)))


def gmm_game(est, data, warm, warm_counters: dict, val, dev, gpu) -> None:
    """GMM (a): GM at full width on the MG_SLOTS-slot mesh — GM's
    estimator and data with ``mesh=``: the datasets sharded (the fixed
    shard row-sharded, every bucket's lanes split over the slots at
    dispatch), a cold fit and a warm refit, peak memory, lock-step solves
    a sweep against GM's, a profiled warm sweep; held against GM's warm
    fit."""
    import torch

    from photon_tpu_torch import kernels as K
    from photon_tpu_torch import telemetry

    mesh = gmm_mesh()
    est_m = dataclasses.replace(est, mesh=mesh)
    dcache, _ = est_m._caches_for(data)
    gm_cache, _ = est._caches_for(data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for cfg in est_m.coordinate_configs.values():
        key = est_m._dataset_key(cfg)
        # GM's bucketed random-effect datasets serve the mesh as they
        # are (the mesh's home is GM's card); the fixed shard shards
        dcache[key] = (gm_cache[key] if key[0] == "random"
                       else est_m._build_dataset(data, cfg))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launch_counts()
    cold, cold_s = fit_timed(est_m, data)
    telemetry.reset()
    warm_m, warm_s = fit_timed(est_m, data)
    c = telemetry.snapshot()["counters"]
    launches = K.launch_counts()
    gmm_count(launches)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    sweeps, n = est.n_sweeps, data.n
    np.testing.assert_allclose(cold.descent.objective_history,
                               warm_m.descent.objective_history, rtol=1e-5,
                               err_msg="GMM (a) cold vs warm fit")
    lock_m = c.get("game_re.lockstep_solves", 0) / sweeps
    lock_1 = warm_counters.get("game_re.lockstep_solves", 0) / sweeps
    if not 0 < lock_m <= MG_SLOTS * lock_1:
        raise AssertionError(f"GMM (a): {lock_m} lock-step solves a sweep "
                             f"against {lock_1} on one device")
    held = gmm_agree("GMM (a)", warm.model, warm_m.model,
                     model_auc(warm.model, val), model_auc(warm_m.model, val))
    log(f"GMM (a): GM on a {MG_SLOTS}-slot mesh (slots on "
        f"{sorted({str(d) for d in mesh.slot_devices})}): the fixed shard "
        f"sharded in {build_s:.2f} s (GM's buckets reused); cold fit "
        f"{cold_s:.3f} s, warm refit {warm_s:.3f} s: "
        f"{n * sweeps / warm_s:.6g} row-sweeps/s; peak "
        f"device memory {peak_gb:.3f} GB ({base / 1e9:.3f} GB held before "
        f"the fits); random-effect lock-step solves a sweep {lock_m:g} "
        f"against {lock_1:g} on one device; mesh reductions "
        f"{int(c.get('mesh.reductions', 0))}, slot solves "
        f"{int(c.get('game_re.slot_solves', 0))}; kernel launches "
        f"{launches or 'none'}  [{gpu}]")
    log("GMM (a): objective history "
        + ", ".join(f"{v:.8g}" for v in warm_m.descent.objective_history)
        + "; against GM's warm fit (" + ", ".join(
            f"{v:.8g}" for v in warm.descent.objective_history) + ")")
    est1 = dataclasses.replace(est_m, n_sweeps=1)
    est1._caches = est_m._caches
    busy, wall, n_ops, top = profiled_busy(lambda: est1.fit(data))
    log("GMM (a): profiled warm sweep: device busy "
        + ("not measured" if busy is None else
           f"{busy:.3f} s of {wall:.3f} s wall ({busy / wall:.3f} busy, "
           f"{1 - busy / wall:.3f} idle)")
        + f", {n_ops} device ops; most device time (ms, launches): "
        + "; ".join(f"{name[:60]} {us / 1e3:.3f}, {k}"
                    for name, us, k in top) + f"  [{gpu}]")
    log(f"GMM (a): against GM's one-device warm fit (every solve to the f32 "
        f"floor: entities reported, §C16), on {GMM_VAL_ROWS} held-out "
        f"rows: {held}  [{gpu}]")
    # the entity bound, on fits stopped at RE_CHECK_TOL on both sides (the
    # datasets of each side shared), beside the one-device fit's own
    # spread under a one-ulp nudge of the row weights (§C8)
    cfgs = {name: dataclasses.replace(c, optimizer=dataclasses.replace(
        c.optimizer, tolerance=RE_CHECK_TOL))
        for name, c in est.coordinate_configs.items()}
    fits = []
    for e, d in ((est, data), (est_m, data), (est, nudged_weights(data))):
        ec = dataclasses.replace(e, coordinate_configs=cfgs)
        ec._caches = e._caches
        fits.append(fit_timed(ec, d))
        del ec
    held = gmm_agree("GMM (a) at the check tolerance", fits[0][0].model,
                     fits[1][0].model, model_auc(fits[0][0].model, val),
                     model_auc(fits[1][0].model, val), fits[2][0].model)
    log(f"GMM (a): every solve stopped at a relative progress of "
        f"{RE_CHECK_TOL:g}: one device {fits[0][1]:.3f} s, the mesh "
        f"{fits[1][1]:.3f} s; held at GMM's bounds: {held}  [{gpu}]")
    del est_m, est1, cold, warm_m, fits
    torch.cuda.empty_cache()


def gmm_grid(est_gm, data, val, dev, gpu) -> None:
    """GMM (f): GG's 4-lane grid (GM's model, per-user L2 GG_USER_L2, no
    warm starts; every solve stopped at a relative progress of
    RE_CHECK_TOL) on GM's first GMM_F_ROWS rows, on one device and on the
    mesh (`fit_game_grid(mesh=)` through the estimator), each lane held
    at GMM's bounds on the held-out rows."""
    import torch

    from photon_tpu_torch.evaluation.evaluator import (Evaluator,
                                                       EvaluatorType)
    from photon_tpu_torch.game.dataset import GameData

    r = GMM_F_ROWS
    cut = GameData.build(
        data.y[:r], shards={k: X[:r] for k, X in data.shards.items()},
        entity_ids={k: v[:r] for k, v in data.entity_ids.items()})
    base = {name: dataclasses.replace(c, optimizer=dataclasses.replace(
        c.optimizer, tolerance=RE_CHECK_TOL))
        for name, c in est_gm.coordinate_configs.items()}
    grid = [{"per_user": dataclasses.replace(
        base["per_user"], optimizer=dataclasses.replace(
            base["per_user"].optimizer, reg_weight=w))} for w in GG_USER_L2]
    fits, secs = {}, {}
    shared: dict = {}
    for label, mesh, d in (("one device", None, cut),
                           ("mesh", gmm_mesh(), cut),
                           ("nudged", None, nudged_weights(cut))):
        est = dataclasses.replace(est_gm, warm_start=False, mesh=mesh,
                                  coordinate_configs=base,
                                  evaluator=Evaluator(EvaluatorType.AUC))
        if not est.would_vectorize(grid, data=d):
            raise AssertionError("GMM (f): the grid must take the lane-axis "
                                 "path")
        if d is cut:  # the one-device buckets serve the mesh too
            cache, _ = est._caches_for(cut)
            cache.update({k: v for k, v in shared.items()
                          if k[0] == "random"})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fits[label] = est.fit(d, validation=val, config_grid=grid)
        torch.cuda.synchronize()
        secs[label] = time.perf_counter() - t0
        if d is cut:
            shared.update(est._caches_for(cut)[0])
        del est
    for g, (one, m, nu) in enumerate(zip(fits["one device"], fits["mesh"],
                                         fits["nudged"])):
        held = gmm_agree(f"GMM (f) lane {g}", one.model, m.model,
                         one.validation_score, m.validation_score, nu.model)
        log(f"GMM (f): lane {g} (user L2 {GG_USER_L2[g]:g}): {held}")
    log(f"GMM (f): GG's {len(grid)}-lane grid on {r} rows (cut from "
        f"{data.n}): one device {secs['one device']:.3f} s (bucketing "
        f"included), the {MG_SLOTS}-slot mesh {secs['mesh']:.3f} s (the "
        f"fixed shard's sharding included, the buckets shared); every "
        f"lane held at GMM's bounds  [{gpu}]")
    del fits, cut, shared
    torch.cuda.empty_cache()


def gmm_kernels(ind, va, y, shards, ids, cfg_f, re_cfg, var, want, data_a,
                dev, gpu) -> None:
    """GMM (b): GK (a) on the mesh — T2's sparse fixed shard laid for the
    slots (`shard_blocked_ell_batch`, every value leaf bf16 as GK's), rows
    2 and 4 on every slot's shard held against their plain versions, then
    the one-sweep fit through them (launches counted), held at GMM's
    bounds against GK (a)'s one-device fit (training rows' AUC)."""
    import torch

    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.data.dataset import (cast_features, make_batch,
                                               shard_blocked_ell_batch)
    from photon_tpu_torch.data.matrix import SparseRows
    from photon_tpu_torch.game.dataset import GameData
    from photon_tpu_torch.kernels import blocked_ell as KB

    mesh = gmm_mesh()
    t0 = time.perf_counter()
    sb = cast_features(shard_blocked_ell_batch(make_batch(
        SparseRows(ind, va, T_FEATURES), y, device="cpu"), MG_SLOTS,
        T_DENSE))
    build_s = time.perf_counter() - t0
    data_m = GameData.build(y, shards={"fixed": sb.X, **shards},
                            entity_ids=ids)
    est = game_estimator(dev, cfg_f, re_cfg, 1, variance=var,
                         shards=("fixed", "u", "i"))
    est.mesh = mesh
    dcache, _ = est._caches_for(data_m)
    fixed_cfg = est.coordinate_configs["fixed"]
    ds = est._build_dataset(data_m, fixed_cfg)
    dcache[est._dataset_key(fixed_cfg)] = ds
    gen = torch.Generator(device=dev).manual_seed(13)
    mesh_kernels_agree(ds.X, gen, "GMM (b) fixed shard", gpu)
    K.reset_launch_counts()
    got, wall = fit_timed(est, data_m)
    counts = K.launch_counts()
    for name in (KB.TAIL, KB.RMATVEC):
        if counts.get(name, 0) == 0:
            raise AssertionError(f"GMM (b): {name} never launched inside "
                                 f"the mesh fit ({counts})")
    gmm_count(counts)
    est_n = game_estimator(dev, cfg_f, re_cfg, 1, variance=var,
                           shards=("fixed", "u", "i"))
    nudged, _ = fit_timed(est_n, nudged_weights(data_a))
    held = gmm_agree("GMM (b)", want.model, got.model,
                     model_auc(want.model, data_a.to_device(dev)),
                     model_auc(got.model, data_m.to_device(dev)),
                     nudged.model)
    log(f"GMM (b): GK (a) on the {MG_SLOTS}-slot mesh: the fixed shard "
        f"laid for the slots in {build_s:.1f} s; one sweep in {wall:.3f} "
        f"s; kernel launches inside the descent {counts}; held against "
        f"GK (a)'s one-device fit on its training rows: {held}  [{gpu}]")
    del est, est_n, got, nudged, data_m, sb, ds
    torch.cuda.empty_cache()


def gmm_processes_start(seed: int, cfgs: dict, var, ckdir: str) -> tuple:
    """GMM (d), started beside (b): (b)'s problem cut to GMM_D_ROWS rows
    and one sweep (its fixed shard laid for MG_SLOTS slots, bf16) fitted
    by 2 gloo processes sharing the card (`parallel.launch`,
    `selfcheck.target_game_data`), then again under a checkpoint session
    killed at the 2nd ``bucket_retire`` on both ranks, the two clusters
    side by side. Returns (their threads, their results, the data)."""
    import threading

    from photon_tpu_torch.data.dataset import (cast_features, make_batch,
                                               shard_blocked_ell_batch)
    from photon_tpu_torch.data.matrix import SparseRows
    from photon_tpu_torch.game.dataset import GameData
    from photon_tpu_torch.parallel import selfcheck as sc
    from photon_tpu_torch.parallel.launch import launch

    ind, va, re, uid, iid, y = gk_data(seed, GMM_D_ROWS)
    sb = cast_features(shard_blocked_ell_batch(make_batch(
        SparseRows(ind, va, T_FEATURES), y, device="cpu"), MG_SLOTS,
        T_DENSE))
    data = GameData.build(y, shards={
        "fixed": sb.X, "u": SparseRows(*re["u"], D_RE),
        "i": SparseRows(*re["i"], D_RE)}, entity_ids={"user": uid,
                                                      "item": iid})
    runs: dict = {}

    def go(key, ck, kill):
        t0 = time.perf_counter()
        try:
            runs[key] = (launch(sc.target_game_data, 2, args=(
                data, cfgs, 1, var, ck, kill), device="cuda",
                backend="gloo", timeout_s=GMM_D_TIMEOUT_S),
                         time.perf_counter() - t0)
        except Exception as e:  # raised in the main thread
            runs[key] = (e, time.perf_counter() - t0)

    # the two clusters side by side
    threads = [threading.Thread(target=go, args=a, daemon=True)
               for a in (("fit", None, 0), ("kill", ckdir, 2))]
    for t in threads:
        t.start()
    return threads, runs, data


def gmm_processes_finish(started: tuple, cfgs: dict, var, ckdir: str, gpu
                         ) -> None:
    """GMM (d), held: the 2 processes' digest (every coordinate's table)
    equal to the in-process mesh's bit for bit, both ranks killed at the
    2nd ``bucket_retire``, and that snapshot resumed in THIS process
    (one process, the same 8 slots) to the same digest."""
    from photon_tpu_torch.kernels import blocked_ell as KB
    from photon_tpu_torch.parallel import selfcheck as sc

    threads, runs, data = started
    mesh = gmm_mesh()
    t0 = time.perf_counter()
    want = sc.fit_game(mesh, data, cfgs, 1, var)
    one_s = time.perf_counter() - t0
    for t in threads:
        t.join()
    for key, (got, _) in runs.items():
        if isinstance(got, Exception):
            raise AssertionError(f"GMM (d) {key}: {got}")
    fit, fit_s = runs["fit"]
    if [r["digest"] for r in fit] != [want["digest"]] * 2:
        raise AssertionError(f"GMM (d): digests {[r['digest'] for r in fit]}"
                             f" against the in-process {want['digest']}")
    kill, kill_s = runs["kill"]
    if not all(r["killed"] for r in kill):
        raise AssertionError("GMM (d): the kill at bucket_retire#2 did not "
                             "fire on every rank")
    t0 = time.perf_counter()
    resumed = sc.fit_game(mesh, data, cfgs, 1, var, ckdir)
    resume_s = time.perf_counter() - t0
    if resumed["digest"] != want["digest"] or resumed["restores"] < 1:
        raise AssertionError(f"GMM (d): resumed at 1 process to "
                             f"{resumed['digest']} ({resumed['restores']} "
                             f"restores), not {want['digest']}")
    counts: dict = {}
    for r in fit:
        for name, c in r["launches"].items():
            counts[name] = counts.get(name, 0) + c
    for name in (KB.TAIL, KB.RMATVEC):
        if counts.get(name, 0) == 0:
            raise AssertionError(f"GMM (d): {name} never launched in the "
                                 f"2 processes ({counts})")
    gmm_count(counts)
    log(f"GMM (d): GMM (b)'s problem at {GMM_D_ROWS} rows, one sweep: 2 "
        f"gloo processes sharing the card ({fit_s:.1f} s with their start)"
        f" give digest {fit[0]['digest']}, the in-process {MG_SLOTS}-slot "
        f"mesh's ({one_s:.1f} s) bit for bit, with "
        f"{[r['collectives'] for r in fit]} collectives a rank; killed at "
        f"bucket_retire#2 on both ranks ({kill_s:.1f} s) and resumed in one"
        f" process ({resume_s:.1f} s, {resumed['restores']} restores): the "
        f"same digest; kernel launches in the 2 processes {counts}  [{gpu}]")


def gmm_refresh(prev, drop, plan, configs, res, one_s: float, dev, gpu):
    """GMM (c): CR's refresh of its first drop on the mesh (the touched
    lanes padded to a slot multiple, solved slot by slot), held against
    CR (b)'s one-device refresh at GMM's entity bound; returns the
    RefreshResult, whose generation CR (d) hot-swaps into the live int8
    ladder."""
    import torch

    from photon_tpu_torch import continual as CT
    from photon_tpu_torch import telemetry

    mesh = gmm_mesh()
    telemetry.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_m = CT.refresh_game_model(prev, drop, plan, configs, mesh=mesh)
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    c = telemetry.snapshot()["counters"]
    nudged = CT.refresh_game_model(prev, nudged_weights(drop), plan, configs)
    spread = entities_off(res.model, nudged.model)
    parts = []
    for name, (k, E, worst) in entities_off(res.model, res_m.model).items():
        st = res_m.stats[name]
        k_sp, _, big_sp = spread[name]
        held_entities("GMM (c)", name, k, st.n_touched, worst, k_sp,
                      big_sp)
        if st.n_touched != res.stats[name].n_touched:
            raise AssertionError(f"GMM (c): {name} touched {st.n_touched}")
        parts.append(f"{name} {st.n_touched} touched, {k} beyond rtol 1e-5"
                     f" of CR (b)'s (largest gap {worst:.3g}; a one-ulp "
                     f"nudge of the drop's weights on one device: {k_sp}, "
                     f"{big_sp:.3g}), {st.n_failed} failed")
    log(f"GMM (c): refresh_game_model on the {MG_SLOTS}-slot mesh "
        f"{mesh_s:.3f} s against {one_s:.3f} s on one device; "
        + "; ".join(parts)
        + f"; slot solves {int(c.get('game_re.slot_solves', 0))}, lock-step"
        f" solves {int(c.get('game_re.lockstep_solves', 0))}; CR (d) "
        f"swaps this generation in  [{gpu}]")
    return res_m


def gmm_driver(params_a: dict, root: str, write_s: float, dev,
               gpu) -> None:
    """GMM (e): DRV (a)'s Avro and parameters with every solve stopped at
    RE_CHECK_TOL (the best model only) through `run_training(mesh=)`, held
    at GMM's bounds against the same run on one device; a third run on
    one device reads DRV (a)'s training rows again from
    ``train_nudged.avro`` (`drv_files`, written in ``write_s``), whose row
    weights sit one ulp above 1, the one-device run's own spread for the
    entity bound."""
    import torch

    from photon_tpu_torch import drivers as D
    from photon_tpu_torch import kernels as K

    nudged_path = os.path.join(root, "train_nudged.avro")
    coords = {n: {**c, "tolerance": RE_CHECK_TOL}
              for n, c in params_a["coordinates"].items()}

    def run(tag, mesh=None, **kw):
        params = D.TrainingParams(**{
            **params_a, "coordinates": coords, "output_mode": "BEST",
            "output_dir": os.path.join(root, f"train_{tag}"), **kw})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = (D.run_training(params, mesh=mesh) if mesh is not None
               else D.run_training(params, device=dev))
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    one, one_s = run("check")
    K.reset_launch_counts()
    out_m, mesh_s = run("mesh", gmm_mesh())
    gmm_count(K.launch_counts())
    nudged, _ = run("nudged", train_path=nudged_path)

    def weights(r):
        return {n: c.optimizer.reg_weight for n, c in r.configs.items()}

    if weights(out_m.best) != weights(one.best):
        raise AssertionError(f"GMM (e): best point {weights(out_m.best)} "
                             f"against {weights(one.best)}")
    (twin,) = [r for r in nudged.results if weights(r) == weights(one.best)]
    held = gmm_agree("GMM (e)", one.best.model, out_m.best.model,
                     one.best.validation_score, out_m.best.validation_score,
                     twin.model)
    log(f"GMM (e): DRV (a)'s run_training with every solve stopped at a "
        f"relative progress of {RE_CHECK_TOL:g}: on the {MG_SLOTS}-slot mesh"
        f" {mesh_s:.3f} s, phases " + ", ".join(
            f"{k} {v:.3f}" for k, v in out_m.timings.items())
        + f" s; on one device {one_s:.3f} s; the nudged training Avro "
        f"written in {write_s:.1f} s (in MG's wait); the same best point; "
        f"held at GMM's "
        f"bounds: {held}  [{gpu}]")


# ------------------------------------------ phase DRV: the drivers on Avro
def encode_examples(y, ids, bags, weights=None) -> tuple:
    """TrainingExampleAvro record bytes of rows, vectorized (the scoring
    driver's block-encoder idiom): the response, a null offset, a null
    weight (or the rows' ``weights``), the string columns ``ids`` (uid then the entity ids, each the union's
    string branch) and the bags, each ``(names, X)``: one (name, "", x)
    NameTermValue per column of X. Returns (payload, record offsets)."""
    import io

    from photon_tpu_torch.data.avro_io import (_write_long, scatter_ragged,
                                               varint_bytes)

    n = int(y.shape[0])
    cols = []
    for col in ids:
        enc = np.char.encode(np.asarray(col, np.str_), "utf-8")
        bmat = np.frombuffer(enc.tobytes(), np.uint8).reshape(
            n, enc.dtype.itemsize)
        ln = np.char.str_len(enc).astype(np.int64)
        cols.append((bmat, ln) + varint_bytes(ln))
    tmpls = []
    for names, X in bags:
        t = io.BytesIO()
        _write_long(t, len(names))
        slots = []
        for name in names:
            raw = name.encode("utf-8")
            _write_long(t, len(raw))
            t.write(raw + b"\x00")  # the name, then the empty term
            slots.append(t.tell())
            t.write(bytes(8))
        t.write(b"\x00")
        tmpls.append((np.frombuffer(t.getvalue(), np.uint8),
                      np.asarray(slots), X))
    head = 10 if weights is None else 18
    rec_len = head + sum(1 + vl + ln for _, ln, _, vl in cols) \
        + sum(len(tm) for tm, _, _ in tmpls)
    off = np.concatenate([[0], np.cumsum(rec_len)[:-1]])
    buf = np.zeros(int(rec_len.sum()), np.uint8)
    b8 = np.arange(8)
    buf[off[:, None] + b8] = np.ascontiguousarray(
        y, "<f8").view(np.uint8).reshape(n, 8)
    # the offset union's null branch (0); the weight union's null branch
    # (0) or its double branch (2, zigzag) and the value
    if weights is not None:
        buf[off + 9] = 2
        buf[off[:, None] + 10 + b8] = np.ascontiguousarray(
            weights, "<f8").view(np.uint8).reshape(n, 8)
    pos = off + head
    for bmat, ln, vmat, vl in cols:
        buf[pos] = 2  # union branch 1, zigzag
        scatter_ragged(buf, pos + 1, vmat, vl)
        scatter_ragged(buf, pos + 1 + vl, bmat, ln)
        pos = pos + 1 + vl + ln
    for tm, slots, X in tmpls:
        buf[pos[:, None] + np.arange(len(tm))] = tm
        vb = np.ascontiguousarray(X, "<f8").view(np.uint8).reshape(
            n, len(slots), 8)
        buf[pos[:, None, None] + slots[None, :, None] + b8] = vb
        pos = pos + len(tm)
    return buf.tobytes(), off


def write_examples(path, schema, y, ids, bags, block: int = DRV_BLOCK,
                   weights=None):
    """Rows as a deflate Avro container through the port's
    `AvroBlockWriter`, ``block`` records a block, with the rows'
    ``weights`` when given; the first block's bytes are held against the
    port's record encoder (`write_datum`)."""
    import io

    from photon_tpu_torch.data.avro_io import (AvroBlockWriter,
                                               parse_schema, write_datum)

    parsed = parse_schema(schema)
    with AvroBlockWriter(path, schema, codec="deflate") as w:
        for lo in range(0, len(y), block):
            hi = min(lo + block, len(y))
            payload, _ = encode_examples(
                y[lo:hi], [c[lo:hi] for c in ids],
                [(names, X[lo:hi]) for names, X in bags],
                None if weights is None else weights[lo:hi])
            if lo == 0:
                ref = io.BytesIO()
                fields = [f["name"] for f in schema["fields"]]
                for i in range(hi):
                    rec = {"response": float(y[i]), "offset": None,
                           "weight": (None if weights is None
                                      else float(weights[i]))}
                    rec.update({f: str(c[i]) for f, c in
                                zip(fields[3:3 + len(ids)], ids)})
                    rec.update({f: [{"name": nm, "term": "",
                                     "value": float(X[i, j])}
                                    for j, nm in enumerate(names)]
                                for f, (names, X) in
                                zip(fields[3 + len(ids):], bags)})
                    write_datum(ref, parsed, rec)
                if ref.getvalue() != payload:
                    raise AssertionError("DRV: the vectorized Avro encoder "
                                         "differs from write_datum")
            w.write_block(hi - lo, payload)


def dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def later_setup(args) -> dict:
    """The later phases' host data, made while MG waits for PF (c)'s
    umbrella (set-up: nothing in it is timed as a metric): GM's rows with
    the seconds they took, DRV (a)'s and DRV-S's Avro files."""
    t0 = time.perf_counter()
    gm = game_10m_data(args.seed)
    return {"gm": (gm, time.perf_counter() - t0), "drv": drv_files(args),
            "drvs": drvs_files(args)}


def drv_files(args) -> dict:
    """DRV (a)'s Avro in a `_drv*` temporary directory beside this script:
    GM's widths at DRV_ROWS training and DRV_VAL_ROWS validation rows (GM's
    planted model), and GMM (e)'s copy of the training file whose row
    weights sit one ulp above 1; the directory and the seconds."""
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.TemporaryDirectory(prefix="_drv", dir=here)
    t0 = time.perf_counter()
    seed = args.seed + DRV_SEED
    tr = game_10m_data(seed, DRV_ROWS)
    va = game_10m_data(seed + 1, DRV_VAL_ROWS, model_seed=seed)
    schema, names = gm_schema()
    cols = {}
    for path, (Xf, Xu, Xi, uid, iid, y) in (("train.avro", tr),
                                            ("val.avro", va)):
        n = len(y)
        cols[path] = (schema, y,
                      [np.char.add("r", np.arange(n).astype(str)),
                       np.char.add("u", uid.astype(str)),
                       np.char.add("i", iid.astype(str))],
                      list(zip(names, (Xf, Xu, Xi))))
        write_examples(os.path.join(tmp.name, path), *cols[path])
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    train = cols["train.avro"]
    write_examples(os.path.join(tmp.name, "train_nudged.avro"), *train,
                   weights=np.full(len(train[1]), np.nextafter(
                       np.float32(1), np.float32(2))))
    return {"dir": tmp, "write_s": write_s,
            "nudged_s": time.perf_counter() - t0}


def phase_drivers(args, files: dict, dev, gpu) -> dict:
    """DRV: the drivers end to end on local Avro — (a) indexing, training
    (a 2-point per-user L2 grid, validation, ALL mode) and scoring at GM's
    widths on ``files`` (`drv_files`), (b) a wide sparse fixed effect
    trained twice, (c) the SparseRows Xᵀr at T2's widths; returns the
    kernels' launches in (a)."""
    import torch

    from photon_tpu_torch import drivers as D
    from photon_tpu_torch import kernels as K
    from photon_tpu_torch import telemetry
    from photon_tpu_torch.data import matrix as PM
    from photon_tpu_torch.data.avro_io import read_avro
    from photon_tpu_torch.data.ingest import training_example_schema
    from photon_tpu_torch.data.model_io import load_game_model
    from photon_tpu_torch.drivers.index import IndexingParams
    from photon_tpu_torch.game.model import FixedEffectModel
    from photon_tpu_torch.game.scoring import score_game

    seed = args.seed + DRV_SEED
    with files["dir"] as root:
        # (a) GM's widths, cut in depth
        log(f"DRV (a): {DRV_ROWS} training and {DRV_VAL_ROWS} validation "
            f"rows written as deflate Avro in {files['write_s']:.1f} s "
            f"(in MG's wait) "
            f"({os.path.getsize(os.path.join(root, 'train.avro')) / 1e6:.1f}"
            f" MB and "
            f"{os.path.getsize(os.path.join(root, 'val.avro')) / 1e6:.1f} "
            "MB; records held against write_datum)")
        shards = {"global": {"bags": ["global"], "has_intercept": True},
                  "perUser": {"bags": ["perUser"], "has_intercept": False},
                  "perItem": {"bags": ["perItem"], "has_intercept": False}}
        coords = {
            "fixed": {"feature_shard": "global", "reg_type": "l2",
                      "reg_weight": GM_FIXED[1], "max_iters": GM_FIXED[0]},
            "per_user": {"feature_shard": "perUser", "entity_name":
                         "userId", "reg_type": "l2", "reg_weight":
                         GM_RE[1], "max_iters": GM_RE[0],
                         "reg_weights": DRV_USER_L2},
            "per_item": {"feature_shard": "perItem", "entity_name":
                         "itemId", "reg_type": "l2", "reg_weight":
                         GM_RE[1], "max_iters": GM_RE[0]}}
        train_path = os.path.join(root, "train.avro")
        val_path = os.path.join(root, "val.avro")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        K.reset_launch_counts()
        telemetry.reset()
        t0 = time.perf_counter()
        ix = D.run_indexing(IndexingParams(train_path,
                                           os.path.join(root, "maps"),
                                           shards))
        index_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        params_a = dict(
            train_path=train_path, validation_path=val_path,
            output_dir=os.path.join(root, "train"), feature_shards=shards,
            coordinates=coords, entity_fields=["userId", "itemId"],
            n_sweeps=GM_SWEEPS, output_mode="ALL",
            evaluators=["AUC", "SHARDED_AUC"], evaluator_entity="userId",
            index_map_dir=os.path.join(root, "maps"))
        out = D.run_training(D.TrainingParams(**params_a), device=dev)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sc = D.run_scoring(D.ScoringParams(
            model_dir=out.model_dir, data_path=val_path,
            output_dir=os.path.join(root, "score"), feature_shards=shards,
            entity_fields=["userId", "itemId"], evaluators=["AUC"]),
            device=dev)
        score_s = time.perf_counter() - t0
        launches = K.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        counters_native("DRV (a)")  # the drivers decode natively now
        rows_read = DRV_ROWS + DRV_VAL_ROWS
        log(f"DRV (a): indexing {index_s:.3f} s ({ix.sizes}); training "
            f"{train_s:.3f} s, phases "
            + ", ".join(f"{k} {v:.3f}" for k, v in out.timings.items())
            + f" s; read {rows_read / out.timings['read']:.6g} rows/s "
            "(native; the pure-Python decode read 7.6e3–1.0e4); "
            f"scoring {score_s:.3f} s, phases "
            + ", ".join(f"{k} {v:.3f}" for k, v in sc.timings.items())
            + f" s, read {DRV_VAL_ROWS / sc.timings['read']:.6g} rows/s; "
            f"best_model/ {dir_bytes(out.model_dir)} bytes, models/ "
            f"{dir_bytes(os.path.join(root, 'train', 'models'))} bytes; "
            f"peak device memory {peak / 1e9:.3f} GB; kernel launches "
            f"{launches}  [{gpu}]")
        for r in out.results:
            log(f"DRV (a): per-user L2 "
                f"{r.configs['per_user'].optimizer.reg_weight}: validation "
                f"AUC {r.validation_score:.8g}; objective history "
                + ", ".join(f"{v:.8g}"
                            for v in r.descent.objective_history))
        log(f"DRV (a): validation metrics of the best point "
            f"{out.validation_metrics}; scoring driver metrics "
            f"{sc.metrics}")

        # holds
        best = out.best.model
        loaded, _ = load_game_model(out.model_dir, device=dev)
        for name, cm in best.coordinates.items():
            lm = loaded[name]
            if isinstance(cm, FixedEffectModel):
                same = torch.equal(cm.model.coefficients.means,
                                   lm.model.coefficients.means)
            else:
                same = (torch.equal(cm.coefficients, lm.coefficients)
                        and list(cm.entity_keys) == list(lm.entity_keys))
            if not same:
                raise AssertionError(f"DRV (a): best_model/{name} does not "
                                     "load back bit for bit")
        rec = np.asarray([r["predictionScore"]
                          for r in read_avro(sc.output_path)])
        if not np.array_equal(rec, sc.scores):
            raise AssertionError("DRV (a): scores.avro differs from "
                                 "ScoringOutput.scores")
        gap = abs(sc.metric - out.best.validation_score)
        if gap > 1e-6:
            raise AssertionError(f"DRV (a): the scoring driver's AUC "
                                 f"{sc.metric} is {gap:.3g} from the "
                                 f"estimator's {out.best.validation_score}")
        # the best model's margins on the validation rows, by the port's
        # scoring, against a numpy f64 rank sum
        from photon_tpu_torch.data.feature_bags import FeatureShardConfig
        from photon_tpu_torch.data.ingest import (GameDataConfig,
                                                  read_game_data)

        _, maps = load_game_model(out.model_dir, device="cpu")
        vfull, _ = read_game_data(val_path, GameDataConfig(
            shards={k: FeatureShardConfig.coerce(v)
                    for k, v in shards.items()},
            entity_fields=("userId", "itemId")),
            index_maps={cm.feature_shard: maps[n]
                        for n, cm in best.coordinates.items()})
        margins = score_game(best, vfull.to_device(dev)).cpu().numpy()
        np_auc = auc(margins.astype(np.float64), vfull.y)
        if abs(np_auc - out.best.validation_score) > 1e-4:
            raise AssertionError(f"DRV (a): best AUC "
                                 f"{out.best.validation_score} vs numpy "
                                 f"f64 {np_auc}")
        best_manifest = json.load(open(os.path.join(
            out.model_dir, "training_manifest.json")))
        rows = json.load(open(os.path.join(root, "train", "models",
                                           "models.json")))
        for row in rows:
            m = json.load(open(os.path.join(row["dir"],
                                            "training_manifest.json")))
            if m != best_manifest or set(m) != {"version", "n_rows",
                                                "entities"}:
                raise AssertionError(f"DRV (a): {row['dir']}'s training "
                                     "manifest is not the row manifest "
                                     "(ROADMAP §C9)")
        log(f"DRV (a): best_model/ loads back bit for bit; scores.avro "
            f"equals ScoringOutput.scores; scoring AUC {sc.metric:.8g} vs "
            f"the estimator's {out.best.validation_score:.8g} "
            f"(gap {gap:.3g}); numpy f64 AUC {np_auc:.8g}; "
            f"{len(rows)} points' training manifests are the row "
            f"manifest ({best_manifest['n_rows']} rows)")
        lap("DRV (a)")
        phase_ck_driver(root, params_a, out, int(
            telemetry.snapshot()["counters"].get("game_re.blocks", 0)),
            dev, gpu)
        lap("CK (c)")
        gmm_driver(params_a, root, files["nudged_s"], dev, gpu)
        lap("GMM (e)")
        tu_driver(params_a, root, dev, gpu)
        lap("TU (d)")
        del out, sc, best, loaded, vfull
        torch.cuda.empty_cache()

        # (b) a wide sparse fixed effect through the driver, twice
        rng = np.random.default_rng(seed + 2)
        n = DRV_WIDE_ROWS
        cols = (rng.zipf(T_ZIPF, size=(n, DRV_WIDE_K)) - 1) % DRV_WIDE_D
        vals = rng.normal(size=(n, DRV_WIDE_K)).astype(np.float32)
        w_true = (rng.normal(size=DRV_WIDE_D) / np.sqrt(
            np.arange(1, DRV_WIDE_D + 1))).astype(np.float32)
        y = planted_labels(rng, cols, vals, w_true)
        wschema = training_example_schema(feature_bags=("wide",))
        wide_path = os.path.join(root, "wide.avro")
        # rows of distinct names: one bag of DRV_WIDE_K entries a row
        t0 = time.perf_counter()
        wnames = np.char.add("w", np.arange(DRV_WIDE_D).astype(str))
        write_wide(wide_path, wschema, y, wnames[cols], vals)
        write_s = time.perf_counter() - t0
        coefs = []
        for run in range(2):
            builds = PM.segment_plan_builds()
            t0 = time.perf_counter()
            w = D.run_training(D.TrainingParams(
                train_path=wide_path,
                output_dir=os.path.join(root, f"wide{run}"),
                feature_shards={"wide": {"bags": ["wide"],
                                         "has_intercept": True}},
                coordinates={"fixed": {
                    "feature_shard": "wide", "reg_type": "l2",
                    "reg_weight": 1.0, "max_iters": DRV_WIDE_ITERS,
                    "tolerance": 0.0}},
                n_sweeps=1), device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            builds = PM.segment_plan_builds() - builds
            if builds < 1:
                raise AssertionError("DRV (b): the wide shard's Xᵀr built "
                                     "no segment plan (not SparseRows?)")
            coefs.append(read_avro(os.path.join(
                w.model_dir, "fixed", "coefficients.avro")))
            d_wide = w.best.model["fixed"].model.coefficients.dim
            log(f"DRV (b): run {run}: {wall:.3f} s, phases "
                + ", ".join(f"{k} {v:.3f}" for k, v in w.timings.items())
                + f" s; {d_wide} columns (SparseRows), {builds} segment "
                f"plan builds; objective "
                f"{w.best.descent.objective_history[-1]:.8g}")
        if coefs[0] != coefs[1]:
            apart = sum(a != b for a, b in zip(*coefs))
            raise AssertionError(f"DRV (b): two runs' coefficient records "
                                 f"differ ({apart} of {len(coefs[0])})")
        log(f"DRV (b): {n} rows over {DRV_WIDE_D} zipf({T_ZIPF}) names, "
            f"{DRV_WIDE_K} a row, written in {write_s:.1f} s; the two "
            f"runs' {len(coefs[0])} coefficient records equal bit for bit")

    # (c) the repaired SparseRows Xᵀr at T2's widths
    ind, val, _ = sparse_problem(args.seed, DRV_XTR_ROWS)
    r_np = np.random.default_rng(seed + 3).normal(
        size=DRV_XTR_ROWS).astype(np.float32)
    X = PM.SparseRows(torch.from_numpy(ind), torch.from_numpy(val),
                      T_FEATURES).to(dev)
    r = torch.from_numpy(r_np).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    PM.segment_plan(X)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    outs = [PM.rmatvec(X, r) for _ in range(3)]
    if not all(torch.equal(outs[0], o) for o in outs[1:]):
        raise AssertionError("DRV (c): the SparseRows Xᵀr changed bits "
                             "between calls")
    want = np.bincount(ind.reshape(-1), weights=(
        val.astype(np.float64) * r_np[:, None]).reshape(-1),
        minlength=T_FEATURES)
    got = outs[0].cpu().numpy()
    err = float(np.abs(got - want).max() / np.abs(want).max())
    if err > 1e-5:
        raise AssertionError(f"DRV (c): Xᵀr off by {err:.3g} of the "
                             "largest f64 output (limit 1e-5)")

    def index_add_rmatvec():  # the parent's `_sparse_rmatvec`
        contrib = (X.values.to(torch.float32) * r[:, None]).reshape(-1)
        out = torch.zeros(X.n_features, dtype=torch.float32, device=dev)
        return out.index_add_(0, X.indices.reshape(-1).long(), contrib)

    old = [index_add_rmatvec() for _ in range(3)]
    old_apart = max(int((old[0] != o).sum()) for o in old[1:])
    old_err = float(np.abs(old[0].cpu().numpy() - want).max()
                    / np.abs(want).max())
    ms, old_ms = [], []
    for _ in range(2):  # in turns: segments, index_add_, segments, ...
        ms.append(events_ms(lambda: PM.rmatvec(X, r), cold=False,
                            hide_host=False))
        old_ms.append(events_ms(index_add_rmatvec, cold=False,
                                hide_host=False))
    log(f"DRV (c): SparseRows Xᵀr at {DRV_XTR_ROWS} rows x "
        f"{ind.shape[1]} slots over {T_FEATURES} features: plan built in "
        f"{plan_s:.3f} s ({len(X.plan.levels)} levels); 3 calls equal bit "
        f"for bit, {err:.3g} of the largest f64 output from numpy; "
        f"{min(ms):.4f} ms a call (events, warm; {ms}) against the "
        f"index_add_ form's {min(old_ms):.4f} ({old_ms}), which gave "
        f"{old_apart} outputs apart between its own 3 calls and is "
        f"{old_err:.3g} from f64  [{gpu}]")
    del X, r, outs, old
    torch.cuda.empty_cache()
    return launches


# ------------------------- phase DRV-S: the streamed data plane on Avro
def write_gm_part(task) -> tuple:
    """One part file of DRV-S's GM-width data (a spawn worker's task):
    ``(path, seed, model_seed, rows, first_row)`` → (path, seconds)."""
    path, seed, model_seed, rows, first = task
    t0 = time.perf_counter()
    Xf, Xu, Xi, uid, iid, y = game_10m_data(seed, rows, model_seed=model_seed)
    schema, names = gm_schema()
    write_examples(path, schema, y,
                   [np.char.add("r", np.arange(first, first + rows)
                                .astype(str)),
                    np.char.add("u", uid.astype(str)),
                    np.char.add("i", iid.astype(str))],
                   list(zip(names, (Xf, Xu, Xi))))
    return path, time.perf_counter() - t0


def gm_schema() -> tuple:
    """GM's TrainingExampleAvro schema and bag names (DRV and DRV-S)."""
    from photon_tpu_torch.data.ingest import training_example_schema

    schema = training_example_schema(
        feature_bags=("global", "perUser", "perItem"),
        entity_fields=("userId", "itemId"))
    names = ([f"f{j}" for j in range(GM_D_FIXED)],
             [f"u{j}" for j in range(GM_D_RE)],
             [f"i{j}" for j in range(GM_D_RE)])
    return schema, names


def encode_named_rows(y, cols, vals) -> bytes:
    """One block of one-bag TrainingExampleAvro records whose entries are
    per-row names ``f<col>`` (an (n, k) int column array; names vary by
    row, so no record template applies), vectorized: the response, null
    offset, weight and uid, then k (name, "", value) NameTermValues."""
    n, k = cols.shape
    c = cols.reshape(-1).astype(np.int64)
    ndig = np.ones(c.shape, np.int64)
    t = c // 10
    while (t > 0).any():
        ndig += t > 0
        t //= 10
    nl = ndig + 1  # "f" + digits
    name = np.zeros((c.size, int(nl.max())), np.uint8)
    name[:, 0] = ord("f")
    rem = c.copy()
    for j in range(int(ndig.max()) - 1, -1, -1):
        live = ndig > j
        name[live, 1 + j] = (48 + rem[live] % 10).astype(np.uint8)
        rem[live] //= 10
    ent = 1 + nl + 1 + 8  # name length varint, name, empty term, double
    count = np.full(n, 2 * k, np.uint8)  # the block count varint (k < 64)
    rec_len = 8 + 3 + 1 + ent.reshape(n, k).sum(1) + 1
    start = np.concatenate([[0], np.cumsum(rec_len)[:-1]])
    buf = np.zeros(int(rec_len.sum()), np.uint8)
    b8 = np.arange(8)
    buf[start[:, None] + b8] = np.ascontiguousarray(
        y, "<f8").view(np.uint8).reshape(n, 8)
    buf[start + 11] = count  # offset, weight, uid: null (0, 0, 0)
    epos = (start[:, None] + 12 + np.concatenate(
        [np.zeros((n, 1), np.int64), np.cumsum(ent.reshape(n, k), 1)[:, :-1]],
        1)).reshape(-1)
    buf[epos] = (2 * nl).astype(np.uint8)
    from photon_tpu_torch.data.avro_io import scatter_ragged

    scatter_ragged(buf, epos + 1, name, nl)
    buf[(epos + 1 + nl)[:, None] + 1 + b8] = np.ascontiguousarray(
        vals.reshape(-1), "<f8").view(np.uint8).reshape(-1, 8)
    return buf.tobytes()


def write_named_rows(path, schema, y, cols, vals, block: int = DRV_BLOCK):
    """Per-row-name rows as a deflate Avro container through
    `AvroBlockWriter` (`encode_named_rows` a block); the first block's
    bytes are held against the port's record encoder (`write_datum`)."""
    import io

    from photon_tpu_torch.data.avro_io import (AvroBlockWriter,
                                               parse_schema, write_datum)

    parsed = parse_schema(schema)
    with AvroBlockWriter(path, schema, codec="deflate") as w:
        for lo in range(0, len(y), block):
            hi = min(lo + block, len(y))
            payload = encode_named_rows(y[lo:hi], cols[lo:hi], vals[lo:hi])
            if lo == 0:
                ref = io.BytesIO()
                for i in range(hi):
                    write_datum(ref, parsed, {
                        "response": float(y[i]), "offset": None,
                        "weight": None, "uid": None,
                        "wide": [{"name": f"f{int(cc)}", "term": "",
                                  "value": float(v)}
                                 for cc, v in zip(cols[i], vals[i])]})
                if ref.getvalue() != payload:
                    raise AssertionError("DRV-S: the per-row-name encoder "
                                         "differs from write_datum")
            w.write_block(hi - lo, payload)


def chunk_digest(chunk) -> str:
    """sha256 of a GameData chunk's arrays (scalars, shards, entity ids)."""
    import hashlib

    h = hashlib.sha256()
    for a in (chunk.y, chunk.weights, chunk.offsets):
        h.update(np.ascontiguousarray(a).tobytes())
    for s in sorted(chunk.shards):
        X = chunk.shards[s]
        for a in ((X.indices, X.values) if hasattr(X, "indices") else (X,)):
            h.update(np.ascontiguousarray(a).tobytes())
    for e in sorted(chunk.entity_ids):
        h.update(np.ascontiguousarray(chunk.entity_ids[e]).tobytes())
    return h.hexdigest()


def counters_native(label: str) -> dict:
    """The telemetry counters after a leg meant to be native: it fails
    when any chunk fell back to Python or the library was unavailable."""
    from photon_tpu_torch import telemetry

    c = telemetry.snapshot()["counters"]
    bad = {k: c[k] for k in ("ingest.python_fallback",
                             "ingest.native_unavailable") if c.get(k)}
    if bad:
        raise AssertionError(f"DRV-S {label}: a native leg fell back to "
                             f"Python: {bad}")
    return c


def models_equal(a, b) -> bool:
    """Two GameModels' coefficients (and entity keys) bit for bit."""
    import torch

    from photon_tpu_torch.game.model import FixedEffectModel

    for name, cm in a.coordinates.items():
        other = b[name]
        if isinstance(cm, FixedEffectModel):
            if not torch.equal(cm.model.coefficients.means,
                               other.model.coefficients.means):
                return False
        elif not (torch.equal(cm.coefficients, other.coefficients)
                  and list(cm.entity_keys) == list(other.entity_keys)):
            return False
    return True


def model_gaps(a, b) -> dict:
    """Per coordinate: (the largest coefficient gap over the largest
    coefficient of ``b``, how many entities' gaps exceed DRVS_TOL of that
    scale, entities); a fixed effect counts as one entity of gap 0."""
    from photon_tpu_torch.game.model import FixedEffectModel

    out = {}
    for name, cm in a.coordinates.items():
        other = b[name]
        if isinstance(cm, FixedEffectModel):
            x = cm.model.coefficients.means.float().cpu().numpy()
            z = other.model.coefficients.means.float().cpu().numpy()
            out[name] = (float(np.abs(x - z).max() / np.abs(z).max()), 0, 1)
        else:
            if list(cm.entity_keys) != list(other.entity_keys):
                raise AssertionError(f"DRV-S: {name}'s entities differ")
            x = cm.coefficients.float().cpu().numpy()
            z = other.coefficients.float().cpu().numpy()
            gap = np.abs(x - z).max(1) / np.abs(z).max()
            out[name] = (float(gap.max()), int((gap > DRVS_TOL).sum()),
                         int(gap.size))
    return out


def drvs_files(args) -> dict:
    """DRV-S's GM-width part files in a `_drvs*` temporary directory beside
    this script (``train/``: DRVS_PARTS parts of DRVS_ROWS rows in all,
    ``val/``: DRVS_VAL_ROWS rows, ``python/``: DRVS_PY_ROWS rows for (a)),
    written by a spawn process pool, the largest file first; the
    directory, the tasks and the seconds."""
    import concurrent.futures as cf
    import multiprocessing
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    seed = args.seed + DRVS_SEED
    tmp = tempfile.TemporaryDirectory(prefix="_drvs", dir=here)
    dirs = [os.path.join(tmp.name, d) for d in ("train", "val", "python")]
    for d in dirs:
        os.makedirs(d)
    per = DRVS_ROWS // DRVS_PARTS
    tasks = [(os.path.join(dirs[0], f"part-{p:05d}.avro"), seed + 10 + p,
              seed, per, p * per) for p in range(DRVS_PARTS)]
    tasks.append((os.path.join(dirs[1], "part-00000.avro"), seed + 1, seed,
                  DRVS_VAL_ROWS, 0))
    tasks.append((os.path.join(dirs[2], "part-00000.avro"), seed + 2, seed,
                  DRVS_PY_ROWS, 0))
    t0 = time.perf_counter()
    with cf.ProcessPoolExecutor(
            max_workers=min(len(tasks), os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        # the largest files first, so none starts last
        part_s = [s for _, s in pool.map(
            write_gm_part, sorted(tasks, key=lambda t: -t[3]))]
    return {"dir": tmp, "tasks": tasks, "write_s": time.perf_counter() - t0,
            "part_s": part_s}


def phase_drivers_streamed(args, files: dict, dev, gpu) -> dict:
    """DRV-S: the streamed data plane on ``files`` (`drvs_files`) — (a)
    native against Python decode and the ingest plane's legs on GM-width
    part files, (b) the training driver past its streaming threshold
    (auto-trip, 4 workers, a chunk cache) against the in-memory read and a
    cache-hit rerun, (c) the streamed objective under a device budget, (d)
    T2's ladder built from Avro and trained through the blocked-ELL
    kernels; returns the kernels' launches in (b)'s streamed run, (c)'s
    and (d)'s solve."""
    import torch

    from photon_tpu_torch import drivers as D
    from photon_tpu_torch import kernels as K
    from photon_tpu_torch import native, telemetry
    from photon_tpu_torch.data.dataset import (_leaves, chunk_blocked_ell,
                                               make_batch)
    from photon_tpu_torch.data.feature_bags import FeatureShardConfig
    from photon_tpu_torch.data.ingest import (GameDataConfig,
                                              read_game_data,
                                              training_example_schema)
    from photon_tpu_torch.data.ingest_plane import (
        chunk_blocked_ell_from_avro, iter_game_chunks_parallel,
        open_chunk_source)
    from photon_tpu_torch.data.streaming import scan_ingest
    from photon_tpu_torch.drivers import train as DT
    from photon_tpu_torch.drivers.index import IndexingParams
    from photon_tpu_torch.models.training import train_glm
    from photon_tpu_torch.ops.losses import TaskType
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l2

    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def peak_gb() -> str:
        return (f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB"
                if cuda else "not measured (CPU)")

    if not native.available():
        raise AssertionError(f"DRV-S: the native library did not build: "
                             f"{native.build_error()}")
    seed = args.seed + DRVS_SEED
    per = DRVS_ROWS // DRVS_PARTS
    t_phase = time.perf_counter()
    failures: list = []
    tasks, write_s, part_s = files["tasks"], files["write_s"], \
        files["part_s"]
    with files["dir"] as root:
        train_dir = os.path.join(root, "train")
        val_dir = os.path.join(root, "val")
        mb = dir_bytes(train_dir) / 1e6
        log(f"DRV-S: {DRVS_ROWS} training rows at GM's widths as "
            f"{DRVS_PARTS} deflate part files ({mb:.1f} MB) and "
            f"{DRVS_VAL_ROWS} validation rows ({dir_bytes(val_dir) / 1e6:.1f}"
            f" MB) written by {len(tasks)} spawn processes in {write_s:.1f} "
            f"s in MG's wait (each part {min(part_s):.1f}–{max(part_s):.1f} "
            f"s); cut: "
            f"depth, {DRVS_ROWS} of GM's {GM_ROWS} rows  [{gpu}]")
        shards = {"global": {"bags": ["global"], "has_intercept": True},
                  "perUser": {"bags": ["perUser"], "has_intercept": False},
                  "perItem": {"bags": ["perItem"], "has_intercept": False}}
        cfg = GameDataConfig(
            shards={k: FeatureShardConfig.coerce(v)
                    for k, v in shards.items()},
            entity_fields=("userId", "itemId"))

        # (a) decode: a part file native and Python, bit for bit
        part0 = tasks[-1][0]
        telemetry.reset()
        t0 = time.perf_counter()
        nat, nmaps = read_game_data(part0, cfg, use_native=True)
        nat_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        py, pmaps = read_game_data(part0, cfg, use_native=False)
        py_s = time.perf_counter() - t0
        counters_native("(a)")
        same = (all(np.array_equal(getattr(nat, f), getattr(py, f))
                    for f in ("y", "weights", "offsets"))
                and all(np.array_equal(nat.shards[s], py.shards[s])
                        for s in cfg.shards)
                and all(np.array_equal(nat.entity_ids[e], py.entity_ids[e])
                        and nat.entity_ids[e].dtype == py.entity_ids[e].dtype
                        for e in cfg.entity_fields)
                and all(nmaps[s].keys_in_order() == pmaps[s].keys_in_order()
                        for s in cfg.shards))
        if not same:
            raise AssertionError("DRV-S (a): the native read differs from "
                                 "the Python read")
        log(f"DRV-S (a): a part file of {DRVS_PY_ROWS} rows (cut: depth, "
            f"from a {per}-row part): read_game_data native "
            f"{DRVS_PY_ROWS / nat_s:.6g} rows/s ({nat_s:.3f} s), Python "
            f"{DRVS_PY_ROWS / py_s:.6g} rows/s ({py_s:.3f} s), "
            f"{py_s / nat_s:.1f}x; "
            f"the two GameData and maps equal bit for bit  [{gpu}]")
        del nat, py
        # the ingest plane's legs read half the part files (cut: depth)
        a_dir = os.path.join(root, "train_a")
        os.makedirs(a_dir)
        for path, *_ in tasks[:DRVS_PARTS // 2]:
            os.link(path, os.path.join(a_dir, os.path.basename(path)))
        a_rows = per * (DRVS_PARTS // 2)
        scan = scan_ingest(a_dir, cfg)
        maps, bidx = scan.index_maps, scan.block_index
        legs, digests = [], None

        def leg(label, make):
            nonlocal digests
            telemetry.reset()
            t0 = time.perf_counter()
            _, chunks = make()
            got = [chunk_digest(c) for c in chunks]
            secs = time.perf_counter() - t0
            c = counters_native(f"(a) {label}")
            if digests is None:
                digests = got
            elif got != digests:
                raise AssertionError(f"DRV-S (a) {label}: chunks differ from "
                                     "the in-process decode's")
            starts = int(c.get("ingest.pool_starts", 0))
            legs.append(f"{label} {a_rows / secs:.6g} rows/s "
                        f"({secs:.3f} s" + (f", a worker pool start"
                                            if starts else "") + ")")
            return c

        kw = dict(chunk_rows=DRVS_CHUNK, block_index=bidx)
        leg("0 workers", lambda: iter_game_chunks_parallel(
            a_dir, cfg, maps, workers=0, **kw))
        c4 = leg(f"{DRVS_WORKERS} process workers",
                 lambda: iter_game_chunks_parallel(
                     a_dir, cfg, maps, workers=DRVS_WORKERS,
                     mode="process", **kw))
        cache_a = os.path.join(root, "cache_a")
        cb = leg("cache build", lambda: open_chunk_source(
            a_dir, cfg, maps, workers=DRVS_WORKERS, cache_dir=cache_a,
            **kw))
        ch = leg("cache hit", lambda: open_chunk_source(
            a_dir, cfg, maps, cache_dir=cache_a, **kw))
        if (c4.get("ingest.worker_deaths") or cb.get("ingest.worker_deaths")
                or ch.get("ingest.cache_hits") != 1
                or ch.get("ingest.decode_seconds")):
            raise AssertionError(f"DRV-S (a): a worker died or the cache "
                                 f"hit decoded Avro: {c4} {cb} {ch}")
        log(f"DRV-S (a): {len(digests)} chunks of {a_rows} training rows "
            f"(cut: depth, {DRVS_PARTS // 2} of the {DRVS_PARTS} part files), "
            f"bit-identical over: " + "; ".join(legs)
            + f"; cache {dir_bytes(cache_a) / 1e6:.1f} MB  [{gpu}]")
        lap("DRV-S (a)")

        # (b) the training driver past its streaming threshold
        coords = {
            "fixed": {"feature_shard": "global", "reg_type": "l2",
                      "reg_weight": GM_FIXED[1], "max_iters": GM_FIXED[0],
                      "tolerance": DRVS_TOL},
            "per_user": {"feature_shard": "perUser", "entity_name":
                         "userId", "reg_type": "l2", "reg_weight": GM_RE[1],
                         "max_iters": GM_RE[0], "tolerance": DRVS_TOL},
            "per_item": {"feature_shard": "perItem", "entity_name":
                         "itemId", "reg_type": "l2", "reg_weight": GM_RE[1],
                         "max_iters": GM_RE[0], "tolerance": DRVS_TOL}}
        maps_dir = os.path.join(root, "maps")
        params = D.TrainingParams(
            train_path=train_dir, validation_path=val_dir,
            output_dir=os.path.join(root, "b1"), feature_shards=shards,
            coordinates=coords, entity_fields=["userId", "itemId"],
            n_sweeps=GM_SWEEPS, evaluators=["AUC", "SHARDED_AUC"],
            evaluator_entity="userId", index_map_dir=maps_dir,
            ingest_workers=DRVS_WORKERS, streaming_threshold_rows=
            DRVS_THRESHOLD, chunk_cache_dir=os.path.join(root, "cache_b"))
        if DRVS_ROWS <= params.streaming_threshold_rows:
            raise AssertionError("DRV-S: the training set does not exceed "
                                 "the streaming threshold")
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        telemetry.reset()
        t0 = time.perf_counter()
        ix = D.run_indexing(IndexingParams(train_dir, maps_dir, shards))
        index_s = time.perf_counter() - t0
        counters_native("(b) indexing")
        telemetry.reset()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        out = D.run_training(params, device=dev)
        sync()
        train_s = time.perf_counter() - t0
        launches_b = K.launch_counts()
        c = counters_native("(b)")
        snap = telemetry.snapshot()
        if not c.get("ingest.device_chunks"):
            raise AssertionError("DRV-S (b): streaming=None did not stream")
        read_s = out.timings["read"]
        rows = DRVS_ROWS + DRVS_VAL_ROWS
        stall = c.get("ingest.staging_wait_seconds", 0.0)
        log(f"DRV-S (b): indexing {index_s:.3f} s ({ix.sizes}); training "
            f"(streaming=None tripped: {DRVS_ROWS} rows > "
            f"{params.streaming_threshold_rows}; {DRVS_WORKERS} workers, a "
            f"chunk cache) {train_s:.3f} s, phases "
            + ", ".join(f"{k} {v:.3f}" for k, v in out.timings.items())
            + f" s; read {rows / read_s:.6g} rows/s; staging stall "
            f"{stall:.3f} s, {stall / read_s:.3f} of the read; prefetch "
            f"widened {int(c.get('stream.prefetch_widened', 0))} times, "
            f"at most {snap['gauges'].get('ingest.staging_peak_depth')} "
            f"staging buffers ("
            f"{snap['gauges'].get('ingest.staging_peak_bytes', 0) / 1e6:.1f}"
            f" MB pinned host staging); decode "
            f"{c.get('ingest.decode_seconds', 0):.3f} s (waiting on "
            f"{int(c.get('ingest.worker_chunks', 0))} worker chunks, "
            f"{int(c.get('ingest.pool_starts', 0))} pool starts), cache "
            f"commits {c.get('ingest.cache_commit_seconds', 0):.3f} s; "
            f"launches {launches_b}; "
            f"peak device memory {peak_gb()}; validation AUC "
            f"{out.best.validation_score:.8g}, metrics "
            f"{out.validation_metrics}  [{gpu}]")
        mem = D.run_training(dataclasses.replace(
            params, output_dir=os.path.join(root, "b_mem"), streaming=False,
            ingest_workers=0, chunk_cache_dir=None), device=dev)
        # the two validation reads, and the best model's margins on each
        from photon_tpu_torch.data.streaming import stream_to_device
        from photon_tpu_torch.game.scoring import score_game

        vmaps = out_maps(maps_dir, shards)
        v_str, _ = stream_to_device(val_dir, cfg, vmaps,
                                    chunk_rows=DRVS_CHUNK, device=dev)
        v_mem, _ = read_game_data(val_dir, cfg, index_maps=vmaps)
        v_same = {f: bool(np.array_equal(
            getattr(v_str, f).cpu().numpy(), getattr(v_mem, f)))
            for f in ("y", "weights", "offsets")}
        v_same.update({s: bool(np.array_equal(
            v_str.shards[s].cpu().numpy(), v_mem.shards[s]))
            for s in cfg.shards})
        v_same.update({e: bool(np.array_equal(v_str.entity_ids[e],
                                              v_mem.entity_ids[e]))
                       for e in cfg.entity_fields})
        from photon_tpu_torch.evaluation.metrics import auc as auc_dev

        m_str = score_game(out.best.model, v_str)
        m_mem = score_game(out.best.model, v_mem.to_device(dev))
        apart = int((m_str != m_mem).sum())
        # the same margins' AUC, call after call: one value (§C11, its
        # cumulative sums are blocked scans, not one CUDA device scan)
        aucs = {float(auc_dev(m_str, v_str.y, v_str.weights))
                for _ in range(DRVS_AUC_CALLS)}
        auc_gap = abs(out.best.validation_score - mem.best.validation_score)
        log(f"DRV-S (b): validation AUC streamed "
            f"{out.best.validation_score!r}, in memory "
            f"{mem.best.validation_score!r} (gap {auc_gap:.3g}, limit 1e-6); "
            f"the validation reads equal: {v_same}; the best model's margins "
            f"on them {apart} apart; the AUC of those margins over "
            f"{DRVS_AUC_CALLS} calls: {len(aucs)} distinct values "
            f"{sorted(aucs)}  [{gpu}]")
        if not (models_equal(out.best.model, mem.best.model)
                and all(v_same.values()) and apart == 0):
            failures.append(
                f"DRV-S (b): the streamed model or data differ from the "
                f"in-memory read's: {model_gaps(out.best.model, mem.best.model)}"
                f", {v_same}, margins {apart} apart")
        if auc_gap > 1e-6:
            failures.append(f"DRV-S (b): the validation AUCs {auc_gap:.3g} "
                            "apart")
        if len(aucs) != 1:
            failures.append(f"DRV-S (b): the AUC of the same margins took "
                            f"{len(aucs)} values over {DRVS_AUC_CALLS} calls "
                            "(ROADMAP §C11)")
        telemetry.reset()
        hit = D.run_training(dataclasses.replace(
            params, output_dir=os.path.join(root, "b2")), device=dev)
        c = counters_native("(b) cache hit")
        if (c.get("ingest.cache_hits") != 2 or c.get("ingest.decode_seconds")
                or not models_equal(out.best.model, hit.best.model)):
            failures.append(f"DRV-S (b): the cache-hit run decoded Avro "
                            f"or trained another model: {c}")
        log(f"DRV-S (b): the streamed model equals the in-memory read's "
            f"(read {mem.timings['read']:.3f} s, "
            f"{rows / mem.timings['read']:.6g} rows/s) bit for bit; a "
            f"second streamed run hit the cache (2 hits, no decode): read "
            f"{hit.timings['read']:.3f} s "
            f"({rows / hit.timings['read']:.6g} rows/s), the same model bit "
            f"for bit  [{gpu}]")

        # (c) the streamed objective under a device budget
        est = DT._estimate_device_bytes(DRVS_ROWS, out_maps(maps_dir, shards),
                                        params)
        telemetry.reset()
        K.reset_launch_counts()
        with CoordinateTimer() as timer:
            so = D.run_training(dataclasses.replace(
                params, output_dir=os.path.join(root, "c"),
                hbm_budget_bytes=est // 2,
                objective_chunk_rows=DRVS_OBJ_CHUNK), device=dev)
        launches_c = K.launch_counts()
        c = counters_native("(c)")
        if c.get("game_e2e.pod_scale_runs") != 1:
            raise AssertionError("DRV-S (c): the streamed objective did not "
                                 f"engage: {c}")
        gaps = model_gaps(so.best.model, out.best.model)
        # the fixed effect within DRVS_TOL; a random effect's entities
        # apart beyond it at most 0.1% of them (entity solves stop at
        # DRVS_TOL, on offsets the streamed fixed effect moves by a
        # rounding)
        bad = {k: v for k, v in gaps.items()
               if v[0] > DRVS_TOL and (k == "fixed" or v[1] > 1e-3 * v[2])}
        e2e = {k: v for k, v in c.items() if k.startswith("game_e2e.")}
        log(f"DRV-S (c): budget {est // 2} bytes (half the {est}-byte "
            f"estimate): the fixed shard as {DRVS_ROWS // DRVS_OBJ_CHUNK} "
            f"host chunks, random effects resident; phases "
            + ", ".join(f"{k} {v:.3f}" for k, v in so.timings.items())
            + " s; seconds per update "
            + "; ".join(f"{s} " + ", ".join(f"{v:.3f}" for v in secs)
                        for s, secs in timer.secs.items())
            + f"; {e2e}; launches {launches_c}; against (b): largest gap / "
            "largest coefficient "
            + ", ".join(f"{k} {v[0]:.3g} ({v[1]} of {v[2]} entities past "
                        f"{DRVS_TOL:g})" for k, v in gaps.items())
            + f"; AUC {so.best.validation_score:.8g} vs "
            f"{out.best.validation_score:.8g}  [{gpu}]")
        if bad:
            failures.append(f"DRV-S (c): streamed objective apart from "
                            f"(b) beyond {DRVS_TOL:g}: {bad}")
        del out, mem, hit, so

        # (d) T2's ladder from Avro, through kernels rows 2 and 4
        ind, val, y = sparse_problem(seed + 3, DRVS_LADDER_ROWS)
        wide_path = os.path.join(root, "t2.avro")
        wschema = training_example_schema(feature_bags=("wide",))
        t0 = time.perf_counter()
        write_named_rows(wide_path, wschema, y, ind[:, :T_NNZ],
                         val[:, :T_NNZ])
        wwrite_s = time.perf_counter() - t0
        wcfg = GameDataConfig(shards={"wide": FeatureShardConfig(
            bags=("wide",), has_intercept=True)})
        telemetry.reset()
        t0 = time.perf_counter()
        wscan = scan_ingest(wide_path, wcfg)
        wmaps = wscan.index_maps
        scan_s = time.perf_counter() - t0
        k = T_NNZ + 1
        lkw = dict(d_dense=T_DENSE, feature_dtype=torch.bfloat16, sparse_k=k,
                   workers=DRVS_WORKERS,
                   cache_dir=os.path.join(root, "ladder"),
                   block_index=wscan.block_index)
        t0 = time.perf_counter()
        cold = chunk_blocked_ell_from_avro(wide_path, wcfg, wmaps, "wide",
                                           DRVS_LADDER_CHUNK, **lkw)
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        lad = chunk_blocked_ell_from_avro(wide_path, wcfg, wmaps, "wide",
                                          DRVS_LADDER_CHUNK, **lkw)
        hit_s = time.perf_counter() - t0
        c = counters_native("(d)")
        cold_parts = (f"decode {c.get('ingest.decode_seconds', 0):.3f} s "
                      f"({int(c.get('ingest.pool_starts', 0))} pool starts),"
                      f" layout {c.get('ingest.layout_seconds', 0):.3f} s, "
                      f"cache commit "
                      f"{c.get('ingest.cache_commit_seconds', 0):.3f} s")
        if c.get("ingest.cache_hits") != 1:
            raise AssertionError(f"DRV-S (d): the ladder cache missed: {c}")
        full, _ = read_game_data(wide_path, wcfg, index_maps=wmaps,
                                 sparse_k=k)
        want = chunk_blocked_ell(make_batch(full.shards["wide"], full.y,
                                            full.weights, full.offsets,
                                            device="cpu"),
                                 DRVS_LADDER_CHUNK, d_dense=T_DENSE,
                                 feature_dtype=torch.bfloat16)
        for got, label in ((cold, "cold"), (lad, "cache hit")):
            ok = (got.X.n_chunks == want.X.n_chunks
                  and all(x.dtype == z.dtype and torch.equal(x, z)
                          for a, b in zip(got.X.chunks, want.X.chunks)
                          for x, z in zip(_leaves(a), _leaves(b)))
                  and torch.equal(got.X.perm_cols,
                                  torch.as_tensor(want.X.perm_cols))
                  and all(np.array_equal(getattr(got, f), getattr(want, f))
                          for f in ("y", "weights", "offsets")))
            if not ok:
                failures.append(f"DRV-S (d): the {label} ladder differs from "
                                "chunk_blocked_ell of the in-memory read")
        d_feat = wmaps["wide"].n_features
        log(f"DRV-S (d): {DRVS_LADDER_ROWS} rows at T2's widths ({T_NNZ} "
            f"zipf({T_ZIPF}) names of {T_FEATURES} a row + an intercept; "
            f"{d_feat} distinct columns) written as per-row names in "
            f"{wwrite_s:.1f} s ({os.path.getsize(wide_path) / 1e6:.1f} MB, "
            f"{DRVS_LADDER_ROWS / wwrite_s:.6g} rows/s; cut: depth, "
            f"{DRVS_LADDER_ROWS} of T2's {T_ROWS}); maps in {scan_s:.3f} s; "
            f"ladder of {lad.X.n_chunks} bf16 chunks ({T_DENSE} hot columns)"
            f" from Avro with {DRVS_WORKERS} workers {cold_s:.3f} s cold "
            f"({cold_parts}), {hit_s:.3f} s from the ladder cache; both equal "
            f"chunk_blocked_ell of the in-memory read bit for bit  [{gpu}]")
        cfg_t = OptimizerConfig(max_iters=DRVS_LADDER_ITERS, tolerance=0.0,
                                reg=l2(), reg_weight=T_REG,
                                history=T_HISTORY)
        sync()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        _, res = train_glm(lad, TaskType.LOGISTIC_REGRESSION, cfg_t,
                           device=dev)
        sync()
        solve_s = time.perf_counter() - t0
        d_launch = K.launch_counts()
        with K.scope("off"):
            _, off = train_glm(lad, TaskType.LOGISTIC_REGRESSION,
                               dataclasses.replace(cfg_t, max_iters=5),
                               device=dev)
        h, ho = np.asarray(res.history()[:5]), np.asarray(off.history()[:5])
        err = float(np.max(np.abs(h - ho) / np.abs(ho)))
        log(f"DRV-S (d): streamed L-BFGS on the ladder, "
            f"{res.iterations} iterations in {solve_s:.3f} s: "
            f"{DRVS_LADDER_ROWS * res.iterations / solve_s:.6g} "
            f"rows·iters/s; launches {d_launch}; first 5 iterations within "
            f"{err:.3g} of scope('off')'s (limit 1e-5)  [{gpu}]")
        if err > 1e-5:
            failures.append("DRV-S (d): the kernel route's history parts "
                            "from scope('off')'s")
        if cuda and not all(d_launch.get(n, 0) > 0
                            for n in ("tail_matvec", "bucket_rmatvec")):
            raise AssertionError(f"DRV-S (d): the ladder solve launched "
                                 f"{d_launch}, not rows 2 and 4")
        # the main paths' launches: (b)'s streamed driver run, (c)'s
        # streamed objective and (d)'s ladder solve, each counted alone
        drvs = {n: launches_b.get(n, 0) + launches_c.get(n, 0)
                + d_launch.get(n, 0)
                for n in {*launches_b, *launches_c, *d_launch}}
    log(f"DRV-S: {time.perf_counter() - t_phase:.1f} s in all  [{gpu}]")
    if failures:
        raise AssertionError("; ".join(failures))
    return drvs


def out_maps(maps_dir, shards) -> dict:
    """The indexing driver's frozen maps of ``shards``."""
    from photon_tpu_torch.drivers.index import load_index_map_dir

    return load_index_map_dir(maps_dir, shards)


def write_wide(path, schema, y, names, vals, block: int = DRV_BLOCK):
    """One-bag rows of per-row names (an (n, k) string array) as a deflate
    Avro container, through `write_avro`'s record encoder (the names vary
    by row, so no template applies)."""
    from photon_tpu_torch.data.avro_io import write_avro

    write_avro(path, ({"response": float(y[i]), "offset": None,
                       "weight": None, "uid": None,
                       "wide": [{"name": str(nm), "term": "",
                                 "value": float(v)}
                                for nm, v in zip(names[i], vals[i])]}
                      for i in range(len(y))), schema, block_records=block)


# ------------------------------------------- phase CR: continual refresh
def cr_drop(seed: int, uid: np.ndarray, planted, shift: float):
    """A delta drop at GM's widths over the user keys ``uid`` (ids at or
    past GM_USERS are users the previous model never saw): uniform item
    keys, N(0, 1) rows, labels from the planted model with every drawn
    user's coefficients shifted by ``shift``. Returns its GameData and
    its (Xf, Xu, Xi, uid, iid, y) columns."""
    from photon_tpu_torch.game.dataset import GameData

    w_true, u_true, i_true = planted
    rng = np.random.default_rng(seed)
    n = uid.shape[0]
    Xf = rng.normal(size=(n, GM_D_FIXED)).astype(np.float32)
    Xu = rng.normal(size=(n, GM_D_RE)).astype(np.float32)
    Xi = rng.normal(size=(n, GM_D_RE)).astype(np.float32)
    iid = rng.integers(0, GM_ITEMS, size=n)
    u_rows = np.where((uid < GM_USERS)[:, None],
                      u_true[np.minimum(uid, GM_USERS - 1)] + shift, 0.0)
    margin = (Xf @ w_true + np.einsum("nd,nd->n", Xu, u_rows)
              + np.einsum("nd,nd->n", Xi, i_true[iid]))
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(
        np.float32)
    data = GameData.build(y, shards={"fixed": Xf, "u_re": Xu, "i_re": Xi},
                          entity_ids={"user": uid, "item": iid})
    return data, (Xf, Xu, Xi, uid, iid, y)


def cr_drop_users(seed: int) -> np.ndarray:
    """(b)'s user keys: CR_DROP_ROWS zipf(1.2) ranks over GM's users (the
    rank wrapped into the user space) and CR_NEW_ROWS rows of CR_NEW_USERS
    users the previous model never saw."""
    rng = np.random.default_rng(seed)
    known = (rng.zipf(1.2, size=CR_DROP_ROWS) - 1) % GM_USERS
    new = GM_USERS + np.concatenate([
        np.arange(CR_NEW_USERS),
        rng.integers(0, CR_NEW_USERS, size=CR_NEW_ROWS - CR_NEW_USERS)])
    return np.concatenate([known, new]).astype(np.int64)


def cr_second_users(data, plan, dev) -> tuple:
    """(c)'s user keys: (b)'s plus up to 8 users of the previous model
    that (b) did not touch, each given exactly the row count of the
    lowest per-user bucket that has free (padding) lanes: the touched
    count grows, every bucket's padded count stays. Returns (keys, users
    added, that bucket's (m, touched, padded))."""
    from photon_tpu_torch.continual import REFRESH_LANES
    from photon_tpu_torch.game.dataset import RandomEffectDataset
    from photon_tpu_torch.parallel.mesh import pad_to_multiple

    uid = np.asarray(data.entity_ids["user"])
    ds = RandomEffectDataset.build(data, "user", "u_re", device=dev)
    touched = plan.coordinates["per_user"].touched_keys
    for b in sorted(ds.blocks, key=lambda b: b.m):
        keys = ds.entity_keys[b.entity_index].astype(np.str_)
        n = int(np.isin(keys, touched).sum())
        pad = pad_to_multiple(n, REFRESH_LANES)
        if pad > n:
            free = np.setdiff1d(np.arange(GM_USERS), uid)[:min(pad - n, 8)]
            return (np.concatenate([uid, np.repeat(free, b.m)]), free.size,
                    (b.m, n, pad))
    raise AssertionError("CR (c): no per-user bucket has a free lane")


def serve_swapping(ladder, reqs: list, swap) -> dict:
    """Serve from CLIENTS threads (each keeps WINDOW in flight) through one
    dispatcher, the requests taken in turn from ``reqs`` (cycling), and
    call ``swap()`` on this thread once half of ``reqs`` are answered, the
    clients still sending; the run ends when half of ``reqs`` more were
    sent after ``swap()`` returned. Returns each send's request index,
    submit and answer times and score, the run's start and end, the
    swap's start and end, and what ``swap()`` returned."""
    from photon_tpu_torch.serving import MicroBatchDispatcher

    n = len(reqs)
    lock = threading.Lock()
    sends: list = []  # [request index, submit s, answer s, score]
    st = dict(t_swap1=None, n_post=0)
    done = threading.Semaphore(0)
    errors: list = []
    disp = MicroBatchDispatcher(ladder, max_batch=MAX_BATCH,
                                max_delay_us=MAX_DELAY_US)

    def take():
        with lock:
            if st["t_swap1"] is not None:
                if st["n_post"] >= n // 2:
                    return None
                st["n_post"] += 1
            rec = [len(sends) % n, 0.0, 0.0, float("nan")]
            sends.append(rec)
            return rec

    def client() -> None:
        try:
            while True:
                window = [r for r in (take() for _ in range(WINDOW))
                          if r is not None]
                if not window:
                    return
                futs = []
                for rec in window:
                    rec[1] = time.perf_counter()
                    futs.append(disp.submit(reqs[rec[0]]))
                for rec, f in zip(window, futs):
                    rec[3] = f.result(timeout=120)
                    rec[2] = time.perf_counter()
                    done.release()
        except Exception as e:  # reported by the main thread
            errors.append(e)
            for _ in range(n):
                done.release()

    threads = [threading.Thread(target=client) for _ in range(CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for _ in range(n // 2):
        done.acquire()
    t_swap0 = time.perf_counter()
    out = swap()
    with lock:
        st["t_swap1"] = t_swap1 = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
    t_end = time.perf_counter()
    disp.close()
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise AssertionError("a client thread did not finish")
    idx, t_sub, t_ans, scores = (np.asarray(v) for v in zip(*sends))
    return dict(idx=idx.astype(np.int64), t_sub=t_sub, t_ans=t_ans,
                scores=scores, t0=t0, t_swap0=t_swap0, t_swap1=t_swap1,
                t_end=t_end, swap=out)


def cr_requests(seed: int, n: int) -> list:
    """Requests over GM's keys: dense rows of the three shards, zipf(1.2)
    user and item ranks (ranks past the entity counts are cold)."""
    from photon_tpu_torch.serving import ScoreRequest

    rng = np.random.default_rng(seed)
    f = rng.standard_normal((n, GM_D_FIXED), np.float32)
    u = rng.standard_normal((n, GM_D_RE), np.float32)
    i = rng.standard_normal((n, GM_D_RE), np.float32)
    ur = rng.zipf(1.2, size=n) - 1
    ir = rng.zipf(1.2, size=n) - 1
    return [ScoreRequest(features={"fixed": f[r], "u_re": u[r],
                                   "i_re": i[r]},
                         entities={"user": str(ur[r]), "item": str(ir[r])},
                         offset=0.0) for r in range(n)]


def lat_text(lat_ms: np.ndarray, wall: float) -> str:
    return (f"{lat_ms.size / wall:.1f} QPS, p50 "
            f"{np.percentile(lat_ms, 50):.3f} ms, p99 "
            f"{np.percentile(lat_ms, 99):.3f} ms over {lat_ms.size}")


def phase_continual(args, gm_data, dev, gpu) -> tuple:
    """CR: continual refresh at GM's widths — (a) the previous model, (b)
    a delta drop's plan and refresh held entity by entity, (c) a second
    drop on the same padded shapes, (d) the hot swap into a live int8
    ladder under load, (e) a killed publish and a refused store, (f) the
    straggler re-solve. Returns the kernels' launches in (b)-(c)'s
    refreshes and in (d)'s post-swap window."""
    import shutil
    import tempfile

    import torch

    from photon_tpu_torch import continual as CT
    from photon_tpu_torch import kernels as K
    from photon_tpu_torch import telemetry
    from photon_tpu_torch.checkpoint.faults import (FaultPlan,
                                                    InjectedFault,
                                                    fault_plan)
    from photon_tpu_torch.continual import refresh as CRF
    from photon_tpu_torch.data.dataset import make_batch
    from photon_tpu_torch.game.random_effect import (RandomEffectCoordinate,
                                                     align_entity_priors)
    from photon_tpu_torch.game.scoring import coordinate_scores
    from photon_tpu_torch.kernels import serving as KS
    from photon_tpu_torch.models.training import train_glm
    from photon_tpu_torch.models.variance import VarianceComputationType
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l2
    from photon_tpu_torch.serving import CoefficientStore, ProgramLadder

    t_phase = time.perf_counter()
    telemetry.reset()
    cfg_f = OptimizerConfig(max_iters=GM_FIXED[0], reg=l2(),
                            reg_weight=GM_FIXED[1])
    cfg_r = OptimizerConfig(max_iters=GM_RE[0], reg=l2(),
                            reg_weight=GM_RE[1])
    # (b) stops each refreshed entity at RE_CHECK_TOL: an entity starts at
    # its previous optimum under a prior of precision ~1/variance, so at
    # 1e-7 it reaches the f32 floor within a few iterations, where its
    # line search can fail on rounding (the reference fails the same
    # lanes); (c) runs GM's configuration as it is and reports them
    cfg_b = dataclasses.replace(cfg_r, tolerance=RE_CHECK_TOL)
    configs = {"per_user": cfg_b, "per_item": cfg_b}

    # (a) the previous model: GM's data (``gm_data``, its fixed shard
    # uploaded again), SIMPLE variances, its manifest
    t0 = time.perf_counter()
    Xf_dev = gm_data.shards["fixed"].to(dev)
    data = dataclasses.replace(gm_data, shards={**gm_data.shards,
                                                "fixed": Xf_dev})
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    est = game_estimator(dev, cfg_f, cfg_r, GM_SWEEPS,
                         variance=VarianceComputationType.SIMPLE)
    prev_fit, fit_s = fit_timed(est, data)
    prev = prev_fit.model
    t0 = time.perf_counter()
    manifest = CT.build_manifest(data)
    manifest_s = time.perf_counter() - t0
    n_users = len(manifest["entities"]["user"])
    log(f"CR (a): previous model: GM's {data.n} rows (its data, the fixed "
        f"shard uploaded again in {gen_s:.2f} s), "
        f"GameEstimator.fit ({GM_SWEEPS} sweeps, SIMPLE variances) "
        f"{fit_s:.3f} s, manifest {manifest_s:.2f} s ({n_users} users, "
        f"{len(manifest['entities']['item'])} items)  [{gpu}]")

    # (b) the delta drop, its plan and the refresh
    planted = game_10m_model(np.random.default_rng(args.seed))
    t_drop = time.time()
    drop, cols = cr_drop(args.seed + CR_SEED, cr_drop_users(
        args.seed + CR_SEED), planted, CR_SHIFT)
    t0 = time.perf_counter()
    plan = CT.diff_manifest(manifest, drop, prev)
    diff_s = time.perf_counter() - t0
    coord_s: dict = {}
    refresh_coordinate = CRF._refresh_coordinate

    def timed_coordinate(prev_model, cm, cplan, *a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = refresh_coordinate(prev_model, cm, cplan, *a, **kw)
        torch.cuda.synchronize()
        coord_s[cplan.name] = time.perf_counter() - t
        return out

    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    CRF._refresh_coordinate = timed_coordinate
    try:
        t0 = time.perf_counter()
        res = CT.refresh_game_model(prev, drop, plan, configs)
        torch.cuda.synchronize()
        refresh_s = time.perf_counter() - t0
    finally:
        CRF._refresh_coordinate = refresh_coordinate
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"CR (b): drop of {drop.n} rows ({CR_DROP_ROWS} zipf(1.2) users + "
        f"{CR_NEW_ROWS} rows of {CR_NEW_USERS} new users, uniform items, "
        f"users shifted {CR_SHIFT:+g}); diff_manifest {diff_s:.3f} s; "
        f"refresh_game_model {refresh_s:.3f} s, peak device memory "
        f"{peak_gb:.3f} GB  [{gpu}]")
    for name, cp in plan.coordinates.items():
        st = res.stats[name]
        log(f"CR (b): {name}: {st.n_touched} touched ({cp.n_touched_rows} "
            f"rows), {st.n_deferred_new} deferred; buckets "
            f"{st.buckets_touched} touched, {st.buckets_skipped} skipped; "
            f"{st.solve_dispatches} solves, {st.total_iterations} "
            f"iterations, {st.n_converged} converged, {st.n_failed} failed; "
            f"{coord_s[name]:.3f} s, {cp.n_touched_rows / coord_s[name]:.6g}"
            f" touched rows/s  [{gpu}]")
    if res.stats["per_user"].n_deferred_new != CR_NEW_USERS or \
            res.stats["per_item"].n_deferred_new != 0:
        raise AssertionError(f"CR (b): deferred {res.stats}")
    for name, cp in plan.coordinates.items():
        old, new = prev.coordinates[name], res.model.coordinates[name]
        keep = np.ones(old.n_entities, bool)
        keep[old.dense_ids(cp.touched_keys.astype(np.int64))] = False
        for a, b in ((old.coefficients, new.coefficients),
                     (old.variances, new.variances)):
            if not torch.equal(a[torch.from_numpy(keep).to(dev)],
                               b[torch.from_numpy(keep).to(dev)]):
                raise AssertionError(f"CR (b): {name}: an untouched row "
                                     "changed")
        log(f"CR (b): {name}: {int(keep.sum())} untouched coefficient and "
            "variance rows equal bit for bit")
    if not torch.equal(prev.coordinates["fixed"].model.weights,
                       res.model.coordinates["fixed"].model.weights):
        raise AssertionError("CR (b): the fixed effect changed")

    # each entity whose refresh failed fails alone too: a line search at
    # the f32 floor (ROADMAP §C12), not the compaction
    col = {"per_user": (1, 3), "per_item": (2, 4)}
    offs = {name: CRF._other_scores_host(prev, drop, name)
            for name in plan.coordinates}

    def alone(name, key, cfg):
        cmn = prev.coordinates[name]
        x, ids = cols[col[name][0]], cols[col[name][1]]
        sel = np.nonzero(ids == key)[0]
        row = int(cmn.dense_ids(np.asarray([key]))[0])
        pm, pp = align_entity_priors(cmn, np.asarray([key]), GM_D_RE)
        return train_glm(make_batch(x[sel], cols[5][sel],
                                    offsets=offs[name][sel], device=dev),
                         cmn.task, cfg,
                         w0=cmn.coefficients[row].cpu().numpy(),
                         prior_mean=pm[0], prior_precision=pp[0], device=dev)

    for name, keys in res.failed_keys.items():
        alone_failed = [bool(alone(name, k, cfg_b)[1].failed)
                        for k in keys.astype(np.int64).tolist()]
        rows_of = [int((cols[col[name][1]] == k).sum())
                   for k in keys.astype(np.int64).tolist()]
        log(f"CR (b): {name}: {keys.size} failed refreshes (drop rows "
            f"{rows_of}), {sum(alone_failed)} of them fail alone "
            f"through train_glm too (the f32 floor, ROADMAP §C12)  [{gpu}]")
        if not all(alone_failed):
            raise AssertionError(f"CR (b): {name}: a failed refresh "
                                 "converges alone")

    # (b) check: touched users re-solved alone on their drop rows, with
    # their prior, warm start and offsets; and as a refresh of their own
    cm = prev.coordinates["per_user"]
    touched = plan.coordinates["per_user"].touched_keys.astype(np.int64)
    picked = np.sort(np.random.default_rng(args.seed + 12).choice(
        touched, size=GM_CHECK, replace=False))
    sub = CT.RefreshPlan({"per_user": dataclasses.replace(
        plan.coordinates["per_user"], touched_keys=picked.astype(np.str_),
        new_keys=np.asarray([], np.str_))}, drop.n, plan.n_prev_rows)
    alone_set = CT.refresh_game_model(prev, drop, sub, {"per_user": cfg_b})
    rows = cm.dense_ids(picked)
    got = res.model.coordinates["per_user"].coefficients[rows].cpu().numpy()
    own = alone_set.model.coordinates["per_user"].coefficients[
        rows].cpu().numpy()
    gaps, alone_its = [], 0
    for j, key in enumerate(picked.tolist()):
        model, r = alone("per_user", key, cfg_b)
        wa = model.coefficients.means.cpu().numpy()
        gaps.append(float(np.max(np.abs(got[j] - wa)
                                 / np.maximum(1.0, np.abs(wa)))))
        alone_its += int(r.iterations)
    shared = float(np.max(np.abs(got - own) / np.maximum(1.0, np.abs(own))))
    st = alone_set.stats["per_user"]
    log(f"CR (b): {GM_CHECK} touched users drawn from the seed, each "
        f"re-solved alone through train_glm on its drop rows with its "
        f"prior, warm start and offsets: max rel coefficient gap "
        f"{max(gaps):.3g}, iterations {alone_its} alone against "
        f"{st.total_iterations} as a refresh of those {GM_CHECK} alone, "
        f"whose coefficients are {shared:.3g} (max rel) from the full "
        f"refresh's  [{gpu}]")
    if max(gaps) > W_CHECK_RTOL or shared > W_CHECK_RTOL or \
            st.total_iterations != alone_its:
        raise AssertionError("CR (b): touched users part from their solves "
                             "alone")
    lap("CR (b)")
    res_m = gmm_refresh(prev, drop, plan, configs, res, refresh_s, dev, gpu)
    lap("GMM (c)")

    # (c) a second drop: another touched count, the same padded shapes
    baseline = len(CT.RefreshResult.signatures())
    uid2, added, (m, n_b, pad) = cr_second_users(drop, plan, dev)
    drop2, _ = cr_drop(args.seed + CR_SEED + 1, uid2, planted, CR_SHIFT)
    full2 = CT.diff_manifest(manifest, drop2, prev)
    plan2 = CT.RefreshPlan({"per_user": full2.coordinates["per_user"]},
                           full2.n_drop_rows, full2.n_prev_rows)
    t0 = time.perf_counter()
    res2 = CT.refresh_game_model(prev, drop2, plan2, {"per_user": cfg_r})
    torch.cuda.synchronize()
    refresh2_s = time.perf_counter() - t0
    refresh_launches = K.launch_counts()
    n_sigs = CT.RefreshResult.assert_no_retrace(baseline)
    log(f"CR (c): second drop of {drop2.n} rows: {added} untouched users "
        f"added with {m} rows each into the per-user bucket of height {m} "
        f"({n_b} touched, padded to {pad}): per_user touched "
        f"{plan.coordinates['per_user'].n_touched} -> "
        f"{plan2.coordinates['per_user'].n_touched}; refresh "
        f"{refresh2_s:.3f} s (per_user alone: the added rows move items "
        f"across bucket heights); {n_sigs} solve signatures, none new; "
        f"hand-written kernel launches in (b)-(c)'s refreshes "
        f"{refresh_launches or 'none'}  [{gpu}]")
    busy, wall, n_ops, top = profiled_busy(lambda: CT.refresh_game_model(
        prev, drop2, plan2, {"per_user": cfg_r}))
    log("CR (c): profiled per-user refresh: device busy "
        + ("not measured" if busy is None else
           f"{busy:.3f} s of {wall:.3f} s wall ({busy / wall:.3f} busy, "
           f"{1 - busy / wall:.3f} idle)")
        + f", {n_ops} device ops; most device time (ms, launches): "
        + "; ".join(f"{name[:60]} {us / 1e3:.3f}, {k}"
                    for name, us, k in top) + f"  [{gpu}]")
    st = res2.stats["per_user"]
    log(f"CR (c): per_user at GM's configuration (tolerance "
        f"{cfg_r.tolerance:g}): {st.n_touched} touched, "
        f"{st.total_iterations} iterations, {st.n_converged} converged, "
        f"{st.n_failed} failed (line searches that found no decrease at "
        f"the f32 floor)  [{gpu}]")

    # (d) the hot swap into a live int8 ladder under load
    live = CoefficientStore.from_game_model(prev, device=dev)
    old = CoefficientStore.from_game_model(prev, device=dev)
    # GMM (c): the mesh refresh's generation goes live
    new = CoefficientStore.from_game_model(res_m.model, device=dev)
    spec = dict(floor=8, max_batch=MAX_BATCH, output_mean=True)
    ladder = ProgramLadder(live, quantize="int8", quant_epsilon=EPSILON,
                           **spec)
    ladder.warmup()
    f32 = ProgramLadder(live, **spec)
    f32.warmup()
    reqs = cr_requests(args.seed + CR_SEED + 2, CR_REQUESTS)
    flushes: list = []
    score_padded = ladder.score_padded

    def timed_score(*a):  # host ms of each flush's upload and dispatch
        t = time.perf_counter()
        out = score_padded(*a)
        flushes.append((t, time.perf_counter() - t))
        return out

    ladder.score_padded = timed_score
    root = tempfile.mkdtemp(prefix="_drv_cr", dir=os.path.dirname(
        os.path.abspath(__file__)))
    try:
        CT.publish_store(root, live)
        probe = CT.ParityProbe(sample=64, bound=CR_PROBE_BOUND)
        t0 = time.perf_counter()
        report = CT.parity_probe(live, new, probe)
        probe_ms = (time.perf_counter() - t0) * 1e3
        parts: dict = {}

        def timed(obj, name):
            fn = getattr(obj, name)

            def wrapped(*a, **kw):
                t = time.perf_counter()
                out = fn(*a, **kw)
                parts[name] = time.perf_counter() - t
                return out

            setattr(obj, name, wrapped)

        timed(new, "save")
        timed(live, "reload_coefficients")

        def swap():
            K.reset_launch_counts()
            return CT.hot_swap(live, new, root=root, probe=probe,
                               rows_changed_unix=t_drop)

        run = serve_swapping(ladder, reqs, swap)
        cr_launches = K.launch_counts()
        gmm_count(cr_launches)
        ladder.score_padded = score_padded
        vdir = os.path.join(root, f"v{run['swap']['version']:08d}")
        lat = (run["t_ans"] - run["t_sub"]) * 1e3
        pre = run["t_ans"] < run["t_swap0"]
        post = run["t_sub"] > run["t_swap1"]
        if not np.isfinite(run["scores"]).all():
            raise AssertionError("CR (d): a request was not answered")
        post_flush = [d for t, d in flushes if t > run["t_swap1"]]
        pre_flush = [d for t, d in flushes if t < run["t_swap0"]]
        counters = telemetry.snapshot()["counters"]
        log(f"CR (d): parity probe {probe_ms:.3f} ms (max margin delta "
            f"{report.max_abs_delta:.6g} over {report.n_probes} probes, "
            f"bound {CR_PROBE_BOUND:g}); publish {parts['save']:.3f} s, "
            f"{dir_bytes(vdir)} bytes; reload "
            f"{parts['reload_coefficients'] * 1e3:.3f} ms; staleness "
            f"{run['swap']['staleness_s']:.3f} s (drop made to servable); "
            f"first post-swap flush {post_flush[0] * 1e3:.3f} ms host (it "
            f"re-quantizes the new generation) against a median "
            f"{np.median(pre_flush) * 1e3:.3f} ms before  [{gpu}]")
        log(f"CR (d): {run['idx'].size} requests from {CLIENTS} threads: before "
            f"the swap " + lat_text(lat[pre], run["t_swap0"] - run["t0"])
            + "; after it " + lat_text(lat[post],
                                       run["t_end"] - run["t_swap1"])
            + f"; {int((~pre & ~post).sum())} in flight across it; "
            f"{KS.KERNEL} launches after the swap "
            f"{cr_launches.get(KS.KERNEL, 0)}  [{gpu}]")
        if counters.get("serving.hot_swaps") != 1:
            raise AssertionError(f"CR (d): hot swaps {counters}")
        if cr_launches.get(KS.KERNEL, 0) == 0:
            raise AssertionError("CR (d): the rung kernel never launched "
                                 "after the swap")
        n_sigs = ladder.assert_no_retrace()
        rng = np.random.default_rng(args.seed + 3)
        for side, mask, store in (("before", pre, old), ("after", post,
                                                         new)):
            idx = np.nonzero(mask)[0]
            idx = np.sort(rng.choice(idx, size=min(256, idx.size),
                                     replace=False))
            picked = [reqs[i] for i in run["idx"][idx]]
            plain = ProgramLadder(store, quantize="int8",
                                  quant_epsilon=EPSILON, **spec)
            with K.scope("off"):
                want = score_direct(plain, picked)
            want32 = score_direct(ProgramLadder(store, **spec), picked)
            got = run["scores"][idx]
            np.testing.assert_allclose(got, want, **TOL,
                                       err_msg=f"CR (d) {side}")
            d32 = float(np.abs(got - want32).max())
            if d32 > EPSILON / 4:
                raise AssertionError(f"CR (d) {side}: int8 answers differ "
                                     f"from the f32 ladder by {d32}")
            log(f"CR (d): {idx.size} answers {side} the swap against the "
                f"{'old' if store is old else 'new'} generation: max |int8 "
                f"- plain int8| {float(np.abs(got - want).max()):.3g}, max "
                f"|int8 - f32| {d32:.3g}; {n_sigs} rung signatures")
        f32_gap = float(np.abs(score_direct(f32, reqs[:256])
                               - score_direct(ProgramLadder(new, **spec),
                                              reqs[:256])).max())
        if f32_gap:
            raise AssertionError("CR (d): the live f32 ladder does not "
                                 "score the new generation")

        # (e) a publish killed before the pointer, and a refused store
        cur, v = CT.open_current(root, device=dev)
        before = np.array(cur.random["per_user"].coefficients)
        with fault_plan(FaultPlan.kill_at("swap_publish", 1)):
            try:
                CT.hot_swap(None, old, root=root, probe=None)
                raise AssertionError("CR (e): the kill did not fire")
            except InjectedFault:
                pass
        cur2, v2 = CT.open_current(root, device=dev)
        if v2 != v or not np.array_equal(
                np.array(cur2.random["per_user"].coefficients), before):
            raise AssertionError("CR (e): a killed publish moved CURRENT")
        broken = CoefficientStore.from_game_model(res.model, device=dev)
        broken.random["per_user"] = dataclasses.replace(
            broken.random["per_user"],
            coefficients=broken.random["per_user"].coefficients + 1e6)
        live_before = np.array(live.random["per_user"].coefficients)
        try:
            CT.hot_swap(live, broken, probe=probe)
            raise AssertionError("CR (e): the blown-up store went live")
        except CT.SwapRefused as e:
            refused = e.report
        counters = telemetry.snapshot()["counters"]
        if counters.get("continual.swap_refusals") != 1 or \
                not np.array_equal(live.random["per_user"].coefficients,
                                   live_before):
            raise AssertionError(f"CR (e): refusal {counters}")
        log(f"CR (e): a publish killed at swap_publish#1 leaves version {v}"
            f" live with the same bytes; a store with +1e6 on its per-user "
            f"coefficients refused (max margin delta "
            f"{refused.max_abs_delta:.6g}), continual.swap_refusals 1, the "
            "live store untouched")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del live, old, new, ladder, f32

    # (f) the straggler re-solve on (a)'s per-user coordinate
    dcache, _ = est._caches_for(data)
    ds = dcache[est._dataset_key(est.coordinate_configs["per_user"])]
    offsets = torch.zeros(data.n, dtype=torch.float32, device=dev)
    for name, s in coordinate_scores(prev, data).items():
        if name != "per_user":
            offsets = offsets + s
    cfg_f2 = dataclasses.replace(cfg_r, tolerance=RE_CHECK_TOL)
    for cfg, budget in ((cfg_r, CR_BUDGET), (cfg_f2, CR_BUDGET_CHECK)):
        fits = {}
        for b in (None, budget):
            coord = RandomEffectCoordinate(ds, cm.task, cfg,
                                           straggler_budget=b)
            telemetry.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model, stats = coord.train(offsets)
            torch.cuda.synchronize()
            fits[b] = (model.coefficients.cpu().numpy(), stats,
                       time.perf_counter() - t0,
                       telemetry.snapshot()["counters"])
        (w0, s0, t_0, _), (w5, s5, t_5, c5) = fits[None], fits[budget]
        conv = s0.converged_per_entity & s5.converged_per_entity
        rel = np.max(np.abs(w5 - w0) / np.maximum(1.0, np.abs(w0)), axis=1)
        log(f"CR (f): per-user update at tolerance {cfg.tolerance:g} without"
            f" a budget {t_0:.3f} s ({s0.total_iterations} iterations, "
            f"{s0.n_converged} converged, {s0.n_failed} failed); "
            f"straggler_budget {budget} {t_5:.3f} s ({s5.total_iterations} "
            f"iterations, {s5.n_converged} converged, {s5.n_failed} failed):"
            f" {int(c5.get('game_re.straggler_entities', 0))} straggler "
            f"entities, lock-step iterations first pass "
            f"{int(c5.get('game_re.capped_lockstep_iters', 0))} + tail "
            f"{int(c5.get('game_re.tail_lockstep_iters', 0))}, "
            f"game_re.iters_saved {int(c5.get('game_re.iters_saved', 0))}; "
            f"{int(conv.sum())} entities converged in both runs: max rel "
            f"coefficient gap {rel[conv].max():.3g}, "
            f"{int((rel[conv] > 1e-5).sum())} apart beyond 1e-5; all "
            f"entities: max rel gap {rel.max():.3g}  [{gpu}]")
        # at 1e-7 both runs reach the optimum: hold the entities converged
        # in both (a tail pass restarted at the f32 floor may end "failed",
        # in the reference too: ROADMAP §C12); at RE_CHECK_TOL each run
        # stops early on its own path: hold the outcomes
        if not c5.get("game_re.straggler_entities") or (
                rel[conv].max() > RE_CHECK_TOL if cfg is cfg_r
                else s0.n_failed != s5.n_failed):
            raise AssertionError("CR (f): the straggler re-solve parts from "
                                 "the run without a budget")
    del data, est, prev_fit, Xf_dev
    torch.cuda.empty_cache()
    log(f"CR: {time.perf_counter() - t_phase:.1f} s  [{gpu}]")
    return refresh_launches, cr_launches


# ------------------------------------------------ phase HY: hybrid layouts
HY_TIMES: dict = {}  # row 4's and row 5's unrounded timings, by kernel


def hy_count(launches: dict) -> None:
    for name, c in launches.items():
        HY_LAUNCHES[name] = HY_LAUNCHES.get(name, 0) + c


def layout_gb(X) -> float:
    """The bytes of every tensor of a layout, GB."""
    total = 0
    for f in dataclasses.fields(X):
        v = getattr(X, f.name)
        for t in (v if isinstance(v, tuple) else (v,)):
            if hasattr(t, "element_size"):
                total += t.numel() * t.element_size()
    return total / 1e9


def row_sum_errors(sums, contrib, bounds, sample) -> tuple:
    """How per-row sums ``sums`` (n,) of flat f32 products ``contrib``,
    row i spanning ``bounds[i]:bounds[i + 1]`` (numpy arrays), stand on
    the ``sample`` rows against f64 sums of the same products: (max |err|,
    max |err| over the row's sum of |products| on rows with a nonzero
    product, the rows whose products are all zero that come out nonzero,
    the largest |prefix sum| a difference of prefix sums cancels, and the
    max |err| of a plain f32 sum of each row's own products in order: how
    a per-row reduction rounds)."""
    c = contrib.astype(np.float64)
    exact = np.array([c[bounds[i]:bounds[i + 1]].sum() for i in sample])
    scale = np.array([np.abs(c[bounds[i]:bounds[i + 1]]).sum()
                      for i in sample])
    own = np.array([np.sum(contrib[bounds[i]:bounds[i + 1]],
                           dtype=np.float32) for i in sample], np.float64)
    err = np.abs(sums[sample] - exact)
    live = scale > 0
    return (float(err.max()), float((err[live] / scale[live]).max()),
            int(((~live) & (err > 0)).sum()),
            float(np.abs(np.cumsum(c)).max()),
            float(np.abs(own - exact).max()))


def tail_errors(X, w, sample: np.ndarray) -> tuple:
    """`row_sum_errors` of a flat-tail layout's per-row tail sums on its
    device (`HybridRows`: w original, the sorted segments of its tail;
    `PermutedHybridRows`: w permuted, prefix-sum differences over
    ``row_bounds``)."""
    import torch

    from photon_tpu_torch.data import matrix as M

    n = int(X.shape[0])
    if isinstance(X, M.PermutedHybridRows):
        contrib = M._gather_product(X.tail_vals, w, X.tail_pcols)
        bounds = X.row_bounds.long()
    else:
        contrib = M._gather_product(X.tail_vals, w, X.tail_cols)
        bounds = torch.searchsorted(
            X.tail_rows, torch.arange(n + 1, dtype=torch.int32,
                                      device=w.device)).long()
    tail = M._tail_rowsum(contrib, bounds)
    return row_sum_errors(tail.cpu().numpy(), contrib.cpu().numpy(),
                          bounds.cpu().numpy(), sample)


def exact_margins(ind, va, w, sample: np.ndarray) -> tuple:
    """(f64 margins, f64 sums of |terms|) of the COO rows ``sample`` for
    original-space ``w``."""
    t = va[sample].astype(np.float64) * w.astype(np.float64)[ind[sample]]
    return t.sum(1), np.abs(t).sum(1)


def hybrid_tail_csr(X, transpose: bool):
    """A `PermutedHybridRows`' tail as an f32 CSR (n, U), or its transpose,
    on its device — cuSPARSE's operand for the library yardstick."""
    import torch

    n, U = int(X.shape[0]), X.n_prefix - X.d_sel
    counts = (X.row_bounds[1:] - X.row_bounds[:-1]).long()
    m = int(X.row_bounds[-1])
    r = torch.repeat_interleave(torch.arange(n, device=counts.device),
                                counts)
    c = X.tail_pcols[:m].long() - X.d_sel
    v = X.tail_vals[:m].float()
    if transpose:
        r, c, n, U = c, r, U, n
    return torch.sparse_coo_tensor(torch.stack([r, c]), v, (n, U)) \
        .coalesce().to_sparse_csr()


def passes_repeat(X, w, r, label: str, calls: int = 5) -> None:
    """Raise unless ``calls`` Xᵀr of ``r`` (and matvecs of ``w``) give the
    same bits."""
    import torch

    from photon_tpu_torch.data import matrix as M

    for name, fn, v in (("Xᵀr", M.rmatvec, r), ("matvec", M.matvec, w)):
        first = fn(X, v)
        for _ in range(calls - 1):
            if not torch.equal(fn(X, v), first):
                raise AssertionError(f"{label}: the {name} moved between "
                                     "calls")


def phase_hybrid(t2: dict, dev, gpu) -> None:
    """HY: the hybrid and permuted-hybrid layouts on T2's data, (a)-(e).
    (a)'s and (b)'s layouts are built first; the sharded permuted layout
    of (d) is then built on the host in a thread beside (a)-(c)'s checks,
    and every timing but the builds' is taken after it has ended."""
    import torch

    from photon_tpu_torch.data import matrix as M
    from photon_tpu_torch.data.dataset import (cast_features, make_batch,
                                               shard_permuted_batch)

    ind, va, y = t2["coo"]
    X = M.SparseRows(ind, va, T_FEATURES)
    builds = []
    for build in (M.to_permuted_hybrid, M.to_hybrid):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = cast_features(make_batch(build(
            X, T_DENSE, device_dense_dtype=torch.bfloat16, device=dev), y,
            device=dev))
        torch.cuda.synchronize()
        builds.append((b, time.perf_counter() - t0))
    built: dict = {}

    def build_sp():
        t0 = time.perf_counter()
        try:
            host = make_batch(M.SparseRows(ind, va, T_FEATURES), y,
                              device="cpu")
            built["sp"] = cast_features(shard_permuted_batch(
                host, MG_SLOTS, T_DENSE, device_dense_dtype=torch.bfloat16))
        except BaseException as e:  # raised in the main thread below
            built["sp"] = e
        built["s"] = time.perf_counter() - t0

    th = threading.Thread(target=build_sp)
    th.start()
    try:
        _phase_hybrid(t2, dev, gpu, builds, th, built)
    finally:
        th.join()


def _phase_hybrid(t2: dict, dev, gpu, builds: list, th,
                  built: dict) -> None:
    import torch

    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.data import matrix as M
    from photon_tpu_torch.data.dataset import (GLMBatch, make_batch,
                                               mesh_batch)
    from photon_tpu_torch.kernels import blocked_ell as KB
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l2
    from photon_tpu_torch.parallel.mesh import make_mesh

    ind, va, y = t2["coo"]
    rows, d = int(ind.shape[0]), T_FEATURES
    rng = np.random.default_rng(41)
    sample = np.sort(rng.choice(rows, HY_SAMPLE, replace=False))
    w_model = t2["w40_model"]
    cfg = OptimizerConfig(max_iters=HY_ITERS, tolerance=0.0, reg=l2(),
                          reg_weight=T_REG, history=T_HISTORY)
    gen = torch.Generator(device=dev).manual_seed(43)
    (bp, build_a), (bh, build_b) = builds

    # (a) the permuted hybrid at full width, every value leaf bf16
    P = bp.X
    U = P.n_prefix - P.d_sel
    occ = sum(int(v.numel()) for v in P.bucket_vals)
    log(f"HY (a): PermutedHybridRows of T2's rows built in {build_a:.1f} s "
        f"(host + device, hot block on the card); {layout_gb(P):.3f} GB on "
        f"the card; flat tail {int(P.row_bounds[-1])} entries, U {U}, "
        f"{len(P.bucket_vals)} occurrence buckets, {occ} bucket slots "
        f"({occ / max(int(P.row_bounds[-1]), 1) - 1:.4f} padding)  [{gpu}]")
    err = 0.0
    for lanes in (1, 8):
        shape = (rows,) if lanes == 1 else (rows, lanes)
        r = torch.randn(shape, generator=gen, device=dev)
        for sq in (False, True):
            want = KB.bucket_rmatvec_reference(P, r, square=sq,
                                               round_r=False)
            got = [form(P, r, square=sq, round_r=False)
                   for form in (KB.bucket_rmatvec, KB.bucket_rmatvec_tiled)]
            torch.cuda.synchronize()
            for g in got:
                np.testing.assert_allclose(
                    g.cpu().numpy(), want.cpu().numpy(), **TOL,
                    err_msg=f"HY (a) rmatvec {lanes} lanes square={sq}")
                err = max(err, float((g - want).abs().max()))
            if not torch.equal(got[0], got[1]):
                raise AssertionError("HY (a): fused and tiled rmatvec differ")
            fn = M.sq_rmatvec if sq else M.rmatvec
            whole = fn(P, r)
            with K.scope("off"):
                plain = fn(P, r)
            scale = float(plain.abs().max())
            np.testing.assert_allclose(
                whole.cpu().numpy(), plain.cpu().numpy(), rtol=1e-5,
                atol=1e-5 * scale, err_msg=f"HY (a) Xᵀr {lanes} lanes")
    wp = P.from_model_space(torch.from_numpy(w_model).to(dev))
    t_abs, t_rel, t_zero, t_pre, t_own = tail_errors(P, wp, sample)
    log(f"HY (a): rows 4 and 5 at the unrounded instantiation (bf16 values "
        f"by an f32 cotangent), 1 and 8 lanes, square off and on, agree "
        f"with their plain versions within rtol=atol=1e-5 (max |err| "
        f"{err:.3g}), fused and tiled bit for bit; the whole Xᵀr and "
        f"(X∘X)ᵀr against scope('off') within 1e-5 of the largest output; "
        f"flat-tail row sums (T2 (a)'s 40th w) on {HY_SAMPLE} rows against "
        f"f64: max |err| {t_abs:.3g}, {t_rel:.3g} of the row's sum of "
        f"|products|, {t_zero} all-zero rows nonzero, largest |prefix sum| "
        f"{t_pre:.6g}; a per-row f32 sum of the same products (host) "
        f"{t_own:.3g}  [{gpu}]")

    # the main path: counts reset just before, read just after
    K.reset_launch_counts()
    model_a, res_a, _ = solve_timed(bp, cfg, dev)
    la = K.launch_counts()
    hy_count(la)
    if la.get(KB.RMATVEC, 0) == 0 or set(la) != {KB.RMATVEC}:
        raise AssertionError(f"HY (a): the solve launched {la}")
    ha = res_a.history()
    if not np.isfinite(ha).all() or not ha[-1] < ha[0]:
        raise AssertionError(f"HY (a): loss history {ha}")
    w_a = model_a.coefficients.means.cpu().numpy()
    z = model_a.score(P).cpu().numpy()[sample]
    ex, sc = exact_margins(ind, va, w_a, sample)
    z_rel = float((np.abs(z - ex) / np.maximum(sc, 1e-30)).max())
    if z_rel > 1e-2:
        raise AssertionError(f"HY (a): the model's margins are {z_rel:.3g} "
                             "of the row scale off its f64 margins")
    K.reset_launch_counts()
    _, res_t, _ = with_budget("0", lambda: solve_timed(bp, cfg, dev))
    lt = K.launch_counts()
    hy_count(lt)
    if lt.get(KB.RMATVEC_TILED, 0) == 0 or set(lt) != {KB.RMATVEC_TILED}:
        raise AssertionError(f"HY (a): the tiled solve launched {lt}")
    gap_t = histories_agree("HY (a) tiled vs fused", ha, res_t.history())
    r1 = torch.randn(rows, generator=gen, device=dev)
    r8 = torch.randn((rows, 8), generator=gen, device=dev)
    w8 = torch.randn((d, 8), generator=gen, device=dev) * 0.01
    passes_repeat(P, wp, r1, "HY (a)")
    passes_repeat(P, w8, r8, "HY (a) 8 lanes")
    log(f"HY (a): {HY_ITERS}-iteration L-BFGS train_glm, loss {ha[0]:.7g} "
        f"-> {ha[-1]:.7g}, launches {la}; its model (original column "
        f"order) scores the layout within {z_rel:.3g} of the row scale of "
        f"f64 margins; the tiled forms (budget 0) launches {lt}, history "
        f"within {gap_t:.3g}; 5 Xᵀr and 5 matvec calls (1 and 8 lanes) bit "
        f"for bit  [{gpu}]")

    # (b) the hybrid at the same widths, hot block built on the card
    H = bh.X
    gaps = []
    for lanes in (1, 8):
        shape = (d,) if lanes == 1 else (d, lanes)
        w = torch.randn(shape, generator=gen, device=dev) * 0.01
        r = r1 if lanes == 1 else r8
        pairs = ((M.matvec(H, w), M.matvec(P, P.from_model_space(w))),
                 (M.rmatvec(H, r), P.to_model_space(M.rmatvec(P, r))),
                 (M.sq_rmatvec(H, r), P.to_model_space(M.sq_rmatvec(P, r))))
        for k, (got, want) in enumerate(pairs):
            scale = float(want.abs().max())
            gap = float((got - want).abs().max()) / scale
            np.testing.assert_allclose(
                got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5,
                atol=1e-5 * scale, err_msg=f"HY (b) pass {k}, {lanes} lanes")
            gaps.append(gap)
    K.reset_launch_counts()
    _, res_b, _ = solve_timed(bh, cfg, dev)
    if K.launch_counts():
        raise AssertionError(f"HY (b) launched {K.launch_counts()}")
    gap_b = histories_agree("HY (b) vs (a)", ha, res_b.history())
    passes_repeat(H, torch.from_numpy(w_model).to(dev), r1, "HY (b)")
    passes_repeat(H, w8, r8, "HY (b) 8 lanes")
    h_abs, h_rel, h_zero, h_pre, h_own = tail_errors(
        H, torch.from_numpy(w_model).to(dev), sample)
    log(f"HY (b): HybridRows built in {build_b:.1f} s, {layout_gb(H):.3f} "
        f"GB on the card; matvec, Xᵀr and (X∘X)ᵀr (1 and 8 lanes) against "
        f"(a)'s within {max(gaps):.3g} of the largest output; "
        f"{HY_ITERS}-iteration solve's history within {gap_b:.3g} of "
        f"(a)'s; 5 Xᵀr and matvec calls (1 and 8 lanes) bit "
        f"for bit; tail row sums against f64: max |err| {h_abs:.3g}, "
        f"{h_rel:.3g} of the row's sum of |products|, {h_zero} all-zero "
        f"rows nonzero, largest |prefix sum| {h_pre:.6g}; a per-row f32 "
        f"sum {h_own:.3g}  [{gpu}]")

    # (c) the cross-layout check at f32 storage
    n_c = HY_C_ROWS
    Xc = M.SparseRows(ind[:n_c], va[:n_c], d)
    layouts = {"BlockedEllRows": M.to_blocked_ell(Xc, T_DENSE, device=dev),
               "HybridRows": M.to_hybrid(Xc, T_DENSE, device=dev),
               "PermutedHybridRows": M.to_permuted_hybrid(Xc, T_DENSE,
                                                          device=dev)}
    hist, errs = {}, {}
    s_c = np.sort(rng.choice(n_c, HY_SAMPLE, replace=False))
    for name, L in layouts.items():
        b = make_batch(L, y[:n_c], device=dev)
        m, res, _ = solve_timed(b, cfg, dev)
        hist[name] = res.history()
        w_c = m.coefficients.means.cpu().numpy()
        ex, sc = exact_margins(ind, va, w_c, s_c)
        z = m.score(L).cpu().numpy()[s_c]
        errs[name] = (float(np.abs(z - ex).max()),
                      float((np.abs(z - ex) / np.maximum(sc, 1e-30)).max()))
    gap_c = max(histories_agree(f"HY (c) {name} vs BlockedEllRows",
                                hist["BlockedEllRows"], h)
                for name, h in hist.items())
    log(f"HY (c): {n_c} rows at f32 storage: {HY_ITERS}-iteration "
        f"histories of HybridRows and PermutedHybridRows within {gap_c:.3g} "
        f"of BlockedEllRows'; each model's margins on its layout against "
        f"f64 on {HY_SAMPLE} rows (max |err|, of the row's sum of |terms|): "
        + "; ".join(f"{k} {a:.3g}, {b:.3g}" for k, (a, b) in errs.items())
        + f"  [{gpu}]")
    del layouts
    torch.cuda.empty_cache()

    # the timings, with the host build of (d) ended
    th.join()
    if isinstance(built.get("sp"), BaseException):
        raise built["sp"]
    _, _, wall_a = solve_timed(bp, cfg, dev)
    _, _, wall_b = solve_timed(bh, cfg, dev)
    log(f"HY (a), (b): {HY_ITERS}-iteration solves timed after (d)'s host "
        f"build: PermutedHybridRows {wall_a:.3f} s "
        f"({rows * HY_ITERS / wall_a:.6g} rows*iters/s), HybridRows "
        f"{wall_b:.3f} s ({rows * HY_ITERS / wall_b:.6g})  [{gpu}]")
    csr_t = hybrid_tail_csr(P, transpose=True)
    for name, form in ((KB.RMATVEC, KB.bucket_rmatvec),
                       (KB.RMATVEC_TILED, KB.bucket_rmatvec_tiled)):
        out = {}
        for lanes, r in ((1, r1), (8, r8)):
            bound_ms, bound_by = blocked_ell_bounds(P, lanes)[name]
            with K.scope("on"):
                ms = time_ms(lambda: form(P, r, round_r=False), n=50,
                             warm=5)
                ev = events_ms(lambda: form(P, r, round_r=False),
                               cold=False)
                ev_cold = events_ms(lambda: form(P, r, round_r=False),
                                    cold=True)
            plain = time_ms(lambda: KB.bucket_rmatvec_reference(
                P, r, round_r=False), n=10, warm=2)
            rr = r if lanes > 1 else r[:, None]
            lib = time_ms(lambda: torch.sparse.mm(csr_t, rr), n=20, warm=3)
            key = "hy" if lanes == 1 else "hy_lanes8"
            out.update({f"{key}_ms": ms, f"{key}_device_ms_events": ev,
                        f"{key}_device_ms_cold": ev_cold,
                        f"{key}_plain_ms": plain, f"{key}_library_ms": lib,
                        f"{key}_bound_ms": bound_ms,
                        f"{key}_bound_by": bound_by})
            log(f"HY (a): {name} unrounded at {lanes} lane(s): {ms:.4f} ms "
                f"per call, {ev:.4f} ms device warm, {ev_cold:.4f} cold "
                f"(events); plain {plain:.4f} ms; cuSPARSE f32 CSR "
                f"{lib:.4f} ms; bound {bound_ms:.4f} ms  [{gpu}]")
        HY_TIMES[name] = out
    del csr_t

    # (d) the sharded pair on MG_SLOTS slots of the card
    sp = built["sp"]
    S = MG_SLOTS
    occ_s = sum(int(v.numel()) for v in sp.X.bucket_vals)
    log(f"HY (d): ShardedPermutedHybridRows for {S} slots built in "
        f"{built['s']:.1f} s on the host beside (a)-(c)'s checks; "
        f"reckoned bucket slots {occ_s} ({occ_s * 6 / 1e9:.3f} GB at 4 + 2 "
        f"B a slot) "
        f"against one device's {occ} ({occ * 6 / 1e9:.3f} GB): "
        f"{occ_s / occ:.2f}x, every slot carrying all {U} bucket columns; "
        f"the whole layout {layout_gb(sp.X):.3f} GB  [{gpu}]")
    mesh = make_mesh(n_devices=S)
    t0 = time.perf_counter()
    mb_p = mesh_batch(sp, mesh)
    mb_h = mesh_batch(GLMBatch(M.shard_hybrid(H, S), bh.y, bh.weights,
                               bh.offsets), mesh)
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t0
    del sp, built["sp"]
    err_d = 0.0
    for part in mb_p.X.parts:
        n_l = int(part.shape[0])
        for lanes in (1, 8):
            r = torch.randn((n_l,) if lanes == 1 else (n_l, lanes),
                            generator=gen, device=dev)
            for sq in (False, True):
                got = KB.bucket_rmatvec(part, r, square=sq, round_r=False)
                want = KB.bucket_rmatvec_reference(part, r, square=sq,
                                                   round_r=False)
                torch.cuda.synchronize()
                np.testing.assert_allclose(
                    got.cpu().numpy(), want.cpu().numpy(), **TOL,
                    err_msg=f"HY (d) slot rmatvec {lanes} lanes")
                err_d = max(err_d, float((got - want).abs().max()))
    out = {}
    for label, mb, h_one in (("ShardedPermutedHybridRows", mb_p, ha),
                             ("ShardedHybridRows", mb_h, res_b.history())):
        K.reset_launch_counts()
        _, res, wall = mesh_solve(mb, cfg, mesh)
        lc = K.launch_counts()
        hy_count(lc)
        gap = histories_agree(f"HY (d) {label} vs one device", h_one,
                              res.history())
        out[label] = (wall, lc, gap)
    lp = out["ShardedPermutedHybridRows"][1]
    if lp.get(KB.RMATVEC, 0) == 0 or lp[KB.RMATVEC] % S:
        raise AssertionError(f"HY (d): row 4 launched {lp}, not once per "
                             f"slot and pass of {S} slots")
    if out["ShardedHybridRows"][1]:
        raise AssertionError("HY (d): the hybrid mesh launched "
                             f"{out['ShardedHybridRows'][1]}")
    log(f"HY (d): both on {S} slots (uploaded in {up_s:.2f} s); every "
        f"slot's rmatvec (1 and 8 lanes, square off and on, unrounded) "
        f"against its plain version within rtol=atol=1e-5 (max |err| "
        f"{err_d:.3g}); "
        + "; ".join(f"{k}: {HY_ITERS} iterations in {w:.3f} s, launches "
                    f"{lc or 'none'}, history within {g:.3g} of one "
                    f"device's" for k, (w, lc, g) in out.items())
        + f"  [{gpu}]")
    del mb_p, mb_h, H, bh
    torch.cuda.empty_cache()

    # (e) bench.py's 8-lane grid on (a)'s layout
    gcfg = OptimizerConfig(max_iters=T_ITERS, tolerance=0.0, reg=l2(),
                           reg_weight=0.0, history=T_HISTORY,
                           lane_history_dtype="bfloat16")
    K.reset_launch_counts()
    (res_g, _), wall_g = grid_timed(bp, gcfg, S_GRID, dev,
                                    device_results=True)
    lg = K.launch_counts()
    hy_count(lg)
    its = res_g.iterations.cpu().numpy()
    for i, h in enumerate(lane_histories(res_g)):
        if not np.isfinite(h).all() or not h[-1] < h[0]:
            raise AssertionError(f"HY (e) lane {i}: loss history {h}")
    if lg.get(KB.RMATVEC, 0) == 0:
        raise AssertionError(f"HY (e): the grid launched {lg}")
    rate = rows * int(its.sum()) / wall_g
    log(f"HY (e): the {len(S_GRID)}-lane grid (S_GRID, history "
        f"{T_HISTORY} bf16, tolerance 0) on (a)'s layout: per-lane "
        f"iterations {its.tolist()} in {wall_g:.3f} s: {rate:.6g} "
        f"rows*sum(iters)/s against G (a)'s {GRID_RATE.get('G', 0.0):.6g} "
        f"on BlockedEllRows ({rate / GRID_RATE['G']:.3f}x); trials "
        f"{res_g.trials}; launches {lg}  [{gpu}]")
    del res_g, bp, P
    torch.cuda.empty_cache()


# ------------------------------------------------ phase CK: elastic runs
# CK's kernel launches, summed over its legs (each reset just before and
# read just after): (a)'s armed runs and resumed legs, (b)'s and (c)'s
# resumed fits, (d)'s tapped solve
CK_LAUNCHES: dict = {}


def ck_count(launches: dict) -> None:
    for name, c in launches.items():
        CK_LAUNCHES[name] = CK_LAUNCHES.get(name, 0) + c


def ck_dir(tag: str) -> str:
    """A fresh snapshot directory beside this script (gitignored as
    ``_drv*``); each leg removes its own."""
    import tempfile

    return tempfile.mkdtemp(prefix=f"_drv_ck_{tag}_", dir=os.path.dirname(
        os.path.abspath(__file__)))


def ck_killed(ckdir: str, site: str, occ: int, run, **session) -> None:
    """Run ``run`` under a session with a kill armed at ``site``#``occ``;
    it must die there, in this process (the session is closed on the way
    out, as a driver's ``finally`` closes it)."""
    from photon_tpu_torch import checkpoint

    try:
        with checkpoint.session(ckdir, **session):
            with checkpoint.fault_plan(
                    checkpoint.FaultPlan.kill_at(site, occ)):
                run()
    except checkpoint.InjectedFault as e:
        if (e.site, e.occurrence) != (site, occ):
            raise
        return
    raise AssertionError(f"CK: no kill at {site}#{occ}")


def ck_resumed(ckdir: str, run, **session) -> tuple:
    """(what ``run`` returns, restore s: the session's load of the last
    commit) under a fresh session resuming from ``ckdir``."""
    from photon_tpu_torch import checkpoint

    t0 = time.perf_counter()
    checkpoint.start_session(ckdir, **session)
    restore_s = time.perf_counter() - t0
    try:
        out = run()
    finally:
        checkpoint.finish_session()
    return out, restore_s


def ck_snap_facts(c: dict) -> str:
    n = max(int(c.get("checkpoint.snapshots", 0)), 1)
    return (f"{int(c.get('checkpoint.snapshots', 0))} snapshots of "
            f"{c.get('checkpoint.bytes', 0) / n / 1e6:.1f} MB, pack "
            f"{c.get('checkpoint.pack_seconds', 0) / n * 1e3:.2f} ms (the "
            f"caller's part), commit "
            f"{c.get('checkpoint.commit_seconds', 0) / n:.3f} s each")


def phase_ck_streamed(cb, res_owlqn, cfg_owlqn, owlqn_evals: int, dev,
                      gpu) -> None:
    """CK (a): streamed L-BFGS on S's ladder (T2's full width, the default
    kernel route, tolerance 0, CK_ITERS iterations) session-less, armed
    and unkilled (a synchronous and an asynchronous writer), killed at its
    middle ``evaluation``, its middle ``chunk_upload``, ``snapshot_write``
    #2 and ``commit`` #2 and each resumed in this process; streamed OWL-QN
    (S (b)'s run the reference; ``owlqn_evals`` its evaluation-site hits,
    one a feature stream) killed at its middle evaluation and resumed. Every armed and resumed result equals the session-less one
    bit for bit."""
    import shutil

    import torch

    from photon_tpu_torch import checkpoint, telemetry
    from photon_tpu_torch.kernels import blocked_ell as KB
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l2

    t_phase = time.perf_counter()
    cfg = OptimizerConfig(max_iters=CK_ITERS, tolerance=0.0, reg=l2(),
                          reg_weight=T_REG, history=T_HISTORY)
    with checkpoint.record_sites() as rec:
        _, plain, plain_s, _, _, _, _ = streamed_solve(cb, cfg, dev)
    sites = dict(rec.hits)
    every = max(sites["evaluation"] // CK_SNAPSHOTS, 1)
    rows_iters = T_ROWS * plain.iterations

    def same(label, res, want=plain):
        if not (torch.equal(res.w, want.w)
                and np.array_equal(res.loss_history.cpu().numpy(),
                                   want.loss_history.cpu().numpy())
                and res.iterations == want.iterations):
            raise AssertionError(f"CK (a) {label}: not the session-less "
                                 "result bit for bit")

    armed = {}
    for mode in ("sync", "async"):
        d = ck_dir("a")
        try:
            with checkpoint.session(d, every_evals=every, every_s=None,
                                    async_writer=mode == "async",
                                    keep=CK_KEEP):
                _, res, wall, la, _, _, peak = streamed_solve(cb, cfg, dev)
                t0 = time.perf_counter()
            drain_s = time.perf_counter() - t0  # the session's close
            same(f"armed ({mode})", res)
            ck_count(la)
            armed[mode] = (wall, dict(telemetry.snapshot()["counters"]),
                           drain_s, peak)
        finally:
            shutil.rmtree(d, ignore_errors=True)
    ws, tele_s, _, peak_s = armed["sync"]
    wa, tele_a, drain_a, peak_a = armed["async"]
    log(f"CK (a): streamed L-BFGS at T2's width, {plain.iterations} "
        f"iterations, {sites['evaluation']} evaluations, "
        f"{sites['chunk_upload']} chunk uploads: session-less "
        f"{plain_s:.3f} s ({rows_iters / plain_s:.6g} rows*iters/s); armed "
        f"every {every} evaluations, sync writer {ws:.3f} s "
        f"({rows_iters / ws:.6g}, {ws / plain_s:.3f}x; "
        f"{ck_snap_facts(tele_s)}; peak {peak_s:.3f} GB), async writer "
        f"{wa:.3f} s ({rows_iters / wa:.6g}, {wa / plain_s:.3f}x; "
        f"{ck_snap_facts(tele_a)}; the close drained {drain_a:.3f} s; "
        f"peak {peak_a:.3f} GB); both bit for bit  [{gpu}]")

    session = dict(every_evals=every, every_s=None, async_writer=False,
                   keep=CK_KEEP)
    legs = [("evaluation", (sites["evaluation"] + 1) // 2),
            ("chunk_upload", (sites["chunk_upload"] + 1) // 2),
            ("snapshot_write", 2), ("commit", 2)]
    for site, occ in legs:
        d = ck_dir("a")
        try:
            ck_killed(d, site, occ, lambda: streamed_solve(cb, cfg, dev),
                      **session)
            seq = checkpoint.SnapshotStore(d).latest_seq()
            out, restore_s = ck_resumed(
                d, lambda: streamed_solve(cb, cfg, dev), **session)
            _, res, wall, la, tele, builds, _ = out
            same(f"resumed after {site}#{occ}", res)
            for name in (KB.TAIL, KB.RMATVEC):
                if la.get(name, 0) == 0:
                    raise AssertionError(f"CK (a) {site}#{occ}: {name} "
                                         "never launched after the resume")
            if tele.get("checkpoint.solver_restores") != 1:
                raise AssertionError(f"CK (a) {site}#{occ}: no solver "
                                     "restore counted")
            ck_count(la)
            log(f"CK (a): killed at {site}#{occ}, resumed from snapshot "
                f"{seq} (restore {restore_s:.3f} s) in {wall:.3f} s, bit "
                f"for bit; launches {la}, plan builds {builds}  [{gpu}]")
        finally:
            shutil.rmtree(d, ignore_errors=True)

    d = ck_dir("a")
    try:
        n_eval = owlqn_evals
        occ = (n_eval + 1) // 2
        ck_killed(d, "evaluation", occ,
                  lambda: streamed_solve(cb, cfg_owlqn, dev), **session)
        out, restore_s = ck_resumed(
            d, lambda: streamed_solve(cb, cfg_owlqn, dev), **session)
        _, res, wall, la, _, _, _ = out
        same("OWL-QN resumed", res, res_owlqn)
        ck_count(la)
        log(f"CK (a): streamed OWL-QN killed at evaluation#{occ} of "
            f"{n_eval}, resumed (restore {restore_s:.3f} s) in {wall:.3f} "
            f"s, equal to S (b) bit for bit; launches {la}  [{gpu}]")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    log(f"CK (a): {time.perf_counter() - t_phase:.1f} s  [{gpu}]")


def phase_ck_game(est_gm, data, dev, gpu) -> None:
    """CK (b): GM at full width (2 sweeps, every solve stopped at
    RE_CHECK_TOL, ``straggler_budget`` CR_BUDGET_CHECK): session-less
    fits at ``pipeline_depth`` 1, 0 and 2 (equal bit for bit), an armed
    unkilled fit (async writer), kills at the middle ``bucket_retire``
    and at a mid-run ``commit`` each resumed — every model and objective
    history equal to the session-less fit's."""
    import shutil

    from photon_tpu_torch import checkpoint, telemetry
    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.game.estimator import RandomEffectConfig

    t_phase = time.perf_counter()

    def estimator(depth: int):
        cfgs = {}
        for name, c in est_gm.coordinate_configs.items():
            c = dataclasses.replace(c, optimizer=dataclasses.replace(
                c.optimizer, tolerance=RE_CHECK_TOL))
            if isinstance(c, RandomEffectConfig):
                c = dataclasses.replace(c, pipeline_depth=depth,
                                        straggler_budget=CR_BUDGET_CHECK)
            cfgs[name] = c
        est = dataclasses.replace(est_gm, coordinate_configs=cfgs)
        est._caches[id(data)] = est_gm._caches[id(data)]  # GM's buckets
        return est

    def fit(depth: int):
        telemetry.reset()
        K.reset_launch_counts()
        res, wall = fit_timed(estimator(depth), data)
        return (res, wall, dict(telemetry.snapshot()["counters"]),
                K.launch_counts())

    def same(label, got, want):
        # the models and objective histories bit for bit (scores are a
        # function of the model: re-scoring 10M rows a comparison, ~4 s
        # each on the host's entity lookups, was cut for phase MG's time)
        if not (models_equal(want.model, got.model)
                and want.descent.objective_history
                == got.descent.objective_history):
            raise AssertionError(f"CK (b) {label}: not the session-less "
                                 "fit bit for bit")

    with checkpoint.record_sites() as rec:
        ref, wall1, c1, _ = fit(1)
    retires = rec.hits["bucket_retire"]
    n_updates = len(ref.descent.objective_history)
    every = max((retires + n_updates) // CK_SNAPSHOTS, 1)
    walls = {1: wall1}
    for depth in (0, 2):
        got, walls[depth], c, _ = fit(depth)
        same(f"pipeline_depth {depth}", got, ref)
    log(f"CK (b): GM at {GM_ROWS} rows, {GM_SWEEPS} sweeps, solves at "
        f"{RE_CHECK_TOL:g}, straggler_budget {CR_BUDGET_CHECK}: "
        f"{retires} bucket retires, {n_updates} updates; fit s at "
        f"pipeline_depth 1 {walls[1]:.3f}, 0 {walls[0]:.3f}, 2 "
        f"{walls[2]:.3f} (no claim), depths 0 and 2 equal to 1 bit for "
        f"bit; {int(c1.get('game_re.straggler_entities', 0))} straggler "
        f"entities  [{gpu}]")

    d = ck_dir("b")
    try:
        with checkpoint.session(d, every_evals=every, every_s=None,
                                keep=CK_KEEP):
            armed, wall_a, _, _ = fit(1)
        same("armed", armed, ref)
        log(f"CK (b): armed every {every} evaluations (async writer): "
            f"{wall_a:.3f} s ({wall_a / walls[1]:.3f}x the session-less "
            f"fit); {ck_snap_facts(telemetry.snapshot()['counters'])}; bit "
            f"for bit  [{gpu}]")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    # the kill legs snapshot at every retire and update, so the middle
    # retire's resume finds a live random-effect update in the snapshot
    session = dict(every_evals=1, every_s=None, async_writer=False,
                   keep=CK_KEEP)
    for site, occ in (("bucket_retire", (retires + 1) // 2),
                      ("commit", (retires + n_updates + 1) // 2)):
        d = ck_dir("b")
        try:
            ck_killed(d, site, occ, lambda: fit(1), **session)
            out, restore_s = ck_resumed(d, lambda: fit(1), **session)
            got, wall, c, la = out
            same(f"resumed after {site}#{occ}", got, ref)
            ck_count(la)
            log(f"CK (b): killed at {site}#{occ}, resumed (restore "
                f"{restore_s:.3f} s) in {wall:.3f} s, bit for bit: "
                f"checkpoint.descent_restores "
                f"{int(c.get('checkpoint.descent_restores', 0))}, "
                f"checkpoint.re_restores "
                f"{int(c.get('checkpoint.re_restores', 0))}, "
                f"{ck_snap_facts(c)}  [{gpu}]")
        finally:
            shutil.rmtree(d, ignore_errors=True)
    log(f"CK (b): {time.perf_counter() - t_phase:.1f} s  [{gpu}]")


def phase_ck_driver(root: str, params: dict, out, retires: int, dev,
                    gpu) -> None:
    """CK (c): DRV (a)'s `run_training` again with ``checkpoint_dir``
    (every evaluation, the async writer), killed at its middle
    ``bucket_retire`` and rerun with the same params: ``best_model/``
    equals DRV (a)'s uncheckpointed one bit for bit (the checkpoint
    selftest runs in PF (c))."""
    import torch

    from photon_tpu_torch import checkpoint, telemetry
    from photon_tpu_torch import drivers as D
    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.data.model_io import load_game_model

    t_phase = time.perf_counter()
    p = D.TrainingParams(**{
        **params, "output_dir": os.path.join(root, "train_ck"),
        "checkpoint_dir": "ck", "checkpoint_every_s": None,
        "checkpoint_every_evals": 1})
    occ = (retires + 1) // 2
    t0 = time.perf_counter()
    with checkpoint.fault_plan(checkpoint.FaultPlan.kill_at("bucket_retire",
                                                            occ)):
        try:
            D.run_training(p, device=dev)
            raise AssertionError("CK (c): the training driver was not "
                                 "killed")
        except checkpoint.InjectedFault:
            pass
    killed_s = time.perf_counter() - t0
    if checkpoint.current() is not None:
        raise AssertionError("CK (c): the killed driver left its session "
                             "open")
    ckdir = os.path.join(root, "train_ck", "ck")
    seq = checkpoint.SnapshotStore(ckdir).latest_seq()
    telemetry.reset()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    again = D.run_training(p, device=dev)
    torch.cuda.synchronize()
    rerun_s = time.perf_counter() - t0
    ck_count(K.launch_counts())
    c = telemetry.snapshot()["counters"]
    a, _ = load_game_model(out.model_dir, device=dev)
    b, _ = load_game_model(again.model_dir, device=dev)
    if not models_equal(a, b):
        raise AssertionError("CK (c): the rerun's best_model/ is not the "
                             "uncheckpointed run's")
    log(f"CK (c): run_training with checkpoint_dir killed at "
        f"bucket_retire#{occ} of {retires} after {killed_s:.1f} s "
        f"(snapshot {seq} committed), rerun {rerun_s:.1f} s (phases "
        + ", ".join(f"{k} {v:.3f}" for k, v in again.timings.items())
        + f"): checkpoint.descent_restores "
        f"{int(c.get('checkpoint.descent_restores', 0))}, re_restores "
        f"{int(c.get('checkpoint.re_restores', 0))}; best_model/ equals "
        f"DRV (a)'s bit for bit  [{gpu}]")
    log(f"CK (c): {time.perf_counter() - t_phase:.1f} s  [{gpu}]")


def dispatched_ops(fn) -> dict:
    """{aten operator: count} of one call of ``fn``: every operator it
    dispatches (on the card, each a kernel launch, copy or read-back),
    counted by a dispatch mode; exact, where a profiler trace can drop
    records. The hand-written kernels' launches are `kernels.
    launch_counts`' own."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops: dict = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = str(func.overloadpacket)
            self.ops[name] = self.ops.get(name, 0) + 1
            return func(*args, **(kwargs or {}))

    with Count() as mode:
        fn()
    return mode.ops


def phase_ck_resident(state: dict, dev, gpu) -> None:
    """CK (d): T2's resident L-BFGS (rows 2 and 4; T_SHORT iterations)
    session-less, under an armed session with the tap off (the same
    launches, the same dispatched device ops operator by operator, the
    same bits), and with ``resident_tap=True`` (the tapped iterate is
    the result's)."""
    import shutil

    import torch

    from photon_tpu_torch import checkpoint
    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l2

    batch = state["batch"]
    cfg = OptimizerConfig(max_iters=T_SHORT, tolerance=0.0, reg=l2(),
                          reg_weight=T_REG, history=T_HISTORY)
    d = ck_dir("d")

    def solve():
        K.reset_launch_counts()
        _, res, wall = solve_timed(batch, cfg, dev)
        return res, wall, K.launch_counts()

    def armed(tap: bool = False):
        with checkpoint.session(d, every_evals=None, every_s=None,
                                async_writer=False, resident_tap=tap) as s:
            out = solve()
            return out, {k: v for k, v in s._state.items()
                         if k.startswith("resident/")}

    try:
        r0, s0, l0 = solve()
        (r1, s1, l1), rec1 = armed()
        ops0, ops1 = dispatched_ops(solve), dispatched_ops(armed)
        (r2, s2, l2_), rec2 = armed(tap=True)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if not (not rec1 and l1 == l0 and ops1 == ops0
            and torch.equal(r1.w, r0.w)):
        raise AssertionError(
            f"CK (d): the armed session with the tap off changed the solve:"
            f" launches {l0} -> {l1}, device ops {sum(ops0.values())} -> "
            f"{sum(ops1.values())}, recorded {sorted(rec1)}")
    cap = rec2.get("resident/lbfgs_margin")
    if cap is None or int(cap["it"]) != r2.iterations or not torch.equal(
            batch.X.to_model_space(cap["w"]), r2.w):
        raise AssertionError("CK (d): the tap did not capture the final "
                             "iterate")
    ck_count(l2_)
    log(f"CK (d): resident L-BFGS on T2's layout, {r0.iterations} "
        f"iterations: session-less {s0:.3f} s, launches {l0}; armed with "
        f"the tap off {s1:.3f} s, the same launches, the same bits, the "
        f"same device ops operator by operator ({sum(ops0.values())} "
        f"dispatched); tapped {s2:.3f} s: "
        f"it {int(cap['it'])} and w equal the result's bit for bit  "
        f"[{gpu}]")


# ------------------------------------------- phase TF: the telemetry spine
# (a) T2's resident L-BFGS, T_SHORT iterations a solve, TF_CALLS solves
# telemetry-off and TF_CALLS tap-armed in turns; the walls compare by
# median, within the larger relative spread of the two sets or TF_FLOOR
TF_CALLS, TF_FLOOR = 4, 0.02
# (b) bench.py's serving configuration (:630-636): entities, dense fixed
# width, random-effect width, slots a row, zipf, clients; the fleet's
# replicas on the one card, the requests of each leg, the exemplars kept
# (the slowest 1%: the p99 tail), and the kill legs' requests
SV_E, SV_DF, SV_DR, SV_K, SV_ZIPF, SV_CLIENTS = 4096, 64, 8, 8, 1.2, 32
TF_REPLICAS, TF_REQUESTS, TF_KILL_REQUESTS = 4, 8192, 64
TF_EXEMPLARS = TF_REQUESTS // 100
TF_LAUNCHES: dict = {}  # TF's kernel launches, summed over its main paths
TU_LAUNCHES: dict = {}  # TU's: (b)'s tune and (e)'s bootstrap


def tf_count(launches: dict) -> None:
    for name, n in launches.items():
        TF_LAUNCHES[name] = TF_LAUNCHES.get(name, 0) + n


def phase_tf_tap(state: dict, dev, gpu) -> None:
    """TF (a): T2's resident L-BFGS (rows 2 and 4) under ``telemetry.run(
    jsonl_path=..., resident_tap=True)`` against telemetry off: the
    JSONL's iteration events equal the result's loss and |g| histories
    bit for bit, the same syncs an iteration (torch's sync debug mode),
    the armed/off wall by median within the runs' spread, and the run's
    device-memory peak equal to `torch.cuda.max_memory_allocated`."""
    import tempfile

    import torch

    from photon_tpu_torch import kernels as K
    from photon_tpu_torch import telemetry
    from photon_tpu_torch.kernels import blocked_ell as KB
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l2
    from photon_tpu_torch.telemetry.sinks import load_report
    from photon_tpu_torch.utils.profiling import count_syncs

    t_phase = time.perf_counter()
    batch = state["batch"]
    cfg = OptimizerConfig(max_iters=T_SHORT, tolerance=0.0, reg=l2(),
                          reg_weight=T_REG, history=T_HISTORY)
    tmp = tempfile.mkdtemp(prefix="_drv_tf", dir=os.path.dirname(
        os.path.abspath(__file__)))
    walls: dict = {"off": [], "armed": []}
    try:
        # the layout's first solve builds its kernel plans, and the first
        # solve under the sync debug mode makes a one-time sync of its own:
        # one counted solve first, its count dropped
        with count_syncs(dev):
            solve_timed(batch, cfg, dev)
        with count_syncs(dev) as sync_off:
            _, r_off, _ = solve_timed(batch, cfg, dev)
        jsonl = os.path.join(tmp, "tf.jsonl")
        K.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        with telemetry.run("tf_tap", jsonl_path=jsonl, resident_tap=True):
            with count_syncs(dev) as sync_on:
                _, r_on, _ = solve_timed(batch, cfg, dev)
            telemetry.sample_device_memory("tf")
            peak = torch.cuda.max_memory_allocated(dev)
            gauges = dict(telemetry.current_run().gauges)
        launches = K.launch_counts()
        events = [e for e in load_report(jsonl)["iterations"]
                  if e["solver"] == "lbfgs_margin"]
        for i in range(2 * TF_CALLS):  # off, armed, off, armed, ...
            armed = i % 2 == 1
            if armed:
                with telemetry.run("tf_wall", resident_tap=True):
                    _, _, wall = solve_timed(batch, cfg, dev)
            else:
                _, _, wall = solve_timed(batch, cfg, dev)
            walls["armed" if armed else "off"].append(wall)
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    n = r_on.iterations + 1
    want = r_on.loss_history[:n].cpu().tolist()
    gwant = r_on.grad_norm_history[:n].cpu().tolist()
    if not ([e["loss"] for e in events] == want
            and [e["grad_norm"] for e in events] == gwant
            and [e["it"] for e in events] == list(range(n))):
        raise AssertionError(f"TF (a): the JSONL's iteration events "
                             f"{[e['loss'] for e in events]} are not the "
                             f"solve's history {want}")
    if not torch.equal(r_off.loss_history.nan_to_num(),
                       r_on.loss_history.nan_to_num()) or \
            not torch.equal(r_off.w, r_on.w):
        raise AssertionError("TF (a): the armed tap changed the solve")
    if sync_on["n"] != sync_off["n"]:
        raise AssertionError(f"TF (a): syncs off {sync_off['n']}, armed "
                             f"{sync_on['n']}; by site off "
                             f"{sync_off['sites']}, armed "
                             f"{sync_on['sites']}")
    for name in (KB.TAIL, KB.RMATVEC):
        if launches.get(name, 0) == 0:
            raise AssertionError(f"TF (a): {name} never launched "
                                 f"({launches})")
    tf_count(launches)
    got_peak = gauges.get("hbm.peak_bytes_in_use.max.tf")
    if got_peak != peak:
        raise AssertionError(f"TF (a): the run's device-memory peak "
                             f"{got_peak} against max_memory_allocated "
                             f"{peak}")
    med = {k: float(np.median(v)) for k, v in walls.items()}
    spread = max((max(v) - min(v)) / med[k] for k, v in walls.items())
    ratio = med["armed"] / med["off"]
    if abs(ratio - 1.0) > max(spread, TF_FLOOR):
        raise AssertionError(f"TF (a): armed/off wall {ratio:.4f} outside "
                             f"the runs' spread {spread:.4f} (walls "
                             f"{walls})")
    log(f"TF (a): T2's resident L-BFGS, {r_on.iterations} iterations, tap "
        f"armed into a JSONL run: {len(events)} iteration events equal the "
        f"loss and |g| histories bit for bit; syncs {sync_on['n']} armed, "
        f"{sync_off['n']} off ({sync_on['n'] / r_on.iterations:.2f} an "
        f"iteration; by site, armed {sync_on['sites']}, off "
        f"{sync_off['sites']}); wall median "
        f"off {med['off']:.4f} s, armed {med['armed']:.4f} s, armed/off "
        f"{ratio:.4f} (runs' spread {spread:.4f}; walls {walls}); the "
        f"run's device-memory peak {got_peak / 1e9:.3f} GB = "
        f"max_memory_allocated; launches {launches}; "
        f"{time.perf_counter() - t_phase:.1f} s  [{gpu}]")


def sv_store(seed: int, dev):
    """bench.py's serving model (:640-660): a dense fixed effect and one
    per-member random effect over SV_E members, as a store on ``dev``."""
    from photon_tpu_torch.convert import game_model_from_arrays
    from photon_tpu_torch.serving import CoefficientStore

    rng = np.random.default_rng(seed)
    keys = np.asarray(sorted(str(i) for i in range(SV_E)))
    model = game_model_from_arrays("logistic", {
        "fixed": {"type": "fixed", "feature_shard": "global",
                  "means": rng.normal(size=SV_DF).astype(np.float32)},
        "perMember": {"type": "random", "feature_shard": "member",
                      "entity_name": "memberId", "entity_keys": keys,
                      "coefficients": rng.normal(
                          size=(SV_E, SV_DR)).astype(np.float32)},
    }, device=dev)
    return CoefficientStore.from_game_model(model, device=dev), rng


def sv_requests(rng, n: int) -> list:
    """bench.py's request mix (:664-672): zipf(1.2) members, ranks past
    SV_E the cold tail."""
    from photon_tpu_torch.serving import ScoreRequest

    ents = (rng.zipf(SV_ZIPF, size=n).astype(np.int64) - 1) % (2 * SV_E)
    xg = rng.normal(size=(n, SV_DF)).astype(np.float32)
    ind = rng.integers(0, SV_DR, size=(n, SV_K)).astype(np.int32)
    val = rng.normal(size=(n, SV_K)).astype(np.float32)
    return [ScoreRequest(features={"global": xg[i],
                                   "member": (ind[i], val[i])},
                         entities={"memberId": str(int(ents[i]))})
            for i in range(n)]


def closed_loop(score, reqs: list) -> tuple:
    """SV_CLIENTS threads each scoring its share of ``reqs`` one request
    at a time through ``score``; returns (answers, wall s, per-request
    latencies in ms)."""
    out = [None] * len(reqs)
    lat = np.zeros(len(reqs))
    errors: list = []

    def client(c: int) -> None:
        try:
            for r in range(c, len(reqs), SV_CLIENTS):
                t0 = time.perf_counter()
                out[r] = score(reqs[r])
                lat[r] = (time.perf_counter() - t0) * 1e3
        except Exception as e:  # reported by the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(SV_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise AssertionError("a client thread did not finish")
    return np.asarray(out, np.float64), wall, lat


def phase_tf_fleet(args, dev, gpu) -> None:
    """TF (b): a TF_REPLICAS-replica `ReplicaFleet` on the one card at
    bench.py's serving widths, every replica on its int8 rung (row 1):
    answers against a single f32 dispatcher (an f32 fleet within 1e-6,
    the int8 fleet within EPSILON / 4), routing against `replica_for`,
    QPS and p50/p99 with tracing off and on and the p99 exemplars' hop
    split, and a ``replica_dispatch`` and a ``rung_execute`` kill each
    ending in an exact or degraded-but-correct answer."""
    from photon_tpu_torch import checkpoint
    from photon_tpu_torch import kernels as K
    from photon_tpu_torch import serving
    from photon_tpu_torch.kernels import serving as KS
    from photon_tpu_torch.telemetry import trace

    t_phase = time.perf_counter()
    store, rng = sv_store(args.seed + 17, dev)
    reqs = sv_requests(rng, TF_REQUESTS)
    spec = dict(floor=8, max_batch=MAX_BATCH, sparse_k={"member": SV_K},
                output_mean=True)
    q8 = dict(spec, quantize="int8", quant_epsilon=EPSILON)
    dk = dict(max_batch=MAX_BATCH, max_delay_us=MAX_DELAY_US)
    single = serving.ProgramLadder(store, **spec)
    single.warmup()
    d32 = serving.MicroBatchDispatcher(single, **dk)
    try:
        want, one_wall, one_lat = closed_loop(d32.score, reqs)
    finally:
        d32.close()
    policy = serving.FleetPolicy(attempt_timeout_s=60.0)

    def fleet(kw):
        return serving.ReplicaFleet.build(store, TF_REPLICAS, policy=policy,
                                          ladder_kwargs=kw,
                                          dispatcher_kwargs=dk, warmup=True)

    f32 = fleet(spec)
    try:  # a parity leg only: a quarter of the requests
        got32, _, _ = closed_loop(f32.score, reqs[:TF_REQUESTS // 4])
    finally:
        f32.close()
    e32 = float(np.abs(got32 - want[:TF_REQUESTS // 4]).max())
    if e32 > 1e-6:
        raise AssertionError(f"TF (b): the f32 fleet is {e32} from the "
                             f"single f32 dispatcher")
    legs = {}
    for armed in (False, True):
        fl = fleet(q8)
        try:
            K.reset_launch_counts()
            if armed:
                with trace.tracing(k=TF_EXEMPLARS) as res:
                    got, wall, lat = closed_loop(fl.score, reqs)
                exemplars = res.snapshot()
            else:
                got, wall, lat = closed_loop(fl.score, reqs)
            launches = K.launch_counts()
            served = [r.dispatcher.latency_stats()["n"]
                      for r in fl.replicas]
            routes = np.bincount([fl.replica_for(q) for q in reqs],
                                 minlength=TF_REPLICAS).tolist()
            fl.assert_no_retrace()
        finally:
            fl.close()
        if served != routes:
            raise AssertionError(f"TF (b): replicas served {served}, "
                                 f"replica_for routes {routes}")
        if launches.get(KS.KERNEL, 0) == 0:
            raise AssertionError(f"TF (b): {KS.KERNEL} never launched")
        e8 = float(np.abs(got - want).max())
        if e8 > EPSILON / 4:
            raise AssertionError(f"TF (b): the int8 fleet is {e8} from the "
                                 f"f32 dispatcher > {EPSILON / 4}")
        tf_count(launches)
        legs[armed] = dict(qps=len(reqs) / wall,
                           p50=float(np.percentile(lat, 50)),
                           p99=float(np.percentile(lat, 99)), err=e8,
                           launches=launches, served=served)
        if armed:
            hops = ("fleet_route", "replica_dispatch", "queue_wait",
                    "device_flush", "retire_wait")
            split = {h: float(np.mean([ex["breakdown_ms"].get(h, 0.0)
                                       for ex in exemplars])) for h in hops}
            tot = float(np.mean([ex["total_ms"] for ex in exemplars]))
            slowest = {}
            for ex in exemplars:
                slowest[ex["slowest_hop"]] = \
                    slowest.get(ex["slowest_hop"], 0) + 1
            if not all(h in exemplars[0]["breakdown_ms"]
                       for h in ("queue_wait", "device_flush",
                                 "retire_wait")):
                raise AssertionError(f"TF (b): an exemplar lacks the "
                                     f"dispatcher's hops: {exemplars[0]}")
            legs[armed].update(split=split, total=tot, slowest=slowest,
                               n_ex=len(exemplars))
    for armed, leg in legs.items():
        log(f"TF (b): {TF_REPLICAS}-replica int8 fleet, tracing "
            f"{'on' if armed else 'off'}: QPS {leg['qps']:.1f}, p50 "
            f"{leg['p50']:.3f} ms, p99 {leg['p99']:.3f} ms over "
            f"{len(reqs)} requests from {SV_CLIENTS} clients; max |int8 "
            f"fleet - f32 dispatcher| {leg['err']:.3g}; served by replica "
            f"{leg['served']} = replica_for's routes; launches "
            f"{leg['launches']}  [{gpu}]")
    on = legs[True]
    log(f"TF (b): the p99 tail's {on['n_ex']} exemplars (the slowest 1%), "
        f"mean total {on['total']:.3f} ms: "
        + ", ".join(f"{h} {v:.3f} ms" for h, v in on["split"].items())
        + f"; slowest hop by count {on['slowest']}  [{gpu}]")
    log(f"TF (b): single f32 dispatcher: QPS {len(reqs) / one_wall:.1f}, "
        f"p50 {float(np.percentile(one_lat, 50)):.3f} ms, p99 "
        f"{float(np.percentile(one_lat, 99)):.3f} ms; the f32 fleet within "
        f"{e32:.3g} of it on {TF_REQUESTS // 4} requests  [{gpu}]")

    # the kills: every answer is the owning replica's or another's
    fl = fleet(q8)
    kreqs = reqs[:TF_KILL_REQUESTS]
    try:
        answers = [[r.dispatcher.score(q) for r in fl.replicas]
                   for q in kreqs]
        facts = {}
        for site, occ in (("replica_dispatch", TF_KILL_REQUESTS // 2),
                          ("rung_execute", TF_KILL_REQUESTS // 2)):
            K.reset_launch_counts()
            with checkpoint.fault_plan(
                    checkpoint.FaultPlan.kill_at(site, occ)) as plan:
                got = [fl.score(q) for q in kreqs]
            tf_count(K.launch_counts())
            owner = [a[fl.replica_for(q)] for q, a in zip(kreqs, answers)]
            bad = [i for i, (g, a) in enumerate(zip(got, answers))
                   if g not in a]
            if bad or plan.hits.get(site, 0) < occ:
                raise AssertionError(f"TF (b): kill at {site}#{occ}: torn "
                                     f"answers {bad}, hits {plan.hits}")
            facts[site] = sum(g != o for g, o in zip(got, owner))
    finally:
        fl.close()
    log(f"TF (b): a kill at replica_dispatch#{TF_KILL_REQUESTS // 2} and "
        f"at rung_execute#{TF_KILL_REQUESTS // 2} over {len(kreqs)} "
        f"requests: every answer the owner's or another replica's "
        f"(degraded) answer; degraded answers {facts}; "
        f"{time.perf_counter() - t_phase:.1f} s  [{gpu}]")


def tf_overheads(gpu, n: int = 20_000) -> dict:
    """Host µs a call of `telemetry.span` (enter + exit) and of
    `trace.begin` (+ `trace.finish`), off and on, over ``n`` calls each
    (the best of three loops)."""
    from photon_tpu_torch import telemetry
    from photon_tpu_torch.telemetry import trace

    def per_call(fn) -> float:
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            best = min(best, time.perf_counter() - t0)
        return best / n * 1e6

    def span():
        with telemetry.span("tf.overhead"):
            pass

    def begin():
        trace.finish(trace.begin("queue_wait"))

    out = {"span_off_us": per_call(span), "begin_off_us": per_call(begin)}
    with telemetry.run("tf_overhead"):
        out["span_on_us"] = per_call(span)
    with trace.tracing(k=8):
        out["begin_on_us"] = per_call(begin)
    log("TF (c): host cost a call (best of 3 x "
        f"{n:,} calls): telemetry.span off {out['span_off_us']:.3f} us, on "
        f"(a run attached: record_function + NVTX + the span record) "
        f"{out['span_on_us']:.3f} us; trace.begin + finish off "
        f"{out['begin_off_us']:.3f} us, armed {out['begin_on_us']:.3f} us"
        f"  [{gpu}]")
    return out


# ------------------------------------------------- phase TU: the tuners
def tu_count(launches: dict) -> None:
    for name, n in launches.items():
        TU_LAUNCHES[name] = TU_LAUNCHES.get(name, 0) + n


def tu_problem(seed: int, dev):
    """bench.py's tuning_problem (TU_ROWS x TU_FEATURES logistic from a
    planted N(0, 1) signal; validation rows a quarter as many) with numpy
    from ``seed``: (train, val) batches on ``dev``."""
    from photon_tpu_torch.data.dataset import make_batch

    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=TU_FEATURES).astype(np.float32)

    def draw(n, s):
        r = np.random.default_rng(s)
        X = r.normal(size=(n, TU_FEATURES)).astype(np.float32)
        p = 1.0 / (1.0 + np.exp(-(X @ w_true)))
        y = (r.uniform(size=n) < p).astype(np.float32)
        return make_batch(X, y, device=dev)

    return draw(TU_ROWS, seed + 1), draw(TU_ROWS // 4, seed + 2)


def phase_tu_tuner(args, dev, gpu) -> None:
    """TU (a): bench.py's tuning_e2e on the card — the lane tuner over
    TU_CONFIGS configs in chunks of TU_CHUNK (a warm tune, then a timed
    one with no new dispatch signature) against the point-at-a-time loop
    on TU_SEQ_SAMPLE points, and the GP fit of each round's history on
    the card and on the CPU (the tuning selftest runs in PF (c))."""
    import torch

    from photon_tpu_torch.evaluation.evaluator import default_evaluator
    from photon_tpu_torch.models.training import (evaluate_glm_grid,
                                                  train_glm_grid)
    from photon_tpu_torch.ops.losses import TaskType
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l2
    from photon_tpu_torch.tuning import gp as GP
    from photon_tpu_torch.tuning.lane_tuner import (LaneTuningResult,
                                                    tune_glm_reg_lanes)
    from photon_tpu_torch.tuning.search import SearchRange, SearchSpace

    train, val = tu_problem(args.seed, dev)
    task = TaskType.LOGISTIC_REGRESSION
    cfg = OptimizerConfig(max_iters=TU_ITERS, reg=l2(), history=5)
    evaluator = default_evaluator(task)
    t0 = time.perf_counter()
    tune_glm_reg_lanes(train, task, cfg, val, n_configs=TU_CONFIGS,
                       lane_chunk=TU_CHUNK, seed=7)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    base = LaneTuningResult.signature_count()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    _, best_w, res = tune_glm_reg_lanes(train, task, cfg, val,
                                        n_configs=TU_CONFIGS,
                                        lane_chunk=TU_CHUNK, seed=args.seed)
    torch.cuda.synchronize()
    lane_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    sigs = LaneTuningResult.assert_no_retrace(base)
    if len(res.ys) != TU_CONFIGS or not 1e-4 <= best_w <= 1e4:
        raise AssertionError(f"TU (a): {len(res.ys)} observations, best "
                             f"weight {best_w}")

    # the point-at-a-time loop: a full-depth single-lane grid and its own
    # validation pass per candidate, on a sample
    sample = list(np.geomspace(1e-4, 1e4, TU_SEQ_SAMPLE))

    def one_point(w):
        grid = train_glm_grid(train, task, cfg, [w], device=dev)
        evaluate_glm_grid(grid, val, evaluator)

    one_point(sample[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for w in sample:
        one_point(w)
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    lane_rate, seq_rate = TU_CONFIGS / lane_s, TU_SEQ_SAMPLE / seq_s

    # each GP round's fit (the screen observations so far) on the card and
    # on the CPU, after one warm fit of each
    space = SearchSpace([SearchRange(1e-4, 1e4, log_scale=True)])
    units = space.to_unit(res.xs).astype(np.float32)
    fits = {}
    for label, where in (("card", dev), ("cpu", torch.device("cpu"))):
        GP.fit_gp(units[:TU_CHUNK], res.ys[:TU_CHUNK], device=where)
        ms = []
        for r in range(1, len(res.rounds)):
            t0 = time.perf_counter()
            gp = GP.fit_gp(units[:TU_CHUNK * r], res.ys[:TU_CHUNK * r],
                           device=where)
            float(gp.alpha[0])
            ms.append((time.perf_counter() - t0) * 1e3)
        fits[label] = ms
    roof = 4.0 * TU_ROWS * TU_FEATURES * TU_CHUNK * res.rounds[0].screen_iters
    log(f"TU (a): bench.py's tuning_e2e: {TU_CONFIGS} configs of "
        f"{TU_ROWS} x {TU_FEATURES} logistic, {TU_ITERS} iterations, in lane "
        f"chunks of {TU_CHUNK}: {len(res.rounds)} rounds in {lane_s:.3f} s "
        f"(the warm tune, beside (c), {warm_s:.3f} s) = {lane_rate:.6g} "
        f"configs/s; the "
        f"point-at-a-time loop {TU_SEQ_SAMPLE} points in {seq_s:.3f} s = "
        f"{seq_rate:.6g} configs/s; ratio {lane_rate / seq_rate:.4g}x "
        f"(the reference's acceptance 8x); best reg weight {best_w:.6g}, "
        f"best_y {res.best_y:.6g}; round_model_flops "
        f"{res.rounds[0].modeled_flops:.6g} (lane roofline {roof:.6g}); "
        f"peak device memory {peak_gb:.3f} GB; {sigs - base + 2} dispatch "
        f"signatures over the timed tune, none new  [{gpu}]")
    counts = ", ".join(str(TU_CHUNK * r) for r in range(1, len(res.rounds)))
    log(f"TU (a): GP fit per round ({counts} observations): on the card "
        + ", ".join(f"{m:.1f}" for m in fits["card"])
        + " ms; on the CPU " + ", ".join(f"{m:.1f}" for m in fits["cpu"])
        + f" ms  [{gpu}]")
    del train, val
    torch.cuda.empty_cache()


def tu_kernels_agree(X, W, gen) -> float:
    """Rows 2 and 4 at the lanes of ``W`` ((d, G), permuted space) on a
    `BlockedEllRows` against their plain versions, rtol=atol=1e-5; returns
    the max |err|."""
    import torch

    from photon_tpu_torch.kernels import blocked_ell as KB

    got = KB.tail_matvec(X, W)
    want = KB.tail_matvec_reference(X, W)
    r = torch.randn((int(X.row_pos.shape[0]), W.shape[1]), generator=gen,
                    device=W.device)
    got_r = KB.bucket_rmatvec(X, r)
    want_r = KB.bucket_rmatvec_reference(X, r)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL,
                               err_msg="TU (b): tail matvec vs plain")
    np.testing.assert_allclose(got_r.cpu().numpy(), want_r.cpu().numpy(),
                               **TOL, err_msg="TU (b): rmatvec vs plain")
    return max(float((got - want).abs().max()),
               float((got_r - want_r).abs().max()))


def hl_f64(p, y, n_bins: int = 10) -> tuple:
    """Hosmer–Lemeshow (chi², bin masses, observed, expected) in numpy
    f64, the reference's binning, unit weights."""
    o = np.argsort(p, kind="stable")
    p, y = p[o].astype(np.float64), y[o].astype(np.float64)
    w = np.ones_like(p)
    cw = np.cumsum(w) - 0.5 * w
    b = np.clip((cw / w.sum() * n_bins).astype(int), 0, n_bins - 1)
    obs, exp, mass = (np.bincount(b, v, n_bins) for v in (y, p, w))
    den = exp * (1 - exp / np.maximum(mass, 1e-12))
    chi2 = float(np.where(mass > 0, (obs - exp) ** 2
                          / np.maximum(den, 1e-12), 0.0).sum())
    return chi2, mass, obs, exp


def rel_gap(got, want) -> float:
    """max |got − want| over max |want|."""
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-300))


def phase_tu_lanes(args, state: dict, dev, gpu) -> None:
    """TU (b): T2's layout (G's configuration) through the lane tuner with
    E's held-out rows (cut: TU_T2_CONFIGS configs in chunks of
    TU_T2_CHUNK); (e) Hosmer–Lemeshow on the winner's held-out
    probabilities and both importances on the SparseRows T2 is laid out
    from, each against numpy f64 and repeated bit for bit."""
    import torch

    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.data.matrix import SparseRows
    from photon_tpu_torch.diagnostics import (expected_magnitude_importance,
                                              hosmer_lemeshow,
                                              variance_importance)
    from photon_tpu_torch.kernels import blocked_ell as KB
    from photon_tpu_torch.models.training import train_glm_grid
    from photon_tpu_torch.ops.losses import TaskType
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l2
    from photon_tpu_torch.tuning.lane_tuner import (LaneBudget,
                                                    LaneTuningResult,
                                                    tune_glm_reg_lanes)

    batch = state["batch"]
    vbatch, vy = state.pop("e_val")
    task = TaskType.LOGISTIC_REGRESSION
    cfg = OptimizerConfig(max_iters=T_ITERS, tolerance=0.0, reg=l2(),
                          reg_weight=0.0, history=T_HISTORY,
                          lane_history_dtype="bfloat16")
    base = LaneTuningResult.signature_count()
    # each layout's kernel plan exists before the tune (T2's and E's
    # phases built them): the tune's rounds must build none
    for b in (batch, vbatch):
        KB.layout_plan(b.X)
    builds = KB.plan_builds()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    model, best_w, res = tune_glm_reg_lanes(
        batch, task, cfg, vbatch, n_configs=TU_T2_CONFIGS,
        lane_chunk=TU_T2_CHUNK, seed=args.seed)
    torch.cuda.synchronize()
    tune_s = time.perf_counter() - t0
    launches = K.launch_counts()
    tu_count(launches)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    new_builds = KB.plan_builds() - builds
    sigs = LaneTuningResult.assert_no_retrace(base + 2)
    if new_builds:
        raise AssertionError(f"TU (b): {new_builds} plan builds in the tune")
    if not all(launches.get(k, 0) > 0 for k in ("tail_matvec",
                                                 "bucket_rmatvec")):
        raise AssertionError(f"TU (b): the tune launched {launches}")

    # the first round's screen on the kernels and under scope("off")
    screen = dataclasses.replace(
        cfg, max_iters=LaneBudget().screen_iters or max(4, T_ITERS // 8))
    weights = [float(w) for w in res.xs[:TU_T2_CHUNK, 0]]
    got, _ = train_glm_grid(batch, task, screen, weights, device=dev,
                            device_results=True)
    with K.scope("off"):
        want, _ = train_glm_grid(batch, task, screen, weights, device=dev,
                                 device_results=True)
    gv, wv = got.value.cpu().numpy(), want.value.cpu().numpy()
    np.testing.assert_allclose(gv, wv, rtol=1e-5,
                               err_msg="TU (b): screen vs scope off")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 18)
    X = batch.X
    err = tu_kernels_agree(X, X.from_model_space(got.w.t().contiguous()),
                           gen)
    rounds = "; ".join(
        f"round {i}: screen best {r.best_screen_y:.6g}, full best "
        f"{r.best_full_y:.6g}" for i, r in enumerate(res.rounds))
    log(f"TU (b): T2's layout through tune_glm_reg_lanes (G's configuration,"
        f" {T_ITERS} iterations, screen {res.rounds[0].screen_iters}; cut: "
        f"{TU_T2_CONFIGS} configs in chunks of {TU_T2_CHUNK}) with E's "
        f"{E_ROWS} held-out rows: {len(res.rounds)} rounds in {tune_s:.3f} s"
        f" ({TU_T2_CONFIGS / tune_s:.4g} configs/s); best reg weight "
        f"{best_w:.6g}, validation AUC {-res.best_y:.8g}; {rounds}; "
        f"round_model_flops {res.rounds[0].modeled_flops:.6g}, bytes "
        f"{res.rounds[0].modeled_bytes:.6g}; launches {launches}; plan "
        f"builds {new_builds}; {sigs - base} dispatch signatures; peak "
        f"device memory {peak_gb:.3f} GB  [{gpu}]")
    log(f"TU (b): the first round's {TU_T2_CHUNK}-lane screen on the kernels"
        f" against scope(\"off\"): final objectives within rtol 1e-5 (max rel"
        f" {float(np.max(np.abs(gv - wv) / np.abs(wv))):.3g}); rows 2 and 4 "
        f"at its {TU_T2_CHUNK} lanes against their plain versions on this "
        f"layout: max |err| {err:.3g}  [{gpu}]")
    del got, want

    # (e) Hosmer–Lemeshow on the winner's held-out probabilities
    probs = torch.sigmoid(model.score(vbatch.X))
    labels = vbatch.y
    hls = [hosmer_lemeshow(probs, labels) for _ in range(5)]
    t0 = time.perf_counter()
    hl = hosmer_lemeshow(probs, labels)
    float(hl.chi2)
    hl_ms = (time.perf_counter() - t0) * 1e3
    same = all(torch.equal(h.chi2, hls[0].chi2)
               and torch.equal(h.bin_weight, hls[0].bin_weight)
               and torch.equal(h.observed_pos, hls[0].observed_pos)
               and torch.equal(h.expected_pos, hls[0].expected_pos)
               for h in hls)
    chi2, mass, obs, exp = hl_f64(probs.cpu().numpy(), vy)
    gaps = {"chi2": abs(float(hl.chi2) - chi2) / chi2,
            "bin masses": rel_gap(hl.bin_weight.cpu().numpy(), mass),
            "observed": rel_gap(hl.observed_pos.cpu().numpy(), obs),
            "expected": rel_gap(hl.expected_pos.cpu().numpy(), exp)}
    if not same or max(gaps.values()) > 1e-5:
        raise AssertionError(f"TU (e): Hosmer-Lemeshow repeat {same}, "
                             f"against f64 {gaps}")
    log(f"TU (e): hosmer_lemeshow on the winner's {E_ROWS} held-out "
        f"probabilities: chi2 {float(hl.chi2):.6g}, p {float(hl.p_value):.6g}"
        f", dof {float(hl.dof):g}, {hl_ms:.3f} ms; against numpy f64 (rel): "
        + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items())
        + f"; 5 calls bit for bit  [{gpu}]")
    del probs, vbatch

    # (e) both importances on the SparseRows T2 is laid out from
    ind, va, _ = state["coo"]
    S = SparseRows(ind, va, T_FEATURES).to(dev)
    w = model.coefficients.means
    outs, secs = {}, {}
    for name, fn in (("magnitude", expected_magnitude_importance),
                     ("variance", variance_importance)):
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs.append(fn(w, S).importance)
            secs.setdefault(name, time.perf_counter() - t0)
        if not all(np.array_equal(r, runs[0]) for r in runs):
            raise AssertionError(f"TU (e): {name} importance moved between "
                                 "calls")
        outs[name] = runs[0]
    wh = np.abs(w.cpu().numpy().astype(np.float64))
    n = ind.shape[0]
    cols = ind.reshape(-1)
    v64 = va.reshape(-1).astype(np.float64)
    e_abs = np.bincount(cols, np.abs(v64), T_FEATURES) / n
    e1 = np.bincount(cols, v64, T_FEATURES) / n
    e2 = np.bincount(cols, v64 * v64, T_FEATURES) / n
    var = np.maximum(e2 - e1 * e1, 0.0)
    g_mag = rel_gap(outs["magnitude"], wh * e_abs)
    # σ of a constant column (the intercept) is the square root of a
    # rounding in f32: the variance importance is held squared
    g_var = rel_gap(outs["variance"].astype(np.float64) ** 2, wh ** 2 * var)
    if max(g_mag, g_var) > 1e-5:
        raise AssertionError(f"TU (e): importances against f64: magnitude "
                             f"{g_mag}, variance (squared) {g_var}")
    log(f"TU (e): importances of the winner on T2's SparseRows ({n} rows x "
        f"{ind.shape[1]} slots, {T_FEATURES} columns): magnitude "
        f"{secs['magnitude']:.3f} s (first call, its segment plan built), "
        f"variance {secs['variance']:.3f} s; against numpy f64 (max gap "
        f"over max): magnitude {g_mag:.3g}, variance (squared) {g_var:.3g};"
        f" 5 calls each bit for bit; top 3 by magnitude "
        + str([(int(j), float(outs['magnitude'][j]))
               for j in np.argsort(-outs["magnitude"])[:3]])
        + f"  [{gpu}]")
    del S
    torch.cuda.empty_cache()


def phase_tu_bootstrap(args, state: dict, dev, gpu) -> None:
    """TU (e): `bootstrap_glm` with TU_BOOT replicates of D2's dense L1
    OWL-QN solve (row 6 a trial), the first replicate held against its
    plain-version solve."""
    import warnings

    import torch

    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.diagnostics import bootstrap_glm
    from photon_tpu_torch.diagnostics.bootstrap import poisson_counts
    from photon_tpu_torch.kernels import fused as KF
    from photon_tpu_torch.models.training import make_objective, solve
    from photon_tpu_torch.ops.losses import TaskType
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l1

    batch = state["batch"]
    task = TaskType.LOGISTIC_REGRESSION
    # D2's solve at the default tolerance, so that converged counts
    cfg = OptimizerConfig(max_iters=D_ITERS, reg=l1(), reg_weight=D_L1,
                          history=D_HISTORY)
    seed = args.seed + 18
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with warnings.catch_warnings():  # a replicate that stops unconverged
        warnings.simplefilter("ignore")
        rep = bootstrap_glm(batch, task, cfg, n_replicates=TU_BOOT,
                            seed=seed)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    launches = K.launch_counts()
    tu_count(launches)
    if launches.get(KF.KERNEL, 0) == 0:
        raise AssertionError(f"TU (e): the bootstrap launched {launches}")
    # replicate 0 again on the kernels (the same bits) and on the plain
    # version for D_SHORT iterations: histories within rtol 1e-5
    counts = poisson_counts(TU_BOOT, batch.n, seed=seed, device=dev)
    rb = batch._replace(weights=batch.weights * counts[0])
    obj = make_objective(task, cfg, D_FEATURES, fused=True, device=dev)
    w0 = torch.zeros(D_FEATURES, dtype=torch.float32, device=dev)
    r0 = solve(obj, rb, w0, cfg)
    if not np.array_equal(r0.w.cpu().numpy(), rep.coefficients[0]):
        raise AssertionError("TU (e): replicate 0 is not its own solve")
    with K.scope("off"):
        p0 = solve(obj, rb, w0, dataclasses.replace(cfg, max_iters=D_SHORT))
    h0 = r0.history()
    gap = histories_agree("TU (e) replicate 0 plain vs kernel",
                          h0[:min(len(h0), D_SHORT + 1)], p0.history())
    log(f"TU (e): bootstrap_glm, {TU_BOOT} Poisson replicates of D2's "
        f"{D_ROWS} x {D_FEATURES} L1 OWL-QN solve (L1 {D_L1:g}, at most "
        f"{D_ITERS} iterations, tolerance {cfg.tolerance:g}) in "
        f"{boot_s:.3f} s ({boot_s / TU_BOOT:.3f} s a replicate); "
        f"{int(rep.converged.sum())} of {TU_BOOT} converged; launches "
        f"{launches}; CI width (95%) median "
        f"{float(np.median(rep.ci_upper - rep.ci_lower)):.4g}; replicate 0 "
        f"re-solved bit for bit, its first {D_SHORT} iterations within rtol "
        f"1e-5 of the plain version's (max rel {gap:.3g})  [{gpu}]")


def tu_driver(params_a: dict, root: str, dev, gpu) -> None:
    """TU (d): DRV (a)'s Avro and parameters with ``tuning_iters=
    TU_DRV_ITERS`` and ``tuning_batch=TU_DRV_BATCH`` over TU_DRV_RANGE (no
    grid, no warm starts: the batches vectorize; the best model only;
    cut: solves stopped at RE_CHECK_TOL) through `run_training`; each result's
    validation score against the same configurations refitted by
    `GameEstimator.fit(config_grid=...)` on the same data."""
    import torch

    from photon_tpu_torch import drivers as D
    from photon_tpu_torch.game import estimator as GE

    coords = {n: {**{k: v for k, v in c.items() if k != "reg_weights"},
                  "tolerance": RE_CHECK_TOL}
              for n, c in params_a["coordinates"].items()}
    params = D.TrainingParams(**{
        **params_a, "coordinates": coords, "output_mode": "BEST",
        "output_dir": os.path.join(root, "train_tuned"),
        "warm_start": False, "tuning_iters": TU_DRV_ITERS,
        "tuning_batch": TU_DRV_BATCH, "tuning_range": TU_DRV_RANGE})
    calls = []
    real = GE.GameEstimator.fit

    def spy(self, data, validation=None, config_grid=None,
            initial_models=None):
        calls.append((self, data, validation, config_grid))
        return real(self, data, validation=validation,
                    config_grid=config_grid, initial_models=initial_models)

    GE.GameEstimator.fit = spy
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = D.run_training(params, device=dev)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        GE.GameEstimator.fit = real
    if len(out.results) != TU_DRV_ITERS:
        raise AssertionError(f"TU (d): {len(out.results)} results")
    # the same calls again, each a GameEstimator.fit of its configurations
    t0 = time.perf_counter()
    refit = [r for est, data, validation, grid in calls
             for r in est.fit(data, validation=validation,
                              config_grid=grid)]
    torch.cuda.synchronize()
    refit_s = time.perf_counter() - t0
    gap = max(abs(a.validation_score - b.validation_score)
              for a, b in zip(out.results, refit))
    if gap > 1e-6:
        raise AssertionError(f"TU (d): validation scores part by {gap:.3g}")
    best = {n: round(c.optimizer.reg_weight, 6)
            for n, c in out.best.configs.items()}
    log(f"TU (d): run_training with tuning_iters={TU_DRV_ITERS}, "
        f"tuning_batch={TU_DRV_BATCH} on DRV (a)'s Avro: {len(out.results)} "
        f"results in {run_s:.3f} s ({len(calls)} estimator fits of "
        f"{[len(c[3]) for c in calls]} configs, vectorized "
        f"{calls[0][0].would_vectorize(calls[0][3], data=calls[0][1])}), "
        f"phases "
        + ", ".join(f"{k} {v:.3f}" for k, v in out.timings.items())
        + f" s; best reg weights {best}, validation AUC "
        f"{out.best.validation_score:.8g}; each result within {gap:.3g} of "
        f"the same configuration refitted by GameEstimator.fit("
        f"config_grid=...) ({refit_s:.3f} s)  [{gpu}]")


# --------------------------------- phase PF: the ledger and the self-tests
def pf_selfcheck(rc: int, out: str, err: str, seconds: float,
                 gpu) -> dict:
    """PF (c): the umbrella's JSON — every ported suite ok on the card,
    each line with its seconds and the facts its report carries, the
    13 suites with none pending; returns the parallel suite's report (MG
    (c) and (d) read it)."""
    lines = out.strip().splitlines()
    umb = json.loads(lines[-1]) if lines else {}
    suites = umb.get("suites", {})
    want = ["parallel", "analysis", "telemetry", "serving", "checkpoint",
            "profiling", "game", "continual", "ingest", "kernels", "tuning",
            "lint", "threads"]
    if (rc != 0 or not umb.get("ok") or sorted(suites) != sorted(want)
            or umb.get("pending") != []):
        failed = {name: {"rc": r.get("rc"), "seconds": r.get("seconds"),
                         "detail": r.get("detail", "")[-1500:]}
                  for name, r in suites.items() if not r.get("ok")}
        raise AssertionError(f"PF (c): selfcheck exit {rc}: suites not ok "
                             f"{failed}; {sorted(suites)} {err[-3000:]}")
    reports = {name: json.loads(r["detail"]) for name, r in suites.items()}
    for name in want:
        rep = reports[name]
        checks = rep.get("checks", {})
        if not rep.get("ok"):
            raise AssertionError(f"PF (c): {name} report not ok: {rep}")
        facts = {
            "serving": lambda r: f"; int8 launches {r['int8_launches']}, "
            f"fleet latency {r['fleet_latency']}",
            "telemetry": lambda r: f"; resident tap {r['resident_tap']}, "
            f"tracing launches {r['serving_trace']}",
            "tuning": lambda r: "; best reg weight "
            f"{r['checks']['lane_tune']['best_w']:.6g}, round flops "
            f"{r['checks']['cost_budget']['round_flops']:.6g}",
            "kernels": lambda r: "; parity max |err| "
            f"{r['checks']['parity']['max_err']:.3g}, fused == tiled "
            f"{r['checks']['parity']['fused_tiled_bitwise']}, streamed "
            f"gap {r['checks']['streamed']['max_rel_gap']:.3g} with "
            f"launches {r['checks']['streamed']['launches']}, ring plans "
            f"{r['checks']['ring']['plan_builds']}",
            "continual": lambda r: "; int8 after the swap within "
            f"{r['checks']['swap']['int8_max_gap']:.3g}, row 1 launches "
            f"{r['checks']['swap']['int8_launches']}",
            "game": lambda r: "; blocked-ELL mesh launches "
            f"{r['checks']['blocked_ell_mesh_smoke']['launches']}",
            "profiling": lambda r: "; streamed utilizations "
            f"{r['checks']['utilization_in_unit_interval']['utilization']}"
            f" ({r['checks']['utilization_in_unit_interval']['peaks_source']})"
            f", ledger free {r['checks']['ledger_off_is_free']}",
            "analysis": lambda r: f"; {r['n_specs']} contracts on "
            f"{r['device']}, {r['n_violations']} violations",
            "lint": lambda r: f"; {r['n_files']} files, {r['n_findings']} "
            f"findings, {r['n_suppressed']} waived",
            "threads": lambda r: f"; {len(r['model']['threads'])} thread "
            f"entries, {r['n_findings']} findings",
        }.get(name, lambda r: "")(rep)
        log(f"PF (c): {name} suite exit 0 in {suites[name]['seconds']} s, "
            f"{len(checks)} checks ok ({', '.join(checks)}){facts}")
    log(f"PF (c): python -m photon_tpu_torch --selfcheck --json --jobs "
        f"{PF_JOBS}: {len(want)}/{len(want)} suites ok in "
        f"{seconds:.1f} s (beside MG's host layout builds, (c)'s "
        f"2-process solve and the later phases' host data), none pending  "
        f"[{gpu}]")
    return reports["parallel"]


def phase_pf_ledger(cb, dev, gpu) -> None:
    """PF (a): the attribution ledger armed on S's ladder solve (cut to
    PF_ITERS iterations): PF_CALLS solves in turns disarmed, armed,
    armed, disarmed under `count_syncs`; the first armed solve's report
    (launches counted around it); rows 2 and 4's device share of its
    passes from one more armed solve under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from photon_tpu_torch import kernels as K
    from photon_tpu_torch import profiling
    from photon_tpu_torch.kernels import blocked_ell as KB
    from photon_tpu_torch.models.training import train_glm
    from photon_tpu_torch.ops.losses import TaskType
    from photon_tpu_torch.optim.config import OptimizerConfig
    from photon_tpu_torch.optim.regularization import l2
    from photon_tpu_torch.utils.profiling import count_syncs

    cfg = OptimizerConfig(max_iters=PF_ITERS, tolerance=0.0, reg=l2(),
                          reg_weight=T_REG, history=T_HISTORY)
    # one counted solve first, its count dropped: a first solve's one-time
    # syncs (the sync debug mode's own, a new shape's plan) land in no leg
    with count_syncs(dev):
        train_glm(cb, TaskType.LOGISTIC_REGRESSION, cfg, device=dev)
    runs, rep = [], None
    for armed in (False, True, True, False)[:PF_CALLS]:
        first = armed and rep is None
        ctx = (profiling.ledger("pf", devices=dev) if armed
               else profiling.ledger_disabled())
        torch.cuda.synchronize()
        if first:
            K.reset_launch_counts()
        t0 = time.perf_counter()
        with ctx as led, count_syncs(dev) as syncs:
            if armed:
                led.sample_hbm("start")
            model, res = train_glm(cb, TaskType.LOGISTIC_REGRESSION, cfg,
                                   device=dev)
            if armed:
                led.sample_hbm("solve")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if first:
            PF_LAUNCHES.update(K.launch_counts())
            rep = led.report()
        runs.append((armed, model.coefficients.means, syncs["n"], wall,
                     res.iterations))
    w0 = runs[0][1]
    if not all(torch.equal(w0, r[1]) for r in runs):
        raise AssertionError("PF (a): armed and disarmed coefficients "
                             "differ")
    if len({r[2] for r in runs}) != 1:
        raise AssertionError(f"PF (a): syncs armed and disarmed "
                             f"{[(r[0], r[2]) for r in runs]}")
    for name in (KB.TAIL, KB.RMATVEC):
        if PF_LAUNCHES.get(name, 0) == 0:
            raise AssertionError(f"PF (a): {name} never launched "
                                 f"({PF_LAUNCHES})")
    off = [r[3] for r in runs if not r[0]]
    on = [r[3] for r in runs if r[0]]
    it = runs[0][4]
    # one more armed solve under the profiler: rows 2 and 4 device us a
    # launch
    with profiling.ledger("pf_profiled", devices=dev), \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        solve_timed(cb, cfg, dev)
    dev_us = {KB.TAIL: [], KB.RMATVEC: []}
    for name, us in device_events(prof):
        if "bell_tail_matvec_kernel" in name:
            dev_us[KB.TAIL].append(us)
        elif "bell_bucket_rmatvec_kernel" in name:
            dev_us[KB.RMATVEC].append(us)
    per = {k: (sum(v) / len(v) / 1e6 if v else 0.0)
           for k, v in dev_us.items()}
    entries = rep["attribution"]
    log(f"PF (a): S's ladder ({cb.n_chunks} bf16 chunks of "
        f"{cb.X.chunk_rows} rows, {it} L-BFGS iterations) under the "
        f"ledger: peaks {rep['peaks']} from {rep['peaks_source']}; "
        f"{len(entries)} attribution entries  [{gpu}]")
    for e in entries:
        util = e.get("utilization")
        log(f"PF (a):   {e['program']} [{e['phase']}]: {e['calls']} calls, "
            f"{e['seconds']:.6f} s"
            + ("" if "flops_modeled" not in e else
               f", modeled {e['flops_modeled']:.6g} FLOP / "
               f"{e['bytes_modeled']:.6g} B, "
               f"{e['achieved_bytes_per_s']:.6g} B/s, utilization "
               f"{util:.6g} ({e['bound']}-bound)"))
    by = {(e["program"], e["phase"]): e for e in entries}
    for prog, phase, rows in (("chunk_dz_phi", "lbfgs/direction",
                               (KB.TAIL,)),
                              ("chunk_init", "lbfgs/init",
                               (KB.TAIL, KB.RMATVEC))):
        e = by.get(("streamed." + prog, phase))
        if e is None:
            raise AssertionError(f"PF (a): no {prog} [{phase}] entry")
        call_s = e["seconds"] / e["calls"]
        raw = e["bytes_modeled"] / (e["seconds"] * PF_HBM_BYTES_PER_S)
        kern_s = sum(per[k] for k in rows)
        log(f"PF (a): {prog} [{phase}]: modeled bytes / (seconds x "
            f"{PF_HBM_BYTES_PER_S:.3g} B/s) = {raw:.6g}; rows "
            f"{'+'.join(rows)} device {kern_s * 1e3:.4f} ms a chunk of "
            f"{call_s * 1e3:.4f} ms a chunk call: {kern_s / call_s:.4g} of "
            f"the pass  [{gpu}]")
    progs = rep["programs"]
    log(f"PF (a): first calls: "
        + "; ".join(f"{n}: load {p.get('compile_s', 0.0):.6f} s, plan "
                    f"{p.get('plan_s', 0.0):.6f} s, {p['retraces']} "
                    f"signature(s)" for n, p in progs.items())
        + f"; account {rep['compile']}; device memory {rep['hbm']}  "
        f"[{gpu}]")
    log(f"PF (a): {len(runs)} solves in turns disarmed/armed: coefficients "
        f"equal bit for bit; syncs {runs[0][2]} each (count_syncs); wall "
        f"disarmed {[round(x, 4) for x in off]} s, armed "
        f"{[round(x, 4) for x in on]} s, armed/disarmed by median "
        f"{float(np.median(on)) / float(np.median(off)):.4f}; launches "
        f"{PF_LAUNCHES}  [{gpu}]")


def phase_pf_clis(gpu) -> None:
    """PF (b): ``python -m photon_tpu_torch.profiling --report --json`` at
    its defaults and ``--selftest --json`` on the card, side by side."""
    t0 = time.perf_counter()
    procs = {flag: subprocess.Popen(
        [sys.executable, "-m", "photon_tpu_torch.profiling", flag,
         "--json"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for flag in ("--report", "--selftest")}
    outs = {}
    try:
        for flag, p in procs.items():
            outs[flag] = p.communicate(timeout=600)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for flag, p in procs.items():
        out, err = outs[flag]
        if p.returncode != 0 or not out.strip():
            raise AssertionError(f"PF (b): profiling {flag} exit "
                                 f"{p.returncode}: {out[-3000:]} "
                                 f"{err[-3000:]}")
    report = json.loads(outs["--report"][0].strip().splitlines()[-1])
    led = report["ledger"]
    streamed = [e for e in led["attribution"]
                if e["program"].startswith("streamed.")]
    if not streamed or not all(
            e.get("utilization") is not None
            and 0.0 < e["utilization"] <= 1.0 for e in streamed):
        raise AssertionError(f"PF (b): report's streamed entries {streamed}")
    log(f"PF (b): python -m photon_tpu_torch.profiling --report --json on "
        f"{report['device']} (peaks from {led['peaks_source']}): "
        + "; ".join(f"{e['program']} [{e['phase']}] {e['calls']} calls "
                    f"{e['seconds']:.6f} s, utilization "
                    f"{e['utilization']:.6g}" for e in streamed)
        + f"; no gate (no --bench-dir)  [{gpu}]")
    st = json.loads(outs["--selftest"][0].strip().splitlines()[-1])
    if not st.get("ok"):
        raise AssertionError(f"PF (b): profiling selftest {st}")
    log(f"PF (b): python -m photon_tpu_torch.profiling --selftest: "
        f"{len(st['checks'])} checks ok ({', '.join(st['checks'])}); "
        f"ledger free {st['checks']['ledger_off_is_free']}; both in "
        f"{time.perf_counter() - t0:.1f} s  [{gpu}]")


# ------------------------------- phase AN: the contracts and the auditor
AN_LAUNCHES: dict = {}  # AN (a)'s kernel launches (reset, run, read)
# the kernel contracts of rows 1-5, by the wrappers each must launch
AN_KERNEL_CONTRACTS = {
    "blocked_ell_kernel_x_passes": ("tail_matvec", "bucket_rmatvec"),
    "blocked_ell_kernel_no_retrace": ("tail_matvec", "bucket_rmatvec"),
    "blocked_ell_tiled_x_passes": ("tail_matvec_tiled",
                                   "bucket_rmatvec_tiled"),
    "serving_kernel_fused_rung": ("serving_int8",),
    "serving_kernel_mode_invariance": ("serving_int8",),
}


def phase_an(dev, gpu) -> None:
    """AN: (a) every registered contract checked in this process on the
    card (`analysis.contracts.trace_contract`: two calls under the
    recorder), one line each — psum count, host syncs, kernel launches,
    plans built on the second call, violations —, every contract holding
    and the kernel contracts of rows 1-5 launching their kernels with no
    sync and no plan on the second call (the counts reset just before and
    read just after); (b) ``python -m photon_tpu_torch.lint --json`` and
    ``--threads --json``, run beside (a): both ``ok`` with zero findings
    and no stale waiver."""
    import torch

    from photon_tpu_torch import kernels as K
    from photon_tpu_torch.analysis.contracts import (check_contract,
                                                     summarize,
                                                     sync_budget,
                                                     trace_contract)
    from photon_tpu_torch.analysis.registry import load_registry

    here = os.path.dirname(os.path.abspath(__file__))
    audits = {name: subprocess.Popen(
        [sys.executable, "-m", "photon_tpu_torch.lint", *flags],
        cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, flags in (("lint", ("--json",)),
                            ("threads", ("--threads", "--json")))}
    try:
        t0 = time.perf_counter()
        specs = load_registry()
        bad: dict = {}
        K.reset_launch_counts()
        for name in sorted(specs):
            spec = specs[name]
            try:
                traced = trace_contract(spec, dev)
                violations = [str(v) for v in check_contract(spec, traced)]
                facts = summarize(traced)
            except Exception as e:  # noqa: BLE001 — the phase fails below
                violations = [f"(trace-error) {type(e).__name__}: {e}"]
                facts = {}
            want = AN_KERNEL_CONTRACTS.get(name)
            if want and facts and (
                    any(not facts["launches"].get(k) for k in want)
                    or facts["syncs"] or facts["plan_builds_second"]):
                violations.append(f"kernel contract: launches "
                                  f"{facts['launches']}, syncs "
                                  f"{facts['syncs']}, plans on the second "
                                  f"call {facts['plan_builds_second']}")
            if violations:
                bad[name] = violations
            log(f"AN (a): {name}: psum "
                f"{facts.get('collectives', {}).get('psum', 0)}, syncs "
                f"{facts.get('syncs', '?')} (budget "
                f"{sync_budget(spec, dev)}), launches "
                f"{facts.get('launches', {})}, plans on the second call "
                f"{facts.get('plan_builds_second', '?')}, violations "
                f"{len(violations)}" + (f": {violations}" if violations
                                        else "") + f"  [{gpu}]")
        AN_LAUNCHES.update(K.launch_counts())
        an_s = time.perf_counter() - t0
        outs = {name: p.communicate(timeout=300)
                for name, p in audits.items()}
    finally:
        for p in audits.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    if bad:
        raise AssertionError(f"AN (a): {len(bad)} contract(s) broken on "
                             f"the card: {bad}")
    log(f"AN (a): {len(specs)} contracts hold on "
        f"{torch.cuda.get_device_name(0)} in {an_s:.1f} s; kernel launches "
        f"{dict(AN_LAUNCHES)}  [{gpu}]")
    for name, (out, err) in outs.items():
        doc = json.loads(out.strip().splitlines()[-1]) if out.strip() \
            else {}
        stale = [f for f in doc.get("findings", [])
                 if f.get("key", "").startswith("stale:")]
        if audits[name].returncode != 0 or not doc.get("ok") \
                or doc.get("n_findings") != 0 or stale:
            raise AssertionError(f"AN (b): {name} exit "
                                 f"{audits[name].returncode}: "
                                 f"{out[-3000:]} {err[-2000:]}")
    lint, threads = (json.loads(outs[n][0].strip().splitlines()[-1])
                     for n in ("lint", "threads"))
    log(f"AN (b): python -m photon_tpu_torch.lint --json: ok, "
        f"{lint['n_rules']} rules over {lint['n_files']} files, 0 findings, "
        f"{lint['n_suppressed']} waived, no stale waiver; --threads --json: "
        f"ok, {len(threads['model']['threads'])} thread entries, "
        f"{len(threads['model']['lock_edges'])} lock-order edges, no cycle, "
        f"0 findings  [{gpu}]")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=4096)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gpu = gpu_line()
    log(f"device: {torch.cuda.get_device_name(0)} ({gpu}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    lap("start")
    ptxas = phase_build()
    lap("build")
    phase_kernels(dev, ptxas["serving_int8"])
    phase_training_kernels(dev, ptxas["blocked_ell"])
    phase_fused_kernel(dev, ptxas["fused_vg"])
    lap("kernels")
    kernels = [phase_serving(args, dev, gpu)]
    torch.cuda.empty_cache()
    lap("serving")
    phase_tf_fleet(args, dev, gpu)
    tf_overheads(gpu)
    lap("TF (b), (c)")
    phase_tu_tuner(args, dev, gpu)
    lap("TU (a), (c)")
    state = phase_training(args, dev, gpu)
    kernels += phase_training_timings(state, gpu)
    phase_sparse_owlqn(state, dev, gpu)
    phase_ck_resident(state, dev, gpu)
    lap("T2, T3, CK (d)")
    phase_tf_tap(state, dev, gpu)
    lap("TF (a)")
    lanes8 = phase_grid_timings(state, phase_grid(state, dev, gpu), gpu)
    for entry in kernels:
        entry.update(lanes8.get(entry["name"], {}))
    lap("G")
    e_launches = phase_validation(args, state, dev, gpu)
    lap("E")
    phase_tu_lanes(args, state, dev, gpu)
    lap("TU (b), (e)")
    t2 = {k: state[k] for k in ("coo", "hist_a", "w5_model", "owlqn",
                                "solve_peak", "w40_model")}
    del state
    torch.cuda.empty_cache()
    s_launches, s_ref = phase_streamed(args, t2, dev, gpu)
    torch.cuda.empty_cache()
    lap("S (c)")
    mg, made = phase_mesh(t2, s_ref, dev, gpu, lambda: later_setup(args))
    lap("MG")
    phase_hybrid(t2, dev, gpu)
    del t2
    torch.cuda.empty_cache()
    lap("HY")
    state = phase_dense_owlqn(args, dev, gpu)
    phase_dense_tron(state, dev, gpu)
    phase_dense_grid(state, dev, gpu)
    kernels.append(phase_dense_timings(state, gpu))
    lap("D2-D5")
    phase_tu_bootstrap(args, state, dev, gpu)
    del state
    torch.cuda.empty_cache()
    lap("TU (e) bootstrap")
    gm, gs, gg, gm_data = phase_game(args, made.pop("gm"), dev, gpu)
    lap("CK (b)")
    gk = phase_game_kernels(args, dev, gpu)
    for name, c in phase_gk_ladder(args, dev, gpu).items():
        gs[name] = gs.get(name, 0) + c
    torch.cuda.empty_cache()
    lap("GK")
    drv = phase_drivers(args, made.pop("drv"), dev, gpu)
    torch.cuda.empty_cache()
    lap("DRV (b), (c)")
    drvs = phase_drivers_streamed(args, made.pop("drvs"), dev, gpu)
    torch.cuda.empty_cache()
    lap("DRV-S (b)-(d)")
    _, cr = phase_continual(args, gm_data, dev, gpu)
    del gm_data
    lap("CR")
    phase_pf_clis(gpu)
    lap("PF (b)")
    phase_an(dev, gpu)
    lap("AN")
    log(f"phase seconds: {json.dumps(LAPS)}; {sum(LAPS.values()):.1f} s "
        f"in all  [{gpu}]")
    for entry in kernels:
        entry["gm_launches"] = gm.get(entry["name"], 0)
        entry["gk_launches"] = gk.get(entry["name"], 0)
        entry["s_launches"] = s_launches.get(entry["name"], 0)
        entry["gs_launches"] = gs.get(entry["name"], 0)
        entry["e_launches"] = e_launches.get(entry["name"], 0)
        entry["gg_launches"] = gg.get(entry["name"], 0)
        entry["drv_launches"] = drv.get(entry["name"], 0)
        entry["drvs_launches"] = drvs.get(entry["name"], 0)
        entry["cr_launches"] = cr.get(entry["name"], 0)
        entry["ck_launches"] = CK_LAUNCHES.get(entry["name"], 0)
        entry["mg_launches"] = mg.get(entry["name"], 0)
        entry["gmm_launches"] = GMM_LAUNCHES.get(entry["name"], 0)
        entry["tf_launches"] = TF_LAUNCHES.get(entry["name"], 0)
        entry["tu_launches"] = TU_LAUNCHES.get(entry["name"], 0)
        entry["pf_launches"] = PF_LAUNCHES.get(entry["name"], 0)
        entry["hy_launches"] = HY_LAUNCHES.get(entry["name"], 0)
        entry["an_launches"] = AN_LAUNCHES.get(entry["name"], 0)
        entry.update(HY_TIMES.get(entry["name"], {}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
