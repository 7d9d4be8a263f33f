// The blocked-ELL X passes: two kernel bodies, each in a fused and a tiled
// form, for f32 or bf16 storage and for a vector or G lanes.
//
// Replaces the Pallas kernels of photon_tpu/kernels/blocked_ell.py:
//   bell_tail_matvec_kernel, all items     tail_matvec          (_tail_call)
//   bell_tail_matvec_kernel, per bucket    tail_matvec_tiled    (_tiled_tail_call)
//   bell_bucket_rmatvec_kernel, all items  bucket_rmatvec       (_rmatvec_call)
//   bell_bucket_rmatvec_kernel, per bucket bucket_rmatvec_tiled (_tiled_rmatvec_call)
//
// What they compute (the reference's _bell_compute dtype recipe):
//   tail matvec  out[i, g] += sum_w f32(pv[p, w]) * f32(S(wt[pc[p, w], g]))
//                for every row i with a tail, p its place in the
//                concatenation of the width buckets (row_pos[i] = p, i =
//                tail_rows[p]), wt = w[d_sel:n_prefix]; rows with no tail
//                are left as they are, and a position p that no row takes
//                (tail_rows[p] < 0: a padded row of a chunk ladder's width
//                bucket) writes nothing
//   rmatvec      out[c, g] = sum_k f32(bv[c, k]) * f32(S(r[br[c, k], g]))
//   square       out[c, g] = sum_k (f32(bv[c, k]) * f32(bv[c, k])) * r[br[c, k], g]
// where S rounds to the storage dtype: to bf16 when the values are bf16
// (the product of two bf16 values is then exact in f32), nothing when they
// are f32. In square mode the cotangent is not rounded, and neither is it
// when the caller asks for it unrounded (round_r = 0: the permuted hybrid
// layout's recipe, whose occurrence buckets are laid as blocked-ELL's; one
// more instantiation, bf16 values by an f32 cotangent). Sums accumulate in
// f32 in slot order with Kahan compensation: an occurrence bucket can hold
// thousands of slots, and a plain running f32 sum that long drifts by
// ~sqrt(k) ulp of its terms, while the compensated sum stays within a few
// ulp of the exact one (the extra adds cost nothing in a gather-bound
// loop).
//
// Buckets arrive as a small device array of Bucket descriptors (pointers,
// shape, first position in the concatenation of their kind) packed once
// per layout by photon_tpu_torch/kernels/blocked_ell.py (layout_plan), so
// one compiled kernel serves every layout.
//
// Tail matvec design. Bound: bytes — every ELL slot once (4 B column id +
// 2 B bf16 or 4 B f32 value), the distinct coefficients the slots touch,
// and the output; one multiply-add per slot. The work is ~1.7 M short rows
// (W_b = 1 ... 16 at the training path's headline layout), each a few
// loads of 4 B at scattered places (its coefficients, its output), so what
// costs is the 32 B sectors those move through L2 and how many of them are
// in flight, more than the bytes of the bound. The host builds a work plan
// once per layout (tail_plan in blocked_ell.py): each TailItem is one
// block's worth of consecutive rows of ONE width bucket, so the width is
// uniform in a block and no thread looks for its bucket; the descriptors
// are staged in shared memory while the item loads. A thread takes R =
// rows_per_thread(W_b) = max(1, 4 / W_b) rows (t, t + 256, ...), so it
// holds at least 4 slots whatever the width (8 or 16 slots, or six blocks
// per SM, measured slower at the headline layout: chip_tail_ab.py). The
// body is specialised per width by a switch on it (W_b = 1, 2, 4, 8, 16
// unrolled; a loop over 4-slot steps beyond): for a vector a thread
// issues the original index (from the inverse map tail_rows), ids and
// values of all R rows at once (16 B id loads and 8 B / 16 B value loads
// where W_b % 4 == 0, 8 B / 4 B for W_b == 2; evict-first, the slot
// stream is read once), then the R current outputs and all R * W_b
// gathers, so a warp waits out two load latencies per R rows, not one per
// slot. Each row's Kahan sum, taken in slot order, is added into out at
// its row: out[row] = out[row] + (acc - comp), one f32 add, so the
// caller's hot-block product takes the tail term in place, with no
// concatenation, no zero slot and no row_pos gather. Lanes live inside the
// thread as in the rmatvec (add_slot), one row after another. Each row is
// written by one thread with no atomics; the fused form (one launch over
// every item, widest bucket first) and the tiled form (one launch per
// bucket over that bucket's items) run the same per-row arithmetic, so
// they give the same bits as each other. Every launch of a call is made by
// one call of the C entry point, so a tiled call crosses from Python to C
// once, not once per bucket.
//
// Rmatvec design. Bound: bytes — every occurrence-bucket slot once (4 B row
// id + 2 B bf16 or 4 B f32 value), the cotangent rows the slots touch and
// 4 B per output per lane, one multiply-add per slot. The buckets' widths
// span k_b = 1 ... thousands, so one thread per column would leave the few
// longest columns walking thousands of dependent gathers each on a handful
// of SMs after the rest of the grid has finished. Instead the host builds a
// work plan per layout once (rmatvec_plan in blocked_ell.py, in the same
// layout_plan): each WorkItem is up to one block's worth of columns of one
// bucket, each column summed by a group of tpc = clamp(k_b / S, 1, kThreads)
// threads (a power of two; S = SLOTS_PER_THREAD = 8 in blocked_ell.py), so
// no thread walks more than max(S, k_b / kThreads) slots; items come longest
// walk first. A block takes one item: no thread scans the descriptors.
// - Slot loads are coalesced: for k_b % 4 == 0 thread j of a group reads
//   slots 4j .. 4j + 3 with one 16 B load of row ids and one 8 B (bf16) or
//   16 B (f32) load of values, then strides by 4 * tpc; neighbouring threads
//   read neighbouring addresses (other widths: scalar loads, stride tpc).
//   The slot stream is read once, so it is loaded evict-first (__ldcs) to
//   leave L2 to the gathered cotangent: at the training path's headline
//   layout that measured 1-3% faster than cached loads (__ldg), warm and
//   cold L2, vector and 8 lanes (chip_rmatvec_ab.py on an H100 SXM, 700 W),
//   so it stays. No cp.async ring streams a column's slots through shared
//   memory: a thread walks at most 8 slots of a typical column.
// - Lanes live inside the thread: for an (n, G) cotangent a thread takes
//   all G lanes of each slot it owns (in chunks of kLaneChunk registers),
//   so a slot's gather reads G contiguous floats instead of G scattered
//   ones.
// - The reduction is fixed-order and compensated, with no atomics: each
//   thread Kahan-sums its slots in slot order, a group of <= 32 threads
//   merges its (sum, compensation) pairs by a fixed xor-shuffle tree with
//   TwoSum, and groups of more than one warp merge their warps' pairs
//   through shared memory in warp order. One thread writes each output.
//   Two launches on the same inputs give the same bits; the fused form (one
//   launch over every item) and the tiled form (one launch per bucket over
//   that bucket's items, into its slice of the same output) run the same
//   items, so they give the same bits as each other.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// One bucket: a (rows, width) int32 index matrix and a value matrix of the
// same shape (f32 or bf16), and the bucket's first position in the
// concatenation of all buckets of its kind. photon_tpu_torch/kernels/
// blocked_ell.py (_DESC_FIELDS) packs the same fields in the same order.
struct Bucket {
  long long idx;    // const int32_t*: column (matvec) or row (rmatvec) ids
  long long val;    // const float* or const __nv_bfloat16*
  long long rows;
  long long width;
  long long base;
};

// One item of the rmatvec's work plan: `cols` columns of occurrence bucket
// `bucket`, from its column `col0` on, each summed by a group of `tpc`
// threads (a power of two, cols * tpc <= kThreads). photon_tpu_torch/
// kernels/blocked_ell.py (_PLAN_FIELDS, rmatvec_plan) packs the same fields
// in the same order.
struct WorkItem {
  int32_t bucket;
  int32_t col0;
  int32_t cols;
  int32_t tpc;
};

// One item of the tail matvec's work plan: `rows` rows of ELL width bucket
// `bucket`, from its row `row0` on, at most rows_per_thread(width) rows per
// thread (rows <= kThreads * rows_per_thread(width)).
// photon_tpu_torch/kernels/blocked_ell.py (_TAIL_FIELDS, tail_plan) packs
// the same fields in the same order.
struct TailItem {
  int32_t bucket;
  int32_t row0;
  int32_t rows;
};

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLaneChunk = 8;  // lanes a thread holds in registers at once
constexpr int kTailSlotsPerThread = 4;  // tail slots a thread holds at once
constexpr int kMaxTailBuckets = 32;  // ELL width buckets a layout may have

// The rows one thread of the tail kernel takes in a bucket of width w (0:
// any width past 16): kTailSlotsPerThread / w, at least 1. blocked_ell.py
// (rows_per_thread) computes the same.
__host__ __device__ constexpr int rows_per_thread(int w) {
  return w <= 0 || w >= kTailSlotsPerThread ? 1 : kTailSlotsPerThread / w;
}

// The gathered operand in the storage dtype, back in f32.
template <bool kBf16>
__device__ __forceinline__ float to_storage(float x) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// acc += a * b with Kahan compensation carried in comp.
__device__ __forceinline__ void kahan_fma(float a, float b, float& acc,
                                          float& comp) {
  const float y = fmaf(a, b, -comp);
  const float t = acc + y;
  comp = (t - acc) - y;
  acc = t;
}

// Merge two compensated sums (acc - comp each) into (acc, comp): the
// rounding error of acc + other_acc (TwoSum, exact) joins the
// compensations. A copy of fused_vg.cu's kahan_merge (the sources build
// separately).
__device__ __forceinline__ void kahan_merge(float other_acc,
                                            float other_comp, float& acc,
                                            float& comp) {
  const float s = acc + other_acc;
  const float bp = s - acc;
  const float err = (acc - (s - bp)) + (other_acc - bp);
  comp = (comp + other_comp) - err;
  acc = s;
}

// Four consecutive values of a bucket from element i (i % 4 == 0), loaded
// evict-first in one 16 B (f32) or 8 B (bf16) load.
template <bool kBf16>
__device__ __forceinline__ void load_values4(long long p, long long i,
                                             float (&v)[4]) {
  if constexpr (kBf16) {
    const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p) + i / 4);
    v[0] = __uint_as_float(u.x << 16);
    v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16);
    v[3] = __uint_as_float(u.y & 0xffff0000u);
  } else {
    const float4 f = __ldcs(reinterpret_cast<const float4*>(p) + i / 4);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
}

template <bool kBf16>
__device__ __forceinline__ float load_value_cs(long long p, long long i) {
  if constexpr (kBf16) {
    const unsigned short u =
        __ldcs(reinterpret_cast<const unsigned short*>(p) + i);
    return __uint_as_float(static_cast<unsigned int>(u) << 16);
  } else {
    return __ldcs(reinterpret_cast<const float*>(p) + i);
  }
}

// acc[g] += f(v) * f(r[row, g0 + g]) for the nl (<= kChunk) lanes of one
// slot, the slot's G floats read together (16 B loads when vec4); r is
// rounded to the storage dtype unless kSquare or not kRound.
template <bool kBf16, bool kSquare, bool kRound, int kChunk>
__device__ __forceinline__ void add_slot(const float* __restrict__ r,
                                         int lanes, int g0, int nl,
                                         bool vec4, int32_t row, float v,
                                         float (&acc)[kChunk],
                                         float (&comp)[kChunk]) {
  const float* rr = r + static_cast<long long>(row) * lanes + g0;
  float x[kChunk];
  if (kChunk % 4 == 0 && vec4) {
#pragma unroll
    for (int q = 0; q < kChunk / 4; ++q) {
      if (4 * q < nl) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(rr) + q);
        x[4 * q] = t.x;
        x[4 * q + 1] = t.y;
        x[4 * q + 2] = t.z;
        x[4 * q + 3] = t.w;
      }
    }
  } else {
#pragma unroll
    for (int g = 0; g < kChunk; ++g) {
      if (g < nl) x[g] = __ldg(rr + g);
    }
  }
  const float vv = kSquare ? __fmul_rn(v, v) : v;
#pragma unroll
  for (int g = 0; g < kChunk; ++g) {
    if (g < nl) {
      kahan_fma(vv, kSquare || !kRound ? x[g] : to_storage<kBf16>(x[g]),
                acc[g], comp[g]);
    }
  }
}

// The kW ids and values of one ELL row, from element off of its bucket (a
// multiple of kW), all loads issued together and evict-first: 16 B id
// loads and 8 B (bf16) or 16 B (f32) value loads for kW % 4 == 0, one 8 B
// id load and one 4 B / 8 B value load for kW == 2, scalar loads for 1.
template <bool kBf16, int kW>
__device__ __forceinline__ void load_row(const Bucket& bk, long long off,
                                         int32_t (&id)[kW], float (&v)[kW]) {
  const int32_t* pc = reinterpret_cast<const int32_t*>(bk.idx) + off;
  if constexpr (kW % 4 == 0) {
#pragma unroll
    for (int q = 0; q < kW / 4; ++q) {
      const int4 t = __ldcs(reinterpret_cast<const int4*>(pc) + q);
      id[4 * q] = t.x;
      id[4 * q + 1] = t.y;
      id[4 * q + 2] = t.z;
      id[4 * q + 3] = t.w;
      float f[4];
      load_values4<kBf16>(bk.val, off + 4 * q, f);
#pragma unroll
      for (int k = 0; k < 4; ++k) v[4 * q + k] = f[k];
    }
  } else if constexpr (kW == 2) {
    const int2 t = __ldcs(reinterpret_cast<const int2*>(pc));
    id[0] = t.x;
    id[1] = t.y;
    if constexpr (kBf16) {
      const unsigned int u =
          __ldcs(reinterpret_cast<const unsigned int*>(bk.val) + off / 2);
      v[0] = __uint_as_float(u << 16);
      v[1] = __uint_as_float(u & 0xffff0000u);
    } else {
      const float2 f =
          __ldcs(reinterpret_cast<const float2*>(bk.val) + off / 2);
      v[0] = f.x;
      v[1] = f.y;
    }
  } else {
    static_assert(kW == 1, "ELL widths are powers of two");
    id[0] = __ldcs(pc);
    v[0] = load_value_cs<kBf16>(bk.val, off);
  }
}

// out[row, g0 + g] += acc[g] - comp[g] for the chunk's nl lanes: one f32
// add of the compensated sum into what out holds.
template <int kChunk>
__device__ __forceinline__ void add_to_row(float* __restrict__ out,
                                           int32_t row, int lanes, int g0,
                                           int nl, const float (&acc)[kChunk],
                                           const float (&comp)[kChunk]) {
  float* o = out + static_cast<long long>(row) * lanes + g0;
#pragma unroll
  for (int g = 0; g < kChunk; ++g) {
    if (g < nl) o[g] = __fadd_rn(o[g], __fsub_rn(acc[g], comp[g]));
  }
}

// Row p of bucket bk, of width kW (unrolled) or, for kW == 0, of bk.width
// (a loop over 4-slot steps: widths past 16 are multiples of 4): its Kahan
// sum per lane chunk, in slot order, added into out at its original row.
template <bool kBf16, int kChunk, int kW>
__device__ __forceinline__ void tail_row(const Bucket& bk, long long p,
                                         int32_t row,
                                         const float* __restrict__ wt,
                                         int lanes, int vec4,
                                         float* __restrict__ out) {
  if constexpr (kW > 0) {
    int32_t id[kW];
    float v[kW];
    load_row<kBf16, kW>(bk, p * kW, id, v);
    for (int g0 = 0; g0 < lanes; g0 += kChunk) {
      const int nl = min(kChunk, lanes - g0);
      float acc[kChunk], comp[kChunk];
#pragma unroll
      for (int g = 0; g < kChunk; ++g) acc[g] = comp[g] = 0.f;
#pragma unroll
      for (int j = 0; j < kW; ++j) {
        add_slot<kBf16, false, true>(wt, lanes, g0, nl, vec4, id[j], v[j],
                                     acc, comp);
      }
      add_to_row(out, row, lanes, g0, nl, acc, comp);
    }
  } else {
    const long long k = bk.width;
    const long long off = p * k;
    const int32_t* pc = reinterpret_cast<const int32_t*>(bk.idx) + off;
    for (int g0 = 0; g0 < lanes; g0 += kChunk) {
      const int nl = min(kChunk, lanes - g0);
      float acc[kChunk], comp[kChunk];
#pragma unroll
      for (int g = 0; g < kChunk; ++g) acc[g] = comp[g] = 0.f;
#pragma unroll 2
      for (long long s = 0; s < k; s += 4) {
        const int4 id = __ldcs(reinterpret_cast<const int4*>(pc + s));
        float v[4];
        load_values4<kBf16>(bk.val, off + s, v);
        add_slot<kBf16, false, true>(wt, lanes, g0, nl, vec4, id.x, v[0],
                                     acc, comp);
        add_slot<kBf16, false, true>(wt, lanes, g0, nl, vec4, id.y, v[1],
                                     acc, comp);
        add_slot<kBf16, false, true>(wt, lanes, g0, nl, vec4, id.z, v[2],
                                     acc, comp);
        add_slot<kBf16, false, true>(wt, lanes, g0, nl, vec4, id.w, v[3],
                                     acc, comp);
      }
      add_to_row(out, row, lanes, g0, nl, acc, comp);
    }
  }
}

// A vector's kR rows of width kW (kW * kR <= kTailSlotsPerThread, or kR =
// 1) for one
// thread, rows t, t + kThreads, ... of the item: every row's original
// index, ids and values are loaded first (coalesced across the warp), then
// the rows' current outputs and all kW * kR gathers, then each row's Kahan
// sum in slot order is added into its output.
template <bool kBf16, int kW, int kR>
__device__ __forceinline__ void tail_rows_vec(
    const Bucket& bk, const TailItem& it,
    const int32_t* __restrict__ tail_rows, const float* __restrict__ wt,
    float* __restrict__ out) {
  int32_t id[kR][kW], row[kR];
  float v[kR][kW], x[kR][kW], o[kR];
  const int t = static_cast<int>(threadIdx.x);
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    row[j] = -1;
    if (t + j * kThreads < it.rows) {
      const long long p = static_cast<long long>(it.row0) + t + j * kThreads;
      row[j] = __ldcs(tail_rows + bk.base + p);
      load_row<kBf16, kW>(bk, p * kW, id[j], v[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    if (row[j] >= 0) {
      o[j] = out[row[j]];
#pragma unroll
      for (int k = 0; k < kW; ++k) x[j][k] = __ldg(wt + id[j][k]);
    }
  }
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    if (row[j] >= 0) {
      float acc = 0.f, comp = 0.f;
#pragma unroll
      for (int k = 0; k < kW; ++k) {
        kahan_fma(v[j][k], to_storage<kBf16>(x[j][k]), acc, comp);
      }
      out[row[j]] = __fadd_rn(o[j], __fsub_rn(acc, comp));
    }
  }
}

// One item's rows of a width-kW bucket (kW == 0: any wider width): a
// vector takes the multi-row body, lanes one row after another.
template <bool kBf16, int kChunk, int kW>
__device__ __forceinline__ void tail_item(const Bucket& bk,
                                          const TailItem& it,
                                          const int32_t* __restrict__ tail_rows,
                                          const float* __restrict__ wt,
                                          int lanes, int vec4,
                                          float* __restrict__ out) {
  constexpr int kR = rows_per_thread(kW);
  if constexpr (kChunk == 1 && kW > 0) {
    tail_rows_vec<kBf16, kW, kR>(bk, it, tail_rows, wt, out);
  } else {
#pragma unroll 1
    for (int j = 0; j < kR; ++j) {
      const int r = static_cast<int>(threadIdx.x) + j * kThreads;
      if (r < it.rows) {
        const long long p = static_cast<long long>(it.row0) + r;
        const int32_t row = __ldcs(tail_rows + bk.base + p);
        if (row >= 0) {
          tail_row<kBf16, kChunk, kW>(bk, p, row, wt, lanes, vec4, out);
        }
      }
    }
  }
}

// One block per TailItem, its rows of one bucket (the width is
// block-uniform, so the switch does not diverge). The nb descriptors are
// staged in shared memory while the item loads, so the descriptor is not
// one more load on each thread's chain.
template <bool kBf16, int kChunk>
__global__ void __launch_bounds__(kThreads)
bell_tail_matvec_kernel(const Bucket* __restrict__ buckets, int nb,
                        const TailItem* __restrict__ items,
                        const int32_t* __restrict__ tail_rows,
                        const float* __restrict__ wt, int lanes, int vec4,
                        float* __restrict__ out) {
  __shared__ Bucket staged[kMaxTailBuckets];
  if (static_cast<int>(threadIdx.x) < nb) {
    staged[threadIdx.x] = buckets[threadIdx.x];
  }
  const TailItem it = items[blockIdx.x];
  __syncthreads();
  const Bucket bk = staged[it.bucket];
  switch (bk.width) {
    case 1:
      tail_item<kBf16, kChunk, 1>(bk, it, tail_rows, wt, lanes, vec4, out);
      break;
    case 2:
      tail_item<kBf16, kChunk, 2>(bk, it, tail_rows, wt, lanes, vec4, out);
      break;
    case 4:
      tail_item<kBf16, kChunk, 4>(bk, it, tail_rows, wt, lanes, vec4, out);
      break;
    case 8:
      tail_item<kBf16, kChunk, 8>(bk, it, tail_rows, wt, lanes, vec4, out);
      break;
    case 16:
      tail_item<kBf16, kChunk, 16>(bk, it, tail_rows, wt, lanes, vec4, out);
      break;
    default:
      tail_item<kBf16, kChunk, 0>(bk, it, tail_rows, wt, lanes, vec4, out);
  }
}

// One block per WorkItem. Thread t of the block works on column
// col0 + t / tpc of the item's bucket as member j = t % tpc of its group;
// see the header for the load pattern and the reduction.
template <bool kBf16, bool kSquare, bool kRound, int kChunk>
__global__ void __launch_bounds__(kThreads)
bell_bucket_rmatvec_kernel(const Bucket* __restrict__ buckets,
                           const WorkItem* __restrict__ items,
                           const float* __restrict__ r, int lanes, int vec4,
                           float* __restrict__ out) {
  __shared__ float2 part[kWarps][kChunk];  // (sum, comp) per warp and lane
  const WorkItem it = items[blockIdx.x];
  const Bucket bk = buckets[it.bucket];
  const int tpc = it.tpc;
  const int c = static_cast<int>(threadIdx.x) / tpc;
  const int j = static_cast<int>(threadIdx.x) - c * tpc;
  const bool live = c < it.cols;
  const long long col = static_cast<long long>(it.col0) + c;
  const long long k = bk.width;
  const long long off = col * k;
  const int32_t* br = reinterpret_cast<const int32_t*>(bk.idx) + off;
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  for (int g0 = 0; g0 < lanes; g0 += kChunk) {
    const int nl = min(kChunk, lanes - g0);
    float acc[kChunk], comp[kChunk];
#pragma unroll
    for (int g = 0; g < kChunk; ++g) acc[g] = comp[g] = 0.f;
    if (live) {
      if ((k & 3) == 0) {
#pragma unroll 2
        for (long long s = 4LL * j; s < k; s += 4LL * tpc) {
          const int4 id = __ldcs(reinterpret_cast<const int4*>(br + s));
          float v[4];
          load_values4<kBf16>(bk.val, off + s, v);
          add_slot<kBf16, kSquare, kRound>(r, lanes, g0, nl, vec4, id.x,
                                           v[0], acc, comp);
          add_slot<kBf16, kSquare, kRound>(r, lanes, g0, nl, vec4, id.y,
                                           v[1], acc, comp);
          add_slot<kBf16, kSquare, kRound>(r, lanes, g0, nl, vec4, id.z,
                                           v[2], acc, comp);
          add_slot<kBf16, kSquare, kRound>(r, lanes, g0, nl, vec4, id.w,
                                           v[3], acc, comp);
        }
      } else {
        for (long long s = j; s < k; s += tpc) {
          add_slot<kBf16, kSquare, kRound>(
              r, lanes, g0, nl, vec4, __ldcs(br + s),
              load_value_cs<kBf16>(bk.val, off + s), acc, comp);
        }
      }
    }
    // the group's pairs, by a fixed xor tree (groups never straddle a warp
    // boundary: tpc and 32 are powers of two)
    for (int o = min(tpc, 32) / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int g = 0; g < kChunk; ++g) {
        const float oa = __shfl_xor_sync(0xffffffffu, acc[g], o);
        const float oc = __shfl_xor_sync(0xffffffffu, comp[g], o);
        kahan_merge(oa, oc, acc[g], comp[g]);
      }
    }
    if (tpc > 32) {  // block-uniform: the item sets tpc
      if ((threadIdx.x & 31) == 0) {
#pragma unroll
        for (int g = 0; g < kChunk; ++g) {
          part[warp][g] = make_float2(acc[g], comp[g]);
        }
      }
      __syncthreads();
      if (j == 0) {
        for (int w = 1; w < tpc / 32; ++w) {
#pragma unroll
          for (int g = 0; g < kChunk; ++g) {
            kahan_merge(part[warp + w][g].x, part[warp + w][g].y, acc[g],
                        comp[g]);
          }
        }
      }
      __syncthreads();  // part is rewritten by the next lane chunk
    }
    if (live && j == 0) {
      float* o = out + (bk.base + col) * lanes + g0;
#pragma unroll
      for (int g = 0; g < kChunk; ++g) {
        if (g < nl) o[g] = __fsub_rn(acc[g], comp[g]);
      }
    }
  }
}

template <bool kBf16, bool kSquare, bool kRound = true>
void launch_rmatvec(const Bucket* b, const WorkItem* items, int n_items,
                    const float* r, int lanes, int vec4, float* o,
                    cudaStream_t s) {
  if (lanes == 1) {
    bell_bucket_rmatvec_kernel<kBf16, kSquare, kRound, 1>
        <<<n_items, kThreads, 0, s>>>(b, items, r, lanes, vec4, o);
  } else {
    bell_bucket_rmatvec_kernel<kBf16, kSquare, kRound, kLaneChunk>
        <<<n_items, kThreads, 0, s>>>(b, items, r, lanes, vec4, o);
  }
}

template <bool kBf16>
void launch_tail(const Bucket* b, int nb, const TailItem* items, int n_items,
                 const int32_t* tail_rows, const float* wt, int lanes,
                 int vec4, float* o, cudaStream_t s) {
  if (lanes == 1) {
    bell_tail_matvec_kernel<kBf16, 1><<<n_items, kThreads, 0, s>>>(
        b, nb, items, tail_rows, wt, lanes, vec4, o);
  } else {
    bell_tail_matvec_kernel<kBf16, kLaneChunk><<<n_items, kThreads, 0, s>>>(
        b, nb, items, tail_rows, wt, lanes, vec4, o);
  }
}

}  // namespace

// Both entry points take their work plan's items on the device and, on the
// host, n_ranges (first, end) pairs of item indices: one launch per
// non-empty range, all from this one call (the fused form passes one range
// over every item, the tiled form one per bucket). Each returns the
// cudaError_t of its first failed launch, or 0.

// Tail matvec: row p of bucket b adds its term into out[tail_rows[
// buckets[b].base + p]], or nothing where that entry is negative (out is
// (n, lanes), wt the (U, lanes) tail slice
// of the coefficients; nb <= kMaxTailBuckets). The first zero_bytes of out
// are zeroed first (a new output: the call then returns the tail alone).
extern "C" __attribute__((visibility("default"))) int
photon_bell_tail_matvec(const void* buckets, int nb, const void* items,
                        const void* tail_rows, int bf16, const int* ranges,
                        int n_ranges, const void* wt, int lanes, void* out,
                        long long zero_bytes, void* stream) {
  if (nb > kMaxTailBuckets) return static_cast<int>(cudaErrorInvalidValue);
  const auto* b = static_cast<const Bucket*>(buckets);
  const auto* it = static_cast<const TailItem*>(items);
  const auto* tr = static_cast<const int32_t*>(tail_rows);
  const auto* w = static_cast<const float*>(wt);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (zero_bytes > 0) {
    const cudaError_t err =
        cudaMemsetAsync(out, 0, static_cast<size_t>(zero_bytes), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int vec4 =
      lanes % 4 == 0 && reinterpret_cast<uintptr_t>(wt) % 16 == 0;
  for (int k = 0; k < n_ranges; ++k) {
    const int lo = ranges[2 * k], n_items = ranges[2 * k + 1] - lo;
    if (n_items <= 0) continue;
    if (bf16) {
      launch_tail<true>(b, nb, it + lo, n_items, tr, w, lanes, vec4, o, s);
    } else {
      launch_tail<false>(b, nb, it + lo, n_items, tr, w, lanes, vec4, o, s);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// Occurrence-bucket rmatvec: column c of bucket b lands in out[buckets[b]
// .base + c] (out is (U, lanes), U the total of the buckets' columns); a
// bf16 layout's cotangent is rounded to bf16 unless square or round_r is 0
// (f32 values: nothing to round either way).
extern "C" __attribute__((visibility("default"))) int
photon_bell_bucket_rmatvec(const void* buckets, const void* items, int bf16,
                           const int* ranges, int n_ranges, const void* r,
                           int lanes, int square, int round_r, void* out,
                           void* stream) {
  const auto* b = static_cast<const Bucket*>(buckets);
  const auto* it = static_cast<const WorkItem*>(items);
  const auto* rr = static_cast<const float*>(r);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const int vec4 =
      lanes % 4 == 0 && reinterpret_cast<uintptr_t>(r) % 16 == 0;
  for (int k = 0; k < n_ranges; ++k) {
    const int lo = ranges[2 * k], n = ranges[2 * k + 1] - lo;
    if (n <= 0) continue;
    if (square) {
      if (bf16) {
        launch_rmatvec<true, true>(b, it + lo, n, rr, lanes, vec4, o, s);
      } else {
        launch_rmatvec<false, true>(b, it + lo, n, rr, lanes, vec4, o, s);
      }
    } else if (bf16 && !round_r) {
      launch_rmatvec<true, false, false>(b, it + lo, n, rr, lanes, vec4, o,
                                         s);
    } else if (bf16) {
      launch_rmatvec<true, false>(b, it + lo, n, rr, lanes, vec4, o, s);
    } else {
      launch_rmatvec<false, false>(b, it + lo, n, rr, lanes, vec4, o, s);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

extern "C" __attribute__((visibility("default"))) const char*
photon_bell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
