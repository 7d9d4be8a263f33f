// The blocked-ELL X passes: two kernel bodies, each in a fused and a tiled
// form, for f32 or bf16 storage and for a vector or G lanes.
//
// Replaces the Pallas kernels of photon_tpu/kernels/blocked_ell.py:
//   bell_tail_matvec_kernel with row_pos   tail_matvec          (_tail_call)
//   bell_tail_matvec_kernel, one bucket    tail_matvec_tiled    (_tiled_tail_call)
//   bell_bucket_rmatvec_kernel, all items  bucket_rmatvec       (_rmatvec_call)
//   bell_bucket_rmatvec_kernel, per bucket bucket_rmatvec_tiled (_tiled_rmatvec_call)
//
// What they compute (the reference's _bell_compute dtype recipe):
//   tail matvec  out[i, g] = sum_w f32(pv[p, w]) * f32(S(wt[pc[p, w], g]))
//                with p = row_pos[i] the row's place in the concatenation
//                of the width buckets (p = B, past every bucket, is the
//                zero slot of a row with no tail), wt = w[d_sel:n_prefix]
//   rmatvec      out[c, g] = sum_k f32(bv[c, k]) * f32(S(r[br[c, k], g]))
//   square       out[c, g] = sum_k (f32(bv[c, k]) * f32(bv[c, k])) * r[br[c, k], g]
// where S rounds to the storage dtype: to bf16 when the values are bf16
// (the product of two bf16 values is then exact in f32), nothing when they
// are f32. In square mode the cotangent is not rounded. Sums accumulate in
// f32 in slot order with Kahan compensation: an occurrence bucket can hold
// thousands of slots, and a plain running f32 sum that long drifts by
// ~sqrt(k) ulp of its terms, while the compensated sum stays within a few
// ulp of the exact one (the extra adds cost nothing in a gather-bound
// loop).
//
// Tail matvec design. One thread per output element (row, lane), looping
// over that row's W_b slots: every output is written by one thread, with
// no atomics, so the order is fixed. Buckets arrive as a small device array
// of Bucket descriptors (pointers, shape, first position in the
// concatenation) packed by photon_tpu_torch/kernels/blocked_ell.py, so one
// compiled kernel serves every layout. The fused form launches once over
// all n rows; a thread finds its bucket by scanning the descriptors'
// bases. The tiled form launches once per bucket with that bucket's
// descriptor alone, over its rows in blocks of kThreads (the tile), and the
// caller concatenates the buckets and gathers by row_pos, as the reference
// does outside its tiled kernels. Bound: bytes (every ELL slot, 4 B index +
// 2 B bf16 or 4 B f32 value, the distinct coefficients it touches, 4 B per
// output per lane; one multiply-add per slot). Making it fast is later
// work.
//
// Rmatvec design. Bound: bytes — every occurrence-bucket slot once (4 B row
// id + 2 B bf16 or 4 B f32 value), the cotangent rows the slots touch and
// 4 B per output per lane, one multiply-add per slot. The buckets' widths
// span k_b = 1 ... thousands, so one thread per column would leave the few
// longest columns walking thousands of dependent gathers each on a handful
// of SMs after the rest of the grid has finished. Instead the host builds a
// work plan per layout once (rmatvec_plan in blocked_ell.py, cached beside
// the descriptors): each WorkItem is up to one block's worth of columns of one
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

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLaneChunk = 8;  // lanes a thread holds in registers at once

template <bool kBf16>
__device__ __forceinline__ float load_value(long long p, long long i) {
  if constexpr (kBf16) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
  } else {
    return reinterpret_cast<const float*>(p)[i];
  }
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

// The bucket holding concatenation position p, or nb when p lies past
// every bucket (the matvec's zero slot). Positions start at b[0].base.
__device__ __forceinline__ int find_bucket(const Bucket* __restrict__ b,
                                           int nb, long long p) {
  for (int i = 0; i < nb; ++i) {
    if (p < b[i].base + b[i].rows) return i;
  }
  return nb;
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
bell_tail_matvec_kernel(const Bucket* __restrict__ buckets, int nb,
                        const int32_t* __restrict__ row_pos,
                        const float* __restrict__ wt, int lanes,
                        long long n_rows, float* __restrict__ out) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (t >= n_rows * lanes) return;
  const long long i = t / lanes;
  const int g = static_cast<int>(t - i * lanes);
  const long long p = row_pos ? static_cast<long long>(row_pos[i])
                              : buckets[0].base + i;
  const int b = find_bucket(buckets, nb, p);
  float acc = 0.f, comp = 0.f;
  if (b < nb) {
    const Bucket bk = buckets[b];
    const long long off = (p - bk.base) * bk.width;
    const int32_t* pc = reinterpret_cast<const int32_t*>(bk.idx) + off;
    for (long long j = 0; j < bk.width; ++j) {
      const float v = load_value<kBf16>(bk.val, off + j);
      const float c =
          to_storage<kBf16>(wt[static_cast<long long>(pc[j]) * lanes + g]);
      kahan_fma(v, c, acc, comp);
    }
  }
  out[t] = acc;
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
// slot, the slot's G floats read together (16 B loads when vec4).
template <bool kBf16, bool kSquare, int kChunk>
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
      kahan_fma(vv, kSquare ? x[g] : to_storage<kBf16>(x[g]), acc[g],
                comp[g]);
    }
  }
}

// One block per WorkItem. Thread t of the block works on column
// col0 + t / tpc of the item's bucket as member j = t % tpc of its group;
// see the header for the load pattern and the reduction.
template <bool kBf16, bool kSquare, int kChunk>
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
          add_slot<kBf16, kSquare>(r, lanes, g0, nl, vec4, id.x, v[0], acc,
                                   comp);
          add_slot<kBf16, kSquare>(r, lanes, g0, nl, vec4, id.y, v[1], acc,
                                   comp);
          add_slot<kBf16, kSquare>(r, lanes, g0, nl, vec4, id.z, v[2], acc,
                                   comp);
          add_slot<kBf16, kSquare>(r, lanes, g0, nl, vec4, id.w, v[3], acc,
                                   comp);
        }
      } else {
        for (long long s = j; s < k; s += tpc) {
          add_slot<kBf16, kSquare>(r, lanes, g0, nl, vec4, __ldcs(br + s),
                                   load_value_cs<kBf16>(bk.val, off + s),
                                   acc, comp);
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

template <bool kBf16, bool kSquare>
void launch_rmatvec(const Bucket* b, const WorkItem* items, int n_items,
                    const float* r, int lanes, int vec4, float* o,
                    cudaStream_t s) {
  if (lanes == 1) {
    bell_bucket_rmatvec_kernel<kBf16, kSquare, 1>
        <<<n_items, kThreads, 0, s>>>(b, items, r, lanes, vec4, o);
  } else {
    bell_bucket_rmatvec_kernel<kBf16, kSquare, kLaneChunk>
        <<<n_items, kThreads, 0, s>>>(b, items, r, lanes, vec4, o);
  }
}

unsigned int blocks_for(long long threads) {
  return static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
}

}  // namespace

// Tail matvec over n_rows rows on `stream`: with row_pos, the fused form
// (every bucket, rows in original order, out (n_rows, lanes)); with
// row_pos null, the tiled form over the one bucket `buckets` points at
// (out (rows, lanes)). Returns the cudaError_t of the launch.
extern "C" __attribute__((visibility("default"))) int
photon_bell_tail_matvec(const void* buckets, int nb, const void* row_pos,
                        const void* wt, int lanes, long long n_rows, int bf16,
                        void* out, void* stream) {
  if (n_rows <= 0) return 0;
  const auto* b = static_cast<const Bucket*>(buckets);
  const auto* rp = static_cast<const int32_t*>(row_pos);
  const auto* w = static_cast<const float*>(wt);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned int grid = blocks_for(n_rows * lanes);
  if (bf16) {
    bell_tail_matvec_kernel<true><<<grid, kThreads, 0, s>>>(
        b, nb, rp, w, lanes, n_rows, o);
  } else {
    bell_tail_matvec_kernel<false><<<grid, kThreads, 0, s>>>(
        b, nb, rp, w, lanes, n_rows, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// Occurrence-bucket rmatvec over n_items work items on `stream`: the fused
// form passes every item of the plan, the tiled form one bucket's. Each
// column c of bucket b lands in out[buckets[b].base + c] (out is (U, lanes),
// U the total of the buckets' columns). Returns the cudaError_t of the
// launch.
extern "C" __attribute__((visibility("default"))) int
photon_bell_bucket_rmatvec(const void* buckets, const void* items,
                           int n_items, const void* r, int lanes, int bf16,
                           int square, void* out, void* stream) {
  if (n_items <= 0) return 0;
  const auto* b = static_cast<const Bucket*>(buckets);
  const auto* it = static_cast<const WorkItem*>(items);
  const auto* rr = static_cast<const float*>(r);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const int vec4 =
      lanes % 4 == 0 && reinterpret_cast<uintptr_t>(r) % 16 == 0;
  if (square) {
    if (bf16) {
      launch_rmatvec<true, true>(b, it, n_items, rr, lanes, vec4, o, s);
    } else {
      launch_rmatvec<false, true>(b, it, n_items, rr, lanes, vec4, o, s);
    }
  } else if (bf16) {
    launch_rmatvec<true, false>(b, it, n_items, rr, lanes, vec4, o, s);
  } else {
    launch_rmatvec<false, false>(b, it, n_items, rr, lanes, vec4, o, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" __attribute__((visibility("default"))) const char*
photon_bell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
