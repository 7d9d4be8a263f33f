// The blocked-ELL X passes: two kernel bodies, each in a fused and a tiled
// form, for f32 or bf16 storage and for a vector or G lanes.
//
// Replaces the Pallas kernels of photon_tpu/kernels/blocked_ell.py:
//   bell_tail_matvec_kernel with row_pos   tail_matvec          (_tail_call)
//   bell_tail_matvec_kernel, one bucket    tail_matvec_tiled    (_tiled_tail_call)
//   bell_bucket_rmatvec_kernel, all        bucket_rmatvec       (_rmatvec_call)
//   bell_bucket_rmatvec_kernel, one bucket bucket_rmatvec_tiled (_tiled_rmatvec_call)
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
// Design. One thread per output element (row or column, lane), looping
// over that row's W_b (or that column's k_b) slots: every output is
// written by one thread, with no atomics, so the order is fixed. Buckets
// arrive as a small device array of Bucket descriptors (pointers, shape,
// first position in the concatenation) packed by
// photon_tpu_torch/kernels/blocked_ell.py, so one compiled kernel serves
// every layout. The fused forms launch once over all n rows (all U
// columns); a thread finds its bucket by scanning the descriptors' bases.
// The tiled forms launch once per bucket with that bucket's descriptor
// alone, over its rows in blocks of kThreads (the tile), and the caller
// concatenates the buckets (and, for the matvec, gathers by row_pos), as
// the reference does outside its tiled kernels.
//
// Bound: bytes. Each pass is a gather: it reads every ELL or bucket slot
// (4 B index + 2 B bf16 or 4 B f32 value), the distinct vector entries it
// touches, and writes 4 B per output per lane, with one multiply-add per
// slot: far below the card's operations per byte. This first version is
// simple and correct (a thread walks its row's slots one by one, strided
// across a warp); making it fast (a warp per long row or column, vector
// loads, the descriptor scan out of the inner path) is later work.

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

constexpr int kThreads = 256;

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

template <bool kBf16, bool kSquare>
__global__ void __launch_bounds__(kThreads)
bell_bucket_rmatvec_kernel(const Bucket* __restrict__ buckets, int nb,
                           const float* __restrict__ r, int lanes,
                           long long n_cols, float* __restrict__ out) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (t >= n_cols * lanes) return;
  const long long i = t / lanes;
  const int g = static_cast<int>(t - i * lanes);
  const long long c = buckets[0].base + i;
  const Bucket bk = buckets[find_bucket(buckets, nb, c)];
  const long long off = (c - bk.base) * bk.width;
  const int32_t* br = reinterpret_cast<const int32_t*>(bk.idx) + off;
  float acc = 0.f, comp = 0.f;
  for (long long k = 0; k < bk.width; ++k) {
    const float v = load_value<kBf16>(bk.val, off + k);
    const float x = r[static_cast<long long>(br[k]) * lanes + g];
    if constexpr (kSquare) {
      kahan_fma(__fmul_rn(v, v), x, acc, comp);
    } else {
      kahan_fma(v, to_storage<kBf16>(x), acc, comp);
    }
  }
  out[t] = acc;
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

// Occurrence-bucket rmatvec over n_cols columns starting at buckets[0].base
// on `stream`: the fused form passes every bucket, the tiled form one.
// out is (n_cols, lanes). Returns the cudaError_t of the launch.
extern "C" __attribute__((visibility("default"))) int
photon_bell_bucket_rmatvec(const void* buckets, int nb, const void* r,
                           int lanes, long long n_cols, int bf16, int square,
                           void* out, void* stream) {
  if (n_cols <= 0) return 0;
  const auto* b = static_cast<const Bucket*>(buckets);
  const auto* rr = static_cast<const float*>(r);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned int grid = blocks_for(n_cols * lanes);
  if (square) {
    if (bf16) {
      bell_bucket_rmatvec_kernel<true, true><<<grid, kThreads, 0, s>>>(
          b, nb, rr, lanes, n_cols, o);
    } else {
      bell_bucket_rmatvec_kernel<false, true><<<grid, kThreads, 0, s>>>(
          b, nb, rr, lanes, n_cols, o);
    }
  } else if (bf16) {
    bell_bucket_rmatvec_kernel<true, false><<<grid, kThreads, 0, s>>>(
        b, nb, rr, lanes, n_cols, o);
  } else {
    bell_bucket_rmatvec_kernel<false, false><<<grid, kThreads, 0, s>>>(
        b, nb, rr, lanes, n_cols, o);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" __attribute__((visibility("default"))) const char*
photon_bell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
