// One whole int8 serving rung in one launch: offsets in, (B,) f32 margin out.
//
// Replaces the Pallas kernel photon_tpu/kernels/serving.py::fused_int8_margin.
// It computes what that kernel computes, coordinate by coordinate in the
// ladder's order, starting from the offsets:
//   fixed effect   margin += sum_j x_j * (float(q[col_j]) * s)
//   random effect  margin += sum_j x_j * (float(q[e * d + col_j]) * s[e]),
//                  e = ids[row]; row E is the all-zero cold-miss row at
//                  scale 1.0, so it contributes exactly 0
// where (col_j, x_j) runs over a sparse row's k padded slots (padding is
// idx 0, val 0 and is read like any slot) or over a dense row's d columns.
//
// Design: one thread block per request row. For each coordinate the block's
// threads stride over the row's slots, dequantize per element as the
// reference does (float(q) * scale, then times the feature value), and the
// f32 partial sums reduce across the block (warp shuffles, then one partial
// per warp added in a fixed order). Thread 0 adds each coordinate's sum to
// the row's margin in coordinate order, so the contributions add in the
// reference's order. Unlike the TPU body, which dequantizes the whole fixed
// vector into VMEM for every call, the fixed vector is gathered per nonzero:
// a 10M-feature vector is 10 MB of int8 against a few KB a rung touches.
//
// Bound: bytes. A rung reads each request slot (index + value), one int8
// and at most one scale per slot, and writes 4 B per row; there is about
// one multiply-add per byte, far below the card's operations per byte.
// This first version does not try to reach that bound (one block per row
// leaves most threads idle at k = 8..32): it is meant to be right first.
//
// The coordinates arrive as a device array of CoordDesc, one per
// coordinate, packed by photon_tpu_torch/kernels/serving.py (_DESC_FIELDS
// there lists the same fields in the same order).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct CoordDesc {
  long long kind;    // 0: fixed effect, 1: random effect
  long long sparse;  // 1: (B, k) indices + values; 0: dense (B, d) rows
  long long d;       // coefficient width (columns of q)
  long long k;       // slots per sparse row (0 when dense)
  long long x;       // const float*: sparse values (B, k) or dense rows (B, d)
  long long idx;     // const int32_t*: sparse indices (B, k), else 0
  long long ids;     // const int32_t*: entity rows (B,) for a random effect
  long long q;       // const int8_t*: (d,) fixed or (E + 1, d) random
  long long s;       // const float*: (1,) fixed or (E + 1,) random
};

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// Sum of v over the block; the result is valid in thread 0.
__device__ float block_sum(float v, float* partial) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) total += partial[w];
  }
  __syncthreads();  // partial[] is reused by the next coordinate
  return total;
}

__global__ void __launch_bounds__(kThreads)
serving_int8_margin_kernel(const float* __restrict__ offsets,
                           const CoordDesc* __restrict__ desc, int n_coords,
                           float* __restrict__ out) {
  __shared__ float partial[kWarps];
  const long long r = blockIdx.x;
  float margin = offsets[r];
  for (int c = 0; c < n_coords; ++c) {
    const CoordDesc cd = desc[c];
    const int8_t* q = reinterpret_cast<const int8_t*>(cd.q);
    const float* s = reinterpret_cast<const float*>(cd.s);
    const float* x = reinterpret_cast<const float*>(cd.x);
    float scale;
    if (cd.kind == 1) {
      const long long e = reinterpret_cast<const int32_t*>(cd.ids)[r];
      q += e * cd.d;
      scale = s[e];
    } else {
      scale = s[0];
    }
    float acc = 0.f;
    if (cd.sparse) {
      const int32_t* idx = reinterpret_cast<const int32_t*>(cd.idx) + r * cd.k;
      const float* val = x + r * cd.k;
      for (long long j = threadIdx.x; j < cd.k; j += kThreads) {
        const float w = __fmul_rn(static_cast<float>(q[idx[j]]), scale);
        acc += val[j] * w;
      }
    } else {
      const float* row = x + r * cd.d;
      for (long long j = threadIdx.x; j < cd.d; j += kThreads) {
        const float w = __fmul_rn(static_cast<float>(q[j]), scale);
        acc += row[j] * w;
      }
    }
    const float contribution = block_sum(acc, partial);
    if (threadIdx.x == 0) margin = margin + contribution;
  }
  if (threadIdx.x == 0) out[r] = margin;
}

}  // namespace

// Launches the rung on `stream`; returns the cudaError_t of the launch.
extern "C" __attribute__((visibility("default"))) int
photon_serving_int8_margin(const void* offsets, const void* desc,
                           int n_coords, int batch, void* out, void* stream) {
  if (batch <= 0) return 0;
  serving_int8_margin_kernel<<<batch, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(offsets),
      static_cast<const CoordDesc*>(desc), n_coords,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" __attribute__((visibility("default"))) const char*
photon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
