// The dense GLM objective's value and gradient in one pass over X.
//
// Replaces the Pallas kernel of photon_tpu/ops/fused.py:
//   fused_value_and_grad -> _fused_call (_dma_kernel on the TPU,
//   _tile_kernel in interpret mode)
//
// What it computes (the reference's _chunk_math, for X (n, d) f32 or bf16):
//   z_i  = sum_j f32(X[i, j]) * f32(S(w[j])) + offset_i
//   loss = sum_i weight_i * loss(z_i, y_i)                        (f32)
//   r_i  = S(weight_i * d1(z_i, y_i))
//   g_j  = sum_i f32(r_i) * f32(X[i, j])                          (f32)
// where S rounds to X's dtype: to bf16 when X is bf16 (every product of
// two bf16 values is then exact in f32), nothing when X is f32. The loss
// and its derivative follow photon_tpu/ops/losses.py (logistic as
// logaddexp(z, 0) - y z, not log(1 + e^z)).
//
// Design. A persistent grid of `ctas` blocks of kThreads threads; block b
// takes row tiles b, b + ctas, b + 2 ctas, ... of `rows` rows each (the
// last tile may be ragged). For each tile the block
//   1. copies the tile from HBM into shared memory once (16-byte loads
//      when the tile is aligned), so X is read from HBM once per call;
//   2. forms each row's margin with one warp per row (each lane a strided
//      Kahan sum, merged across the warp by a shuffle tree that carries
//      the compensations), and in lane 0 the row's weighted loss (a Kahan
//      sum per warp) and its cotangent r, kept in shared memory;
//   3. adds the tile's X^T r to the block's gradient accumulators (one
//      thread per column, Kahan sums kept in shared memory, rows in
//      order).
// The block then writes its gradient and loss partials, and a second
// kernel sums the partials column by column in block order (Kahan, eight
// row groups per column combined in a fixed order). No atomics: a call
// repeats bit for bit on one card and shape.
//
// Why every sum is compensated: with bf16 storage r rounds to bf16, and a
// margin one ulp off can move that rounding by a whole bf16 step (2^-8)
// on its row. The compensated margin is within an ulp of the exact one
// (the bf16 products are exact), as is the plain version's, which sums
// in f64 (kernels/fused.py), so the two round r alike on all but rare
// rows. The per-element math (expf, log1pf, the division of the
// sigmoid) is the same f32 math PyTorch's CUDA kernels do, operation for
// operation, so r matches where z does.
//
// Bound: bytes. Every element of X is read once (n d itemsize bytes) with
// two multiply-adds on it; the row vectors add 12 n bytes. At d = 256 f32
// that is 4 operations per 4 bytes, far below the card's operations per
// byte. This first version loads a tile, then computes on it, with no
// copy in flight during the compute (several blocks per SM overlap one
// another); a ring of tiles filled by TMA or cp.async is later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kReduceGroups = 8;

enum Task { kLogistic = 0, kLinear = 1, kPoisson = 2, kHinge = 3 };

template <bool kBf16>
struct Storage;

template <>
struct Storage<false> {
  using T = float;
  __device__ static float load(T x) { return x; }
  __device__ static T store(float x) { return x; }
  __device__ static float round(float x) { return x; }
};

template <>
struct Storage<true> {
  using T = __nv_bfloat16;
  __device__ static float load(T x) { return __bfloat162float(x); }
  __device__ static T store(float x) { return __float2bfloat16_rn(x); }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

// acc += a * b with Kahan compensation carried in comp.
__device__ __forceinline__ void kahan_fma(float a, float b, float& acc,
                                          float& comp) {
  const float y = fmaf(a, b, -comp);
  const float t = acc + y;
  comp = (t - acc) - y;
  acc = t;
}

__device__ __forceinline__ void kahan_add(float x, float& acc, float& comp) {
  const float y = x - comp;
  const float t = acc + y;
  comp = (t - acc) - y;
  acc = t;
}

// Merge two compensated sums (acc - comp each) into (acc, comp): the
// rounding error of acc + other_acc (TwoSum, exact) joins the
// compensations.
__device__ __forceinline__ void kahan_merge(float other_acc,
                                            float other_comp, float& acc,
                                            float& comp) {
  const float s = acc + other_acc;
  const float bp = s - acc;
  const float err = (acc - (s - bp)) + (other_acc - bp);
  comp = (comp + other_comp) - err;
  acc = s;
}

// (loss, d1) of one example, as photon_tpu/ops/losses.py computes them.
template <int kTask>
__device__ __forceinline__ void loss_d1(float z, float y, float& loss,
                                        float& d1) {
  if constexpr (kTask == kLogistic) {
    // logaddexp(z, 0) = max(z, 0) + log1p(exp(-|z|))
    loss = fmaxf(z, 0.f) + log1pf(expf(-fabsf(z))) - y * z;
    d1 = 1.f / (1.f + expf(-z)) - y;
  } else if constexpr (kTask == kLinear) {
    const float e = z - y;
    loss = 0.5f * e * e;
    d1 = e;
  } else if constexpr (kTask == kPoisson) {
    const float e = expf(z);
    loss = e - y * z;
    d1 = e - y;
  } else {
    const float ypm = 2.f * y - 1.f;
    const float m = ypm * z;
    if (m >= 1.f) {
      loss = 0.f;
      d1 = 0.f;
    } else if (m <= 0.f) {
      loss = 0.5f - m;
      d1 = -ypm;
    } else {
      const float u = 1.f - m;
      loss = 0.5f * u * u;
      d1 = ypm * (m - 1.f);
    }
  }
}

// Shared memory of one block, carved from the dynamic allocation in this
// order: x tile (rows * d, storage dtype), w rounded to the storage dtype
// (d), gradient accumulators and their compensations (d f32 each), the
// tile's cotangents (rows f32), the warps' loss sums (kWarps f32). Each
// part starts on a 16-byte boundary. photon_tpu_torch/kernels/fused.py
// (smem_bytes) computes the same layout to size the tile.
__host__ __device__ inline long long align16(long long b) {
  return (b + 15) & ~15LL;
}

__host__ __device__ inline long long smem_bytes(int rows, int d,
                                                int itemsize) {
  return align16(static_cast<long long>(rows) * d * itemsize) +
         align16(static_cast<long long>(d) * itemsize) + 2 * align16(4LL * d) +
         align16(4LL * rows) + 4 * kWarps;
}

// Copy `count` elements of the tile at src into dst: 16-byte loads when
// both ends allow it, else one element per load.
template <typename T>
__device__ __forceinline__ void load_tile(T* __restrict__ dst,
                                          const T* __restrict__ src,
                                          long long count) {
  const long long nbytes = count * static_cast<long long>(sizeof(T));
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (nbytes & 15) == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* o = reinterpret_cast<uint4*>(dst);
    for (long long k = threadIdx.x; k < nbytes / 16; k += kThreads) {
      o[k] = s[k];
    }
  } else {
    for (long long k = threadIdx.x; k < count; k += kThreads) {
      dst[k] = src[k];
    }
  }
}

template <bool kBf16, int kTask>
__global__ void __launch_bounds__(kThreads)
fused_vg_tile_kernel(const typename Storage<kBf16>::T* __restrict__ X,
                     const float* __restrict__ w, const float* __restrict__ y,
                     const float* __restrict__ weight,
                     const float* __restrict__ offset, long long n, int d,
                     int rows, float* __restrict__ partial) {
  using S = Storage<kBf16>;
  using T = typename S::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int itemsize = static_cast<int>(sizeof(T));
  unsigned char* p = smem;
  T* x_s = reinterpret_cast<T*>(p);
  p += align16(static_cast<long long>(rows) * d * itemsize);
  T* w_s = reinterpret_cast<T*>(p);
  p += align16(static_cast<long long>(d) * itemsize);
  float* acc_s = reinterpret_cast<float*>(p);
  p += align16(4LL * d);
  float* comp_s = reinterpret_cast<float*>(p);
  p += align16(4LL * d);
  float* r_s = reinterpret_cast<float*>(p);
  p += align16(4LL * rows);
  float* wl_s = reinterpret_cast<float*>(p);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < d; j += kThreads) {
    w_s[j] = S::store(w[j]);  // w rounds to X's dtype first
    acc_s[j] = 0.f;
    comp_s[j] = 0.f;
  }
  float loss_acc = 0.f, loss_comp = 0.f;  // lane 0 of each warp

  const long long n_tiles = (n + rows - 1) / rows;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long row0 = t * rows;
    const int tile_rows =
        static_cast<int>(n - row0 < rows ? n - row0 : rows);
    __syncthreads();  // the previous tile's column pass is done with x_s
    load_tile<T>(x_s, X + row0 * d, static_cast<long long>(tile_rows) * d);
    __syncthreads();

    // margins: one warp per row
    for (int i = warp; i < tile_rows; i += kWarps) {
      const T* xr = x_s + static_cast<long long>(i) * d;
      float a = 0.f, c = 0.f;
      for (int j = lane; j < d; j += 32) {
        kahan_fma(S::load(xr[j]), S::load(w_s[j]), a, c);
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float oa = __shfl_down_sync(0xffffffffu, a, o);
        const float oc = __shfl_down_sync(0xffffffffu, c, o);
        kahan_merge(oa, oc, a, c);
      }
      if (lane == 0) {
        const long long gi = row0 + i;
        const float z = __fadd_rn(__fsub_rn(a, c), offset[gi]);
        float l, d1;
        loss_d1<kTask>(z, y[gi], l, d1);
        const float wt = weight[gi];
        kahan_add(wt * l, loss_acc, loss_comp);
        r_s[i] = S::round(wt * d1);  // r rounds to X's dtype
      }
    }
    __syncthreads();

    // X^T r over the tile: one thread per column, rows in order
    for (int j = threadIdx.x; j < d; j += kThreads) {
      float a = acc_s[j], c = comp_s[j];
      for (int i = 0; i < tile_rows; ++i) {
        kahan_fma(r_s[i], S::load(x_s[static_cast<long long>(i) * d + j]), a,
                  c);
      }
      acc_s[j] = a;
      comp_s[j] = c;
    }
  }
  if (lane == 0) wl_s[warp] = loss_acc;
  __syncthreads();

  float* out = partial + static_cast<long long>(blockIdx.x) * (d + 1);
  for (int j = threadIdx.x; j < d; j += kThreads) out[j] = acc_s[j];
  if (threadIdx.x == 0) {
    float a = 0.f, c = 0.f;
    for (int k = 0; k < kWarps; ++k) kahan_add(wl_s[k], a, c);
    out[d] = a;
  }
}

// out[j] = sum over the ctas rows of partial (ctas, cols) of column j, in
// row order within each of kReduceGroups interleaved groups, the groups
// then added in order; Kahan sums throughout.
__global__ void __launch_bounds__(32 * kReduceGroups)
fused_vg_reduce_kernel(const float* __restrict__ partial, int ctas, int cols,
                       float* __restrict__ out) {
  __shared__ float part[kReduceGroups][32];
  const int j = blockIdx.x * 32 + threadIdx.x;
  float a = 0.f, c = 0.f;
  if (j < cols) {
    for (int b = threadIdx.y; b < ctas; b += kReduceGroups) {
      kahan_add(partial[static_cast<long long>(b) * cols + j], a, c);
    }
  }
  part[threadIdx.y][threadIdx.x] = a;
  __syncthreads();
  if (threadIdx.y == 0 && j < cols) {
    float s = 0.f, sc = 0.f;
    for (int k = 0; k < kReduceGroups; ++k) {
      kahan_add(part[k][threadIdx.x], s, sc);
    }
    out[j] = s;
  }
}

template <bool kBf16, int kTask>
int launch(const void* X, const float* w, const float* y, const float* wt,
           const float* off, long long n, int d, int rows, int ctas,
           float* partial, float* out, cudaStream_t s) {
  const auto kernel = fused_vg_tile_kernel<kBf16, kTask>;
  const int smem = static_cast<int>(
      smem_bytes(rows, d, kBf16 ? 2 : 4));
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<ctas, kThreads, smem, s>>>(
      static_cast<const typename Storage<kBf16>::T*>(X), w, y, wt, off, n, d,
      rows, partial);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 block(32, kReduceGroups);
  fused_vg_reduce_kernel<<<(d + 1 + 31) / 32, block, 0, s>>>(partial, ctas,
                                                             d + 1, out);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBf16>
int launch_task(int task, const void* X, const float* w, const float* y,
                const float* wt, const float* off, long long n, int d,
                int rows, int ctas, float* partial, float* out,
                cudaStream_t s) {
  switch (task) {
    case kLogistic:
      return launch<kBf16, kLogistic>(X, w, y, wt, off, n, d, rows, ctas,
                                      partial, out, s);
    case kLinear:
      return launch<kBf16, kLinear>(X, w, y, wt, off, n, d, rows, ctas,
                                    partial, out, s);
    case kPoisson:
      return launch<kBf16, kPoisson>(X, w, y, wt, off, n, d, rows, ctas,
                                     partial, out, s);
    case kHinge:
      return launch<kBf16, kHinge>(X, w, y, wt, off, n, d, rows, ctas,
                                   partial, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The grid of a call: `ctas` = as many blocks as are resident on the
// current device at once for a tile of `rows` rows (one full wave),
// capped at the tile count. Returns the cudaError_t of the queries.
extern "C" __attribute__((visibility("default"))) int
photon_fused_vg_grid(long long n, int d, int bf16, int rows, int* ctas) {
  const int smem = static_cast<int>(smem_bytes(rows, d, bf16 ? 2 : 4));
  const void* kernel = nullptr;
  // occupancy is set by the shared memory and the threads, so the
  // logistic instantiation stands for all four tasks
  if (bf16) {
    kernel = reinterpret_cast<const void*>(
        fused_vg_tile_kernel<true, kLogistic>);
  } else {
    kernel = reinterpret_cast<const void*>(
        fused_vg_tile_kernel<false, kLogistic>);
  }
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0, device = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles = (n + rows - 1) / rows;
  long long g = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  *ctas = static_cast<int>(g < tiles ? g : tiles);
  return 0;
}

// One fused evaluation on `stream`: partial is (ctas, d + 1) f32 scratch;
// out is (d + 1,) f32, the gradient then the loss. Returns the
// cudaError_t of the launches.
extern "C" __attribute__((visibility("default"))) int
photon_fused_vg(const void* X, const void* w, const void* y,
                const void* weight, const void* offset, long long n, int d,
                int bf16, int task, int rows, int ctas, void* partial,
                void* out, void* stream) {
  if (n <= 0 || d <= 0 || rows <= 0 || ctas <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* ww = static_cast<const float*>(w);
  const auto* yy = static_cast<const float*>(y);
  const auto* wt = static_cast<const float*>(weight);
  const auto* off = static_cast<const float*>(offset);
  auto* part = static_cast<float*>(partial);
  auto* o = static_cast<float*>(out);
  if (bf16) {
    return launch_task<true>(task, X, ww, yy, wt, off, n, d, rows, ctas,
                             part, o, s);
  }
  return launch_task<false>(task, X, ww, yy, wt, off, n, d, rows, ctas, part,
                            o, s);
}

extern "C" __attribute__((visibility("default"))) const char*
photon_fused_vg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
