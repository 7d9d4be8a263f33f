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
// last tile may be ragged). Each block keeps a ring of `stages` tile
// buffers in shared memory, each with a "full" and an "empty" mbarrier:
//   - one elected thread fills a stage with one bulk asynchronous copy
//     (cp.async.bulk, completing on the stage's full barrier, armed with
//     the tile's bytes): consecutive rows of row-major X are one
//     contiguous byte range, so no tensor map is needed. It keeps up to
//     `stages` tiles in flight and refills a stage as soon as every warp
//     has arrived on its empty barrier, so the copies of the next tiles
//     run while the block computes on this one. X is read from HBM once.
//   - each warp loads its rows' y, weight and offset (lane j the warp's
//     j-th row) before it waits on the full barrier, so those loads
//     overlap the copy too;
//   - the margins: one warp per row, up to kRowGroup of the warp's rows at
//     once (each lane a strided Kahan sum, merged across the warp by a
//     shuffle tree that carries the compensations); lane j then takes the
//     loss and the cotangent r of the warp's j-th row, and lane 0 adds the
//     rows' weighted losses in row order (a Kahan sum per warp); r goes to
//     one of two shared buffers, so the next tile's margins need not wait
//     for this tile's column pass;
//   - X^T r over the tile: one thread per column, Kahan sums kept in
//     shared memory, rows in order; then each warp arrives on the stage's
//     empty barrier.
// A bulk copy needs a 16-byte aligned source and a size that is a
// multiple of 16. Where X's address or a row's bytes (d * itemsize) break
// that, every thread fills each stage with element loads before the
// compute, with no copy in flight (the same arithmetic, the same bits).
// The block then writes its gradient and loss partials, and a second
// kernel sums the partials column by column in block order (Kahan, eight
// row groups per column combined in a fixed order). No atomics: a call
// repeats bit for bit on one card, shape and tile geometry.
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
// byte. The ring is what reaches for that bound: an SM must keep about
// 25 KB in flight (3.35 TB/s x ~1 us of latency / 132 SMs) while its
// blocks compute.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kReduceGroups = 8;
// rows whose margins a warp sums at once
constexpr int kRowGroup = 4;
// lane j of warp w holds the y, weight and offset of the tile's row
// w + kWarps * j, so a tile takes at most 32 * kWarps rows
constexpr int kMaxRows = 32 * kWarps;
constexpr int kMaxStages = 8;

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
// order: the ring of `stages` x tiles (rows * d each, storage dtype), w
// rounded to the storage dtype (d), gradient accumulators and their
// compensations (d f32 each), two buffers of the tile's cotangents (2 rows
// f32), the warps' loss sums (kWarps f32), and each stage's full and empty
// mbarriers (16 bytes a stage). Each part starts on a 16-byte boundary.
// photon_tpu_torch/kernels/fused.py (smem_bytes) computes the same layout
// to size the ring.
__host__ __device__ inline long long align16(long long b) {
  return (b + 15) & ~15LL;
}

__host__ __device__ inline long long tile_bytes(int rows, int d,
                                                int itemsize) {
  return align16(static_cast<long long>(rows) * d * itemsize);
}

__host__ __device__ inline long long smem_bytes(int rows, int stages, int d,
                                                int itemsize) {
  return stages * tile_bytes(rows, d, itemsize) +
         align16(static_cast<long long>(d) * itemsize) + 2 * align16(4LL * d) +
         align16(8LL * rows) + 4 * kWarps + 16LL * stages;
}

// ------------------------------------------------- mbarriers, bulk copies
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival that also expects `bytes` of transactions on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}" ::"r"(
          smem_addr(bar))
      : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Copy `bytes` (a multiple of 16, both ends 16-byte aligned) from global
// memory into shared memory; completes `bytes` transactions on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ------------------------------------------------------------ the margins
// The margins of kRows rows of the tile, slots base .. base + kRows - 1 of
// this warp (slot j is the tile's row warp + kWarps * j; lane j holds
// slot j's y, weight and offset): each row's compensated sum, its
// weighted loss added into (loss_acc, loss_comp) in slot order by lane 0,
// its cotangent into r.
template <class S, int kTask, int kRows>
__device__ __forceinline__ void margin_rows(
    const typename S::T* __restrict__ xt, const typename S::T* __restrict__ w_s,
    int d, int base, float yv, float wv, float ov, float* __restrict__ r,
    float& loss_acc, float& loss_comp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const typename S::T* xr[kRows];
  float a[kRows], c[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    xr[j] = xt + static_cast<long long>(warp + kWarps * (base + j)) * d;
    a[j] = 0.f;
    c[j] = 0.f;
  }
#pragma unroll 4
  for (int k = lane; k < d; k += 32) {
    const float wk = S::load(w_s[k]);
#pragma unroll
    for (int j = 0; j < kRows; ++j) kahan_fma(S::load(xr[j][k]), wk, a[j], c[j]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const float oa = __shfl_down_sync(0xffffffffu, a[j], o);
      const float oc = __shfl_down_sync(0xffffffffu, c[j], o);
      kahan_merge(oa, oc, a[j], c[j]);
    }
  }
  // lane 0 holds each row's sum; lane base + j takes row j's
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const float v = __shfl_sync(0xffffffffu, __fsub_rn(a[j], c[j]), 0);
    if (lane == base + j) m = v;
  }
  float wl = 0.f;
  if (lane >= base && lane < base + kRows) {
    const float z = __fadd_rn(m, ov);
    float l, d1;
    loss_d1<kTask>(z, yv, l, d1);
    wl = wv * l;
    r[warp + kWarps * lane] = S::round(wv * d1);  // r rounds to X's dtype
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const float v = __shfl_sync(0xffffffffu, wl, base + j);
    if (lane == 0) kahan_add(v, loss_acc, loss_comp);
  }
}

template <bool kBf16, int kTask>
__global__ void __launch_bounds__(kThreads)
fused_vg_tile_kernel(const typename Storage<kBf16>::T* __restrict__ X,
                     const float* __restrict__ w, const float* __restrict__ y,
                     const float* __restrict__ weight,
                     const float* __restrict__ offset, long long n, int d,
                     int rows, int stages, float* __restrict__ partial) {
  using S = Storage<kBf16>;
  using T = typename S::T;
  extern __shared__ __align__(128) unsigned char smem[];
  const int itemsize = static_cast<int>(sizeof(T));
  const long long stage_bytes = tile_bytes(rows, d, itemsize);
  unsigned char* p = smem + stages * stage_bytes;
  T* w_s = reinterpret_cast<T*>(p);
  p += align16(static_cast<long long>(d) * itemsize);
  float* acc_s = reinterpret_cast<float*>(p);
  p += align16(4LL * d);
  float* comp_s = reinterpret_cast<float*>(p);
  p += align16(4LL * d);
  float* r_s = reinterpret_cast<float*>(p);  // two buffers of `rows`
  p += align16(8LL * rows);
  float* wl_s = reinterpret_cast<float*>(p);
  p += 4 * kWarps;
  uint64_t* full = reinterpret_cast<uint64_t*>(p);
  uint64_t* empty = full + stages;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long n_tiles = (n + rows - 1) / rows;
  const long long my_tiles =
      blockIdx.x < n_tiles ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const bool bulk = (reinterpret_cast<uintptr_t>(X) & 15) == 0 &&
                    ((static_cast<long long>(d) * itemsize) & 15) == 0;
  auto stage = [&](int s) {
    return reinterpret_cast<T*>(smem + s * stage_bytes);
  };
  // the block's k-th tile: its first row and its rows
  auto tile_row0 = [&](long long k) {
    return (blockIdx.x + k * gridDim.x) * static_cast<long long>(rows);
  };
  auto tile_count = [&](long long row0) {
    return static_cast<int>(n - row0 < rows ? n - row0 : rows);
  };
  // one elected thread: the k-th tile into stage s
  auto fill = [&](int s, long long k) {
    const long long row0 = tile_row0(k);
    const uint32_t bytes = static_cast<uint32_t>(
        static_cast<long long>(tile_count(row0)) * d * itemsize);
    mbar_expect_tx(&full[s], bytes);
    bulk_copy(stage(s), X + row0 * d, bytes, &full[s]);
  };

  if (bulk && threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (bulk && threadIdx.x == 0) {
    for (int s = 0; s < stages && s < my_tiles; ++s) fill(s, s);
  }
  for (int j = threadIdx.x; j < d; j += kThreads) {
    w_s[j] = S::store(w[j]);  // w rounds to X's dtype first
    acc_s[j] = 0.f;
    comp_s[j] = 0.f;
  }
  __syncthreads();
  float loss_acc = 0.f, loss_comp = 0.f;  // lane 0 of each warp

  for (long long k = 0; k < my_tiles; ++k) {
    const int s = static_cast<int>(k % stages);
    const uint32_t parity = static_cast<uint32_t>((k / stages) & 1);
    const long long row0 = tile_row0(k);
    const int tr = tile_count(row0);
    const T* xt = stage(s);
    float* r = r_s + (k & 1) * rows;
    // this warp's rows are slots j = 0, 1, ...: row warp + kWarps * j
    const int slots = tr > warp ? (tr - warp + kWarps - 1) / kWarps : 0;
    float yv = 0.f, wv = 0.f, ov = 0.f;
    if (lane < slots) {
      const long long gi = row0 + warp + kWarps * lane;
      yv = y[gi];
      wv = weight[gi];
      ov = offset[gi];
    }
    if (bulk) {
      mbar_wait(&full[s], parity);
    } else {
      __syncthreads();  // every thread is done with this stage's last tile
      T* dst = stage(s);
      const T* src = X + row0 * d;
      const long long count = static_cast<long long>(tr) * d;
      for (long long e = threadIdx.x; e < count; e += kThreads) dst[e] = src[e];
      __syncthreads();
    }

    // margins: kRowGroup of this warp's rows at a time
    for (int base = 0; base < slots; base += kRowGroup) {
      switch (slots - base < kRowGroup ? slots - base : kRowGroup) {
        case 1:
          margin_rows<S, kTask, 1>(xt, w_s, d, base, yv, wv, ov, r, loss_acc,
                                   loss_comp);
          break;
        case 2:
          margin_rows<S, kTask, 2>(xt, w_s, d, base, yv, wv, ov, r, loss_acc,
                                   loss_comp);
          break;
        case 3:
          margin_rows<S, kTask, 3>(xt, w_s, d, base, yv, wv, ov, r, loss_acc,
                                   loss_comp);
          break;
        default:
          margin_rows<S, kTask, kRowGroup>(xt, w_s, d, base, yv, wv, ov, r,
                                           loss_acc, loss_comp);
      }
    }
    __syncthreads();  // the tile's cotangents are all in r

    // X^T r over the tile: one thread per column, rows in order
    for (int j = threadIdx.x; j < d; j += kThreads) {
      float a = acc_s[j], c = comp_s[j];
#pragma unroll 8
      for (int i = 0; i < tr; ++i) {
        kahan_fma(r[i], S::load(xt[static_cast<long long>(i) * d + j]), a, c);
      }
      acc_s[j] = a;
      comp_s[j] = c;
    }
    if (bulk) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (threadIdx.x == 0 && k + stages < my_tiles) {
        mbar_wait(&empty[s], parity);  // every warp is done with stage s
        fill(s, k + stages);
      }
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
           const float* off, long long n, int d, int rows, int stages,
           int ctas, float* partial, float* out, cudaStream_t s) {
  const auto kernel = fused_vg_tile_kernel<kBf16, kTask>;
  const int smem = static_cast<int>(smem_bytes(rows, stages, d, kBf16 ? 2 : 4));
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<ctas, kThreads, smem, s>>>(
      static_cast<const typename Storage<kBf16>::T*>(X), w, y, wt, off, n, d,
      rows, stages, partial);
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
                int rows, int stages, int ctas, float* partial, float* out,
                cudaStream_t s) {
  switch (task) {
    case kLogistic:
      return launch<kBf16, kLogistic>(X, w, y, wt, off, n, d, rows, stages,
                                      ctas, partial, out, s);
    case kLinear:
      return launch<kBf16, kLinear>(X, w, y, wt, off, n, d, rows, stages,
                                    ctas, partial, out, s);
    case kPoisson:
      return launch<kBf16, kPoisson>(X, w, y, wt, off, n, d, rows, stages,
                                     ctas, partial, out, s);
    case kHinge:
      return launch<kBf16, kHinge>(X, w, y, wt, off, n, d, rows, stages,
                                   ctas, partial, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool geometry_ok(int d, int rows, int stages) {
  return d > 0 && rows > 0 && rows <= kMaxRows && stages > 0 &&
         stages <= kMaxStages;
}

}  // namespace

// The grid of a call: `ctas` = as many blocks as are resident on the
// current device at once for a ring of `stages` tiles of `rows` rows (one
// full wave), capped at the tile count. Returns the cudaError_t of the
// queries.
extern "C" __attribute__((visibility("default"))) int
photon_fused_vg_grid(long long n, int d, int bf16, int rows, int stages,
                     int* ctas) {
  if (n <= 0 || !geometry_ok(d, rows, stages)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem =
      static_cast<int>(smem_bytes(rows, stages, d, bf16 ? 2 : 4));
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
                int bf16, int task, int rows, int stages, int ctas,
                void* partial, void* out, void* stream) {
  if (n <= 0 || ctas <= 0 || !geometry_ok(d, rows, stages)) {
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
    return launch_task<true>(task, X, ww, yy, wt, off, n, d, rows, stages,
                             ctas, part, o, s);
  }
  return launch_task<false>(task, X, ww, yy, wt, off, n, d, rows, stages,
                            ctas, part, o, s);
}

extern "C" __attribute__((visibility("default"))) const char*
photon_fused_vg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
