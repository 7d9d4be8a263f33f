// One whole int8 serving rung: offsets in, (B,) f32 margin out.
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
// Bound: bytes, and in practice latency. A rung reads each request slot
// (index + value), one int8 and at most one scale per slot, and writes 4 B
// per row: about 30 KB at B = 64, a few nanoseconds of HBM time, with
// about one multiply-add per byte. What a rung really waits on is the
// chain of dependent loads — a slot's index, then the coefficient it
// names — and the launch itself.
//
// Design.
// - The coordinates travel by value in the kernel's parameter space (a
//   __grid_constant__ RungParams of up to kMaxCoords CoordDesc entries,
//   ~1.2 KB of the 4 KB), so a call uploads no descriptor array.
// - The kernel is instantiated for 1, 2, 4, 8 and 16 coordinates, and a
//   launch takes the smallest that holds its coordinates, so its loops
//   unroll to no more code than the rung needs.
// - One warp per request row, kRowsPerBlock rows per block. Lane j takes
//   slots j, j + 32, ... of a sparse row, or columns j, j + 32, ... of a
//   dense one.
// - Loads in three phases over every coordinate of the launch: first the
//   ones that depend on no other load (the row's entity id, its first 32
//   slots' indices and values), then the ones that need them (the
//   entity's scale, the q gathers), then the arithmetic. The dependent
//   chain per rung is about three memory round trips in all, not three
//   per coordinate in series. Slots past a row's first 32 (k > 32 or
//   d > 32) are loaded in the third phase, in order.
// - Each coordinate's dequantized products (float(q) * scale rounded as
//   the reference does, then times the feature value) reduce across the
//   warp by a fixed shuffle tree; lane 0 adds each coordinate's sum to the
//   row's margin in coordinate order.
// - A rung of more than kMaxCoords coordinates is served by several
//   launches from one call (photon_serving_int8_margin): each launch
//   starts from the previous one's margins in `out`. The margin is an f32
//   either way, so the result is bit for bit that of one pass.
// Unlike the TPU body, which dequantizes the whole fixed vector into VMEM
// for every call, the fixed vector is gathered per nonzero: a 10M-feature
// vector is 10 MB of int8 against a few KB a rung touches.
//
// The coordinates arrive from photon_tpu_torch/kernels/serving.py as a
// host array of CoordDesc (its _DESC_FIELDS lists the same fields in the
// same order), whose pointers that module writes on every call.

#include <cstdint>
#include <cstring>
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

constexpr int kMaxCoords = 16;
constexpr int kRowsPerBlock = 4;
constexpr int kThreads = 32 * kRowsPerBlock;

struct RungParams {
  const float* offsets;  // (B,): the offsets, or the previous launch's out
  float* out;            // (B,) margins
  int batch;
  int n_coords;          // <= kMaxCoords
  CoordDesc coord[kMaxCoords];
};
static_assert(sizeof(CoordDesc) == 72, "CoordDesc is nine 8-byte fields");
static_assert(sizeof(RungParams) <= 4096, "kernel parameters exceed 4 KB");

// kCoords bounds the coordinates of a launch (p.n_coords <= kCoords): the
// loops over them unroll to exactly that many, so a rung of three takes
// no code for sixteen.
template <int kCoords>
__global__ void __launch_bounds__(kThreads)
serving_int8_margin_kernel(const __grid_constant__ RungParams p) {
  const int lane = threadIdx.x & 31;
  const long long r =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (r >= p.batch) return;

  // phase 1: the loads that depend on no other load
  const float offset = p.offsets[r];
  int e[kCoords];
  int col[kCoords];
  float val[kCoords];
#pragma unroll
  for (int c = 0; c < kCoords; ++c) {
    if (c < p.n_coords) {
      const CoordDesc& cd = p.coord[c];
      const long long width = cd.sparse ? cd.k : cd.d;
      e[c] = cd.kind == 1 ? reinterpret_cast<const int32_t*>(cd.ids)[r] : 0;
      col[c] = 0;
      val[c] = 0.f;
      if (lane < width) {
        col[c] = cd.sparse
                     ? reinterpret_cast<const int32_t*>(cd.idx)[r * cd.k + lane]
                     : lane;
        val[c] = reinterpret_cast<const float*>(cd.x)[r * width + lane];
      }
    }
  }
  // phase 2: the loads that need phase 1's
  float scale[kCoords];
  int qv[kCoords];
#pragma unroll
  for (int c = 0; c < kCoords; ++c) {
    if (c < p.n_coords) {
      const CoordDesc& cd = p.coord[c];
      const long long width = cd.sparse ? cd.k : cd.d;
      scale[c] = reinterpret_cast<const float*>(cd.s)[e[c]];
      qv[c] = lane < width
                  ? reinterpret_cast<const int8_t*>(
                        cd.q)[static_cast<long long>(e[c]) * cd.d + col[c]]
                  : 0;
    }
  }
  // phase 3: dequantize, reduce each coordinate, add in coordinate order
  float margin = offset;
#pragma unroll
  for (int c = 0; c < kCoords; ++c) {
    if (c < p.n_coords) {
      const CoordDesc& cd = p.coord[c];
      const long long width = cd.sparse ? cd.k : cd.d;
      const int8_t* q = reinterpret_cast<const int8_t*>(cd.q) +
                        static_cast<long long>(e[c]) * cd.d;
      const float* x = reinterpret_cast<const float*>(cd.x) + r * width;
      const int32_t* idx =
          reinterpret_cast<const int32_t*>(cd.idx) + r * cd.k;
      float acc = 0.f;
      if (lane < width) {
        acc = val[c] * __fmul_rn(static_cast<float>(qv[c]), scale[c]);
      }
      for (long long j = lane + 32; j < width; j += 32) {
        const long long cj = cd.sparse ? idx[j] : j;
        acc += x[j] * __fmul_rn(static_cast<float>(q[cj]), scale[c]);
      }
      for (int o = 16; o > 0; o >>= 1) {
        acc += __shfl_down_sync(0xffffffffu, acc, o);
      }
      margin = margin + acc;  // lane 0 holds the coordinate's sum
    }
  }
  if (lane == 0) p.out[r] = margin;
}

// The floor a launch of the rung's grid costs: no loads, no work.
__global__ void __launch_bounds__(kThreads) serving_int8_empty_kernel() {}

int blocks_for(int batch) {
  return (batch + kRowsPerBlock - 1) / kRowsPerBlock;
}

// The smallest of 1, 2, 4, 8, 16 that holds n coordinates: the
// instantiation a launch of n takes.
int coords_bound(int n) {
  int b = 1;
  while (b < n) b <<= 1;
  return b;
}

cudaError_t launch_rung(const RungParams& p, cudaStream_t stream) {
  const int grid = blocks_for(p.batch);
  switch (coords_bound(p.n_coords)) {
    case 1:
      serving_int8_margin_kernel<1><<<grid, kThreads, 0, stream>>>(p);
      break;
    case 2:
      serving_int8_margin_kernel<2><<<grid, kThreads, 0, stream>>>(p);
      break;
    case 4:
      serving_int8_margin_kernel<4><<<grid, kThreads, 0, stream>>>(p);
      break;
    case 8:
      serving_int8_margin_kernel<8><<<grid, kThreads, 0, stream>>>(p);
      break;
    default:
      serving_int8_margin_kernel<kMaxCoords>
          <<<grid, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// Launches the rung on `stream`: `coords` is a host array of n_coords
// CoordDesc, served kMaxCoords at a time (the first launch reads
// `offsets`, each later one the margins the one before left in `out`).
// Returns the cudaError_t of the launches.
extern "C" __attribute__((visibility("default"))) int
photon_serving_int8_margin(const void* offsets, const void* coords,
                           int n_coords, int batch, void* out, void* stream) {
  if (batch <= 0) return 0;
  if (n_coords < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* cds = static_cast<const CoordDesc*>(coords);
  RungParams p;
  p.out = static_cast<float*>(out);
  p.batch = batch;
  int c0 = 0;
  do {
    const int n = n_coords - c0 < kMaxCoords ? n_coords - c0 : kMaxCoords;
    p.offsets = c0 == 0 ? static_cast<const float*>(offsets) : p.out;
    p.n_coords = n;
    std::memcpy(p.coord, cds + c0, sizeof(CoordDesc) * n);
    const cudaError_t e = launch_rung(p, static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return static_cast<int>(e);
    c0 += n;
  } while (c0 < n_coords);
  return 0;
}

// One launch of the empty kernel with a B-row rung's grid on `stream`.
extern "C" __attribute__((visibility("default"))) int
photon_serving_int8_empty(int batch, void* stream) {
  if (batch <= 0) return 0;
  serving_int8_empty_kernel<<<blocks_for(batch), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" __attribute__((visibility("default"))) const char*
photon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
