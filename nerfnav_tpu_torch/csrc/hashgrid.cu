// Multiresolution hash-grid encode (Instant-NGP) for Hopper (sm_90a): the
// forward, the table gradient and the input gradient of
// ops/hashgrid.py::hash_grid_encode.
//
// Replaces no Pallas kernel: the JAX package encodes with XLA gathers
// (nerfnav_tpu/ops/hashgrid.py::hash_grid_encode). The port's eager version
// of it issued ~300 small kernels a call and autograd a chain per level, and
// was the slowest layer of a train step; this kernel pair does the same
// arithmetic in one launch each way.
//
// Per point and level it does what the plain version does, in its order and
// with its roundings (the _rn intrinsics keep nvcc from contracting a
// multiply and an add into one FMA, which the plain version's separate
// kernels never do): unit coordinates (x + bound) / (2 bound) as an IEEE
// division, the in-bounds test and clamp, pos (x R, or x (base s^l - 1) +
// 0.5 under the ngp convention), the cell clamped to [0, R - 1] and its
// fraction, the trilinear weights as a product over dims 0..D-1, the row
// index (dense or hashed, uint32 arithmetic, with the modulo wrap), the
// corner rows, and an f32 sum over the corners in the order torch's CPU sum
// takes (corner_sum), so the features equal the CPU's. Points out of bounds
// get all-zero features. A bf16 table (or an f32 one under bf16 compute) is
// read as bf16 values.
//
// What bounds it on an H100: bytes. At a dense train step (N = 2,097,152
// points, 16 levels x 2 features, 2^19 rows) a forward reads x (25 MB),
// writes the features (268 MB) and gathers 268M 8-byte corner rows, one
// 32-byte sector each; the tables (47 MB in all, 4 MB a hashed level) fit
// the 50 MB L2 one level at a time. The backward adds 268M float2 atomic
// adds into the table gradient.
//
// Design:
// - Forward: a block of 256 threads takes 256 points and a group of levels
//   (grid y); a thread computes its point's levels in order and writes them
//   into a shared tile, which the block then writes out as whole row
//   segments of the (N, L*F) output, so the stores are coalesced. Blocks are
//   scheduled x first, so every point tile of one level group runs before
//   the next group's: the group's tables stay hot in L2 while their rows are
//   gathered. The wrapper sizes a group to 8 output floats a point (4 levels
//   at F = 2): all 16 levels in one group took 3x as long. A corner-layout
//   level issues its 2^D row loads before it uses any; a cell-layout level
//   loads one 2^D*F-wide row.
// - Table gradient: f32 atomic adds of g * w into each corner row, as one
//   float2 / float4 vector atomic (sm_90) per row where the width allows.
//   A level whose rows are few next to the points a block sees (the dense
//   coarse levels: 4,920 rows at level 0 of the benchmark's grid against
//   millions of points) is summed in shared memory by each block and
//   flushed once, with one global atomic per nonzero entry; the host picks
//   those levels from their row counts. Blocks stride over point tiles so
//   that each flush serves many tiles.
// - Deterministic route: the backward kernel writes each (point, corner)
//   row and its weighted gradient instead, and the caller sums them with
//   torch's sorted, deterministic index_put_.
// - Input gradient (only when x requires one): a thread per point walks
//   every level, gathers the corner features and chains them through the
//   weights, the clamp (half the gradient on the boundary, as
//   torch.maximum / minimum pass it) and the division.
//
// Limits (checked by the wrapper and here): D 2 or 3, F 1, 2, 4 or 8, at
// most 32 levels, table rows 16-byte aligned, N < 2^31.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
constexpr int kMaxGroupFloats = 64;       // output floats per point in a group
constexpr int kAccFloats = 48 * 1024 / 4;  // shared accumulator of a backward block

struct Level {
  const void* table;  // (rows, W) f32 or bf16
  float* grad;        // (rows, W) f32, the table gradient (backward)
  float scale;        // pos = x01c * scale (+ 0.5 under the ngp convention)
  uint32_t res;       // cells per axis R: the cell clamps to [0, R - 1]
  uint32_t stride;    // dense row stride per axis: R + 1 (corner), R (cell)
  uint32_t wrap;      // 0, or rows wrap modulo this
  uint32_t rows;
  int hashed;         // XOR of prime products, else the dense order
  int acc;            // backward: float offset of its shared accumulator, or -1
};

struct Args {
  Level lv[kMaxLevels];
  int levels;
  int group;       // levels per block row
  int ngp;         // ngp convention: pos + 0.5; dense corner rows from dim D-1
  int round_bf16;  // f32 table values rounded to bf16 before the weighting
  float bound;
  float two_bound;
};

__device__ __forceinline__ uint32_t prime(int d) {
  return d == 0 ? 1u : d == 1 ? 2654435761u : 805459861u;
}

template <int D>
struct Point {
  float u[D];  // unit coordinates, clamped to [0, 1]
  bool in;
};

template <int D>
__device__ __forceinline__ Point<D> locate(const float* __restrict__ x, long long p,
                                           const Args& a) {
  Point<D> pt;
  pt.in = true;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float v = __fdiv_rn(__fadd_rn(__ldg(x + p * D + d), a.bound), a.two_bound);
    pt.in = pt.in && v >= 0.f && v <= 1.f;
    pt.u[d] = fminf(fmaxf(v, 0.f), 1.f);
  }
  return pt;
}

// The point's cell at one level and its fraction within it.
template <int D>
__device__ __forceinline__ void cell_of(const Point<D>& pt, const Level& lv, int ngp,
                                        uint32_t (&c)[D], float (&fr)[D]) {
  const float top = (float)(lv.res - 1);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float pos = __fmul_rn(pt.u[d], lv.scale);
    if (ngp) pos = __fadd_rn(pos, 0.5f);
    const float pf = fminf(fmaxf(floorf(pos), 0.f), top);
    fr[d] = __fsub_rn(pos, pf);
    c[d] = (uint32_t)pf;
  }
}

// _corner_indices / _cell_indices of ops/hashgrid.py in uint32 arithmetic.
template <int D>
__device__ __forceinline__ uint32_t row_of(const uint32_t (&g)[D], const Level& lv,
                                           bool ngp_order) {
  uint32_t idx;
  if (lv.hashed) {
    idx = g[0];
#pragma unroll
    for (int d = 1; d < D; ++d) idx ^= g[d] * prime(d);
  } else if (ngp_order) {
    idx = g[D - 1];
#pragma unroll
    for (int d = D - 2; d >= 0; --d) idx = idx * lv.stride + g[d];
  } else {
    idx = g[0];
#pragma unroll
    for (int d = 1; d < D; ++d) idx = idx * lv.stride + g[d];
  }
  if (lv.wrap) idx = (lv.wrap & (lv.wrap - 1)) ? idx % lv.wrap : idx & (lv.wrap - 1);
  return idx;
}

// Bit of corner c along dim d; dim 0 is the most significant.
template <int D>
__device__ __forceinline__ int bit(int c, int d) {
  return (c >> (D - 1 - d)) & 1;
}

// The trilinear weight of corner c: the product over dims 0..D-1 in order.
template <int D>
__device__ __forceinline__ float weight(int c, const float (&fr)[D]) {
  float w = 1.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float s = bit<D>(c, d) ? fr[d] : __fsub_rn(1.f, fr[d]);
    w = d == 0 ? s : __fmul_rn(w, s);
  }
  return w;
}

template <int W>
__device__ __forceinline__ void load_row(const float* __restrict__ t, uint32_t row,
                                         float (&v)[W]) {
  const float* p = t + (size_t)row * W;
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int k = 0; k < W / 4; ++k) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p) + k);
      v[4 * k] = q.x; v[4 * k + 1] = q.y; v[4 * k + 2] = q.z; v[4 * k + 3] = q.w;
    }
  } else if constexpr (W == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = __ldg(p);
  }
}

__device__ __forceinline__ float bf16_lo(uint32_t q) { return __uint_as_float(q << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t q) { return __uint_as_float(q & 0xffff0000u); }

template <int W>
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ t, uint32_t row,
                                         float (&v)[W]) {
  const __nv_bfloat16* p = t + (size_t)row * W;
  if constexpr (W % 8 == 0) {
#pragma unroll
    for (int k = 0; k < W / 8; ++k) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + k);
      const uint32_t w4[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[8 * k + 2 * i] = bf16_lo(w4[i]);
        v[8 * k + 2 * i + 1] = bf16_hi(w4[i]);
      }
    }
  } else if constexpr (W == 4) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = bf16_lo(q.x); v[1] = bf16_hi(q.x); v[2] = bf16_lo(q.y); v[3] = bf16_hi(q.y);
  } else if constexpr (W == 2) {
    const uint32_t q = __ldg(reinterpret_cast<const unsigned int*>(p));
    v[0] = bf16_lo(q); v[1] = bf16_hi(q);
  } else {
    v[0] = bf16_lo(__ldg(reinterpret_cast<const unsigned short*>(p)));
  }
}

__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The 2^D corner rows' features of one level: f[c][j] (the cell layout's
// one row holds corner c's features at c * F).
template <int D, int F, bool CELL, typename T>
__device__ __forceinline__ void gather(const Level& lv, const Args& a,
                                       const uint32_t (&c0)[D], float (&f)[1 << D][F]) {
  constexpr int K = 1 << D;
  const T* tab = static_cast<const T*>(lv.table);
  if constexpr (CELL) {
    float v[K * F];
    load_row<K * F>(tab, row_of<D>(c0, lv, false), v);
#pragma unroll
    for (int c = 0; c < K; ++c)
#pragma unroll
      for (int j = 0; j < F; ++j) f[c][j] = v[c * F + j];
  } else {
    uint32_t rows[K];
#pragma unroll
    for (int c = 0; c < K; ++c) {
      uint32_t g[D];
#pragma unroll
      for (int d = 0; d < D; ++d) g[d] = c0[d] + bit<D>(c, d);
      rows[c] = row_of<D>(g, lv, a.ngp);
    }
#pragma unroll
    for (int c = 0; c < K; ++c) load_row<F>(tab, rows[c], f[c]);
  }
  if (a.round_bf16) {
#pragma unroll
    for (int c = 0; c < K; ++c)
#pragma unroll
      for (int j = 0; j < F; ++j) f[c][j] = to_bf16(f[c][j]);
  }
}

// The sum over the corners of the weighted features, in the order torch's
// CPU reduction over dim 1 of an (N, 2^D, F) tensor takes: at 8 corners and
// F = 2 or 8 four partial sums t_c + t_{c+4}, added in order; otherwise
// corner by corner. This pins how torch's vectorised CPU sum happens to
// split that reduction, as read on torch 2.13.0 and 2.11.0 with the AVX-512
// dispatch; another torch version or CPU dispatch may take another order
// (the card's own sum does at F = 4). With the product of the weights in dim
// order, also the CPU's, the features then equal the CPU's plain version bit
// for bit; tests/test_torch_hashgrid_kernel.py checks the CPU's order first
// and skips that comparison where it differs.
template <int K, int F>
__device__ __forceinline__ void corner_sum(const float (&t)[K][F], float (&o)[F]) {
#pragma unroll
  for (int j = 0; j < F; ++j) {
    if constexpr (K == 8 && (F == 2 || F == 8)) {
      o[j] = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(t[0][j], t[4][j]),
                                           __fadd_rn(t[1][j], t[5][j])),
                                 __fadd_rn(t[2][j], t[6][j])),
                       __fadd_rn(t[3][j], t[7][j]));
    } else {
      o[j] = t[0][j];
#pragma unroll
      for (int c = 1; c < K; ++c) o[j] = __fadd_rn(o[j], t[c][j]);
    }
  }
}

template <int D, int F, bool CELL, typename T>
__global__ void __launch_bounds__(kThreads)
    hashgrid_forward_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                            const __grid_constant__ Args a) {
  extern __shared__ float tile[];  // kThreads x (group * F + 1)
  constexpr int K = 1 << D;
  const int l0 = blockIdx.y * a.group;
  const int l1 = min(l0 + a.group, a.levels);
  const int gf = (l1 - l0) * F;
  const int ts = gf + 1;
  const long long n0 = (long long)blockIdx.x * kThreads;
  const long long p = n0 + threadIdx.x;
  if (p < n) {
    const Point<D> pt = locate<D>(x, p, a);
    float* mine = tile + threadIdx.x * ts;
    for (int l = l0; l < l1; ++l) {
      float o[F];
#pragma unroll
      for (int j = 0; j < F; ++j) o[j] = 0.f;
      if (pt.in) {
        const Level& lv = a.lv[l];
        uint32_t c0[D];
        float fr[D];
        cell_of<D>(pt, lv, a.ngp, c0, fr);
        float f[K][F];
        gather<D, F, CELL, T>(lv, a, c0, f);
#pragma unroll
        for (int c = 0; c < K; ++c) {
          const float w = weight<D>(c, fr);
#pragma unroll
          for (int j = 0; j < F; ++j) f[c][j] = __fmul_rn(f[c][j], w);
        }
        corner_sum<K, F>(f, o);
      }
#pragma unroll
      for (int j = 0; j < F; ++j) mine[(l - l0) * F + j] = o[j];
    }
  }
  __syncthreads();
  const long long left = n - n0;
  const int rows = left < kThreads ? (int)left : kThreads;
  const size_t lf = (size_t)a.levels * F;
  float* dst = out + (size_t)n0 * lf + (size_t)l0 * F;
  for (int i = threadIdx.x; i < rows * gf; i += kThreads) {
    const int r = i / gf;
    const int c = i - r * gf;
    dst[(size_t)r * lf + c] = tile[r * ts + c];
  }
}

// One row's W gradient values, added atomically to device memory.
template <int W>
__device__ __forceinline__ void add_row(float* dst, const float (&v)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int k = 0; k < W / 4; ++k)
      atomicAdd(reinterpret_cast<float4*>(dst) + k,
                make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]));
  } else if constexpr (W == 2) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
  } else {
    atomicAdd(dst, v[0]);
  }
}

// The table gradient. rows_out == nullptr: atomic adds (shared accumulators
// for the levels whose `acc` >= 0). Otherwise the deterministic route:
// rows_out (L, N * K) and vals_out (L, N * K, W) get each (point, row) and
// its values, out-of-bounds points included (with zero values), in the
// order of the plain version's index_select.
template <int D, int F, bool CELL>
__global__ void __launch_bounds__(kThreads)
    hashgrid_backward_kernel(const float* __restrict__ x, const float* __restrict__ g, int n,
                             const __grid_constant__ Args a, long long* __restrict__ rows_out,
                             float* __restrict__ vals_out) {
  extern __shared__ float acc[];
  constexpr int K = CELL ? 1 : (1 << D);
  constexpr int W = CELL ? (F << D) : F;
  const int l0 = blockIdx.y * a.group;
  const int l1 = min(l0 + a.group, a.levels);
  const bool emit = rows_out != nullptr;
  int acc_n = 0;
  for (int l = l0; l < l1; ++l)
    if (a.lv[l].acc >= 0) acc_n = max(acc_n, a.lv[l].acc + (int)a.lv[l].rows * W);
  for (int i = threadIdx.x; i < acc_n; i += kThreads) acc[i] = 0.f;
  if (acc_n) __syncthreads();

  const size_t lf = (size_t)a.levels * F;
  const long long tiles = ((long long)n + kThreads - 1) / kThreads;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long p = t * kThreads + threadIdx.x;
    if (p >= n) continue;
    const Point<D> pt = locate<D>(x, p, a);
    if (!pt.in && !emit) continue;  // their gradient is zero
    const float mask = pt.in ? 1.f : 0.f;
    for (int l = l0; l < l1; ++l) {
      const Level& lv = a.lv[l];
      float gl[F];
#pragma unroll
      for (int j = 0; j < F; ++j) gl[j] = __fmul_rn(__ldg(g + p * lf + l * F + j), mask);
      uint32_t c0[D];
      float fr[D];
      cell_of<D>(pt, lv, a.ngp, c0, fr);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        uint32_t row;
        float v[W];
        if constexpr (CELL) {
          row = row_of<D>(c0, lv, false);
#pragma unroll
          for (int c = 0; c < (1 << D); ++c) {
            const float w = weight<D>(c, fr);
#pragma unroll
            for (int j = 0; j < F; ++j) v[c * F + j] = __fmul_rn(gl[j], w);
          }
        } else {
          uint32_t gc[D];
#pragma unroll
          for (int d = 0; d < D; ++d) gc[d] = c0[d] + bit<D>(k, d);
          row = row_of<D>(gc, lv, a.ngp);
          const float w = weight<D>(k, fr);
#pragma unroll
          for (int j = 0; j < F; ++j) v[j] = __fmul_rn(gl[j], w);
        }
        if (emit) {
          const size_t e = ((size_t)l * n + p) * K + k;
          rows_out[e] = row;
#pragma unroll
          for (int j = 0; j < W; ++j) vals_out[e * W + j] = v[j];
        } else if (lv.acc >= 0) {
#pragma unroll
          for (int j = 0; j < W; ++j) atomicAdd(acc + lv.acc + row * W + j, v[j]);
        } else {
          add_row<W>(lv.grad + (size_t)row * W, v);
        }
      }
    }
  }
  if (acc_n) {
    __syncthreads();
    for (int l = l0; l < l1; ++l) {
      const Level& lv = a.lv[l];
      if (lv.acc < 0) continue;
      const int m = (int)lv.rows * W;
      for (int i = threadIdx.x; i < m; i += kThreads) {
        const float v = acc[lv.acc + i];
        if (v != 0.f) atomicAdd(lv.grad + i, v);
      }
    }
  }
}

// d loss / d x: per point, over every level, the features chained through
// the trilinear weights, the scale, the clamp and the division.
template <int D, int F, bool CELL, typename T>
__global__ void __launch_bounds__(kThreads)
    hashgrid_dx_kernel(const float* __restrict__ x, const float* __restrict__ g,
                       float* __restrict__ dx, int n, const __grid_constant__ Args a) {
  constexpr int K = 1 << D;
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  const Point<D> pt = locate<D>(x, p, a);
  float s[D];
#pragma unroll
  for (int d = 0; d < D; ++d) s[d] = 0.f;
  if (pt.in) {
    const size_t lf = (size_t)a.levels * F;
    for (int l = 0; l < a.levels; ++l) {
      const Level& lv = a.lv[l];
      uint32_t c0[D];
      float fr[D];
      cell_of<D>(pt, lv, a.ngp, c0, fr);
      float f[K][F];
      gather<D, F, CELL, T>(lv, a, c0, f);
      float gl[F];
#pragma unroll
      for (int j = 0; j < F; ++j) gl[j] = __ldg(g + p * lf + l * F + j);
      float dfr[D];
#pragma unroll
      for (int d = 0; d < D; ++d) dfr[d] = 0.f;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        float dw = 0.f;  // d loss / d w_c
#pragma unroll
        for (int j = 0; j < F; ++j) dw = __fadd_rn(dw, __fmul_rn(gl[j], f[c][j]));
#pragma unroll
        for (int d = 0; d < D; ++d) {
          float others = 1.f;
#pragma unroll
          for (int e = 0; e < D; ++e)
            if (e != d)
              others = __fmul_rn(others, bit<D>(c, e) ? fr[e] : __fsub_rn(1.f, fr[e]));
          const float t = __fmul_rn(dw, others);
          dfr[d] = bit<D>(c, d) ? __fadd_rn(dfr[d], t) : __fsub_rn(dfr[d], t);
        }
      }
#pragma unroll
      for (int d = 0; d < D; ++d) s[d] = __fadd_rn(s[d], __fmul_rn(dfr[d], lv.scale));
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) {
    // torch.maximum / minimum pass half the gradient at a tie
    const float u = pt.u[d];
    const float half = (u == 0.f || u == 1.f) ? __fmul_rn(s[d], 0.5f) : s[d];
    dx[p * D + d] = __fdiv_rn(half, a.two_bound);
  }
}

struct DeviceInfo {
  int sms = 0;
  int smem_optin = 0;
};

DeviceInfo device_info(int dev) {
  static DeviceInfo cache[kMaxDevices];
  DeviceInfo& d = cache[dev];
  if (d.sms == 0) {
    cudaDeviceGetAttribute(&d.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return d;
}

int current_device(int* dev) {
  const cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  return (*dev < 0 || *dev >= kMaxDevices) ? (int)cudaErrorInvalidDevice : 0;
}

// Allows `smem` bytes of dynamic shared memory to `kernel` on `dev` once.
template <typename Kernel>
int allow_smem(Kernel kernel, int* allowed, int dev, size_t smem) {
  if ((int)smem <= 48 * 1024 || (int)smem <= allowed[dev]) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  allowed[dev] = (int)smem;
  return 0;
}

struct Launch {
  const float* x;
  const float* g;
  float* out;  // forward: features; dx: the input gradient
  int n;
  long long* rows_out;
  float* vals_out;
  cudaStream_t stream;
  Args a;
};

template <int D, int F, bool CELL, typename T>
int launch_forward(Launch& L) {
  auto kernel = hashgrid_forward_kernel<D, F, CELL, T>;
  static int allowed[kMaxDevices];
  int dev = 0;
  int e = current_device(&dev);
  if (e) return e;
  const size_t smem = (size_t)kThreads * (L.a.group * F + 1) * sizeof(float);
  if (smem > (size_t)device_info(dev).smem_optin) return (int)cudaErrorInvalidValue;
  e = allow_smem(kernel, allowed, dev, smem);
  if (e) return e;
  const dim3 grid((unsigned)((L.n + kThreads - 1) / kThreads),
                  (unsigned)((L.a.levels + L.a.group - 1) / L.a.group));
  kernel<<<grid, kThreads, smem, L.stream>>>(L.x, L.out, L.n, L.a);
  return (int)cudaGetLastError();
}

template <int D, int F, bool CELL, typename T>
int launch_dx(Launch& L) {
  const unsigned blocks = (unsigned)((L.n + kThreads - 1) / kThreads);
  hashgrid_dx_kernel<D, F, CELL, T><<<blocks, kThreads, 0, L.stream>>>(L.x, L.g, L.out,
                                                                       L.n, L.a);
  return (int)cudaGetLastError();
}

template <int D, int F, bool CELL, typename T>
int launch_backward(Launch& L) {
  constexpr int K = CELL ? 1 : (1 << D);
  constexpr int W = CELL ? (F << D) : F;
  auto kernel = hashgrid_backward_kernel<D, F, CELL>;
  static int allowed[kMaxDevices];
  int dev = 0;
  int e = current_device(&dev);
  if (e) return e;
  const DeviceInfo info = device_info(dev);
  Args& a = L.a;
  const long long tiles = ((long long)L.n + kThreads - 1) / kThreads;
  int per_sm = 0;
  cudaError_t ce = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (ce != cudaSuccess) return (int)ce;
  long long blocks = (long long)(per_sm < 1 ? 1 : per_sm) * info.sms;
  if (blocks > tiles) blocks = tiles;
  // a level is summed in shared memory when its rows fit beside the
  // group's earlier ones and a block's points touch at least as many rows
  // as the level has: then a flush costs less than the atomics it saves
  const long long per_block = (L.n + blocks - 1) / blocks;
  int smem_floats = 0;
  for (int l0 = 0; l0 < a.levels; l0 += a.group) {
    int off = 0;
    for (int l = l0; l < l0 + a.group && l < a.levels; ++l) {
      Level& lv = a.lv[l];
      const long long m = (long long)lv.rows * W;
      lv.acc = -1;
      if (L.rows_out == nullptr && off + m <= kAccFloats && per_block * K >= (long long)lv.rows) {
        lv.acc = off;
        off += (int)m;
      }
    }
    smem_floats = off > smem_floats ? off : smem_floats;
  }
  const size_t smem = (size_t)smem_floats * sizeof(float);
  if (smem) {
    e = allow_smem(kernel, allowed, dev, smem);
    if (e) return e;
    ce = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (ce != cudaSuccess) return (int)ce;
    const long long cap = (long long)(per_sm < 1 ? 1 : per_sm) * info.sms;
    if (blocks > cap) blocks = cap;
  }
  const dim3 grid((unsigned)blocks, (unsigned)((a.levels + a.group - 1) / a.group));
  kernel<<<grid, kThreads, smem, L.stream>>>(L.x, L.g, L.n, a, L.rows_out, L.vals_out);
  return (int)cudaGetLastError();
}

// The instantiations: D 2 or 3, F 1, 2, 4 or 8, corner or cell layout.
#define NERFNAV_SHAPES(X, T)                                                    \
  X(2, 1, false, T) X(2, 1, true, T) X(2, 2, false, T) X(2, 2, true, T)         \
  X(2, 4, false, T) X(2, 4, true, T) X(2, 8, false, T) X(2, 8, true, T)         \
  X(3, 1, false, T) X(3, 1, true, T) X(3, 2, false, T) X(3, 2, true, T)         \
  X(3, 4, false, T) X(3, 4, true, T) X(3, 8, false, T) X(3, 8, true, T)

#define NERFNAV_CASE(D, F, CELL, T) \
  if (d == D && f == F && cell == CELL) return fn.template operator()<D, F, CELL, T>();

// Launchers as functors, so that dispatch can pick the instantiation.
struct Forward {
  Launch& L;
  template <int D, int F, bool CELL, typename T>
  int operator()() const { return launch_forward<D, F, CELL, T>(L); }
};
struct Backward {
  Launch& L;
  template <int D, int F, bool CELL, typename T>
  int operator()() const { return launch_backward<D, F, CELL, T>(L); }
};
struct InputGrad {
  Launch& L;
  template <int D, int F, bool CELL, typename T>
  int operator()() const { return launch_dx<D, F, CELL, T>(L); }
};

template <typename Fn>
int dispatch(int d, int f, bool cell, bool bf16, const Fn& fn) {
  if (bf16) {
    NERFNAV_SHAPES(NERFNAV_CASE, __nv_bfloat16)
  } else {
    NERFNAV_SHAPES(NERFNAV_CASE, float)
  }
  return (int)cudaErrorInvalidValue;
}

// Fills `a` from the host arrays; returns a cudaError_t.
int fill(Args& a, int levels, int group, int ngp, int round_bf16, float bound,
         const void* tables, const void* grads, const void* scales, const void* params) {
  if (levels < 1 || levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  a.levels = levels;
  a.group = group < 1 ? 1 : (group > levels ? levels : group);
  a.ngp = ngp;
  a.round_bf16 = round_bf16;
  a.bound = bound;
  a.two_bound = 2.f * bound;
  const void* const* tp = static_cast<const void* const*>(tables);
  void* const* gp = static_cast<void* const*>(grads);
  const float* sp = static_cast<const float*>(scales);
  const uint32_t* pp = static_cast<const uint32_t*>(params);
  for (int l = 0; l < levels; ++l) {
    Level& lv = a.lv[l];
    lv.table = tp ? tp[l] : nullptr;
    lv.grad = gp ? static_cast<float*>(gp[l]) : nullptr;
    if ((tp && reinterpret_cast<uintptr_t>(tp[l]) % 16) ||
        (gp && reinterpret_cast<uintptr_t>(gp[l]) % 16))
      return (int)cudaErrorMisalignedAddress;
    lv.scale = sp[l];
    lv.res = pp[5 * l];
    lv.stride = pp[5 * l + 1];
    lv.wrap = pp[5 * l + 2];
    lv.hashed = (int)pp[5 * l + 3];
    lv.rows = pp[5 * l + 4];
    lv.acc = -1;
    if (lv.res < 1) return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// Every function launches on `stream` and returns cudaGetLastError() after
// the launch (0 = ok). tables / grads are HOST arrays of `levels` device
// pointers; scales a host array of `levels` floats; params a host array of
// 5 uint32 per level: R, dense stride, wrap (0 = none), hashed, rows. x is
// (n, d) f32, the features (n, levels * f) f32, g their gradient.

extern "C" int nerfnav_hashgrid_forward(const void* x, void* out, int n, int d, int f,
                                        int cell, int bf16_table, int round_bf16, int ngp,
                                        float bound, int levels, int group,
                                        const void* tables, const void* scales,
                                        const void* params, void* stream) {
  if (group * f > kMaxGroupFloats) return (int)cudaErrorInvalidValue;
  Launch L = {};
  int e = fill(L.a, levels, group, ngp, round_bf16, bound, tables, nullptr, scales, params);
  if (e) return e;
  if (n <= 0) return 0;
  L.x = static_cast<const float*>(x);
  L.out = static_cast<float*>(out);
  L.n = n;
  L.stream = static_cast<cudaStream_t>(stream);
  return dispatch(d, f, cell != 0, bf16_table != 0, Forward{L});
}

// rows_out == NULL: atomic adds into grads (zeroed by the caller). Else the
// deterministic route: rows_out (levels, n * K) int64 and vals_out
// (levels, n * K, W) f32, K = 2^d corner rows of W = f values, or one cell
// row of W = 2^d * f; grads is then unused.
extern "C" int nerfnav_hashgrid_backward(const void* x, const void* g, int n, int d, int f,
                                         int cell, int ngp, float bound, int levels,
                                         int group, const void* grads, const void* scales,
                                         const void* params, void* rows_out, void* vals_out,
                                         void* stream) {
  Launch L = {};
  int e = fill(L.a, levels, group, ngp, 0, bound, nullptr, rows_out ? nullptr : grads,
               scales, params);
  if (e) return e;
  if (n <= 0) return 0;
  L.x = static_cast<const float*>(x);
  L.g = static_cast<const float*>(g);
  L.n = n;
  L.rows_out = static_cast<long long*>(rows_out);
  L.vals_out = static_cast<float*>(vals_out);
  L.stream = static_cast<cudaStream_t>(stream);
  return dispatch(d, f, cell != 0, false, Backward{L});
}

extern "C" int nerfnav_hashgrid_dx(const void* x, const void* g, void* dx, int n, int d,
                                   int f, int cell, int bf16_table, int round_bf16, int ngp,
                                   float bound, int levels, const void* tables,
                                   const void* scales, const void* params, void* stream) {
  Launch L = {};
  int e = fill(L.a, levels, levels, ngp, round_bf16, bound, tables, nullptr, scales, params);
  if (e) return e;
  if (n <= 0) return 0;
  L.x = static_cast<const float*>(x);
  L.g = static_cast<const float*>(g);
  L.out = static_cast<float*>(dx);
  L.n = n;
  L.stream = static_cast<cudaStream_t>(stream);
  return dispatch(d, f, cell != 0, bf16_table != 0, InputGrad{L});
}
