// Fully fused bias-free MLP forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nerfnav_tpu/ops/fused_mlp.py::_fused_kernel
// (launched by fused_mlp_forward, pallas_call at fused_mlp.py:98). It computes
// the function of _mlp_math: for each layer, h = act(h @ W_i) with f32
// accumulation; each hidden activation is rounded back to bf16 (round to
// nearest even); the output activation is applied in f32 and the result
// written as f32 (N, D_out).
//
// What bounds it on an H100: at the eval render's shapes (sigma 32->64->16 and
// color 31->64->64->3, N = 32,768 rows) a row costs 6.1-12.5 kFLOP against
// 136-192 bytes of f32 input and output, far under the ~295 FLOP/byte the
// bf16 tensor cores need: the byte bound is 1.9 us (sigma) and 1.3 us
// (color), the FLOP bound 0.2 / 0.4 us. At that N the card holds ~2 tiles of
// work per SM, so what is left after the bytes is serial latency: the
// launch, one trip to L2 for the weights, one to HBM for x, and the layer
// chain. The design cuts each of those.
//
// Design:
// - Persistent blocks of 4 warps: the grid is min(tiles, resident blocks per
//   SM x SMs) and each block walks row tiles with a stride of gridDim.x.
//   Each warp owns R = 16 * MT rows of a tile (MT = 2 m-tiles up to width 64,
//   1 above).
// - The weights are staged once per block, in the mma B-fragment order (one
//   conflict-free 8-byte load per lane per k16 x n8 tile), zero-padded to
//   k16 and n8 tile counts that are powers of two. The raw row-major weights
//   arrive by one coalesced cp.async copy, in flight with the first x tile,
//   and are permuted inside shared memory; one barrier follows, none per
//   layer. Where the layers do not all fit (eight 256-wide layers), the
//   block gathers one layer at a time from L2 instead, between two barriers.
// - The layer chain stays in registers: mma.sync.m16n8k16 (bf16 in, f32
//   accumulate). The accumulators of n8 tiles 2j and 2j+1 are exactly the A
//   fragment of k16 tile j of the next layer, so a layer is: accumulate,
//   activate in registers, round with __float22bfloat162_rn, feed the next
//   mma. No shared-memory round trip, no scratch. Each layer's tile counts
//   pick, once per layer, a body unrolled for exactly those counts: an
//   unrolled body guarded by runtime widths either issues predicated-off
//   work for the widest layer or splits every tile into a basic block of
//   its own, with each shared-memory load serialised before its product.
// - x reaches shared memory by cp.async, in two stages: a warp copies its
//   next tile into its shared slot as soon as the current tile's layer-0 A
//   fragments are in registers, so the copy runs under the current tile's
//   layers. (A second shared slot, two tiles ahead, measured no faster.) A
//   warp's rows are one contiguous, 16-byte-aligned range (the wrapper
//   guarantees x's alignment); when D_in % 4 == 0 rows are laid at a stride
//   of 8 mod 32 floats, so the float2 fragment loads are conflict-free;
//   otherwise (D_in = 31) rows are copied flat, 16 bytes at a time, with a
//   4-byte tail.
// - The output goes from the accumulators straight to device memory, with
//   guarded stores at the ragged edge; the 3-wide color output costs one n8
//   tile.
// Why not wgmma / TMA tensor maps: the tensor-core work is 0.2-0.4 us at the
// dense peak, so wgmma buys nothing measurable here, and a 2D TMA tensor map
// cannot describe the color input (row stride 124 bytes, not a multiple of
// 16).
// What the previous design (a block per 64 rows, wmma through an f32
// scratch) spent and this one does not: per-layer weight re-staging with
// two barriers each, the f32 scratch round trip and serial lane loop per
// 16x16 tile, and 512 blocks that never overlapped a load with the chain.
//
// Limits (checked by the wrapper and here): 1-8 layers, every width 1-256,
// any N; x 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxWidth = 256;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxDevices = 64;
constexpr int kStageBatch = 8;  // weight slots a thread gathers per trip to L2

struct MlpArgs {
  const __nv_bfloat16* w[kMaxLayers];  // (dims[i], dims[i+1]) row major
  int dims[kMaxLayers + 1];
  int kt[kMaxLayers];          // k16 tiles of layer i's input, a power of 2
  int nt[kMaxLayers];          // n8 tiles of layer i's output, a power of 2
  int woff[kMaxLayers + 1];    // fragment slot (8 bytes) where layer i starts
  int roff[kMaxLayers + 1];    // bf16 element where layer i's raw copy starts
  int n_layers;
  int resident;  // 1: every layer staged once; 0: one layer at a time
  int wslots;    // slots of the shared weight region
  int xs;        // row stride of x in shared memory, in floats
};

// Activation ids follow _ACTIVATIONS in ops/fused_mlp.py. relu and none
// (the eval render's) are inlined; the others share one out-of-line copy, so
// the unrolled layer chain does not carry their bodies (sinf's slow path
// among them) for every element it activates.
__device__ __noinline__ float activate_call(float v, int act) {
  switch (act) {
    case 2: return expf(v);                                // exp
    case 3: return 1.f / (1.f + expf(-v));                 // sigmoid
    case 4: return sinf(v);                                // sine
    case 5: return 0.5f * (v + sqrtf(v * v + 4.f));        // squareplus
    default: return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));  // softplus
  }
}

// The activation of the accumulators, chosen once per layer rather than per
// element.
template <int MT, int NT>
__device__ __forceinline__ void activate_tiles(float (&acc)[MT][NT][4], int act) {
  if (act == 1) return;  // none
  if (act == 0) {        // relu
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][j][i] = fmaxf(acc[m][j][i], 0.f);
    return;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = activate_call(acc[m][j][i], act);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __float22bfloat162_rn(make_float2(lo, hi));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage layers [l0, l1) into w_s in B-fragment order: slot (kk * nt + j) *
// 32 + lane of a layer holds W[16kk + 2t + {0, 1, 8, 9}][8j + g] (g = lane
// / 4, t = lane % 4) as two bf16 pairs, zero where k or n lies in the
// padding. Each thread gathers whole slots, kStageBatch at a time, so one
// batch costs one trip to L2. The caller puts a barrier after.
__device__ void stage_weights(const MlpArgs& a, int l0, int l1, uint2* w_s) {
  const int base = a.woff[l0];
  const int n_slots = a.woff[l1] - base;
  for (int s0 = threadIdx.x; s0 < n_slots; s0 += kStageBatch * kThreads) {
    uint2 v[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int s = s0 + u * kThreads;
      v[u] = make_uint2(0, 0);
      if (s < n_slots) {
        int l = l0;
        while (l + 1 < l1 && base + s >= a.woff[l + 1]) ++l;
        const int r = base + s - a.woff[l];
        const int kk = (r >> 5) / a.nt[l];
        const int col = ((r >> 5) - kk * a.nt[l]) * 8 + ((r & 31) >> 2);
        const int k = kk * 16 + (r & 3) * 2;
        const int din = a.dims[l];
        const int dout = a.dims[l + 1];
        const unsigned short* w = reinterpret_cast<const unsigned short*>(a.w[l]) + col;
        auto at = [&](int kr) -> uint32_t {
          return k + kr < din && col < dout ? __ldg(w + (size_t)(k + kr) * dout) : 0u;
        };
        v[u] = make_uint2(at(0) | at(1) << 16, at(8) | at(9) << 16);
      }
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int s = s0 + u * kThreads;
      if (s < n_slots) w_s[s] = v[u];
    }
  }
}

// Stage every layer when all fit: one coalesced cp.async copy of the raw
// row-major weights (16 bytes a piece, in flight with the first x tile),
// then a permutation inside shared memory into the B-fragment order that
// stage_weights describes. The caller puts a barrier after.
__device__ void stage_resident(const MlpArgs& a, uint2* w_s, unsigned short* raw) {
  const int tid = threadIdx.x;
  for (int l = 0; l < a.n_layers; ++l) {
    const int ne = a.dims[l] * a.dims[l + 1];
    const unsigned short* src = reinterpret_cast<const unsigned short*>(a.w[l]);
    unsigned short* dst = raw + a.roff[l];
    const int n16 = reinterpret_cast<uintptr_t>(src) % 16 ? 0 : ne / 8;
    for (int c = tid; c < n16; c += kThreads) cp_async16(dst + c * 8, src + c * 8);
    for (int e = n16 * 8 + tid; e < ne; e += kThreads) dst[e] = src[e];
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  for (int l = 0; l < a.n_layers; ++l) {
    const int din = a.dims[l];
    const int dout = a.dims[l + 1];
    const int nt = a.nt[l];
    const int log_nt = __ffs(nt) - 1;  // nt is a power of 2
    const unsigned short* w = raw + a.roff[l];
    uint2* dst = w_s + a.woff[l];
    const int n_slots = a.woff[l + 1] - a.woff[l];
    for (int s = tid; s < n_slots; s += kThreads) {
      const int tile = s >> 5;
      const int kk = tile >> log_nt;
      const int col = (tile & (nt - 1)) * 8 + ((s & 31) >> 2);
      const int k = kk * 16 + (s & 3) * 2;
      auto at = [&](int kr) -> uint32_t {
        return k + kr < din && col < dout ? w[(k + kr) * dout + col] : 0u;
      };
      dst[s] = make_uint2(at(0) | at(1) << 16, at(8) | at(9) << 16);
    }
  }
}

// Copy this warp's rows [r0, r0 + R) of x (those below n) into x_s.
template <int R>
__device__ __forceinline__ void load_x(const float* __restrict__ x, float* x_s,
                                       int r0, int n, int d0, int xs, int lane) {
  const int vr = min(R, n - r0);
  if (vr > 0) {
    const float* src = x + (size_t)r0 * d0;
    if (xs != d0) {  // d0 % 4 == 0: whole 16-byte chunks per row, padded rows
      const int cpr = d0 / 4;
      for (int c = lane; c < vr * cpr; c += 32) {
        const int r = c / cpr;
        cp_async16(x_s + r * xs + (c - r * cpr) * 4, src + c * 4);
      }
    } else {  // flat copy of vr * d0 floats
      const int f = vr * d0;
      const int full = f / 4;
      for (int c = lane; c < full; c += 32) cp_async16(x_s + c * 4, src + c * 4);
      for (int e = full * 4 + lane; e < f; e += 32) cp_async4(x_s + e, src + e);
    }
  }
  cp_async_commit();
}

// mma over k16 tiles [0, KTL) and n8 tiles [0, NTL) of one layer. B
// fragments come from the layer's slots in w_s; nothing is guarded, so the
// loads can all be issued ahead of the products.
template <int MT, int KT, int NTL, int KTL = 1>
__device__ __forceinline__ void layer_mma(int kt, const uint2* wl, int lane,
                                          const uint32_t (&af)[MT][KT][4],
                                          float (&acc)[MT][NTL][4]) {
  if constexpr (KTL < KT) {
    if (kt > KTL) return layer_mma<MT, KT, NTL, 2 * KTL>(kt, wl, lane, af, acc);
  }
#pragma unroll
  for (int kk = 0; kk < KTL; ++kk) {
#pragma unroll
    for (int j = 0; j < NTL; ++j) {
      const uint2 b = wl[(kk * NTL + j) * 32 + lane];
#pragma unroll
      for (int m = 0; m < MT; ++m) mma_bf16(acc[m][j], af[m][kk], b);
    }
  }
}

// Where the last layer's rows go.
struct Output {
  float* out;
  int n, dout, r0;
};

// One layer with NTL n8 tiles: products, activation, then either the next
// layer's A fragments (accumulators of n8 tiles 2kk and 2kk + 1 are the A
// fragment of k16 tile kk) or the output. The layer's tile counts are powers
// of two, so NTL and KTL are compile-time: the dispatch picks the unrolled
// body once per layer.
template <int MT, int KT, int NTL = 1>
__device__ __forceinline__ void layer(int nt, int kt, const uint2* wl, int lane,
                                      uint32_t (&af)[MT][KT][4], int act,
                                      bool last, const Output& o) {
  if constexpr (NTL < 2 * KT) {
    if (nt > NTL) return layer<MT, KT, 2 * NTL>(nt, kt, wl, lane, af, act, last, o);
  }
  float acc[MT][NTL][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;
  layer_mma<MT, KT, NTL>(kt, wl, lane, af, acc);
  activate_tiles<MT, NTL>(acc, act);

  const int g = lane >> 2;
  const int t = lane & 3;
  if (last) {
#pragma unroll
    for (int j = 0; j < NTL; ++j) {
      const int col = j * 8 + 2 * t;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = o.r0 + m * 16 + g + 8 * h;
          if (row < o.n && col < o.dout) {
            float* p = o.out + (size_t)row * o.dout + col;
            if ((o.dout & 1) == 0) {  // col + 1 < dout as well
              *reinterpret_cast<float2*>(p) =
                  make_float2(acc[m][j][2 * h], acc[m][j][2 * h + 1]);
            } else {
              p[0] = acc[m][j][2 * h];
              if (col + 1 < o.dout) p[1] = acc[m][j][2 * h + 1];
            }
          }
        }
      }
    }
    return;
  }
  // padded columns meet zero weight rows in the next layer
#pragma unroll
  for (int kk = 0; kk < (NTL + 1) / 2; ++kk) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float* p = acc[m][2 * kk];
      af[m][kk][0] = pack_bf16(p[0], p[1]);
      af[m][kk][1] = pack_bf16(p[2], p[3]);
      if (2 * kk + 1 < NTL) {
        const float* q = acc[m][2 * kk + 1];
        af[m][kk][2] = pack_bf16(q[0], q[1]);
        af[m][kk][3] = pack_bf16(q[2], q[3]);
      } else {
        af[m][kk][2] = 0u;
        af[m][kk][3] = 0u;
      }
    }
  }
}

template <int PW, int MT>
__global__ void __launch_bounds__(kThreads)
fused_mlp_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                 MlpArgs a, int act, int out_act) {
  constexpr int R = 16 * MT;  // rows per warp tile
  constexpr int KT = PW / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* w_s = reinterpret_cast<uint2*>(smem);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int d0 = a.dims[0];
  const int xs = a.xs;
  const int L = a.n_layers;
  float* x_all = reinterpret_cast<float*>(w_s + a.wslots);
  float* x_s = x_all + warp * R * xs;

  const int n_tiles = (n + kWarps * R - 1) / (kWarps * R);
  int tile = blockIdx.x;
  load_x<R>(x, x_s, tile * kWarps * R + warp * R, n, d0, xs, lane);
  if (a.resident) {
    stage_resident(a, w_s, reinterpret_cast<unsigned short*>(x_all + kWarps * R * xs));
    __syncthreads();
  }

  for (; tile < n_tiles; tile += gridDim.x) {
    const int r0 = tile * kWarps * R + warp * R;

    // layer-0 A fragments: x rows in f32 -> bf16 pairs. Rows at or past n
    // hold stale data; an mma row depends on its own A row only, and those
    // rows are never stored.
    uint32_t af[MT][KT][4];
    cp_async_wait_all();
    __syncwarp();
    const int kt0 = a.kt[0];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float* lo = x_s + (m * 16 + g) * xs;
      const float* hi = lo + 8 * xs;
      if (xs != d0) {  // d0 even: a pair is in or out of the row together
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          if (kk >= kt0) break;
          const int c = kk * 16 + 2 * t;
          const float2 z = make_float2(0.f, 0.f);
          const float2 p0 = c < d0 ? *reinterpret_cast<const float2*>(lo + c) : z;
          const float2 p1 = c < d0 ? *reinterpret_cast<const float2*>(hi + c) : z;
          const float2 p2 = c + 8 < d0 ? *reinterpret_cast<const float2*>(lo + c + 8) : z;
          const float2 p3 = c + 8 < d0 ? *reinterpret_cast<const float2*>(hi + c + 8) : z;
          af[m][kk][0] = pack_bf16(p0.x, p0.y);
          af[m][kk][1] = pack_bf16(p1.x, p1.y);
          af[m][kk][2] = pack_bf16(p2.x, p2.y);
          af[m][kk][3] = pack_bf16(p3.x, p3.y);
        }
      } else {
        auto ld = [&](const float* row, int col) { return col < d0 ? row[col] : 0.f; };
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          if (kk >= kt0) break;
          const int c = kk * 16 + 2 * t;
          af[m][kk][0] = pack_bf16(ld(lo, c), ld(lo, c + 1));
          af[m][kk][1] = pack_bf16(ld(hi, c), ld(hi, c + 1));
          af[m][kk][2] = pack_bf16(ld(lo, c + 8), ld(lo, c + 9));
          af[m][kk][3] = pack_bf16(ld(hi, c + 8), ld(hi, c + 9));
        }
      }
    }
    __syncwarp();  // every lane has read x_s: the next tile may overwrite it
    if (tile + (int)gridDim.x < n_tiles) {
      load_x<R>(x, x_s, r0 + gridDim.x * kWarps * R, n, d0, xs, lane);
    }

    const Output o = {out, n, a.dims[L], r0};
    for (int l = 0; l < L; ++l) {
      if (!a.resident) {
        __syncthreads();  // every warp is done with the previous layer
        stage_weights(a, l, l + 1, w_s);
        __syncthreads();
      }
      const uint2* wl = w_s + (a.resident ? a.woff[l] : 0);
      const bool last = l == L - 1;
      layer<MT, KT>(a.nt[l], a.kt[l], wl, lane, af, last ? out_act : act, last, o);
    }
  }
  cp_async_wait_all();  // no copy outlives the block
}

int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
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

template <int PW, int MT>
int launch(const float* x, float* out, int n, MlpArgs& a, int act, int out_act,
           cudaStream_t stream) {
  constexpr int R = 16 * MT;
  auto kernel = fused_mlp_kernel<PW, MT>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const DeviceInfo info = device_info(dev);

  const int d0 = a.dims[0];
  a.xs = d0 % 4 ? d0 : d0 + (8 - d0 % 32 + 32) % 32;  // stride = 8 mod 32 floats
  const size_t x_bytes = (size_t)kWarps * R * a.xs * sizeof(float);
  int layer_slots = 0;
  for (int i = 0; i < a.n_layers; ++i) {
    const int s = a.woff[i + 1] - a.woff[i];
    layer_slots = s > layer_slots ? s : layer_slots;
  }
  // resident: fragments, x, then the raw copy of every layer
  const size_t raw_bytes = (size_t)a.roff[a.n_layers] * sizeof(__nv_bfloat16);
  a.resident = (size_t)a.woff[a.n_layers] * sizeof(uint2) + x_bytes + raw_bytes <=
               (size_t)info.smem_optin;
  a.wslots = a.resident ? a.woff[a.n_layers] : layer_slots;
  const size_t smem =
      (size_t)a.wslots * sizeof(uint2) + x_bytes + (a.resident ? raw_bytes : 0);
  if (smem > (size_t)info.smem_optin) return (int)cudaErrorInvalidValue;

  // per (device, instantiation): the dynamic shared memory allowed so far
  static int allowed[kMaxDevices];
  if ((int)smem > 48 * 1024 && (int)smem > allowed[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed[dev] = (int)smem;
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) per_sm = 1;
  const long long tiles = ((long long)n + kWarps * R - 1) / (kWarps * R);
  const long long cap = (long long)per_sm * info.sms;
  const int grid = (int)(tiles < cap ? tiles : cap);
  kernel<<<grid, kThreads, smem, stream>>>(x, out, n, a, act, out_act);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// w_ptrs and dims are HOST arrays of n_layers and n_layers + 1 entries. x
// must be 16-byte aligned.
extern "C" int nerfnav_fused_mlp_forward(const void* x, const void* w_ptrs,
                                         void* out, int n, int n_layers,
                                         const void* dims, int act,
                                         int out_act, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16) return (int)cudaErrorMisalignedAddress;
  const void* const* wp = static_cast<const void* const*>(w_ptrs);
  const int* d = static_cast<const int*>(dims);
  MlpArgs a = {};
  a.n_layers = n_layers;
  int pmax = 0;
  for (int i = 0; i <= n_layers; ++i) {
    if (d[i] < 1 || d[i] > kMaxWidth) return (int)cudaErrorInvalidValue;
    a.dims[i] = d[i];
    const int p = (d[i] + 15) / 16 * 16;
    pmax = p > pmax ? p : pmax;
  }
  for (int i = 0; i < n_layers; ++i) {
    a.w[i] = static_cast<const __nv_bfloat16*>(wp[i]);
    a.kt[i] = pow2_at_least((d[i] + 15) / 16);
    a.nt[i] = pow2_at_least((d[i + 1] + 7) / 8);
    a.woff[i + 1] = a.woff[i] + a.kt[i] * a.nt[i] * 32;
    a.roff[i + 1] = a.roff[i] + (d[i] * d[i + 1] + 7) / 8 * 8;
  }
  if (n <= 0) return (int)cudaSuccess;
  const float* xf = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pmax <= 16) return launch<16, 2>(xf, o, n, a, act, out_act, s);
  if (pmax <= 32) return launch<32, 2>(xf, o, n, a, act, out_act, s);
  if (pmax <= 64) return launch<64, 2>(xf, o, n, a, act, out_act, s);
  if (pmax <= 128) return launch<128, 1>(xf, o, n, a, act, out_act, s);
  return launch<256, 1>(xf, o, n, a, act, out_act, s);
}
