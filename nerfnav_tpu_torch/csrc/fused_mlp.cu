// Fully fused bias-free MLP forward and backward for Hopper (sm_90a).
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
//
// Backward (nerfnav_fused_mlp_backward): the reference differentiates the
// kernel by a custom_vjp whose backward (_fused_mlp_bwd, fused_mlp.py:122-150)
// XLA runs outside the Pallas kernel; the port's plain twin is
// ops/fused_mlp.py::_mlp_backward. This pair computes its function, rounding
// point for rounding point: x and W in bf16, each pre-activation an f32 sum,
// each hidden activation rounded to bf16; gp = out_act'(pre) * g in f32; each
// dh rounded to bf16 and times act'(pre) (relu from the f32 pre-activation,
// half the gradient where it is exactly 0); each dW the f32 sum over all rows,
// rounded to bf16 once. Only the order of the f32 sums differs.
// What bounds it: a row reads x and g and writes dx once (260 bytes for the
// color net, 320 for sigma) against ~3x the forward's FLOPs, so the byte
// bound leads (the plain version's ops move ~44 GB a dense train step).
// Design (widths up to 64, 1-8 layers, hidden relu or none):
// - fused_mlp_backward_rows: persistent blocks of 4 warps over 128-row tiles
//   as the forward's, each warp 32 rows. W (B fragments) and W^T (the
//   fragments of dh = gp W^T) are staged once per block. x and g reach
//   per-warp shared slots by cp.async, the next tile's copy in flight under
//   the current one; rows past N are zeroed there, so they add nothing.
// - Per tile the layer chain stays in registers. x's A fragments are kept;
//   the last layer's step recomputes the whole forward, and each hidden
//   layer's step recomputes the layers below it from x (for the color net,
//   4 layer products instead of 3): no per-layer activation is held.
// - gp of the last layer is f32 (g is not rounded): it enters the tensor
//   cores as three bf16 terms whose sum is exact. Every other gp is dh
//   (bf16) times 0, 0.5 or 1, so exactly bf16.
// - dW_i = h_i^T gp_i takes the rows as K. The A fragments of h^T and the B
//   fragments of gp are the registers the chain already holds, transposed
//   8x8 block by block with movmatrix: no shared-memory round trip. Each warp
//   adds its tile, summed on the tensor cores, into its own f32 partial of
//   every dW with one f32 add (a running sum fed through the mma's C would
//   be rounded by its accumulation at every tile), in fragment order: one
//   16-byte load and store per lane per tile; no atomics.
// - A warp's partials (26 KB for the color net) decide the occupancy: with
//   one block a SM the chain's latencies stand bare (color 1.95 ms at a
//   dense step's N against 1.69 with every partial in L2 and 2 blocks a
//   SM). So a layer's partials stay in shared memory only while a block
//   still fits twice on a SM, the rest go to the global scratch (L2).
// - At the end a block sums its warps' partials in warp order into the
//   scratch; fused_mlp_dw_reduce sums the blocks' in block order and rounds
//   to bf16. Sums in a fixed order: the same bits every run.
// - dx goes from the accumulators to device memory, as the forward's output.

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

// Row stride in shared memory, in floats, of rows of d floats: d when d % 4
// (copied flat), else d padded to 8 mod 32, so float2 fragment loads are
// conflict-free.
int row_stride(int d) { return d % 4 ? d : d + (8 - d % 32 + 32) % 32; }

struct DeviceInfo {
  int sms = 0;
  int smem_optin = 0;
  int smem_sm = 0;         // shared memory of a SM
  int smem_reserved = 0;   // shared memory the system keeps per block
};

DeviceInfo device_info(int dev) {
  static DeviceInfo cache[kMaxDevices];
  DeviceInfo& d = cache[dev];
  if (d.sms == 0) {
    cudaDeviceGetAttribute(&d.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&d.smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    cudaDeviceGetAttribute(&d.smem_reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
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
  a.xs = row_stride(d0);
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


// ---- The backward --------------------------------------------------------
//
// fused_mlp_backward_rows: for each row tile, the reference's recompute
// backward (_mlp_backward) in registers; fused_mlp_dw_reduce: the dW sums.
// See the header of this file for what bounds it and how it is laid out.

constexpr int kBwdMT = 2;                    // m16 tiles of rows a warp owns
constexpr int kBwdRows = 16 * kBwdMT;        // rows of a warp tile
constexpr int kBwdMaxWidth = 64;
constexpr int kBwdKT = kBwdMaxWidth / 16;    // k16 tiles of the widest input
constexpr int kBwdNT = kBwdMaxWidth / 8;     // n8 tiles of the widest output
constexpr int kMaskWords = kBwdMT * kBwdNT * 4 / 32;
constexpr int kReduceWarps = 8;
constexpr int kBwdBlocksPerSm = 2;  // the rows kernel's registers (255 a thread) allow 2

struct BwdArgs {
  const __nv_bfloat16* w[kMaxLayers];  // (dims[i], dims[i+1]) row major
  int dims[kMaxLayers + 1];
  int kt[kMaxLayers];    // k16 tiles over dims[i], a power of 2: layer i's A, dW_i's m16 tiles
  int nt[kMaxLayers];    // n8 tiles over dims[i+1], a power of 2: layer i's output, dW_i's
  int ktt[kMaxLayers];   // k16 tiles of W_i^T (over dims[i+1]): (nt[i] + 1) / 2
  int ntt[kMaxLayers];   // n8 tiles of W_i^T (over dims[i]), a power of 2: dh_i's
  int woff[kMaxLayers + 1];  // fragment slot where W_i starts; 4 woff[i]: float where
                             // dW_i starts in a partial
  int toff[kMaxLayers + 1];  // fragment slot where W_i^T starts (toff[0] = woff[L])
  int doff[kMaxLayers + 1];  // float where dW_i starts in the output
  int n_layers;
  int xs, gs;            // row strides of x and g in shared memory, in floats
  int pin[kMaxLayers];   // 1: the warps' dW_i partials in shared memory, 0: in the scratch
  int poff[kMaxLayers];  // float where dW_i starts in a warp's shared or scratch partial
  int ps, pg;            // floats of a warp's partial in shared memory, in the scratch
};

using Frags = uint32_t[kBwdMT][kBwdKT][4];   // A fragments of a warp tile, up to width 64
using Accs = float[kBwdMT][kBwdNT][4];       // accumulators of a warp tile, up to width 64

// Relu's gradient pattern of a pre-activation tile: pos where it is > 0,
// zero where it is == 0 (the reference passes half the gradient there).
struct Mask {
  uint32_t pos[kMaskWords];
  uint32_t zero[kMaskWords];
};

__device__ __forceinline__ int mask_bit(int m, int j, int e) { return (m * kBwdNT + j) * 4 + e; }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The s-th of three bf16 values whose sum is v exactly: v rounded, then the
// rest rounded, then what is left (at most 8 significant bits, so packing it
// with round-to-nearest keeps it exact).
__device__ __forceinline__ float split3(float v, int s) {
  const float hi = round_bf16(v);
  if (s == 0) return hi;
  const float rest = v - hi;
  const float mid = round_bf16(rest);
  return s == 1 ? mid : rest - mid;
}

// An 8x8 b16 matrix held one row pair a lane (row lane / 4, columns
// 2 (lane % 4) and + 1), transposed across the warp.
__device__ __forceinline__ uint32_t transpose8x8(uint32_t v) {
  uint32_t r;
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(r) : "r"(v));
  return r;
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// d act(v) / dv times g, as _ACT_GRADS in ops/fused_mlp.py takes it. relu
// and none are inlined; the others share one out-of-line copy.
__device__ __noinline__ float act_grad_call(float v, float g, int act) {
  switch (act) {
    case 2: return g * expf(v);                                      // exp
    case 3: {                                                        // sigmoid
      const float s = 1.f / (1.f + expf(-v));
      return g * s * (1.f - s);
    }
    case 4: return g * cosf(v);                                      // sine
    case 5: return 0.5f * g * (1.f + v / sqrtf(v * v + 4.f));        // squareplus
    default: return g * (1.f / (1.f + expf(-v)));                   // softplus
  }
}

__device__ __forceinline__ float act_grad(float v, float g, int act) {
  if (act == 1) return g;
  if (act == 0) return v > 0.f ? g : (v == 0.f ? 0.5f * g : 0.f);
  return act_grad_call(v, g, act);
}

// Calls op.run<KTL, NTL>() with the powers of two KTL == kt and NTL == nt,
// so each layer runs a body unrolled for exactly its tile counts.
template <class Op, int KTL = 1, int NTL = 1>
__device__ __forceinline__ void dispatch(Op& op, int kt, int nt) {
  if constexpr (KTL < kBwdKT) {
    if (kt > KTL) return dispatch<Op, 2 * KTL, NTL>(op, kt, nt);
  }
  if constexpr (NTL < kBwdNT) {
    if (nt > NTL) return dispatch<Op, KTL, 2 * NTL>(op, kt, nt);
  }
  op.template run<KTL, NTL>();
}

// acc[m][j] += sum over k16 tiles kk of a[m][kk] times B tile (kk, j), the
// B fragments in slots w (rows of NTL tiles).
template <int KTL, int NTL, int N>
__device__ __forceinline__ void mma_tiles(const uint2* w, int lane, const Frags& a,
                                          float (&acc)[kBwdMT][N][4]) {
#pragma unroll
  for (int kk = 0; kk < KTL; ++kk) {
#pragma unroll
    for (int j = 0; j < NTL; ++j) {
      const uint2 b = w[(kk * NTL + j) * 32 + lane];
#pragma unroll
      for (int m = 0; m < kBwdMT; ++m) mma_bf16(acc[m][j], a[m][kk], b);
    }
  }
}

template <int NTL>
__device__ __forceinline__ void zero_tiles(float (&acc)[kBwdMT][NTL][4]) {
#pragma unroll
  for (int m = 0; m < kBwdMT; ++m)
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
}

// Accumulators of n8 tiles 2kk and 2kk + 1 -> A fragment of k16 tile kk,
// rounded to bf16; an odd last tile's pair is zero.
template <int NTL, int N>
__device__ __forceinline__ void pack_frags(const float (&acc)[kBwdMT][N][4], Frags& af) {
#pragma unroll
  for (int kk = 0; kk < (NTL + 1) / 2; ++kk) {
#pragma unroll
    for (int m = 0; m < kBwdMT; ++m) {
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

// A fragments of h^T for its m16 tile f (input features 16f..16f+15), one
// per k16 tile of rows: the four 8x8 blocks of h's fragment, each
// transposed, the off-diagonal two swapped.
__device__ __forceinline__ void transposed_frags(const Frags& h, int f,
                                                 uint32_t (&at)[kBwdMT][4]) {
#pragma unroll
  for (int r = 0; r < kBwdMT; ++r) {
    at[r][0] = transpose8x8(h[r][f][0]);
    at[r][1] = transpose8x8(h[r][f][2]);
    at[r][2] = transpose8x8(h[r][f][1]);
    at[r][3] = transpose8x8(h[r][f][3]);
  }
}

// One hidden layer of the recompute: h <- bf16(act(h @ W)), as the forward
// computes it; with want_mask, the relu pattern of the pre-activation too.
struct FwdLayer {
  const uint2* w;
  int lane, act;
  bool want_mask;
  Frags& h;
  Mask& mk;

  template <int KTL, int NTL>
  __device__ __forceinline__ void run() {
    float acc[kBwdMT][NTL][4];
    zero_tiles<NTL>(acc);
    mma_tiles<KTL, NTL>(w, lane, h, acc);
    if (act == 0) {
      if (want_mask) {
#pragma unroll
        for (int i = 0; i < kMaskWords; ++i) mk.pos[i] = mk.zero[i] = 0u;
#pragma unroll
        for (int m = 0; m < kBwdMT; ++m)
#pragma unroll
          for (int j = 0; j < NTL; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int b = mask_bit(m, j, e);
              mk.pos[b >> 5] |= uint32_t(acc[m][j][e] > 0.f) << (b & 31);
              mk.zero[b >> 5] |= uint32_t(acc[m][j][e] == 0.f) << (b & 31);
            }
      }
#pragma unroll
      for (int m = 0; m < kBwdMT; ++m)
#pragma unroll
        for (int j = 0; j < NTL; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][j][e] = fmaxf(acc[m][j][e], 0.f);
    }
    pack_frags<NTL>(acc, h);
  }
};

// The last layer: gp = out_act'(h @ W) * g in f32, g read from the warp's
// shared slot (rows past n hold zeros there).
struct TopLayer {
  const uint2* w;
  const float* g_s;
  int gs, dout, lane, out_act;
  const Frags& h;
  Accs& gp;

  template <int KTL, int NTL>
  __device__ __forceinline__ void run() {
    float acc[kBwdMT][NTL][4];
    zero_tiles<NTL>(acc);
    if (out_act != 1) mma_tiles<KTL, NTL>(w, lane, h, acc);  // none needs no pre-activation
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int m = 0; m < kBwdMT; ++m)
#pragma unroll
      for (int j = 0; j < NTL; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = m * 16 + g + 8 * (e >> 1);
          const int col = j * 8 + 2 * t + (e & 1);
          const float gv = col < dout ? g_s[row * gs + col] : 0.f;
          gp[m][j][e] = act_grad(acc[m][j][e], gv, out_act);
        }
  }
};

// gpa <- the A fragments of the s-th of gp's three exact bf16 terms.
struct SplitPack {
  const Accs& gp;
  int s;
  Frags& gpa;

  template <int KTL, int NTL>
  __device__ __forceinline__ void run() {
    float part[kBwdMT][NTL][4];
#pragma unroll
    for (int m = 0; m < kBwdMT; ++m)
#pragma unroll
      for (int j = 0; j < NTL; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[m][j][e] = split3(gp[m][j][e], s);
    pack_frags<NTL>(part, gpa);
  }
};

// dW += h^T gp over the tile's rows, gp bf16 (its A fragments): the B
// fragments are those registers transposed. The partial's tiles (f, j), f
// over input features (16 each), j over outputs (8 each), are read,
// accumulated and written back by this warp alone.
struct DwBf16 {
  float* part;
  int lane;
  const Frags& h;
  const Frags& gpa;

  template <int KTL, int NTL>
  __device__ __forceinline__ void run() {
    uint32_t b[kBwdMT][NTL][2];
#pragma unroll
    for (int r = 0; r < kBwdMT; ++r)
#pragma unroll
      for (int j = 0; j < NTL; ++j) {
        b[r][j][0] = transpose8x8(gpa[r][j >> 1][(j & 1) * 2]);
        b[r][j][1] = transpose8x8(gpa[r][j >> 1][(j & 1) * 2 + 1]);
      }
#pragma unroll
    for (int f = 0; f < KTL; ++f) {
      uint32_t at[kBwdMT][4];
      transposed_frags(h, f, at);
#pragma unroll
      for (int j = 0; j < NTL; ++j) {
        // the tile's 32 rows on the tensor cores, then one f32 add into the
        // partial: a running sum fed back through the mma's C would be
        // rounded by the tensor core's accumulation at every tile
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int r = 0; r < kBwdMT; ++r) mma_bf16(c, at[r], make_uint2(b[r][j][0], b[r][j][1]));
        float4* p = reinterpret_cast<float4*>(part) + (f * NTL + j) * 32 + lane;
        const float4 v = *p;
        *p = make_float4(v.x + c[0], v.y + c[1], v.z + c[2], v.w + c[3]);
      }
    }
  }
};

// Where dh goes: rounded to bf16, then either dx (layer 0) or, times the
// hidden activation's gradient, the A fragments of the layer below's gp.
struct DhOut {
  Frags& gpa;
  const Mask& mk;
  int act;
  float* dx;  // non-null for layer 0
  int n, d0, r0;
};

template <int NTL>
__device__ __forceinline__ void dh_epilogue(Accs& acc, const DhOut& o, int lane) {
#pragma unroll
  for (int m = 0; m < kBwdMT; ++m)
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = round_bf16(acc[m][j][e]);
  if (o.dx != nullptr) {
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int j = 0; j < NTL; ++j) {
      const int col = j * 8 + 2 * t;
#pragma unroll
      for (int m = 0; m < kBwdMT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = o.r0 + m * 16 + g + 8 * h;
          if (row < o.n && col < o.d0) {
            float* p = o.dx + (size_t)row * o.d0 + col;
            if ((o.d0 & 1) == 0) {  // col + 1 < d0 as well
              *reinterpret_cast<float2*>(p) = make_float2(acc[m][j][2 * h], acc[m][j][2 * h + 1]);
            } else {
              p[0] = acc[m][j][2 * h];
              if (col + 1 < o.d0) p[1] = acc[m][j][2 * h + 1];
            }
          }
        }
    }
    return;
  }
  if (o.act == 0) {
#pragma unroll
    for (int m = 0; m < kBwdMT; ++m)
#pragma unroll
      for (int j = 0; j < NTL; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int b = mask_bit(m, j, e);
          const uint32_t bit = 1u << (b & 31);
          const float d = acc[m][j][e];
          acc[m][j][e] = (o.mk.pos[b >> 5] & bit) ? d
                         : (o.mk.zero[b >> 5] & bit) ? 0.5f * d : 0.f;
        }
  }
  pack_frags<NTL>(acc, o.gpa);
}

// acc += gp @ W^T for gp bf16 (its A fragments).
struct DhMma {
  const uint2* wt;
  int lane;
  const Frags& gpa;
  Accs& acc;

  template <int KTL, int NTL>
  __device__ __forceinline__ void run() {
    mma_tiles<KTL, NTL>(wt, lane, gpa, acc);
  }
};

struct DhEpilogue {
  Accs& acc;
  const DhOut& o;
  int lane;

  template <int KTL, int NTL>
  __device__ __forceinline__ void run() {
    dh_epilogue<NTL>(acc, o, lane);
  }
};

// h <- the input of layer `upto`, recomputed from x's fragments; mk <- the
// relu pattern of layer upto - 1's pre-activation.
__device__ __forceinline__ void forward_to(const BwdArgs& a, const uint2* w_s, int upto,
                                           const Frags& af0, Frags& h, Mask& mk, int act,
                                           int lane) {
#pragma unroll
  for (int m = 0; m < kBwdMT; ++m)
#pragma unroll
    for (int kk = 0; kk < kBwdKT; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) h[m][kk][i] = af0[m][kk][i];
  for (int l = 0; l < upto; ++l) {
    FwdLayer op{w_s + a.woff[l], lane, act, l == upto - 1, h, mk};
    dispatch(op, a.kt[l], a.nt[l]);
  }
}

// Stage every layer's W (B fragments in the order stage_weights describes)
// and, from slot toff[0], every W^T in the same order: slot (kk * ntt + j)
// * 32 + lane of layer i's W^T holds W_i[8j + g][16kk + 2t + {0, 1, 8, 9}].
// Gathered from L2, kStageBatch slots a thread a trip; the caller puts a
// barrier after.
__device__ void stage_backward_weights(const BwdArgs& a, uint2* w_s) {
  const int L = a.n_layers;
  const int total = a.toff[L];
  for (int s0 = threadIdx.x; s0 < total; s0 += kStageBatch * kThreads) {
    uint2 v[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int s = s0 + u * kThreads;
      v[u] = make_uint2(0, 0);
      if (s < total) {
        const bool tr = s >= a.toff[0];
        int l = 0;
        while (l + 1 < L && s >= (tr ? a.toff[l + 1] : a.woff[l + 1])) ++l;
        const int r = s - (tr ? a.toff[l] : a.woff[l]);
        const int ncols = tr ? a.ntt[l] : a.nt[l];
        const int kk = (r >> 5) / ncols;
        const int col = ((r >> 5) - kk * ncols) * 8 + ((r & 31) >> 2);
        const int k = kk * 16 + (r & 3) * 2;
        const int din = a.dims[l];
        const int dout = a.dims[l + 1];
        const unsigned short* w = reinterpret_cast<const unsigned short*>(a.w[l]);
        auto at = [&](int kr) -> uint32_t {
          const int kq = k + kr;
          if (tr) return kq < dout && col < din ? __ldg(w + col * dout + kq) : 0u;
          return kq < din && col < dout ? __ldg(w + kq * dout + col) : 0u;
        };
        v[u] = make_uint2(at(0) | at(1) << 16, at(8) | at(9) << 16);
      }
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int s = s0 + u * kThreads;
      if (s < total) w_s[s] = v[u];
    }
  }
}

// Copy rows [r0, r0 + R) of an (n, d) f32 array into a warp's slot, laid
// as load_x lays x, and zero the rows at or past n, so that they add
// nothing to dW. Commits one cp.async group.
template <int R>
__device__ __forceinline__ void load_rows(const float* __restrict__ src, float* slot, int r0,
                                          int n, int d, int stride, int lane) {
  load_x<R>(src, slot, r0, n, d, stride, lane);
  const int valid = max(0, min(R, n - r0));
  for (int e = valid * stride + lane; e < R * stride; e += 32) slot[e] = 0.f;
}

// Layer-0 A fragments of a warp tile from its x slot (as the forward reads
// them).
__device__ __forceinline__ void x_frags(const float* x_s, int xs, int d0, int kt0, int lane,
                                        Frags& af) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int m = 0; m < kBwdMT; ++m) {
    const float* lo = x_s + (m * 16 + g) * xs;
    const float* hi = lo + 8 * xs;
    if (xs != d0) {  // d0 even: a pair is in or out of the row together
#pragma unroll
      for (int kk = 0; kk < kBwdKT; ++kk) {
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
      for (int kk = 0; kk < kBwdKT; ++kk) {
        if (kk >= kt0) break;
        const int c = kk * 16 + 2 * t;
        af[m][kk][0] = pack_bf16(ld(lo, c), ld(lo, c + 1));
        af[m][kk][1] = pack_bf16(ld(hi, c), ld(hi, c + 1));
        af[m][kk][2] = pack_bf16(ld(lo, c + 8), ld(lo, c + 9));
        af[m][kk][3] = pack_bf16(ld(hi, c + 8), ld(hi, c + 9));
      }
    }
  }
}

// Shared memory: W and W^T fragments, then each warp's x slot, each warp's
// g slot and each warp's dW partials of the layers pin marks. scratch: the
// blocks' partials (gridDim.x x 4 woff[L] floats), then each warp's of the
// other layers.
__global__ void __launch_bounds__(kThreads)
fused_mlp_backward_rows(const float* __restrict__ x, const float* __restrict__ g,
                        float* __restrict__ dx, float* __restrict__ scratch, int n,
                        BwdArgs a, int act, int out_act) {
  constexpr int R = kBwdRows;
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* w_s = reinterpret_cast<uint2*>(smem);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int L = a.n_layers;
  const int d0 = a.dims[0];
  const int dl = a.dims[L];
  const int S = a.woff[L] * 4;  // floats of a dW partial
  float* x_all = reinterpret_cast<float*>(w_s + a.toff[L]);
  float* g_all = x_all + kWarps * R * a.xs;
  float* smem_parts = g_all + kWarps * R * a.gs;
  float* scratch_parts = scratch + (size_t)gridDim.x * S + (size_t)blockIdx.x * kWarps * a.pg;
  float* x_s = x_all + warp * R * a.xs;
  float* g_s = g_all + warp * R * a.gs;
  auto partial = [&](int l, int w) {  // warp w's dW_l partial
    return a.pin[l] ? smem_parts + w * a.ps + a.poff[l]
                    : scratch_parts + (size_t)w * a.pg + a.poff[l];
  };
  for (int l = 0; l < L; ++l) {
    float* p = partial(l, warp);
    for (int e = lane * 4; e < (a.woff[l + 1] - a.woff[l]) * 4; e += 128) {
      *reinterpret_cast<float4*>(p + e) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  const int n_tiles = (n + kWarps * R - 1) / (kWarps * R);
  int tile = blockIdx.x;
  load_rows<R>(x, x_s, tile * kWarps * R + warp * R, n, d0, a.xs, lane);
  load_rows<R>(g, g_s, tile * kWarps * R + warp * R, n, dl, a.gs, lane);
  stage_backward_weights(a, w_s);
  cp_async_wait_all();
  __syncthreads();

  for (; tile < n_tiles; tile += gridDim.x) {
    const int r0 = tile * kWarps * R + warp * R;
    const bool more = tile + (int)gridDim.x < n_tiles;
    const int r_next = more ? r0 + gridDim.x * kWarps * R : 0;

    // x's fragments stay in registers for every recompute; the slot then
    // takes the next tile's rows (cp.async groups: x, g, x, g, ...)
    Frags af0;
    cp_async_wait_one();
    __syncwarp();
    x_frags(x_s, a.xs, d0, a.kt[0], lane, af0);
    __syncwarp();
    if (more) load_rows<R>(x, x_s, r_next, n, d0, a.xs, lane);
    else cp_async_commit();

    Frags h, gpa;
    Mask mk;
    // the last layer: the whole forward, then gp in f32 from g
    forward_to(a, w_s, L - 1, af0, h, mk, act, lane);
    {
      Accs gp;
      cp_async_wait_one();
      __syncwarp();
      TopLayer top{w_s + a.woff[L - 1], g_s, a.gs, dl, lane, out_act, h, gp};
      dispatch(top, a.kt[L - 1], a.nt[L - 1]);
      __syncwarp();
      if (more) load_rows<R>(g, g_s, r_next, n, dl, a.gs, lane);
      else cp_async_commit();
      // gp's three bf16 terms through the bf16 bodies, dW's first, then dh's
#pragma unroll 1
      for (int s = 0; s < 3; ++s) {
        SplitPack sp{gp, s, gpa};
        dispatch(sp, 1, a.nt[L - 1]);
        DwBf16 dw{partial(L - 1, warp), lane, h, gpa};
        dispatch(dw, a.kt[L - 1], a.nt[L - 1]);
      }
      Accs acc;
      zero_tiles<kBwdNT>(acc);
#pragma unroll 1
      for (int s = 0; s < 3; ++s) {
        SplitPack sp{gp, s, gpa};
        dispatch(sp, 1, a.nt[L - 1]);
        DhMma dh{w_s + a.toff[L - 1], lane, gpa, acc};
        dispatch(dh, a.ktt[L - 1], a.ntt[L - 1]);
      }
      const DhOut o{gpa, mk, act, L == 1 ? dx : nullptr, n, d0, r0};
      DhEpilogue ep{acc, o, lane};
      dispatch(ep, 1, a.ntt[L - 1]);
    }
    // the hidden layers, top down, each input recomputed from x
    for (int i = L - 2; i >= 0; --i) {
      forward_to(a, w_s, i, af0, h, mk, act, lane);
      DwBf16 dw{partial(i, warp), lane, h, gpa};
      dispatch(dw, a.kt[i], a.nt[i]);
      Accs acc;
      zero_tiles<kBwdNT>(acc);
      DhMma dh{w_s + a.toff[i], lane, gpa, acc};
      dispatch(dh, a.ktt[i], a.ntt[i]);
      const DhOut o{gpa, mk, act, i == 0 ? dx : nullptr, n, d0, r0};
      DhEpilogue ep{acc, o, lane};
      dispatch(ep, 1, a.ntt[i]);
    }
  }
  cp_async_wait_all();  // no copy outlives the block

  // the block's partial: its warps' partials summed in warp order
  __syncthreads();
  for (int l = 0; l < L; ++l) {
    float* out = scratch + (size_t)blockIdx.x * S + a.woff[l] * 4;
    for (int e = threadIdx.x * 4; e < (a.woff[l + 1] - a.woff[l]) * 4; e += kThreads * 4) {
      float4 s = *reinterpret_cast<const float4*>(partial(l, 0) + e);
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        const float4 v = *reinterpret_cast<const float4*>(partial(l, w) + e);
        s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
      }
      *reinterpret_cast<float4*>(out + e) = s;
    }
  }
}

// dW_i = the blocks' partials summed in block order (kReduceWarps ranges of
// blocks, then the ranges in order), rounded to bf16 once, written as f32
// row major at doff[i]. One block a 32 partial floats.
__global__ void __launch_bounds__(kReduceWarps * 32)
fused_mlp_dw_reduce(const float* __restrict__ partials, int blocks, BwdArgs a,
                    float* __restrict__ dw) {
  __shared__ float sums[kReduceWarps][32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int S = a.woff[a.n_layers] * 4;
  const int e = blockIdx.x * 32 + lane;
  const int per = (blocks + kReduceWarps - 1) / kReduceWarps;
  const int p1 = min(blocks, (warp + 1) * per);
  float s = 0.f;
  if (e < S) {
    for (int p = warp * per; p < p1; ++p) s += partials[(size_t)p * S + e];
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || e >= S) return;
  for (int w = 1; w < kReduceWarps; ++w) s += sums[w][lane];
  int l = 0;
  while (l + 1 < a.n_layers && e >= a.woff[l + 1] * 4) ++l;
  const int q = e - a.woff[l] * 4;   // (tile, lane, element) in the partial's order
  const int tile = q >> 7;
  const int ln = (q >> 2) & 31;
  const int c = q & 3;
  const int f = tile / a.nt[l];
  const int j = tile - f * a.nt[l];
  const int row = f * 16 + (ln >> 2) + 8 * (c >> 1);
  const int col = j * 8 + 2 * (ln & 3) + (c & 1);
  if (row < a.dims[l] && col < a.dims[l + 1]) {
    dw[a.doff[l] + row * a.dims[l + 1] + col] = round_bf16(s);
  }
}

// What a backward call launches with: its arguments (but the weights), the
// grid, the dynamic shared memory and the scratch floats it needs.
struct BwdPlan {
  BwdArgs a;
  int grid;
  size_t smem;
  long long scratch;
};

int backward_plan(int n, int n_layers, const int* d, BwdPlan& p) {
  if (n_layers < 1 || n_layers > kMaxLayers) return (int)cudaErrorInvalidValue;
  BwdArgs& a = p.a;
  a = BwdArgs{};
  a.n_layers = n_layers;
  for (int i = 0; i <= n_layers; ++i) {
    if (d[i] < 1 || d[i] > kBwdMaxWidth) return (int)cudaErrorInvalidValue;
    a.dims[i] = d[i];
  }
  for (int i = 0; i < n_layers; ++i) {
    a.kt[i] = pow2_at_least((d[i] + 15) / 16);
    a.nt[i] = pow2_at_least((d[i + 1] + 7) / 8);
    a.ktt[i] = (a.nt[i] + 1) / 2;
    a.ntt[i] = pow2_at_least((d[i] + 7) / 8);
    a.woff[i + 1] = a.woff[i] + a.kt[i] * a.nt[i] * 32;
    a.doff[i + 1] = a.doff[i] + d[i] * d[i + 1];
  }
  a.toff[0] = a.woff[n_layers];
  for (int i = 0; i < n_layers; ++i) a.toff[i + 1] = a.toff[i] + a.ktt[i] * a.ntt[i] * 32;
  a.xs = row_stride(d[0]);
  a.gs = row_stride(d[n_layers]);

  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const DeviceInfo info = device_info(dev);
  const long long S = (long long)a.woff[n_layers] * 4;
  // the warps' dW partials go to shared memory, the last layer's first (a
  // tile adds into it three times) and then downwards, while a block still
  // fits kBwdBlocksPerSm times on a SM (the whole block alone where the
  // rest does not); the others to the scratch
  size_t used = (size_t)a.toff[n_layers] * sizeof(uint2) +
                (size_t)kWarps * kBwdRows * (a.xs + a.gs) * sizeof(float);
  size_t budget = (size_t)info.smem_sm / kBwdBlocksPerSm - info.smem_reserved;
  if (used > budget || budget > (size_t)info.smem_optin) budget = info.smem_optin;
  for (int l = n_layers - 1; l >= 0; --l) {
    const int size = (a.woff[l + 1] - a.woff[l]) * 4;
    const size_t bytes = (size_t)kWarps * size * sizeof(float);
    a.pin[l] = used + bytes <= budget;
    if (a.pin[l]) {
      a.poff[l] = a.ps;
      a.ps += size;
      used += bytes;
    } else {
      a.poff[l] = a.pg;
      a.pg += size;
    }
  }
  p.smem = used;
  if (p.smem > (size_t)info.smem_optin) return (int)cudaErrorInvalidValue;

  // per device: the dynamic shared memory allowed so far, and the blocks a
  // SM holds at the last few sizes asked
  static int allowed[kMaxDevices];
  static int occ_smem[kMaxDevices][8];
  static int occ_blocks[kMaxDevices][8];
  auto kernel = fused_mlp_backward_rows;
  if ((int)p.smem > 48 * 1024 && (int)p.smem > allowed[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)p.smem);
    if (e != cudaSuccess) return (int)e;
    allowed[dev] = (int)p.smem;
  }
  int per_sm = 0;
  int slot = 0;
  for (; slot < 8 && occ_blocks[dev][slot] > 0; ++slot) {
    if (occ_smem[dev][slot] == (int)p.smem) {
      per_sm = occ_blocks[dev][slot];
      break;
    }
  }
  if (per_sm == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, p.smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) per_sm = 1;
    if (slot < 8) {
      occ_smem[dev][slot] = (int)p.smem;
      occ_blocks[dev][slot] = per_sm;
    }
  }
  const long long tiles = ((long long)n + kWarps * kBwdRows - 1) / (kWarps * kBwdRows);
  const long long cap = (long long)per_sm * info.sms;
  p.grid = (int)(tiles < cap ? tiles : cap);
  p.scratch = (long long)p.grid * (S + (long long)kWarps * a.pg);
  return (int)cudaSuccess;
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

// The scratch floats a backward call needs (into *out, a HOST int64; 0 for n
// <= 0). Returns a cudaError_t (0 = ok). dims: a HOST array of n_layers + 1
// widths.
extern "C" int nerfnav_fused_mlp_backward_scratch(int n, int n_layers, const void* dims,
                                                  void* out) {
  long long* o = static_cast<long long*>(out);
  *o = 0;
  if (n <= 0) return (int)cudaSuccess;
  BwdPlan p;
  const int e = backward_plan(n, n_layers, static_cast<const int*>(dims), p);
  if (e != (int)cudaSuccess) return e;
  *o = p.scratch;
  return (int)cudaSuccess;
}

// dx (n, dims[0]) and every dW_i, rounded to bf16 and written as f32 row major
// one after another into dw, of the net whose forward is
// nerfnav_fused_mlp_forward's, for the output gradient g (n, dims[L]) f32.
// Two launches on `stream`: the rows kernel, then the dW reduce; returns
// cudaGetLastError() after them (0 = ok). w_ptrs and dims are HOST arrays of
// n_layers and n_layers + 1 entries; every width 1-64; act relu (0) or none
// (1); x, g and scratch 16-byte aligned, scratch at least
// nerfnav_fused_mlp_backward_scratch floats.
extern "C" int nerfnav_fused_mlp_backward(const void* x, const void* g, const void* w_ptrs,
                                          void* dx, void* dw, void* scratch,
                                          long long scratch_floats, int n, int n_layers,
                                          const void* dims, int act, int out_act,
                                          void* stream) {
  if (act != 0 && act != 1) return (int)cudaErrorInvalidValue;
  if (out_act < 0 || out_act > 6) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(g) % 16 ||
      reinterpret_cast<uintptr_t>(scratch) % 16) {
    return (int)cudaErrorMisalignedAddress;
  }
  if (n <= 0) return (int)cudaSuccess;
  BwdPlan p;
  const int e = backward_plan(n, n_layers, static_cast<const int*>(dims), p);
  if (e != (int)cudaSuccess) return e;
  if (scratch_floats < p.scratch) return (int)cudaErrorInvalidValue;
  const void* const* wp = static_cast<const void* const*>(w_ptrs);
  for (int i = 0; i < n_layers; ++i) p.a.w[i] = static_cast<const __nv_bfloat16*>(wp[i]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  fused_mlp_backward_rows<<<p.grid, kThreads, p.smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), static_cast<float*>(dx), sc,
      n, p.a, act, out_act);
  const cudaError_t le = cudaGetLastError();
  if (le != cudaSuccess) return (int)le;
  const int S = p.a.woff[n_layers] * 4;
  fused_mlp_dw_reduce<<<(S + 31) / 32, kReduceWarps * 32, 0, s>>>(sc, p.grid, p.a,
                                                                   static_cast<float*>(dw));
  return (int)cudaGetLastError();
}
