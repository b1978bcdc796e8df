// Fully fused bias-free MLP forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nerfnav_tpu/ops/fused_mlp.py::_fused_kernel
// (launched by fused_mlp_forward, pallas_call at fused_mlp.py:98). It computes
// the function of _mlp_math: for each layer, h = act(h @ W_i) with f32
// accumulation; each hidden activation is rounded back to bf16; the output
// activation is applied in f32 and the result written as f32 (N, D_out).
//
// What bounds it on an H100: at the eval render's shapes (sigma 32->64->16 and
// color 31->64->64->3, N = 32,768 rows) a row costs 6.1-12.5 kFLOP against
// 136-192 bytes of f32 input and output, far under the ~295 FLOP/byte the
// bf16 tensor cores need, so it is bound by the f32 bytes read and written.
// The design therefore touches device memory only for x (read once, rounded
// to bf16 on load, which saves the wrapper's cast pass) and for the output:
// weights (a few KB) and hidden activations stay in shared memory.
//
// Design: one block of 4 warps per 64 rows. Per layer the block stages the
// layer's bf16 weight matrix in shared memory, zero-padded to multiples of 16
// (global loads are issued in batches so their latencies overlap),
// and each warp computes 16x16 output tiles with nvcuda::wmma bf16 -> f32
// (16x16x16) fragments. The f32 tile goes through a per-warp scratch, where
// the activation is applied before the bf16 store into the other activation
// buffer. Zero padding changes no result. Limits (checked by the wrapper):
// up to 8 layers, every width <= 256; N of any size (ragged last block).
// wgmma / TMA tuning is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int kMaxLayers = 8;
constexpr int kRows = 64;   // rows per block
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 16;
constexpr int kBatch = 8;  // global loads a thread issues before it stores

struct MlpArgs {
  const __nv_bfloat16* w[kMaxLayers];  // (dims[i], dims[i+1]) row major
  int dims[kMaxLayers + 1];
  int pad[kMaxLayers + 1];  // dims rounded up to 16
  int n_layers;
  int pmax;  // widest padded width
  int wmax;  // largest padded weight, in elements
};

// Activation ids follow _ACTIVATIONS in ops/fused_mlp.py.
__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 0: return fmaxf(v, 0.f);                          // relu
    case 1: return v;                                      // none
    case 2: return expf(v);                                // exp
    case 3: return 1.f / (1.f + expf(-v));                 // sigmoid
    case 4: return sinf(v);                                // sine
    case 5: return 0.5f * (v + sqrtf(v * v + 4.f));        // squareplus
    default: return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));  // softplus
  }
}

__global__ void __launch_bounds__(kThreads)
fused_mlp_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                 MlpArgs a, int act, int out_act) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* h_in = w_s + a.wmax;
  __nv_bfloat16* h_out = h_in + kRows * a.pmax;
  float* scratch = reinterpret_cast<float*>(h_out + kRows * a.pmax);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = blockIdx.x * kRows;
  const int ld = a.pmax;
  float* tile_f32 = scratch + warp * kTile * kTile;

  // x tile: f32 -> bf16 (round to nearest even), zero outside the data.
  // Each thread issues kBatch independent loads before storing any, so the
  // block waits about one load latency per batch rather than per element.
  const int d0 = a.dims[0];
  const int p0 = a.pad[0];
  const int nx = kRows * p0;
  for (int base = 0; base < nx; base += kBatch * kThreads) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = base + u * kThreads + tid;
      const int r = e / p0;
      const int c = e - r * p0;
      const int row = row0 + r;
      v[u] = (e < nx && c < d0 && row < n) ? x[(size_t)row * d0 + c] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = base + u * kThreads + tid;
      const int r = e / p0;
      if (e < nx) h_in[r * ld + (e - r * p0)] = __float2bfloat16(v[u]);
    }
  }

  for (int l = 0; l < a.n_layers; ++l) {
    const int din = a.dims[l];
    const int dout = a.dims[l + 1];
    const int pin = a.pad[l];
    const int pout = a.pad[l + 1];
    const bool last = (l == a.n_layers - 1);
    const int f = last ? out_act : act;

    __syncthreads();  // the previous layer is done with w_s and h_in/h_out
    const __nv_bfloat16* w = a.w[l];
    const int nw = pin * pout;
    for (int base = 0; base < nw; base += kBatch * kThreads) {
      __nv_bfloat16 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = base + u * kThreads + tid;
        const int r = e / pout;
        const int c = e - r * pout;
        v[u] = (e < nw && r < din && c < dout) ? w[(size_t)r * dout + c]
                                                : __float2bfloat16(0.f);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = base + u * kThreads + tid;
        if (e < nw) w_s[e] = v[u];
      }
    }
    __syncthreads();

    const int tiles_n = pout / kTile;
    const int tiles = (kRows / kTile) * tiles_n;
    for (int t = warp; t < tiles; t += kWarps) {
      const int rt = t / tiles_n;
      const int ct = t - rt * tiles_n;
      wmma::fragment<wmma::accumulator, kTile, kTile, kTile, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k = 0; k < pin; k += kTile) {
        wmma::fragment<wmma::matrix_a, kTile, kTile, kTile, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, kTile, kTile, kTile, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fa, h_in + rt * kTile * ld + k, ld);
        wmma::load_matrix_sync(fb, w_s + k * pout + ct * kTile, pout);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(tile_f32, acc, kTile, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < kTile * kTile; e += 32) {
        const int r = e / kTile;
        const int col = ct * kTile + (e - r * kTile);
        const float v = activate(tile_f32[e], f);
        if (!last) {
          h_out[(rt * kTile + r) * ld + col] =
              __float2bfloat16(col < dout ? v : 0.f);
        } else {
          const int row = row0 + rt * kTile + r;
          if (row < n && col < dout) out[(size_t)row * dout + col] = v;
        }
      }
      __syncwarp();  // the scratch tile is reused by this warp's next tile
    }
    __nv_bfloat16* tmp = h_in;
    h_in = h_out;
    h_out = tmp;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// w_ptrs and dims are HOST arrays of n_layers and n_layers + 1 entries.
extern "C" int nerfnav_fused_mlp_forward(const void* x, const void* w_ptrs,
                                         void* out, int n, int n_layers,
                                         const void* dims, int act,
                                         int out_act, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers) return (int)cudaErrorInvalidValue;
  const void* const* wp = static_cast<const void* const*>(w_ptrs);
  const int* d = static_cast<const int*>(dims);
  MlpArgs a = {};
  a.n_layers = n_layers;
  for (int i = 0; i <= n_layers; ++i) {
    if (d[i] < 1 || d[i] > 256) return (int)cudaErrorInvalidValue;
    a.dims[i] = d[i];
    a.pad[i] = (d[i] + kTile - 1) / kTile * kTile;
    a.pmax = a.pad[i] > a.pmax ? a.pad[i] : a.pmax;
  }
  for (int i = 0; i < n_layers; ++i) {
    a.w[i] = static_cast<const __nv_bfloat16*>(wp[i]);
    const int we = a.pad[i] * a.pad[i + 1];
    a.wmax = we > a.wmax ? we : a.wmax;
  }
  const size_t smem = (size_t)(a.wmax + 2 * kRows * a.pmax) * sizeof(__nv_bfloat16) +
                      (size_t)kWarps * kTile * kTile * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (n <= 0) return (int)cudaSuccess;
  const int blocks = (n + kRows - 1) / kRows;
  fused_mlp_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, a, act, out_act);
  return (int)cudaGetLastError();
}
