// The wide layers of mip-NeRF's MLP for Hopper (sm_90a): one GEMM with a
// fused epilogue in each direction, for ops/mip_gemm.py.
//
// Replaces no Pallas kernel: the JAX package has no mip-NeRF. The port's
// eager chain (torch.addmm into a float32 output, then a cast, a relu, and in
// the backward a product into float32, a mask, a cast and a column sum, each
// a pass over a (2^19, 256) activation) spent most of a mip-NeRF train step
// in elementwise passes; here each activation and each activation gradient is
// read once and written once, in bf16.
//
//   bias_act:    out = bf16(act(A @ W + b)), act relu or none; out may have a
//                row stride (a column block of a wider buffer).
//   dgrad_mask:  d = G @ W^T (+ gd[m] ws[n]), set to 0 where saved[m, n] <= 0;
//                out = bf16(d) and per-warp partial column sums of d, which
//                the caller sums (the bias gradient: no atomics, the same
//                bits every run).
//
// Both are C = A @ B^T with A (M, K) bf16, K-major, f32 sums, and B read as
// it lies: the forward's B^T is W (K, N), N-major (wgmma's transposed B), the
// input gradient's B is W's first N rows (N, K), K-major. The arithmetic is
// the plain version's: f32 products and sums of bf16 operands, the bias
// added in f32, one rounding to bf16 (round to nearest even); the rank-1 term
// as a rounded product, then a rounded add; only the order of the K sum is
// this kernel's own.
//
// What bounds it on an H100: bytes. A 256 x 256 layer over M = 2^19 rows is
// 68.7 GFLOP (0.07 ms at 989 TFLOP/s) against 256 MB of bf16 input and 256 MB
// of bf16 output (0.16 ms at 3.35 TB/s); the input gradient also reads the
// saved bf16 activation for its mask (0.23 ms).
//
// Design: persistent blocks, one per SM, walk the 64-row tiles.
// - B stays resident in shared memory for the whole walk (N x K bf16, K
//   padded to a multiple of 64: 128 KB at N = K = 256, 192 KB at K = 352):
//   the forward's W in 64 x 64 boxes, 64 columns of N by 64 rows of K, one
//   run of K rows for each 64 columns; the input gradient's in boxes of N
//   rows by 64 columns of K.
// - One thread of a third warpgroup (the producer) keeps a ring of 64 x 64
//   A chunks in flight by TMA (128-byte swizzle, the layout wgmma reads;
//   rows past M and columns past K arrive as zeros, so a last chunk past K
//   adds nothing). The producer hands registers to the consumers
//   (setmaxnreg): ptxas reports 168 a thread either way, but on an H100 the
//   input gradient then takes 0.29-0.32 ms at M = 2^19, K = 256 instead of
//   0.40-0.41 ms.
// - Two consumer warpgroups take the block's tiles in turns: each runs
//   wgmma m64nNk16 over a tile's K into N / 2 f32 registers a thread, then
//   its epilogue in registers, while the other runs the next tile's
//   products. A pair of barriers orders the two mainloops, so the ring's
//   stages are waited on in the order they were filled.
// - The epilogue moves rows 16 bytes a thread (whole 32-byte sectors a
//   warp), its words transposed within each quad of lanes.
// - In the input gradient each consumer thread copies its mask rows of a
//   tile into shared memory (cp.async) before the tile's products, which
//   hide the copy; each tile's column sums are reduced and scattered over
//   the 8 lanes that hold a column, so that a thread keeps 8 running sums in
//   registers, written once at the end.
//
// Limits (checked by the wrapper and here): N 256 (either) or 128 (bias_act),
// K a multiple of 16 with B fitting beside two ring stages, row strides a
// multiple of 8 elements, every matrix 16-byte aligned. The forward's W may
// have fewer rows than K: the rows past its own read as zeros.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;                      // rows of a tile: one wgmma M
constexpr int kBK = 64;                      // columns of a chunk: one 128-byte row
constexpr int kChunkBytes = kBM * kBK * 2;   // one ring stage
constexpr int kMaxStages = 16;
constexpr int kConsumers = 256;              // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;   // and the producer warpgroup
constexpr int kSmemLimit = 232448;           // dynamic shared memory of a block, sm_90
// the input gradient's mask rows: 16 bytes a thread, 2 rows x 8 column groups
// of a 64 x 256 tile, for each consumer thread
constexpr int kMaskBytes = kConsumers * 2 * 8 * 16;

struct Params {
  int m, k, stages;
  __nv_bfloat16* out;                        // (M, N), row stride ldo
  int ldo;
  const float* bias;                         // bias_act: (N,) f32
  int relu;
  const __nv_bfloat16* saved;                // dgrad_mask: the mask's (M, N), row stride lds, or null
  int lds;
  const __nv_bfloat16* gd;                   // dgrad_mask: rank-1 row factor (M,), or null
  const __nv_bfloat16* wsv;                  //   and its column factor (N,)
  float* colsum;                             // dgrad_mask: (grid x 8, N) partial column sums
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// spins until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// one TMA box of a 2-D tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row)
      : "memory");
}

// wgmma descriptor of a bf16 operand in 128-byte-swizzled rows, 8-row groups
// 1024 bytes apart (the stride byte offset). K-major: a row holds 64 of K, a
// 16-wide K step is +32 bytes of address, the leading offset unused (1).
// N-major: a row holds 64 of N for one k, a 16-wide K step is +2048 bytes,
// and `lead` bytes lie between one 64 columns of N and the next
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lead = 16) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t(lead >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256 f32, 128 a thread) += A (64 x 16, smem) B (16 x 256, smem), or = when
// accumulate is 0; bf16 behind 128-byte-swizzle descriptors, A K-major, B
// K-major (TB 0) or N-major (TB 1)
template <int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
}

// the same at N = 128 (64 f32 a thread)
template <int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
}


// 4 words of each lane of a quad (lanes 4 i .. 4 i + 3) transposed: lane q's
// word k becomes lane k's word q
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[4], int lane) {
  const bool b0 = lane & 1, b1 = lane & 2;
  uint32_t y = __shfl_xor_sync(0xffffffffu, b0 ? w[0] : w[1], 1);
  if (b0) w[0] = y; else w[1] = y;
  y = __shfl_xor_sync(0xffffffffu, b0 ? w[2] : w[3], 1);
  if (b0) w[2] = y; else w[3] = y;
  y = __shfl_xor_sync(0xffffffffu, b1 ? w[0] : w[2], 2);
  if (b1) w[0] = y; else w[2] = y;
  y = __shfl_xor_sync(0xffffffffu, b1 ? w[1] : w[3], 2);
  if (b1) w[1] = y; else w[3] = y;
}

// the sums over the 8 lanes of a warp that share lane % 4 of 8 values each,
// scattered: lane (b4 b3 b2 q) gets the sum of value 4 b4 + 2 b3 + b2
__device__ __forceinline__ float reduce_scatter8(const float (&v)[8], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float k[4], h[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    k[i] = (b4 ? v[i + 4] : v[i]) + __shfl_xor_sync(0xffffffffu, b4 ? v[i] : v[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    h[i] = (b3 ? k[i + 2] : k[i]) + __shfl_xor_sync(0xffffffffu, b3 ? k[i] : k[i + 2], 8);
  return (b2 ? h[1] : h[0]) + __shfl_xor_sync(0xffffffffu, b2 ? h[0] : h[1], 4);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the low / high bf16 of a word <= 0 (a NaN is not)
__device__ __forceinline__ bool low_le0(uint32_t w) {
  return __uint_as_float(w << 16) <= 0.f;
}
__device__ __forceinline__ bool high_le0(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u) <= 0.f;
}

// 16 bytes from global to shared memory, asynchronously; zeros unless ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ void load16_shared(uint32_t (&w)[4], const void* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const uint32_t (&w)[4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <int BN, int TB>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da, uint64_t db,
                                           int accumulate) {
  if constexpr (BN == 256) {
    wgmma_n256<TB>(d, da, db, accumulate);
  } else {
    wgmma_n128<TB>(d, da, db, accumulate);
  }
}

template <int BN, bool DGRAD>
__device__ __forceinline__ void gemm_body(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                          const Params& p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sb = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // K chunks of a tile; a last chunk past K holds zeros (TMA fills them),
  // which add nothing to the sums
  const int nkb = (p.k + kBK - 1) / kBK;
  const int stages = p.stages;
  uint8_t* masks = sb + nkb * BN * 128;    // B: nkb x 64 rows of K by BN columns
  uint8_t* ring = masks + (DGRAD ? kMaskBytes : 0);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * kChunkBytes);
  uint64_t* empty = full + stages;
  uint64_t* b_full = empty + stages;
  uint64_t* turn = b_full + 1;             // [2]: consumer c may start a mainloop
  float* vec = reinterpret_cast<float*>(turn + 2);   // BN: the bias, or ws

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_init(b_full, 1);
    mbar_init(&turn[0], 4);
    mbar_init(&turn[1], 4);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < BN; i += kThreads) {
    if constexpr (DGRAD) {
      vec[i] = p.gd ? __bfloat162float(p.wsv[i]) : 0.f;
    } else {
      vec[i] = p.bias[i];
    }
  }
  __syncthreads();

  const int ntiles = (p.m + kBM - 1) / kBM;
  if (tid >= kConsumers) {
    // the producer: one thread loads B once, then the ring of A chunks in
    // tile order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid != kConsumers) return;
    mbar_expect_tx(b_full, nkb * BN * 128);
    if constexpr (DGRAD) {
      for (int b = 0; b < nkb; ++b) tma_load(sb + b * BN * 128, map_b, b_full, b * kBK, 0);
    } else {
      for (int nb = 0; nb < BN / 64; ++nb)
        for (int b = 0; b < nkb; ++b)
          tma_load(sb + (nb * nkb + b) * kChunkBytes, map_b, b_full, nb * 64, b * kBK);
    }
    int seq = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      for (int kc = 0; kc < nkb; ++kc, ++seq) {
        const int s = seq % stages;
        mbar_wait(&empty[s], ((seq / stages) & 1) ^ 1);
        mbar_expect_tx(&full[s], kChunkBytes);
        tma_load(ring + s * kChunkBytes, map_a, &full[s], kc * kBK, t * kBM);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int c = tid / 128;                 // consumer warpgroup
  const int warp = (tid % 128) / 32, lane = tid % 32;
  float acc[BN / 2];
  float sums[BN / 32];   // the running column sums this thread keeps
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 32; ++i) sums[i] = 0.f;
  mbar_wait(b_full, 0);
  const uint32_t a_base = smem_u32(ring), b_base = smem_u32(sb);
  int local = 0;
  // thread (warp, lane) of a consumer holds rows r0, r0 + 8 of a tile and,
  // for each j < BN / 8, columns 8 j + 2 q + {0, 1}, q = lane % 4. Rows move
  // as 16 bytes a thread: for each group of 4 j, the quad's words are
  // transposed so that lane q holds columns 8 (4 J + q) .. + 7
  const int q = lane & 3;
  uint8_t* my_masks = masks + (tid % 128 + c * 128 * 2 * 8) * 16;
  for (int i = c; blockIdx.x + i * gridDim.x < ntiles; i += 2, ++local) {
    const int t = blockIdx.x + i * gridDim.x;
    const int r0 = t * kBM + warp * 16 + lane / 4, r1 = r0 + 8;
    const bool ok0 = r0 < p.m, ok1 = r1 < p.m;
    float g0 = 0.f, g1 = 0.f;
    if constexpr (DGRAD) {
      if (p.gd) {
        if (ok0) g0 = __bfloat162float(p.gd[r0]);
        if (ok1) g1 = __bfloat162float(p.gd[r1]);
      }
      // this thread's mask words, copied while the products run
      if (p.saved) {
        const __nv_bfloat16* s0 = p.saved + static_cast<size_t>(ok0 ? r0 : 0) * p.lds + 8 * q;
        const __nv_bfloat16* s1 = p.saved + static_cast<size_t>(ok1 ? r1 : 0) * p.lds + 8 * q;
#pragma unroll
        for (int jg = 0; jg < BN / 32; ++jg) {
          cp_async16(my_masks + (2 * jg) * 128 * 16, s0 + 32 * jg, ok0);
          cp_async16(my_masks + (2 * jg + 1) * 128 * 16, s1 + 32 * jg, ok1);
        }
      }
    }
    if (c == 1) {
      mbar_wait(&turn[1], local & 1);
    } else if (local > 0) {
      mbar_wait(&turn[0], (local - 1) & 1);
    }
    int seq = i * nkb;
    for (int kc = 0; kc < nkb; ++kc, ++seq) {
      const int s = seq % stages;
      mbar_wait(&full[s], (seq / stages) & 1);
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db =
            DGRAD ? sw128_desc(b_base + kc * BN * 128 + kk * 32)
                  : sw128_desc(b_base + (kc * kBK + kk * 16) * 128, nkb * kChunkBytes);
        wgmma_tile<BN, DGRAD ? 0 : 1>(acc, sw128_desc(a_base + s * kChunkBytes + kk * 32), db,
                                     (kc | kk) != 0);
      }
      wg_commit();
      wg_wait_all();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[s]);   // the warp is past its reads
    }
    if (lane == 0) mbar_arrive(&turn[c ^ 1]);

    // epilogue
    __nv_bfloat16* o0 = p.out + static_cast<size_t>(ok0 ? r0 : 0) * p.ldo + 8 * q;
    __nv_bfloat16* o1 = p.out + static_cast<size_t>(ok1 ? r1 : 0) * p.ldo + 8 * q;
    if constexpr (DGRAD) {
      if (p.saved) cp_async_wait_all();
    }
#pragma unroll
    for (int jg = 0; jg < BN / 32; ++jg) {
      uint32_t w0[4], w1[4], m0[4], m1[4];
      float col_sums[8];
      if constexpr (DGRAD) {
        if (p.saved) {
          load16_shared(m0, my_masks + (2 * jg) * 128 * 16);
          load16_shared(m1, my_masks + (2 * jg + 1) * 128 * 16);
          quad_transpose(m0, lane);
          quad_transpose(m1, lane);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * jg + jj;
        const int col = 8 * j + 2 * q;
        float x00 = acc[4 * j], x01 = acc[4 * j + 1];
        float x10 = acc[4 * j + 2], x11 = acc[4 * j + 3];
        if constexpr (!DGRAD) {
          const float b0 = vec[col], b1 = vec[col + 1];
          x00 += b0;
          x01 += b1;
          x10 += b0;
          x11 += b1;
          if (p.relu) {   // as torch's relu: a NaN stays NaN
            x00 = x00 <= 0.f ? 0.f : x00;
            x01 = x01 <= 0.f ? 0.f : x01;
            x10 = x10 <= 0.f ? 0.f : x10;
            x11 = x11 <= 0.f ? 0.f : x11;
          }
        } else {
          if (p.gd) {
            const float v0 = vec[col], v1 = vec[col + 1];
            x00 = __fadd_rn(x00, __fmul_rn(g0, v0));
            x01 = __fadd_rn(x01, __fmul_rn(g0, v1));
            x10 = __fadd_rn(x10, __fmul_rn(g1, v0));
            x11 = __fadd_rn(x11, __fmul_rn(g1, v1));
          }
          if (p.saved) {
            if (low_le0(m0[jj])) x00 = 0.f;
            if (high_le0(m0[jj])) x01 = 0.f;
            if (low_le0(m1[jj])) x10 = 0.f;
            if (high_le0(m1[jj])) x11 = 0.f;
          }
          if (!ok0) x00 = x01 = 0.f;
          if (!ok1) x10 = x11 = 0.f;
          col_sums[2 * jj] = x00 + x10;
          col_sums[2 * jj + 1] = x01 + x11;
        }
        w0[jj] = pack_bf16(x00, x01);
        w1[jj] = pack_bf16(x10, x11);
      }
      if constexpr (DGRAD) sums[jg] += reduce_scatter8(col_sums, lane);
      quad_transpose(w0, lane);
      quad_transpose(w1, lane);
      if (ok0) store16(o0 + 32 * jg, w0);
      if (ok1) store16(o1 + 32 * jg, w1);
    }
  }
  if constexpr (DGRAD) {
    // this warp's partial sums of its rows: lane (b4 b3 b2 q) holds column
    // 8 (4 jg + 2 b4 + b3) + 2 q + b2 of each group jg (reduce_scatter8)
    float* dst = p.colsum + (static_cast<size_t>(blockIdx.x) * 8 + c * 4 + warp) * BN +
                 8 * (2 * ((lane >> 4) & 1) + ((lane >> 3) & 1)) + 2 * (lane & 3) +
                 ((lane >> 2) & 1);
#pragma unroll
    for (int jg = 0; jg < BN / 32; ++jg) dst[32 * jg] = sums[jg];
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    mip_gemm_bias_act_kernel(const __grid_constant__ CUtensorMap map_a,
                             const __grid_constant__ CUtensorMap map_b, const Params p) {
  gemm_body<BN, false>(&map_a, &map_b, p);
}

__global__ void __launch_bounds__(kThreads, 1)
    mip_gemm_dgrad_mask_kernel(const __grid_constant__ CUtensorMap map_a,
                               const __grid_constant__ CUtensorMap map_b, const Params p) {
  gemm_body<256, true>(&map_a, &map_b, p);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the libcuda the process has loaded
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// a (rows, cols) bf16 matrix with row stride ld, read in boxes of box_rows x
// 64 columns, 128-byte swizzled; out-of-range rows and columns read as zeros
int make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int ld, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK), static_cast<cuuint32_t>(box_rows)};
  cuuint32_t elem[2] = {1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                  strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

// shared memory of a block and its ring stages for B (n x k) and extra
// bytes; 0 stages if they do not fit beside two
int smem_bytes(int n, int k, int extra, int* stages) {
  const int fixed = 1024 + ((k + kBK - 1) / kBK) * n * 128 + extra + 3 * 8 + n * 4;
  int s = (kSmemLimit - fixed) / (kChunkBytes + 16);
  s = s < kMaxStages ? s : kMaxStages;
  *stages = s >= 2 ? s : 0;
  return fixed + s * (kChunkBytes + 16);
}

// b: the forward's W (kb, n), kb <= K rows, or the input gradient's (n, K)
template <int BN, bool DGRAD>
int launch(const void* a, int lda, const void* b, int ldb, int kb, int extra, Params p,
           int grid, void* stream) {
  constexpr auto kernel =
      DGRAD ? mip_gemm_dgrad_mask_kernel : mip_gemm_bias_act_kernel<BN>;
  if (p.m < 0 || p.k <= 0 || p.k % 16 || kb <= 0 || kb > p.k || grid <= 0 || lda % 8 ||
      ldb % 8 || p.ldo % 8 || !aligned(a, 16) || !aligned(b, 16) || !aligned(p.out, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.m == 0) return 0;
  const int smem = smem_bytes(BN, p.k, extra, &p.stages);
  if (!p.stages) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_a, map_b;
  int e = make_map(&map_a, a, p.m, p.k, lda, kBM);
  if (e) return e;
  e = DGRAD ? make_map(&map_b, b, BN, p.k, ldb, BN) : make_map(&map_b, b, kb, BN, ldb, kBK);
  if (e) return e;
  // once a kernel: every launch asks for at most kSmemLimit
  static const cudaError_t allowed =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(map_a, map_b, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (m, n) bf16, row stride ldo = bf16(act(a @ w + bias)): a (m, k) bf16,
// row stride lda; w (kw, n) bf16, kw <= k (rows past kw count as zeros), row
// stride ldw; bias (n,) f32; relu 1 or 0; n 256 or 128
extern "C" int nerfnav_mip_gemm_bias_act(const void* a, int lda, const void* w, int ldw,
                                         int kw, const void* bias, void* out, int ldo, int m,
                                         int n, int k, int relu, int grid, void* stream) {
  Params p = {};
  p.m = m;
  p.k = k;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.ldo = ldo;
  p.bias = static_cast<const float*>(bias);
  p.relu = relu;
  if (n == 256) return launch<256, false>(a, lda, w, ldw, kw, 0, p, grid, stream);
  if (n == 128) return launch<128, false>(a, lda, w, ldw, kw, 0, p, grid, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// d = g @ w^T (+ gd ws^T when gd is not null), 0 where saved <= 0 (when saved
// is not null); out (m, 256) bf16, row stride ldo = bf16(d); colsum (grid x
// 8, 256) f32: partial column sums of d, the rows of which sum to d's. g (m,
// k) bf16, row stride ldg; w (256, k) bf16, row stride ldw; saved (m, 256)
// bf16, row stride lds; gd (m,) and ws (256,) bf16
extern "C" int nerfnav_mip_gemm_dgrad_mask(const void* g, int ldg, const void* w, int ldw,
                                           const void* saved, int lds, const void* gd,
                                           const void* ws, void* out, int ldo, void* colsum,
                                           int m, int n, int k, int grid, void* stream) {
  if (n != 256 || (saved && (lds % 8 || !aligned(saved, 16))) || (gd && !ws))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  p.m = m;
  p.k = k;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.ldo = ldo;
  p.saved = static_cast<const __nv_bfloat16*>(saved);
  p.lds = lds;
  p.gd = static_cast<const __nv_bfloat16*>(gd);
  p.wsv = static_cast<const __nv_bfloat16*>(ws);
  p.colsum = static_cast<float*>(colsum);
  return launch<256, true>(g, ldg, w, ldw, k, kMaskBytes, p, grid, stream);
}
