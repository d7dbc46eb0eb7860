// Backward of SMPL linear-blend skinning for NVIDIA Hopper (sm_90a): both
// products on the tensor cores as a 3xTF32 split, one W tile shared by a
// group of samples, a deterministic two-pass reduction.
//
// The gradient of csrc/skinning.cu, the port of the TPU kernel
// poco_tpu/ops/pallas_lbs.py (skinning_pallas / _skin_kernel). That kernel
// has no VJP: the JAX package trains through XLA's autodiff of its einsum
// path (poco_tpu/smpl/lbs.py:177-186), so this kernel has no Pallas
// counterpart and computes what that autodiff computes. For sample b and
// vertex v, with g = dL/dout[b, v] and p = [v_posed[b, v], 1]:
//
//     T[b, v] = sum_j W[v, j] * A[b, j]           (recomputed, never stored)
//     grad_v_posed[b, v, y]  = sum_{x<3} T[b, v, x, y] * g[x]          (y < 3)
//     grad_tfms[b, j, x, y]  = sum_v W[v, j] * g[b, v, x] * p[b, v, y]  (x < 3)
//
// and row 3 of grad_tfms is 0. W (the SMPL skinning weights) gets no
// gradient. The first version, fp32 FMA on the shared-memory pipe, is
// csrc/skinning_backward_simt.cu, kept as the yardstick.
//
// Bound on an H100 SXM at B=64, V=6890: the kernel must move W 0.66 MB +
// the transforms 0.10 MB + v_posed, g and grad_v_posed 3 x 5.29 MB +
// grad_tfms 0.10 MB = 16.7 MB (5.0 us at 3.35 TB/s). Its two GEMM-shaped
// products as three TF32 products each on the tensor cores, plus the fp32
// rest, take 2.9 us, so the bound is bytes.
//
// Accuracy: the gate is 1e-5 x max |plain| + 1e-7 on both gradients. One
// TF32 product misses it (18x on grad_v_posed, 39x on grad_tfms at B=2,
// V=6890, against float64), so every operand x is split into big =
// tf32(x) and small = the TF32 residual, and each product is big*big +
// big*small + small*big summed in fp32, as in csrc/skinning.cu
// (tests/test_torch_skinning.py emulates this arithmetic).
//
// Design (block-synchronous, 8 warps; a block owns a tile of 128 vertices
// and a group of samples, walked two at a time):
// - One W tile serves the group: each warp loads its 16 rows of W once,
//   splits them, and keeps them in registers in both fragment layouts the
//   two products need (A of the blend, B of the reduction) for every pair
//   it walks. W is read from L2 once a group, not once a sample.
// - The group size fills the card in one wave: the launch reads how many
//   blocks the card holds at once (SMs x blocks an SM holds) and gives
//   each block as few samples as that allows, rounded up to a pair.
// - Staged I/O: thread 0 issues TMA bulk copies one pair ahead into a
//   ring of two stages: the pair's transforms and its (sample, tile)
//   slabs of v_posed and g. A bulk copy moves whole 16-byte lines, so
//   each slab is copied from the line that holds its first float and
//   lands at its global address modulo 16 (odd samples at V=6890 start 8
//   bytes into a line; inputs may start at any 4-byte offset; the ragged
//   tile is 106 vertices). The extra bytes share a line with the slab's
//   own and are never used. V is not padded.
// - The blend: the block splits the pair's transforms into the stage as
//   B fragments, columns laid out transposed (sample h, output column y,
//   row x: h * 12 + 4 y + x, row x = 3 zero), so that grad_v_posed[y] =
//   sum_x T[x, y] g[x] is the same 4-wide register epilogue as the
//   forward's (even lane T0 g0 + T1 g1, odd lane T2 g2, one shuffle).
//   Each warp: W (16 x 24) @ A' (24 x 24) in 27 MMAs a pair. The output
//   is staged in shared memory at its global phase and stored as 16-byte
//   chunks.
// - The reduction: per sample, E^T (12 x 16) @ W (16 x 24), E[v] = g[v]
//   (x) p[v] formed in A-fragment registers from the staged slabs and
//   split there (rows 12-15 zero): 2 k-steps x 3 n-tiles x 3 = 18 MMAs a
//   warp a sample. The 8 warps' 24 x 12 partials are summed in warp
//   order in shared memory, and the tile's partial goes to a scratch of
//   (B, tiles, 288) floats (4 MB at B=64, held in L2).
// - No float atomics: a second kernel adds each sample's tile partials in
//   a fixed order (four interleaved running sums, then (s0 + s1) + (s2 +
//   s3)). The same inputs give the same bits, which the bit-identical
//   resumed training step needs. It is chained behind the first by
//   programmatic dependent launch: the first kernel lets it launch at
//   once, and griddepcontrol.wait holds it until the first has finished
//   (plain stream order measured no faster; PERF.md).
//
// What bounds it (H100 SXM, ptxas: 102 registers, 47.0 KB of shared
// memory a block, so 2 blocks = 16 warps an SM): instruction issue, not
// bytes or the tensor cores. At B=64 it takes about 26 us hot and 28 us
// cold, 0.18-0.19 of the bound, 2.4x the first version (PERF.md).
// The 63 MMAs a pair are a small share of a warp's instructions; most go
// to forming and splitting E, then the split of the transforms, the
// epilogue, the warps' sum and address arithmetic. Built without them
// (ablate_skinning_backward.py, B=64), it takes 0.64 of its time without
// the reduction, 0.82 without the blend, 0.94 without the warps' sum, and
// 0.45 with only the loads, the transforms' split, epilogue and stores.
// Layouts with more warps an SM (3 blocks, W's reduction fragments in
// shared memory), a 4-stage ring with one barrier a pair, or those
// loop invariants hoisted were no faster; the next step is fewer
// instructions a pair (wgmma, E formed once a tile), not more latency
// hiding.
//
// Plain C interface for ctypes: the launch returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kJoints = 24;
constexpr int kWarps = 8;                  // 16 vertices each
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 2;              // blocks an SM must hold (caps registers at 128)
constexpr int kTile = 16 * kWarps;         // vertices per block
constexpr int kSlab = 3 * kTile;           // floats of one (sample, tile) slab
constexpr int kSlabPitch = kSlab + 4;      // + room for the 16-byte phase
constexpr int kTfm = kJoints * 16;         // floats of one sample's transforms
constexpr int kBRows = 12;                 // 3 k-steps x 4 (rows t, t+4)
constexpr int kBPitch = 26;                // float4s a row: 24 used
constexpr int kUsed = 12;                  // rows 0-2 of a 4x4
constexpr int kPartial = kJoints * kUsed;  // floats of one (sample, tile) partial
constexpr int kWarpOut = 3 * 16 + 4;       // one warp's rows of a sample, + phase
constexpr int kReduceThreads = kJoints * 16;
// Measurement builds only (ablate_skinning_backward.py): -DPOCO_ABLATE=
// <bits> leaves out the blend (1), the reduction (2) or the warps' sum
// (4), so their gradients are wrong; the library is built with 0.
#ifndef POCO_ABLATE
#define POCO_ABLATE 0
#endif
constexpr int kAblate = POCO_ABLATE;
constexpr int kAblateBlend = 1, kAblateReduce = 2, kAblateSum = 4;
static_assert(2 * kWarpOut <= kPartial, "the output staging fits a warp's partial");
static_assert(kBRows * 24 <= 2 * kThreads, "the split takes two passes at most");

// One stage of the ring: a pair's split transforms, raw transforms and
// v_posed and g slabs.
struct Stage {
  float4 b[kBRows * kBPitch];
  float tfm[2 * kTfm + 4];
  float vp[2][kSlabPitch];
  float g[2][kSlabPitch];
};
static_assert(sizeof(Stage) % 16 == 0, "stages stay 16-byte aligned");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x = big + small, both rounded to TF32 to nearest, ties away (what
// cvt.rna.tf32.f32 gives for finite x, in three integer operations and a
// subtraction; cvt.rna is no single instruction on sm_90a). W and E.
__device__ __forceinline__ void split_rna(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) & 0xffffe000u;
}

// x = big + small: big is x rounded to TF32 (to nearest, ties away, as
// cvt.rna.tf32.f32 for finite x), small the residual truncated to TF32
// (the transforms, as in csrc/skinning.cu).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

// C += A B for one m16n8k8 tile: A row-major 16x8, B column-major 8x8.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
        " selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// TMA bulk copy of `bytes` (a multiple of 16) from 16-byte aligned global
// memory to 16-byte aligned shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// Where p lies in its 16-byte line of global memory, in floats (0-3).
__device__ __forceinline__ int phase_of(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// The 16-byte lines that hold n floats from p: where they start, and
// their length in bytes.
__device__ __forceinline__ const float* line_start(const float* p) {
  return p - phase_of(p);
}
__device__ __forceinline__ uint32_t line_bytes(const float* p, int n) {
  return static_cast<uint32_t>((phase_of(p) + n + 3) >> 2) * 16u;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
grad_tc_kernel(const float* __restrict__ weights,   // (V, 24)
               const float* __restrict__ tfms,      // (B, 24, 4, 4)
               const float* __restrict__ v_posed,   // (B, V, 3)
               const float* __restrict__ grad_out,  // (B, V, 3)
               float* __restrict__ grad_v_posed,    // (B, V, 3)
               float* __restrict__ partial,         // (B, tiles, 24 * 12)
               int batch, int num_verts, int num_tiles, int group) {
  __shared__ __align__(128) Stage stage_s[2];
  // per (sample of the pair, warp): the warp's partial sum; a warp's own
  // [0][warp] row doubles as its output staging before it holds a partial
  __shared__ __align__(16) float red_s[2][kWarps][kPartial];
  __shared__ uint64_t full_s[2];

  // the second kernel may launch now; it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;");

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // row within the mma tile
  const int t = lane & 3;   // k (A, B) or column pair (C) within the tile
  const int tile = blockIdx.x;
  const int v0 = tile * kTile;
  const int nv = min(kTile, num_verts - v0);
  const int b0 = blockIdx.y * group;
  const int nb = min(group, batch - b0);
  const int npairs = (nb + 1) >> 1;
  const size_t sample_stride = (size_t)num_verts * 3;  // floats

  // This warp's 16 rows of W, raw: as the blend's A fragments (rows g, g +
  // 8; joints t + 8 kk, + 4) and as the reduction's B fragments (vertices
  // t + 8 kk, + 4; joint g + 8 nt). Rows past V are 0.
  float wa_raw[3][4] = {};
  float wb_raw[2][3][2] = {};
  {
    const int r0 = warp * 16 + g;
    const int r1 = r0 + 8;
    const float* w0 = weights + (size_t)(v0 + r0) * kJoints + t;
    const float* w1 = weights + (size_t)(v0 + r1) * kJoints + t;
#pragma unroll
    for (int kk = 0; kk < 3; ++kk) {
      if (r0 < nv) wa_raw[kk][0] = __ldg(w0 + 8 * kk);
      if (r1 < nv) wa_raw[kk][1] = __ldg(w1 + 8 * kk);
      if (r0 < nv) wa_raw[kk][2] = __ldg(w0 + 8 * kk + 4);
      if (r1 < nv) wa_raw[kk][3] = __ldg(w1 + 8 * kk + 4);
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int u = warp * 16 + 8 * kk + t;
#pragma unroll
      for (int nt = 0; nt < 3; ++nt) {
        const float* w = weights + (size_t)(v0 + u) * kJoints + g + 8 * nt;
        if (u < nv) wb_raw[kk][nt][0] = __ldg(w);
        if (u + 4 < nv) wb_raw[kk][nt][1] = __ldg(w + 4 * kJoints);
      }
    }
  }

  const float* const vp_first = v_posed + ((size_t)b0 * num_verts + v0) * 3;
  const float* const g_first = grad_out + ((size_t)b0 * num_verts + v0) * 3;
  const float* const tfm_first = tfms + (size_t)b0 * kTfm;
  // Pair p into stage p % 2, issued by thread 0.
  auto issue = [&](int p) {
    Stage& st = stage_s[p & 1];
    const bool two = 2 * p + 1 < nb;
    const float* tf = tfm_first + (size_t)(2 * p) * kTfm;
    const uint32_t tfm_bytes = line_bytes(tf, (two ? 2 : 1) * kTfm);
    uint32_t total = tfm_bytes;
    for (int h = 0; h < (two ? 2 : 1); ++h) {
      total += line_bytes(vp_first + (2 * p + h) * sample_stride, 3 * nv);
      total += line_bytes(g_first + (2 * p + h) * sample_stride, 3 * nv);
    }
    mbar_expect(&full_s[p & 1], total);
    bulk_load(st.tfm, line_start(tf), tfm_bytes, &full_s[p & 1]);
    for (int h = 0; h < (two ? 2 : 1); ++h) {
      const float* vp = vp_first + (2 * p + h) * sample_stride;
      const float* gr = g_first + (2 * p + h) * sample_stride;
      bulk_load(st.vp[h], line_start(vp), line_bytes(vp, 3 * nv), &full_s[p & 1]);
      bulk_load(st.g[h], line_start(gr), line_bytes(gr, 3 * nv), &full_s[p & 1]);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(&full_s[0], 1);
    mbar_init(&full_s[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int q = 0; q < 2 && q < npairs; ++q) issue(q);
  }

  // W split once, for every pair.
  uint32_t wa_big[3][4], wa_small[3][4];
#pragma unroll
  for (int kk = 0; kk < 3; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_rna(wa_raw[kk][i], wa_big[kk][i], wa_small[kk][i]);
  }
  uint32_t wb_big[2][3][2], wb_small[2][3][2];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int nt = 0; nt < 3; ++nt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) split_rna(wb_raw[kk][nt][i], wb_big[kk][nt][i], wb_small[kk][nt][i]);
    }
  }

  const int odd = t & 1;
  const int q = t >> 1;
  const int b_at = t * kBPitch + g;
  const int in_at = warp * 48 + g * 3;     // this lane's rows g, g + 8 in a slab
  const int o_row = (g + 8 * odd) * 3;     // the output row it finishes
  const int tfm_ph = phase_of(tfms);       // a sample's transforms are 1536 bytes
  const int n_store = 3 * max(0, min(16, nv - 16 * warp));
  const int st_half = lane >> 4;           // the store: lane (h, j) writes line j of
  const int st_line = lane & 15;           // sample h's slice
  float* const o_warp = &red_s[0][warp][0];
  // The reduction's A fragment: entries e = g (row x0, column y0) and e =
  // g + 8 (row 2, column y0; zero for g >= 4) of vertices u and u + 4.
  const int x0 = g >> 2;
  const int y0 = g & 3;

  for (int p = 0; p < npairs; ++p) {
    Stage& st = stage_s[p & 1];
    mbar_wait(&full_s[p & 1], (p >> 1) & 1);

    // Split the pair's transforms into B fragments: entry (row 4 kk + tt,
    // column c) holds {big, small} of joints k = 8 kk + tt and k + 4, for
    // column c = h * 12 + 4 y + x: A[h, k, x, y] (x < 3), 0 for x = 3.
    for (int i = threadIdx.x; i < kBRows * 24; i += kThreads) {
      const int row = i / 24, c = i % 24;
      const int k = 8 * (row >> 2) + (row & 3);
      const int h = c / 12, x = c & 3, y = (c % 12) >> 2;
      const bool ok = 2 * p + h < nb && x < 3;
      const float* src = st.tfm + tfm_ph + h * kTfm + k * 16 + 4 * x + y;
      uint32_t lo_big, lo_small, hi_big, hi_small;
      split_tf32(ok ? src[0] : 0.0f, lo_big, lo_small);
      split_tf32(ok ? src[64] : 0.0f, hi_big, hi_small);
      st.b[row * kBPitch + c] =
          make_float4(__uint_as_float(lo_big), __uint_as_float(hi_big),
                      __uint_as_float(lo_small), __uint_as_float(hi_small));
    }
    __syncthreads();

    // ---- the blend: acc = W (16 x 24) @ A' (24 x 24) in 27 MMAs ----
    float acc[3][4] = {};
    const float4* bf = st.b + b_at;
    if constexpr (!(kAblate & kAblateBlend)) {
#pragma unroll
      for (int kk = 0; kk < 3; ++kk) {
        float4 b[3];
#pragma unroll
        for (int nt = 0; nt < 3; ++nt) b[nt] = bf[4 * kk * kBPitch + 8 * nt];
#pragma unroll
        for (int nt = 0; nt < 3; ++nt)
          mma_tf32(acc[nt], wa_small[kk], __float_as_uint(b[nt].x), __float_as_uint(b[nt].y));
#pragma unroll
        for (int nt = 0; nt < 3; ++nt)
          mma_tf32(acc[nt], wa_big[kk], __float_as_uint(b[nt].z), __float_as_uint(b[nt].w));
#pragma unroll
        for (int nt = 0; nt < 3; ++nt)
          mma_tf32(acc[nt], wa_big[kk], __float_as_uint(b[nt].x), __float_as_uint(b[nt].y));
      }
    }

    // Phases of this pair's slabs and of this warp's output slices.
    const size_t first = (size_t)(b0 + 2 * p) * num_verts + v0;
    const int vp_ph0 = phase_of(v_posed + first * 3);
    const int vp_ph1 = phase_of(v_posed + first * 3 + sample_stride);
    const int g_ph0 = phase_of(grad_out + first * 3);
    const int g_ph1 = phase_of(grad_out + first * 3 + sample_stride);
    float* const out0 = grad_v_posed + (first + 16 * warp) * 3;
    const int o_ph0 = phase_of(out0);
    const int o_ph1 = phase_of(out0 + sample_stride);

    // Epilogue: (g0, g1) for even lanes, (g2, 0) for odd lanes, rows g
    // and g + 8, for both samples of the pair.
    {
      const float* ga = st.g[0] + g_ph0 + in_at;
      const float* gb = st.g[1] + g_ph1 + in_at;
      const float u00 = ga[2 * odd], u01 = ga[24 + 2 * odd];
      const float u10 = gb[2 * odd], u11 = gb[24 + 2 * odd];
      const float w00 = odd ? 0.0f : ga[1], w01 = odd ? 0.0f : ga[25];
      const float w10 = odd ? 0.0f : gb[1], w11 = odd ? 0.0f : gb[25];
      float* const oa = o_warp + o_ph0 + o_row;
      float* const ob = o_warp + kWarpOut + o_ph1 + o_row;
#pragma unroll
      for (int nt = 0; nt < 3; ++nt) {
        // Quad 2 nt + q of the pair is column y of sample h's T^T.
        const bool h = nt == 2 || (nt == 1 && q);
        const int y = nt == 0 ? q : nt == 1 ? 2 - 2 * q : 1 + q;
        const float p0 = fmaf(acc[nt][0], h ? u10 : u00, acc[nt][1] * (h ? w10 : w00));
        const float p1 = fmaf(acc[nt][2], h ? u11 : u01, acc[nt][3] * (h ? w11 : w01));
        const float mine = odd ? p1 : p0;
        const float theirs = __shfl_xor_sync(0xffffffffu, odd ? p0 : p1, 1);
        (h ? ob : oa)[y] = mine + theirs;
      }
      __syncwarp();
      // Line j of slice h covers slice floats [4 j - ph, 4 j - ph + 4).
      if (2 * p + st_half < nb) {
        const int ph = st_half ? o_ph1 : o_ph0;
        const float* src = o_warp + st_half * kWarpOut;
        float* dst = out0 + st_half * sample_stride;
        const int lo = 4 * st_line - ph;
        if (lo >= 0 && lo + 4 <= n_store) {
          *reinterpret_cast<float4*>(dst + lo) =
              *reinterpret_cast<const float4*>(src + 4 * st_line);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (lo + k >= 0 && lo + k < n_store) dst[lo + k] = src[4 * st_line + k];
          }
        }
      }
      __syncwarp();
    }

    // ---- the reduction: per sample, E^T (16 x 16) @ W (16 x 24) ----
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (2 * p + h >= nb || (kAblate & kAblateReduce)) break;
      const float* gs = st.g[h] + (h ? g_ph1 : g_ph0);
      const float* ps = st.vp[h] + (h ? vp_ph1 : vp_ph0);
      float racc[3][4] = {};
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        float e[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int u = warp * 16 + 8 * kk + t + 4 * half;
          const float* gu = gs + 3 * u;
          const float py = y0 < 3 ? ps[3 * u + y0] : 1.0f;
          const bool ok = u < nv;
          e[2 * half] = ok ? gu[x0] * py : 0.0f;
          e[2 * half + 1] = ok && g < 4 ? gu[2] * py : 0.0f;
        }
        uint32_t e_big[4], e_small[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_rna(e[i], e_big[i], e_small[i]);
#pragma unroll
        for (int nt = 0; nt < 3; ++nt)
          mma_tf32(racc[nt], e_small, wb_big[kk][nt][0], wb_big[kk][nt][1]);
#pragma unroll
        for (int nt = 0; nt < 3; ++nt)
          mma_tf32(racc[nt], e_big, wb_small[kk][nt][0], wb_small[kk][nt][1]);
#pragma unroll
        for (int nt = 0; nt < 3; ++nt)
          mma_tf32(racc[nt], e_big, wb_big[kk][nt][0], wb_big[kk][nt][1]);
      }
      // C (entry e, joint j): c0, c1 = (g, 8 nt + 2 t + 0/1); c2, c3 = (g + 8, ...)
      float* red = &red_s[h][warp][0];
#pragma unroll
      for (int nt = 0; nt < 3; ++nt) {
        const int j = 8 * nt + 2 * t;
        red[j * kUsed + g] = racc[nt][0];
        red[(j + 1) * kUsed + g] = racc[nt][1];
        if (g < 4) {
          red[j * kUsed + g + 8] = racc[nt][2];
          red[(j + 1) * kUsed + g + 8] = racc[nt][3];
        }
      }
    }
    __syncthreads();

    // Stage p % 2 is free: it takes pair p + 2.
    if (threadIdx.x == 0 && p + 2 < npairs) issue(p + 2);

    // The tile's partial: the warps' sums in warp order.
    if constexpr (!(kAblate & kAblateSum)) {
      constexpr int kQuads = kPartial / 4;
      for (int i = threadIdx.x; i < 2 * kQuads; i += kThreads) {
        const int h = i >= kQuads;
        const int o = i - h * kQuads;
        if (2 * p + h < nb) {
          const float4* red = reinterpret_cast<const float4*>(&red_s[h][0][0]) + o;
          float4 s = red[0];
#pragma unroll
          for (int w = 1; w < kWarps; ++w) {
            const float4 r = red[w * kQuads];
            s.x += r.x;
            s.y += r.y;
            s.z += r.z;
            s.w += r.w;
          }
          *reinterpret_cast<float4*>(
              partial + ((size_t)(b0 + 2 * p + h) * num_tiles + tile) * kPartial + 4 * o) = s;
        }
      }
    }
  }
}

// One block a sample, one thread an entry of its (24, 4, 4) gradient: the
// tiles' partials in a fixed order (row 3 is 0).
__global__ void __launch_bounds__(kReduceThreads)
reduce_tiles(const float* __restrict__ partial,  // (B, tiles, 24 * 12)
             float* __restrict__ grad_tfms,      // (B, 24, 4, 4)
             int num_tiles) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int b = blockIdx.x;
  const int o = threadIdx.x;
  const int j = o >> 4;
  const int e = o & 15;
  float s = 0.0f;
  if (e < kUsed) {
    const float* src = partial + (size_t)b * num_tiles * kPartial + j * kUsed + e;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int c = 0;
#pragma unroll 4
    for (; c + 4 <= num_tiles; c += 4) {
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] += src[(size_t)(c + k) * kPartial];
    }
    for (; c < num_tiles; ++c) acc[c & 3] += src[(size_t)c * kPartial];
    s = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }
  grad_tfms[(size_t)b * kJoints * 16 + o] = s;
}

// Samples per block: as few as fill the card in one wave of blocks,
// rounded up to a pair. A failed
// query is returned to the caller and not cached.
cudaError_t group_size(int batch, int tiles, int* group) {
  static int resident[64];  // blocks the card holds at once, by device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int held = dev < 64 ? resident[dev] : 0;
  if (held == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grad_tc_kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    held = max(1, sms * per_sm);
    if (dev < 64) resident[dev] = held;
  }
  const int groups = max(1, held / tiles);
  const int g = (batch + groups - 1) / groups;
  *group = g + (g & 1);
  return cudaSuccess;
}

}  // namespace

// Vertices a block reduces: the caller sizes the partial-sum scratch,
// (B, ceil(V / chunk), 24 * 12) floats, from it.
extern "C" int poco_skinning_backward_chunk() { return kTile; }

extern "C" int poco_skinning_backward_f32(const float* weights, const float* tfms,
                                          const float* v_posed, const float* grad_out,
                                          float* grad_v_posed, float* grad_tfms,
                                          float* partial, int batch, int num_verts,
                                          int num_joints, cudaStream_t stream) {
  if (num_joints != kJoints || batch < 0 || num_verts < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  const int tiles = (num_verts + kTile - 1) / kTile;
  if (tiles > 0) {
    int group = 0;
    const cudaError_t query = group_size(batch, tiles, &group);
    if (query != cudaSuccess) return static_cast<int>(query);
    const int blocks_y = (batch + group - 1) / group;
    if (blocks_y > 65535) return static_cast<int>(cudaErrorInvalidValue);
    grad_tc_kernel<<<dim3(tiles, blocks_y), kThreads, 0, stream>>>(
        weights, tfms, v_posed, grad_out, grad_v_posed, partial, batch, num_verts, tiles,
        group);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(batch);
  config.blockDim = dim3(kReduceThreads);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  config.numAttrs = tiles > 0 ? 1 : 0;  // programmatic dependent launch
  const cudaError_t err = cudaLaunchKernelEx(&config, reduce_tiles, partial, grad_tfms, tiles);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
