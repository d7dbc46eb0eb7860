// SMPL linear-blend skinning for NVIDIA Hopper (sm_90a): the fp32 blend
// on the tensor cores as a 3xTF32 split, the affine in registers.
//
// Replaces the TPU kernel poco_tpu/ops/pallas_lbs.py: skinning_pallas /
// _skin_kernel (the pallas_call at pallas_lbs.py:87). For sample b and
// vertex v:
//
//     T[b, v] = sum_j W[v, j] * A[b, j]                    (4x4, j < 24)
//     out[b, v] = T[b, v, :3, :3] @ v_posed[b, v] + T[b, v, :3, 3]
//
// The blend is a product C = W (V x 24) @ A' (24 x 12B), where A' holds
// rows 0-2 of each sample's transforms, its 12 columns per sample side
// by side. T never leaves registers, as in the TPU kernel.
//
// Bound on an H100 SXM at B=128, V=6890: the kernel must move W 0.66 MB
// + A 0.20 MB + v_posed 10.6 MB + out 10.6 MB = 22.0 MB (6.6 us at 3.35
// TB/s). The blend in fp32 FMA would take 7.8 us at 67 TFLOP/s; as three
// TF32 products on the tensor cores it is 1.52 GFLOP, 3.1 us at 495
// TFLOP/s, plus 0.24 us of fp32 affine. So the bound is bytes, 6.6 us.
//
// Accuracy: the JAX path demands full fp32 (Precision.HIGHEST). One TF32
// product misses the 1e-4 gate by an order of magnitude, so each operand
// x is split into big = tf32(x) and small = the TF32 residual x - big,
// and the product is big*big + big*small + small*big, summed in fp32:
// about 2e-6 from the fp32 result at the main path's inputs.
//
// What bounds it (H100 SXM, ptxas: 72 registers, 36.9 KB of shared memory
// a block, so 3 blocks = 27 warps an SM): latency, not bytes or the tensor
// cores. At B=128 it takes about 18 us hot and 19.5 us cold, a third of
// the bound (PERF.md). Each MMA warp walks its pairs one after another
// through dependent steps (wait for the stage, chains of 9 dependent MMAs
// of ~25 cycles each, the shuffle epilogue, the staged store), and 27
// warps an SM do not hide that; the producer's split, repeated by every
// vertex tile, adds to it. Taking block-wide barriers out (the warp
// specialization below), the issue cost of the loads out of the MMA
// warps (TMA), filling the card in one wave of blocks (the group size
// below) and sharing one producer among 8 MMA warps each took a share;
// software-pipelining the MMAs of the next pair against the epilogue did
// not. The block-synchronous form of the same tile (8 warps, a cp.async
// double buffer, the split done by the whole block between two
// __syncthreads a pair; 72 registers, 3 blocks an SM, the same group)
// takes 21.1 us hot and 22.6 us cold at B=128 on an H100 SXM, 1.20x and
// 1.17x this kernel's time; at B=1 and B=8, where both sit near launch
// latency, it is 0.2-0.4 us faster.
//
// Design (warp-specialized):
// - A block owns a tile of 128 vertices and a group of samples, walked
//   two at a time (24 columns = 3 n-tiles of mma.m16n8k8, K = 24 = 3
//   k-steps, 27 MMAs a warp per pair). Eight MMA warps own 16 rows each;
//   a ninth, the producer warp, feeds them through a ring of kStages
//   stages in shared memory, with no block barrier after the start.
// - The group size fills the card in one wave: the launch reads how many
//   blocks the card holds at once (SMs x blocks an SM holds) and gives
//   each block as few samples as that allows (7 groups of up to 20 at
//   B=128, V=6890; 4 groups of 2 at B=8), since more blocks in flight
//   hide more of the latency.
// - Each MMA warp loads its 16 x 24 rows of W once, splits them
//   (cvt.rna.tf32.f32, then the residual) and keeps them as A fragments
//   in 24 registers for every pair it walks.
// - The producer issues TMA bulk copies kStages - 1 pairs ahead: per pair,
//   the two (sample, tile) slabs of v_posed (1536 bytes each) and the
//   pair's two transform stacks (3 KB). A bulk copy moves whole 16-byte
//   lines, so each slab is copied from the line that holds its first
//   float and lands in shared memory at its global address modulo 16
//   (odd samples at V=6890 start 8 bytes into a line; the ragged tile is
//   1272 bytes). The extra bytes share a line with the slab's own, so they
//   are never outside mapped memory, and they are ignored. V is not
//   padded.
// - One pair ahead of the MMA warps, the producer splits the pair's
//   24 x 24 slab of A' into big and small parts in the stage, as float4
//   {big[k], big[k+4], small[k], small[k+4]}, so that a B fragment is one
//   conflict-free 16-byte load (row pitch 26 float4).
// - Stage hand-off: `full` (the TMA bytes have landed), `ready` (the
//   producer's split is written) and `empty` (all MMA warps are done with
//   the stage, so the producer may load the next pair into it).
// - Epilogue: a sample's 12 columns start at a multiple of 4, so each
//   row of T (4 entries) lies inside one n-tile, held by lanes 2t and
//   2t+1 (columns 4q..4q+3). The even lane forms T0*x + T1*y, the odd
//   lane T2*z + T3, for rows g and g+8; one __shfl_xor_sync completes
//   both, and each lane keeps one. Each MMA warp stages its 16 rows of
//   the pair's output in shared memory, mirrored at the global address
//   modulo 16, and stores them as 16-byte chunks (single floats at the
//   ends).
//
// Plain C interface for ctypes: the launch returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kJoints = 24;
constexpr int kMmaWarps = 8;                    // 16 vertices each
constexpr int kMinBlocks = 3;                   // blocks an SM must hold (caps registers at 72)
constexpr int kStages = 3;                      // sample pairs in the ring of a block
constexpr int kThreads = 32 * (kMmaWarps + 1);  // + the producer warp
constexpr int kTile = 16 * kMmaWarps;           // vertices per block
constexpr int kSlab = 3 * kTile;                // floats of one (sample, tile) slab
constexpr int kSlabPitch = kSlab + 4;           // + room for the 16-byte phase
constexpr int kWarpOut = 3 * 16 + 4;            // one MMA warp's rows of a sample
constexpr int kTfm = kJoints * 16;              // floats of one sample's transforms
constexpr int kBRows = 12;                      // 3 k-steps x 4 (rows t, t+4)
constexpr int kBPitch = 26;                     // float4s a row: 24 used
static_assert(kStages >= 2, "the ring needs two stages");

// One stage of the ring: a pair's split transforms, raw transforms and
// v_posed slabs.
struct Stage {
  float4 b[kBRows * kBPitch];
  float tfm[2 * kTfm + 4];
  float vp[2][kSlabPitch];
};
static_assert(sizeof(Stage) % 16 == 0, "stages stay 16-byte aligned");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small: big is x rounded to TF32 (to nearest, ties away, as
// cvt.rna.tf32.f32 for finite x; NaN and Inf reach the result through
// small), small the residual truncated to TF32.
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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
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
skin_tc_kernel(const float* __restrict__ weights,  // (V, 24)
               const float* __restrict__ tfms,     // (B, 24, 4, 4)
               const float* __restrict__ v_posed,  // (B, V, 3)
               float* __restrict__ out,            // (B, V, 3)
               int batch, int num_verts, int group) {
  __shared__ __align__(128) Stage stage_s[kStages];
  __shared__ __align__(16) float out_s[kMmaWarps][2][kWarpOut];
  __shared__ uint64_t full_s[kStages], ready_s[kStages], empty_s[kStages];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int v0 = blockIdx.x * kTile;
  const int nv = min(kTile, num_verts - v0);
  const int b0 = blockIdx.y * group;
  const int nb = min(group, batch - b0);
  const int npairs = (nb + 1) >> 1;
  const size_t sample_stride = (size_t)num_verts * 3;  // floats
  const size_t pair_stride = 2 * sample_stride;
  const int pair_phase_step = static_cast<int>(pair_stride & 3);  // of a slab's phase

  // This MMA warp's 16 rows of W as A fragments (loads start before the
  // barrier; the split waits until after it).
  float w_raw[3][4] = {};
  if (warp < kMmaWarps) {
    const int g = lane >> 2, t = lane & 3;
    const int r0 = warp * 16 + g;
    const int r1 = r0 + 8;
    const float* w0 = weights + (size_t)(v0 + r0) * kJoints + t;
    const float* w1 = weights + (size_t)(v0 + r1) * kJoints + t;
#pragma unroll
    for (int kk = 0; kk < 3; ++kk) {
      if (r0 < nv) w_raw[kk][0] = __ldg(w0 + 8 * kk);
      if (r1 < nv) w_raw[kk][1] = __ldg(w1 + 8 * kk);
      if (r0 < nv) w_raw[kk][2] = __ldg(w0 + 8 * kk + 4);
      if (r1 < nv) w_raw[kk][3] = __ldg(w1 + 8 * kk + 4);
    }
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_s[s], 1);
      mbar_init(&ready_s[s], 24);
      mbar_init(&empty_s[s], 32 * kMmaWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kMmaWarps) {
    // ---- producer warp: TMA loads kStages - 1 pairs ahead, the split
    // of the transforms one pair ahead of the MMA warps ----
    // Pair p into stage p % kStages: every lane computes the operands from
    // the pair index, one lane issues.
    const float* const vp_first = v_posed + ((size_t)b0 * num_verts + v0) * 3;
    const float* const tfm_first = tfms + (size_t)b0 * kTfm;
    auto issue = [&](int p) {
      const int s = p % kStages;
      const bool two = 2 * p + 1 < nb;
      const float* vp_a = vp_first + p * pair_stride;
      const float* vp_b = vp_a + sample_stride;
      const float* tf = tfm_first + (size_t)(2 * p) * kTfm;
      const uint32_t tfm_bytes = line_bytes(tf, (two ? 2 : 1) * kTfm);
      const uint32_t vp_bytes_a = line_bytes(vp_a, 3 * nv);
      const uint32_t vp_bytes_b = two ? line_bytes(vp_b, 3 * nv) : 0u;
      if (lane == 0) {
        mbar_expect(&full_s[s], tfm_bytes + vp_bytes_a + vp_bytes_b);
        bulk_load(stage_s[s].tfm, line_start(tf), tfm_bytes, &full_s[s]);
        bulk_load(stage_s[s].vp[0], line_start(vp_a), vp_bytes_a, &full_s[s]);
        if (two) bulk_load(stage_s[s].vp[1], line_start(vp_b), vp_bytes_b, &full_s[s]);
      }
    };
    for (int q = 0; q < kStages - 1 && q < npairs; ++q) issue(q);
    // Lane n < 24 splits column n of the pair (sample n / 12, transform
    // entry n % 12) for all 12 rows 4 kk + tt (joints 8 kk + tt and + 4).
    const int col_sample = lane / 12;
    const int src0 = phase_of(tfms) + col_sample * kTfm + lane % 12;
    int stage = 0;
    uint32_t parity = 0;
    for (int p = 0; p < npairs; ++p) {
      Stage& st = stage_s[stage];
      mbar_wait(&full_s[stage], parity);
      if (lane < 24) {
        const bool ok = 2 * p + col_sample < nb;
#pragma unroll
        for (int row = 0; row < kBRows; ++row) {
          const int k = 8 * (row >> 2) + (row & 3);
          uint32_t lo_big, lo_small, hi_big, hi_small;
          split_tf32(ok ? st.tfm[src0 + 16 * k] : 0.0f, lo_big, lo_small);
          split_tf32(ok ? st.tfm[src0 + 16 * (k + 4)] : 0.0f, hi_big, hi_small);
          st.b[row * kBPitch + lane] =
              make_float4(__uint_as_float(lo_big), __uint_as_float(hi_big),
                          __uint_as_float(lo_small), __uint_as_float(hi_small));
        }
        mbar_arrive(&ready_s[stage]);
      }
      // The stage of pair p - 1 takes pair p + kStages - 1.
      if (p + kStages - 1 < npairs) {
        if (p > 0) {
          const int prev = stage == 0 ? kStages - 1 : stage - 1;
          mbar_wait(&empty_s[prev], prev == kStages - 1 ? parity ^ 1 : parity);
        }
        issue(p + kStages - 1);
      }
      if (++stage == kStages) {
        stage = 0;
        parity ^= 1;
      }
    }
    return;
  }

  // ---- MMA warps ----
  const int g = lane >> 2;  // row within the mma tile
  const int t = lane & 3;   // k (A, B) or column pair (C) within the tile
  const int odd = t & 1;
  const int q = t >> 1;

  // W split once (cvt.rna.tf32.f32, then the residual), for every pair.
  uint32_t w_big[3][4], w_small[3][4];
#pragma unroll
  for (int kk = 0; kk < 3; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w_big[kk][i] = to_tf32(w_raw[kk][i]);
      w_small[kk][i] = to_tf32(w_raw[kk][i] - __uint_as_float(w_big[kk][i]));
    }
  }

  // Per-lane offsets: the B fragments in a stage, this lane's inputs in a
  // v_posed slab (x, y or z, 1 of rows g and g + 8), and the output row
  // it finishes in this warp's staging.
  const int b_at = t * kBPitch + g;
  const int vp_at = warp * 48 + g * 3;
  const int o_row = (g + 8 * odd) * 3;
  // Phases (floats into a 16-byte line) of this pair's v_posed slabs and
  // of this warp's output slices, stepped a pair at a time.
  const float* vp0 = v_posed + ((size_t)b0 * num_verts + v0) * 3;
  float* const out0 = out + ((size_t)b0 * num_verts + v0 + 16 * warp) * 3;
  int vp_ph0 = phase_of(vp0), vp_ph1 = phase_of(vp0 + sample_stride);
  int o_ph0 = phase_of(out0), o_ph1 = phase_of(out0 + sample_stride);
  // The store: lane (h, j) writes 16-byte line j of output slice h.
  const int st_half = lane >> 4;
  const int st_line = lane & 15;
  const int n_store = 3 * max(0, min(16, nv - 16 * warp));
  float* out_slice = out0 + st_half * sample_stride;
  float* const o_warp = &out_s[warp][0][0];

  int stage = 0;
  uint32_t parity = 0;
  for (int p = 0; p < npairs; ++p) {
    Stage& st = stage_s[stage];
    mbar_wait(&ready_s[stage], parity);

    // acc = W (16 x 24) @ A' (24 x 24) in 27 MMAs, 3xTF32.
    float acc[3][4] = {};
    const float4* bf = st.b + b_at;
#pragma unroll
    for (int kk = 0; kk < 3; ++kk) {
      float4 b[3];
#pragma unroll
      for (int nt = 0; nt < 3; ++nt) b[nt] = bf[4 * kk * kBPitch + 8 * nt];
#pragma unroll
      for (int nt = 0; nt < 3; ++nt)
        mma_tf32(acc[nt], w_small[kk], __float_as_uint(b[nt].x), __float_as_uint(b[nt].y));
#pragma unroll
      for (int nt = 0; nt < 3; ++nt)
        mma_tf32(acc[nt], w_big[kk], __float_as_uint(b[nt].z), __float_as_uint(b[nt].w));
#pragma unroll
      for (int nt = 0; nt < 3; ++nt)
        mma_tf32(acc[nt], w_big[kk], __float_as_uint(b[nt].x), __float_as_uint(b[nt].y));
    }

    // (x, y) for even lanes, (z, 1) for odd lanes, rows g and g + 8, for
    // both samples of the pair.
    const float* vpa = st.vp[0] + vp_ph0 + vp_at;
    const float* vpb = st.vp[1] + vp_ph1 + vp_at;
    const float u00 = vpa[2 * odd], u01 = vpa[24 + 2 * odd];
    const float u10 = vpb[2 * odd], u11 = vpb[24 + 2 * odd];
    const float w00 = odd ? 1.0f : vpa[1], w01 = odd ? 1.0f : vpa[25];
    const float w10 = odd ? 1.0f : vpb[1], w11 = odd ? 1.0f : vpb[25];
    float* const oa = o_warp + o_ph0 + o_row;
    float* const ob = o_warp + kWarpOut + o_ph1 + o_row;
#pragma unroll
    for (int nt = 0; nt < 3; ++nt) {
      // Quad 2 nt + q of the pair is row r of sample h's T (h is fixed
      // for n-tiles 0 and 2, and is q for n-tile 1).
      const bool h = nt == 2 || (nt == 1 && q);
      const int r = nt == 0 ? q : nt == 1 ? 2 - 2 * q : 1 + q;
      const float p0 = fmaf(acc[nt][0], h ? u10 : u00, acc[nt][1] * (h ? w10 : w00));
      const float p1 = fmaf(acc[nt][2], h ? u11 : u01, acc[nt][3] * (h ? w11 : w01));
      const float mine = odd ? p1 : p0;
      const float theirs = __shfl_xor_sync(0xffffffffu, odd ? p0 : p1, 1);
      (h ? ob : oa)[r] = mine + theirs;
    }
    mbar_arrive(&empty_s[stage]);  // this lane is done with the stage
    __syncwarp();

    // Line j of slice h covers slice floats [4 j - ph, 4 j - ph + 4).
    if (2 * p + st_half < nb) {
      const int ph = st_half ? o_ph1 : o_ph0;
      const float* src = o_warp + st_half * kWarpOut;
      const int lo = 4 * st_line - ph;
      if (lo >= 0 && lo + 4 <= n_store) {
        *reinterpret_cast<float4*>(out_slice + lo) =
            *reinterpret_cast<const float4*>(src + 4 * st_line);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (lo + k >= 0 && lo + k < n_store) out_slice[lo + k] = src[4 * st_line + k];
        }
      }
    }
    __syncwarp();

    out_slice += pair_stride;
    vp_ph0 = (vp_ph0 + pair_phase_step) & 3;
    vp_ph1 = (vp_ph1 + pair_phase_step) & 3;
    o_ph0 = (o_ph0 + pair_phase_step) & 3;
    o_ph1 = (o_ph1 + pair_phase_step) & 3;
    if (++stage == kStages) {
      stage = 0;
      parity ^= 1;
    }
  }
}

// Samples per block: as few as fill the card in one wave of blocks (more
// blocks in flight hide more latency), rounded up to a pair. A failed
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
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, skin_tc_kernel, kThreads, 0);
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

extern "C" int poco_skinning_f32(const float* weights, const float* tfms,
                                 const float* v_posed, float* out, int batch,
                                 int num_verts, int num_joints,
                                 cudaStream_t stream) {
  if (num_joints != kJoints || batch < 0 || num_verts < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || num_verts == 0) return 0;
  const int tiles = (num_verts + kTile - 1) / kTile;
  int group = 0;
  const cudaError_t query = group_size(batch, tiles, &group);
  if (query != cudaSuccess) return static_cast<int>(query);
  const int blocks_y = (batch + group - 1) / group;
  if (blocks_y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  skin_tc_kernel<<<dim3(tiles, blocks_y), kThreads, 0, stream>>>(
      weights, tfms, v_posed, out, batch, num_verts, group);
  return static_cast<int>(cudaGetLastError());
}
