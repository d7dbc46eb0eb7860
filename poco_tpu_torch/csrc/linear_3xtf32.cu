// Y = epilogue(X @ W^T + b) in fp32 for NVIDIA Hopper (sm_90a): the product
// on the tensor cores as a 3xTF32 split with `wgmma`, bias and GELU or a
// residual add in the epilogue.
//
// Replaces no TPU kernel: the JAX package has no ViT. It was added for
// HMR 2.0's ViT-H trunk (`models/backbones/vit.py`), whose four nn.Linear
// layers a block (qkv, proj, fc1, fc2; M = 192 tokens a crop, K and N 1280,
// 3840 or 5120) took 90% of a request's card time in cuBLAS's fp32 SIMT
// GEMM: with TF32 off, cuBLAS offers no fp32-accurate tensor-core route.
//
// Accuracy: the port computes in fp32 with TF32 off. One TF32 product
// keeps 11 bits of each operand and misses that by three orders. Each
// operand x is split into big = tf32_rna(x) and small = tf32_rna(x - big),
// and the product is A_small B_big + A_big B_small + A_big B_big; only
// A_small B_small (2^-22 of |a||b|) is left out, as in `skinning.cu`. The
// tensor cores add each product into their fp32 accumulator without
// rounding to nearest: summed there over all of K, the error grew to 6-9
// times cuBLAS's fp32 error at K = 1280-5120 (H100, 24,576 rows). So an
// accumulator spans one k-tile only, and each k-tile's sums are added
// into a second set of registers with fp32 adds, as Hopper's FP8 GEMMs
// promote theirs: the error is then a quarter of cuBLAS's fp32 error.
//
// Bound on an H100 SXM: the operations. A 128-box request runs 24576 rows
// through the four layers: 30.9 TFLOP of fp32 products, three TF32
// products each, 187 ms at 494.7 TFLOP/s; the operands and outputs are a
// few hundred MB a layer (well under 1 ms at 3.35 TB/s). Timed alone at
// those shapes the kernel reaches 68-77% of that bound (PERF.md); on part
// of the SMs its rate an SM rises only 5%, so the SM's own pipeline, not
// L2, holds it there.
//
// Design:
// - A persistent grid of one block an SM walks the 128 x 128 output tiles
//   (grouped by kGroupM row tiles, so the blocks in flight share their
//   operands in L2). Three warpgroups: two consumers, each owning 64 rows
//   of the tile, and one producer, of which one thread issues the loads.
// - W is split once a call by `split_kernel` into W_big and W_small (the
//   caller's scratch), so B comes into shared memory already split. The
//   producer brings X's tile and both W tiles of each BK-deep k-tile by
//   TMA (the tensor maps' swizzle is the one the wgmma descriptors name)
//   into a ring of kStages stages; `full` barriers count the bytes,
//   `empty` barriers the consumer warps done with a stage.
// - A comes from registers: each consumer thread reads its four elements
//   of a k8 step from the swizzled tile, splits them (cvt.rna.tf32.f32)
//   and issues the three m64n128k8 products of the step as one wgmma
//   group. The split is double-buffered by step, and each step waits only
//   for the group before it, so the tensor cores always hold a step's
//   work.
// - A consumer thread holds two sets of 64 accumulators, for even and odd
//   k-tiles, and the 64 promoted sums (setmaxnreg gives the consumers 240
//   registers, the producer 24). A k-tile's first product starts its set
//   afresh; once its first step's wait shows the k-tile before it done,
//   that k-tile's set is added into the sums while this one's products
//   run, so promoting costs the tensor cores no wait.
// - The epilogue reads the sums in place: bias, exact-erf GELU (F.gelu's
//   default) or the residual add, stored as float2 from the fragment
//   layout; rows past M (TMA fills them with zeros) and columns past N are
//   masked. While the consumers run it, the producer already fills the
//   ring with the next tile's k-tiles.
//
// Plain C interface for ctypes: each call returns a cudaError_t (0 on
// success; the launch's cudaGetLastError()).

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;                    // rows of a tile: 64 a consumer warpgroup
constexpr int kBN = 128;                    // columns of a tile: one wgmma's N
constexpr int kBK = 32;                     // k of a stage: 128-byte rows
constexpr int kStages = 4;                  // stages in the ring
constexpr int kGroupM = 16;                 // row tiles walked together
// 2 consumer warpgroups + the producer's, and the registers setmaxnreg
// gives each thread (2 x 240 + 24 = 504 of the SM's 512 a thread slot).
constexpr int kThreads = 384;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kRowBytes = kBK * 4;          // a tile row: the 128-byte swizzle span
constexpr int kSteps = kBK / 8;             // k8 wgmma steps a stage
constexpr int kAcc = kBN / 2;               // fp32 accumulators a thread
constexpr int kABytes = kBM * kRowBytes;
constexpr int kBBytes = kBN * kRowBytes;
constexpr int kStageBytes = kABytes + 2 * kBBytes;
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;
static_assert(kSteps % 2 == 0, "the split is double-buffered by step");
static_assert(kSmemBytes <= 232448, "the ring must fit a block's shared memory");

enum Epilogue { kNone = 0, kGelu = 1, kResidual = 2 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// ---- mbarriers and TMA ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Waits for the phase of `bar` with this parity to complete. A wait that
// outlasts kStallNs traps, so a fault in the ring's accounting fails the
// launch instead of hanging the card. No stage takes a millisecond, but
// %globaltimer runs on while the context is switched out (time-slicing
// with other processes, MPS, a profiler's kernel replay), so the limit is
// a minute, far above any such pause: a trap poisons the whole context.
constexpr uint64_t kStallNs = 60000000000ull;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint64_t start = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
        " selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (start == 0) {
      start = now;
    } else if (now - start > kStallNs) {
      __trap();
    }
  }
}

// The box of `map` at (inner, outer) into shared memory, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int inner, int outer,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(inner), "r"(outer),
        "r"(smem_addr(bar)) : "memory");
}

// ---- wgmma ----

// Descriptor of a K-major tile of 128-byte rows with the 128-byte swizzle
// (layout 1), as TMA wrote it: 8-row groups 1024 bytes apart (the stride
// byte offset); the leading byte offset is unused for swizzled K-major
// tiles.
__device__ __forceinline__ uint64_t wgmma_desc(const void* tile) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3ffff) >> 4) |
         (uint64_t{1} << 16) |
         (static_cast<uint64_t>((8 * kRowBytes) >> 4) << 32) |
         (uint64_t{1} << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = A (64 x 8, TF32 in registers) @ B (8 x 128, K-major in shared
// memory), plus d unless `accumulate` is 0.
__device__ __forceinline__ void wgmma_tf32(float (&d)[kAcc], const uint32_t (&a)[4],
                                           uint64_t desc_b, uint32_t accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752440f));
}

// Tile t of the grouped walk: kGroupM row tiles at a time, rows fastest.
__device__ __forceinline__ void tile_coords(int t, int m_tiles, int n_tiles, int& m0, int& n0) {
  const int per_group = kGroupM * n_tiles;
  const int first = (t / per_group) * kGroupM;
  const int rows = min(m_tiles - first, kGroupM);
  const int in_group = t % per_group;
  m0 = (first + in_group % rows) * kBM;
  n0 = (in_group / rows) * kBN;
}

template <int kEpi>
__global__ void __launch_bounds__(kThreads, 1)
linear_kernel(const __grid_constant__ CUtensorMap x_map,    // X (M, K)
              const __grid_constant__ CUtensorMap wb_map,   // W_big (N, K)
              const __grid_constant__ CUtensorMap ws_map,   // W_small (N, K)
              const float* __restrict__ bias,               // (N)
              const float* __restrict__ residual,           // (M, N) or null
              float* __restrict__ out,                      // (M, N)
              int M, int N, int K) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // The ring starts on a 1024-byte boundary of the shared window, where
  // the swizzle patterns repeat.
  uint8_t* const smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* const empty = full + kStages;

  const int m_tiles = (M + kBM - 1) / kBM;
  const int n_tiles = (N + kBN - 1) / kBN;
  const int tiles = m_tiles * n_tiles;
  const int k_tiles = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs) : "memory");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int m0, n0;
        tile_coords(t, m_tiles, n_tiles, m0, n0);
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* const st = smem + stage * kStageBytes;
          mbar_expect(&full[stage], kStageBytes);
          tma_load(st, &x_map, kt * kBK, m0, &full[stage]);
          tma_load(st + kABytes, &wb_map, kt * kBK, n0, &full[stage]);
          tma_load(st + kABytes + kBBytes, &ws_map, kt * kBK, n0, &full[stage]);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs) : "memory");
    const int wg = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    // This thread's A elements of a k8 step kk: rows r0 and r0 + 8 of the
    // tile, columns t4 and t4 + 4 of the step. In the swizzled tile the
    // 16-byte chunk c of row r lies at chunk c ^ (r & 7), the same for
    // both rows.
    const int r0 = wg * 64 + warp * 16 + g;
    const uint32_t a_base = r0 * kRowBytes + t4 * 4;
    const uint32_t sw = r0 & 7;

    int stage = 0;
    uint32_t phase = 0;
    uint32_t a_big[2][4], a_small[2][4];
    // The tensor cores add into their accumulator without rounding to
    // nearest, so each k-tile's products go to a fresh one of the pair
    // acc[kt & 1], which is added into `total` (fp32 adds) while the next
    // k-tile's products run.
    float acc[2][kAcc], total[kAcc];
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int m0, n0;
      tile_coords(t, m_tiles, n_tiles, m0, n0);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) total[i] = 0.0f;
      int prev = 0;
      for (int kt0 = 0; kt0 < k_tiles; kt0 += 2) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int kt = kt0 + q;
          if (kt < k_tiles) {
            mbar_wait(&full[stage], phase);
            const uint8_t* const st = smem + stage * kStageBytes;
            const uint64_t desc_big = wgmma_desc(st + kABytes);
            const uint64_t desc_small = wgmma_desc(st + kABytes + kBBytes);
#pragma unroll
            for (int kk = 0; kk < kSteps; ++kk) {
              const int b = kk & 1;
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const uint32_t chunk = (2 * kk + (i >> 1)) ^ sw;
                const float x = *reinterpret_cast<const float*>(
                    st + a_base + (chunk << 4) + (i & 1) * 8 * kRowBytes);
                a_big[b][i] = tf32_rna(x);
                a_small[b][i] = tf32_rna(x - __uint_as_float(a_big[b][i]));
              }
              wgmma_fence();
              // k8 step kk is 32 bytes into each row: 2 units of the address.
              wgmma_tf32(acc[q], a_small[b], desc_big + 2 * kk, kk > 0);
              wgmma_tf32(acc[q], a_big[b], desc_small + 2 * kk, 1);
              wgmma_tf32(acc[q], a_big[b], desc_big + 2 * kk, 1);
              wgmma_commit();
              // The step before is done: its split may be overwritten.
              wgmma_wait<1>();
              if (kk == 0 && kt > 0) {
                // So is the k-tile before: its sums join the total, and
                // its stage is free.
                fence_acc(acc[q ^ 1]);
#pragma unroll
                for (int i = 0; i < kAcc; ++i) total[i] += acc[q ^ 1][i];
                if (lane == 0) mbar_arrive(&empty[prev]);
              }
            }
            prev = stage;
            if (++stage == kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
      wgmma_wait<0>();
      if ((k_tiles - 1) & 1) {
        fence_acc(acc[1]);
#pragma unroll
        for (int i = 0; i < kAcc; ++i) total[i] += acc[1][i];
      } else {
        fence_acc(acc[0]);
#pragma unroll
        for (int i = 0; i < kAcc; ++i) total[i] += acc[0][i];
      }
      if (lane == 0) mbar_arrive(&empty[prev]);

      // total[4 j + 2 h + e]: row r0 + 8 h, column 8 j + 2 t4 + e of the tile.
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t4;
        if (col < N) {
          const float2 bj = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + r0 + 8 * h;
            if (row < M) {
              float v0 = total[4 * j + 2 * h] + bj.x;
              float v1 = total[4 * j + 2 * h + 1] + bj.y;
              const size_t at = static_cast<size_t>(row) * N + col;
              if (kEpi == kGelu) {
                v0 = gelu_erf(v0);
                v1 = gelu_erf(v1);
              } else if (kEpi == kResidual) {
                const float2 r = __ldg(reinterpret_cast<const float2*>(residual + at));
                v0 += r.x;
                v1 += r.y;
              }
              *reinterpret_cast<float2*>(out + at) = make_float2(v0, v1);
            }
          }
        }
      }
    }
  }
}

// big = tf32_rna(w), small = tf32_rna(w - big), four floats a thread-step.
__global__ void split_kernel(const float4* __restrict__ w, float4* __restrict__ big,
                             float4* __restrict__ small, long long n4) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float4 v = w[i];
    float4 b, s;
    b.x = __uint_as_float(tf32_rna(v.x));
    b.y = __uint_as_float(tf32_rna(v.y));
    b.z = __uint_as_float(tf32_rna(v.z));
    b.w = __uint_as_float(tf32_rna(v.w));
    s.x = __uint_as_float(tf32_rna(v.x - b.x));
    s.y = __uint_as_float(tf32_rna(v.y - b.y));
    s.z = __uint_as_float(tf32_rna(v.z - b.z));
    s.w = __uint_as_float(tf32_rna(v.w - b.w));
    big[i] = b;
    small[i] = s;
  }
}

// ---- host side ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                              cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess) return err;
    if (status != cudaDriverEntryPointSuccess || ptr == nullptr) return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiled>(ptr);
  }
  *fn = cached;
  return cudaSuccess;
}

// A (rows, K) fp32 row-major matrix, in boxes of box_rows x kBK.
cudaError_t tensor_map(CUtensorMap* map, const float* base, int rows, int K, int box_rows) {
  EncodeTiled encode = nullptr;
  const cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * sizeof(float)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// SMs of the current device, and the kernels' shared-memory limit raised
// once a device.
cudaError_t prepare(int* sms) {
  static int cached[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && cached[dev] > 0) {
    *sms = cached[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(linear_kernel<kNone>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(linear_kernel<kGelu>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(linear_kernel<kResidual>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  if (dev < 64) cached[dev] = *sms;
  return cudaSuccess;
}

}  // namespace

// big, small = the TF32 split of n floats of w (n a multiple of 4, every
// pointer 16-byte aligned).
extern "C" int poco_tf32_split(const float* w, float* big, float* small, long long n,
                               cudaStream_t stream) {
  if (n < 0 || n % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  int sms = 0;
  const cudaError_t err = prepare(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n4 = n / 4;
  const long long want = (n4 + 255) / 256;
  const int blocks = static_cast<int>(want < 8LL * sms ? want : 8LL * sms);
  split_kernel<<<blocks, 256, 0, stream>>>(reinterpret_cast<const float4*>(w),
                                           reinterpret_cast<float4*>(big),
                                           reinterpret_cast<float4*>(small), n4);
  return static_cast<int>(cudaGetLastError());
}

// out (M, N) = epilogue(x (M, K) @ w^T + bias), w given as its TF32 split
// (N, K). epilogue: 0 none, 1 GELU (erf), 2 + residual (M, N). K a
// multiple of 4 and N of 2; x, w_big and w_small 16-byte aligned, the
// rest 8-byte aligned.
extern "C" int poco_linear_3xtf32(const float* x, const float* w_big, const float* w_small,
                                  const float* bias, const float* residual, float* out, int M,
                                  int N, int K, int epilogue, cudaStream_t stream) {
  if (M < 0 || N <= 0 || K <= 0 || K % 4 != 0 || N % 2 != 0 || epilogue < 0 || epilogue > 2 ||
      (epilogue == kResidual) != (residual != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0) return 0;
  int sms = 0;
  cudaError_t err = prepare(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap x_map, wb_map, ws_map;
  err = tensor_map(&x_map, x, M, K, kBM);
  if (err == cudaSuccess) err = tensor_map(&wb_map, w_big, N, K, kBN);
  if (err == cudaSuccess) err = tensor_map(&ws_map, w_small, N, K, kBN);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles =
      static_cast<long long>((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  const int blocks = static_cast<int>(tiles < sms ? tiles : sms);
  switch (epilogue) {
    case kNone:
      linear_kernel<kNone><<<blocks, kThreads, kSmemBytes, stream>>>(
          x_map, wb_map, ws_map, bias, residual, out, M, N, K);
      break;
    case kGelu:
      linear_kernel<kGelu><<<blocks, kThreads, kSmemBytes, stream>>>(
          x_map, wb_map, ws_map, bias, residual, out, M, N, K);
      break;
    default:
      linear_kernel<kResidual><<<blocks, kThreads, kSmemBytes, stream>>>(
          x_map, wb_map, ws_map, bias, residual, out, M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}
