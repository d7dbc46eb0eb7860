// Backward of SMPL linear-blend skinning for NVIDIA Hopper (sm_90a), fp32.
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
// gradient.
//
// Two passes and no atomics, so every sum runs in one fixed order and the
// same inputs give bit-identical gradients (a resumed training step must
// repeat the uninterrupted one):
// 1. grad_pass, one block per (chunk of 256 vertices, sample), one thread
//    per vertex. The thread forms the 9 entries of T that the gradient of
//    v_posed needs from its 24 weights and the sample's transforms (rows
//    0-2, staged in shared memory), writes grad_v_posed, and stages its
//    weights and its 12 products g[x] * p[y] in shared memory. The block
//    then forms the chunk's 24 x 12 partial sum W^T E, one entry a thread
//    in a fixed order over the chunk's vertices, into scratch.
// 2. reduce_pass, one block per sample, one thread per entry of the
//    (24, 4, 4) gradient: the chunks' partial sums added in order.
//
// Bound on an H100 SXM at B=64, V=6890: the kernel must move W 0.66 MB +
// the transforms 0.10 MB + v_posed, g and grad_v_posed 3 x 5.29 MB +
// grad_tfms 0.10 MB = 16.7 MB (5.0 us at 3.35 TB/s). Its two products are
// GEMM-shaped, the 24 x 9 blend of T and the 24 x 12 W^T E: on the fastest
// engine that keeps fp32 accuracy, the tensor cores with a 3xTF32 split,
// they take 2.9 us, plus 9 + 12 fp32 operations a (vertex, sample), so the
// bound is the bytes' 5.0 us (all in fp32 FMA the work would take 6.9 us
// at 67 TFLOP/s). This first version keeps the work simple, all in fp32
// FMA: the block reduction reads both operands from shared memory (2 loads
// an FMA), and 32 of 256 threads take two of the 288 entries; making it
// fast is later work (PERF.md has its times).
//
// Plain C interface for ctypes: the launch returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kJoints = 24;
constexpr int kUsed = 12;                     // rows 0-2 of a row-major 4x4
constexpr int kChunk = 256;                   // vertices a block, threads a block
constexpr int kPartial = kJoints * kUsed;     // entries of a chunk's partial sum
constexpr int kReduceThreads = kJoints * 16;  // one per entry of a (24, 4, 4) gradient

__global__ void __launch_bounds__(kChunk)
grad_pass(const float* __restrict__ weights,    // (V, 24)
          const float* __restrict__ tfms,       // (B, 24, 4, 4)
          const float* __restrict__ v_posed,    // (B, V, 3)
          const float* __restrict__ grad_out,   // (B, V, 3)
          float* __restrict__ grad_v_posed,     // (B, V, 3)
          float* __restrict__ partial,          // (B, chunks, 24 * 12)
          int num_verts, int num_chunks) {
  __shared__ float tfm_s[kJoints * kUsed];
  // rows padded by one float: row strides 25 and 13 are odd, so a warp's
  // stores of one column fall in 32 distinct banks
  __shared__ float w_s[kChunk][kJoints + 1];
  __shared__ float e_s[kChunk][kUsed + 1];

  const int b = blockIdx.y;
  const int chunk = blockIdx.x;
  const int t = threadIdx.x;
  for (int i = t; i < kJoints * kUsed; i += kChunk) {
    tfm_s[i] = tfms[((size_t)b * kJoints + i / kUsed) * 16 + i % kUsed];
  }
  __syncthreads();

  const int v = chunk * kChunk + t;
  if (v < num_verts) {
    float w[kJoints];
#pragma unroll
    for (int j = 0; j < kJoints; ++j) {
      w[j] = __ldg(weights + (size_t)v * kJoints + j);
      w_s[t][j] = w[j];
    }
    float tm[9];
#pragma unroll
    for (int e = 0; e < 9; ++e) tm[e] = 0.0f;
#pragma unroll
    for (int j = 0; j < kJoints; ++j) {
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int col = 0; col < 3; ++col) {
          tm[r * 3 + col] = fmaf(w[j], tfm_s[j * kUsed + r * 4 + col], tm[r * 3 + col]);
        }
      }
    }
    const size_t base = ((size_t)b * num_verts + v) * 3;
    const float g[3] = {grad_out[base], grad_out[base + 1], grad_out[base + 2]};
    const float p[4] = {v_posed[base], v_posed[base + 1], v_posed[base + 2], 1.0f};
#pragma unroll
    for (int col = 0; col < 3; ++col) {
      grad_v_posed[base + col] =
          fmaf(tm[col], g[0], fmaf(tm[3 + col], g[1], tm[6 + col] * g[2]));
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int col = 0; col < 4; ++col) e_s[t][r * 4 + col] = g[r] * p[col];
    }
  } else {
    // the ragged chunk: vertices past V add nothing
#pragma unroll
    for (int j = 0; j < kJoints; ++j) w_s[t][j] = 0.0f;
#pragma unroll
    for (int e = 0; e < kUsed; ++e) e_s[t][e] = 0.0f;
  }
  __syncthreads();

  float* out = partial + ((size_t)b * num_chunks + chunk) * kPartial;
  for (int o = t; o < kPartial; o += kChunk) {
    const int j = o / kUsed;
    const int e = o % kUsed;
    float s = 0.0f;
    for (int u = 0; u < kChunk; ++u) s = fmaf(w_s[u][j], e_s[u][e], s);
    out[o] = s;
  }
}

__global__ void __launch_bounds__(kReduceThreads)
reduce_pass(const float* __restrict__ partial,  // (B, chunks, 24 * 12)
            float* __restrict__ grad_tfms,      // (B, 24, 4, 4)
            int num_chunks) {
  const int b = blockIdx.x;
  const int o = threadIdx.x;
  const int j = o / 16;
  const int e = o % 16;
  float s = 0.0f;
  if (e < kUsed) {
    const float* src = partial + (size_t)b * num_chunks * kPartial + j * kUsed + e;
    for (int c = 0; c < num_chunks; ++c) s += src[(size_t)c * kPartial];
  }
  grad_tfms[(size_t)b * kJoints * 16 + o] = s;
}

}  // namespace

// Vertices a block reduces: the caller sizes the partial-sum scratch,
// (B, ceil(V / chunk), 24 * 12) floats, from it.
extern "C" int poco_skinning_backward_chunk_simt() { return kChunk; }

extern "C" int poco_skinning_backward_f32_simt(const float* weights, const float* tfms,
                                          const float* v_posed, const float* grad_out,
                                          float* grad_v_posed, float* grad_tfms,
                                          float* partial, int batch, int num_verts,
                                          int num_joints, cudaStream_t stream) {
  if (num_joints != kJoints || batch < 0 || num_verts < 0 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  const int num_chunks = (num_verts + kChunk - 1) / kChunk;
  if (num_chunks > 0) {
    grad_pass<<<dim3(num_chunks, batch), kChunk, 0, stream>>>(
        weights, tfms, v_posed, grad_out, grad_v_posed, partial, num_verts, num_chunks);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  reduce_pass<<<batch, kReduceThreads, 0, stream>>>(partial, grad_tfms, num_chunks);
  return static_cast<int>(cudaGetLastError());
}
