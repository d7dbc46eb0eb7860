// Fused SMPL linear-blend skinning for NVIDIA Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel poco_tpu/ops/pallas_lbs.py: skinning_pallas /
// _skin_kernel (the pallas_call at pallas_lbs.py:87). For sample b and
// vertex v:
//
//     T[b, v] = sum_j W[v, j] * A[b, j]                    (4x4, j < 24)
//     out[b, v] = T[b, v, :3, :3] @ v_posed[b, v] + T[b, v, :3, 3]
//
// The plain formulation writes T, a (B, V, 16) tensor, to device memory
// and reads it back (56 MB at B=128, V=6890). Here T lives in registers:
// each thread owns one vertex, keeps its 24 weights in registers, forms
// only the 12 entries of T that the affine uses (rows 0-2) and writes 3
// floats. A block serves 256 vertices of up to kSamplesPerBlock samples,
// whose transforms (rows 0-2, 24 x 12 floats each) it stages in shared
// memory, so a vertex's weights are read once per block and not once per
// sample. v < V is masked, so V needs no padding to a tile.
//
// Bound on an H100 SXM at B=128, V=6890: it must move W 0.66 MB + A 0.20
// MB + v_posed 10.6 MB + out 10.6 MB = 22.0 MB (6.6 us at 3.35 TB/s), and
// do (24 * 12 * 2 + 18) * B * V = 0.52 GFLOP of fp32 FMA (7.8 us at 67
// TFLOP/s), so it is bound by fp32 operations at about 8 us. All math is
// fp32 FMA: the JAX path demands full fp32 (Precision.HIGHEST), so no
// TF32 tensor cores.
//
// Plain C interface for ctypes: the launch returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kJoints = 24;
constexpr int kUsed = 12;  // rows 0-2 of a row-major 4x4 transform
constexpr int kThreads = 256;
constexpr int kSamplesPerBlock = 4;

__global__ void __launch_bounds__(kThreads)
skin_kernel(const float* __restrict__ weights,   // (V, 24)
            const float* __restrict__ tfms,      // (B, 24, 4, 4)
            const float* __restrict__ v_posed,   // (B, V, 3)
            float* __restrict__ out,             // (B, V, 3)
            int batch, int num_verts) {
  __shared__ float tfm_s[kSamplesPerBlock][kJoints][kUsed];

  const int b0 = blockIdx.y * kSamplesPerBlock;
  const int nb = min(kSamplesPerBlock, batch - b0);
  for (int i = threadIdx.x; i < nb * kJoints * kUsed; i += kThreads) {
    const int s = i / (kJoints * kUsed);
    const int j = (i / kUsed) % kJoints;
    const int e = i % kUsed;
    tfm_s[s][j][e] = tfms[((size_t)(b0 + s) * kJoints + j) * 16 + e];
  }
  __syncthreads();

  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= num_verts) return;

  float w[kJoints];
#pragma unroll
  for (int j = 0; j < kJoints; ++j) w[j] = __ldg(weights + (size_t)v * kJoints + j);

  for (int s = 0; s < nb; ++s) {
    float t[kUsed];
#pragma unroll
    for (int e = 0; e < kUsed; ++e) t[e] = 0.0f;
#pragma unroll
    for (int j = 0; j < kJoints; ++j) {
#pragma unroll
      for (int e = 0; e < kUsed; ++e) t[e] = fmaf(w[j], tfm_s[s][j][e], t[e]);
    }
    const size_t base = ((size_t)(b0 + s) * num_verts + v) * 3;
    const float x = v_posed[base];
    const float y = v_posed[base + 1];
    const float z = v_posed[base + 2];
    out[base] = fmaf(t[0], x, fmaf(t[1], y, fmaf(t[2], z, t[3])));
    out[base + 1] = fmaf(t[4], x, fmaf(t[5], y, fmaf(t[6], z, t[7])));
    out[base + 2] = fmaf(t[8], x, fmaf(t[9], y, fmaf(t[10], z, t[11])));
  }
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
  const int blocks_y = (batch + kSamplesPerBlock - 1) / kSamplesPerBlock;
  if (blocks_y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((num_verts + kThreads - 1) / kThreads, blocks_y);
  skin_kernel<<<grid, kThreads, 0, stream>>>(weights, tfms, v_posed, out,
                                             batch, num_verts);
  return static_cast<int>(cudaGetLastError());
}
