// Gradient of nn_distance with respect to its first cloud.
//
// Replaces the TPU kernel
//   geometric_adv_tpu/ops/pallas/chamfer_bwd_kernel.py::chamfer_grad1_pallas
//     (_bwd_kernel)                                      -> gat_chamfer_grad1
// with the exact-f32, fixed-order semantics of its twin
// chamfer_grad1_pallas_vpu.
//
// Contract: xyz1 [b, n, 3], xyz2 [b, m, 3], idx1 [b, n] int32,
// idx2 [b, m] int32, g1 [b, n], g2 [b, m] (f32 unless noted, contiguous):
//   out[i] = 2*g1[i]*(x1[i] - x2[idx1[i]])
//            - sum_{j: idx2[j] == i} 2*g2[j]*(x2[j] - x1[i])        [b, n, 3]
// the reference scatter-add backward (tf_nndistance.cpp:130-163). The
// caller swaps the arguments to get the gradient of the second cloud.
//
// The scatter term uses the identity of chamfer_bwd_kernel.py:10-13: a j with
// idx2[j] == i reads x1[idx2[j]] == x1[i], which the thread owning point i
// already holds in registers, so the scatter becomes a gather-free filtered
// sum and no atomics are needed. Each term is formed as (2*g2[j]) *
// (x2[j] - x1[i]) like the plain version and summed in ascending j, so the
// result is deterministic from run to run.
//
// What bounds it on Hopper: the filtered sum visits all m entries of
// (idx2, g2, x2) for each of the n points, one integer compare per pair, so
// it is O(n*m) like the forward but with about a third of its ALU work per
// pair; device memory sees each staged entry once per block of kThreads
// points. The gather term is one read of x2[idx1[i]] per point. Design:
// one thread per point i, the other cloud's (x2, 2*g2, idx2) staged through
// shared memory in ascending tiles, ragged edges masked. An idx1 entry outside
// [0, m) gives NaN in that point's output instead of a stray read.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads;

__global__ void __launch_bounds__(kThreads)
grad1_kernel(const float* __restrict__ xyz1, const float* __restrict__ xyz2,
             const int* __restrict__ idx1, const int* __restrict__ idx2,
             const float* __restrict__ g1, const float* __restrict__ g2,
             float* __restrict__ out, int n, int m, int blocks_per_cloud) {
  __shared__ float4 tile_pt[kTile];  // x2[j] in xyz, 2*g2[j] in w
  __shared__ int tile_idx[kTile];

  const int cloud = blockIdx.x / blocks_per_cloud;
  const int i = (blockIdx.x % blocks_per_cloud) * kThreads + threadIdx.x;
  const bool active = i < n;
  const size_t row1 = static_cast<size_t>(cloud) * n;
  const size_t row2 = static_cast<size_t>(cloud) * m;
  const float* x2 = xyz2 + row2 * 3;

  float px = 0.f, py = 0.f, pz = 0.f;
  float tx = 0.f, ty = 0.f, tz = 0.f;  // the gather term 2*g1*(x1 - x2[idx1])
  if (active) {
    px = xyz1[(row1 + i) * 3];
    py = xyz1[(row1 + i) * 3 + 1];
    pz = xyz1[(row1 + i) * 3 + 2];
    const int k = idx1[row1 + i];
    const float g = __fmul_rn(2.f, g1[row1 + i]);
    if (k >= 0 && k < m) {
      tx = __fmul_rn(g, __fsub_rn(px, x2[3 * k]));
      ty = __fmul_rn(g, __fsub_rn(py, x2[3 * k + 1]));
      tz = __fmul_rn(g, __fsub_rn(pz, x2[3 * k + 2]));
    } else {
      tx = ty = tz = CUDART_NAN_F;
    }
  }

  float sx = 0.f, sy = 0.f, sz = 0.f;  // the scatter term
  for (int base = 0; base < m; base += kTile) {
    const int count = min(kTile, m - base);
    __syncthreads();
    if (threadIdx.x < count) {
      const int j = base + threadIdx.x;
      tile_pt[threadIdx.x] = make_float4(x2[3 * j], x2[3 * j + 1], x2[3 * j + 2],
                                         __fmul_rn(2.f, g2[row2 + j]));
      tile_idx[threadIdx.x] = idx2[row2 + j];
    }
    __syncthreads();
    if (active) {
#pragma unroll 8
      for (int j = 0; j < count; ++j) {
        if (tile_idx[j] == i) {
          const float4 p = tile_pt[j];
          sx = __fadd_rn(sx, __fmul_rn(p.w, __fsub_rn(p.x, px)));
          sy = __fadd_rn(sy, __fmul_rn(p.w, __fsub_rn(p.y, py)));
          sz = __fadd_rn(sz, __fmul_rn(p.w, __fsub_rn(p.z, pz)));
        }
      }
    }
  }
  if (active) {
    out[(row1 + i) * 3] = __fsub_rn(tx, sx);
    out[(row1 + i) * 3 + 1] = __fsub_rn(ty, sy);
    out[(row1 + i) * 3 + 2] = __fsub_rn(tz, sz);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int gat_chamfer_grad1(const float* xyz1, const float* xyz2,
                                 const int* idx1, const int* idx2,
                                 const float* g1, const float* g2, float* out,
                                 int b, int n, int m, void* stream) {
  const int blocks_per_cloud = (n + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(b) * blocks_per_cloud);
  grad1_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xyz1, xyz2, idx1, idx2, g1, g2, out, n, m, blocks_per_cloud);
  return static_cast<int>(cudaGetLastError());
}
