// Gradient of nn_distance with respect to its first cloud, two kernels.
//
// Replaces the TPU kernels
//   geometric_adv_tpu/ops/pallas/chamfer_bwd_kernel.py::chamfer_grad1_pallas
//     (_bwd_kernel, K3)                                  -> gat_chamfer_grad1
//   geometric_adv_tpu/ops/pallas/chamfer_bwd_kernel.py::chamfer_grad1_pallas_vpu
//     (_bwd_vpu_kernel, K4)                          -> gat_chamfer_grad1_vpu
// gat_chamfer_grad1 gives the exact-f32, fixed-order semantics of the TPU
// pair; gat_chamfer_grad1_vpu keeps K4's own algebra (below). The two round
// differently and each is held against its own plain version.
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

// K4: the same contract in the TPU kernel's masked-reduction algebra
// (chamfer_bwd_kernel.py:156-209, combined at :288-294): with w[j] =
// 2*g2[j], one thread per point i accumulates over every j
//   gath = sum_{j == idx1[i]} x2[j]      (the gather as a masked sum)
//   sc   = sum_{idx2[j] == i} w[j]*x2[j]
//   cnt  = sum_{idx2[j] == i} w[j]
// and writes (2*g1[i]*(x1[i] - gath) - sc) + x1[i]*cnt. x1 is factored out
// of the scatter term, so x1*cnt - sc cancels where the two are close; the
// error is measured against K4's plain version (PERF.md). The staged tiles
// carry (x2[j], w[j]) and (w[j]*x2[j], idx2[j]); sums run in ascending j.
// An idx1 entry outside [0, m) matches no j and gathers 0.
// What bounds it: two integer compares per pair over all n*m pairs (the
// gather is a masked reduction too), ~1/3 of K1's ALU work per pair.
__global__ void __launch_bounds__(kThreads)
grad1_vpu_kernel(const float* __restrict__ xyz1, const float* __restrict__ xyz2,
                 const int* __restrict__ idx1, const int* __restrict__ idx2,
                 const float* __restrict__ g1, const float* __restrict__ g2,
                 float* __restrict__ out, int n, int m, int blocks_per_cloud) {
  __shared__ float4 tile_pt[kTile];  // x2[j] in xyz, w[j] in w
  __shared__ float4 tile_sc[kTile];  // w[j]*x2[j] in xyz, idx2[j]'s bits in w

  const int cloud = blockIdx.x / blocks_per_cloud;
  const int i = (blockIdx.x % blocks_per_cloud) * kThreads + threadIdx.x;
  const bool active = i < n;
  const size_t row1 = static_cast<size_t>(cloud) * n;
  const size_t row2 = static_cast<size_t>(cloud) * m;
  const float* x2 = xyz2 + row2 * 3;

  float px = 0.f, py = 0.f, pz = 0.f;
  int k = -1;
  if (active) {
    px = xyz1[(row1 + i) * 3];
    py = xyz1[(row1 + i) * 3 + 1];
    pz = xyz1[(row1 + i) * 3 + 2];
    k = idx1[row1 + i];
  }

  float gx = 0.f, gy = 0.f, gz = 0.f;  // gath
  float sx = 0.f, sy = 0.f, sz = 0.f;  // sc
  float cnt = 0.f;
  for (int base = 0; base < m; base += kTile) {
    const int count = min(kTile, m - base);
    __syncthreads();
    if (threadIdx.x < count) {
      const int j = base + threadIdx.x;
      const float w = __fmul_rn(2.f, g2[row2 + j]);
      const float ax = x2[3 * j], ay = x2[3 * j + 1], az = x2[3 * j + 2];
      tile_pt[threadIdx.x] = make_float4(ax, ay, az, w);
      tile_sc[threadIdx.x] = make_float4(__fmul_rn(ax, w), __fmul_rn(ay, w),
                                         __fmul_rn(az, w),
                                         __int_as_float(idx2[row2 + j]));
    }
    __syncthreads();
    if (active) {
#pragma unroll 8
      for (int j = 0; j < count; ++j) {
        if (base + j == k) {
          const float4 p = tile_pt[j];
          gx = __fadd_rn(gx, p.x);
          gy = __fadd_rn(gy, p.y);
          gz = __fadd_rn(gz, p.z);
        }
        const float4 s = tile_sc[j];
        if (__float_as_int(s.w) == i) {
          sx = __fadd_rn(sx, s.x);
          sy = __fadd_rn(sy, s.y);
          sz = __fadd_rn(sz, s.z);
          cnt = __fadd_rn(cnt, tile_pt[j].w);
        }
      }
    }
  }
  if (active) {
    const float g = __fmul_rn(2.f, g1[row1 + i]);
    out[(row1 + i) * 3] =
        __fadd_rn(__fsub_rn(__fmul_rn(g, __fsub_rn(px, gx)), sx), __fmul_rn(px, cnt));
    out[(row1 + i) * 3 + 1] =
        __fadd_rn(__fsub_rn(__fmul_rn(g, __fsub_rn(py, gy)), sy), __fmul_rn(py, cnt));
    out[(row1 + i) * 3 + 2] =
        __fadd_rn(__fsub_rn(__fmul_rn(g, __fsub_rn(pz, gz)), sz), __fmul_rn(pz, cnt));
  }
}

}  // namespace

// Both entries launch on `stream` and return cudaGetLastError() (0 = launched).
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

extern "C" int gat_chamfer_grad1_vpu(const float* xyz1, const float* xyz2,
                                     const int* idx1, const int* idx2,
                                     const float* g1, const float* g2, float* out,
                                     int b, int n, int m, void* stream) {
  const int blocks_per_cloud = (n + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(b) * blocks_per_cloud);
  grad1_vpu_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xyz1, xyz2, idx1, idx2, g1, g2, out, n, m, blocks_per_cloud);
  return static_cast<int>(cudaGetLastError());
}
