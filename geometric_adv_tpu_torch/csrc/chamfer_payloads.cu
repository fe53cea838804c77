// The fused chamfer loss's forward: both nearest-neighbour directions and the
// gradient payloads of the per-cloud loss, in one call.
//
// Replaces the TPU kernel
//   geometric_adv_tpu/ops/pallas/chamfer_loss_kernel.py::chamfer_loss_payloads
//     (_loss_kernel, _loss_kernel_2n)              -> gat_chamfer_loss_payloads
//
// Contract: x1 [b, n, 3] f32, x2 [b, m, 3] f32 (contiguous)
//   d1[b, n], i1[b, n] (int32), d2[b, m], i2[b, m] (int32): nn_distance's
//   nn1[b, n, 3]  = x2[i1[i]]
//   snn1[b, n, 3] = sum_{j: i2[j] == i} x2[j]
//   cnt1[b, n]    = #{j: i2[j] == i} (f32)
// With these the gradient of mean(d1) + mean(d2) wrt x1 is elementwise
// (ops/chamfer.py::_ChamferPerPcFused.backward).
//
// Design, two launches on the caller's stream:
//   1. the column direction (d2, i2): K1's kernel (gat_nn_distance in
//      nn_distance.cu) with the clouds swapped;
//   2. one thread per x1 point i walks x2 through shared memory in ascending
//      tiles, with (x2[j], i2[j]) staged together. In the same sweep it keeps
//      the running minimum and first-index argmin with the coordinates of the
//      current best (that is nn1: no second gather), and the filtered sum of
//      x2[j] and the count over the j with i2[j] == i -- K3's no-atomics
//      pattern (chamfer_grad.cu), summed in ascending j, so deterministic.
// Distances come from gat_sq_dist (sqdist.cuh) with the same strict '<' in
// ascending j as K1, so d1, i1, d2 and i2 are bit-equal to K1's outputs and
// nn1 bit-equal to x2[i1]. The kernel takes any n and m: the frozen attack's
// payloads run it at every size; the fused loss's gate (n <= 2048,
// ops/chamfer.py::_fused_loss_shape_ok) is routing.
// The TPU kernel's 2^23-biased index lane (its payload block is f32), its
// MXU payload variant, its 2-subtile split of n and its 1e9 padding answer
// TPU constraints and are not carried over: ragged edges are masked.
//
// What bounds it on Hopper: like K1, n*m distance evaluations per direction
// at ~10 f32 ALU instructions each, plus in launch 2 one integer compare per
// pair and the select of the best point's coordinates; every staged point is
// reused by all kThreads threads of the block, so it is bound by FP32
// instruction throughput.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "sqdist.cuh"

extern "C" int gat_nn_distance(const float* query, const float* other,
                               float* dist, int* idx, int b, int n, int m,
                               void* stream);

namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads;

__global__ void __launch_bounds__(kThreads)
payload_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
               const int* __restrict__ i2, float* __restrict__ d1,
               int* __restrict__ i1, float* __restrict__ nn1,
               float* __restrict__ snn1, float* __restrict__ cnt1, int n, int m,
               int blocks_per_cloud) {
  __shared__ float4 tile_pt[kTile];
  __shared__ int tile_idx[kTile];

  const int cloud = blockIdx.x / blocks_per_cloud;
  const int i = (blockIdx.x % blocks_per_cloud) * kThreads + threadIdx.x;
  const bool active = i < n;
  const size_t row1 = static_cast<size_t>(cloud) * n;
  const size_t row2 = static_cast<size_t>(cloud) * m;
  const float* o = x2 + row2 * 3;

  float px = 0.f, py = 0.f, pz = 0.f;
  if (active) {
    px = x1[(row1 + i) * 3];
    py = x1[(row1 + i) * 3 + 1];
    pz = x1[(row1 + i) * 3 + 2];
  }
  float best = CUDART_INF_F;
  int best_j = 0;
  float bx = 0.f, by = 0.f, bz = 0.f;  // x2[best_j]
  float sx = 0.f, sy = 0.f, sz = 0.f, cnt = 0.f;

  for (int base = 0; base < m; base += kTile) {
    const int count = min(kTile, m - base);
    __syncthreads();  // every thread is done with the previous tile
    if (threadIdx.x < count) {
      const int j = base + threadIdx.x;
      tile_pt[threadIdx.x] = make_float4(o[3 * j], o[3 * j + 1], o[3 * j + 2], 0.f);
      tile_idx[threadIdx.x] = i2[row2 + j];
    }
    __syncthreads();
    if (active) {
#pragma unroll 8
      for (int j = 0; j < count; ++j) {
        const float4 p = tile_pt[j];
        const float d = gat_sq_dist(px, py, pz, p.x, p.y, p.z);
        if (d < best) {
          best = d;
          best_j = base + j;
          bx = p.x;
          by = p.y;
          bz = p.z;
        }
        if (tile_idx[j] == i) {
          sx = __fadd_rn(sx, p.x);
          sy = __fadd_rn(sy, p.y);
          sz = __fadd_rn(sz, p.z);
          cnt = __fadd_rn(cnt, 1.f);
        }
      }
    }
  }
  if (active) {
    d1[row1 + i] = best;
    i1[row1 + i] = best_j;
    nn1[(row1 + i) * 3] = bx;
    nn1[(row1 + i) * 3 + 1] = by;
    nn1[(row1 + i) * 3 + 2] = bz;
    snn1[(row1 + i) * 3] = sx;
    snn1[(row1 + i) * 3 + 1] = sy;
    snn1[(row1 + i) * 3 + 2] = sz;
    cnt1[row1 + i] = cnt;
  }
}

}  // namespace

// Launches both kernels on `stream`; returns the first cudaError_t that is
// not 0 (0 = both launched).
extern "C" int gat_chamfer_loss_payloads(const float* x1, const float* x2,
                                         float* d1, int* i1, float* d2, int* i2,
                                         float* nn1, float* snn1, float* cnt1,
                                         int b, int n, int m, void* stream) {
  const int rc = gat_nn_distance(x2, x1, d2, i2, b, m, n, stream);
  if (rc != 0) return rc;
  const int blocks_per_cloud = (n + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(b) * blocks_per_cloud);
  payload_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x1, x2, i2, d1, i1, nn1, snn1, cnt1, n, m, blocks_per_cloud);
  return static_cast<int>(cudaGetLastError());
}
