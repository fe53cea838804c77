// Nearest-neighbour squared distances (and first-index argmin) between two
// batched point clouds, one direction per launch.
//
// Replaces the TPU kernels
//   geometric_adv_tpu/ops/pallas/chamfer_kernel_v2.py::nn_distance_pallas_v2
//     (_nn_kernel_v2: distances + argmin)                    -> gat_nn_distance
//   geometric_adv_tpu/ops/pallas/chamfer_kernel_v2.py::nn_distance_values_pallas
//     (_nn_values_kernel_v2: distances only)          -> gat_nn_distance_values
//
// Contract: query [b, n, 3] f32, other [b, m, 3] f32 (both contiguous)
//   dist[b, n] = min_j |query[i] - other[j]|^2
//   idx[b, n]  = the smallest j attaining that minimum (int32)
// The caller swaps the two clouds for the second direction, as the
// reference's tf_nndistance_g.cu does.
//
// Numerics: each distance is gat_sq_dist (sqdist.cuh), ((dx*dx) + (dy*dy))
// + (dz*dz) in round-to-nearest f32 with no FMA contraction. The plain
// PyTorch version (geometric_adv_tpu_torch/ops/chamfer.py::pairwise_sqdist)
// evaluates the same expression in the same order, so the minima are
// bit-equal and the argmin ties resolve identically.
//
// gat_nn_distance is also the first launch of K5 (chamfer_payloads.cu),
// which takes its column direction from it.
//
// What bounds it on Hopper: n*m distance evaluations per direction, about ten
// f32 ALU instructions each, against 12 bytes read per staged point. Every
// point staged in shared memory is reused by all kThreads query threads of
// the block, so device-memory traffic is ~1/kThreads of the ALU work and the
// kernel is bound by FP32 instruction throughput. Design:
//   - one thread owns one query point and keeps its running min in registers;
//   - the block stages the other cloud through shared memory in tiles of
//     kTile points, in ascending index order, as float4 so each pair costs a
//     single broadcast shared-memory load;
//   - the running minimum is updated with a strict '<' while j ascends, which
//     yields the first index on ties with no reduction across threads or
//     blocks;
//   - the ragged edges (n or m not a multiple of the tile) are masked, never
//     padded: inactive threads still help stage tiles but write nothing.
// The TPU kernel's sequential grid, its 1e9 coordinate padding and its
// packed-row layout answer TPU constraints and are not carried over.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "sqdist.cuh"

namespace {

constexpr int kThreads = 256;  // query points per block
constexpr int kTile = kThreads;  // other-cloud points per shared-memory tile

template <bool kWithIndex>
__global__ void __launch_bounds__(kThreads)
nn_kernel(const float* __restrict__ query, const float* __restrict__ other,
          float* __restrict__ dist, int* __restrict__ idx, int n, int m,
          int blocks_per_cloud) {
  __shared__ float4 tile[kTile];

  const int cloud = blockIdx.x / blocks_per_cloud;
  const int i = (blockIdx.x % blocks_per_cloud) * kThreads + threadIdx.x;
  const bool active = i < n;
  const float* q = query + static_cast<size_t>(cloud) * n * 3;
  const float* o = other + static_cast<size_t>(cloud) * m * 3;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = q[3 * i];
    qy = q[3 * i + 1];
    qz = q[3 * i + 2];
  }
  float best = CUDART_INF_F;
  int best_j = 0;

  for (int base = 0; base < m; base += kTile) {
    const int count = min(kTile, m - base);
    __syncthreads();  // every thread is done with the previous tile
    if (threadIdx.x < count) {
      const float* p = o + static_cast<size_t>(base + threadIdx.x) * 3;
      tile[threadIdx.x] = make_float4(p[0], p[1], p[2], 0.f);
    }
    __syncthreads();
    if (active) {
#pragma unroll 8
      for (int j = 0; j < count; ++j) {
        const float4 p = tile[j];
        const float d = gat_sq_dist(qx, qy, qz, p.x, p.y, p.z);
        if (d < best) {
          best = d;
          if (kWithIndex) best_j = base + j;
        }
      }
    }
  }
  if (active) {
    dist[static_cast<size_t>(cloud) * n + i] = best;
    if (kWithIndex) idx[static_cast<size_t>(cloud) * n + i] = best_j;
  }
}

template <bool kWithIndex>
int launch(const float* query, const float* other, float* dist, int* idx,
           int b, int n, int m, void* stream) {
  const int blocks_per_cloud = (n + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(b) * blocks_per_cloud);
  nn_kernel<kWithIndex><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      query, other, dist, idx, n, m, blocks_per_cloud);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entries launch on `stream` and return cudaGetLastError() (0 = launched).
extern "C" int gat_nn_distance(const float* query, const float* other,
                               float* dist, int* idx, int b, int n, int m,
                               void* stream) {
  return launch<true>(query, other, dist, idx, b, n, m, stream);
}

extern "C" int gat_nn_distance_values(const float* query, const float* other,
                                      float* dist, int b, int n, int m,
                                      void* stream) {
  return launch<false>(query, other, dist, nullptr, b, n, m, stream);
}
