// One nearest-neighbour direction with exact bounding-sphere pruning over
// Morton-sorted blocks of the other cloud.
//
// Replaces the TPU kernel
//   geometric_adv_tpu/ops/pallas/chamfer_hier_kernel.py::_nn_direction_hier
//     (_hier_kernel)                                  -> gat_nn_direction_hier
// reached through nn_direction_sorted and nn_distance_hier. The preparation
// (Morton codes, the stable sort, the block spheres and the seeded upper
// bounds) is torch code in geometric_adv_tpu_torch/ops/chamfer_hier.py.
//
// Contract (f32 unless noted, contiguous):
//   x [b, n, 3]   query points, in any order (Morton-sorted: tiles coherent)
//   ub [b, n]     a true upper bound on each query's NN distance
//   y [b, m, 3]   the other cloud, Morton-sorted
//   oy [b, m]     int32, the original id of each sorted y point
//   cyr [b, nb, 4] per block of kBlock sorted y points (nb = ceil(m/kBlock)):
//                 centre and inflated radius of a sphere holding the block
//   dist [b, n]   min_j |x - y_j|^2 over all y
//   idx [b, n]    int32, the smallest ORIGINAL id attaining it (may be null)
//
// Design: one block of kThreads threads per (cloud, kThreads-point x tile).
// For each y block the thread of point x computes the lower bound
//   lb = max(0, sqrt(|x - c|^2) - r)^2 * (1 - 1e-5) - 1e-12
// and the block votes with __syncthreads_or(lb <= cur): the y block is staged
// into shared memory and scanned only where some point of the tile needs it.
// The test is '<=', never '<', so a point at exactly the running distance is
// still examined for the id tie. The running distance starts at ub and the
// index at 2^30; a closer point takes over, an equal one keeps the lower
// original id (the TPU kernel's tie rule, chamfer_hier_kernel.py:227-231).
// Because lb <= d(x, p) for every p of the block, a skipped block never holds
// the argmin: the result is exact, bit-equal to K1 with the same indices.
// Ragged edges are masked, not padded: an x past n votes no and writes
// nothing; the last y block holds m - (nb-1)*kBlock points.
// Distances come from gat_sq_dist (sqdist.cuh), as in K1.
//
// What bounds it: the distance scan of the blocks that are not pruned (K1's
// FP32 work times the share of blocks scanned), plus one sqrt per point and
// block and one block-wide vote per block. The vote is per tile, so one
// point far from its neighbours keeps a block in for the whole tile.

#include <cuda_runtime.h>

#include "sqdist.cuh"

namespace {

constexpr int kThreads = 128;  // query points per block (the x tile)
constexpr int kBlock = 128;    // y points per bounding sphere
constexpr int kBigIdx = 1 << 30;

__global__ void __launch_bounds__(kThreads)
hier_kernel(const float* __restrict__ x, const float* __restrict__ ub,
            const float* __restrict__ y, const int* __restrict__ oy,
            const float4* __restrict__ cyr, float* __restrict__ dist,
            int* __restrict__ idx, int n, int m, int nb, int tiles_per_cloud) {
  __shared__ float4 tile[kBlock];
  __shared__ int tile_id[kBlock];
  // the float32 values of the JAX package's _LB_MARGIN and _ABS_MARGIN
  const float lb_margin = static_cast<float>(1.0 - 1e-5);
  const float abs_margin = static_cast<float>(1e-12);

  const int cloud = blockIdx.x / tiles_per_cloud;
  const int i = (blockIdx.x % tiles_per_cloud) * kThreads + threadIdx.x;
  const bool active = i < n;
  const size_t row1 = static_cast<size_t>(cloud) * n;
  const size_t row2 = static_cast<size_t>(cloud) * m;
  const float* yc = y + row2 * 3;
  const float4* spheres = cyr + static_cast<size_t>(cloud) * nb;

  float px = 0.f, py = 0.f, pz = 0.f, cur = 0.f;
  if (active) {
    px = x[(row1 + i) * 3];
    py = x[(row1 + i) * 3 + 1];
    pz = x[(row1 + i) * 3 + 2];
    cur = ub[row1 + i];
  }
  int icur = kBigIdx;

  for (int jb = 0; jb < nb; ++jb) {
    bool need = false;
    if (active) {
      const float4 c = spheres[jb];
      const float dc = gat_sq_dist(px, py, pz, c.x, c.y, c.z);
      const float gap = fmaxf(__fsub_rn(__fsqrt_rn(dc), c.w), 0.f);
      const float lb = __fsub_rn(__fmul_rn(__fmul_rn(gap, gap), lb_margin), abs_margin);
      need = lb <= cur;
    }
    // a barrier too: every thread is done scanning the previous block
    if (!__syncthreads_or(need)) continue;
    const int base = jb * kBlock;
    const int count = min(kBlock, m - base);
    if (threadIdx.x < count) {
      const float* p = yc + static_cast<size_t>(base + threadIdx.x) * 3;
      tile[threadIdx.x] = make_float4(p[0], p[1], p[2], 0.f);
      tile_id[threadIdx.x] = oy[row2 + base + threadIdx.x];
    }
    __syncthreads();
    if (active) {
#pragma unroll 8
      for (int j = 0; j < count; ++j) {
        const float4 p = tile[j];
        const float d = gat_sq_dist(px, py, pz, p.x, p.y, p.z);
        if (d < cur) {
          cur = d;
          icur = tile_id[j];
        } else if (d == cur) {
          icur = min(icur, tile_id[j]);
        }
      }
    }
  }
  if (active) {
    dist[row1 + i] = cur;
    if (idx != nullptr) idx[row1 + i] = icur;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched). `idx`
// may be null (distances only).
extern "C" int gat_nn_direction_hier(const float* x, const float* ub,
                                     const float* y, const int* oy,
                                     const float* cyr, float* dist, int* idx,
                                     int b, int n, int m, void* stream) {
  const int tiles_per_cloud = (n + kThreads - 1) / kThreads;
  const int nb = (m + kBlock - 1) / kBlock;
  const dim3 grid(static_cast<unsigned>(b) * tiles_per_cloud);
  hier_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, ub, y, oy, reinterpret_cast<const float4*>(cyr), dist, idx, n, m, nb,
      tiles_per_cloud);
  return static_cast<int>(cudaGetLastError());
}
