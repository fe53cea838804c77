// Nearest-neighbour squared distances (and first-index argmin) between two
// batched point clouds, both directions in one pass over the distance plane.
//
// Replaces the TPU kernels
//   geometric_adv_tpu/ops/pallas/chamfer_kernel_v2.py::nn_distance_pallas_v2
//     (_nn_kernel_v2: distances + argmin)                    -> gat_nn_distance
//   geometric_adv_tpu/ops/pallas/chamfer_kernel_v2.py::nn_distance_values_pallas
//     (_nn_values_kernel_v2: distances only)          -> gat_nn_distance_values
//
// Contract: x1 [b, n, 3] f32, x2 [b, m, 3] f32 (both contiguous)
//   d1[b, n] = min_j |x1[i] - x2[j]|^2,  i1[b, n] = the smallest such j
//   d2[b, m] = min_i |x1[i] - x2[j]|^2,  i2[b, m] = the smallest such i
// (int32 indices). gat_nn_distance is also the first launch of K5
// (chamfer_payloads.cu).
//
// Numerics: each distance is gat_sq_dist (sqdist.cuh), ((dx*dx) + (dy*dy))
// + (dz*dz) in round-to-nearest f32 with no FMA contraction; (x - y)^2 is
// exactly (y - x)^2, so one evaluation serves both directions, and the
// minima are bit-equal to the plain PyTorch version's
// (geometric_adv_tpu_torch/ops/chamfer.py::pairwise_sqdist). Every argmin is
// the first index, and no combine depends on the order in which threads,
// warps or blocks arrive (see below), so a run repeats bit for bit.
//
// What bounds it on Hopper: n*m distance evaluations of 8 FP32 instructions
// (no FMA: the plain version rounds every product and sum) and a minimum per
// direction, 10 issue slots per pair at the least; each staged byte is
// reused by a whole block, so it is bound by instruction issue (chip_smoke.py
// counts the 10 FP32 operations per pair against the card's FP32 peak) and,
// next, by the shared-memory atomics that merge the column partials. A
// design that formed every distance twice (one launch per direction) and
// issued a shared-memory load per pair took ~24 issue slots per pair. By
// cuobjdump -sass of this file's build, the hot loop issues 10.7 slots per
// pair in K2 (342 per step of 32 pairs a lane: 256 FADD/FMUL, 71 FMNMX,
// 4 LDS, 4 ATOMS) and 12.2 in K1 (781 per two steps: the row's step
// select, the column combine's shuffles and one atomic); -Xptxas -v: K1 80
// registers and one 4-byte spill, K2 72 registers; 3 blocks of 8 warps per
// SM. The design:
//   - one pass: a row group of 8 rows (x1 points) is held in registers by
//     each of its lanes; each lane takes kC = 4 staged columns (x2 points)
//     per step, so a 16-byte broadcast load serves 8 pairs. A row's minimum
//     over the lane's columns stays in registers for the whole sweep, the
//     column minimum over the group's 8 rows is complete in the lane;
//   - the argmins leave the hot loop: a row records the step that held its
//     minimum (a compare and two selects per 4 pairs); after the sweep the
//     rows' minima are reduced across the lanes transposed (8 rows in 7
//     shuffles over K1's 8 lanes, not 24; in 9 over K2's 32, not 40), and
//     the one lane holding a row's minimum gives the
//     step in which its first column attaining it is recomputed (4
//     distances per row, not 4 per row and lane); exact ties across lanes
//     take the full lexicographic (d, j) reduction;
//   - a column's partial over the block's rows is merged in shared memory
//     with an atomic minimum: of its bits alone for K2 (d >= 0, so the
//     unsigned order is the float order and the native 32-bit atomic
//     serves), of the 64-bit key (d bits, 8-row group) for K1, whose
//     unsigned order is lexicographic, so the first group attaining the
//     minimum wins whatever the warps' order. Hopper has no native 64-bit
//     shared minimum: it is a compare-and-swap loop, and the atomics are the
//     second bound (timed on the H100 at [64, 2048^2] with K1's earlier
//     layout: the loop cost 0.200 ms against 0.168 with a 32-bit atomic that
//     keeps no index, and a second 32-bit atomic per column 0.218). So K1
//     splits each warp into 4 lane groups of 8 lanes that hold 4 row groups
//     over the same columns, combines their column partials with 3 shuffles
//     per lane and step, and issues one atomic where it would issue four:
//     0.200 -> 0.175 ms (0.183 with 2 groups). K2 keeps one group per warp,
//     whose cheap atomic the shuffles do not repay (0.141 -> 0.147 ms with
//     4 groups). The warps of a block never wait for each other inside a
//     tile: no barrier per tile. After the sweep the winning group's 8 rows
//     are recomputed for the first row attaining the column's minimum;
//   - the column partials of the blocks that split one cloud's rows are
//     combined in one launch through distributed shared memory, in a
//     thread-block cluster per cloud (cooperative_groups::this_cluster,
//     map_shared_rank): the 24-pair attack path is bound by launches, so a
//     second pass, or a device-memory scratch buffer with its init (the
//     64-bit atomic alternative), would cost a launch or a memset per call.
//     A cluster holds up to 8 blocks (the portable size), never more than
//     row tiles (K1 256 rows, K2 64). A block loops over its row tiles
//     (rank, rank + K, ...), whose points it keeps staged in shared memory
//     where they fit. Clusters of 16 blocks, 21 of which the card holds at
//     once, were no faster at [24, 2048^2] (K2 0.0607 ms against 0.0604)
//     nor at [64] (0.143 against 0.141). At [24, 2048^2] K1 runs 192
//     blocks of 8 warps, 11.6 warps per SM: 128-thread blocks in clusters of
//     16 (384 blocks, 2-3 per SM) measured 0.080 ms against 0.077, 2 lane
//     groups (23 warps per SM) 0.080, so the warps' count is not what holds
//     it back;
//   - the other cloud is staged in chunks of up to 2048 points (32 KB,
//     loaded once per chunk and reused by every tile, so not
//     double-buffered); a row's minimum over earlier chunks is kept in d1/i1
//     and combined at the end of each chunk, so any n and m are taken. Per-
//     warp column partials without atomics need 1024-point chunks to fit 3
//     blocks per SM, and the twice as frequent row epilogue made them 17%
//     slower;
//   - ragged edges are clamped, not masked: a row or column past the end is
//     a copy of the last one, with its index, so it can only repeat that
//     point's candidate; nothing is written for it.
// The TPU kernel's sequential grid, its 1e9 coordinate padding and its
// packed-row layout answer TPU constraints and are not carried over.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "sqdist.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kR = 8;               // rows per row group, held by each of its lanes
constexpr int kC = 4;               // columns per lane and step
constexpr int kMaxChunk = 2048;     // staged x2 points
constexpr int kStagedRows = 512;    // x1 points a block keeps staged
constexpr int kMaxCluster = 8;     // blocks per cloud (the portable cluster size)
constexpr unsigned kFull = 0xffffffffu;

// The launch geometry of K1 (kIdx) and K2.
template <bool kIdx>
struct Geometry {
  static constexpr int kGroups = kIdx ? 4 : 1;           // row groups per warp
  static constexpr int kLanes = 32 / kGroups;            // lanes per row group
  static constexpr int kTileRows = kWarps * kGroups * kR;  // x1 points per block tile
  static constexpr int kStepCols = kLanes * kC;          // x2 points per step
};

__host__ __device__ constexpr size_t smem_bytes(int chunk) {
  // staged x2 points, staged x1 points, the column partials (one 64-bit key)
  return static_cast<size_t>(chunk) * (sizeof(float4) + sizeof(unsigned long long)) +
         kStagedRows * sizeof(float4);
}

__device__ __forceinline__ bool lex_less(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// A column partial: the minimum's bits above the index of the first 8-row
// group attaining it (d >= 0, so the unsigned order is (d, group)).
__device__ __forceinline__ unsigned long long col_key(float d, int group) {
  return (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
         static_cast<unsigned>(group);
}

// One level of K1's column combine across the lane groups `off` lanes apart:
// of the 2 * kHalf column partials (d, group) in cm/gv, this lane keeps the
// upper half if `hi`, else the lower, each merged with the partner's partial
// of the same column (lexicographic: the lower group keeps ties), into
// cm/gv[0, kHalf). Returns the first kept column's offset (kHalf or 0).
template <int kHalf>
__device__ __forceinline__ int combine_columns(float* cm, int* gv, bool hi, int off) {
#pragma unroll
  for (int c = 0; c < kHalf; ++c) {
    const float got = __shfl_xor_sync(kFull, hi ? cm[c] : cm[c + kHalf], off);
    const int gg = __shfl_xor_sync(kFull, hi ? gv[c] : gv[c + kHalf], off);
    const float keep = hi ? cm[c + kHalf] : cm[c];
    const int kg = hi ? gv[c + kHalf] : gv[c];
    const bool take = lex_less(got, gg, keep, kg);
    cm[c] = take ? got : keep;
    gv[c] = take ? gg : kg;
  }
  return hi ? kHalf : 0;
}

// Merge a row's (d, i) over earlier chunks, which hold earlier columns and
// so keep ties, and store it.
template <bool kIdx>
__device__ __forceinline__ void store_row(float* d1, int* i1, size_t at, int base, float d,
                                          int i) {
  if (base > 0) {
    const float pd = d1[at];
    if (!(d < pd)) {
      d = pd;
      if (kIdx) i = i1[at];
    }
  }
  d1[at] = d;
  if (kIdx) i1[at] = i;
}

template <bool kIdx>
__global__ void __launch_bounds__(kThreads, 3)
nn_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
          float* __restrict__ d1, int* __restrict__ i1,
          float* __restrict__ d2, int* __restrict__ i2, int n, int m, int chunk) {
  using G = Geometry<kIdx>;
  constexpr int kGroups = G::kGroups, kLanes = G::kLanes;
  constexpr int kTileRows = G::kTileRows, kStepCols = G::kStepCols;
  constexpr unsigned kGroupMask = kLanes == 32 ? kFull : (1u << kLanes) - 1u;
  extern __shared__ float4 smem[];
  float4* pts = smem;                       // [chunk]
  float4* rows = pts + chunk;               // [kStagedRows]
  unsigned long long* colkey = reinterpret_cast<unsigned long long*>(rows + kStagedRows);
  unsigned* colbits = reinterpret_cast<unsigned*>(colkey);  // values only: [chunk]

  cg::cluster_group cluster = cg::this_cluster();
  const int nblocks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int cloud = blockIdx.x / nblocks;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int sub = lane / kLanes;  // the lane's row group within the warp
  const int gl = lane % kLanes;   // its lane within the group
  const float* q = x1 + static_cast<size_t>(cloud) * n * 3;
  const float* o = x2 + static_cast<size_t>(cloud) * m * 3;
  const size_t row_out = static_cast<size_t>(cloud) * n;
  const size_t col_out = static_cast<size_t>(cloud) * m;
  const int tiles = (n + kTileRows - 1) / kTileRows;
  const int my_tiles = (tiles - rank + nblocks - 1) / nblocks;  // rank, rank + K, ...
  // this block's rows stay in shared memory where they fit (every shape the
  // port meets); else each tile reads its rows from device memory
  const bool staged = my_tiles * kTileRows <= kStagedRows;
  if (staged) {
    for (int k = tid; k < my_tiles * kTileRows; k += kThreads) {
      const int row = min((rank + (k / kTileRows) * nblocks) * kTileRows + k % kTileRows, n - 1);
      rows[k] = make_float4(q[3 * row], q[3 * row + 1], q[3 * row + 2], 0.f);
    }
  }

  for (int base = 0; base < m; base += chunk) {
    const int cols = min(chunk, m - base);
    const int steps = (cols + kStepCols - 1) / kStepCols;
    for (int k = tid; k < steps * kStepCols; k += kThreads) {
      const int j = min(base + k, m - 1);
      pts[k] = make_float4(o[3 * j], o[3 * j + 1], o[3 * j + 2], 0.f);
      if (kIdx) {
        colkey[k] = ~0ull;
      } else {
        colbits[k] = ~0u;
      }
    }
    __syncthreads();

    // each row group owns 8 rows of each of the block's tiles: no barrier
    for (int l = 0; l < my_tiles; ++l) {
      const int group = ((rank + l * nblocks) * kWarps + warp) * kGroups + sub;  // rows group*8 ...
      float rx[kR], ry[kR], rz[kR], rb[kR];
      int rs[kR];  // the step of the row's best candidate
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (staged) {
          const float4 p = rows[l * kTileRows + (warp * kGroups + sub) * kR + r];
          rx[r] = p.x;
          ry[r] = p.y;
          rz[r] = p.z;
        } else {
          const int row = min(group * kR + r, n - 1);
          rx[r] = q[3 * row];
          ry[r] = q[3 * row + 1];
          rz[r] = q[3 * row + 2];
        }
        rb[r] = CUDART_INF_F;
        rs[r] = 0;
      }

      // (unrolled twice with the argmin: measured 2% faster there)
#pragma unroll(kIdx ? 2 : 1)
      for (int s = 0; s < steps; ++s) {
        float4 p[kC];
        float cm[kC];
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          p[c] = pts[s * kStepCols + c * kLanes + gl];
          cm[c] = CUDART_INF_F;
        }
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          float dm = CUDART_INF_F;
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            const float d = gat_sq_dist(rx[r], ry[r], rz[r], p[c].x, p[c].y, p[c].z);
            dm = fminf(dm, d);
            cm[c] = fminf(cm[c], d);
          }
          if (kIdx) {
            if (dm < rb[r]) {  // steps ascend: the first step keeps ties
              rb[r] = dm;
              rs[r] = s;
            }
          } else {
            rb[r] = fminf(rb[r], dm);
          }
        }
        if constexpr (kIdx) {
          // the warp's 4 row groups' minima of the same columns, combined
          // transposed (each lane ends with one column, the lower group
          // keeping ties), then one atomic minimum of the 64-bit key
          static_assert(kGroups == 4 && kC == 4, "two combine levels");
          int gv[kC] = {group, group, group, group};
          const int col = combine_columns<2>(cm, gv, lane & 16, 16) +
                          combine_columns<1>(cm, gv, lane & 8, 8);
          atomicMin(&colkey[s * kStepCols + col * kLanes + gl], col_key(cm[0], gv[0]));
        } else {
          // the group's column minima into the block's partials: an atomic
          // minimum, so the warps' order does not matter
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            atomicMin(&colbits[s * kStepCols + c * kLanes + gl], __float_as_uint(cm[c]));
          }
        }
      }

      // the rows' minima across the group's lanes, transposed: 8 rows halve
      // to 4, 2, 1 per lane over three shuffle levels, then the last levels
      // reduce one; lane gl ends with row gl / (kLanes / 8)'s minimum
      float t;
      {
        constexpr int o1 = kLanes / 2, o2 = kLanes / 4, o3 = kLanes / 8;
        const bool b1 = gl & o1, b2 = gl & o2, b3 = gl & o3;
        float w[4], u[2];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float got = __shfl_xor_sync(kFull, b1 ? rb[k] : rb[k + 4], o1);
          w[k] = fminf(b1 ? rb[k + 4] : rb[k], got);
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float got = __shfl_xor_sync(kFull, b2 ? w[k] : w[k + 2], o2);
          u[k] = fminf(b2 ? w[k + 2] : w[k], got);
        }
        t = fminf(b3 ? u[1] : u[0], __shfl_xor_sync(kFull, b3 ? u[0] : u[1], o3));
#pragma unroll
        for (int off = o3 / 2; off >= 1; off >>= 1) t = fminf(t, __shfl_xor_sync(kFull, t, off));
      }
      if constexpr (!kIdx) {
        const int row = group * kR + gl / (kLanes / 8);
        if (gl % (kLanes / 8) == 0 && row < n) {
          store_row<false>(d1, i1, row_out + row, base, t, 0);
        }
      } else {
        // lane gl < 8 takes row gl: the one lane of its group holding the row's
        // minimum gives the step, in which the first of that lane's columns
        // attaining it is the index. A tie across lanes (the same minimum in
        // two lanes) takes the full reduction below, for the whole warp.
        bool tied = false;
        float my_d = 0.f, mx = 0.f, my = 0.f, mz = 0.f;
        int my_lane = 0, my_step = 0;
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float dr = __shfl_sync(kFull, t, r * (kLanes / 8), kLanes);
          const unsigned holders = __ballot_sync(kFull, rb[r] == dr);
          const unsigned mine = (holders >> (sub * kLanes)) & kGroupMask;
#pragma unroll
          for (int g = 0; g < kGroups; ++g) {
            const unsigned in_g = (holders >> (g * kLanes)) & kGroupMask;
            tied |= (in_g & (in_g - 1u)) != 0u;
          }
          const int holder = __ffs(mine) - 1;
          const int step = __shfl_sync(kFull, rs[r], holder, kLanes);
          if ((gl & (kR - 1)) == r) {
            my_d = dr;
            my_lane = holder;
            my_step = step;
            mx = rx[r];
            my = ry[r];
            mz = rz[r];
          }
        }
        if (!tied) {
          int i = 0;
#pragma unroll
          for (int c = kC - 1; c >= 0; --c) {
            const int k = my_step * kStepCols + c * kLanes + my_lane;
            const float4 p = pts[k];
            if (gat_sq_dist(mx, my, mz, p.x, p.y, p.z) == my_d || c == kC - 1) {
              i = min(base + k, m - 1);
            }
          }
          const int row = group * kR + gl;
          if (gl < kR && row < n) store_row<true>(d1, i1, row_out + row, base, my_d, i);
          continue;
        }
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          // every lane's first column attaining its minimum (recomputed from
          // the step that held it), combined lexicographically (columns
          // interleave across the lanes)
          float d = rb[r];
          int i = 0;
#pragma unroll
          for (int c = kC - 1; c >= 0; --c) {
            const int k = rs[r] * kStepCols + c * kLanes + gl;
            const float4 p = pts[k];
            if (gat_sq_dist(rx[r], ry[r], rz[r], p.x, p.y, p.z) == d || c == kC - 1) {
              i = min(base + k, m - 1);
            }
          }
#pragma unroll
          for (int off = 1; off < kLanes; off <<= 1) {
            const float od = __shfl_xor_sync(kFull, d, off);
            const int oi = __shfl_xor_sync(kFull, i, off);
            if (lex_less(od, oi, d, i)) {
              d = od;
              i = oi;
            }
          }
          const int row = group * kR + r;
          if (gl == r && row < n) store_row<true>(d1, i1, row_out + row, base, d, i);
        }
      }
    }

    // the column minima over the cloud's rows: the blocks' partials, through
    // distributed shared memory (the unsigned minimum of the keys is the
    // lexicographic one); the argmin is the first row of the winning group
    // that attains the minimum, recomputed
    cluster.sync();
    for (int k = rank * kThreads + tid; k < cols; k += nblocks * kThreads) {
      if (kIdx) {
        unsigned long long key = ~0ull;
#pragma unroll
        for (int b = 0; b < kMaxCluster; ++b) {
          if (b < nblocks) key = min(key, cluster.map_shared_rank(colkey, b)[k]);
        }
        const float d = __uint_as_float(static_cast<unsigned>(key >> 32));
        const int g = static_cast<int>(key & 0xffffffffu);
        const float4 p = pts[k];
        int i = min(g * kR + kR - 1, n - 1);
#pragma unroll
        for (int r = kR - 1; r >= 0; --r) {
          const int row = min(g * kR + r, n - 1);
          if (gat_sq_dist(q[3 * row], q[3 * row + 1], q[3 * row + 2], p.x, p.y, p.z) == d) i = row;
        }
        d2[col_out + base + k] = d;
        i2[col_out + base + k] = i;
      } else {
        unsigned bits = ~0u;
#pragma unroll
        for (int b = 0; b < kMaxCluster; ++b) {
          if (b < nblocks) bits = min(bits, cluster.map_shared_rank(colbits, b)[k]);
        }
        d2[col_out + base + k] = __uint_as_float(bits);
      }
    }
    cluster.sync();  // no block restages or exits while another reads it
  }
}

template <bool kIdx>
cudaError_t prepare() {
  static const cudaError_t err = cudaFuncSetAttribute(
      nn_kernel<kIdx>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(kMaxChunk)));
  return err;
}

// One launch over [b, n, 3] x [b, m, 3]: a cluster of up to kMaxCluster
// blocks per cloud, never more than its row tiles, block `rank` taking the
// tiles rank, rank + cluster, ...; x2 staged in chunks of whole steps, at
// most kMaxChunk points.
template <bool kIdx>
int launch(const float* x1, const float* x2, float* d1, int* i1, float* d2, int* i2,
           int b, int n, int m, void* stream) {
  cudaError_t err = prepare<kIdx>();
  if (err != cudaSuccess) return static_cast<int>(err);
  using G = Geometry<kIdx>;
  if (b < 1 || n < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int cluster = min(kMaxCluster, (n + G::kTileRows - 1) / G::kTileRows);
  const int chunk = min(kMaxChunk, (m + G::kStepCols - 1) / G::kStepCols * G::kStepCols);
  if (static_cast<long long>(b) * cluster > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(cluster);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(b) * static_cast<unsigned>(cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(chunk);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, nn_kernel<kIdx>, x1, x2, d1, i1, d2, i2, n, m, chunk);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entries launch once on `stream` and return cudaGetLastError()
// (0 = launched).
extern "C" int gat_nn_distance(const float* x1, const float* x2, float* d1, int* i1,
                               float* d2, int* i2, int b, int n, int m, void* stream) {
  return launch<true>(x1, x2, d1, i1, d2, i2, b, n, m, stream);
}

extern "C" int gat_nn_distance_values(const float* x1, const float* x2, float* d1,
                                      float* d2, int b, int n, int m, void* stream) {
  return launch<false>(x1, x2, d1, nullptr, d2, nullptr, b, n, m, stream);
}
