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
// K3 forms each scatter term as (2*g2[j]) * (x2[j] - x1[i]) like the plain
// version and adds a point's terms in ascending j from 0.0f, the order of
// an explicit loop, so its output is bit-equal to that loop on the host
// and repeats exactly from run to run. The scatter term is a segmented sum,
// O(n + m) per cloud: each block owns a range of `keys` points i of one
// cloud and reads all of that cloud's idx2, 2048 at a time, eight per
// thread; the j whose idx2[j] falls in its range are compacted in ascending
// j (warp ballots, then one scan of the 64 warp counts) with x2[j] and
// 2*g2[j], and the segmented sum of csrc/segment_sum.cuh (K5's) adds them
// to their points' running sums. The gather term is one read of
// x2[idx1[i]] per point. An idx2 outside [0, n) falls in no block's range;
// an idx1 outside [0, m) gives NaN in that point's output instead of a
// stray read.
//
// What bounds it on Hopper: the bytes (each input read once) would take
// 0.002 ms at [64, 2048^2]; the pass is bound by the latency of its steps
// (the idx2 loads, the compaction's barriers, the peels' atomics and
// barriers), so the launcher splits each cloud into blocks of 128-2048
// points, enough for ~4 blocks per SM, or one block per cloud where the
// clouds alone fill the SMs: 16, 8 and 1 per cloud at [24, 64, 250] x
// 2048^2 (the splits timed on the H100: PERF.md). Each block reads the
// cloud's idx2 (8 KB at 2048 points) and only the x2 and g2 of its own j.
// On the H100 it takes 0.006, 0.009 and 0.021 ms there (torch.profiler;
// the wrapper's host time, ~0.03 ms a call, is longer), where the masked
// O(n*m) scan it replaced (one thread per i over every j) took 0.047, 0.076
// and 0.28 ms.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

#include "segment_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads;  // K4: points per staged tile
constexpr unsigned kFull = 0xffffffffu;

// K3
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                  // idx2 entries a thread reads per stage
constexpr int kStage = kThreads * kPer;  // j per stage
constexpr int kMaxKeys = 2048;           // points i per block, at most

// Dynamic shared memory of a K3 block that owns `keys` points.
size_t grad1_smem(int keys) {
  return kStage * (sizeof(float4) + sizeof(int)) + keys * 8 * sizeof(float) +
         (kPer * kWarps + 1) * sizeof(int);
}

__global__ void __launch_bounds__(kThreads)
grad1_kernel(const float* __restrict__ xyz1, const float* __restrict__ xyz2,
             const int* __restrict__ idx1, const int* __restrict__ idx2,
             const float* __restrict__ g1, const float* __restrict__ g2,
             float* __restrict__ out, int n, int m, int keys, int blocks_per_cloud) {
  extern __shared__ float4 smem[];
  float4* list = smem;  // [kStage]: the stage's j in range: x2[j], 2*g2[j] in .w
  int* list_key = reinterpret_cast<int*>(list + kStage);    // [kStage]: idx2[j] - k0
  float* kx = reinterpret_cast<float*>(list_key + kStage);  // [keys] each: x1[i]
  float* ky = kx + keys;
  float* kz = ky + keys;
  float* sx = kz + keys;  // [keys] each: the running sums
  float* sy = sx + keys;
  float* sz = sy + keys;
  int* bid = reinterpret_cast<int*>(sz + keys);  // [2][keys]
  int* offs = bid + 2 * keys;  // [kPer * kWarps + 1]: warp counts, offsets, total

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int cloud = blockIdx.x / blocks_per_cloud;
  const int k0 = (blockIdx.x % blocks_per_cloud) * keys;
  const int nk = min(keys, n - k0);
  const size_t row1 = static_cast<size_t>(cloud) * n + k0;
  const size_t row2 = static_cast<size_t>(cloud) * m;
  const float* x2 = xyz2 + row2 * 3;

  for (int k = tid; k < nk; k += kThreads) {
    kx[k] = xyz1[(row1 + k) * 3];
    ky[k] = xyz1[(row1 + k) * 3 + 1];
    kz[k] = xyz1[(row1 + k) * 3 + 2];
    sx[k] = sy[k] = sz[k] = 0.f;
    bid[k] = bid[keys + k] = INT_MAX;
  }
  for (int j0 = 0; j0 < m; j0 += kStage) {
    // compact the stage's j with idx2[j] - k0 in [0, nk), in ascending j
    int key[kPer];
    unsigned in[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int j = j0 + r * kThreads + tid;
      key[r] = j < m ? idx2[row2 + j] - k0 : -1;
    }
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      in[r] = __ballot_sync(kFull, static_cast<unsigned>(key[r]) < static_cast<unsigned>(nk));
      if (lane == 0) offs[r * kWarps + warp] = __popc(in[r]);
    }
    __syncthreads();  // the counts are in, and the previous stage's rounds are done
    if (warp == 0) {  // exclusive scan of the counts in (r, warp) order: ascending j
      const int a = offs[2 * lane], c = offs[2 * lane + 1];
      int incl = a + c;
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += v;
      }
      offs[2 * lane] = incl - a - c;
      offs[2 * lane + 1] = incl - c;
      if (lane == 31) offs[kPer * kWarps] = incl;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      if ((in[r] >> lane) & 1u) {
        const int pos = offs[r * kWarps + warp] + __popc(in[r] & ((1u << lane) - 1u));
        const int j = j0 + r * kThreads + tid;
        list[pos] = make_float4(x2[3 * j], x2[3 * j + 1], x2[3 * j + 2],
                                __fmul_rn(2.f, g2[row2 + j]));
        list_key[pos] = key[r];
      }
    }
    __syncthreads();
    const int count = offs[kPer * kWarps];
    for (int r0 = 0; r0 < count; r0 += kThreads) {
      const int e = r0 + tid;
      const int slot = e < count ? list_key[e] : -1 - lane;
      gat_segment_round(slot, bid, keys, [&](int s, unsigned grp) {
        const float px = kx[s], py = ky[s], pz = kz[s];
        float ax = sx[s], ay = sy[s], az = sz[s];
        for (unsigned g = grp; g != 0u; g &= g - 1u) {
          const float4 p = list[r0 + warp * 32 + __ffs(g) - 1];
          ax = __fadd_rn(ax, __fmul_rn(p.w, __fsub_rn(p.x, px)));
          ay = __fadd_rn(ay, __fmul_rn(p.w, __fsub_rn(p.y, py)));
          az = __fadd_rn(az, __fmul_rn(p.w, __fsub_rn(p.z, pz)));
        }
        sx[s] = ax;
        sy[s] = ay;
        sz[s] = az;
      });
    }
  }
  __syncthreads();
  for (int k = tid; k < nk; k += kThreads) {
    // the gather term 2*g1*(x1 - x2[idx1]), less the scatter term
    const size_t i = row1 + k;
    const int j = idx1[i];
    const float g = __fmul_rn(2.f, g1[i]);
    float tx = CUDART_NAN_F, ty = CUDART_NAN_F, tz = CUDART_NAN_F;
    if (j >= 0 && j < m) {
      tx = __fmul_rn(g, __fsub_rn(kx[k], x2[3 * j]));
      ty = __fmul_rn(g, __fsub_rn(ky[k], x2[3 * j + 1]));
      tz = __fmul_rn(g, __fsub_rn(kz[k], x2[3 * j + 2]));
    }
    out[i * 3] = __fsub_rn(tx, sx[k]);
    out[i * 3 + 1] = __fsub_rn(ty, sy[k]);
    out[i * 3 + 2] = __fsub_rn(tz, sz[k]);
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

// K3's points per block: one block per cloud where the clouds alone give
// every SM a block (more would take a second wave); else enough blocks to
// give every SM kBlocksPerSm, rounded up to whole warps, at least kMinKeys.
constexpr int kBlocksPerSm = 4;
constexpr int kMinKeys = 128;

int grad1_keys(int b, int n) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int per_cloud = b >= sms ? 1 : (kBlocksPerSm * sms + b - 1) / b;
  const int keys = ((n + per_cloud - 1) / per_cloud + 31) / 32 * 32;
  return keys < kMinKeys ? kMinKeys : (keys > kMaxKeys ? kMaxKeys : keys);
}

}  // namespace

// Both entries launch on `stream` and return a cudaError_t (0 = launched).
extern "C" int gat_chamfer_grad1(const float* xyz1, const float* xyz2,
                                 const int* idx1, const int* idx2,
                                 const float* g1, const float* g2, float* out,
                                 int b, int n, int m, void* stream) {
  static const cudaError_t ready = cudaFuncSetAttribute(
      grad1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(grad1_smem(kMaxKeys)));
  if (ready != cudaSuccess) return static_cast<int>(ready);
  const int keys = grad1_keys(b, n);
  const int blocks_per_cloud = (n + keys - 1) / keys;
  const dim3 grid(static_cast<unsigned>(b) * blocks_per_cloud);
  grad1_kernel<<<grid, kThreads, grad1_smem(keys), static_cast<cudaStream_t>(stream)>>>(
      xyz1, xyz2, idx1, idx2, g1, g2, out, n, m, keys, blocks_per_cloud);
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
