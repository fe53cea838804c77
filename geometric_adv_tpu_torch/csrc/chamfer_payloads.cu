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
//   snn1[b, n, 3] = sum_{j: i2[j] == i} x2[j], summed in ascending j
//   cnt1[b, n]    = #{j: i2[j] == i} (f32)
// With these the gradient of mean(d1) + mean(d2) wrt x1 is elementwise
// (ops/chamfer.py::_ChamferPerPcFused.backward).
//
// Design, two launches on the caller's stream:
//   1. K1's kernel (gat_nn_distance in nn_distance.cu): d1, i1, d2, i2 in one
//      pass over the plane, so they are K1's outputs bit for bit;
//   2. payload_kernel, O(n + m) per cloud with no per-pair loop, one block
//      per cloud:
//      - nn1 = x2[i1], a gather (bit-equal to the selected point; keeping
//        the best point's coordinates beside the argmin in launch 1 would
//        cost three selects per pair);
//      - cnt1 and snn1 are a segmented sum over j grouped by i2[j], each i's
//        sum taken in ascending j from 0.0f, the order of an explicit loop
//        (and of the TPU kernel's masked sweep), so snn1 keeps its bits and runs repeat
//        exactly. The block takes j in rounds of 256, one per thread. In a
//        warp __match_any_sync groups the lanes with the same i2; across the
//        warps, the groups of one i are peeled in warp order: each group's
//        lowest lane bids its warp for i with a shared-memory atomic
//        minimum, and the winning warp's group adds its points to i's running
//        sum in lane order and its size to i's integer count. A round takes as
//        many peels as the most warps sharing one i (8 at most), each two
//        block barriers. This is the counting
//        sort's stable placement with the sums folded in: the segment
//        offsets are never needed, because each point is added where it would
//        be placed.
//      x2 and i2 are staged in shared memory, 2048 points at a time, and the
//      payloads of up to 2048 x1 points stay in shared memory; past that the
//      block takes x2 again for the next 2048 (the frozen payloads' 2500 x
//      2048 takes two passes).
// A launch 2 that swept the whole [n, m] plane again (the TPU kernel's
// workaround: no scatter) cost 1.8x a K1 direction.
// The kernel takes any n and m: the frozen attack's payloads run it at
// every size; the fused loss's gate (n <= 2048,
// ops/chamfer.py::_fused_loss_shape_ok) is routing.
// The TPU kernel's 2^23-biased index lane (its payload block is f32), its
// MXU payload variant, its 2-subtile split of n and its 1e9 padding answer
// TPU constraints and are not carried over.
//
// What bounds it on Hopper: launch 1, FP32 issue (see nn_distance.cu);
// launch 2 moves O(n + m) bytes and is bound by the latency of its rounds
// (staging, one match and a few barriers each; 48 registers, -Xptxas -v).
// A single warp walking j 32 at a time, the first design, took 0.031 ms per
// launch at [250, 2048^2] (torch.profiler); the rounds of the whole block
// cut K5 from 0.200 to 0.189 ms at [64, 2048^2] and from 0.102 to 0.092 at
// [24, 2048^2]. Where x2 clusters on three x1 points (segments of ~700 j)
// they cost 0.226 ms against the walk's 0.220. 512 or 1024 threads gained
// under 2% (timed on the H100 while this was written).

#include <climits>

#include <cuda_runtime.h>

extern "C" int gat_nn_distance(const float* x1, const float* x2, float* d1, int* i1,
                               float* d2, int* i2, int b, int n, int m, void* stream);

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 2048;   // x1 points whose payloads a pass keeps
constexpr int kStage = 2048;  // x2 points staged at a time
constexpr unsigned kFull = 0xffffffffu;
// staged points, the payloads' running sums and counts, two bid arrays
constexpr size_t kSmem = kStage * sizeof(float4) + kKeys * 4 * sizeof(float) +
                         2 * kKeys * sizeof(int);

__global__ void __launch_bounds__(kThreads)
payload_kernel(const float* __restrict__ x2, const int* __restrict__ i1,
               const int* __restrict__ i2, float* __restrict__ nn1,
               float* __restrict__ snn1, float* __restrict__ cnt1, int n, int m) {
  extern __shared__ float4 smem[];
  float4* pts = smem;  // [kStage]: x2[j] with i2[j] - k0 in .w (as int bits)
  float* sx = reinterpret_cast<float*>(pts + kStage);  // [kKeys] each
  float* sy = sx + kKeys;
  float* sz = sy + kKeys;
  int* cnt = reinterpret_cast<int*>(sz + kKeys);
  int* bid = cnt + kKeys;  // [2][kKeys]: the lowest warp holding each i, per peel parity

  const int cloud = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const float* o = x2 + static_cast<size_t>(cloud) * m * 3;
  const int* key = i2 + static_cast<size_t>(cloud) * m;
  const size_t row = static_cast<size_t>(cloud) * n;

#pragma unroll 4
  for (int i = tid; i < n; i += kThreads) {
    const int j = i1[row + i];
    nn1[(row + i) * 3] = o[3 * j];
    nn1[(row + i) * 3 + 1] = o[3 * j + 1];
    nn1[(row + i) * 3 + 2] = o[3 * j + 2];
  }

  for (int k0 = 0; k0 < n; k0 += kKeys) {
    const int nk = min(kKeys, n - k0);
    for (int k = tid; k < nk; k += kThreads) {
      sx[k] = 0.f;
      sy[k] = 0.f;
      sz[k] = 0.f;
      cnt[k] = 0;
      bid[k] = INT_MAX;
      bid[kKeys + k] = INT_MAX;
    }
    for (int j0 = 0; j0 < m; j0 += kStage) {
      const int nj = min(kStage, m - j0);
      __syncthreads();  // the previous stage's rounds (or the reset) are done
#pragma unroll 4
      for (int k = tid; k < nj; k += kThreads) {
        const int j = j0 + k;
        pts[k] = make_float4(o[3 * j], o[3 * j + 1], o[3 * j + 2],
                             __int_as_float(key[j] - k0));
      }
      __syncthreads();
      for (int r0 = 0; r0 < nj; r0 += kThreads) {
        const int t = r0 + tid;
        int slot = -1 - lane;  // a lane outside this pass stays alone
        if (t < nj) {
          const int k = __float_as_int(pts[t].w);
          if (k >= 0 && k < nk) slot = k;
        }
        const unsigned grp = __match_any_sync(kFull, slot);
        // the group's lowest lane carries it: its members in ascending lane = j
        bool pending = slot >= 0 && (grp & ((1u << lane) - 1u)) == 0u;
        // peel the groups of each i in warp order (warps hold ascending j);
        // a winner resets its bid, which a loser reading it late can not
        // mistake for its own warp
        for (int parity = 0; __syncthreads_or(pending); parity ^= 1) {
          int* b = bid + parity * kKeys;
          if (pending) atomicMin(&b[slot], warp);
          __syncthreads();
          if (pending && b[slot] == warp) {
            float ax = sx[slot], ay = sy[slot], az = sz[slot];
            for (unsigned g = grp; g != 0u; g &= g - 1u) {
              const float4 p = pts[r0 + warp * 32 + __ffs(g) - 1];
              ax = __fadd_rn(ax, p.x);
              ay = __fadd_rn(ay, p.y);
              az = __fadd_rn(az, p.z);
            }
            sx[slot] = ax;
            sy[slot] = ay;
            sz[slot] = az;
            cnt[slot] += __popc(grp);
            b[slot] = INT_MAX;
            pending = false;
          }
        }
      }
    }
    __syncthreads();
    for (int k = tid; k < nk; k += kThreads) {
      const size_t i = row + k0 + k;
      snn1[i * 3] = sx[k];
      snn1[i * 3 + 1] = sy[k];
      snn1[i * 3 + 2] = sz[k];
      cnt1[i] = static_cast<float>(cnt[k]);
    }
    __syncthreads();  // the next pass resets the payloads
  }
}

}  // namespace

// Launches both kernels on `stream`; returns the first cudaError_t that is
// not 0 (0 = both launched).
extern "C" int gat_chamfer_loss_payloads(const float* x1, const float* x2,
                                         float* d1, int* i1, float* d2, int* i2,
                                         float* nn1, float* snn1, float* cnt1,
                                         int b, int n, int m, void* stream) {
  const int rc = gat_nn_distance(x1, x2, d1, i1, d2, i2, b, n, m, stream);
  if (rc != 0) return rc;
  static const cudaError_t ready = cudaFuncSetAttribute(
      payload_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (ready != cudaSuccess) return static_cast<int>(ready);
  payload_kernel<<<static_cast<unsigned>(b), kThreads, kSmem,
                   static_cast<cudaStream_t>(stream)>>>(x2, i1, i2, nn1, snn1, cnt1, n, m);
  return static_cast<int>(cudaGetLastError());
}
