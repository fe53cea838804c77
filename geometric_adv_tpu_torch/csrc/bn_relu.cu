// Train-mode batch norm over the channel axis followed by ReLU, fused: one
// launch forward after the batch moments, two backward.
//
// Replaces no TPU kernel: XLA fuses flax's BatchNorm and the ReLU after it
// (geometric_adv_tpu/models/layers.py::PointMLP) into its neighbours. The
// port composed it from ATen operations (models/layers.py::BatchNorm in
// train mode, then torch.relu): about 20 launches a layer forward and as
// many backward, its column reductions well below the card's bandwidth.
//
// Contract: x [R, C] f32 contiguous (R rows: batch x points), gamma, beta
// [C]; flax's formula as models/layers.py::BatchNorm states it:
//   mean = sum(x)/R, s = sum(x*x)/R over the rows, d = s - mean^2,
//   v = max(d, 0), r = rsqrt(v + eps), a = r*gamma,
//   y = relu((x - mean)*a + beta), each operation rounded in that order,
//   running_mean = keep*running_mean + keep1*mean, running_var likewise
//   with v (keep the momentum, keep1 = 1 - momentum, both f32).
// The forward takes mean and s from the caller: ATen's two column means, as
// BatchNorm takes them, so that y and the running statistics are those of
// the composed version bit for bit (every other operation here is the same
// IEEE operation, rsqrtf ATen's rsqrt). A training step's argmaxes, ReLU
// masks and Adam's near-zero entries part from the composed version's at a
// changed last bit of a mean, so the statistics keep ATen's order.
// stats [5, C] keeps mean, v, r, a and flag = (d >= 0) for the backward.
// Backward, with g = dy where the recomputed pre-activation is > 0, else 0:
//   Sg = sum(g), Sgx = sum(g*(x - mean)),
//   dbeta = Sg, dgamma = r*Sgx, dv = flag * (-r^3/2 * gamma * Sgx),
//   dx = g*a + ((x - mean)*(2*dv/R) - a*Sg/R),
// the gradient of the forward, the clip included (torch.clamp's
// convention: it flows where d >= 0). The pre-activation is formed the same
// way in all three passes, so the backward's mask is the forward's y > 0.
//
// Each launch covers the rows in blocks of 32 rows x 8 columns, a column
// being 4 channels read as a float4 where C % 4 == 0 and x, dy are 16-byte
// aligned, else one channel; the grid is (row ranges, column chunks of 8).
// The forward's pass forms each of its columns' per-channel numbers from
// the moments (each column chunk's first block writes stats and the running
// statistics). The backward's sums launch keeps f32 partials a thread over
// its rows, adds a block's in f64 in a fixed order into one partial row per
// block, and the last block of a column chunk to finish (a counter and
// __threadfence, no float atomics) adds all the chunk's partial rows in f64
// in a fixed order and writes dgamma, dbeta and dx's two coefficients. The
// results depend only on (R, C, the SM count), so they repeat bit for bit.
// The counters are left at 0 for the next launch: launches that share them
// run one after another on one stream.
//
// What bounds it on Hopper: the bytes. The least a step can move is 8
// passes of R*C*4 bytes (x read for the sums, x read and y written; dy and
// x read for the sums, dy and x read and dx written: 0.69 ms a step of the
// victim's five encoder layers at 3.35 TB/s); ATen's moments add 3 (x*x
// written, x and x*x read). The per-channel data is a few KB.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;                     // columns a block covers
constexpr int kRowLanes = kThreads / kLanes;  // rows a block reads at once
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// Blocks aimed at per SM: fewer for the sums launch, whose last blocks add
// one partial row per block.
constexpr int kSumsBlocksPerSm = 4;
constexpr int kPassBlocksPerSm = 8;

enum Stat { kMean = 0, kVar, kR, kA, kFlag };

template <int V>
__device__ __forceinline__ void load(const float* __restrict__ p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store(float* __restrict__ p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

// (x - mean)*a + beta, each operation rounded, never contracted to an fma.
__device__ __forceinline__ float preact(float xc, float a, float b) {
  return __fadd_rn(__fmul_rn(xc, a), b);
}

// The rows [r0, r1) of this block.
__device__ __forceinline__ int row_end(int rows, int rows_per_block) {
  return min(rows, static_cast<int>(blockIdx.x) * rows_per_block + rows_per_block);
}

// The thread's first channel; >= C where its column lies past the last.
template <int V>
__device__ __forceinline__ int first_channel() {
  return (static_cast<int>(blockIdx.y) * kLanes + static_cast<int>(threadIdx.x) % kLanes) * V;
}

// Adds the block's two sums of each of its kLanes*V channels (s1, s2 of the
// thread's V channels) into its partial row, and in the column chunk's last
// block to finish, every partial row of the chunk into tot [2][kLanes*V];
// true in that block. Every order is fixed.
template <int V>
__device__ bool reduce_sums(const float (&s1)[V], const float (&s2)[V],
                            double* __restrict__ partials, unsigned* __restrict__ counters,
                            double* tot) {
  constexpr int kP = 2 * kLanes * V;    // a partial row: sum 1, then sum 2
  constexpr int kSlices = kThreads / kP;
  __shared__ double warp_sums[kWarps][kP];
  __shared__ double slices[kSlices][kP];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int warp = tid / 32;
  double d1[V], d2[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    d1[e] = s1[e];
    d2[e] = s2[e];
    // the warp's four row lanes of a column (bits 3 and 4 of tid)
#pragma unroll
    for (int off = kLanes; off < 32; off *= 2) {
      d1[e] += __shfl_xor_sync(kFull, d1[e], off);
      d2[e] += __shfl_xor_sync(kFull, d2[e], off);
    }
  }
  if (tid % 32 < kLanes) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      warp_sums[warp][lane * V + e] = d1[e];
      warp_sums[warp][kLanes * V + lane * V + e] = d2[e];
    }
  }
  __syncthreads();
  const int gx = gridDim.x;
  double* chunk = partials + static_cast<size_t>(blockIdx.y) * gx * kP;
  if (tid < kP) {
    double t = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += warp_sums[w][tid];
    chunk[static_cast<size_t>(blockIdx.x) * kP + tid] = t;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + blockIdx.y, 1u) == static_cast<unsigned>(gx - 1);
  __syncthreads();
  if (!last) return false;
  __threadfence();
  const int k = tid % kP, s = tid / kP;
  double t = 0.0;
#pragma unroll 8
  for (int b = s; b < gx; b += kSlices) t += __ldcg(chunk + static_cast<size_t>(b) * kP + k);
  slices[s][k] = t;
  __syncthreads();
  if (tid < kP) {
    double u = 0.0;
#pragma unroll
    for (int j = 0; j < kSlices; ++j) u += slices[j][tid];
    tot[tid] = u;
  }
  if (tid == 0) counters[blockIdx.y] = 0u;  // ready for the next launch
  __syncthreads();
  return true;
}

// The thread's channels' mean, a and beta (and dx's coefficients).
template <int V>
__device__ __forceinline__ void channel_params(const float* __restrict__ stats,
                                               const float* __restrict__ beta, int C, int col,
                                               float (&mu)[V], float (&a)[V], float (&b)[V]) {
#pragma unroll
  for (int e = 0; e < V; ++e) {
    mu[e] = stats[kMean * C + col + e];
    a[e] = stats[kA * C + col + e];
    b[e] = beta[col + e];
  }
}

// Forward: each thread forms its channels' statistics from the moments,
// the first block of each column chunk writes them to stats and updates
// the running statistics, and every block writes its rows of
// y = relu((x - mean)*a + beta).
template <int V>
__global__ void __launch_bounds__(kThreads)
bn_relu_forward_kernel(const float* __restrict__ x, const float* __restrict__ mean,
                       const float* __restrict__ mean_sq, const float* __restrict__ gamma,
                       const float* __restrict__ beta, float* __restrict__ running_mean,
                       float* __restrict__ running_var, float* __restrict__ stats,
                       float* __restrict__ y, int rows, int C, int rows_per_block, float eps,
                       float keep, float keep1) {
  const int col = first_channel<V>();
  if (col >= C) return;
  float mu[V], a[V], b[V];
  const bool writes = blockIdx.x == 0 && threadIdx.x < kLanes;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int c = col + e;
    mu[e] = mean[c];
    const float d = __fsub_rn(mean_sq[c], __fmul_rn(mu[e], mu[e]));
    const float v = d < 0.f ? 0.f : d;  // torch.clamp: a NaN stays NaN
    const float r = rsqrtf(__fadd_rn(v, eps));
    a[e] = __fmul_rn(r, gamma[c]);
    b[e] = beta[c];
    if (writes) {
      stats[kMean * C + c] = mu[e];
      stats[kVar * C + c] = v;
      stats[kR * C + c] = r;
      stats[kA * C + c] = a[e];
      stats[kFlag * C + c] = d >= 0.f ? 1.f : 0.f;
      running_mean[c] = __fadd_rn(__fmul_rn(keep, running_mean[c]), __fmul_rn(keep1, mu[e]));
      running_var[c] = __fadd_rn(__fmul_rn(keep, running_var[c]), __fmul_rn(keep1, v));
    }
  }
  const int r1 = row_end(rows, rows_per_block);
#pragma unroll 4
  for (int r = blockIdx.x * rows_per_block + threadIdx.x / kLanes; r < r1; r += kRowLanes) {
    const size_t at = static_cast<size_t>(r) * C + col;
    float v[V];
    load<V>(x + at, v);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float z = preact(__fsub_rn(v[e], mu[e]), a[e], b[e]);
      v[e] = z > 0.f || z != z ? z : 0.f;  // torch.relu: a NaN stays NaN
    }
    store<V>(y + at, v);
  }
}

// Backward, launch 1: Sg and Sgx; the last blocks write dgamma, dbeta and
// dx's coefficients coef [2, C]: c1 = -a*Sg/R, c2 = 2*dv/R.
template <int V>
__global__ void __launch_bounds__(kThreads)
bn_relu_grad_sums_kernel(const float* __restrict__ dy, const float* __restrict__ x,
                         const float* __restrict__ gamma, const float* __restrict__ beta,
                         const float* __restrict__ stats, float* __restrict__ coef,
                         float* __restrict__ dgamma, float* __restrict__ dbeta,
                         double* __restrict__ partials, unsigned* __restrict__ counters,
                         int rows, int C, int rows_per_block) {
  __shared__ double tot[2 * kLanes * V];
  const int col = first_channel<V>();
  float s1[V] = {}, s2[V] = {};
  if (col < C) {
    float mu[V], a[V], b[V];
    channel_params<V>(stats, beta, C, col, mu, a, b);
    const int r1 = row_end(rows, rows_per_block);
#pragma unroll 4
    for (int r = blockIdx.x * rows_per_block + threadIdx.x / kLanes; r < r1; r += kRowLanes) {
      const size_t at = static_cast<size_t>(r) * C + col;
      float v[V], g[V];
      load<V>(x + at, v);
      load<V>(dy + at, g);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xc = __fsub_rn(v[e], mu[e]);
        const float ge = preact(xc, a[e], b[e]) > 0.f ? g[e] : 0.f;
        s1[e] += ge;
        s2[e] = fmaf(ge, xc, s2[e]);
      }
    }
  }
  if (!reduce_sums<V>(s1, s2, partials, counters, tot)) return;
  const int j = threadIdx.x;
  const int c = blockIdx.y * kLanes * V + j;
  if (j >= kLanes * V || c >= C) return;
  const double sg = tot[j], sgx = tot[kLanes * V + j];
  const double r = stats[kR * C + c];
  const double dv = stats[kFlag * C + c] != 0.f ? -0.5 * r * r * r * gamma[c] * sgx : 0.0;
  dbeta[c] = static_cast<float>(sg);
  dgamma[c] = static_cast<float>(r * sgx);
  coef[c] = static_cast<float>(-static_cast<double>(stats[kA * C + c]) * sg / rows);
  coef[C + c] = static_cast<float>(2.0 * dv / rows);
}

// Backward, launch 2: dx = g*a + ((x - mean)*c2 + c1).
template <int V>
__global__ void __launch_bounds__(kThreads)
bn_relu_dx_kernel(const float* __restrict__ dy, const float* __restrict__ x,
                  const float* __restrict__ beta, const float* __restrict__ stats,
                  const float* __restrict__ coef, float* __restrict__ dx, int rows, int C,
                  int rows_per_block) {
  const int col = first_channel<V>();
  if (col >= C) return;
  float mu[V], a[V], b[V], c1[V], c2[V];
  channel_params<V>(stats, beta, C, col, mu, a, b);
#pragma unroll
  for (int e = 0; e < V; ++e) {
    c1[e] = coef[col + e];
    c2[e] = coef[C + col + e];
  }
  const int r1 = row_end(rows, rows_per_block);
#pragma unroll 4
  for (int r = blockIdx.x * rows_per_block + threadIdx.x / kLanes; r < r1; r += kRowLanes) {
    const size_t at = static_cast<size_t>(r) * C + col;
    float v[V], g[V];
    load<V>(x + at, v);
    load<V>(dy + at, g);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float xc = __fsub_rn(v[e], mu[e]);
      const float ge = preact(xc, a[e], b[e]) > 0.f ? g[e] : 0.f;
      v[e] = fmaf(ge, a[e], fmaf(xc, c2[e], c1[e]));
    }
    store<V>(dx + at, v);
  }
}

// The grid over R rows and C channels, V channels a column, at about
// blocks_per_sm blocks an SM; rows_per_block a multiple of kRowLanes.
struct Geometry {
  dim3 grid;
  int rows_per_block;
};

Geometry geometry(int rows, int C, int V, int sms, int blocks_per_sm) {
  const int cols = C / V;
  const int gy = (cols + kLanes - 1) / kLanes;
  const int groups = (rows + kRowLanes - 1) / kRowLanes;
  const long target = static_cast<long>(sms) * blocks_per_sm;
  const int want = static_cast<int>(std::max(1L, std::min<long>(groups, (target + gy - 1) / gy)));
  const int per = (groups + want - 1) / want * kRowLanes;
  return {dim3((rows + per - 1) / per, gy), per};
}

// Room check of the sums launches' scratch: a partial row of 2*kLanes*V
// doubles a block, a counter a column chunk.
bool fits(const Geometry& g, int V, long partials_cap, int counters_cap) {
  return static_cast<long>(g.grid.x) * g.grid.y * 2 * kLanes * V <= partials_cap &&
         static_cast<int>(g.grid.y) <= counters_cap && g.grid.y <= 65535u;
}

template <int V>
int forward(const float* x, const float* mean, const float* mean_sq, const float* gamma,
            const float* beta, float* running_mean, float* running_var, float* stats, float* y,
            int rows, int C, float eps, float keep, float keep1, int sms, cudaStream_t stream) {
  const Geometry p = geometry(rows, C, V, sms, kPassBlocksPerSm);
  if (p.grid.y > 65535u) return cudaErrorInvalidValue;
  bn_relu_forward_kernel<V><<<p.grid, kThreads, 0, stream>>>(
      x, mean, mean_sq, gamma, beta, running_mean, running_var, stats, y, rows, C,
      p.rows_per_block, eps, keep, keep1);
  return cudaGetLastError();
}

template <int V>
int backward(const float* dy, const float* x, const float* gamma, const float* beta,
             const float* stats, float* coef, float* dgamma, float* dbeta, float* dx,
             double* partials, long partials_cap, unsigned* counters, int counters_cap,
             int rows, int C, int sms, cudaStream_t stream) {
  const Geometry s = geometry(rows, C, V, sms, kSumsBlocksPerSm);
  if (!fits(s, V, partials_cap, counters_cap)) return cudaErrorInvalidValue;
  bn_relu_grad_sums_kernel<V><<<s.grid, kThreads, 0, stream>>>(
      dy, x, gamma, beta, stats, coef, dgamma, dbeta, partials, counters, rows, C,
      s.rows_per_block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const Geometry p = geometry(rows, C, V, sms, kPassBlocksPerSm);
  bn_relu_dx_kernel<V><<<p.grid, kThreads, 0, stream>>>(dy, x, beta, stats, coef, dx, rows, C,
                                                        p.rows_per_block);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The forward's launch, from the moments mean and mean_sq [C]. vec is 4
// (C % 4 == 0, x 16-byte aligned) or 1.
int gat_bn_relu_forward(const float* x, const float* mean, const float* mean_sq,
                        const float* gamma, const float* beta, float* running_mean,
                        float* running_var, float* stats, float* y, int rows, int C, float eps,
                        float keep, float keep1, int vec, int sms, cudaStream_t stream) {
  if (rows < 1 || C < 1 || (vec != 1 && vec != 4) || C % vec != 0) return cudaErrorInvalidValue;
  return vec == 4 ? forward<4>(x, mean, mean_sq, gamma, beta, running_mean, running_var, stats,
                               y, rows, C, eps, keep, keep1, sms, stream)
                  : forward<1>(x, mean, mean_sq, gamma, beta, running_mean, running_var, stats,
                               y, rows, C, eps, keep, keep1, sms, stream);
}

// Both launches of the backward; partials_cap doubles and counters_cap
// zeroed counters of scratch; dy 16-byte aligned too where vec is 4.
int gat_bn_relu_backward(const float* dy, const float* x, const float* gamma,
                         const float* beta, const float* stats, float* coef, float* dgamma,
                         float* dbeta, float* dx, double* partials, long partials_cap,
                         unsigned* counters, int counters_cap, int rows, int C, int vec,
                         int sms, cudaStream_t stream) {
  if (rows < 1 || C < 1 || (vec != 1 && vec != 4) || C % vec != 0) return cudaErrorInvalidValue;
  return vec == 4 ? backward<4>(dy, x, gamma, beta, stats, coef, dgamma, dbeta, dx, partials,
                                partials_cap, counters, counters_cap, rows, C, sms, stream)
                  : backward<1>(dy, x, gamma, beta, stats, coef, dgamma, dbeta, dx, partials,
                                partials_cap, counters, counters_cap, rows, C, sms, stream);
}

}  // extern "C"
