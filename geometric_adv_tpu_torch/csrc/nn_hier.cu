// Nearest neighbours with exact bounding-sphere pruning over Morton-sorted
// blocks (K8), and the preparation of its clouds.
//
// Replaces the TPU kernel
//   geometric_adv_tpu/ops/pallas/chamfer_hier_kernel.py::_nn_direction_hier
//     (_hier_kernel)                                  -> gat_nn_direction_hier
// reached through nn_direction_sorted and nn_distance_hier. The JAX package
// prepares its clouds (Morton codes, the stable sort, the block spheres, the
// seeded upper bounds) in plain jnp; here one kernel, gat_hier_prep, sorts
// the clouds and builds their spheres, and K8 seeds its own bounds. The
// plain PyTorch versions of both are in geometric_adv_tpu_torch/ops/
// chamfer_hier.py.
//
// A prepared cloud [b, k] is a float4 per point in Morton order: x, y, z
// and, in w, the bits of the point's original int32 id; beside it the
// spheres [b, ceil(k / kBlock)] of its blocks of kBlock sorted points
// (centre xyz, inflated radius in w).
//
// gat_hier_prep: one block of kPrepThreads threads per cloud, every cloud
// of one or two batches in one grid (blockIdx.y picks the batch). Per cloud:
//   - the box, a block-wide min and max per axis;
//   - Morton codes bit for bit as morton_codes: scale = 1023 / max(hi - lo,
//     1e-12) as a true division, (p - lo) * scale, clamped to [0, 1023],
//     truncated, the same bit spread; every step __f*_rn, so nothing is
//     contracted into an FMA;
//   - a bitonic sort of the 64-bit keys (code << 32) | id: the keys are
//     distinct, so the order is total, and equal codes keep their ids in
//     ascending order, as argsort(stable=True) does;
//   - the sorted float4 cloud, the codes (in original order, optional) and
//     one warp per block sphere, with build_block_structure's formula
//     (centre 0.5 * (min + max), radius sqrt(max |p - c|^2) * (1 + 1e-4) +
//     1e-9), a ragged last block over its own points.
// Up to kPrepCap = 16384 points a cloud (128 KB of keys, padded to a power
// of two) this is one kernel, the sort in shared memory. It is bound by its
// barriers (one per bitonic step, 66 at 2048 points), not by its bytes: it
// reads 12 and writes 16 bytes a point. Past the cap the same steps run over
// keys in global memory: runs of kPrepCap keys sorted in shared memory, and
// each larger bitonic size merged by its strides >= kPrepCap in global
// memory and its shorter ones in shared memory, run by run.
//
// gat_nn_direction_hier (K8): one launch for one or both directions
// (blockIdx.z picks the direction). A direction's queries are a cloud in
// any order (its results are written at the query's original id, read from
// w of a prepared cloud, or at its own position); its blocks are the other,
// prepared, cloud. One block of kWarps warps per (cloud, tile of kWarps * 32
// queries), one query a lane.
//   - The block stages the other cloud's spheres and points with cp.async
//     (16 bytes a point: no separate id array) into dynamic shared memory,
//     in chunks of kChunk points (32 blocks) with a barrier per chunk where
//     the cloud is larger.
//   - Each query seeds its running minimum with seed_upper_bounds's formula
//     over the spheres in shared memory, min_j (|q - c_j| + r_j)^2 *
//     (1 + 1e-5) + 1e-12: a true upper bound, not bit-equal to the plain
//     version's (it need not be).
//   - Each warp ranks the chunk's blocks by the least lower bound of its 32
//     queries, lb = max(0, sqrt(|q - c|^2) - r)^2 * (1 - 1e-5) - 1e-12, and
//     visits them nearest first, so that the first minima prune the rest.
//     It scans a block where one of its queries has lb <= cur
//     (__any_sync): no block-wide barrier in the loop.
//   - The running minimum is the packed key (bits of d) << 32 | original
//     id, started at (ub, 2^30). Distances are >= +0, so the unsigned order
//     of the keys is the order of the values with ties to the lowest id.
//     The scan keeps the key out of its loop: per group of 4 points it
//     takes their float minimum, records the first group below the running
//     value and flags a group equal to it; after the block the best group's
//     4 keys (or, where a group tied, every point's key: the ids do not
//     ascend with the points) enter the 64-bit minimum. The result is the
//     one 64-bit minimum over all scanned points' keys would give.
//     Since lb <= d(q, p) for every point p of a block and the test is
//     '<=', a skipped block never holds the argmin nor a tie with it: the
//     result is exact, bit-equal to K1 with the same indices.
//   - NaN: a NaN point of the other cloud has a key above every finite key
//     and is never taken while a finite distance exists; a query with a NaN
//     coordinate votes no and gets NaN and index 2^30. The plain version
//     follows the same rules.
//
// What bounds K8: the distance scan of the blocks its warps need, 8 FP32
// operations a pair and, per 4 pairs, 3 minima and a compare-and-select
// (~11 issue slots a pair with the shared-memory load); chip_smoke.py
// counts the (query, block) pairs whose own lower bound is at most the
// query's final distance, the least any exact search over these spheres
// scans, at 9 FP32 operations a point. Measured
// on the H100 (PERF.md): 1, 2 or 4 queries a lane (coarser votes),
// two or four independent 64-bit minima, 4, 8 or 16 warps a block, a
// register cap for 6 blocks an SM and warps that take the block's tiles
// as they come free all ran as fast as this or slower; the nearest-first
// order and the group scan were the steps that counted.

#include <cuda_runtime.h>
#include <math.h>

#include "sqdist.cuh"

namespace {

constexpr int kBlock = 128;  // sorted points per sphere (HIER_BLOCK)
constexpr unsigned kBigIdx = 1u << 30;
constexpr int kPrepThreads = 1024;
constexpr int kPrepCap = 16384;  // keys gat_hier_prep sorts in shared memory
constexpr int kWarps = 8;        // warps per K8 block
constexpr int kChunk = 4096;     // other-cloud points staged at once (64 KB): 32 blocks
constexpr int kMaxSmem = 226 * 1024;  // dynamic; the static orders take the rest

// the float32 values of the JAX package's margins
__device__ __forceinline__ float r_margin() { return static_cast<float>(1.0 + 1e-4); }
__device__ __forceinline__ float lb_margin() { return static_cast<float>(1.0 - 1e-5); }
__device__ __forceinline__ float ub_margin() { return static_cast<float>(1.0 + 1e-5); }
__device__ __forceinline__ float abs_margin() { return static_cast<float>(1e-12); }

__device__ __forceinline__ unsigned spread10(unsigned v) {
  v = (v | (v << 16)) & 0x030000FFu;
  v = (v | (v << 8)) & 0x0300F00Fu;
  v = (v | (v << 4)) & 0x030C30C3u;
  return (v | (v << 2)) & 0x09249249u;
}

__device__ __forceinline__ unsigned quantize(float p, float lo, float scale) {
  const float q = __fmul_rn(__fsub_rn(p, lo), scale);
  return static_cast<unsigned>(__float2int_rz(fminf(fmaxf(q, 0.f), 1023.f)));
}

__device__ __forceinline__ float warp_min(float v) {
  for (int s = 16; s > 0; s >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int s = 16; s > 0; s >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

struct PrepCloud {
  const float* pts;  // [b, k, 3]
  float4* out;       // [b, k] sorted, id bits in w
  float4* spheres;   // [b, ceil(k / kBlock)]
  int* codes;        // [b, k] in original order, or null
  int k;
};

struct PrepArgs {
  PrepCloud cloud[2];
  int pow2;                  // keys per cloud: a power of two >= every k
  int b;                     // clouds per batch
  unsigned long long* keys;  // [batches, b, pow2] in global memory (past kPrepCap), or null
};

__device__ __forceinline__ PrepCloud prep_cloud(const PrepArgs& a, int batch) {
  return batch ? a.cloud[1] : a.cloud[0];
}

// the box of the block's cloud p [k, 3] into box (lo xyz, hi xyz)
__device__ __forceinline__ void block_box(const float* p, int k, float* box) {
  __shared__ float part[6][kPrepThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float lo[3] = {INFINITY, INFINITY, INFINITY}, hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int i = threadIdx.x; i < k; i += kPrepThreads) {
    for (int ax = 0; ax < 3; ++ax) {
      const float v = p[i * 3 + ax];
      lo[ax] = fminf(lo[ax], v);
      hi[ax] = fmaxf(hi[ax], v);
    }
  }
  for (int ax = 0; ax < 3; ++ax) {
    lo[ax] = warp_min(lo[ax]);
    hi[ax] = warp_max(hi[ax]);
    if (lane == 0) {
      part[ax][warp] = lo[ax];
      part[3 + ax][warp] = hi[ax];
    }
  }
  __syncthreads();
  if (warp == 0) {
    for (int ax = 0; ax < 3; ++ax) {
      const float l = warp_min(part[ax][lane]);
      const float h = warp_max(part[3 + ax][lane]);
      if (lane == 0) {
        box[ax] = l;
        box[3 + ax] = h;
      }
    }
  }
  __syncthreads();
}

// the keys (code << 32) | id of the cloud p [k, 3] into keys[0, pow2); the
// padding, ~0, sorts last
__device__ __forceinline__ void make_keys(const float* p, int k, int pow2, const float* box,
                                          unsigned long long* keys) {
  float scale[3];
  for (int ax = 0; ax < 3; ++ax)
    scale[ax] = __fdiv_rn(1023.f, fmaxf(__fsub_rn(box[3 + ax], box[ax]), 1e-12f));
  for (int i = threadIdx.x; i < pow2; i += kPrepThreads) {
    unsigned long long key = ~0ull;
    if (i < k) {
      const unsigned code = spread10(quantize(p[i * 3], box[0], scale[0])) |
                            (spread10(quantize(p[i * 3 + 1], box[1], scale[1])) << 1) |
                            (spread10(quantize(p[i * 3 + 2], box[2], scale[2])) << 2);
      key = (static_cast<unsigned long long>(code) << 32) | static_cast<unsigned>(i);
    }
    keys[i] = key;
  }
}

// The bitonic steps of sizes size0, 2 * size0, ..., size1 on the len keys in
// shared memory that stand at base in the whole sequence, each size's
// strides from min(size, len) / 2 down to 1; a key at global position g goes
// up where (g & size) == 0. From size0 = 2 to size1 = len it sorts them.
__device__ __forceinline__ void bitonic_steps(unsigned long long* keys, int len, int base,
                                              int size0, int size1) {
  for (int size = size0; size <= size1; size <<= 1) {
    for (int stride = min(size, len) >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int t = threadIdx.x; t < len / 2; t += kPrepThreads) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const unsigned long long u = keys[i], v = keys[j];
        if ((u > v) == (((base + i) & size) == 0)) {
          keys[i] = v;
          keys[j] = u;
        }
      }
    }
  }
  __syncthreads();
}

// From the sorted keys of a cloud: the sorted float4 cloud, the codes and
// one warp per block sphere, with build_block_structure's formula.
__device__ __forceinline__ void finish_cloud(const PrepCloud& c, int cloud,
                                             const unsigned long long* keys) {
  const int k = c.k;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* p = c.pts + static_cast<size_t>(cloud) * k * 3;
  float4* out = c.out + static_cast<size_t>(cloud) * k;
  int* codes = c.codes ? c.codes + static_cast<size_t>(cloud) * k : nullptr;
  for (int i = threadIdx.x; i < k; i += kPrepThreads) {
    const unsigned long long key = keys[i];
    const unsigned id = static_cast<unsigned>(key);
    out[i] = make_float4(p[id * 3], p[id * 3 + 1], p[id * 3 + 2], __uint_as_float(id));
    if (codes) codes[id] = static_cast<int>(key >> 32);
  }
  __syncthreads();  // the block's writes to out are visible to it

  const int nb = (k + kBlock - 1) / kBlock;
  for (int jb = warp; jb < nb; jb += kPrepThreads / 32) {
    const int base = jb * kBlock;
    const int count = min(kBlock, k - base);
    float4 q[kBlock / 32];
    float mn[3] = {INFINITY, INFINITY, INFINITY}, mx[3] = {-INFINITY, -INFINITY, -INFINITY};
#pragma unroll
    for (int t = 0; t < kBlock / 32; ++t) {
      const int i = lane + 32 * t;
      q[t] = out[base + min(i, count - 1)];  // past a ragged end, its last point
      mn[0] = fminf(mn[0], q[t].x), mx[0] = fmaxf(mx[0], q[t].x);
      mn[1] = fminf(mn[1], q[t].y), mx[1] = fmaxf(mx[1], q[t].y);
      mn[2] = fminf(mn[2], q[t].z), mx[2] = fmaxf(mx[2], q[t].z);
    }
    float cen[3];
    for (int ax = 0; ax < 3; ++ax)
      cen[ax] = __fmul_rn(0.5f, __fadd_rn(warp_min(mn[ax]), warp_max(mx[ax])));
    float r2 = 0.f;
#pragma unroll
    for (int t = 0; t < kBlock / 32; ++t)
      r2 = fmaxf(r2, gat_sq_dist(q[t].x, q[t].y, q[t].z, cen[0], cen[1], cen[2]));
    r2 = warp_max(r2);
    if (lane == 0) {
      const float r = __fadd_rn(__fmul_rn(__fsqrt_rn(r2), r_margin()), 1e-9f);
      c.spheres[static_cast<size_t>(cloud) * nb + jb] = make_float4(cen[0], cen[1], cen[2], r);
    }
  }
}

// up to kPrepCap points a cloud: the whole preparation, the keys in shared
// memory. Grid (b, batches).
__global__ void __launch_bounds__(kPrepThreads) hier_prep_kernel(const PrepArgs a) {
  extern __shared__ unsigned long long keys[];
  __shared__ float box[6];
  const PrepCloud c = prep_cloud(a, blockIdx.y);
  const float* p = c.pts + static_cast<size_t>(blockIdx.x) * c.k * 3;
  block_box(p, c.k, box);
  make_keys(p, c.k, a.pow2, box, keys);
  bitonic_steps(keys, a.pow2, 0, 2, a.pow2);
  finish_cloud(c, blockIdx.x, keys);
}

// Past kPrepCap, the same steps over the keys in global memory (a.keys):
// hier_keys_kernel writes them, grid (b, batches); hier_sort_kernel runs
// bitonic_steps on each run of kPrepCap keys in shared memory, grid
// (pow2 / kPrepCap, b, batches); hier_merge_kernel runs one step of a
// stride >= kPrepCap in global memory, grid (pow2 / 2 / 1024, b, batches);
// hier_finish_kernel writes the outputs, grid (b, batches).
__device__ __forceinline__ unsigned long long* cloud_keys(const PrepArgs& a, int batch,
                                                           int cloud) {
  return a.keys + (static_cast<size_t>(batch) * a.b + cloud) * a.pow2;
}

__global__ void __launch_bounds__(kPrepThreads) hier_keys_kernel(const PrepArgs a) {
  __shared__ float box[6];
  const PrepCloud c = prep_cloud(a, blockIdx.y);
  const float* p = c.pts + static_cast<size_t>(blockIdx.x) * c.k * 3;
  block_box(p, c.k, box);
  make_keys(p, c.k, a.pow2, box, cloud_keys(a, blockIdx.y, blockIdx.x));
}

__global__ void __launch_bounds__(kPrepThreads) hier_sort_kernel(const PrepArgs a, int size0,
                                                                 int size1) {
  extern __shared__ unsigned long long keys[];
  const int base = blockIdx.x * kPrepCap;
  unsigned long long* g = cloud_keys(a, blockIdx.z, blockIdx.y) + base;
  for (int i = threadIdx.x; i < kPrepCap; i += kPrepThreads) keys[i] = g[i];
  bitonic_steps(keys, kPrepCap, base, size0, size1);
  for (int i = threadIdx.x; i < kPrepCap; i += kPrepThreads) g[i] = keys[i];
}

__global__ void __launch_bounds__(kPrepThreads) hier_merge_kernel(const PrepArgs a, int size,
                                                                  int stride) {
  const int t = blockIdx.x * kPrepThreads + threadIdx.x;
  unsigned long long* g = cloud_keys(a, blockIdx.z, blockIdx.y);
  const int i = 2 * t - (t & (stride - 1));
  const int j = i + stride;
  const unsigned long long u = g[i], v = g[j];
  if ((u > v) == ((i & size) == 0)) {
    g[i] = v;
    g[j] = u;
  }
}

__global__ void __launch_bounds__(kPrepThreads) hier_finish_kernel(const PrepArgs a) {
  finish_cloud(prep_cloud(a, blockIdx.y), blockIdx.x, cloud_keys(a, blockIdx.y, blockIdx.x));
}

struct HierDir {
  const float* q;     // queries [b, nq, qstride]: x y z (and id bits, stride 4)
  const float4* o;    // the other cloud, prepared [b, no]
  const float4* sph;  // its spheres [b, nbo]
  float* dist;        // [b, nq], at the queries' original ids
  int* idx;           // [b, nq] or null
  int qstride;        // 3: results at the query's position; 4: at its id
  int nq, no, nbo, tiles;
};

struct HierArgs {
  HierDir dir[2];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ unsigned long long pack(float d, unsigned id) {
  return (static_cast<unsigned long long>(__float_as_uint(d)) << 32) | id;
}

__device__ __forceinline__ float dist_to(float x, float y, float z, float4 p) {
  return gat_sq_dist(x, y, z, p.x, p.y, p.z);
}

// One block of `count` staged points against the lane's query, whose
// running minimum is bm: the minimum of each group of 4 points is compared
// with bm, and the first group below it is recorded (bg); tie is set where
// a group's minimum equals bm, since the ids do not ascend with the points.
template <int kCount>
__device__ __forceinline__ void scan_groups(const float4* blk, int count, float x, float y,
                                            float z, float& bm, int& bg, bool& tie) {
  const int groups = kCount ? kCount / 4 : (count + 3) / 4;
#pragma unroll 4
  for (int g = 0; g < groups; ++g) {
    float d[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      d[k] = dist_to(x, y, z, blk[kCount ? 4 * g + k : min(4 * g + k, count - 1)]);
    const float m = fminf(fminf(d[0], d[1]), fminf(d[2], d[3]));
    tie = tie || m == bm;
    if (m < bm) {
      bm = m;
      bg = g;
    }
  }
}

// the lower bound of |q - p|^2 over a sphere's points
__device__ __forceinline__ float lower_bound(float x, float y, float z, float4 s) {
  const float gap = fmaxf(__fsub_rn(__fsqrt_rn(dist_to(x, y, z, s)), s.w), 0.f);
  return __fsub_rn(__fmul_rn(__fmul_rn(gap, gap), lb_margin()), abs_margin());
}

// Writes to order[0, nbc) the blocks jb0 + [0, nbc) of a chunk (nbc <= 32)
// in increasing order of the warp's least lower bound over its live
// queries, ties by block: the blocks nearest the warp's queries come first,
// so that their minima prune the rest.
__device__ __forceinline__ void order_chunk(const float4* sph, int jb0, int nbc, int lane,
                                            float x, float y, float z, bool live,
                                            unsigned char* order) {
  float mine = INFINITY;
  for (int j = 0; j < nbc; ++j) {
    const float lb = warp_min(live ? lower_bound(x, y, z, sph[jb0 + j]) : INFINITY);
    if (lane == j) mine = lb;
  }
  int rank = 0;
  for (int i = 0; i < nbc; ++i) {
    const float other = __shfl_sync(0xffffffffu, mine, i);
    rank += other < mine || (other == mine && i < lane);
  }
  __syncwarp();
  if (lane < nbc) order[rank] = static_cast<unsigned char>(lane);
  __syncwarp();
}

__global__ void __launch_bounds__(kWarps * 32) hier_kernel(const HierArgs a) {
  extern __shared__ float4 stage[];
  __shared__ unsigned char orders[kWarps][32];
  const HierDir d = blockIdx.z ? a.dir[1] : a.dir[0];
  if (static_cast<int>(blockIdx.x) >= d.tiles) return;
  const int cloud = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float4* sph = stage;
  float4* pts = stage + d.nbo;
  const float4* o = d.o + static_cast<size_t>(cloud) * d.no;
  const float4* gs = d.sph + static_cast<size_t>(cloud) * d.nbo;
  for (int i = threadIdx.x; i < d.nbo; i += kWarps * 32) cp_async16(&sph[i], &gs[i]);
  const int first = min(d.no, kChunk);
  for (int i = threadIdx.x; i < first; i += kWarps * 32) cp_async16(&pts[i], &o[i]);

  // the lane's query, while the copies fly
  const int i = (blockIdx.x * kWarps + warp) * 32 + lane;
  float x = 0.f, y = 0.f, z = 0.f;
  int pos = i;
  if (i < d.nq) {
    const float* q = d.q + (static_cast<size_t>(cloud) * d.nq + i) * d.qstride;
    x = q[0];
    y = q[1];
    z = q[2];
    if (d.qstride == 4) pos = __float_as_int(q[3]);
  }
  const bool bad = isnan(x) || isnan(y) || isnan(z);
  const bool live = i < d.nq && !bad;
  cp_async_wait_all();
  __syncthreads();

  // the seed
  float cur = INFINITY;
  for (int j = 0; j < d.nbo; ++j) {
    const float4 s = sph[j];
    const float u = __fadd_rn(__fsqrt_rn(dist_to(x, y, z, s)), s.w);
    cur = fminf(cur, __fmul_rn(u, u));
  }
  cur = __fadd_rn(__fmul_rn(cur, ub_margin()), abs_margin());
  unsigned long long best = pack(cur, kBigIdx);

  for (int start = 0; start < d.no; start += kChunk) {
    if (start > 0) {
      __syncthreads();  // every warp is done with the previous chunk
      const int count = min(d.no - start, kChunk);
      for (int k = threadIdx.x; k < count; k += kWarps * 32) cp_async16(&pts[k], &o[start + k]);
      cp_async_wait_all();
      __syncthreads();
    }
    const int jb0 = start / kBlock;
    const int nbc = min(d.nbo, (start + kChunk) / kBlock) - jb0;
    order_chunk(sph, jb0, nbc, lane, x, y, z, live, orders[warp]);
    for (int k = 0; k < nbc; ++k) {
      const int jb = jb0 + orders[warp][k];
      if (!__any_sync(0xffffffffu, live && lower_bound(x, y, z, sph[jb]) <= cur)) continue;
      const float4* blk = pts + (jb * kBlock - start);
      const int count = min(kBlock, d.no - jb * kBlock);
      float bm = cur;
      int bg = -1;
      bool tie = false;
      if (count == kBlock)
        scan_groups<kBlock>(blk, count, x, y, z, bm, bg, tie);
      else
        scan_groups<0>(blk, count, x, y, z, bm, bg, tie);
      // the id: the first of the best group's points at bm; where a group
      // tied, every point's key
      if (tie) {
        for (int j = 0; j < count; ++j) {
          const unsigned long long key = pack(dist_to(x, y, z, blk[j]), __float_as_uint(blk[j].w));
          best = key < best ? key : best;
        }
      } else if (bg >= 0) {
#pragma unroll
        for (int k2 = 0; k2 < 4; ++k2) {
          const float4 p = blk[min(4 * bg + k2, count - 1)];
          const unsigned long long key = pack(dist_to(x, y, z, p), __float_as_uint(p.w));
          best = key < best ? key : best;
        }
      }
      cur = __uint_as_float(static_cast<unsigned>(best >> 32));
    }
  }

  if (i < d.nq) {
    const size_t at = static_cast<size_t>(cloud) * d.nq + pos;
    d.dist[at] = bad ? __uint_as_float(0x7fffffffu) : cur;
    if (d.idx != nullptr) d.idx[at] = static_cast<int>(bad ? kBigIdx : static_cast<unsigned>(best));
  }
}

size_t hier_smem(int no, int nbo) {
  return static_cast<size_t>(nbo + (no < kChunk ? no : kChunk)) * sizeof(float4);
}

// lets the preparation's shared-memory sorts take kPrepCap keys (once)
cudaError_t prep_ready() {
  const int bytes = static_cast<int>(kPrepCap * sizeof(unsigned long long));
  const cudaError_t e = cudaFuncSetAttribute(
      hier_prep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(hier_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// lets hier_kernel take up to kMaxSmem of dynamic shared memory (once)
cudaError_t hier_ready() {
  static const cudaError_t ready = cudaFuncSetAttribute(
      hier_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  return ready;
}

HierDir make_dir(const float* q, int qstride, const float* o, const float* sph, float* dist,
                 int* idx, int nq, int no) {
  HierDir d;
  d.q = q;
  d.o = reinterpret_cast<const float4*>(o);
  d.sph = reinterpret_cast<const float4*>(sph);
  d.dist = dist;
  d.idx = idx;
  d.qstride = qstride;
  d.nq = nq;
  d.no = no;
  d.nbo = (no + kBlock - 1) / kBlock;
  d.tiles = (nq + kWarps * 32 - 1) / (kWarps * 32);
  return d;
}

}  // namespace

// The preparation of one batch of clouds (y null) or of two: one launch up
// to kPrepCap points a cloud; past it, 3 + L + L (L + 1) / 2 launches with
// L = log2(pow2 / kPrepCap), through the keys workspace [batches, b, pow2]
// (8 bytes a key, pow2 the power of two >= every k; null below the cap):
// x [b, n, 3] -> x4 [b, n, 4], cyr_x [b, ceil(n / 128), 4], codes_x [b, n]
// (may be null); the same for y [b, m, 3].
extern "C" int gat_hier_prep(const float* x, float* x4, float* cyr_x, int* codes_x,
                             const float* y, float* y4, float* cyr_y, int* codes_y, void* keys,
                             int b, int n, int m, void* stream) {
  const int k = y != nullptr && m > n ? m : n;
  static const cudaError_t ready = prep_ready();
  if (ready != cudaSuccess) return static_cast<int>(ready);
  PrepArgs a;
  a.cloud[0] = {x, reinterpret_cast<float4*>(x4), reinterpret_cast<float4*>(cyr_x), codes_x, n};
  a.cloud[1] = {y, reinterpret_cast<float4*>(y4), reinterpret_cast<float4*>(cyr_y), codes_y, m};
  a.b = b;
  a.keys = static_cast<unsigned long long*>(keys);
  a.pow2 = 1;
  while (a.pow2 < k) a.pow2 <<= 1;
  const int batches = y != nullptr ? 2 : 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 clouds(b, batches);
  const size_t smem = static_cast<size_t>(a.pow2 < kPrepCap ? a.pow2 : kPrepCap) *
                      sizeof(unsigned long long);
  if (a.pow2 <= kPrepCap) {
    hier_prep_kernel<<<clouds, kPrepThreads, smem, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (a.keys == nullptr || b > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 runs(a.pow2 / kPrepCap, b, batches);
  const dim3 pairs(a.pow2 / 2 / kPrepThreads, b, batches);
  hier_keys_kernel<<<clouds, kPrepThreads, 0, s>>>(a);
  hier_sort_kernel<<<runs, kPrepThreads, smem, s>>>(a, 2, kPrepCap);
  for (int size = 2 * kPrepCap; size <= a.pow2; size <<= 1) {
    for (int stride = size / 2; stride >= kPrepCap; stride >>= 1)
      hier_merge_kernel<<<pairs, kPrepThreads, 0, s>>>(a, size, stride);
    hier_sort_kernel<<<runs, kPrepThreads, smem, s>>>(a, size, size);
  }
  hier_finish_kernel<<<clouds, kPrepThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K8, one launch. Direction 1: queries q1 [b, n1, s1] (s1 = 4: a prepared
// cloud, results at its ids; 3: results in its order) against the prepared
// o1 [b, m1, 4] with spheres sph1, into dist1 / idx1 [b, n1] (idx1 may be
// null). Direction 2 the same, or q2 null for one direction. Refuses an
// other cloud whose spheres and first chunk exceed kMaxSmem.
extern "C" int gat_nn_direction_hier(const float* q1, int s1, const float* o1,
                                     const float* sph1, float* dist1, int* idx1, int n1,
                                     int m1, const float* q2, int s2, const float* o2,
                                     const float* sph2, float* dist2, int* idx2, int n2,
                                     int m2, int b, void* stream) {
  const cudaError_t ready = hier_ready();
  if (ready != cudaSuccess) return static_cast<int>(ready);
  HierArgs a;
  a.dir[0] = make_dir(q1, s1, o1, sph1, dist1, idx1, n1, m1);
  a.dir[1] = q2 != nullptr ? make_dir(q2, s2, o2, sph2, dist2, idx2, n2, m2) : a.dir[0];
  const int ndir = q2 != nullptr ? 2 : 1;
  size_t smem = 0;
  int tiles = 0;
  for (int k = 0; k < ndir; ++k) {
    const size_t s = hier_smem(a.dir[k].no, a.dir[k].nbo);
    smem = s > smem ? s : smem;
    tiles = a.dir[k].tiles > tiles ? a.dir[k].tiles : tiles;
  }
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(tiles, b, ndir);
  hier_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K8's thread blocks resident on one SM against an other cloud of m points
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into out[0].
extern "C" int gat_hier_blocks_per_sm(int m, int* out) {
  const cudaError_t ready = hier_ready();
  if (ready != cudaSuccess) return static_cast<int>(ready);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, hier_kernel, kWarps * 32, hier_smem(m, (m + kBlock - 1) / kBlock)));
}
