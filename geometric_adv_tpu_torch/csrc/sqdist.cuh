// The squared distance every chamfer kernel forms, shared by
// nn_distance.cu (K1, K2), chamfer_payloads.cu (K5) and nn_hier.cu (K8).
//
// ((dx*dx) + (dy*dy)) + (dz*dz) in round-to-nearest f32, written with
// __fsub_rn/__fmul_rn/__fadd_rn so that nvcc can not contract it into FMAs.
// The plain PyTorch version (geometric_adv_tpu_torch/ops/chamfer.py::
// pairwise_sqdist) evaluates the same expression in the same order, so
// minima are bit-equal and argmin ties resolve identically in every kernel.
//
// ops/cuda/build.py hashes every file under csrc/, so a change here rebuilds
// the library.

#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float gat_sq_dist(float ax, float ay, float az,
                                             float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}
