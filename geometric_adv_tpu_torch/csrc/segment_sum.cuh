// The ordered segmented sum shared by chamfer_payloads.cu (K5's snn1 and
// cnt1) and chamfer_grad.cu (K3's scatter term, K4's sc and cnt).
//
// Entries, taken in ascending order, each carry a key (a slot of the block's
// running sums). A key's entries must be added to its running sum in
// ascending entry order, one after another from 0.0f, the order of an
// explicit loop, so that the sums keep the host's bits and runs repeat
// exactly. The block takes the entries in rounds of blockDim.x, one per
// thread, ascending with the thread index. One round:
//   - __match_any_sync groups the lanes of a warp that hold the same key;
//     the group's lowest lane carries it, its members in ascending lane;
//   - across the warps, the groups of one key are peeled in warp order:
//     each carrier bids its warp for the key with a shared-memory atomic
//     minimum, and the winning warp's carrier adds its group to the key's
//     running sum. A round takes as many peels as the most warps sharing
//     one key (blockDim.x / 32 at most), each two block barriers.
// This is a counting sort's stable placement with the sums folded in: the
// segment offsets are never needed, because each entry is added where it
// would be placed.
//
// ops/cuda/build.py hashes every file under csrc/, so a change here rebuilds
// the library.

#pragma once

#include <climits>

#include <cuda_runtime.h>

// One round. `slot` is this thread's key, or a negative value that no other
// lane holds (-1 - lane) where it has no entry. `bid` holds two arrays of
// `stride` ints, one per peel parity, every element INT_MAX between peels.
// add(slot, grp) adds the entries of this warp's lanes in `grp` (ascending
// lane) to the running sum of `slot`; only the group's carrier calls it.
// Every thread of the block must call this, and it ends at a barrier.
template <typename Add>
__device__ __forceinline__ void gat_segment_round(int slot, int* bid, int stride,
                                                  Add add) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned grp = __match_any_sync(0xffffffffu, slot);
  bool pending = slot >= 0 && (grp & ((1u << lane) - 1u)) == 0u;
  // a winner resets its bid, which a loser reading it late can not mistake
  // for its own warp: the next peel bids in the other parity's array
  for (int parity = 0; __syncthreads_or(pending); parity ^= 1) {
    int* b = bid + parity * stride;
    if (pending) atomicMin(&b[slot], warp);
    __syncthreads();
    if (pending && b[slot] == warp) {
      add(slot, grp);
      b[slot] = INT_MAX;
      pending = false;
    }
  }
}
