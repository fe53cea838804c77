"""The all-pairs Chamfer distance matrix job, exact mode
(``geometric_adv_tpu/ops/pairwise.py:44-73, :189-322``).

The reference computes the test-set matrix with a TF graph over inner
batches of 10 pairs, resumable in 100-column CLI shards (reference:
attacker/prepare_indices_for_attack.py:104-156). Here the clouds upload to
the device once; the upper triangle of the pair list (the matrix is
symmetric, the diagonal is computed and is 0) is walked in blocks of
``pair_block`` pairs, each block one gather plus one ``nn_distance_values``
call (kernel K2 on the card). Results stay on the device for
``blocks_per_chunk`` blocks and then cross to the host, which is also the
progress granule.

Entries are mean(d1) + mean(d2) of squared NN distances, the reference's
``chamfer_dist`` node (prepare_indices_for_attack.py:113-114). The
chunk-screened fast mode (``screen_chunks > 0``, PARITY #14) is not ported
yet.
"""

from __future__ import annotations

import numpy as np
import torch

from geometric_adv_tpu_torch.ops.chamfer import nn_distance_values

PAIR_BLOCK = 512


def chamfer_distance_matrix(
    point_clouds: np.ndarray,
    device,
    pair_block: int = PAIR_BLOCK,
    blocks_per_chunk: int = 256,
    progress: bool = False,
    screen_chunks: int = 0,
) -> np.ndarray:
    """Symmetric [N, N] float32 chamfer matrix over a set of clouds."""
    if screen_chunks:
        raise NotImplementedError(
            "the chunk-screened chamfer matrix (screen_chunks > 0) is not "
            "ported yet (ROADMAP Queue 1 item 4)"
        )
    pcs = torch.as_tensor(np.asarray(point_clouds, np.float32), device=device)
    n_total = pcs.shape[0]
    iu, ju = np.triu_indices(n_total)
    n_pairs = len(iu)
    ii = torch.as_tensor(iu, device=device)
    jj = torch.as_tensor(ju, device=device)
    out = np.zeros((n_total, n_total), np.float32)

    chunk_pairs = pair_block * blocks_per_chunk
    with torch.no_grad():
        for s in range(0, n_pairs, chunk_pairs):
            e = min(s + chunk_pairs, n_pairs)
            parts = []
            for bs in range(s, e, pair_block):
                be = min(bs + pair_block, e)
                d1, d2 = nn_distance_values(pcs[ii[bs:be]], pcs[jj[bs:be]])
                parts.append(d1.mean(dim=-1) + d2.mean(dim=-1))
            d = torch.cat(parts).cpu().numpy()
            out[iu[s:e], ju[s:e]] = d
            out[ju[s:e], iu[s:e]] = d
            if progress:
                print(f"chamfer matrix: {e}/{n_pairs} pairs")
    return out
