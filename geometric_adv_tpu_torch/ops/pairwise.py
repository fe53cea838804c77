"""The all-pairs Chamfer distance matrix job
(``geometric_adv_tpu/ops/pairwise.py``).

The reference computes the test-set matrix with a TF graph over inner
batches of 10 pairs, resumable in 100-column CLI shards (reference:
attacker/prepare_indices_for_attack.py:104-156). Here the clouds upload to
the device once; the upper triangle of the pair list (the matrix is
symmetric, the diagonal is computed and is 0) is walked in blocks of
``pair_block`` pairs. Results stay on the device for ``blocks_per_chunk``
blocks and then cross to the host, which is also the progress granule.

Entries are mean(d1) + mean(d2) of squared NN distances, the reference's
``chamfer_dist`` node (prepare_indices_for_attack.py:113-114). Two modes:

- exact (the default): each block is one gather plus one
  ``nn_distance_values`` call (kernel K2 on the card);
- chunk-screened (``screen_chunks`` = C > 0, PARITY #14; the JAX package's
  pairwise.py:97-188): each cloud is Morton-sorted once and cut into C
  contiguous chunks of g = ceil(m / C) points; a pair evaluation screens
  each query point against the other cloud's C chunk centroids (the "mxu"
  distance), takes the ``screen_k`` nearest chunks (ties to the lower
  chunk) and takes the exact ("direct") minimum over their k * g points.
  Every entry majorizes its exact value; with k = C it equals it. This mode
  is a PyTorch composition, as the JAX package's is an XLA one.

Under a mesh of P processes (``parallel/``) ``pair_block`` is rounded up to
a multiple of P, each block (the last one padded with (0, 0) self-pairs)
is cut into P contiguous parts, rank p computes part p, and
``gather_global`` assembles each chunk's blocks on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from geometric_adv_tpu_torch.ops.chamfer import nn_distance_values, pairwise_sqdist
from geometric_adv_tpu_torch.parallel import gather_global

PAIR_BLOCK = 512
# the screened mode's block: its k candidate gathers of [block, n, g, 3]
# are its working set (the JAX package's cap, pairwise.py:268-272)
SCREEN_PAIR_BLOCK = 128
SCREEN_K = 8


def _morton_spread3(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of int32 ``v`` so bit i lands at bit 3*i."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def chunk_clouds(pcs: torch.Tensor, n_chunks: int = 64):
    """Morton-sort each cloud and cut it into equal contiguous chunks.

    ``pcs`` [N, m, 3] -> (chunks [N, C, g, 3], centers [N, C, 3]): the
    10-bit-a-coordinate Morton key of the JAX package's ``chunk_clouds``,
    bit for bit, a stable sort (equal keys keep their point order), the
    sorted cloud padded to C * g by its last point where m % C != 0 (a
    duplicate never changes a minimum) and the centers the chunk means,
    padding included.
    """
    n_total, m, _ = pcs.shape
    g = -(-m // n_chunks)
    lo = pcs.amin(dim=1, keepdim=True)
    span = pcs.amax(dim=1, keepdim=True) - lo
    q = torch.clamp(((pcs - lo) / (span + 1e-12) * 1023.0).to(torch.int32), 0, 1023)
    key = (_morton_spread3(q[..., 0]) | (_morton_spread3(q[..., 1]) << 1)
           | (_morton_spread3(q[..., 2]) << 2))
    order = torch.sort(key, dim=1, stable=True).indices
    srt = torch.gather(pcs, 1, order[..., None].expand(-1, -1, 3))
    if n_chunks * g > m:
        pad = srt[:, -1:].expand(-1, n_chunks * g - m, -1)
        srt = torch.cat([srt, pad], dim=1)
    chunks = srt.reshape(n_total, n_chunks, g, 3)
    return chunks, chunks.mean(dim=2)


def _screened_min_sqdist(a, b_chunks, b_centers, k):
    """Per-point candidate minimum squared distance of the points of ``a``
    [P, n, 3] into the chunked clouds ``b_chunks`` [P, C, g, 3] with
    centers ``b_centers`` [P, C, 3]: [P, n], each >= its exact minimum.

    The k nearest centroids come from a stable sort (``torch.topk`` promises
    no order among equal values; ``lax.top_k`` takes the lower index). The
    k gathers of [P, n, g, 3] run one at a time, as the JAX package unrolls
    them, so that no [P, n, k * g, 3] tensor is formed."""
    d_ac = pairwise_sqdist(a, b_centers, method="mxu")  # [P, n, C]
    top = torch.sort(d_ac, dim=-1, stable=True).indices[..., :k]
    rows = torch.arange(a.shape[0], device=a.device)[:, None]
    best = None
    for r in range(k):
        pts = b_chunks[rows, top[..., r]]  # [P, n, g, 3]
        d = pairwise_sqdist(a[..., None, :], pts)[..., 0, :].amin(dim=-1)
        best = d if best is None else torch.minimum(best, d)
    return best


def chamfer_distance_matrix(
    point_clouds: np.ndarray,
    device,
    pair_block: int = PAIR_BLOCK,
    blocks_per_chunk: int = 256,
    progress: bool = False,
    screen_chunks: int = 0,
    screen_k: int = 0,
    mesh=None,
) -> np.ndarray:
    """Symmetric [N, N] float32 chamfer matrix over a set of clouds.

    ``screen_chunks`` = C > 0 selects the chunk-screened mode, scanning
    ``screen_k`` chunks a point (0: 8; capped at C), in blocks of at most
    SCREEN_PAIR_BLOCK pairs. ``mesh`` shards each block's pairs over its
    processes (a mesh of size 1 is ``None``).
    """
    pcs = torch.as_tensor(np.asarray(point_clouds, np.float32), device=device)
    n_total = pcs.shape[0]
    iu, ju = np.triu_indices(n_total)
    n_pairs = len(iu)
    ii = torch.as_tensor(iu, device=device)
    jj = torch.as_tensor(ju, device=device)
    out = np.zeros((n_total, n_total), np.float32)

    if screen_chunks:
        screen_k = min(screen_k or SCREEN_K, screen_chunks)
        pair_block = min(pair_block, SCREEN_PAIR_BLOCK)
        with torch.no_grad():
            chunks, centers = chunk_clouds(pcs, screen_chunks)

    def block_values(i, j):
        if screen_chunks:
            d1 = _screened_min_sqdist(pcs[i], chunks[j], centers[j], screen_k)
            d2 = _screened_min_sqdist(pcs[j], chunks[i], centers[i], screen_k)
        else:
            d1, d2 = nn_distance_values(pcs[i], pcs[j])
        return d1.mean(dim=-1) + d2.mean(dim=-1)

    if mesh is not None and mesh.size > 1:
        pair_block = -(-pair_block // mesh.size) * mesh.size
        width = pair_block // mesh.size
        ii, jj = (torch.cat([t, t.new_zeros(-n_pairs % pair_block)]) for t in (ii, jj))

        def chunk_values(s, e):
            """[blocks, P * width]: rank r computes columns [r*w, (r+1)*w)."""
            own = [bs + mesh.rank * width for bs in range(s, e, pair_block)]
            mine = torch.stack([block_values(ii[o:o + width], jj[o:o + width])
                                for o in own])
            return gather_global(mine, axis=1).reshape(-1)[:e - s]
    else:
        def chunk_values(s, e):
            return torch.cat([
                block_values(ii[bs:min(bs + pair_block, e)],
                             jj[bs:min(bs + pair_block, e)])
                for bs in range(s, e, pair_block)
            ]).cpu().numpy()

    chunk_pairs = pair_block * blocks_per_chunk
    with torch.no_grad():
        for s in range(0, n_pairs, chunk_pairs):
            e = min(s + chunk_pairs, n_pairs)
            d = chunk_values(s, e)
            out[iu[s:e], ju[s:e]] = d
            out[ju[s:e], iu[s:e]] = d
            if progress:
                print(f"chamfer matrix: {e}/{n_pairs} pairs")
    return out
