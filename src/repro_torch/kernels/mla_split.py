"""The launch plan of the bf16 absorbed-MLA kernel (``csrc/
paged_decode_mla.cu``, through ``paged_flash_decode_mla``): how many
warps a block has, and into how many splits the keys of a (slot, row
tile) are cut.

A block is two warpgroups (8 warps, ``wgmma``) owning 64 position-major
query rows of one slot (``ROWS``) and walking its visible keys in tiles
of 64 (``KEY_TILE``).  Its shared memory (the q tile and two key tiles,
~226 KB at r 512) leaves room for one block an SM, so the keys are
split over up to ``MAX_SPLITS`` blocks of one thread-block cluster, as
many as bring the grid to about one block an SM (``SMS``) and no more:
a second wave would double the call.  ``MAX_SPLITS`` is 5, not the
portable cluster size of 8: a cluster's blocks must share one GPC, and
on the H100 only 15 clusters of 8 such blocks (120 blocks) are resident
at once (``cudaOccupancyMaxActiveClusters``), so a decode step's 16 row
tiles x 8 splits ran in two waves; of 4, 5 and 6 splits, which all fit
in one, 5 measured fastest (each split adds a partial to the combine).
The splits combine their partial softmax states in split order.  The plan reads
shapes only; which key tiles a block walks depends on the query
positions and is worked out in the kernel with ``split_tiles``'
formula.
"""
from __future__ import annotations

from repro_torch.kernels.gqa_split import split_tiles

__all__ = ["plan", "split_tiles", "blocks"]

SMS = 132            # streaming multiprocessors of an H100 SXM
WARPS = 8            # two warpgroups a block
ROWS = 64            # query rows a block: one wgmma m-tile
KEY_TILE = 64        # keys a staged tile
MAX_SPLITS = 5       # see above: 8-block clusters do not all fit at once


def plan(slots: int, rows: int, max_keys: int) -> tuple[int, int]:
    """(warps, splits) of a call with ``slots`` = B slots, ``rows`` = h *
    S query rows each and at most ``max_keys`` keys a slot (the page
    table's W * page_size)."""
    base = slots * -(-rows // ROWS)
    return WARPS, max(1, min(MAX_SPLITS, -(-max_keys // KEY_TILE),
                             SMS // base))


def blocks(slots: int, rows: int, splits: int) -> int:
    """Thread blocks of a launch."""
    return slots * -(-rows // ROWS) * splits
