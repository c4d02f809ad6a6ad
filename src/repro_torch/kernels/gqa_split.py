"""The launch plan of the two bf16 GQA attention kernels (``csrc/
gqa_attention.cuh``, through ``flash_attention`` and
``paged_flash_decode``): how many warps a block has, and into how many
splits the keys of a (slot, kv head, row tile) are cut.

A block of one warpgroup (4 warps, ``wgmma``) owns 128 query rows, a
block of one warp (``mma.sync``) 16 (``ROWS``).  When a grid of 128-row
blocks already fills the card (a slab prefill: 512 blocks), each block
walks all its keys.  Otherwise blocks take one warp, and the keys are
split over up to ``MAX_SPLITS``
blocks of one thread-block cluster, which combine their partial softmax
states in split order: as many splits as bring the grid to about
``TARGET_BLOCKS``, since each split adds a block's fixed cost (its
prologue, two cluster barriers, the combine).  The plan reads shapes
only; which key tiles a block walks depends on the query positions and
is worked out in the kernel with ``split_tiles``' formula.

The flash kernel's block surface (``kernels/ops.py``
``set_flash_blocks``) overrides the plan: ``block_q`` picks the block
shape by its query rows (16: one warp, 128: one warpgroup), and
``block_kv`` the keys a split walks, splits = ceil(max_keys / block_kv).
Only one-warp blocks split, so a set ``block_kv`` implies them.  A value
the kernel was not built for raises ``ValueError``; none is rounded.
"""
from __future__ import annotations

SMS = 132            # streaming multiprocessors of an H100 SXM
# by warps a block (gqa_attention.cuh Config): query rows a block owns,
# keys a staged tile holds
ROWS = {1: 16, 4: 128}
KEY_TILE = {1: 32, 4: 64}
MAX_SPLITS = 8       # the portable thread-block cluster size (kMaxSplits)
TARGET_BLOCKS = 3 * SMS   # a split grid aims at about three blocks an SM


def plan(kv_blocks: int, rows: int, max_keys: int, *, block_q=None,
         block_kv=None) -> tuple[int, int]:
    """(warps, splits) of a call with ``kv_blocks`` = B * hk (slot, kv
    head) pairs, ``rows`` = g * S query rows each and at most
    ``max_keys`` keys a slot (T, or the page table's W * page_size).
    ``block_q`` / ``block_kv``: the block surface's override (module
    docstring); None keeps the plan."""
    legal_q = sorted(ROWS.values())
    if block_q is not None and block_q not in legal_q:
        raise ValueError(f"flash_attention: bf16 block_q={block_q} is not "
                         f"built; legal: None or {legal_q}")
    if block_kv is not None:
        if block_q == ROWS[4]:
            raise ValueError(f"flash_attention: block_kv={block_kv} with "
                             f"block_q={block_q}: only {ROWS[1]}-row blocks "
                             "split the keys; legal: None")
        tile = KEY_TILE[1]
        least = -(-max_keys // MAX_SPLITS)
        least = -(-least // tile) * tile
        if block_kv % tile or block_kv < least:
            raise ValueError(
                f"flash_attention: block_kv={block_kv} is not built for "
                f"{max_keys} keys; legal: None or a multiple of {tile} from "
                f"{least} (at most {MAX_SPLITS} splits)")
        return 1, -(-max_keys // block_kv)
    if block_q is None and kv_blocks * -(-rows // ROWS[4]) >= SMS:
        return 4, 1
    if block_q == ROWS[4]:
        return 4, 1
    base = kv_blocks * -(-rows // ROWS[1])
    return 1, max(1, min(MAX_SPLITS, -(-max_keys // KEY_TILE[1]),
                         -(-TARGET_BLOCKS // base)))


def split_tiles(tile_lo: int, n_tiles: int, splits: int,
                split: int) -> range:
    """The key tiles split ``split`` of ``splits`` walks, out of the
    ``n_tiles`` tiles from ``tile_lo`` that its block's rows can see (the
    kernel's formula)."""
    return range(tile_lo + split * n_tiles // splits,
                 tile_lo + (split + 1) * n_tiles // splits)


def blocks(kv_blocks: int, rows: int, warps: int, splits: int) -> int:
    """Thread blocks of a launch."""
    return kv_blocks * -(-rows // ROWS[warps]) * splits
