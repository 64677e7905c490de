"""The two layouts the labs run on, built on the host with numpy.

* ``tile_layout``: the tiled SpMM layout of the JAX package's
  ``PallasDirection.__init__`` (``textgcn_tpu/ops/pallas_spmm.py``, its
  numpy construction).  Edges are sorted into (destination block x source
  block) tiles of 512 x 512, each tile's run is padded to chunks of 128
  slots, and each destination block's chunks are padded to groups of
  ``group`` chunks.  A padding slot carries w = 0 and points at local row
  0 of its tile; a padding chunk of a group holds packed 0, w 0 and source
  block 0.
* ``block_padded_ids``: the id padding of the JAX gather lab's
  ``make_onehot`` (``tools/gather_lab.py``): each source block's run of
  sorted ids is padded to a multiple of 128 by repeating its first id, so
  that no chunk of 128 ids straddles two source blocks.

The port's SpMM (``ops/spmm.py``) does not use this layout; only the lab
kernels of ``kernel_lab`` read it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

SRC_BLOCK = 512
DST_BLOCK = 512
CHUNK = 128
GROUP = 8


@dataclasses.dataclass(frozen=True)
class TileLayout:
    """One direction's tiled layout.

    ``packed`` holds ``dst_local << 16 | src_local`` per slot and ``w`` its
    weight, both ``(n_groups, group, chunk)``; ``chunk_sb`` the source
    block of each chunk, ``(n_groups * group,)``; ``group_ptr`` the range
    of groups of each destination block, ``(n_dst_blocks + 1,)``.  The
    arrays are numpy on the host, or torch tensors after ``to(device)``.
    """
    packed: object
    w: object
    chunk_sb: object
    group_ptr: object
    n_dst_blocks: int
    n_src_padded: int
    n_slots: int           # slots of the groups some destination block owns
    src_block: int = SRC_BLOCK
    dst_block: int = DST_BLOCK
    chunk: int = CHUNK
    group: int = GROUP

    @property
    def n_groups(self) -> int:
        return self.packed.shape[0]

    def to(self, device) -> TileLayout:
        """The same layout as contiguous tensors on ``device``."""
        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a)).to(device)
        return dataclasses.replace(
            self, packed=t(self.packed), w=t(self.w),
            chunk_sb=t(self.chunk_sb), group_ptr=t(self.group_ptr))


def _runs(counts, starts) -> np.ndarray:
    """``concat(arange(c) + s for c, s in zip(counts, starts))``."""
    if not len(counts):
        return np.zeros(0, np.int64)
    return np.concatenate([np.arange(c) + s for c, s in zip(counts, starts)])


def tile_layout(src, dst, w, n_src: int, n_dst: int,
                src_block: int = SRC_BLOCK, dst_block: int = DST_BLOCK,
                chunk: int = CHUNK, group: int = GROUP) -> TileLayout:
    """The tiled layout of the edges ``src -> dst`` with weights ``w``,
    equal array for array to ``PallasDirection``'s."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    w = np.asarray(w, np.float32)
    n_src_padded = -(-int(n_src) // src_block) * src_block
    n_dst_blocks = max(1, -(-int(n_dst) // dst_block))
    n_src_blocks = n_src_padded // src_block

    tile = (dst // dst_block) * n_src_blocks + (src // src_block)
    order = np.argsort(tile, kind='stable')
    src, dst, w, tile = src[order], dst[order], w[order], tile[order]

    # each tile's run padded to a multiple of ``chunk`` slots
    uniq, counts = np.unique(tile, return_counts=True)
    padded_counts = -(-counts // chunk) * chunk
    total = int(padded_counts.sum())
    tile_p = np.repeat(uniq, padded_counts)
    idx = _runs(counts, np.cumsum(padded_counts) - padded_counts)
    pad = np.ones(total, bool)
    pad[idx] = False
    src_p = np.zeros(total, np.int64)
    dst_p = np.zeros(total, np.int64)
    w_p = np.zeros(total, np.float32)
    src_p[idx], dst_p[idx], w_p[idx] = src, dst, w
    # padding slots: w = 0, local row 0 of their own tile
    src_p[pad] = (tile_p[pad] % n_src_blocks) * src_block
    dst_p[pad] = (tile_p[pad] // n_src_blocks) * dst_block

    n_chunks0 = total // chunk
    packed0 = (((dst_p % dst_block).astype(np.int32) << 16)
               | (src_p % src_block).astype(np.int32)).reshape(n_chunks0,
                                                               chunk)
    w0 = w_p.reshape(n_chunks0, chunk)
    first = tile_p.reshape(-1, chunk)[:, 0]
    sb0 = (first % n_src_blocks).astype(np.int32)
    db0 = (first // n_src_blocks).astype(np.int64)

    # each destination block's chunks padded to a multiple of ``group``
    cptr = np.searchsorted(db0, np.arange(n_dst_blocks + 1))
    counts_b = np.diff(cptr)
    padded_b = -(-counts_b // group) * group
    n_chunks = int(padded_b.sum())
    sel = _runs(counts_b, cptr[:-1])
    pos = _runs(counts_b, np.cumsum(padded_b) - padded_b)
    packed = np.zeros((n_chunks, chunk), np.int32)
    w_arr = np.zeros((n_chunks, chunk), np.float32)
    sb = np.zeros(n_chunks, np.int32)
    packed[pos], w_arr[pos], sb[pos] = packed0[sel], w0[sel], sb0[sel]

    # no edge at all still gives one group (of zeros), as on the TPU
    n_groups = max(n_chunks // group, 1)
    group_ptr = (np.cumsum(np.concatenate([[0], padded_b])) // group) \
        .astype(np.int32)
    return TileLayout(
        packed=np.resize(packed, (n_groups * group, chunk))
        .reshape(n_groups, group, chunk),
        w=np.resize(w_arr, (n_groups * group, chunk))
        .reshape(n_groups, group, chunk),
        chunk_sb=np.resize(sb, (n_groups * group,)),
        group_ptr=group_ptr, n_dst_blocks=n_dst_blocks,
        n_src_padded=n_src_padded,
        n_slots=int(group_ptr[-1]) * group * chunk, src_block=src_block,
        dst_block=dst_block, chunk=chunk, group=group)


def block_padded_ids(ids_sorted, src_block: int = SRC_BLOCK,
                     chunk: int = CHUNK) -> np.ndarray:
    """Sorted ids with each source block's run padded to a multiple of
    ``chunk`` by repeating the block's first id (int32)."""
    ids_sorted = np.asarray(ids_sorted)
    blocks = ids_sorted // src_block
    runs = []
    for b in np.unique(blocks):
        run = ids_sorted[blocks == b]
        runs.append(np.concatenate(
            [run, np.full((-len(run)) % chunk, run[0], run.dtype)]))
    return np.concatenate(runs).astype(np.int32)
