"""SpMM lab on the card: the tiled SpMM of the JAX lab in five modes, each
timed against its bound.

    python -m textgcn_tpu_torch.tools.kernel_lab [full no_gather no_scatter merged_scatter scat_bf16]

Counterpart of ``tools/kernel_lab.py``.  The lab graph is E = 600,000
random (dst, src) pairs (duplicates allowed) from 25,000 sources to
60,000 destinations with U[0, 1) weights, drawn from
``np.random.RandomState(0)`` in the JAX lab's order, then one x (25,000
rows of N(0, 1), d = 64, padded to 25,088) per mode from the same stream.
The edges are laid out as the TPU kernel reads them
(``lab_layout.tile_layout``), and every mode reads that layout:

* ``full`` -- the SpMM itself: gather x's rows, scale by w, add into the
  destination rows;
* ``no_gather`` -- the gather reads the chunk's 128 consecutive rows of
  its source block instead of the edges' rows;
* ``no_scatter`` -- the adds go to 128 consecutive rows of the
  destination block instead of the edges' rows;
* ``merged_scatter`` -- on the TPU, ``full`` with one scatter matmul per
  group; on the card the same function and the same kernel as ``full``;
* ``scat_bf16`` -- ``full`` with each scaled row rounded to bf16 before
  the f32 sum.

So ``full`` against the two ablations splits the SpMM's time between its
random row reads and its random adds.  ``spmm_lab_cuda`` launches the
hand-written kernel (``csrc/spmm_lab.cu``) and counts its launches in
``.launches``; ``spmm_lab_plain`` is the same function in plain torch.
The kernel's decomposition (a cluster of ``CLUSTER`` CTAs per destination
block, each owning the rows ``cta_rows`` gives, the block's slots cut
into stages and warps as ``work_split`` says, its kept slots sorted and
walked in the epochs of ``epoch_stages`` by the runs of ``walk_rows``) is
mirrored here: ``spmm_lab_split`` computes every mode by that decomposition
in plain torch, so that the CPU tests can hold it against
``spmm_lab_plain``; ``check_kernel_args`` holds what the wrapper refuses.

``TEXTGCN_TPU_LAB_XDTYPE=f32`` runs x in float32 (default bf16, as the
JAX lab), ``TEXTGCN_TPU_LAB_GROUP`` sets the chunks per group (default 8).
The lab runs on the card and prints, per mode, ms per call (CUDA events,
median of single launches), the bound and the share of it reached;
without a card it raises unless ``TEXTGCN_TPU_PLATFORM=cpu`` asks for
the CPU, where it runs the plain version once per mode and prints
checksums, not times.
"""

from __future__ import annotations

import ctypes
import functools
import os
import sys

import numpy as np
import torch

from ..config import platform_device
from .lab_layout import GROUP, TileLayout, tile_layout
from .timing import bound_ms, log, nvidia_smi, time_ms

E, NI, NU, D = 600_000, 25_000, 60_000, 64
MODES = ('full', 'no_gather', 'no_scatter', 'merged_scatter', 'scat_bf16')
DEFAULT_MODES = MODES[:4]
# the kernel's mode argument: merged_scatter is full on the card
MODE_IDS = {'full': 0, 'no_gather': 1, 'no_scatter': 2,
            'merged_scatter': 0, 'scat_bf16': 3}
SLICE = 64   # columns of the output a cluster writes
KERNEL_SOURCE = 'spmm_lab.cu'
XDTYPE_ENV = 'TEXTGCN_TPU_LAB_XDTYPE'
GROUP_ENV = 'TEXTGCN_TPU_LAB_GROUP'
# csrc/spmm_lab.cu's constants; the library's spmm_lab_config() must
# return CONFIG when it is loaded
CLUSTER = 2          # CTAs of a (destination block, column slice) cluster
CONSUMER_WARPS = 8   # warps of a CTA that collect, sort and walk
STAGE_SLOTS = 512    # slots of a stage of the ring of ids and weights
STAGES = 8
CAP = 4096           # kept slots an epoch holds
ROUNDS = {torch.float32: 4, torch.bfloat16: 8}   # gathers of a batch
TILE_ROWS = 512 // CLUSTER            # rows of a block a CTA owns
ROW_BITS = 8                          # log2(TILE_ROWS)
WALKERS = 2 * CONSUMER_WARPS          # half-warps that walk the rows
# the ring (packed int32 + w f32), the found and sorted lists (an int32
# pair a slot), the row starts and counts, the count found, 8-byte
# aligned, and three 8-byte barriers a stage
SMEM_BYTES = (8 * STAGES * STAGE_SLOTS + 16 * CAP
              + -(-(4 * (2 * TILE_ROWS + 2)) // 8) * 8 + 24 * STAGES)
CONFIG = (CLUSTER, CONSUMER_WARPS, STAGE_SLOTS, STAGES, CAP,
          ROUNDS[torch.float32], ROUNDS[torch.bfloat16], SMEM_BYTES)


def x_dtype() -> torch.dtype:
    """bf16 unless ``TEXTGCN_TPU_LAB_XDTYPE=f32``, as the JAX lab reads it."""
    return (torch.float32 if os.environ.get(XDTYPE_ENV, 'bf16') == 'f32'
            else torch.bfloat16)


def lab_group() -> int:
    """The chunks per group: ``TEXTGCN_TPU_LAB_GROUP`` if set, else 8."""
    value = os.environ.get(GROUP_ENV, '')
    return int(value) if value else GROUP


def lab_graph():
    """``(src, dst, w, rng)``: the lab's edges at the module's ``E``,
    ``NI`` and ``NU``, and the stream the x tables come from next."""
    rng = np.random.RandomState(0)
    src = rng.randint(0, NI, E).astype(np.int32)
    dst = rng.randint(0, NU, E).astype(np.int32)
    w = rng.rand(E).astype(np.float32)
    return src, dst, w, rng


def lab_x(rng, n_src_padded: int, dtype: torch.dtype) -> torch.Tensor:
    """The next x of the stream: ``NI`` rows of N(0, 1) at width ``D``,
    zero rows up to ``n_src_padded``, cast to ``dtype`` (on the host)."""
    x = np.zeros((n_src_padded, D), np.float32)
    x[:NI] = rng.randn(NI, D)
    return torch.from_numpy(x).to(dtype)


def _check_args(layout: TileLayout, x: torch.Tensor, mode: str):
    if mode not in MODE_IDS:
        raise ValueError(f'mode must be one of {MODES}, got {mode!r}')
    if x.dim() != 2 or x.shape[0] != layout.n_src_padded:
        raise ValueError(f'x must be ({layout.n_src_padded}, d), got '
                         f'{tuple(x.shape)}')
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'x must be float32 or bfloat16, got {x.dtype}')
    for name in ('packed', 'w', 'chunk_sb', 'group_ptr'):
        t = getattr(layout, name)
        if not isinstance(t, torch.Tensor) or t.device != x.device:
            raise ValueError(f'layout.{name} must be a tensor on {x.device} '
                             '(TileLayout.to)')


def _slots(layout: TileLayout, mode: str):
    """Per slot of the owned groups: the row of x read, the row of out
    written (int64) and the weight."""
    dev = layout.packed.device
    n = layout.n_slots
    packed = layout.packed.reshape(-1)[:n].to(torch.int64)
    w = layout.w.reshape(-1)[:n]
    per_chunk = layout.chunk
    sb = layout.chunk_sb[:n // per_chunk].to(torch.int64) \
        .repeat_interleave(per_chunk)
    groups = (layout.group_ptr[1:] - layout.group_ptr[:-1]).to(torch.int64)
    block = torch.repeat_interleave(
        torch.arange(layout.n_dst_blocks, device=dev),
        groups * layout.group * per_chunk, output_size=n)
    slot = torch.arange(n, device=dev) % per_chunk
    src_local = slot if mode == 'no_gather' else packed & 0xFFFF
    dst_local = slot if mode == 'no_scatter' else packed >> 16
    return (sb * layout.src_block + src_local,
            block * layout.dst_block + dst_local, w)


def spmm_lab_plain(layout: TileLayout, x: torch.Tensor,
                   mode: str) -> torch.Tensor:
    """The plain torch version of every mode: gather, widen, scale,
    round to bf16 for ``scat_bf16``, ``index_add_`` in f32."""
    _check_args(layout, x, mode)
    row_in, row_out, w = _slots(layout, mode)
    v = x[row_in].float() * w[:, None]
    if mode == 'scat_bf16':
        v = v.to(torch.bfloat16).float()
    out = torch.zeros((layout.n_dst_blocks * layout.dst_block, x.shape[1]),
                      dtype=torch.float32, device=x.device)
    return out.index_add_(0, row_out, v)


def cta_rows(rank: int) -> np.ndarray:
    """The rows of a destination block (``dst_local``) that CTA ``rank`` of
    its cluster owns, in the order of its tile rows: every ``CLUSTER``-th
    row from ``rank`` on, so that ``no_scatter``'s first 128 rows spread
    over the cluster as ``full``'s do."""
    if not 0 <= rank < CLUSTER:
        raise ValueError(f'rank must be in [0, {CLUSTER}), got {rank}')
    return rank + CLUSTER * np.arange(TILE_ROWS)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def work_split(layout: TileLayout) -> dict[str, np.ndarray]:
    """How the kernel's CTAs read the slots each destination block owns:
    per slot its ``block``, the ``stage`` of the block's ring it arrives in
    (``STAGE_SLOTS`` slots a stage from the block's first slot, so a stage
    starts on a chunk), the consumer ``warp`` whose share of the stage it
    is (``STAGE_SLOTS // CONSUMER_WARPS`` consecutive slots), and the
    ``chunk`` whose source block that warp reads: the chunk of the share's
    first slot.  Every CTA of the block's cluster reads every slot and
    keeps those of its rows.  ``n_stages`` holds each block's stages."""
    gp = _host(layout.group_ptr).astype(np.int64)
    per_block = np.diff(gp) * layout.group * layout.chunk
    starts = gp[:-1] * layout.group * layout.chunk
    block = np.repeat(np.arange(layout.n_dst_blocks), per_block)
    offset = np.arange(layout.n_slots) - starts[block]
    stage, in_stage = np.divmod(offset, STAGE_SLOTS)
    share = STAGE_SLOTS // CONSUMER_WARPS
    warp = in_stage // share
    first = starts[block] + stage * STAGE_SLOTS + warp * share
    return {'block': block, 'stage': stage, 'warp': warp,
            'chunk': first // layout.chunk,
            'n_stages': -(-per_block // STAGE_SLOTS)}


def epoch_stages(kept_by_stage) -> list[range]:
    """The kernel's epochs of one CTA: the runs of stages whose kept slots
    it sorts and walks together, given the slots it keeps from each stage.
    The count is read only once the stages since the last reading could
    have filled ``CAP`` (``STAGE_SLOTS`` kept a stage at most), and an
    epoch ends there if one more stage might not fit."""
    epochs, start, n_found = [], 0, 0
    unchecked = CAP // STAGE_SLOTS
    n_stages = len(kept_by_stage)
    for n, kept in enumerate(kept_by_stage):
        n_found += int(kept)
        unchecked -= 1
        if unchecked == 0 and n + 1 < n_stages:
            if n_found + STAGE_SLOTS > CAP:
                epochs.append(range(start, n + 1))
                start, n_found, unchecked = n + 1, 0, CAP // STAGE_SLOTS
            else:
                unchecked = (CAP - n_found) // STAGE_SLOTS
    epochs.append(range(start, n_stages))
    return epochs


def walk_rows(row_counts) -> np.ndarray:
    """The kernel's walk of one epoch: ``WALKERS + 1`` boundaries, half-warp
    ``k`` summing tile rows ``[bounds[k], bounds[k + 1])``, from the first
    row whose sorted slots start at or after its share of the slots."""
    counts = np.asarray(row_counts, np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)])
    n_found = int(starts[-1])
    targets = n_found * np.arange(WALKERS + 1) // WALKERS
    bounds = np.searchsorted(starts[:len(counts)], targets, side='left')
    bounds[-1] = len(counts)
    return bounds


def spmm_lab_split(layout: TileLayout, x: torch.Tensor,
                   mode: str) -> torch.Tensor:
    """Every mode computed by the kernel's decomposition, in plain torch:
    the slots with w = 0 skipped, each kept slot summed by the CTA that
    owns its row (``cta_rows``) into that CTA's tile row, each epoch's sums
    (``epoch_stages``) added in turn, and the tiles written out to their
    rows.  Equal to ``spmm_lab_plain`` up to the order of the f32 sums."""
    _check_args(layout, x, mode)
    dev = x.device
    split = work_split(layout)
    n, per_chunk = layout.n_slots, layout.chunk
    packed = layout.packed.reshape(-1)[:n].to(torch.int64)
    w = layout.w.reshape(-1)[:n]
    in_chunk = torch.arange(n, device=dev) % per_chunk
    src_local = in_chunk if mode == 'no_gather' else packed & 0xFFFF
    dst_local = in_chunk if mode == 'no_scatter' else packed >> 16
    # the source block of the warp's share (the slot's own chunk)
    sb = layout.chunk_sb[torch.from_numpy(split['chunk']).to(dev)] \
        .to(torch.int64)
    kept = w != 0
    v = x[(sb * layout.src_block + src_local)].float() * w[:, None]
    if mode == 'scat_bf16':
        v = v.to(torch.bfloat16).float()
    rank, tile_row = dst_local % CLUSTER, dst_local // CLUSTER
    cta = torch.from_numpy(split['block']).to(dev) * CLUSTER + rank
    stage = torch.from_numpy(split['stage']).to(dev)
    d = x.shape[1]
    tiles = torch.zeros((layout.n_dst_blocks * CLUSTER * TILE_ROWS, d),
                        dtype=torch.float32, device=dev)
    n_cta = layout.n_dst_blocks * CLUSTER
    n_stages = int(split['n_stages'].max(initial=0))
    kept_by = torch.zeros((n_cta, max(n_stages, 1)), dtype=torch.int64,
                          device=dev)
    kept_by.index_put_((cta[kept], stage[kept]),
                       torch.ones_like(cta[kept]), accumulate=True)
    epoch = torch.zeros((n_cta, max(n_stages, 1)), dtype=torch.int64)
    for c in range(n_cta):
        for e, run in enumerate(epoch_stages(
                _host(kept_by[c, :split['n_stages'][c // CLUSTER]]))):
            epoch[c, run.start:run.stop] = e
    epoch = epoch.to(dev)[cta, stage]
    for e in range(int(epoch.max()) + 1 if n else 0):
        sel = kept & (epoch == e)
        tiles.index_add_(0, (cta * TILE_ROWS + tile_row)[sel], v[sel])
    # tile row lr of CTA rank is the block's row lr * CLUSTER + rank
    return tiles.view(layout.n_dst_blocks, CLUSTER, TILE_ROWS, d) \
        .transpose(1, 2).reshape(-1, d)


def check_kernel_args(layout: TileLayout, x: torch.Tensor):
    """Raise on what the kernel does not take: a d that is not a multiple
    of 64, other block or chunk sizes, layout arrays of another dtype,
    shape or stride, an x that is not contiguous or not 16-byte aligned,
    or more rows of x than its slot lists can index."""
    d = x.shape[1]
    if d % SLICE:
        raise ValueError(f'd must be a multiple of {SLICE}, got {d}')
    if (layout.src_block, layout.dst_block, layout.chunk) != (512, 512, 128):
        raise ValueError('the kernel takes 512-row blocks and 128-slot '
                         'chunks')
    g, gs = layout.n_groups, layout.group
    want = {'packed': ((g, gs, 128), torch.int32),
            'w': ((g, gs, 128), torch.float32),
            'chunk_sb': ((g * gs,), torch.int32),
            'group_ptr': ((layout.n_dst_blocks + 1,), torch.int32)}
    for name, (shape, dtype) in want.items():
        t = getattr(layout, name)
        if tuple(t.shape) != shape or t.dtype != dtype or \
                not t.is_contiguous():
            raise ValueError(f'layout.{name} must be contiguous {dtype} '
                             f'{shape}, got {t.dtype} {tuple(t.shape)}')
    # a found slot holds row_in << ROW_BITS, a sorted one row_in * d / 4
    if layout.n_src_padded > min(2 ** (31 - ROW_BITS), 2 ** 33 // d):
        raise ValueError(f'x has {layout.n_src_padded} rows of {d}: the '
                         'kernel\'s slot lists index at most '
                         f'{min(2 ** (31 - ROW_BITS), 2 ** 33 // d)}')
    # 16-byte gathers of x, 16-byte bulk copies of packed and w
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError('x must be contiguous and 16-byte aligned')
    for name in ('packed', 'w'):
        if getattr(layout, name).data_ptr() % 16:
            raise ValueError(f'layout.{name} must be 16-byte aligned')


@functools.cache
def _kernel_fn():
    """The kernel's C entry point, built and bound at first use, after
    checking that the library was built with this module's constants."""
    from .. import cuda_build
    lib = cuda_build.load(KERNEL_SOURCE)
    got = (ctypes.c_int * len(CONFIG))()
    lib.spmm_lab_config.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.spmm_lab_config.restype = ctypes.c_int
    n = lib.spmm_lab_config(got, len(CONFIG))
    if n != len(CONFIG) or tuple(got) != CONFIG:
        raise RuntimeError(f'{KERNEL_SOURCE} was built with {tuple(got)}, '
                           f'kernel_lab expects {CONFIG}')
    fn = lib.spmm_lab
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
    fn.restype = ci
    return fn


def spmm_lab_cuda(layout: TileLayout, x: torch.Tensor,
                  mode: str) -> torch.Tensor:
    """Launch L1 in ``mode`` on PyTorch's current stream; ``out`` is
    allocated here.

    Raises on anything the kernel does not take: a tensor off the card,
    another dtype or layout shape, what ``check_kernel_args`` refuses, or
    a refused launch.
    """
    _check_args(layout, x, mode)
    if x.device.type != 'cuda':
        raise ValueError(f'spmm_lab_cuda needs CUDA tensors, x is on '
                         f'{x.device}')
    check_kernel_args(layout, x)
    d = x.shape[1]
    out = torch.empty((layout.n_dst_blocks * 512, d), dtype=torch.float32,
                      device=x.device)
    fn = _kernel_fn()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(layout.group_ptr.data_ptr(), layout.chunk_sb.data_ptr(),
            layout.packed.data_ptr(), layout.w.data_ptr(), x.data_ptr(),
            out.data_ptr(), layout.n_dst_blocks, layout.group, d,
            int(x.dtype == torch.bfloat16), MODE_IDS[mode],
            x.device.index or 0, stream)
    if rc:
        raise RuntimeError(f'spmm_lab kernel launch failed: CUDA error {rc}')
    spmm_lab_cuda.launches += 1
    return out


spmm_lab_cuda.launches = 0


def spmm_lab_bound(layout: TileLayout, x: torch.Tensor,
                   mode: str) -> tuple[float, str, float]:
    """``(ms, 'bytes' | 'operations', bytes)``: the least time of one call
    on the card.  Bytes: the owned slots' packed ids and weights, their
    chunks' source blocks, the group pointers, each row of x the mode
    reads once, the output written once; operations: a multiply and an
    add per slot and column, and a rounding for ``scat_bf16``."""
    row_in, _, _ = _slots(layout, mode)
    rows_read = int(torch.unique(row_in).numel())
    d = x.shape[1]
    n = layout.n_slots
    nbytes = (8 * n + 4 * (n // layout.chunk + layout.n_dst_blocks + 1)
              + rows_read * d * x.element_size()
              + 4 * layout.n_dst_blocks * layout.dst_block * d)
    ops = (3 if mode == 'scat_bf16' else 2) * n * d
    ms, by = bound_ms(nbytes, ops)
    return ms, by, nbytes


def main(argv: list[str] | None = None) -> dict[str, dict]:
    """Run the modes named in ``argv`` (default: all but ``scat_bf16``,
    as the JAX lab) and return ``{mode: result}``: on the card ``ms``,
    ``bound_ms``, ``bound_by`` and ``bytes``; on the CPU ``checksum``."""
    modes = list(sys.argv[1:] if argv is None else argv) or \
        list(DEFAULT_MODES)
    bad = [m for m in modes if m not in MODES]
    if bad:
        raise SystemExit(f'unknown mode(s) {bad}: choose from {MODES}')
    dev = platform_device()
    if dev.type == 'cuda':
        log(nvidia_smi('name,power.limit'))
    group, dtype = lab_group(), x_dtype()
    src, dst, w, rng = lab_graph()
    layout = tile_layout(src, dst, w, NI, NU, group=group).to(dev)
    log(f'lab graph: E={E}, {NI} -> {NU}, d={D}: {layout.n_slots} slots in '
        f'{layout.n_groups} groups, {layout.n_dst_blocks} destination '
        f'blocks, x ({layout.n_src_padded}, {D}) {dtype}')
    results = {}
    for mode in modes:
        x = lab_x(rng, layout.n_src_padded, dtype).to(dev)
        if dev.type == 'cpu':
            out = spmm_lab_plain(layout, x, mode)
            results[mode] = {'checksum': float(out.double().sum())}
            log(f'{mode:16s} GROUP={group:2d} x={dtype}: plain on the CPU, '
                f'checksum {results[mode]["checksum"]:.6f}')
            continue
        ms = time_ms({mode: lambda: spmm_lab_cuda(layout, x, mode)},
                     [mode, mode], strict=(mode,))[mode]
        b, by, nbytes = spmm_lab_bound(layout, x, mode)
        results[mode] = {'ms': ms, 'bound_ms': b, 'bound_by': by,
                         'bytes': nbytes}
        log(f'{mode:16s} GROUP={group:2d} x={dtype}: {ms:.4f} ms/call, '
            f'bound {b:.4f} ms ({by}, {nbytes / 1e6:.1f} MB), '
            f'{b / ms:.3f} of it')
    return results


if __name__ == '__main__':
    main()
