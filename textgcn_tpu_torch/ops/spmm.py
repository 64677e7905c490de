"""Bipartite SpMM: kernels K1 (hash edge dropout fused) and K2 (weights
given per call), with their plain twins.

Counterpart of ``textgcn_tpu/ops/pallas_spmm.py`` (``TiledSpMM``,
``PallasGraphOp``, ``pallas_spmm``, ``edge_dropout_scale``,
``hash_dropout_salts``).  One propagation direction computes

    out[dst] = sum_e w_e * s_e * x[src_e]

with ``s_e = 1/keep`` when the murmur-style hash of the edge's global
(user, item, salt) is below ``keep`` (always when ``keep >= 1``), else 0.
The mask is a pure function of the edge, so a direction and its transpose
drop the same edges.

The TPU layout (512x512 tiles, 128-edge chunks, one-hot matmuls, VMEM
source splits, tables padded to 4096 rows) is not carried over: each
direction is one destination-sorted CSR over the real rows.

* ``spmm_dropout_cuda`` launches the hand-written CUDA kernel
  (``csrc/spmm_dropout.cu``) and counts its launches in ``.launches``;
  ``.split_launches`` counts those that ran a CSR's split schedule.
* ``build_csr`` also builds each direction's split schedule once
  (``split_schedule``): the rows longer than ``SPLIT_LEN`` edges, cut into
  chunks that K1 walks in parallel and sums in a fixed order.  It depends
  on ``rowptr`` alone, so every salt, keep, pass and step reuses it; a
  graph without such rows has none, and ``CSR.split`` is None.
* ``spmm_plain`` is the same function in plain torch; the CPU path and the
  on-card comparison use it.
* ``spmm`` picks by the tensor's device: the plain version for a CPU
  tensor, the kernel for a CUDA tensor; there is no fallback between them.
* ``spmm_weighted_cuda`` launches K2 (``csrc/spmm_weighted.cu``):
  ``out[dst] = sum_e w_e * x[src_e]`` with the caller's per-edge weights
  ``w`` in CSR order, as ``pallas_spmm(..., w, x)`` takes them; the mesh
  path (``parallel/sharded_spmm.py``) runs it on a rank's shard.
  ``spmm_weighted_plain`` is its plain version and ``spmm_weighted`` picks
  between them by device, as ``spmm`` does.
* ``GraphOp.to_user``/``to_item`` are differentiable: the gradient of one
  direction is the other direction's CSR run on the cotangent with the
  forward's ``(salt, keep)`` (``_pgs_bwd`` in ``pallas_spmm.py``), so the
  backward is K1 again and drops the same edges.  ``GraphOp.csr_pair``
  names a direction's CSR and its transpose for the attention kernels.
* ``TEXTGCN_TPU_PALLAS_XDTYPE=bf16`` (``gathered_dtype``) rounds the
  table K1 gathers, forward ``x`` and backward cotangent, to bfloat16
  before the f32 kernel, as the JAX package's TPU default does
  (``pallas_spmm.py:546-559``, ``x.astype(self.x_dtype)``).  The default
  is f32: nothing is rounded.
"""

from __future__ import annotations

import ctypes
import functools
import os
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.autograd.function import once_differentiable

_M1 = 2654435761
_M2 = 2246822519
_F1 = 0x7FEB352D
_F2 = 0x846CA68B
_U32 = 0xFFFFFFFF
KERNEL_SOURCE = 'spmm_dropout.cu'
WEIGHTED_SOURCE = 'spmm_weighted.cu'
XDTYPE_ENV = 'TEXTGCN_TPU_PALLAS_XDTYPE'
# K1 walks a row longer than this many edges in chunks of at most as many,
# one group each (csrc/spmm_dropout.cu; the pick: PERF.md, section 6)
SPLIT_LEN = 128


@dataclass(frozen=True, eq=False)
class SplitSchedule:
    """K1's chunks of the rows longer than ``split_len`` edges, on the
    card.  Chunk ``i`` is its own slot in ``partials``; the chunks of split
    row ``j`` are ``first[j]:first[j + 1]``, in CSR order."""
    work: torch.Tensor      # (chunks, 4) int32: row, begin, end, split row
    first: torch.Tensor     # (split rows + 1,) int32
    arrivals: torch.Tensor  # (split rows,) int32, 0 between launches
    split_len: int
    split_edges: int        # the edges of the split rows
    # the chunks' partial rows, (chunks, d) float32 for each d launched
    partials: dict = field(default_factory=dict)


@dataclass(frozen=True)
class CSR:
    """One propagation direction, sorted by destination row."""
    rowptr: torch.Tensor   # (n_dst + 1,) int32
    col: torch.Tensor      # (E,) int32, source row of each edge
    w: torch.Tensor        # (E,) float32
    n_src: int
    dst_is_user: bool      # which endpoint feeds the user slot of the hash
    split: SplitSchedule | None = None   # None: no row is split

    @property
    def n_dst(self) -> int:
        return self.rowptr.numel() - 1

    @property
    def n_edges(self) -> int:
        return self.col.numel()

    @property
    def split_rows(self) -> int:
        return 0 if self.split is None else self.split.arrivals.numel()

    @property
    def chunks(self) -> int:
        return 0 if self.split is None else self.split.work.shape[0]

    @property
    def split_edge_share(self) -> float:
        """The share of the edges that lie in split rows."""
        if self.split is None:
            return 0.0
        return self.split.split_edges / self.n_edges


def split_schedule(rowptr: np.ndarray, split_len: int = SPLIT_LEN):
    """K1's split schedule of a CSR's ``rowptr``, as numpy int32 arrays
    ``(work, first)``: every row longer than ``split_len`` edges, heaviest
    first (ties in row order), cut into consecutive chunks of at most
    ``split_len`` edges in CSR order; ``work[i]`` = (row, begin, end,
    split row j) of chunk ``i``, and row j's chunks are ``first[j]:first[j
    + 1]``."""
    rowptr = np.asarray(rowptr, np.int64)
    length = np.diff(rowptr)
    rows = np.flatnonzero(length > split_len)
    rows = rows[np.argsort(-length[rows], kind='stable')]
    first = np.zeros(len(rows) + 1, np.int64)
    np.cumsum(-(-length[rows] // split_len), out=first[1:])
    j = np.repeat(np.arange(len(rows)), np.diff(first))
    begin = rowptr[rows[j]] + (np.arange(first[-1]) - first[j]) * split_len
    end = np.minimum(begin + split_len, rowptr[rows[j] + 1])
    work = np.stack([rows[j], begin, end, j], axis=1)
    return work.astype(np.int32).reshape(-1, 4), first.astype(np.int32)


def build_csr(dst: np.ndarray, src: np.ndarray, w: np.ndarray, n_dst: int,
              n_src: int, dst_is_user: bool, device) -> CSR:
    """Host-built CSR of one direction: edges sorted by (dst, src)."""
    dst = np.asarray(dst, np.int64)
    src = np.asarray(src, np.int64)
    if len(dst) >= 2**31:
        raise ValueError(f'{len(dst)} edges exceed the int32 CSR')
    order = np.lexsort((src, dst))
    rowptr = np.zeros(n_dst + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n_dst), out=rowptr[1:])
    work, first = split_schedule(rowptr, SPLIT_LEN)
    split = None
    if len(work):
        split = SplitSchedule(
            work=torch.from_numpy(work).to(device),
            first=torch.from_numpy(first).to(device),
            arrivals=torch.zeros(len(first) - 1, dtype=torch.int32,
                                 device=device),
            split_len=SPLIT_LEN,
            split_edges=int((work[:, 2] - work[:, 1]).sum()))
    return CSR(
        rowptr=torch.from_numpy(rowptr.astype(np.int32)).to(device),
        col=torch.from_numpy(src[order].astype(np.int32)).to(device),
        w=torch.from_numpy(np.asarray(w, np.float32)[order]).to(device),
        n_src=int(n_src), dst_is_user=dst_is_user, split=split)


def hash_dropout_salts(generator: torch.Generator | None = None,
                       dropout: float = 0.0):
    """Per-direction ``(salt, keep)`` pairs, (to_user, to_item).

    No dropout gives ``(0, 1.0)`` for both.  Otherwise the two salts are
    uint32 draws from ``generator`` and ``keep`` is ``float32(1 -
    dropout)``, as the JAX package computes it.
    """
    if dropout <= 0.0 or generator is None:
        return (0, 1.0), (0, 1.0)
    salts = torch.randint(0, 2**32, (2,), generator=generator,
                          dtype=torch.int64).tolist()
    keep = float(np.float32(1.0 - dropout))
    return (salts[0], keep), (salts[1], keep)


def edge_dropout_scale(user_ids: torch.Tensor, item_ids: torch.Tensor,
                       salt: int, keep: float) -> torch.Tensor:
    """Per-edge scale ``1/keep`` or 0, bit-equal to the JAX package's.

    The uint32 hash is computed in int64 and masked to 32 bits after every
    multiply; the low 32 bits survive int64 wrap-around.  ``keep`` and
    ``1/keep`` are float32 values made on the host, so nothing here waits
    for the device.
    """
    u = user_ids.to(torch.int64) & _U32
    i = item_ids.to(torch.int64) & _U32
    h = ((u * _M1) & _U32) ^ ((i * _M2) & _U32) ^ (int(salt) & _U32)
    h = h ^ (h >> 16)
    h = (h * _F1) & _U32
    h = h ^ (h >> 15)
    h = (h * _F2) & _U32
    h = h ^ (h >> 16)
    # top 23 bits -> an exact f32 uniform in [0, 1)
    unif = (h >> 9).to(torch.float32) * (1.0 / 8388608.0)
    keep32 = np.float32(keep)
    kept = (unif < float(keep32)) | bool(keep32 >= 1.0)
    return torch.where(kept, float(np.float32(1.0) / keep32), 0.0).to(
        torch.float32)


def gathered_dtype() -> torch.dtype:
    """The type the kernels' gathered tables are rounded to: float32 (no
    rounding) unless ``TEXTGCN_TPU_PALLAS_XDTYPE=bf16`` asks for
    bfloat16; another value raises."""
    env = os.environ.get(XDTYPE_ENV, '').lower()
    if env in ('', 'f32', 'float32'):
        return torch.float32
    if env in ('bf16', 'bfloat16'):
        return torch.bfloat16
    raise ValueError(f'{XDTYPE_ENV}={env!r}: use f32 or bf16')


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and back to float32 (``x`` itself for
    float32)."""
    return x if dtype == torch.float32 else x.to(dtype).to(torch.float32)


def _edges(csr: CSR):
    """Per edge of ``csr``: destination row, source row and the (user,
    item) pair the hash takes, int64."""
    counts = (csr.rowptr[1:] - csr.rowptr[:-1]).to(torch.int64)
    rows = torch.repeat_interleave(
        torch.arange(csr.n_dst, device=csr.col.device), counts,
        output_size=csr.n_edges)
    col = csr.col.to(torch.int64)
    user, item = (rows, col) if csr.dst_is_user else (col, rows)
    return rows, col, user, item


def edge_mask(csr: CSR, salt: int, keep: float):
    """Per edge of ``csr``: destination row, source row (int64) and the
    hash's {0, 1} keep mask as a bool."""
    rows, col, user, item = _edges(csr)
    return rows, col, edge_dropout_scale(user, item, salt, keep) > 0.0


def kept_degree(csr: CSR, salt: int, keep: float) -> torch.Tensor:
    """Each destination's number of edges the hash keeps, float32
    ``(n_dst,)``: the mask-dependent degree of the conv layers."""
    if keep >= 1.0:
        return (csr.rowptr[1:] - csr.rowptr[:-1]).to(torch.float32)
    rows, _, kept = edge_mask(csr, salt, keep)
    deg = torch.zeros(csr.n_dst, dtype=torch.float32, device=csr.col.device)
    return deg.index_add_(0, rows, kept.to(torch.float32))


def _check_args(csr: CSR, x: torch.Tensor, salt: int, keep: float):
    if x.dim() != 2 or x.shape[0] != csr.n_src:
        raise ValueError(f'x must be ({csr.n_src}, d), got {tuple(x.shape)}')
    if x.dtype != torch.float32:
        raise TypeError(f'x must be float32, got {x.dtype}')
    for name in ('rowptr', 'col', 'w'):
        if getattr(csr, name).device != x.device:
            raise ValueError(f'CSR {name} on {getattr(csr, name).device}, '
                             f'x on {x.device}')
    if not 0 <= int(salt) <= _U32:
        raise ValueError(f'salt must be a uint32, got {salt}')
    if not 0.0 < keep <= 1.0:
        raise ValueError(f'keep must be in (0, 1], got {keep}')


def spmm_plain(csr: CSR, x: torch.Tensor, salt: int,
               keep: float) -> torch.Tensor:
    """The plain torch version of K1: hash, gather, scale, ``index_add_``."""
    _check_args(csr, x, salt, keep)
    rows, col, user, item = _edges(csr)
    w = csr.w * edge_dropout_scale(user, item, salt, keep)
    out = torch.zeros((csr.n_dst, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    return out.index_add_(0, rows, x[col] * w[:, None])


@functools.cache
def _kernel_fn():
    """The kernel's C entry point, built and bound at first use."""
    from .. import cuda_build
    fn = cuda_build.load(KERNEL_SOURCE).spmm_dropout_f32
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci,
                   ctypes.c_uint32, ctypes.c_float, ci, ci, ci, ci, vp]
    fn.restype = ci
    return fn


def k1_layout(d: int, aligned16: bool) -> tuple[int, int]:
    """K1's and K2's instance for width ``d``: ``(vec, lanes)``, the floats
    each lane loads at once (4 when ``d % 4 == 0`` and the tables it loads
    and stores in vectors are 16-byte aligned, else 2) and the lanes that
    share a destination row (8, 16 or 32: the fewest that cover ``d`` in
    one strip of ``lanes * vec`` columns, 32 for wider ``d``, which loops
    over strips)."""
    vec = 4 if d % 4 == 0 and aligned16 else 2
    lanes = 8
    while lanes < 32 and lanes * vec < d:
        lanes *= 2
    return vec, lanes


def _check_cuda(name: str, x: torch.Tensor):
    """What K1 and K2 take beyond their plain versions: ``x`` on the card,
    contiguous and 8-byte aligned, with an even ``d > 0``."""
    if x.device.type != 'cuda':
        raise ValueError(f'{name} needs CUDA tensors, x is on {x.device}')
    d = x.shape[1]
    if d == 0 or d % 2:
        raise ValueError(f'the kernel takes an even d > 0, got d={d}')
    if not x.is_contiguous() or x.data_ptr() % 8:
        raise ValueError('x must be contiguous and 8-byte aligned')


def spmm_dropout_cuda(csr: CSR, x: torch.Tensor, salt: int,
                      keep: float) -> torch.Tensor:
    """Launch K1 on PyTorch's current stream; ``out`` is allocated here,
    and a split schedule's partial rows at the first launch of each ``d``.
    Launches on one CSR share its schedule's counters and partials, so they
    run in stream order, as PyTorch's one current stream orders them.

    Raises on anything the kernel does not take: a tensor off the card,
    another dtype, a non-contiguous or misaligned ``x``, an odd ``d``.
    """
    _check_args(csr, x, salt, keep)
    _check_cuda('spmm_dropout_cuda', x)
    d = x.shape[1]
    if (csr.rowptr.dtype, csr.col.dtype, csr.w.dtype) != (
            torch.int32, torch.int32, torch.float32):
        raise TypeError('CSR must be int32 rowptr/col and float32 w')
    out = torch.empty((csr.n_dst, d), dtype=torch.float32, device=x.device)
    if csr.n_dst == 0:
        return out
    fn = _kernel_fn()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    vec, lanes = k1_layout(d, x.data_ptr() % 16 == 0)
    sp = csr.split
    if sp is None:
        work = first = arrivals = partials = None
        n_chunks = split_len = 0
    else:
        buf = sp.partials.get(d)
        if buf is None:
            buf = sp.partials[d] = torch.empty(
                (sp.work.shape[0], d), dtype=torch.float32, device=x.device)
        work, first, arrivals, partials = (
            t.data_ptr() for t in (sp.work, sp.first, sp.arrivals, buf))
        n_chunks, split_len = sp.work.shape[0], sp.split_len
    rc = fn(csr.rowptr.data_ptr(), csr.col.data_ptr(), csr.w.data_ptr(),
            x.data_ptr(), out.data_ptr(), work, first, arrivals, partials,
            csr.n_dst, n_chunks, split_len, d, int(salt), float(keep),
            int(csr.dst_is_user), vec, lanes, x.device.index or 0, stream)
    if rc:
        raise RuntimeError(f'spmm_dropout kernel launch failed: CUDA error '
                           f'{rc}')
    spmm_dropout_cuda.launches += 1
    spmm_dropout_cuda.split_launches += sp is not None
    return out


spmm_dropout_cuda.launches = 0
spmm_dropout_cuda.split_launches = 0


def spmm(csr: CSR, x: torch.Tensor, salt: int, keep: float) -> torch.Tensor:
    """One direction: the plain version for a CPU tensor, the kernel for a
    CUDA tensor."""
    if x.device.type == 'cpu':
        return spmm_plain(csr, x, salt, keep)
    if x.device.type == 'cuda':
        return spmm_dropout_cuda(csr, x, salt, keep)
    raise ValueError(f'no SpMM for device {x.device}')


def _check_weighted_args(csr: CSR, w: torch.Tensor, x: torch.Tensor):
    _check_args(csr, x, 0, 1.0)
    if w.shape != (csr.n_edges,) or w.dtype != torch.float32:
        raise ValueError(f'w must be float32 ({csr.n_edges},), got '
                         f'{w.dtype} {tuple(w.shape)}')
    if w.device != x.device:
        raise ValueError(f'w on {w.device}, x on {x.device}')


def spmm_weighted_plain(csr: CSR, w: torch.Tensor,
                        x: torch.Tensor) -> torch.Tensor:
    """The plain torch version of K2: gather, scale by ``w``,
    ``index_add_``."""
    _check_weighted_args(csr, w, x)
    rows, col, _, _ = _edges(csr)
    out = torch.zeros((csr.n_dst, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    return out.index_add_(0, rows, x[col] * w[:, None])


@functools.cache
def _weighted_fn():
    """K2's C entry point, built and bound at first use."""
    from .. import cuda_build
    fn = cuda_build.load(WEIGHTED_SOURCE).spmm_weighted_f32
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
    fn.restype = ci
    return fn


def spmm_weighted_cuda(csr: CSR, w: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """Launch K2 on PyTorch's current stream; ``out`` is allocated here.

    ``w`` holds one float32 weight per edge of ``csr``, in CSR order
    (``csr.w`` is not read).  Raises on anything the kernel does not take,
    as ``spmm_dropout_cuda`` does.
    """
    _check_weighted_args(csr, w, x)
    _check_cuda('spmm_weighted_cuda', x)
    d = x.shape[1]
    if not w.is_contiguous():
        raise ValueError('w must be contiguous')
    if (csr.rowptr.dtype, csr.col.dtype) != (torch.int32, torch.int32):
        raise TypeError('CSR must be int32 rowptr/col')
    out = torch.empty((csr.n_dst, d), dtype=torch.float32, device=x.device)
    if csr.n_dst == 0:
        return out
    fn = _weighted_fn()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    vec, lanes = k1_layout(d, x.data_ptr() % 16 == 0
                           and out.data_ptr() % 16 == 0)
    rc = fn(csr.rowptr.data_ptr(), csr.col.data_ptr(), w.data_ptr(),
            x.data_ptr(), out.data_ptr(), csr.n_dst, d, vec, lanes,
            x.device.index or 0, stream)
    if rc:
        raise RuntimeError(f'spmm_weighted kernel launch failed: CUDA error '
                           f'{rc}')
    spmm_weighted_cuda.launches += 1
    return out


spmm_weighted_cuda.launches = 0


def spmm_weighted(csr: CSR, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One direction with the caller's weights: the plain version for a CPU
    tensor, K2 for a CUDA tensor."""
    if x.device.type == 'cpu':
        return spmm_weighted_plain(csr, w, x)
    if x.device.type == 'cuda':
        return spmm_weighted_cuda(csr, w, x)
    raise ValueError(f'no SpMM for device {x.device}')


class _SpMM(torch.autograd.Function):
    """One direction with its gradient: the backward runs ``spmm`` over
    the transpose CSR with the forward's salt and keep.  The hash is a
    function of the (user, item) pair, so both passes drop the same
    edges.  Each pass rounds the table it gathers to ``x_dtype``."""

    @staticmethod
    def forward(ctx, x, fwd: CSR, bwd: CSR, salt: int, keep: float,
                x_dtype: torch.dtype = torch.float32):
        ctx.bwd, ctx.salt, ctx.keep, ctx.x_dtype = bwd, salt, keep, x_dtype
        return spmm(fwd, round_to(x, x_dtype), salt, keep)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        g = round_to(g.contiguous(), ctx.x_dtype)
        return (spmm(ctx.bwd, g, ctx.salt, ctx.keep),
                None, None, None, None, None)


class GraphOp:
    """Both propagation directions of the bipartite graph.

    Same interface as the JAX package's graph ops: ``weights(generator,
    dropout)`` gives the per-direction ``(salt, keep)`` pairs, then
    ``to_user(item_emb, pair)`` and ``to_item(user_emb, pair)``.  Holds one
    destination-sorted CSR per direction, built on the host; each is the
    other's transpose, so a direction's backward runs on the other CSR.
    ``x_dtype`` is ``gathered_dtype()`` at construction.
    """

    def __init__(self, edge_user, edge_item, edge_weight, n_users: int,
                 n_items: int, device):
        self.n_users = int(n_users)
        self.n_items = int(n_items)
        self.x_dtype = gathered_dtype()
        self.l_i2u = build_csr(edge_user, edge_item, edge_weight,
                               self.n_users, self.n_items, True, device)
        self.l_u2i = build_csr(edge_item, edge_user, edge_weight,
                               self.n_items, self.n_users, False, device)

    def weights(self, generator: torch.Generator | None = None,
                dropout: float = 0.0):
        return hash_dropout_salts(generator, dropout)

    def csr_pair(self, direction: str) -> tuple[CSR, CSR]:
        """``(forward CSR, its transpose)`` of ``direction`` ('to_user' |
        'to_item')."""
        if direction == 'to_user':
            return self.l_i2u, self.l_u2i
        if direction == 'to_item':
            return self.l_u2i, self.l_i2u
        raise ValueError(f'unknown direction {direction!r}')

    def to_user(self, item_emb: torch.Tensor, w_pair) -> torch.Tensor:
        """users = R @ items."""
        return _SpMM.apply(item_emb, self.l_i2u, self.l_u2i, *w_pair,
                           self.x_dtype)

    def to_item(self, user_emb: torch.Tensor, w_pair) -> torch.Tensor:
        """items = R^T @ users."""
        return _SpMM.apply(user_emb, self.l_u2i, self.l_i2u, *w_pair,
                           self.x_dtype)
