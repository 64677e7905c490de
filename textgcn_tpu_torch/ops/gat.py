"""GAT attention over one bipartite direction: kernels K3 and K4 and their
plain twins.

Counterpart of the GAT half of ``textgcn_tpu/ops/pallas_gat.py``
(``gat_att_fused``, ``_gas_fwd``/``_gas_bwd``, ``gat_direction``).  Over
a destination-sorted CSR (the same ``CSR`` as K1's; only its structure is
read, the attention's edge weight is 1) one direction computes, for every
destination ``j`` and its incoming sources ``i``,

    z_ij  = leaky(s_i + d_j, 0.2)           masked to NEG where dropped
    m_j   = max_i z_ij over surviving edges  (NEG when none survives)
    e_ij  = mask_ij * exp(z_ij - m_j)
    num_j = sum_i e_ij h_i,   den_j = sum_i e_ij

with ``mask_ij`` in {0, 1} from the same (user, item, salt) hash as K1
(``edge_dropout_scale > 0``; not K1's 1/keep scale).  The backward, with
the shift ``m`` held constant (softmax shift invariance), is

    dz_ij = e_ij * (g_num_j . h_i + g_den_j) * leaky'(z_ij)
    dh_i  = sum_j e_ij g_num_j,  ds_i = sum_j dz_ij,  dd_j = sum_i dz_ij

with ``leaky'(0) = 1`` as in ``jax.nn.leaky_relu``.  It runs over the
transpose CSR (one row per forward source ``i``), where the hash's user
slot flips with the layout.

* ``gat_fwd_cuda`` launches K3 (``csrc/gat_fwd.cu``) and ``gat_bwd_cuda``
  launches K4 (``csrc/gat_bwd.cu``); each counts its launches in
  ``.launches``.
* ``gat_att_plain`` and ``gat_bwd_plain`` are the same functions in plain
  torch; the CPU path and the on-card comparison use them.
* ``gat_direction`` folds in the never-dropped self loop outside the
  autograd boundary, exactly as ``pallas_gat.py:615-637`` does.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from .spmm import CSR, _check_args, edge_dropout_scale

NEG = -2.0 ** 100    # masked-logit sentinel of the JAX package
SLOPE = 0.2          # torch_geometric's LeakyReLU slope
MAX_D = 256          # the kernels keep up to 4 float2 per lane
FWD_SOURCE = 'gat_fwd.cu'
BWD_SOURCE = 'gat_bwd.cu'


def leaky(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z >= 0, z, SLOPE * z)


def _edges(csr: CSR, salt: int, keep: float):
    """Per edge: destination row, source row (int64) and the {0, 1} keep
    mask as a bool."""
    counts = (csr.rowptr[1:] - csr.rowptr[:-1]).to(torch.int64)
    rows = torch.repeat_interleave(
        torch.arange(csr.n_dst, device=csr.col.device), counts,
        output_size=csr.n_edges)
    col = csr.col.to(torch.int64)
    user, item = (rows, col) if csr.dst_is_user else (col, rows)
    kept = edge_dropout_scale(user, item, salt, keep) > 0.0
    return rows, col, kept


def _check_vec(name: str, v: torch.Tensor, n: int, like: torch.Tensor):
    if v.shape != (n,) or v.dtype != torch.float32 or v.device != like.device:
        raise ValueError(f'{name} must be float32 ({n},) on {like.device}, '
                         f'got {v.dtype} {tuple(v.shape)} on {v.device}')


def gat_att_plain(csr: CSR, h_src: torch.Tensor, s_src: torch.Tensor,
                  d_dst: torch.Tensor, salt: int, keep: float):
    """The plain torch version of K3: ``(num (n_dst, d), den (n_dst,),
    m_edge (n_dst,))``."""
    _check_args(csr, h_src, salt, keep)
    _check_vec('s_src', s_src, csr.n_src, h_src)
    _check_vec('d_dst', d_dst, csr.n_dst, h_src)
    rows, col, kept = _edges(csr, salt, keep)
    z = torch.where(kept, leaky(s_src[col] + d_dst[rows]), NEG)
    m = torch.full((csr.n_dst,), NEG, dtype=torch.float32,
                   device=h_src.device)
    m = m.scatter_reduce(0, rows, z, reduce='amax', include_self=True)
    e = torch.where(kept, torch.exp(z - m[rows]), 0.0)
    num = torch.zeros((csr.n_dst, h_src.shape[1]), dtype=torch.float32,
                      device=h_src.device)
    num.index_add_(0, rows, h_src[col] * e[:, None])
    den = torch.zeros(csr.n_dst, dtype=torch.float32, device=h_src.device)
    den.index_add_(0, rows, e)
    return num, den, m


def gat_bwd_plain(csr_t: CSR, h_src: torch.Tensor, s_src: torch.Tensor,
                  d_dst: torch.Tensor, m_dst: torch.Tensor,
                  g_num: torch.Tensor, g_den: torch.Tensor, salt: int,
                  keep: float):
    """The plain torch version of K4: ``(dh (n_src, d), ds (n_src,), dd
    (n_dst,))``.  ``csr_t`` is the transpose of the forward CSR: its rows
    are the forward sources ``i``, its columns the destinations ``j``."""
    n_src, n_dst = csr_t.n_dst, csr_t.n_src
    _check_args(csr_t, g_num, salt, keep)
    if h_src.shape != (n_src, g_num.shape[1]) or h_src.dtype != torch.float32:
        raise ValueError(f'h_src must be float32 ({n_src}, '
                         f'{g_num.shape[1]}), got {tuple(h_src.shape)}')
    _check_vec('s_src', s_src, n_src, g_num)
    for name, v in (('d_dst', d_dst), ('m_dst', m_dst), ('g_den', g_den)):
        _check_vec(name, v, n_dst, g_num)
    src, dst, kept = _edges(csr_t, salt, keep)
    z = s_src[src] + d_dst[dst]
    zm = torch.where(kept, leaky(z), NEG)
    e = torch.where(kept, torch.exp(zm - m_dst[dst]), 0.0)
    g = g_num[dst]
    dz = e * ((g * h_src[src]).sum(dim=1) + g_den[dst]) \
        * torch.where(z >= 0, 1.0, SLOPE)
    dh = torch.zeros_like(h_src).index_add_(0, src, g * e[:, None])
    ds = torch.zeros_like(s_src).index_add_(0, src, dz)
    dd = torch.zeros_like(d_dst).index_add_(0, dst, dz)
    return dh, ds, dd


@functools.cache
def _kernel_fn(source: str, symbol: str, n_ptr: int):
    """A kernel's C entry point, built and bound at first use: ``n_ptr``
    pointers, then ``n_rows, d, salt, keep, dst_is_user, device,
    stream``."""
    from .. import cuda_build
    fn = getattr(cuda_build.load(source), symbol)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * n_ptr + [ci, ci, ctypes.c_uint32, ctypes.c_float,
                                  ci, ci, vp]
    fn.restype = ci
    return fn


def _check_cuda(name: str, d: int, tensors):
    for t in tensors:
        if t.device.type != 'cuda':
            raise ValueError(f'{name} needs CUDA tensors, got one on '
                             f'{t.device}')
        if not t.is_contiguous() or t.data_ptr() % 8:
            raise ValueError(f'{name}: tensors must be contiguous and '
                             '8-byte aligned')
    if d == 0 or d % 2 or d > MAX_D:
        raise ValueError(f'{name} takes an even d in (0, {MAX_D}], '
                         f'got d={d}')


def _launch(name: str, fn, ptrs, n_rows: int, d: int, csr: CSR, salt: int,
            keep: float, device: torch.device):
    if (csr.rowptr.dtype, csr.col.dtype) != (torch.int32, torch.int32):
        raise TypeError('CSR must be int32 rowptr/col')
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(*ptrs, n_rows, d, int(salt), float(keep), int(csr.dst_is_user),
            device.index or 0, stream)
    if rc:
        raise RuntimeError(f'{name} kernel launch failed: CUDA error {rc}')


def gat_fwd_cuda(csr: CSR, h_src: torch.Tensor, s_src: torch.Tensor,
                 d_dst: torch.Tensor, salt: int, keep: float):
    """Launch K3 on PyTorch's current stream; outputs allocated here."""
    _check_args(csr, h_src, salt, keep)
    _check_vec('s_src', s_src, csr.n_src, h_src)
    _check_vec('d_dst', d_dst, csr.n_dst, h_src)
    d = h_src.shape[1]
    _check_cuda('gat_fwd_cuda', d, (h_src, s_src, d_dst))
    dev = h_src.device
    num = torch.empty((csr.n_dst, d), dtype=torch.float32, device=dev)
    den = torch.empty(csr.n_dst, dtype=torch.float32, device=dev)
    m = torch.empty(csr.n_dst, dtype=torch.float32, device=dev)
    if csr.n_dst == 0:
        return num, den, m
    fn = _kernel_fn(FWD_SOURCE, 'gat_fwd_f32', 8)
    _launch('gat_fwd', fn,
            (csr.rowptr.data_ptr(), csr.col.data_ptr(), h_src.data_ptr(),
             s_src.data_ptr(), d_dst.data_ptr(), num.data_ptr(),
             den.data_ptr(), m.data_ptr()),
            csr.n_dst, d, csr, salt, keep, dev)
    gat_fwd_cuda.launches += 1
    return num, den, m


gat_fwd_cuda.launches = 0


def gat_bwd_cuda(csr_t: CSR, h_src: torch.Tensor, s_src: torch.Tensor,
                 d_dst: torch.Tensor, m_dst: torch.Tensor,
                 g_num: torch.Tensor, g_den: torch.Tensor, salt: int,
                 keep: float):
    """Launch K4 on PyTorch's current stream over the transpose CSR;
    ``dd`` is summed with one float ``atomicAdd`` per edge into a zeroed
    buffer allocated here."""
    n_src, n_dst = csr_t.n_dst, csr_t.n_src
    _check_args(csr_t, g_num, salt, keep)
    d = g_num.shape[1]
    if h_src.shape != (n_src, d) or h_src.dtype != torch.float32:
        raise ValueError(f'h_src must be float32 ({n_src}, {d}), got '
                         f'{tuple(h_src.shape)}')
    _check_vec('s_src', s_src, n_src, g_num)
    for name, v in (('d_dst', d_dst), ('m_dst', m_dst), ('g_den', g_den)):
        _check_vec(name, v, n_dst, g_num)
    _check_cuda('gat_bwd_cuda', d,
                (h_src, s_src, d_dst, m_dst, g_num, g_den))
    dev = g_num.device
    dh = torch.empty((n_src, d), dtype=torch.float32, device=dev)
    ds = torch.empty(n_src, dtype=torch.float32, device=dev)
    dd = torch.zeros(n_dst, dtype=torch.float32, device=dev)
    if n_src == 0:
        return dh, ds, dd
    fn = _kernel_fn(BWD_SOURCE, 'gat_bwd_f32', 11)
    _launch('gat_bwd', fn,
            (csr_t.rowptr.data_ptr(), csr_t.col.data_ptr(),
             h_src.data_ptr(), s_src.data_ptr(), d_dst.data_ptr(),
             m_dst.data_ptr(), g_num.data_ptr(), g_den.data_ptr(),
             dh.data_ptr(), ds.data_ptr(), dd.data_ptr()),
            n_src, d, csr_t, salt, keep, dev)
    gat_bwd_cuda.launches += 1
    return dh, ds, dd


gat_bwd_cuda.launches = 0


def _by_device(t: torch.Tensor, cpu_fn, cuda_fn):
    if t.device.type == 'cpu':
        return cpu_fn
    if t.device.type == 'cuda':
        return cuda_fn
    raise ValueError(f'no GAT attention for device {t.device}')


class _GatAttention(torch.autograd.Function):
    """``(num, den, m_edge)`` of one direction: K3 forward and K4 backward
    on CUDA tensors, the plain versions on CPU tensors.  ``m_edge`` carries
    no gradient."""

    @staticmethod
    def forward(ctx, h_src, s_src, d_dst, fwd: CSR, bwd: CSR, salt: int,
                keep: float):
        fn = _by_device(h_src, gat_att_plain, gat_fwd_cuda)
        num, den, m = fn(fwd, h_src, s_src, d_dst, salt, keep)
        ctx.save_for_backward(h_src, s_src, d_dst, m)
        ctx.bwd, ctx.salt, ctx.keep = bwd, salt, keep
        ctx.mark_non_differentiable(m)
        return num, den, m

    @staticmethod
    @once_differentiable
    def backward(ctx, g_num, g_den, _g_m):
        h_src, s_src, d_dst, m = ctx.saved_tensors
        fn = _by_device(h_src, gat_bwd_plain, gat_bwd_cuda)
        dh, ds, dd = fn(ctx.bwd, h_src, s_src, d_dst, m,
                        g_num.contiguous(), g_den.contiguous(), ctx.salt,
                        ctx.keep)
        return dh, ds, dd, None, None, None, None


def gat_att(op, direction: str, h_src, s_src, d_dst, salt: int,
            keep: float):
    """``(num, den, m_edge)`` of ``direction`` ('to_user' | 'to_item') over
    the ``GraphOp`` ``op``'s CSRs, differentiable in h, s and d."""
    if direction == 'to_user':
        fwd, bwd = op.l_i2u, op.l_u2i
    elif direction == 'to_item':
        fwd, bwd = op.l_u2i, op.l_i2u
    else:
        raise ValueError(f'unknown direction {direction!r}')
    return _GatAttention.apply(h_src, s_src, d_dst, fwd, bwd, salt, keep)


def gat_direction(op, direction: str, h_src, h_dst, s_src, s_dst, d_dst,
                  salt: int, keep: float) -> torch.Tensor:
    """One GAT direction with the never-dropped self loop: the (n_dst, d)
    softmax-weighted sum over surviving incoming edges plus the self loop
    (logit ``leaky(s_dst + d_dst)``, message ``h_dst``).  The kernel's
    ``(num, den)`` are relative to the edge max; folding in the self
    loop's shift is one row rescale, and both shifts are constants."""
    num, den, m_edge = gat_att(op, direction, h_src, s_src, d_dst, salt,
                               keep)
    m_edge = m_edge[:, None]
    z_self = leaky(s_dst + d_dst)[:, None]
    m = torch.maximum(m_edge, z_self.detach())
    r = torch.exp(m_edge - m)    # 0 where no edge survives
    e_self = torch.exp(z_self - m)
    return (num * r + e_self * h_dst) / (den[:, None] * r + e_self)
