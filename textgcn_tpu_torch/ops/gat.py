"""GAT and GATv2 attention over one bipartite direction: kernels K3, K4,
K5 and K6 and their plain twins.

Counterpart of ``textgcn_tpu/ops/pallas_gat.py``.  The GAT half
(``gat_att_fused``, ``_gas_fwd``/``_gas_bwd``, ``gat_direction``): over
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
  ``.launches``, and in ``.long_row_launches`` those over a CSR with a row
  longer than ``spmm.SPLIT_LEN`` edges, which one group walks alone
  (``CSR.split_rows``, known since the CSR was built).
* ``gat_att_plain`` and ``gat_bwd_plain`` are the same functions in plain
  torch; the CPU path and the on-card comparison use them.
* ``gat_direction`` folds in the never-dropped self loop outside the
  autograd boundary, exactly as ``pallas_gat.py:615-637`` does.  It runs
  in the span ``conv.attention`` and K4 in ``conv.attention.backward``
  (``utils/profiling.span``).

The GATv2 half (``gatv2_att_fused``, ``_g2s_fwd``/``_g2s_bwd``,
``gatv2_direction``) has a d-dim logit per edge and two tables,
``hs`` on the source side and ``hd`` on the destination side:

    u_ij  = hs_i + hd_j,    z_ij = a . leaky(u_ij)   masked to NEG
    m_j, e_ij, den_j as above,   num_j = sum_i e_ij hs_i

and with ``m`` held constant, ``lam_ij = leaky'(u_ij) * a`` (a d-vector),

    dz_ij = e_ij * (g_num_j . hs_i + g_den_j)
    dhs_i = sum_j (e_ij g_num_j + dz_ij lam_ij)
    dhd_j = sum_i dz_ij lam_ij,      da = sum_ij dz_ij leaky(u_ij)

* ``gatv2_fwd_cuda`` launches K5 (``csrc/gatv2_fwd.cu``) and
  ``gatv2_bwd_cuda`` launches K6 (``csrc/gatv2_bwd.cu``), each counting
  in ``.launches``; ``gatv2_att_plain`` and ``gatv2_bwd_plain`` are their
  plain twins.
* ``gatv2_direction`` folds in the self loop (logit ``a .
  leaky(hs_dst + hd_dst)``, message ``hs_dst``) as
  ``pallas_gat.py:974-987`` does.

A direction reads its CSR and the transpose from ``op.csr_pair`` (on a
destination shard the transpose is the shard's own, not the other
direction's CSR).  Under ``TEXTGCN_TPU_PALLAS_XDTYPE=bf16`` (the op's
``x_dtype``) the tables a kernel gathers are rounded to bfloat16 before
the f32 kernel, the ones the JAX package casts to ``x_dtype``: K3's
``h_src``, K5's ``hs_src``, K4's ``g_num``, K6's ``hd_dst`` and
``g_num`` (``pallas_gat.py:559, 596, 909, 953-954``).  The default
rounds nothing.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from ..utils.profiling import span
from .spmm import CSR, _check_args, edge_mask, round_to

NEG = -2.0 ** 100    # masked-logit sentinel of the JAX package
SLOPE = 0.2          # torch_geometric's LeakyReLU slope
MAX_D = 256          # K3-K6 keep up to 4 float4 (8 float2) a lane
FWD_SOURCE = 'gat_fwd.cu'
BWD_SOURCE = 'gat_bwd.cu'
V2_FWD_SOURCE = 'gatv2_fwd.cu'
V2_BWD_SOURCE = 'gatv2_bwd.cu'


def leaky(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z >= 0, z, SLOPE * z)


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
    rows, col, kept = edge_mask(csr, salt, keep)
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
    src, dst, kept = edge_mask(csr_t, salt, keep)
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
def _kernel_fn(source: str, symbol: str, n_ptr: int, n_layout: int = 0):
    """A kernel's C entry point, built and bound at first use: ``n_ptr``
    pointers, then ``n_rows, d, salt, keep, dst_is_user``, ``n_layout``
    ints that pick the kernel's instance, ``device, stream``."""
    from .. import cuda_build
    fn = getattr(cuda_build.load(source), symbol)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * n_ptr + [ci, ci, ctypes.c_uint32, ctypes.c_float,
                                  ci] + [ci] * n_layout + [ci, vp]
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
            keep: float, device: torch.device, layout=()):
    if (csr.rowptr.dtype, csr.col.dtype) != (torch.int32, torch.int32):
        raise TypeError('CSR must be int32 rowptr/col')
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(*ptrs, n_rows, d, int(salt), float(keep), int(csr.dst_is_user),
            *layout, device.index or 0, stream)
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
    fn = _kernel_fn(FWD_SOURCE, 'gat_fwd_f32', 8, n_layout=2)
    _launch('gat_fwd', fn,
            (csr.rowptr.data_ptr(), csr.col.data_ptr(), h_src.data_ptr(),
             s_src.data_ptr(), d_dst.data_ptr(), num.data_ptr(),
             den.data_ptr(), m.data_ptr()),
            csr.n_dst, d, csr, salt, keep, dev,
            layout=_pick_layout(d, (h_src, num)))
    gat_fwd_cuda.launches += 1
    gat_fwd_cuda.long_row_launches += csr.split_rows > 0
    return num, den, m


gat_fwd_cuda.launches = 0
gat_fwd_cuda.long_row_launches = 0


def att_layout(d: int, aligned16: bool) -> tuple[int, int]:
    """The instance of K3, K4, K5 or K6 for width ``d`` (even, at most
    ``MAX_D``): ``(vec, per)``, the floats of one vector (4 when ``d % 4 ==
    0`` and every table is 16-byte aligned, else 2) and the vectors each of
    a half-warp's 16 lanes holds (1, 2, 4 or, for float2, 8: the fewest
    that cover ``d``)."""
    vec = 4 if d % 4 == 0 and aligned16 else 2
    per = 1
    while 16 * vec * per < d:
        per *= 2
    return vec, per


def _pick_layout(d: int, tables) -> tuple[int, int]:
    return att_layout(d, all(t.data_ptr() % 16 == 0 for t in tables))


def gat_bwd_cuda(csr_t: CSR, h_src: torch.Tensor, s_src: torch.Tensor,
                 d_dst: torch.Tensor, m_dst: torch.Tensor,
                 g_num: torch.Tensor, g_den: torch.Tensor, salt: int,
                 keep: float):
    """Launch K4 on PyTorch's current stream over the transpose CSR;
    ``dd`` is summed with one float ``atomicAdd`` per kept edge into a
    zeroed buffer allocated here."""
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
    fn = _kernel_fn(BWD_SOURCE, 'gat_bwd_f32', 11, n_layout=2)
    _launch('gat_bwd', fn,
            (csr_t.rowptr.data_ptr(), csr_t.col.data_ptr(),
             h_src.data_ptr(), s_src.data_ptr(), d_dst.data_ptr(),
             m_dst.data_ptr(), g_num.data_ptr(), g_den.data_ptr(),
             dh.data_ptr(), ds.data_ptr(), dd.data_ptr()),
            n_src, d, csr_t, salt, keep, dev,
            layout=_pick_layout(d, (h_src, g_num, dh)))
    gat_bwd_cuda.launches += 1
    gat_bwd_cuda.long_row_launches += csr_t.split_rows > 0
    return dh, ds, dd


gat_bwd_cuda.launches = 0
gat_bwd_cuda.long_row_launches = 0


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
                keep: float, x_dtype: torch.dtype = torch.float32):
        fn = _by_device(h_src, gat_att_plain, gat_fwd_cuda)
        num, den, m = fn(fwd, round_to(h_src, x_dtype), s_src, d_dst, salt,
                         keep)
        ctx.save_for_backward(h_src, s_src, d_dst, m)
        ctx.bwd, ctx.salt, ctx.keep, ctx.x_dtype = bwd, salt, keep, x_dtype
        ctx.mark_non_differentiable(m)
        return num, den, m

    @staticmethod
    @once_differentiable
    def backward(ctx, g_num, g_den, _g_m):
        h_src, s_src, d_dst, m = ctx.saved_tensors
        fn = _by_device(h_src, gat_bwd_plain, gat_bwd_cuda)
        with span('conv.attention.backward'):
            dh, ds, dd = fn(ctx.bwd, h_src, s_src, d_dst, m,
                            round_to(g_num.contiguous(), ctx.x_dtype),
                            g_den.contiguous(), ctx.salt, ctx.keep)
        return dh, ds, dd, None, None, None, None, None


def gat_att(op, direction: str, h_src, s_src, d_dst, salt: int,
            keep: float):
    """``(num, den, m_edge)`` of ``direction`` ('to_user' | 'to_item') over
    ``op.csr_pair(direction)``, differentiable in h, s and d."""
    fwd, bwd = op.csr_pair(direction)
    return _GatAttention.apply(h_src, s_src, d_dst, fwd, bwd, salt, keep,
                               op.x_dtype)


def _fold_self_loop(num, den, m_edge, z_self, msg_self) -> torch.Tensor:
    """The softmax over the kept edges plus the self loop (logit
    ``z_self``, message ``msg_self``).  The kernel's ``(num, den)`` are
    relative to the edge max; folding in the self loop's shift is one row
    rescale, and both shifts are constants."""
    m_edge = m_edge[:, None]
    z_self = z_self[:, None]
    m = torch.maximum(m_edge, z_self.detach())
    r = torch.exp(m_edge - m)    # 0 where no edge survives
    e_self = torch.exp(z_self - m)
    return (num * r + e_self * msg_self) / (den[:, None] * r + e_self)


def gat_direction(op, direction: str, h_src, h_dst, s_src, s_dst, d_dst,
                  salt: int, keep: float) -> torch.Tensor:
    """One GAT direction with the never-dropped self loop: the (n_dst, d)
    softmax-weighted sum over surviving incoming edges plus the self loop
    (logit ``leaky(s_dst + d_dst)``, message ``h_dst``); in the span
    ``conv.attention``."""
    with span('conv.attention'):
        num, den, m_edge = gat_att(op, direction, h_src, s_src, d_dst, salt,
                                   keep)
        return _fold_self_loop(num, den, m_edge, leaky(s_dst + d_dst),
                               h_dst)


# --- GATv2 -------------------------------------------------------------------

def _check_table(name: str, t: torch.Tensor, n: int, d: int,
                 like: torch.Tensor):
    if t.shape != (n, d) or t.dtype != torch.float32 \
            or t.device != like.device:
        raise ValueError(f'{name} must be float32 ({n}, {d}) on '
                         f'{like.device}, got {t.dtype} {tuple(t.shape)} on '
                         f'{t.device}')


def _check_v2_fwd(csr: CSR, hs_src, hd_dst, a, salt, keep) -> int:
    _check_args(csr, hs_src, salt, keep)
    d = hs_src.shape[1]
    _check_table('hd_dst', hd_dst, csr.n_dst, d, hs_src)
    _check_vec('a', a, d, hs_src)
    return d


def _check_v2_bwd(csr_t: CSR, hs_src, hd_dst, a, m_dst, g_num, g_den, salt,
                  keep) -> int:
    n_src, n_dst = csr_t.n_dst, csr_t.n_src
    _check_args(csr_t, g_num, salt, keep)
    d = g_num.shape[1]
    _check_table('hs_src', hs_src, n_src, d, g_num)
    _check_table('hd_dst', hd_dst, n_dst, d, g_num)
    _check_vec('a', a, d, g_num)
    for name, v in (('m_dst', m_dst), ('g_den', g_den)):
        _check_vec(name, v, n_dst, g_num)
    return d


def gatv2_att_plain(csr: CSR, hs_src: torch.Tensor, hd_dst: torch.Tensor,
                    a: torch.Tensor, salt: int, keep: float):
    """The plain torch version of K5: ``(num (n_dst, d), den (n_dst,),
    m_edge (n_dst,))``."""
    _check_v2_fwd(csr, hs_src, hd_dst, a, salt, keep)
    rows, col, kept = edge_mask(csr, salt, keep)
    hs = hs_src[col]
    z = torch.where(kept, leaky(hs + hd_dst[rows]) @ a, NEG)
    m = torch.full((csr.n_dst,), NEG, dtype=torch.float32,
                   device=hs_src.device)
    m = m.scatter_reduce(0, rows, z, reduce='amax', include_self=True)
    e = torch.where(kept, torch.exp(z - m[rows]), 0.0)
    num = torch.zeros((csr.n_dst, hs_src.shape[1]), dtype=torch.float32,
                      device=hs_src.device)
    num.index_add_(0, rows, hs * e[:, None])
    den = torch.zeros(csr.n_dst, dtype=torch.float32, device=hs_src.device)
    den.index_add_(0, rows, e)
    return num, den, m


def gatv2_bwd_plain(csr_t: CSR, hs_src: torch.Tensor, hd_dst: torch.Tensor,
                    a: torch.Tensor, m_dst: torch.Tensor,
                    g_num: torch.Tensor, g_den: torch.Tensor, salt: int,
                    keep: float):
    """The plain torch version of K6: ``(dhs (n_src, d), dhd (n_dst, d),
    da (d,))``.  ``csr_t`` is the transpose of the forward CSR: its rows
    are the forward sources ``i``, its columns the destinations ``j``."""
    _check_v2_bwd(csr_t, hs_src, hd_dst, a, m_dst, g_num, g_den, salt, keep)
    src, dst, kept = edge_mask(csr_t, salt, keep)
    hs = hs_src[src]
    u = hs + hd_dst[dst]
    lk = leaky(u)
    z = torch.where(kept, lk @ a, NEG)
    e = torch.where(kept, torch.exp(z - m_dst[dst]), 0.0)
    g = g_num[dst]
    dz = e * ((g * hs).sum(dim=1) + g_den[dst])
    lam_dz = torch.where(u >= 0, 1.0, SLOPE) * a * dz[:, None]
    dhs = torch.zeros_like(hs_src).index_add_(0, src,
                                              g * e[:, None] + lam_dz)
    dhd = torch.zeros_like(hd_dst).index_add_(0, dst, lam_dz)
    da = (lk * dz[:, None]).sum(dim=0)
    return dhs, dhd, da


def gatv2_fwd_cuda(csr: CSR, hs_src: torch.Tensor, hd_dst: torch.Tensor,
                   a: torch.Tensor, salt: int, keep: float):
    """Launch K5 on PyTorch's current stream; outputs allocated here."""
    d = _check_v2_fwd(csr, hs_src, hd_dst, a, salt, keep)
    _check_cuda('gatv2_fwd_cuda', d, (hs_src, hd_dst, a))
    dev = hs_src.device
    num = torch.empty((csr.n_dst, d), dtype=torch.float32, device=dev)
    den = torch.empty(csr.n_dst, dtype=torch.float32, device=dev)
    m = torch.empty(csr.n_dst, dtype=torch.float32, device=dev)
    if csr.n_dst == 0:
        return num, den, m
    fn = _kernel_fn(V2_FWD_SOURCE, 'gatv2_fwd_f32', 8, n_layout=2)
    _launch('gatv2_fwd', fn,
            (csr.rowptr.data_ptr(), csr.col.data_ptr(), hs_src.data_ptr(),
             hd_dst.data_ptr(), a.data_ptr(), num.data_ptr(),
             den.data_ptr(), m.data_ptr()),
            csr.n_dst, d, csr, salt, keep, dev,
            layout=_pick_layout(d, (hs_src, hd_dst, a, num)))
    gatv2_fwd_cuda.launches += 1
    return num, den, m


gatv2_fwd_cuda.launches = 0


def gatv2_bwd_cuda(csr_t: CSR, hs_src: torch.Tensor, hd_dst: torch.Tensor,
                   a: torch.Tensor, m_dst: torch.Tensor,
                   g_num: torch.Tensor, g_den: torch.Tensor, salt: int,
                   keep: float):
    """Launch K6 on PyTorch's current stream over the transpose CSR.
    ``dhd`` and ``da`` are summed with float ``atomicAdd``s into zeroed
    buffers allocated here; each output's shape is asserted after the
    launch (``dhs`` (n_src, d), ``dhd`` (n_dst, d), ``da`` (d,))."""
    d = _check_v2_bwd(csr_t, hs_src, hd_dst, a, m_dst, g_num, g_den, salt,
                      keep)
    _check_cuda('gatv2_bwd_cuda', d,
                (hs_src, hd_dst, a, m_dst, g_num, g_den))
    n_src, n_dst = csr_t.n_dst, csr_t.n_src
    dev = g_num.device
    dhs = torch.empty((n_src, d), dtype=torch.float32, device=dev)
    dhd = torch.zeros((n_dst, d), dtype=torch.float32, device=dev)
    da = torch.zeros(d, dtype=torch.float32, device=dev)
    if n_src:
        fn = _kernel_fn(V2_BWD_SOURCE, 'gatv2_bwd_f32', 11, n_layout=2)
        _launch('gatv2_bwd', fn,
                (csr_t.rowptr.data_ptr(), csr_t.col.data_ptr(),
                 hs_src.data_ptr(), hd_dst.data_ptr(), a.data_ptr(),
                 m_dst.data_ptr(), g_num.data_ptr(), g_den.data_ptr(),
                 dhs.data_ptr(), dhd.data_ptr(), da.data_ptr()),
                n_src, d, csr_t, salt, keep, dev,
                layout=_pick_layout(d, (hs_src, hd_dst, a, g_num, dhs,
                                        dhd)))
        gatv2_bwd_cuda.launches += 1
    if (dhs.shape, dhd.shape, da.shape) != (hs_src.shape, hd_dst.shape,
                                            a.shape):
        raise RuntimeError(f'gatv2_bwd output shapes {tuple(dhs.shape)}, '
                           f'{tuple(dhd.shape)}, {tuple(da.shape)} do not '
                           f'match the inputs')
    return dhs, dhd, da


gatv2_bwd_cuda.launches = 0


class _Gatv2Attention(torch.autograd.Function):
    """``(num, den, m_edge)`` of one GATv2 direction: K5 forward and K6
    backward on CUDA tensors, the plain versions on CPU tensors.
    ``m_edge`` carries no gradient."""

    @staticmethod
    def forward(ctx, hs_src, hd_dst, a, fwd: CSR, bwd: CSR, salt: int,
                keep: float, x_dtype: torch.dtype = torch.float32):
        fn = _by_device(hs_src, gatv2_att_plain, gatv2_fwd_cuda)
        num, den, m = fn(fwd, round_to(hs_src, x_dtype), hd_dst, a, salt,
                         keep)
        ctx.save_for_backward(hs_src, hd_dst, a, m)
        ctx.bwd, ctx.salt, ctx.keep, ctx.x_dtype = bwd, salt, keep, x_dtype
        ctx.mark_non_differentiable(m)
        return num, den, m

    @staticmethod
    @once_differentiable
    def backward(ctx, g_num, g_den, _g_m):
        hs_src, hd_dst, a, m = ctx.saved_tensors
        fn = _by_device(hs_src, gatv2_bwd_plain, gatv2_bwd_cuda)
        x_dtype = ctx.x_dtype
        dhs, dhd, da = fn(ctx.bwd, hs_src, round_to(hd_dst, x_dtype), a, m,
                          round_to(g_num.contiguous(), x_dtype),
                          g_den.contiguous(), ctx.salt, ctx.keep)
        return dhs, dhd, da, None, None, None, None, None


def gatv2_att(op, direction: str, hs_src, hd_dst, a, salt: int,
              keep: float):
    """``(num, den, m_edge)`` of ``direction`` ('to_user' | 'to_item') over
    ``op.csr_pair(direction)``, differentiable in hs, hd and a."""
    fwd, bwd = op.csr_pair(direction)
    return _Gatv2Attention.apply(hs_src, hd_dst, a, fwd, bwd, salt, keep,
                                 op.x_dtype)


def gatv2_direction(op, direction: str, hs_src, hs_dst, hd_dst, a,
                    salt: int, keep: float) -> torch.Tensor:
    """One GATv2 direction with the never-dropped self loop (logit ``a .
    leaky(hs_dst + hd_dst)``, message ``hs_dst``), folded in as
    ``gat_direction`` folds GAT's: both shifts are constants."""
    num, den, m_edge = gatv2_att(op, direction, hs_src, hd_dst, a, salt,
                                 keep)
    return _fold_self_loop(num, den, m_edge, (leaky(hs_dst + hd_dst) @ a),
                           hs_dst)
