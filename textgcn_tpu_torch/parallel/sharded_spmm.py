"""Source-row-sharded propagation on kernel K2, combined by reduce-scatter.

Counterpart of ``textgcn_tpu/parallel/pallas_sharded.py``
(``MeshPallasGraphOp``).  Rank ``r`` of ``W`` owns rows ``[r*R, (r+1)*R)``
of each table and, per direction, the edges whose SOURCE row falls there.
One direction on one rank:

1. the per-edge weights ``w_base * edge_dropout_scale(user, item, salt,
   keep)`` in plain torch, on the edges' global ids (``pallas_sharded.py
   :236-237``);
2. K2 (``ops.spmm.spmm_weighted``) over the shard's CSR, which gathers
   the rank's local source rows and spans the full padded destination
   range: a ``(W * R_dst, d)`` partial;
3. ``reduce_scatter_tensor`` of the partials: each rank gets the sum over
   all shards of its own destination rows (``:251``).

The gradient of a direction is the same three steps over the transpose
shard with the forward's ``(salt, keep)`` (``_mgs_bwd``, ``:146-151``):
the transpose shard holds the edges whose destination rows this rank
owns, so it reads the rank's rows of the output gradient.  The hash takes
global ids, so both directions and both passes drop the same edges.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

from ..ops.spmm import (CSR, _edges, build_csr, edge_dropout_scale,
                        hash_dropout_salts, spmm_weighted)
from .mesh import Mesh, collective_dtype


@dataclass(frozen=True)
class Shard:
    """One direction's edges on one rank (the counterpart of a device's
    slice of ``_StackedLayout``)."""
    csr: CSR             # local source rows x the full padded dst range
    users: torch.Tensor  # (E_r,) int64 global user id of each edge, CSR order
    items: torch.Tensor  # (E_r,) int64 global item id


def build_shard(src, dst, w, n_src_padded: int, n_dst_padded: int,
                n_ranks: int, rank: int, dst_is_user: bool, device) -> Shard:
    """Rank ``rank``'s shard of the direction ``src -> dst``: the edges with
    ``src`` in its row range, source ids made local, sorted by (dst, src)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    rows = n_src_padded // n_ranks
    lo = rank * rows
    sel = (src >= lo) & (src < lo + rows)
    csr = build_csr(dst[sel], src[sel] - lo, np.asarray(w)[sel],
                    n_dst_padded, rows, dst_is_user, device)
    dst_ids, col, _, _ = _edges(csr)
    src_ids = col + lo
    users, items = (dst_ids, src_ids) if dst_is_user else (src_ids, dst_ids)
    return Shard(csr, users, items)


class _MeshSpMM(torch.autograd.Function):
    """One sharded direction with its gradient: the backward runs the
    transpose shard on the cotangent with the forward's salt and keep."""

    @staticmethod
    def forward(ctx, x, op, fwd: Shard, bwd: Shard, salt: int, keep: float):
        ctx.op, ctx.bwd, ctx.salt, ctx.keep = op, bwd, salt, keep
        return op.apply(fwd, x, salt, keep)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return (ctx.op.apply(ctx.bwd, g.contiguous(), ctx.salt, ctx.keep),
                None, None, None, None, None)


class MeshGraphOp:
    """Both propagation directions over row-sharded tables.

    Same interface as ``ops.spmm.GraphOp``: ``weights(generator,
    dropout)``, then ``to_user(item_rows, pair)`` and ``to_item(user_rows,
    pair)``, where the tables and the results are this rank's rows of the
    tables padded to ``n_users_padded`` and ``n_items_padded``.
    """

    def __init__(self, edge_user, edge_item, edge_weight,
                 n_users_padded: int, n_items_padded: int, mesh: Mesh):
        self.mesh = mesh
        self.rs_dtype = collective_dtype()
        self.n_users = int(n_users_padded)
        self.n_items = int(n_items_padded)
        w = np.asarray(edge_weight, np.float32)
        self.i2u = build_shard(edge_item, edge_user, w, self.n_items,
                               self.n_users, mesh.size, mesh.rank, True,
                               mesh.device)
        self.u2i = build_shard(edge_user, edge_item, w, self.n_users,
                               self.n_items, mesh.size, mesh.rank, False,
                               mesh.device)

    def weights(self, generator: torch.Generator | None = None,
                dropout: float = 0.0):
        return hash_dropout_salts(generator, dropout)

    def csr_pair(self, direction: str):
        """Refused: a source shard's partial spans every destination, so a
        destination's softmax would span the ranks.  The attention layers
        run on ``sharded_conv.MeshConvOp``'s destination shards."""
        raise NotImplementedError(
            f'{direction}: the source-row shards of MeshGraphOp cannot '
            'carry an attention layer; the conv family runs on MeshConvOp')

    def apply(self, shard: Shard, x: torch.Tensor, salt: int,
              keep: float) -> torch.Tensor:
        """Steps 1-3 of the module docstring: this rank's rows of one
        direction's output."""
        if not 0.0 < keep <= 1.0:
            raise ValueError(f'keep must be in (0, 1], got {keep}')
        w = shard.csr.w
        if keep < 1.0:   # at keep 1 the scale is exactly 1
            w = w * edge_dropout_scale(shard.users, shard.items, salt, keep)
        partial = spmm_weighted(shard.csr, w, x)
        out = torch.empty((partial.shape[0] // self.mesh.size,
                           partial.shape[1]), dtype=self.rs_dtype,
                          device=partial.device)
        dist.reduce_scatter_tensor(out, partial.to(self.rs_dtype))
        return out.to(torch.float32)

    def to_user(self, item_emb: torch.Tensor, w_pair) -> torch.Tensor:
        """This rank's user rows of R @ items."""
        return _MeshSpMM.apply(item_emb, self, self.i2u, self.u2i, *w_pair)

    def to_item(self, user_emb: torch.Tensor, w_pair) -> torch.Tensor:
        """This rank's item rows of R^T @ users."""
        return _MeshSpMM.apply(user_emb, self, self.u2i, self.i2u, *w_pair)
