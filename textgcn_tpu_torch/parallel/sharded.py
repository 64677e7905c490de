"""Collectives of the mesh path outside the propagation.

Counterpart of ``textgcn_tpu/parallel/sharded.py``:

* ``all_gather_rows``: the whole table from every rank's rows, as a
  differentiable op whose backward reduce-scatters the gradient, so each
  rank gets the sum over all ranks' losses for its own rows.  The loss
  gathers the propagated and the layer-0 tables through it, each conv
  layer its input tables; checkpoints and exports gather the tables with
  it;
* ``sharded_topk`` (``sharded.py:72-151``): each rank scores its item
  shard, takes a local top-k with global ids, and the candidates of all
  ranks are gathered and merged exactly (an LTR head or a concat scorer
  passes its fused factors ``u_cat`` and its rows of ``i_cat``);
* ``all_reduce_sum``: the loss sums of an epoch, ``adv_sampling``'s count
  of valid pairs.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.retrieval import catalog_scores, mask_train_items
from .mesh import Mesh


class _AllGatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mesh: Mesh):
        ctx.mesh = mesh
        x = x.contiguous()
        out = torch.empty((mesh.size * x.shape[0], *x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty((g.shape[0] // ctx.mesh.size, *g.shape[1:]),
                          dtype=g.dtype, device=g.device)
        dist.reduce_scatter_tensor(out, g)
        return out, None


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order along dim 0."""
    return _AllGatherRows.apply(x, mesh)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, in place."""
    dist.all_reduce(x)
    return x


def sharded_topk(mesh: Mesh, users_emb: torch.Tensor,
                 items_shard: torch.Tensor, batch_pos_padded: torch.Tensor,
                 k: int, n_valid: int):
    """Catalogue-sharded scoring and exact top-k: ``(values, indices)``,
    ``(B, k)``, the same on every rank.

    ``users_emb``: (B, d) rows of the batch's users; ``items_shard``: this
    rank's ``R`` rows of the padded item table, global ids ``[rank*R,
    (rank+1)*R)``; ``n_valid``: the number of real items.  Each rank
    scores its real columns only (phantom columns are left out, as the JAX
    package masks them), masks the batch's train items that fall in its
    shard, and keeps ``min(k, R)`` candidates with global ids; a shard
    with fewer real columns pads with ``-inf`` at an id past every real
    one.  The merge sorts all candidates by value with ties going to the
    lower id, so padding never displaces a real item.
    """
    shard = items_shard.shape[0]
    offset = mesh.rank * shard
    n_real = max(0, min(shard, n_valid - offset))
    kk = min(k, shard)
    b = users_emb.shape[0]
    vals = torch.full((b, kk), -torch.inf, dtype=torch.float32,
                      device=users_emb.device)
    idx = torch.full((b, kk), mesh.size * shard, dtype=torch.int64,
                     device=users_emb.device)
    if n_real:
        scores = catalog_scores(users_emb, items_shard[:n_real])
        local = batch_pos_padded.to(torch.int64) - offset
        local = torch.where((local >= 0) & (local < n_real), local, n_real)
        scores = mask_train_items(scores, local, n_real)
        v, i = torch.topk(scores, min(kk, n_real), dim=1)
        vals[:, :v.shape[1]] = v
        idx[:, :i.shape[1]] = i + offset
    all_v = torch.empty((mesh.size * b, kk), dtype=vals.dtype,
                        device=vals.device)
    all_i = torch.empty((mesh.size * b, kk), dtype=idx.dtype,
                        device=idx.device)
    dist.all_gather_into_tensor(all_v, vals)
    dist.all_gather_into_tensor(all_i, idx)
    flat_v = all_v.view(mesh.size, b, kk).transpose(0, 1).reshape(b, -1)
    flat_i = all_i.view(mesh.size, b, kk).transpose(0, 1).reshape(b, -1)
    by_id, order = torch.sort(flat_i, dim=1, stable=True)
    top_v, pos = torch.sort(flat_v.gather(1, order), dim=1, descending=True,
                            stable=True)
    return top_v[:, :k], by_id.gather(1, pos[:, :k])
