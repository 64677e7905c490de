"""Collectives of the mesh path outside the propagation.

Counterpart of ``textgcn_tpu/parallel/sharded.py``:

* ``all_gather_rows``: the whole table from every rank's rows, as a
  differentiable op whose backward reduce-scatters the gradient, so each
  rank gets the sum over all ranks' losses for its own rows.  The loss
  gathers the propagated and the layer-0 tables through it, each conv
  layer its input tables; checkpoints and exports gather the tables with
  it;
* ``sharded_topk`` (``sharded.py:72-151``): each rank scores its item
  shard (in bfloat16 in serving mode), takes a local top-k with global
  ids, and the candidates of all ranks are gathered and merged exactly
  (an LTR head or a concat scorer passes its fused factors ``u_cat`` and
  its rows of ``i_cat``);
  ``sharded_topk_of_scores`` merges scores a caller computed for its own
  columns (a boosted head's forest scores), with ties to the lower index
  on request;
* ``all_reduce_sum``: the loss sums of an epoch, ``adv_sampling``'s count
  of valid pairs;
* ``ranks_agree``: one all-reduce that tells whether every rank holds the
  same value (a boosted head's forest digest).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.retrieval import (_ordered_bits, catalog_scores,
                             mask_train_items, serving_mode,
                             top_k_lower_index)
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


def ranks_agree(value: float, device) -> bool:
    """Whether every rank passed the same ``value`` (a float64): one
    all-reduce of ``(value, -value)`` by maximum."""
    both = torch.tensor([value, -value], dtype=torch.float64, device=device)
    dist.all_reduce(both, op=dist.ReduceOp.MAX)
    return bool(both[0] == -both[1])


def shard_columns(mesh: Mesh, shard: int, n_valid: int) -> tuple[int, int]:
    """``(offset, n_real)``: the global id of this rank's first row of a
    table sharded ``shard`` rows a rank, and how many of its rows are real
    (``n_valid`` real rows in all; the last ranks may hold none)."""
    offset = mesh.rank * shard
    return offset, max(0, min(shard, n_valid - offset))


def sharded_topk(mesh: Mesh, users_emb: torch.Tensor,
                 items_shard: torch.Tensor, batch_pos_padded: torch.Tensor,
                 k: int, n_valid: int, approx: float | None = None):
    """Catalogue-sharded scoring and exact top-k: ``(values, indices)``,
    ``(B, k)``, the same on every rank.

    ``users_emb``: (B, d) rows of the batch's users; ``items_shard``: this
    rank's ``R`` rows of the padded item table, global ids ``[rank*R,
    (rank+1)*R)``; ``n_valid``: the number of real items.  Each rank
    scores its real columns only (phantom columns are left out, as the JAX
    package masks them); ``sharded_topk_of_scores`` merges.  In serving
    mode (``approx``, or ``TEXTGCN_TPU_APPROX_TOPK``) the local scores are
    rounded to bfloat16, as the JAX package's are, and merged with ties to
    the lower index: the one-card ``score_and_topk``'s result bit for bit.
    """
    shard = items_shard.shape[0]
    _, n_real = shard_columns(mesh, shard, n_valid)
    scores = catalog_scores(users_emb, items_shard[:n_real])
    serving = serving_mode(approx)
    if serving:
        scores = scores.to(torch.bfloat16)
    return sharded_topk_of_scores(mesh, scores, shard, batch_pos_padded, k,
                                  lower_index=serving)


def sharded_topk_of_scores(mesh: Mesh, scores: torch.Tensor, shard: int,
                           batch_pos_padded: torch.Tensor, k: int, *,
                           lower_index: bool = False):
    """The exact top-k ``(values, indices)``, ``(B, k)``, of scores whose
    columns are sharded ``shard`` a rank: ``scores`` is ``(B, n_real)``,
    this rank's real columns (``shard_columns``).

    Each rank masks the batch's train items that fall in its shard and
    keeps ``min(k, shard)`` candidates with global ids; a shard with fewer
    real columns pads with ``-inf`` at an id past every real one.  The
    candidates of all ranks are gathered and sorted by value with ties
    going to the lower id, so padding never displaces a real item.  With
    ``lower_index`` a rank's own candidates are its top-k with ties to the
    lower index too (``top_k_lower_index``), so the result is exactly
    ``top_k_lower_index`` over the whole catalogue (+0 above -0 too): the
    boosted heads' order, whose forest gives many equal scores; else
    ``torch.topk`` picks among ties at a shard's k-th place.
    """
    offset = mesh.rank * shard
    b, n_real = scores.shape
    kk = min(k, shard)
    vals = torch.full((b, kk), -torch.inf, dtype=torch.float32,
                      device=scores.device)
    idx = torch.full((b, kk), mesh.size * shard, dtype=torch.int64,
                     device=scores.device)
    if n_real:
        local = batch_pos_padded.to(torch.int64) - offset
        local = torch.where((local >= 0) & (local < n_real), local, n_real)
        scores = mask_train_items(scores, local, n_real)
        take = min(kk, n_real)
        v, i = (top_k_lower_index(scores, take) if lower_index
                else torch.topk(scores, take, dim=1))
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
    by_id_v = flat_v.gather(1, order)
    # lower_index: +0 above -0, as top_k_lower_index orders them
    keys = _ordered_bits(by_id_v)[0] if lower_index else by_id_v
    _, pos = torch.sort(keys, dim=1, descending=True, stable=True)
    pos = pos[:, :k]
    return by_id_v.gather(1, pos), by_id.gather(1, pos)
