"""Destination-row-sharded graph op of the conv family on a mesh.

``lgcn``'s split (``sharded_spmm.py``) is by source row: each rank's
partial spans every destination and a reduce-scatter combines them.  An
attention layer cannot be split so, since each destination's softmax
would span the ranks.  The conv family splits by DESTINATION row instead:
rank ``r`` of ``W`` holds, per direction, the edges whose destination row
it owns (``Mesh.rows``) and that shard's own transpose, which covers every
source row and only those edges.  A layer (``models/conv.py``) gathers its
input tables whole (``sharded.all_gather_rows``, whose backward
reduce-scatters the table gradients), runs the single-card ``conv_layer``
over this op and keeps this rank's rows of the output.

The CSRs keep GLOBAL row and column ids, with a ``rowptr`` over the whole
padded destination range (the rows of other ranks are empty): K1 and
K3-K6 hash the CSR's own (row, col) pair, so the masks and the kernels'
outputs on this rank's rows are the single card's, and no kernel changes.
``kept_degrees`` sums each rank's kept degrees, which are 0 off its rows,
over the ranks (outside autograd), because ``gcn``'s source normalisation
reads the degrees of every source row.

Counterpart of the JAX package's GSPMD conv path
(``textgcn_tpu/parallel/mesh.py:160-172``), which drops edges with
``jax.random.bernoulli`` masks; the port keeps the hash: the same law
from another stream.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.spmm import (CSR, _SpMM, build_csr, gathered_dtype,
                        hash_dropout_salts, kept_degree)
from .mesh import Mesh
from .sharded import all_reduce_sum


class MeshConvOp:
    """Both directions of the unit-weight bipartite graph over this rank's
    destination shards.

    Same interface as ``ops.spmm.GraphOp`` for the conv layers:
    ``weights(generator, dropout)``, ``csr_pair(direction)``,
    ``to_user(items, pair)``/``to_item(users, pair)`` (K1, whole padded
    tables in, whole padded tables out, zero outside this rank's rows) and
    ``x_dtype``; plus ``kept_degrees(w_pairs)``, whole.
    """

    def __init__(self, edge_user, edge_item, n_users_padded: int,
                 n_items_padded: int, mesh: Mesh):
        self.mesh = mesh
        self.n_users = int(n_users_padded)
        self.n_items = int(n_items_padded)
        self.x_dtype = gathered_dtype()
        eu = np.asarray(edge_user, np.int64)
        ei = np.asarray(edge_item, np.int64)
        nu, ni, dev = self.n_users, self.n_items, mesh.device

        def owned(ids, n):
            rows = mesh.rows(n)
            return (ids >= rows.start) & (ids < rows.stop)

        u, i = owned(eu, nu), owned(ei, ni)
        ones_u = np.ones(int(u.sum()), np.float32)
        ones_i = np.ones(int(i.sum()), np.float32)
        # to_user: the edges into this rank's users, and their transpose
        self.l_i2u = build_csr(eu[u], ei[u], ones_u, nu, ni, True, dev)
        self.t_i2u = build_csr(ei[u], eu[u], ones_u, ni, nu, False, dev)
        # to_item: the edges into this rank's items, and their transpose
        self.l_u2i = build_csr(ei[i], eu[i], ones_i, ni, nu, False, dev)
        self.t_u2i = build_csr(eu[i], ei[i], ones_i, nu, ni, True, dev)

    def weights(self, generator: torch.Generator | None = None,
                dropout: float = 0.0):
        return hash_dropout_salts(generator, dropout)

    def csr_pair(self, direction: str) -> tuple[CSR, CSR]:
        """``(forward shard, its own transpose)`` of ``direction``."""
        if direction == 'to_user':
            return self.l_i2u, self.t_i2u
        if direction == 'to_item':
            return self.l_u2i, self.t_u2i
        raise ValueError(f'unknown direction {direction!r}')

    def to_user(self, item_emb: torch.Tensor, w_pair) -> torch.Tensor:
        """R @ items on this rank's user rows; the other rows are 0."""
        return _SpMM.apply(item_emb, self.l_i2u, self.t_i2u, *w_pair,
                           self.x_dtype)

    def to_item(self, user_emb: torch.Tensor, w_pair) -> torch.Tensor:
        """R^T @ users on this rank's item rows; the other rows are 0."""
        return _SpMM.apply(user_emb, self.l_u2i, self.t_u2i, *w_pair,
                           self.x_dtype)

    @torch.no_grad()
    def kept_degrees(self, w_pairs):
        """``(deg_u, deg_i)``, whole ``(n, 1)`` float32 columns: users'
        kept edges under the to_user salt, items' under the to_item salt
        (``models/conv.kept_degrees`` on one card).  A shard's count is 0
        off its own rows, so the sum over the ranks is the whole vector."""
        (salt_u, keep_u), (salt_i, keep_i) = w_pairs
        return (all_reduce_sum(kept_degree(self.l_i2u, salt_u,
                                           keep_u))[:, None],
                all_reduce_sum(kept_degree(self.l_u2i, salt_i,
                                           keep_i))[:, None])
