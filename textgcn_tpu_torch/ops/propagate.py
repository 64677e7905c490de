"""K-hop LightGCN propagation over the normalized bipartite graph.

Counterpart of ``textgcn_tpu/ops/propagate.py``.  Because the adjacency
is bipartite, one layer is two rectangular products,

    users_{l+1} = R   @ items_l      (graph_op.to_user)
    items_{l+1} = R^T @ users_l      (graph_op.to_item)

and the representation is the mean over layers 0..L, or the last layer
under ``--single``.
"""

from __future__ import annotations

import torch


def salt_pairs(graph_op, dropout, generator, w_pairs):
    """The per-direction ``(salt, keep)`` pairs: ``w_pairs`` when given
    (the tests inject the JAX package's), else drawn from ``generator``
    when ``dropout > 0``."""
    if w_pairs is not None:
        return w_pairs
    return graph_op.weights(generator if dropout > 0.0 else None, dropout)


def propagate_rest(user_emb: torch.Tensor, item_emb: torch.Tensor,
                   graph_op, n_layers: int, *, dropout: float = 0.0,
                   generator: torch.Generator | None = None, w_pairs=None):
    """``(sum_{l=1..L} u_l, sum_{l=1..L} i_l)``: the propagated layers
    without the layer-0 (ego) term."""
    w_to_user, w_to_item = salt_pairs(graph_op, dropout, generator, w_pairs)
    u, i = user_emb, item_emb
    acc_u = torch.zeros_like(u)
    acc_i = torch.zeros_like(i)
    for _ in range(n_layers):
        u, i = graph_op.to_user(i, w_to_user), graph_op.to_item(u, w_to_item)
        acc_u = acc_u + u
        acc_i = acc_i + i
    return acc_u, acc_i


def representation(user_emb: torch.Tensor, item_emb: torch.Tensor, graph_op,
                   n_layers: int, *, single: bool, dropout: float = 0.0,
                   generator: torch.Generator | None = None, w_pairs=None):
    """Propagated ``(users_repr, items_repr)``: the layer mean, or the
    last layer when ``single``.  Edge dropout applies when ``dropout > 0``
    and a ``generator`` draws the salts, or when ``w_pairs`` gives them."""
    if single:
        w_to_user, w_to_item = salt_pairs(graph_op, dropout, generator, w_pairs)
        u, i = user_emb, item_emb
        for _ in range(n_layers):
            u, i = (graph_op.to_user(i, w_to_user),
                    graph_op.to_item(u, w_to_item))
        return u, i
    rest_u, rest_i = propagate_rest(user_emb, item_emb, graph_op, n_layers,
                                    dropout=dropout, generator=generator,
                                    w_pairs=w_pairs)
    inv = 1.0 / (n_layers + 1)
    return (user_emb + rest_u) * inv, (item_emb + rest_i) * inv
