"""The plain reference of the ``gat`` cells: GAT (Velickovic et al., ICLR
2018) with one head, as torch_geometric's ``GATConv`` runs on the stacked
``[users; items]`` nodes over both directions of every train pair (the
reference TextGCN's ``TorchGeometric`` wrapper): per layer ``h = x W``,
and for each destination ``j`` a softmax over its in-edges and its self
loop of the logits ``leaky(a_src . h_i + a_dst . h_j, 0.2)``, the
weighted sum of the ``h_i`` (``h_j`` for the loop), plus ``b``; the mean
over layers 0..L; then ``lgcn``'s BPR + L2 loss and Adam over the tables
and every conv parameter (``reference/lightgcn.py``'s).

Plain PyTorch on whatever device it is given, in the dtype of the tensors
it is handed (float64 for the comparisons), written out with gathers and
``index_add`` over ``RefGraph``'s pairs, with TF32 off.  It imports
nothing of the program and takes no weight, CSR or mask from it.

Departures from ``GATConv`` that the program shares (its ``ops/gat.py``):

* dropout removes edges before the softmax, by the hash of (user, item,
  salt) with one salt a direction a step (the reference's
  ``_dropout_norm_matrix``); ``GATConv``'s own dropout acts on the
  attention coefficients after it (off by default);
* the self loop is never dropped (torch_geometric adds the loops after the
  edge dropout);
* ``leaky'(0) = 1``, as ``jax.nn.leaky_relu`` and the program's
  ``torch.where`` give it; torch's ``leaky_relu`` gives the slope there;
* users and items share the layer's ``W``, ``a_src``, ``a_dst`` and
  ``b``: one conv on the stacked matrix.

The softmax subtracts each destination's largest logit, the loop's
included, held constant: the softmax does not depend on it.
"""

from __future__ import annotations

import contextlib

import torch

from .lightgcn import Adam, RefGraph, bpr_loss, hash_kept  # noqa: F401

SLOPE = 0.2
LEAVES = ('w', 'a_src', 'a_dst', 'b')


@contextlib.contextmanager
def no_tf32():
    """Matrix products and cuDNN without TF32 inside the block."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def leaky(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z >= 0, z, SLOPE * z)


def attend(dst: torch.Tensor, src: torch.Tensor, h_src, s_src, h_dst, s_dst,
           d_dst) -> torch.Tensor:
    """One direction over its kept edges ``(dst, src)``: each destination
    row's softmax-weighted sum of its sources' ``h`` and its own (the
    self loop)."""
    z = leaky(s_src[src] + d_dst[dst])
    z_self = leaky(s_dst + d_dst)
    m = z_self.detach().scatter_reduce(0, dst, z.detach(), reduce='amax')
    e = torch.exp(z - m[dst])
    e_self = torch.exp(z_self - m)
    num = (h_dst * e_self[:, None]).index_add(0, dst, h_src[src] * e[:, None])
    den = e_self.index_add(0, dst, e)
    return num / den[:, None]


def layer(g: RefGraph, lp: dict, u: torch.Tensor, i: torch.Tensor,
          kept_u: torch.Tensor, kept_i: torch.Tensor):
    """One GAT layer in both directions: ``(new_u, new_i)``; ``kept_u``
    and ``kept_i`` mark the pairs each direction keeps."""
    h_u, h_i = u @ lp['w'], i @ lp['w']
    s_u, d_u = h_u @ lp['a_src'], h_u @ lp['a_dst']
    s_i, d_i = h_i @ lp['a_src'], h_i @ lp['a_dst']
    eu, ei = g.edge_user, g.edge_item
    new_u = attend(eu[kept_u], ei[kept_u], h_i, s_i, h_u, s_u, d_u)
    new_i = attend(ei[kept_i], eu[kept_i], h_u, s_u, h_i, s_i, d_i)
    return new_u + lp['b'], new_i + lp['b']


def propagate(g: RefGraph, user_emb: torch.Tensor, item_emb: torch.Tensor,
              convs: list[dict], salts=None):
    """The layer mean over layers 0..len(convs); with ``salts = ((salt,
    keep) to_user, (salt, keep) to_item)`` each direction keeps the pairs
    the hash keeps, else every pair.  Differentiable in the tables and in
    every leaf of ``convs``."""
    (s_u, k_u), (s_i, k_i) = salts or ((0, 1.0), (0, 1.0))
    kept_u = hash_kept(g.edge_user, g.edge_item, s_u, k_u)
    kept_i = hash_kept(g.edge_user, g.edge_item, s_i, k_i)
    u, i = user_emb, item_emb
    acc_u, acc_i = u, i
    with no_tf32():
        for lp in convs:
            u, i = layer(g, lp, u, i, kept_u, kept_i)
            acc_u = acc_u + u
            acc_i = acc_i + i
    inv = 1.0 / (len(convs) + 1)
    return acc_u * inv, acc_i * inv


def loss(g: RefGraph, tables, convs: list[dict], salts, users, pos, negs,
         reg_lambda: float) -> torch.Tensor:
    """``gat``'s loss of one batch under ``salts``: ``lgcn``'s BPR + L2
    (on the layer-0 rows) over ``propagate``'s layer mean."""
    reprs = propagate(g, *tables, convs, salts)
    return bpr_loss(reprs, tables, users, pos, negs, reg_lambda)
