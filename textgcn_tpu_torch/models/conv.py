"""Graph-conv variants of LightGCN: ``gcn``, ``graphsage``, ``gat`` and
``gatv2``.

Counterpart of ``textgcn_tpu/models/conv.py`` (``init_conv_layer``,
``conv_layer``, ``ConvModel`` and its ``_kernel_representation``).  The
LightGCN runtime (BPR loss, sampling, eval, checkpoints) is kept and the
parameter-free propagation is swapped for a learnable conv applied in both
bipartite directions, one weight set per layer shared by users and items.
The layers are combined as LightGCN's are: the mean over layers 0..L, or
the last layer under ``--single``.

The family's graph op has unit edge weights (the JAX package's
``conv_op``): the attention kernels read only its structure, and K1 on it
is an unweighted masked sum.  The lgcn-normalised op is never built here.
Edge dropout is the hash mask in {0, 1}, one salt per direction per step;
self loops are never dropped.  In the JAX package's layout, so weights
carry across as copies (``W`` shaped ``(d_in, d_out)``):

* ``gcn`` (``w``, ``b``): ``D̂_dst^{-1/2} A D̂_src^{-1/2} h + h / D̂`` with
  ``h = x W`` and ``D̂`` = kept degree + 1; the sum over kept edges is K1
  (``GraphOp.to_user``/``to_item``) scaled back by ``keep``, since K1
  applies ``1/keep`` and a conv drops edges without a rescale;
* ``graphsage`` (``w_nbr``, ``w_root``, ``b``): ``agg(x_nbr) W_nbr + b +
  x W_root``; ``sum`` is K1 scaled back by ``keep``, ``mean`` divides it
  by ``max(kept degree, 1)``, ``max`` is a plain ``scatter_reduce``
  segment max (a masked message is -inf, an empty row gives 0), as the
  JAX package computes it outside any kernel;
* ``gat`` (``w``, ``a_src``, ``a_dst``, ``b``): ``ops/gat.gat_direction``
  on K3/K4;
* ``gatv2`` (``w_src``, ``w_dst``, ``a``, ``b``):
  ``ops/gat.gatv2_direction`` on K5/K6.

The kept degrees are constants for autograd: the gradient of a K1 sum is
K1's own backward.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops.gat import gat_direction, gatv2_direction
from ..ops.propagate import salt_pairs
from ..ops.spmm import edge_mask, kept_degree
from .lightgcn import LightGCN

PORTED_CONVS = ('gcn', 'graphsage', 'gat', 'gatv2')


def _glorot(generator: torch.Generator, shape) -> torch.Tensor:
    """Uniform in ``+-sqrt(6 / (fan_in + fan_out))``, ``fan_in = shape[0]``,
    ``fan_out = shape[-1]``, as the JAX package draws it."""
    bound = math.sqrt(6.0 / (shape[0] + shape[-1]))
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (2.0 * u - 1.0) * bound


def init_conv_layer(generator: torch.Generator, conv: str,
                    d: int) -> nn.ParameterDict:
    """One layer's parameters: glorot weights and a zero bias, with the
    JAX package's keys and shapes (``conv.py:75-94``)."""
    def glorot(*shape):
        return nn.Parameter(_glorot(generator, shape))

    def vector():
        return nn.Parameter(_glorot(generator, (d, 1))[:, 0])

    bias = nn.Parameter(torch.zeros(d))
    if conv == 'gcn':
        layer = {'w': glorot(d, d), 'b': bias}
    elif conv == 'graphsage':
        layer = {'w_nbr': glorot(d, d), 'w_root': glorot(d, d), 'b': bias}
    elif conv == 'gat':
        layer = {'w': glorot(d, d), 'a_src': vector(), 'a_dst': vector(),
                 'b': bias}
    elif conv == 'gatv2':
        layer = {'w_src': glorot(d, d), 'w_dst': glorot(d, d),
                 'a': vector(), 'b': bias}
    else:
        raise ValueError(f'unknown conv {conv!r}')
    return nn.ParameterDict(layer)


def kept_degrees(op, w_pairs):
    """``(deg_u, deg_i)``: users' kept edges under the to_user salt and
    items' under the to_item salt, as ``(n, 1)`` float32 columns."""
    (salt_u, keep_u), (salt_i, keep_i) = w_pairs
    return (kept_degree(op.l_i2u, salt_u, keep_u)[:, None],
            kept_degree(op.l_u2i, salt_i, keep_i)[:, None])


def _sage_max(csr, x_src: torch.Tensor, salt: int,
              keep: float) -> torch.Tensor:
    """The segment max over each destination's kept edges; 0 for a row
    without one."""
    rows, col, kept = edge_mask(csr, salt, keep)
    msg = torch.where(kept[:, None], x_src[col], -torch.inf)
    d = x_src.shape[1]
    agg = torch.full((csr.n_dst, d), -torch.inf, dtype=x_src.dtype,
                     device=x_src.device)
    agg = agg.scatter_reduce(0, rows[:, None].expand(-1, d), msg,
                             reduce='amax', include_self=True)
    return torch.where(torch.isfinite(agg), agg, 0.0)


def conv_layer(lp, conv: str, aggr: str, op, u: torch.Tensor,
               i: torch.Tensor, w_pairs, degrees=None):
    """One conv layer in both directions over the unit-weight ``GraphOp``
    ``op``: ``(new_u, new_i)``.  ``w_pairs`` are the per-direction
    ``(salt, keep)``; ``degrees`` are ``kept_degrees(op, w_pairs)``
    (computed here when ``None``; ``gcn`` and ``graphsage`` mean use them).
    """
    pair_u, pair_i = w_pairs
    if conv == 'gat':
        h_u, h_i = u @ lp['w'], i @ lp['w']
        s_u, d_u = h_u @ lp['a_src'], h_u @ lp['a_dst']
        s_i, d_i = h_i @ lp['a_src'], h_i @ lp['a_dst']
        return (gat_direction(op, 'to_user', h_i, h_u, s_i, s_u, d_u,
                              *pair_u) + lp['b'],
                gat_direction(op, 'to_item', h_u, h_i, s_u, s_i, d_i,
                              *pair_i) + lp['b'])
    if conv == 'gatv2':
        hs_u, hs_i = u @ lp['w_src'], i @ lp['w_src']
        hd_u, hd_i = u @ lp['w_dst'], i @ lp['w_dst']
        return (gatv2_direction(op, 'to_user', hs_i, hs_u, hd_u, lp['a'],
                                *pair_u) + lp['b'],
                gatv2_direction(op, 'to_item', hs_u, hs_i, hd_i, lp['a'],
                                *pair_i) + lp['b'])

    def ksum_to_user(x):    # the sum over kept edges, no 1/keep rescale
        return op.to_user(x, pair_u) * pair_u[1]

    def ksum_to_item(x):
        return op.to_item(x, pair_i) * pair_i[1]

    if conv == 'graphsage' and aggr == 'max':
        nbr_u = _sage_max(op.l_i2u, i, *pair_u)
        nbr_i = _sage_max(op.l_u2i, u, *pair_i)
    elif conv in ('gcn', 'graphsage'):
        deg_u, deg_i = kept_degrees(op, w_pairs) if degrees is None \
            else degrees
        if conv == 'gcn':
            ru, ri = torch.rsqrt(deg_u + 1.0), torch.rsqrt(deg_i + 1.0)
            h_u, h_i = u @ lp['w'], i @ lp['w']
            return (ru * ksum_to_user(h_i * ri) + h_u * (ru * ru) + lp['b'],
                    ri * ksum_to_item(h_u * ru) + h_i * (ri * ri) + lp['b'])
        nbr_u, nbr_i = ksum_to_user(i), ksum_to_item(u)
        if aggr == 'mean':
            nbr_u = nbr_u / torch.clamp(deg_u, min=1.0)
            nbr_i = nbr_i / torch.clamp(deg_i, min=1.0)
        elif aggr != 'sum':
            raise ValueError(f'unknown aggregator {aggr!r}')
    else:
        raise ValueError(f'unknown conv {conv!r}')
    return (nbr_u @ lp['w_nbr'] + lp['b'] + u @ lp['w_root'],
            nbr_i @ lp['w_nbr'] + lp['b'] + i @ lp['w_root'])


class ConvModel(LightGCN):
    """The LightGCN runtime with a learnable graph conv per layer, over a
    unit-weight graph op."""

    def __init__(self, cfg, data, *, device=None, generator=None):
        if cfg.model not in PORTED_CONVS:
            raise ValueError(f'{cfg.model!r} is not a conv model '
                             f'({", ".join(PORTED_CONVS)})')
        if cfg.aggr not in ('mean', 'sum', 'max'):
            raise ValueError('conv models require an explicit aggregator '
                             f'(--aggr mean|sum|max), got {cfg.aggr!r}')
        super().__init__(cfg, data, device=device, generator=generator)
        self.conv = cfg.model
        self.aggr = cfg.aggr
        self.convs = nn.ModuleList(
            init_conv_layer(self.init_generator, self.conv, cfg.emb_size)
            for _ in range(self.n_layers)).to(self.device)

    def graph_edge_weight(self, graph) -> np.ndarray:
        """Unit weights: the family's own op (the JAX ``conv_op``); the
        lgcn-normalised op is never built for a conv model."""
        return np.ones(graph.n_edges, np.float32)

    def param_tree(self) -> dict:
        tree = super().param_tree()
        tree['convs'] = [dict(lp.items()) for lp in self.convs]
        return tree

    @torch.no_grad()
    def load_params(self, params: dict):
        """Tables, and the conv layers when the checkpoint has them (a
        LightGCN checkpoint warm-starts the tables only)."""
        super().load_params(params)
        convs = params.get('convs')
        if convs is None:
            return
        if len(convs) != len(self.convs):
            raise ValueError(f'checkpoint has {len(convs)} conv layers, '
                             f'the model {len(self.convs)}')
        for lp, loaded in zip(self.convs, convs):
            if set(loaded) != set(lp.keys()):
                raise ValueError(f'conv layer keys {sorted(loaded)} do not '
                                 f'fit {sorted(lp.keys())}')
            for name, param in lp.items():
                if tuple(loaded[name].shape) != tuple(param.shape):
                    raise ValueError(
                        f'conv {name}: checkpoint {tuple(loaded[name].shape)}'
                        f' does not fit {tuple(param.shape)}')
                param.copy_(loaded[name])

    def _layer_combine(self, step):
        """Run ``step(lp, u, i) -> (u, i)`` per layer; the layer mean, or
        the last layer under ``--single``."""
        u, i = self.user_emb, self.item_emb
        acc_u, acc_i = u, i
        for lp in self.convs:
            u, i = step(lp, u, i)
            acc_u = acc_u + u
            acc_i = acc_i + i
        if self.single:
            return u, i
        inv = 1.0 / (self.n_layers + 1)
        return acc_u * inv, acc_i * inv

    def representation(self, *, training: bool = False,
                       generator: torch.Generator | None = None,
                       w_pairs=None):
        op = self.graph_op
        w_pairs = salt_pairs(op, self.dropout if training else 0.0,
                             generator, w_pairs if training else None)
        degrees = None
        if self.conv == 'gcn' or (self.conv == 'graphsage'
                                  and self.aggr == 'mean'):
            degrees = kept_degrees(op, w_pairs)   # once for all layers

        def step(lp, u, i):
            return conv_layer(lp, self.conv, self.aggr, op, u, i, w_pairs,
                              degrees)

        return self._layer_combine(step)
