"""Graph-conv variants of LightGCN: ``gat`` on kernels K3/K4.

Counterpart of ``textgcn_tpu/models/conv.py`` (``init_conv_layer``,
``ConvModel``).  The LightGCN runtime (BPR loss, sampling, eval,
checkpoints) is kept and the parameter-free propagation is swapped for a
learnable conv applied in both bipartite directions, one weight set per
layer shared by users and items.  The layers are combined as LightGCN's
are: the mean over layers 0..L, or the last layer under ``--single``.

GAT at one head, ``d -> d``, in the JAX package's layout so weights carry
across as copies: ``h = x @ W`` with ``W`` shaped ``(d_in, d_out)``, ``s =
h @ a_src``, ``d = h @ a_dst``, a softmax over each destination's
surviving incoming edges plus its self loop (``ops/gat.gat_direction``),
then ``+ b``.  Edge dropout is the hash mask of K1 in {0, 1}, one salt per
direction per step; the self loop is never dropped.

``gcn``, ``graphsage`` and ``gatv2`` are not ported yet.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.gat import gat_direction
from ..ops.propagate import salt_pairs
from .lightgcn import LightGCN

PORTED_CONVS = ('gat',)


def _glorot(generator: torch.Generator, shape) -> torch.Tensor:
    """Uniform in ``+-sqrt(6 / (fan_in + fan_out))``, ``fan_in = shape[0]``,
    ``fan_out = shape[-1]``, as the JAX package draws it."""
    bound = math.sqrt(6.0 / (shape[0] + shape[-1]))
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (2.0 * u - 1.0) * bound


def init_conv_layer(generator: torch.Generator, conv: str,
                    d: int) -> nn.ParameterDict:
    """One layer's parameters: glorot weights and a zero bias."""
    if conv != 'gat':
        raise NotImplementedError(f'conv {conv!r} is not ported yet')
    return nn.ParameterDict({
        'w': nn.Parameter(_glorot(generator, (d, d))),
        'a_src': nn.Parameter(_glorot(generator, (d, 1))[:, 0]),
        'a_dst': nn.Parameter(_glorot(generator, (d, 1))[:, 0]),
        'b': nn.Parameter(torch.zeros(d)),
    })


class ConvModel(LightGCN):
    """The LightGCN runtime with a learnable graph conv per layer."""

    def __init__(self, cfg, data, *, device=None, generator=None):
        super().__init__(cfg, data, device=device, generator=generator)
        if cfg.model not in PORTED_CONVS:
            raise NotImplementedError(
                f'model {cfg.model!r} is not ported yet')
        if cfg.aggr not in ('mean', 'sum', 'max'):
            raise ValueError('conv models require an explicit aggregator '
                             f'(--aggr mean|sum|max), got {cfg.aggr!r}')
        self.conv = cfg.model
        self.aggr = cfg.aggr
        self.convs = nn.ModuleList(
            init_conv_layer(self.init_generator, self.conv, cfg.emb_size)
            for _ in range(self.n_layers)).to(self.device)

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
        (salt_u, keep), (salt_i, _) = salt_pairs(
            op, self.dropout if training else 0.0, generator,
            w_pairs if training else None)

        def step(lp, u, i):
            h_u, h_i = u @ lp['w'], i @ lp['w']
            s_u, d_u = h_u @ lp['a_src'], h_u @ lp['a_dst']
            s_i, d_i = h_i @ lp['a_src'], h_i @ lp['a_dst']
            return (gat_direction(op, 'to_user', h_i, h_u, s_i, s_u, d_u,
                                  salt_u, keep) + lp['b'],
                    gat_direction(op, 'to_item', h_u, h_i, s_u, s_i, d_i,
                                  salt_i, keep) + lp['b'])

        return self._layer_combine(step)
