"""The mesh of a run and the row-sharded models.

Counterpart of ``textgcn_tpu/parallel/mesh.py``.  The ``(data, model)``
shape of ``--mesh`` is kept for its product: the ranks of the group, one
per GPU.  Rank ``r`` owns rows ``[r*R, (r+1)*R)`` of each embedding
table, ``R = n_padded / W``.  The JAX package orders its devices
model-major for the same split (``mesh.py:196-200``); the flat rank order
gives the same rows to the same shard index, and the same outputs.

``shard_model`` takes every model:

* ``lgcn`` and the other ``LightGCN`` subclasses (the LTR heads
  ``ltr_linear``, ``ltr_pop``; the boosted heads ``gbdt``, ``gbdt_pop``,
  ``xgboost``, ``xgboost_pop``, ``marcus``; ``adv_sampling``; the
  text-loss models ``text``, ``kg``, ``reviews``; the concat scorers
  ``ltr_reviews``, ``ltr_kg``, ``ltr_simple``; ``text_probe``) propagate
  over the edges whose SOURCE row the rank owns, on K2 with a
  reduce-scatter (``sharded_spmm.py``).  Only the two tables are sharded:
  an LTR head's tower, the text and popularity buffers, ``text --pos
  user``'s (item, user) review table and the train lists stay whole on
  every rank;
* the conv family propagates over the edges whose DESTINATION row the
  rank owns (``sharded_conv.py``), with its conv layers whole.

The parameters held whole (conv layers, tower) are replicated: the
trainer sums their gradients over the ranks before each Adam step.  A
boosted head's forest is fitted on every rank from the gathered tables
(``models/ltr_boosted.py``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch import nn

from . import multihost

RS_DTYPE_ENV = 'TEXTGCN_TPU_RS_DTYPE'


@dataclass(frozen=True)
class Mesh:
    """A run's ranks: ``shape`` (data, model), this process's ``rank`` and
    ``device``; the group is ``torch.distributed``'s default one."""
    shape: tuple[int, int]
    rank: int
    device: torch.device

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    def rows(self, n_padded: int) -> slice:
        """The rows of an ``n_padded``-row table this rank owns."""
        if n_padded % self.size:
            raise ValueError(f'{n_padded} rows do not split over '
                             f'{self.size} ranks')
        per = n_padded // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


def auto_shape(n: int) -> tuple[int, int]:
    """``n`` ranks as (data, model): model gets the largest power-of-two
    divisor <= sqrt(n), as the JAX package's ``_auto_shape`` picks."""
    best = 1
    while n % (best * 2) == 0 and (best * 2) ** 2 <= n:
        best *= 2
    return (n // best, best)


def collective_dtype() -> torch.dtype:
    """Payload type of the propagation's reduce-scatters: float32, the
    tables' type, unless ``TEXTGCN_TPU_RS_DTYPE=bf16`` asks for bfloat16.

    The JAX package defaults to bf16 because its TPU kernel rounds the
    table to bf16 anyway (``mesh.py:30-55``); the port's kernel does not.
    """
    env = os.environ.get(RS_DTYPE_ENV, '').lower()
    if env in ('', 'f32', 'float32'):
        return torch.float32
    if env in ('bf16', 'bfloat16'):
        return torch.bfloat16
    raise ValueError(f'{RS_DTYPE_ENV}={env!r}: use f32 or bf16')


def make_mesh(shape: tuple[int, int], device_type: str):
    """The mesh of ``--mesh``: ``shape`` from ``Config.mesh_shape``, ``(0,
    0)`` for auto.  Joins or starts the process group; returns ``(mesh,
    created)``, where ``created`` says the caller destroys the group.

    Raises when the product of ``shape`` is not the number of ranks, and
    when more than one rank is asked for outside torchrun.
    """
    n = shape[0] * shape[1]
    if n > 1 and not dist.is_initialized() and not multihost.launched():
        raise RuntimeError(
            f'--mesh {shape[0]}x{shape[1]} needs {n} ranks, one per GPU: run '
            f'torchrun --nproc_per_node {n} -m textgcn_tpu_torch ...')
    device = multihost.local_device(device_type)
    created = multihost.maybe_initialize(device)
    try:
        world = dist.get_world_size()
        shape = auto_shape(world) if n == 0 else tuple(shape)
        if shape[0] * shape[1] != world:
            raise ValueError(f'--mesh {shape[0]}x{shape[1]} has '
                             f'{shape[0] * shape[1]} ranks, the group has '
                             f'WORLD_SIZE={world}')
        if device.type == 'cuda' and world > 1 \
                and 'LOCAL_RANK' not in os.environ:
            raise RuntimeError('a multi-rank group on CUDA needs LOCAL_RANK '
                               'to pick each rank\'s card')
        return Mesh(shape, dist.get_rank(), device), created
    except BaseException:
        if created:
            dist.destroy_process_group()
        raise


def shard_model(mesh: Mesh, model, data):
    """Row-shard a model in place: its tables keep this rank's rows of the
    zero-padded tables (and their ``requires_grad``: a frozen head's stay
    frozen) and its graph op becomes ``MeshConvOp`` (the conv family) or
    ``MeshGraphOp`` (the other ``LightGCN`` models).  Everything else, the
    buffers included, stays whole.

    ``data`` is ``padded_to(mesh.size)``: phantom rows have no edges, are
    never sampled and never scored.  ``lgcn``'s stay zero; a conv layer
    maps them to its bias and root terms, which reach no real row.
    """
    from ..models.conv import ConvModel
    from .sharded_conv import MeshConvOp
    from .sharded_spmm import MeshGraphOp
    nu, ni = data.n_users_padded, data.n_items_padded
    with torch.no_grad():
        for name, n in (('user_emb', nu), ('item_emb', ni)):
            full = getattr(model, name)
            padded = torch.zeros((n, full.shape[1]), dtype=full.dtype,
                                 device=full.device)
            padded[:full.shape[0]] = full
            setattr(model, name, nn.Parameter(
                padded[mesh.rows(n)].clone(),
                requires_grad=full.requires_grad))
    g = data.graph
    if isinstance(model, ConvModel):
        model.graph_op = MeshConvOp(g.edge_user, g.edge_item, nu, ni, mesh)
    else:
        model.graph_op = MeshGraphOp(g.edge_user, g.edge_item,
                                     model.graph_edge_weight(g), nu, ni,
                                     mesh)
    model.mesh = mesh
    return model
