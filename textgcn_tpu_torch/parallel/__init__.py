"""The mesh path: ``lgcn`` over ``torch.distributed`` ranks, one per GPU.

Counterpart of ``textgcn_tpu/parallel/`` for ``lgcn``:

* ``multihost``: the process group (torchrun's environment, or one rank
  in-process), the rank's device, ``is_primary``;
* ``mesh``: the ``Mesh`` of a run (shape, rank, device, the rows each rank
  owns), ``collective_dtype`` and ``shard_model``;
* ``sharded_spmm``: ``MeshGraphOp``, the source-row-sharded propagation on
  kernel K2 with a reduce-scatter (``pallas_sharded.MeshPallasGraphOp``);
* ``sharded``: the catalogue-sharded exact top-k and the differentiable
  row gather of the loss.
"""

from .mesh import Mesh, make_mesh, shard_model

__all__ = ['Mesh', 'make_mesh', 'shard_model']
