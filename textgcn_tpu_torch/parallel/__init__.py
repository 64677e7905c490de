"""The mesh path: every model over ``torch.distributed`` ranks, one per
GPU.

Counterpart of ``textgcn_tpu/parallel/``:

* ``multihost``: the process group (torchrun's environment, or one rank
  in-process), the rank's device, ``is_primary``, ``barrier``;
* ``mesh``: the ``Mesh`` of a run (shape, rank, device, the rows each rank
  owns), ``collective_dtype`` and ``shard_model``;
* ``sharded_spmm``: ``MeshGraphOp``, the source-row-sharded propagation on
  kernel K2 with a reduce-scatter (``pallas_sharded.MeshPallasGraphOp``),
  for ``lgcn`` and the other ``LightGCN`` models;
* ``sharded_conv``: ``MeshConvOp``, the destination-row shards of the
  conv family (K1, K3-K6 over the edges into a rank's rows);
* ``sharded``: the catalogue-sharded exact top-k (from given scores too,
  with ties to the lower index for the boosted heads) and the
  differentiable row gather of the loss.
"""

from .mesh import Mesh, make_mesh, shard_model

__all__ = ['Mesh', 'make_mesh', 'shard_model']
