"""textgcn_tpu_torch — the PyTorch + CUDA port of ``textgcn_tpu``.

Trains and serves LightGCN (``lgcn``) and its conv variants (``gcn``,
``graphsage``, ``gat``, ``gatv2``) on an NVIDIA Hopper card: load the
interactions, sample BPR triples on the device, propagate with hash edge
dropout through hand-written CUDA kernels (``csrc/spmm_dropout.cu`` for
LightGCN, GCN and GraphSAGE mean|sum, forward and backward;
``csrc/gat_fwd.cu``/``gat_bwd.cu`` for GAT's attention and
``csrc/gatv2_fwd.cu``/``gatv2_bwd.cu`` for GATv2's; GraphSAGE max is a
plain segment max), take Adam steps, evaluate, checkpoint in the JAX
package's pickle format, and serve the top-k with ``predictions.tsv``.  Module names mirror the JAX
package so every counterpart is found by name.

Imports torch, numpy and the standard library only: never ``jax`` and
never the JAX package.
"""

__version__ = '0.3.0'
