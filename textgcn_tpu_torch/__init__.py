"""textgcn_tpu_torch — the PyTorch + CUDA port of ``textgcn_tpu``.

Trains and serves LightGCN (``lgcn``) and its GAT variant (``gat``) on an
NVIDIA Hopper card: load the interactions, sample BPR triples on the
device, propagate with hash edge dropout through hand-written CUDA
kernels (``csrc/spmm_dropout.cu`` for LightGCN forward and backward,
``csrc/gat_fwd.cu`` and ``csrc/gat_bwd.cu`` for GAT's attention), take
Adam steps, evaluate, checkpoint in the JAX package's pickle format, and
serve the top-k with ``predictions.tsv``.  Module names mirror the JAX
package so every counterpart is found by name.

Imports torch, numpy and the standard library only: never ``jax`` and
never the JAX package.
"""

__version__ = '0.2.0'
