"""textgcn_tpu_torch — the PyTorch + CUDA port of ``textgcn_tpu``.

Runs the serving path of LightGCN (``lgcn``) on an NVIDIA Hopper card:
load the interactions, load a checkpoint, propagate through the
hand-written CUDA SpMM kernel (``csrc/spmm_dropout.cu``), score, take the
top-k, compute the metrics and write ``predictions.tsv``.  Module names
mirror the JAX package so every counterpart is found by name.

Imports torch, numpy and the standard library only: never ``jax`` and
never the JAX package.
"""

__version__ = '0.1.0'
