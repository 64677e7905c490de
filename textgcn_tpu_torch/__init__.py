"""textgcn_tpu_torch — the PyTorch + CUDA port of ``textgcn_tpu``.

Trains and serves all 20 models of the JAX package's registry on an
NVIDIA Hopper card: LightGCN (``lgcn``), ``adv_sampling``, the conv family
(``gcn``, ``graphsage``, ``gat``, ``gatv2``), the LTR heads, the text-loss
models, the concat scorers, the probes and the boosted heads.  The graph
propagation runs on hand-written CUDA kernels (``csrc/``: the SpMM with
hash edge dropout, its weighted form on a mesh, and GAT's and GATv2's
attention, forward and backward).  Every model also runs row-sharded over
``torch.distributed`` ranks, one per GPU (``--mesh``, ``parallel/``).
Checkpoints are the JAX package's pickles, or ``torch.distributed
.checkpoint`` directories under ``--ckpt_backend orbax``.  Serving mode
(``--approx_topk``) scores in bfloat16; the text encoder
(``data/encoder.py``) is a BERT in plain PyTorch that reads a local
model directory.  Module names mirror the JAX package so every
counterpart is found by name.

The public API is the JAX package's: ``Config``, ``get_class``,
``get_logger``, ``parse_args``, and, imported on first use, ``LightGCN``,
``AdvSamplModel``, ``LTRLinear``, ``LTRLinearWPop``, ``Trainer``,
``load_interactions`` and ``load_ltr_data``.

Imports torch, numpy and the standard library only: never ``jax``, never
the JAX package and never a Hugging Face package.
"""

__version__ = '0.5.0'

from .config import Config, get_logger, parse_args  # noqa: E402
from .registry import get_class  # noqa: E402

__all__ = ['Config', 'get_class', 'get_logger', 'parse_args',
           'AdvSamplModel', 'LightGCN', 'LTRLinear', 'LTRLinearWPop',
           'Trainer', 'load_interactions', 'load_ltr_data']

_LAZY = {
    'LightGCN': ('textgcn_tpu_torch.models.lightgcn', 'LightGCN'),
    'AdvSamplModel': ('textgcn_tpu_torch.models.adv_sampling',
                      'AdvSamplModel'),
    'LTRLinear': ('textgcn_tpu_torch.models.ltr', 'LTRLinear'),
    'LTRLinearWPop': ('textgcn_tpu_torch.models.ltr', 'LTRLinearWPop'),
    'Trainer': ('textgcn_tpu_torch.train.trainer', 'Trainer'),
    'load_interactions': ('textgcn_tpu_torch.data.core',
                          'load_interactions'),
    'load_ltr_data': ('textgcn_tpu_torch.data.text', 'load_ltr_data'),
}


def __getattr__(name):
    """The model, data and training names, imported on first use."""
    if name in _LAZY:
        import importlib
        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(name)
