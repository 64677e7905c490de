"""Model registry: name -> (dataset loader, model class).

Counterpart of ``textgcn_tpu/registry.py``; ``lgcn`` and ``gat`` are
ported.
"""

from __future__ import annotations

from .config import CONV_MODELS, PORTED_MODELS, Config


def get_class(name: str):
    if name not in PORTED_MODELS:
        raise NotImplementedError(f'model {name!r} is not ported yet')
    from .data.core import load_interactions
    from .models.conv import ConvModel
    from .models.lightgcn import LightGCN

    def base_loader(cfg: Config):
        return load_interactions(cfg.data, reshuffle=cfg.reshuffle,
                                 seed=cfg.seed)

    return base_loader, ConvModel if name in CONV_MODELS else LightGCN
