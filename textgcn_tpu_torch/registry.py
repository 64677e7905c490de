"""Model registry: name -> (dataset loader, model class).

Counterpart of ``textgcn_tpu/registry.py``; ``lgcn`` (``LightGCN``), the
conv family ``gcn``, ``graphsage``, ``gat`` and ``gatv2`` (``ConvModel``)
and the LTR heads ``ltr_linear`` (``LTRLinear``) and ``ltr_pop``
(``LTRLinearWPop``) on ``load_ltr_data`` are ported.
"""

from __future__ import annotations

from .config import CONV_MODELS, PORTED_MODELS, Config


def get_class(name: str):
    if name not in PORTED_MODELS:
        raise NotImplementedError(f'model {name!r} is not ported yet')
    from .data.core import load_interactions
    from .data.text import load_ltr_data
    from .models.conv import ConvModel
    from .models.lightgcn import LightGCN
    from .models.ltr import LTRLinear, LTRLinearWPop

    def base_loader(cfg: Config):
        return load_interactions(cfg.data, reshuffle=cfg.reshuffle,
                                 seed=cfg.seed)

    if name == 'ltr_linear':
        return load_ltr_data, LTRLinear
    if name == 'ltr_pop':
        return load_ltr_data, LTRLinearWPop
    return base_loader, ConvModel if name in CONV_MODELS else LightGCN
