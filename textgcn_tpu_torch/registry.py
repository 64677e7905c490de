"""Model registry: name -> (dataset loader, model class).

Counterpart of ``textgcn_tpu/registry.py``; all 20 models are ported:
``lgcn`` (``LightGCN``), ``adv_sampling`` (``AdvSamplModel``), the conv
family ``gcn``, ``graphsage``, ``gat`` and ``gatv2`` (``ConvModel``), and
on ``load_ltr_data`` the LTR heads ``ltr_linear`` and ``ltr_pop``, the
text-loss models ``text``, ``kg`` and ``reviews``, the concat scorers
``ltr_reviews``, ``ltr_kg`` and ``ltr_simple``, ``text_probe``
(``LightGCN``; its probe runs in the CLI, as ``ltr_simple``'s does) and
the boosted heads ``gbdt``, ``xgboost``, ``gbdt_pop``, ``xgboost_pop`` and
``marcus`` (``BOOSTED_MODELS``: the CLI trains them with
``BoostedTrainer``).
"""

from __future__ import annotations

from .config import CONV_MODELS, MODEL_CHOICES, Config


def get_class(name: str):
    if name not in MODEL_CHOICES:
        raise ValueError(f'unknown model {name!r}')
    from .data.core import load_interactions
    from .data.text import load_ltr_data
    from .models.adv_sampling import AdvSamplModel
    from .models.conv import ConvModel
    from .models.lightgcn import LightGCN
    from .models.ltr import LTRLinear, LTRLinearWPop
    from .models.ltr_boosted import (LTRGradientBoosted,
                                     LTRGradientBoostedWPop,
                                     MarcusGradientBoosted)
    from .models.ltr_concat import LTRCosine, LTRSimple
    from .models.text_loss import TextModel, TextModelKG, TextModelReviews

    def base_loader(cfg: Config):
        return load_interactions(cfg.data, reshuffle=cfg.reshuffle,
                                 seed=cfg.seed)

    on_text = {'ltr_linear': LTRLinear, 'ltr_pop': LTRLinearWPop,
               'text': TextModel, 'kg': TextModelKG,
               'reviews': TextModelReviews, 'text_probe': LightGCN,
               'xgboost': LTRGradientBoosted, 'gbdt': LTRGradientBoosted,
               'xgboost_pop': LTRGradientBoostedWPop,
               'gbdt_pop': LTRGradientBoostedWPop,
               'marcus': MarcusGradientBoosted,
               'ltr_reviews': LTRCosine, 'ltr_kg': LTRCosine,
               'ltr_simple': LTRSimple}
    if name in on_text:
        return load_ltr_data, on_text[name]
    if name == 'adv_sampling':
        return base_loader, AdvSamplModel
    return base_loader, ConvModel if name in CONV_MODELS else LightGCN
