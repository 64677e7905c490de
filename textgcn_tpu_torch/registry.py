"""Model registry: name -> (dataset loader, model class).

Counterpart of ``textgcn_tpu/registry.py``; every model but the boosted
heads is ported: ``lgcn`` (``LightGCN``), ``adv_sampling``
(``AdvSamplModel``), the conv family ``gcn``, ``graphsage``, ``gat`` and
``gatv2`` (``ConvModel``), and on ``load_ltr_data`` the LTR heads
``ltr_linear`` and ``ltr_pop``, the text-loss models ``text``, ``kg`` and
``reviews``, the concat scorers ``ltr_reviews``, ``ltr_kg`` and
``ltr_simple``, and ``text_probe`` (``LightGCN``; its probe runs in the
CLI, as ``ltr_simple``'s does).
"""

from __future__ import annotations

from .config import CONV_MODELS, PORTED_MODELS, Config


def get_class(name: str):
    if name not in PORTED_MODELS:
        raise NotImplementedError(f'model {name!r} is not ported yet')
    from .data.core import load_interactions
    from .data.text import load_ltr_data
    from .models.adv_sampling import AdvSamplModel
    from .models.conv import ConvModel
    from .models.lightgcn import LightGCN
    from .models.ltr import LTRLinear, LTRLinearWPop
    from .models.ltr_concat import LTRCosine, LTRSimple
    from .models.text_loss import TextModel, TextModelKG, TextModelReviews

    def base_loader(cfg: Config):
        return load_interactions(cfg.data, reshuffle=cfg.reshuffle,
                                 seed=cfg.seed)

    on_text = {'ltr_linear': LTRLinear, 'ltr_pop': LTRLinearWPop,
               'text': TextModel, 'kg': TextModelKG,
               'reviews': TextModelReviews, 'text_probe': LightGCN,
               'ltr_reviews': LTRCosine, 'ltr_kg': LTRCosine,
               'ltr_simple': LTRSimple}
    if name in on_text:
        return load_ltr_data, on_text[name]
    if name == 'adv_sampling':
        return base_loader, AdvSamplModel
    return base_loader, ConvModel if name in CONV_MODELS else LightGCN
