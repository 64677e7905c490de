"""CLI entry point — the training and serving paths of ``textgcn_tpu/cli.py``.

    python -m textgcn_tpu_torch --model lgcn --data D --epochs N \
        --evaluate_every M
    python -m textgcn_tpu_torch --model gat --aggr mean --data D ...
    python -m textgcn_tpu_torch --model lgcn --data D --no_train \
        --load runs/<data>/<uid> [--predict] [--export_reprs]

Drives: config parse -> dataset load -> model build -> ``--load`` (with
its evaluation; before training it warm-starts the params) -> ``fit``
unless ``--no_train`` -> ``--predict`` -> ``--export_reprs``.  Runs on
the GPU; ``TEXTGCN_TPU_PLATFORM=cpu`` asks for the CPU.  ``--resume`` is
not ported yet.
"""

from __future__ import annotations

import os

from .config import PLATFORM_ENV, get_logger, parse_args, resolve_device
from .registry import get_class
from .train.trainer import Trainer


def main(argv: list[str] | None = None):
    cfg = parse_args(argv)
    platform = os.environ.get(PLATFORM_ENV, '').lower()
    if platform not in ('', 'cpu', 'cuda', 'gpu'):
        raise ValueError(f'{PLATFORM_ENV}={platform!r}: use cpu or cuda')
    device = resolve_device('cpu' if platform == 'cpu' else None)
    if cfg.resume:
        raise NotImplementedError('--resume is not ported yet')
    logger = get_logger(cfg)
    loader, model_cls = get_class(cfg.model)
    logger.info('Class: %s', model_cls.__name__)
    logger.info('%s', cfg)
    logger.info('Device: %s', device)

    data = loader(cfg)
    model = model_cls(cfg, data, device=device)
    trainer = Trainer(cfg, model, data)
    logger.info('Created model %s (%d users x %d items, %d edges)',
                cfg.uid, data.n_users, data.n_items, data.graph.n_edges)

    if cfg.load or cfg.load_base:
        trainer.load(cfg.load or cfg.load_base)
    if not cfg.no_train:
        trainer.fit()
    if cfg.predict:
        trainer.predict(range(data.n_users), with_scores=True, save=True)
    if cfg.export_reprs:
        trainer.export_reprs()
    return trainer


if __name__ == '__main__':
    main()
