"""CLI entry point — the training and serving paths of ``textgcn_tpu/cli.py``.

    python -m textgcn_tpu_torch --model lgcn --data D --epochs N \
        --evaluate_every M
    python -m textgcn_tpu_torch --model gat|gatv2|gcn --aggr mean --data D ...
    python -m textgcn_tpu_torch --model graphsage --aggr mean|sum|max ...
    python -m textgcn_tpu_torch --model lgcn --data D --no_train \
        --load runs/<data>/<uid> [--predict] [--export_reprs]
    python -m textgcn_tpu_torch --model ltr_linear|ltr_pop --data D \
        --load_base runs/<data>/<lgcn uid> --freeze ...
    python -m textgcn_tpu_torch --model adv_sampling --data D ...
    python -m textgcn_tpu_torch --model text|kg|reviews [--weight W \
        --distance F --dist_fn euclid|cosine_minus --pos avg|user|kg \
        --neg avg|kg] --data D ...
    python -m textgcn_tpu_torch --model ltr_reviews|ltr_kg --data D ...
    python -m textgcn_tpu_torch --model text_probe --data D
    python -m textgcn_tpu_torch --model ltr_simple --load_base RUN --data D
    python -m textgcn_tpu_torch --model gbdt|gbdt_pop|xgboost|xgboost_pop|\
        marcus --data D --load_base RUN [--predict] [--export_reprs]
    python -m textgcn_tpu_torch ... --resume runs/<data>/<uid>
    python -m textgcn_tpu_torch --model lgcn ... --refresh_every N
    python -m textgcn_tpu_torch --model lgcn --mesh 1x1|auto ...
    python -m textgcn_tpu_torch --model gcn|graphsage|gat|gatv2 \
        --aggr mean|sum|max --mesh 1x1|auto ...
    python -m textgcn_tpu_torch --model ltr_linear|ltr_pop \
        --load_base RUN [--freeze] --mesh 1x1|auto ...
    python -m textgcn_tpu_torch --model adv_sampling|text|kg|reviews|\
        ltr_reviews|ltr_kg --mesh 1x1|auto ...
    python -m textgcn_tpu_torch --model text_probe --mesh 1x1|auto ...
    python -m textgcn_tpu_torch --model ltr_simple --load_base RUN \
        --mesh 1x1|auto ...
    python -m textgcn_tpu_torch --model gbdt|gbdt_pop|xgboost|xgboost_pop|\
        marcus --load_base RUN --mesh 1x1|auto ...
    python -m textgcn_tpu_torch ... --ckpt_backend orbax [--mesh ...]
    python -m textgcn_tpu_torch ... --reshuffle [--seed S]
    python -m textgcn_tpu_torch ... --trace DIR
    python -m textgcn_tpu_torch --model lgcn ... --no_train --load RUN \
        --approx_topk 0.95 [--mesh ...]          # serving mode
    torchrun --nproc_per_node N -m textgcn_tpu_torch --model lgcn \
        --mesh AxB ...                                  # A * B == N
    (every model the same way under torchrun)

Drives: config parse -> (``--approx_topk``: ``TEXTGCN_TPU_APPROX_TOPK``
exported while ``main`` runs) -> (``--mesh``: the process group, one rank
per GPU) -> the device health check (``device_healthcheck``) -> dataset
load -> (``--mesh``: tables padded to the number of ranks
and row-sharded; conv layers, LTR towers and text buffers whole) -> model
build ->
``--resume`` (the whole trainer state of a stopped run), else ``--load`` or ``--load_base`` (with its
evaluation; before training it warm-starts the params; ``--load_base``
evaluates an LTR head's base with plain scoring, then switches the head
on) -> ``fit`` unless ``--no_train`` (under ``--trace DIR`` inside a
``torch.profiler`` trace, ``utils/profiling.trace``) -> ``--predict`` ->
``--export_reprs``; the boosted heads fit their trees in ``fit`` and
load with their ``forest.npz`` (``BoostedTrainer``; on a mesh every rank
fits the same forest from the gathered tables and scores its own
catalogue rows).  ``text_probe``
returns after its probe of the four
text representations, before any load; ``ltr_simple`` after the load and
its probe of the two item texts.  Runs on the GPU;
``TEXTGCN_TPU_PLATFORM=cpu`` asks for the CPU (gloo for ``--mesh``).  A
process group this call started is destroyed before it returns, and the
environment is restored, so ``main`` can run again in the same process.
"""

from __future__ import annotations

import logging
import os
import threading
import time

import torch

from .config import (BOOSTED_MODELS, LOGGER_NAME, get_logger, parse_args,
                     platform_device, warn_footguns)
from .ops.retrieval import APPROX_TOPK_ENV
from .registry import get_class
from .train.trainer import Trainer

WARN_ENV = 'TEXTGCN_TPU_DEVICE_WARN_S'
TIMEOUT_ENV = 'TEXTGCN_TPU_DEVICE_TIMEOUT_S'


def device_healthcheck(warn_after_s: float | None = None,
                       fail_after_s: float | None = None,
                       _probe=None, device=None) -> float:
    """Round-trip a scalar through ``device`` before any data is loaded, so
    a wedged card fails loudly instead of hanging the first real op.

    The probe (``torch.ones((), device=device).add_(1).item()``, then a
    ``torch.cuda.synchronize`` on a card; ``_probe`` replaces it in tests)
    runs in a thread.  After ``warn_after_s`` (``TEXTGCN_TPU_DEVICE_WARN_S``,
    default 60) one ERROR is logged; after ``fail_after_s``
    (``TEXTGCN_TPU_DEVICE_TIMEOUT_S``, default 0: wait for ever) a
    ``TimeoutError`` is raised.  An exception of the probe is raised here.
    Returns the round trip in seconds.
    """
    log = logging.getLogger(LOGGER_NAME)
    if warn_after_s is None:
        warn_after_s = float(os.environ.get(WARN_ENV, '60'))
    if fail_after_s is None:
        fail_after_s = float(os.environ.get(TIMEOUT_ENV, '0'))
    dev = torch.device('cpu' if device is None else device)

    def default_probe():
        torch.ones((), device=dev).add_(1).item()
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    done = threading.Event()
    err: list[BaseException] = []

    def probe():
        try:
            (_probe or default_probe)()
        except BaseException as e:  # raised on the calling thread
            err.append(e)
        finally:
            done.set()

    threading.Thread(target=probe, daemon=True).start()
    warned = False
    # wake often enough to warn and to give up on time
    tick = min([5.0] + [max(s / 4.0, 0.02)
                        for s in (warn_after_s, fail_after_s) if s])
    while not done.wait(timeout=tick):
        waited = time.perf_counter() - t0
        if not warned and waited >= warn_after_s:
            log.error('device unresponsive after %.0f s; still waiting (set '
                      '%s to abort instead)', waited, TIMEOUT_ENV)
            warned = True
        if fail_after_s and waited >= fail_after_s and not done.is_set():
            raise TimeoutError(f'device unresponsive after {waited:.0f} s '
                               f'({TIMEOUT_ENV}={fail_after_s:g})')
    if err:
        raise err[0]
    return time.perf_counter() - t0


def main(argv: list[str] | None = None):
    cfg = parse_args(argv)
    device = platform_device()
    saved = os.environ.get(APPROX_TOPK_ENV)
    if cfg.approx_topk:
        # serving mode: every retrieval sink reads it (ops/retrieval)
        os.environ[APPROX_TOPK_ENV] = str(cfg.approx_topk)
    try:
        if not cfg.mesh:
            return _run(cfg, device)
        import torch.distributed as dist

        from .parallel.mesh import make_mesh
        mesh, created = make_mesh(cfg.mesh_shape, device.type)
        try:
            return _run(cfg, mesh.device, mesh)
        finally:
            if created:
                dist.destroy_process_group()
    finally:
        if saved is None:
            os.environ.pop(APPROX_TOPK_ENV, None)
        else:
            os.environ[APPROX_TOPK_ENV] = saved


def _run(cfg, device, mesh=None):
    from .parallel.multihost import is_primary
    logger = get_logger(cfg, primary=is_primary())
    warn_footguns(cfg, logger)
    loader, model_cls = get_class(cfg.model)
    logger.info('Class: %s', model_cls.__name__)
    logger.info('%s', cfg)
    logger.info('Device: %s', device)
    if mesh is not None:
        logger.info('Mesh: data=%d, model=%d (%d ranks)', *mesh.shape,
                    mesh.size)
    if cfg.approx_topk:
        logger.info('Serving mode: %s=%g (bfloat16 scores, exact top-k)',
                    APPROX_TOPK_ENV, cfg.approx_topk)
    # fail loudly, not hang, on a wedged card: before the data load
    rtt = device_healthcheck(device=device)
    logger.info('Device backend ready (%.2f s probe)', rtt)

    data = loader(cfg)
    if mesh is not None:
        from .parallel.mesh import shard_model
        data = data.padded_to(mesh.size)
    model = model_cls(cfg, data, device=device)
    if mesh is not None:
        model = shard_model(mesh, model, data)
    if cfg.model in BOOSTED_MODELS:
        from .models.ltr_boosted import BoostedTrainer
        trainer = BoostedTrainer(cfg, model, data)
    else:
        trainer = Trainer(cfg, model, data)
    if cfg.model == 'text_probe':
        from .models.text_loss import probe_text_representations
        for combo, res in probe_text_representations(data,
                                                     trainer).items():
            logger.info('probe %s: %s', combo, res)
        return trainer
    logger.info('Created model %s (%d users x %d items, %d edges)',
                cfg.uid, data.n_users, data.n_items, data.graph.n_edges)

    if cfg.resume:
        trainer.resume(cfg.resume)
    elif cfg.load:
        trainer.load(cfg.load)
    elif cfg.load_base:
        # an LTR head's base is evaluated with plain scoring first
        head = getattr(model, 'score_with_head', None)
        if head is not None:
            model.score_with_head = False
        trainer.load(cfg.load_base)
        if head is not None:
            model.score_with_head = True
    if cfg.model == 'ltr_simple':
        from .models.ltr_concat import probe_concat_scoring
        for mode, res in probe_concat_scoring(trainer).items():
            logger.info('concat probe pos=%s: %s', mode, res)
        return trainer
    if not cfg.no_train:
        if cfg.trace:
            from .utils.profiling import trace
            with trace(cfg.trace, device):
                trainer.fit()
        else:
            trainer.fit()
    if cfg.predict:
        trainer.predict(range(data.n_users), with_scores=True, save=True)
    if cfg.export_reprs:
        trainer.export_reprs()
    return trainer


if __name__ == '__main__':
    main()
