"""CLI entry point — the training and serving paths of ``textgcn_tpu/cli.py``.

    python -m textgcn_tpu_torch --model lgcn --data D --epochs N \
        --evaluate_every M
    python -m textgcn_tpu_torch --model gat|gatv2|gcn --aggr mean --data D ...
    python -m textgcn_tpu_torch --model graphsage --aggr mean|sum|max ...
    python -m textgcn_tpu_torch --model lgcn --data D --no_train \
        --load runs/<data>/<uid> [--predict] [--export_reprs]
    python -m textgcn_tpu_torch --model lgcn --mesh 1x1|auto ...
    torchrun --nproc_per_node N -m textgcn_tpu_torch --model lgcn \
        --mesh AxB ...                                  # A * B == N

Drives: config parse -> (``--mesh``: the process group, one rank per
GPU) -> dataset load -> (``--mesh``: tables padded to the number of ranks
and row-sharded) -> model build -> ``--load`` (with its evaluation; before
training it warm-starts the params) -> ``fit`` unless ``--no_train`` ->
``--predict`` -> ``--export_reprs``.  Runs on the GPU;
``TEXTGCN_TPU_PLATFORM=cpu`` asks for the CPU (gloo for ``--mesh``).  A
process group this call started is destroyed before it returns, so
``main`` can run again in the same process.  ``--resume`` is not ported
yet.
"""

from __future__ import annotations

from .config import get_logger, parse_args, platform_device
from .registry import get_class
from .train.trainer import Trainer


def main(argv: list[str] | None = None):
    cfg = parse_args(argv)
    device = platform_device()
    if cfg.resume:
        raise NotImplementedError('--resume is not ported yet')
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


def _run(cfg, device, mesh=None):
    from .parallel.multihost import is_primary
    logger = get_logger(cfg, primary=is_primary())
    loader, model_cls = get_class(cfg.model)
    logger.info('Class: %s', model_cls.__name__)
    logger.info('%s', cfg)
    logger.info('Device: %s', device)
    if mesh is not None:
        logger.info('Mesh: data=%d, model=%d (%d ranks)', *mesh.shape,
                    mesh.size)

    data = loader(cfg)
    if mesh is not None:
        from .parallel.mesh import shard_model
        data = data.padded_to(mesh.size)
    model = model_cls(cfg, data, device=device)
    if mesh is not None:
        model = shard_model(mesh, model, data)
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
