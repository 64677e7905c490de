"""Typed configuration: the ``textgcn_tpu`` flag surface, for the port.

Counterpart of ``textgcn_tpu/config.py``: the same ``Config`` fields, the
same flag names and defaults, the same ``finalize`` (``save_path =
runs/<data-basename>/<uid>``, sorted k) and the same log format.  What the
port does not run yet is refused in ``validate`` with "not ported yet".

Knobs that exist for the TPU:

* ``--no_pallas`` and ``--steps_per_call`` are accepted and ignored: the
  port has one kernel per function and no device-call relay to bound.
* ``--mesh DATAxMODEL|auto`` runs ``lgcn`` over ``torch.distributed``
  ranks, one per GPU (``parallel/``); the other models refuse it.
  ``--approx_topk`` is refused when set: the port serves an exact top-k.
* ``--refresh_every`` (cached propagation) is refused when non-zero: not
  ported yet.

``resolve_device`` picks the device: CUDA unless the caller asks for the
CPU, and an error, never a silent CPU run, when CUDA is absent.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time
from dataclasses import dataclass, field

import torch

MODEL_CHOICES = (
    'lgcn', 'adv_sampling', 'ltr_linear', 'ltr_pop', 'text', 'kg',
    'reviews', 'text_probe', 'xgboost', 'gbdt', 'xgboost_pop', 'gbdt_pop',
    'marcus', 'ltr_reviews', 'ltr_kg', 'ltr_simple', 'gcn', 'graphsage',
    'gat', 'gatv2',
)
PORTED_MODELS = ('lgcn', 'gcn', 'graphsage', 'gat', 'gatv2')
CONV_MODELS = ('gcn', 'graphsage', 'gat', 'gatv2')

LOGGER_NAME = 'textgcn_tpu_torch'
PLATFORM_ENV = 'TEXTGCN_TPU_PLATFORM'


@dataclass
class Config:
    # --- model / data ------------------------------------------------------
    model: str = 'lgcn'
    data: str = 'data/dummy/'
    uid: str | None = None

    # --- training regime ----------------------------------------------------
    epochs: int = 1000
    emb_size: int = 64
    neg_samples: int = 1
    batch_size: int = 2048
    evaluate_every: int = 25
    k: tuple[int, ...] = (20, 40)
    lr: float = 1e-3
    reg_lambda: float = 1e-4
    dropout: float = 0.4
    n_layers: int = 3
    single: bool = False          # last layer instead of the layer mean

    # --- LTR ---------------------------------------------------------------
    ltr_layers: tuple[int, ...] = ()
    freeze: bool = False
    load_base: str | None = None

    # --- persistence -------------------------------------------------------
    save: bool = True
    load: str | None = None
    no_train: bool = False
    predict: bool = False
    resume: str | None = None
    resume_state: bool = True

    # --- text pipeline -------------------------------------------------------
    emb_batch_size: int = 256
    bert_model: str = 'all-MiniLM-L6-v2'
    sep: str = '[SEP]'
    weight: str = '1'
    distance: str = '|b-g|'
    dist_fn: str = 'euclid'
    pos: str = 'avg'
    neg: str = 'avg'
    popularity_mode: str = 'fixed'
    aggr: str | None = None

    # --- serving / ops -------------------------------------------------------
    export_reprs: bool = False
    trace: str = ''

    # --- misc --------------------------------------------------------------
    seed: int = 0
    reshuffle: bool = False
    quiet: bool = False
    logging_level: str = 'info'
    slurm: bool = False

    # --- knobs of the TPU build (see the module docstring) -------------------
    mesh: str = ''
    data_axis: str = 'data'
    model_axis: str = 'model'
    param_dtype: str = 'float32'
    compute_dtype: str = 'float32'
    use_pallas: bool = True
    precompute_adjacency: bool = True
    ckpt_backend: str = 'pickle'
    approx_topk: float = 0.0
    steps_per_call: int = 0
    refresh_every: int = 0

    # --- derived (filled by finalize()) -------------------------------------
    save_path: str = field(default='', compare=False)

    def finalize(self) -> 'Config':
        """Derive save_path, sort k and clamp the eval cadence, as
        ``textgcn_tpu.config.Config.finalize`` does."""
        cfg = dataclasses.replace(self)
        cfg.k = tuple(sorted(cfg.k))
        cfg.data = os.path.join(cfg.data, '')
        cfg.uid = cfg.uid or time.strftime('%m-%d-%Hh%Mm%Ss')
        if not cfg.save_path:
            base = os.path.basename(os.path.dirname(cfg.data))
            cfg.save_path = os.path.join('runs', base, cfg.uid)
        if cfg.evaluate_every > cfg.epochs:
            cfg.evaluate_every = cfg.epochs
        return cfg

    @property
    def mesh_shape(self) -> tuple[int, int]:
        """``--mesh AxB`` as ``(data, model)`` sizes; ``(0, 0)`` for
        ``auto`` (the shape is derived from the number of ranks, see
        ``parallel.mesh.auto_shape``) and when no mesh is asked for."""
        if not self.mesh or self.mesh.lower() == 'auto':
            return (0, 0)
        parts = self.mesh.lower().split('x')
        if len(parts) != 2 or not all(p.isdigit() and int(p) > 0
                                      for p in parts):
            raise ValueError(f'--mesh must be DATAxMODEL with positive '
                             f'sizes, or auto; got {self.mesh!r}')
        return (int(parts[0]), int(parts[1]))

    def validate(self) -> None:
        if self.model not in MODEL_CHOICES:
            raise ValueError(f'unknown model {self.model!r}')
        if self.model not in PORTED_MODELS:
            raise NotImplementedError(
                f'model {self.model!r} is not ported yet (ported: '
                f'{", ".join(PORTED_MODELS)})')
        if self.load is not None and self.load_base is not None:
            raise ValueError('cannot load both base and trained model')
        if self.resume is not None and (self.load is not None
                                        or self.load_base is not None):
            raise ValueError('--resume restores full trainer state; it '
                             'excludes --load/--load_base')
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f'dropout must be in [0, 1), got {self.dropout}')
        if self.epochs < 1 or self.batch_size < 1 or self.evaluate_every < 1:
            raise ValueError('epochs, batch_size and evaluate_every must be '
                             'positive')
        if self.model in CONV_MODELS and self.aggr is None:
            raise ValueError(f'--aggr is required for conv model '
                             f'{self.model!r}: pass one of mean|sum|max')
        if self.refresh_every:
            raise NotImplementedError(
                '--refresh_every (cached propagation) is not ported yet')
        if self.mesh:
            if self.model != 'lgcn':
                raise NotImplementedError(
                    f'--mesh for {self.model!r} is not ported yet (ported: '
                    'lgcn)')
            self.mesh_shape  # raises on a malformed shape
        if self.approx_topk:
            raise NotImplementedError(
                '--approx_topk is not ported yet: the port serves exact '
                'top-k')
        if self.trace:
            raise NotImplementedError(
                '--trace (a profiler trace of training) is not ported yet')


def build_argparser() -> argparse.ArgumentParser:
    from . import __version__
    p = argparse.ArgumentParser(
        description='TextGCN/LightGCN on PyTorch + CUDA (port of textgcn_tpu)')
    d = Config()
    p.add_argument('--version', action='version',
                   version=f'textgcn-tpu-torch {__version__}')
    p.add_argument('--model', required=True, choices=MODEL_CHOICES)
    p.add_argument('--data', '-d', default=d.data)
    p.add_argument('--uid', type=str, default=None)
    p.add_argument('--epochs', '-e', type=int, default=d.epochs)
    p.add_argument('--emb_size', type=int, default=d.emb_size)
    p.add_argument('--neg_samples', type=int, default=d.neg_samples)
    p.add_argument('--batch_size', type=int, default=d.batch_size)
    p.add_argument('--evaluate_every', '--eval_every', type=int,
                   default=d.evaluate_every)
    p.add_argument('-k', type=int, nargs='*', default=list(d.k))
    p.add_argument('--lr', type=float, default=d.lr)
    p.add_argument('--reg_lambda', type=float, default=d.reg_lambda)
    p.add_argument('--dropout', type=float, default=d.dropout)
    p.add_argument('--n_layers', type=int, default=d.n_layers)
    p.add_argument('--single', action='store_true')
    p.add_argument('--ltr_layers', type=int, nargs='*', default=[])
    p.add_argument('--freeze', action='store_true')
    p.add_argument('--load_base', type=str, default=None)
    p.add_argument('--no_save', action='store_true',
                   help='disable checkpointing (saving is on by default)')
    p.add_argument('--save', action='store_true',
                   help='accepted for reference CLI compatibility (no-op)')
    p.add_argument('--load', type=str, default=None)
    p.add_argument('--resume', type=str, default=None)
    p.add_argument('--no_resume_state', action='store_true')
    p.add_argument('--no_train', action='store_true')
    p.add_argument('--predict', action='store_true')
    p.add_argument('--emb_batch_size', type=int, default=d.emb_batch_size)
    p.add_argument('--bert_model', type=str, default=d.bert_model)
    p.add_argument('--separator', '--sep', dest='sep', type=str, default=d.sep)
    p.add_argument('--weight', type=str, default=d.weight)
    p.add_argument('--distance', type=str, default=d.distance)
    p.add_argument('--dist_fn', default=d.dist_fn,
                   choices=['euclid', 'cosine_minus'])
    p.add_argument('--pos', default=d.pos, choices=['user', 'avg', 'kg'])
    p.add_argument('--neg', default=d.neg, choices=['avg', 'kg'])
    p.add_argument('--popularity_mode', default=d.popularity_mode,
                   choices=['fixed', 'compat'])
    p.add_argument('--gpu', type=str, default='',
                   help='accepted for reference CLI compatibility (no-op)')
    p.add_argument('--seed', type=int, default=d.seed)
    p.add_argument('--reshuffle', action='store_true')
    p.add_argument('--quiet', '-q', action='store_true')
    p.add_argument('--logging_level', default=d.logging_level,
                   choices=['debug', 'info', 'warn', 'error'])
    p.add_argument('--slurm', action='store_true')
    p.add_argument('--mesh', type=str, default=d.mesh,
                   help='DATAxMODEL or auto: lgcn over torch.distributed '
                        'ranks, one per GPU (torchrun for more than one)')
    p.add_argument('--no_pallas', action='store_true',
                   help='accepted and ignored (TPU kernel switch)')
    p.add_argument('--ckpt_backend', default=d.ckpt_backend,
                   choices=['pickle', 'orbax'])
    p.add_argument('--approx_topk', type=float, default=d.approx_topk,
                   help='not ported yet: refused when non-zero')
    p.add_argument('--steps_per_call', type=int, default=d.steps_per_call,
                   help='accepted and ignored (TPU relay knob)')
    p.add_argument('--export_reprs', action='store_true',
                   help='write propagated user/item representations as '
                        '.npy into the run dir')
    p.add_argument('--trace', type=str, default=d.trace)
    p.add_argument('--aggr', '--aggregator', dest='aggr', default=d.aggr,
                   choices=['mean', 'sum', 'max'])
    p.add_argument('--refresh_every', type=int, default=d.refresh_every,
                   help='not ported yet: refused when non-zero')
    return p


def parse_args(argv: list[str] | None = None) -> Config:
    ns = build_argparser().parse_args(argv)
    weight, distance = ns.weight, ns.distance
    if '_' in weight:
        weight, distance = weight.split('_', 1)
    cfg = Config(
        model=ns.model, data=ns.data, uid=ns.uid, epochs=ns.epochs,
        emb_size=ns.emb_size, neg_samples=ns.neg_samples,
        batch_size=ns.batch_size, evaluate_every=ns.evaluate_every,
        k=tuple(ns.k), lr=ns.lr, reg_lambda=ns.reg_lambda,
        dropout=ns.dropout, n_layers=ns.n_layers, single=ns.single,
        ltr_layers=tuple(ns.ltr_layers), freeze=ns.freeze,
        load_base=ns.load_base, save=not ns.no_save, load=ns.load,
        resume=ns.resume, resume_state=not ns.no_resume_state,
        no_train=ns.no_train, predict=ns.predict,
        emb_batch_size=ns.emb_batch_size, bert_model=ns.bert_model,
        sep=ns.sep, weight=weight, distance=distance, dist_fn=ns.dist_fn,
        pos=ns.pos, neg=ns.neg, popularity_mode=ns.popularity_mode,
        aggr=ns.aggr, seed=ns.seed, reshuffle=ns.reshuffle, quiet=ns.quiet,
        logging_level=ns.logging_level, slurm=ns.slurm, mesh=ns.mesh,
        use_pallas=not ns.no_pallas, ckpt_backend=ns.ckpt_backend,
        approx_topk=ns.approx_topk, steps_per_call=ns.steps_per_call,
        refresh_every=ns.refresh_every, export_reprs=ns.export_reprs,
        trace=ns.trace,
    ).finalize()
    cfg.validate()
    return cfg


def resolve_device(device=None) -> torch.device:
    """The device entry points run on: CUDA by default.

    ``device=None`` means the card.  The CPU runs only when the caller
    names it.  Asking for CUDA where there is none raises; nothing falls
    back to the CPU.
    """
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'CUDA is not available: the port runs on the GPU unless the '
            f'CPU is asked for (device="cpu", or {PLATFORM_ENV}=cpu for '
            'the CLI)')
    if dev.type not in ('cuda', 'cpu'):
        raise ValueError(f'unsupported device {dev}')
    return dev


def platform_device() -> torch.device:
    """The device of a command-line entry point: the card, or the CPU
    when ``TEXTGCN_TPU_PLATFORM=cpu`` asks for it."""
    platform = os.environ.get(PLATFORM_ENV, '').lower()
    if platform not in ('', 'cpu', 'cuda', 'gpu'):
        raise ValueError(f'{PLATFORM_ENV}={platform!r}: use cpu or cuda')
    return resolve_device('cpu' if platform == 'cpu' else None)


def get_logger(cfg: Config, primary: bool = True) -> logging.Logger:
    """File + stream logger: ``log.log`` (mode='w') in the run directory,
    mirrored to stderr, in the JAX package's format.  A rank other than
    the primary one of a mesh run writes no file and logs errors only."""
    level_map = {'debug': logging.DEBUG, 'info': logging.INFO,
                 'warn': logging.WARNING, 'error': logging.ERROR}
    level = logging.ERROR if cfg.quiet or not primary \
        else level_map[cfg.logging_level]
    logger = logging.getLogger(LOGGER_NAME)
    logger.setLevel(level)
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()
    fmt = logging.Formatter('%(asctime)-10s - %(levelname)s: %(message)s',
                            datefmt='%d/%m/%y %H:%M')
    handlers = [logging.StreamHandler()]
    if primary:
        os.makedirs(cfg.save_path, exist_ok=True)
        handlers.append(logging.FileHandler(
            os.path.join(cfg.save_path, 'log.log'), mode='w'))
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)
    logger.propagate = False
    return logger
