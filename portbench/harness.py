"""One run of one cell: set-up, the measured window, the traced
sub-window, the check against the plain reference, the result line.

Everything that belongs to a cell is found by name under the benchmark's
folder: ``workloads/<cell>.json`` names the configuration, the traffic
mix and the limits of the check; ``configs/<config>.json`` holds the
model, its flags (every one passed to the program's parser, which
refuses one it does not know), its control a traffic kind, and the
dataset; ``traffic/<mix>.json`` holds the mix's parameters and its
``kind``, whose code is ``traffic/<kind>.py``; every
``metrics/<name>.py`` is a reader of one per-layer metric.  A new cell,
configuration, mix or metric is a new file.

The program under test is ``textgcn_tpu_torch``, built as its CLI builds
it (``cli._run``: the health check, ``load_interactions`` through the
registry's loader, the model class, ``Trainer``), with the tables drawn
by the benchmark on the device from the seed.
"""

from __future__ import annotations

import contextlib
import gc
import glob
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from . import graphgen, isolation, work
from .tracing import WINDOW, Trace

ROOT = os.path.dirname(os.path.abspath(__file__))
MODES = (None, 'control', 'unchanged', 'half_batch', 'answer_altered',
         'candidates_all', 'candidates_fixed', 'positives_fixed')
APPROX_ENV = 'TEXTGCN_TPU_APPROX_TOPK'
HARNESS_FLAGS = ('model', 'data', 'seed', 'no_save', 'uid')


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    why: str
    chips: int

    @classmethod
    def load(cls, name: str, root: str = ROOT,
             overrides: dict | None = None) -> 'Cell':
        """The cell ``name`` from its files; ``overrides`` replace keys of
        the configuration's ``flags`` and ``dataset`` and of the traffic
        (the CPU tests' small sizes)."""
        def read(*parts):
            with open(os.path.join(root, *parts)) as f:
                return json.load(f)
        w = read('workloads', f'{name}.json')
        config = read('configs', f'{w["config"]}.json')
        traffic = read('traffic', f'{w["traffic"]}.json')
        for key, value in (overrides or {}).items():
            for part in (config['flags'], config['dataset'], traffic):
                if key in part:
                    part[key] = value
        return cls(name, config, traffic, w.get('limits', {}), w['why'],
                   w['chips'])


@dataclass
class Readings:
    """What the per-layer readers read (``metrics/<name>.py``)."""
    kind: str
    shape: work.Shape
    window_s: float
    count: int                  # steps or requests the window completed
    host_s: list[float]         # per step (train) or request (serve)
    work_s: float               # least seconds of the window's work
    load_s: float
    trace: Trace | None = None
    traced_count: int = 0
    traced_keep: float = 1.0


class Ctx:
    """The run's state: the cell, the seed, the device, the generated
    pairs, the program's objects (freed before the check) and the
    benchmark's own inputs."""

    def __init__(self, cell: Cell, seed: int, device: torch.device,
                 mode: str | None):
        self.cell, self.seed, self.device, self.mode = cell, seed, device, mode
        self.timings: dict[str, float] = {}
        self.inter = None
        self.folder = None
        self.cfg = self.data = self.model = self.trainer = None
        self.settings: dict = {}
        self.tables0: tuple[torch.Tensor, torch.Tensor] | None = None
        self.program_ids: tuple[list, list] | None = None

    def shape(self) -> work.Shape:
        f = self.settings
        return work.Shape(self.n_users, self.n_items, self.n_edges,
                          f['emb_size'], f['n_layers'],
                          float(np.float32(1.0 - f['dropout'])))

    def sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def argv(self) -> list[str]:
        return ['--model', self.cell.config['model'], '--data', self.folder,
                '--seed', str(self.seed), '--no_save', '--uid', 'portbench',
                *flag_argv(self.cell.config['flags'])]

    def parse(self):
        """The program's configuration from the command line ``argv``
        builds; ``settings`` keeps it as a dict for the check, which runs
        once the program's objects are freed."""
        from textgcn_tpu_torch.config import parse_args
        argv = self.argv()
        try:
            self.cfg = parse_args(argv)
        except SystemExit as e:     # argparse refuses an unknown flag so
            raise ValueError(
                f'the program refuses the flags of configuration '
                f'{self.cell.config["name"]}: {argv}') from e
        self.settings = dict(vars(self.cfg))
        return self.cfg

    def build(self):
        """The program as ``cli._run`` builds it, the benchmark's tables
        loaded into it."""
        from textgcn_tpu_torch.cli import device_healthcheck
        from textgcn_tpu_torch.registry import get_class
        from textgcn_tpu_torch.train.trainer import Trainer
        mark = time.perf_counter()

        def lap(name):
            nonlocal mark
            now = time.perf_counter()
            self.timings[name] = now - mark
            mark = now
        cfg = self.cfg
        loader, model_cls = get_class(cfg.model)
        device_healthcheck(device=self.device)
        lap('health_s')
        data = self.data = loader(cfg)
        lap('load_s')
        self.n_users, self.n_items = data.n_users, data.n_items
        self.n_edges = data.graph.n_edges
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        model = self.model = model_cls(cfg, data, device=self.device,
                                       generator=gen)
        self.sync()
        lap('model_s')
        d = cfg.emb_size
        tables = (0.1 * torch.randn((data.n_users, d), generator=gen,
                                    device=self.device),
                  0.1 * torch.randn((data.n_items, d), generator=gen,
                                    device=self.device))
        model.load_params({'user_emb': tables[0], 'item_emb': tables[1]})
        self.tables0 = tuple(t.cpu() for t in tables)
        self.program_ids = ([data.user_id_map[k] for k in range(data.n_users)],
                            [data.item_id_map[k] for k in range(data.n_items)])
        self.trainer = Trainer(cfg, model, data)
        lap('tables_s')

    def free_program(self):
        self.cfg = self.data = self.model = self.trainer = None
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()


def flag_argv(flags: dict) -> list[str]:
    """A configuration's ``flags`` as the program's command line, every
    key of them: a key of one letter is ``-k``, any other ``--key``; True
    is a bare switch and False leaves it out; a list gives its items.
    The harness sets the flags of ``HARNESS_FLAGS`` itself."""
    argv = []
    for key, value in flags.items():
        if key in HARNESS_FLAGS:
            raise ValueError(f'flag {key!r} is the harness\'s own')
        opt = f'-{key}' if len(key) == 1 else f'--{key}'
        if value is True:
            argv.append(opt)
        elif value is False:
            continue
        elif isinstance(value, list):
            argv += [opt, *(str(v) for v in value)]
        else:
            argv += [opt, str(value)]
    return argv


def id_map_bad(ctx: Ctx, ref_graph) -> int:
    """Rows whose external id in the program is not the one the
    reference numbers them by."""
    users, items = ctx.program_ids
    want_u = np.full(ref_graph.n_users, -1, np.int64)
    want_u[ref_graph.user_of_generated[ref_graph.user_of_generated >= 0]] = \
        np.nonzero(ref_graph.user_of_generated >= 0)[0]
    want_i = np.full(ref_graph.n_items, -1, np.int64)
    want_i[ref_graph.item_of_generated[ref_graph.item_of_generated >= 0]] = \
        np.nonzero(ref_graph.item_of_generated >= 0)[0]
    if (len(users), len(items)) != (len(want_u), len(want_i)):
        return abs(len(users) - len(want_u)) + abs(len(items) - len(want_i))
    bad = sum(u != f'u{g:0{graphgen.ID_DIGITS}d}' for u, g in
              zip(users, want_u.tolist()))
    bad += sum(i != f'i{g:0{graphgen.ID_DIGITS}d}' for i, g in
               zip(items, want_i.tolist()))
    return int(bad)


def control(cell: Cell) -> dict:
    """The configuration's control for the cell's traffic kind: ``env``,
    the program's environment for its own lower-precision path, or what
    the traffic's code puts in the program's place
    (``reference_scores``)."""
    c = cell.config.get('control', {}).get(cell.traffic['kind'])
    if c is None:
        raise ValueError(f'configuration {cell.config["name"]} states no '
                         f'control for {cell.traffic["kind"]}')
    return c


def traffic_code(kind: str):
    return importlib.import_module(f'portbench.traffic.{kind}')


def metric_readers(root: str = ROOT) -> dict:
    """``{name: module}`` of every ``metrics/<name>.py``."""
    out = {}
    for path in sorted(glob.glob(os.path.join(root, 'metrics', '*.py'))):
        name = os.path.basename(path)[:-3]
        if name.startswith('_'):
            continue
        spec = importlib.util.spec_from_file_location(
            f'portbench_metric_{name.replace(".", "_").replace("-", "_")}',
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod
    return out


def device_info(device: torch.device) -> dict:
    if device.type != 'cuda':
        return {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
                'memory_peak_bytes': 0}
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(device),
            'count': 1,
            'memory_peak_bytes': int(torch.cuda.max_memory_allocated(device))}


def power_line() -> str:
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit,clocks.max.sm',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f'nvidia-smi: {e}'


def run(name: str, seed: int, seconds: float, trace: bool, *,
        device: str | torch.device = 'cuda', mode: str | None = None,
        root: str = ROOT, overrides: dict | None = None,
        t_start: float | None = None, cache_dir: str = graphgen.CACHE_DIR,
        ) -> dict:
    """One run; returns the result line as a dict (``checks`` last).

    ``mode``: None for the program as configured; ``control`` for the
    lower-precision control; a fault's name to plant it (``faults.py``).
    """
    t_start = time.perf_counter() if t_start is None else t_start
    if mode not in MODES:
        raise ValueError(f'mode {mode!r}: one of {MODES}')
    cell = Cell.load(name, root, overrides)
    device = torch.device(device)
    if device.type == 'cuda':
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    ctx = Ctx(cell, seed, device, mode)
    kind = traffic_code(cell.traffic['kind'])
    phases = {'start': time.perf_counter() - t_start}

    folder, inter, gen_s = graphgen.materialise(cell.config['dataset'],
                                                cache_dir)
    ctx.folder, ctx.inter = folder, inter
    phases['data'] = time.perf_counter() - t_start
    stats = graphgen.degree_stats(inter)
    print('graph: ' + json.dumps(stats), flush=True)

    cfg = ctx.parse()
    env = {}
    if cfg.approx_topk:
        env[APPROX_ENV] = str(cfg.approx_topk)      # as cli.main does
    if mode == 'control':
        env.update(control(cell).get('env', {}))
    saved = {k: os.environ.get(k) for k in env}
    try:
        os.environ.update(env)
        ctx.build()
        phases['build'] = time.perf_counter() - t_start
        if mode not in (None, 'control'):
            from . import faults
            faults.plant(ctx, mode)
        state = kind.setup(ctx)
        gen_s += state.gen_s
        ctx.sync()
        setup_s = time.perf_counter() - t_start - gen_s
        phases['setup'] = time.perf_counter() - t_start
        isolation.require_clean('after set-up')

        win = kind.window(ctx, state, seconds)
        shape = ctx.shape()
        readings = Readings(cell.traffic['kind'], shape, win['window_s'],
                            win['count'], win['host_s'], win['work_s'],
                            ctx.timings['load_s'])
        if trace:
            tr, n, keep = kind.traced(ctx, state)
            readings.trace, readings.traced_count = tr, n
            readings.traced_keep = keep
        dev = device_info(device)
        isolation.require_clean('after the window')
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    ctx.free_program()
    checks = kind.check(ctx, state)
    limits = cell.limits
    compared = {k: {'value': v, 'limit': limits.get(k)}
                for k, v in checks.items()}
    correct = bool(compared) and all(
        c['limit'] is not None and not math.isnan(c['value'])
        and c['value'] <= c['limit'] for c in compared.values())
    if win['failed']:
        correct = False

    e2e = kind.end_to_end(ctx, state, win, setup_s)
    log(f'gen_s={gen_s:.3f} (not in setup_s) phases (s from start): '
        + ' '.join(f'{k}={v:.3f}' for k, v in phases.items()) + '; build: '
        + ' '.join(f'{k}={v:.3f}' for k, v in ctx.timings.items()))
    log('end_to_end: ' + json.dumps(e2e))
    if device.type == 'cuda':
        log('card: ' + power_line())
    if trace:
        per_layer = {}
        for mname, mod in metric_readers(root).items():
            value = mod.read(readings)
            if value is not None:
                per_layer[mname] = {'value': value, 'unit': mod.UNIT}
        metrics = per_layer
        dev['busy_s'] = readings.trace.busy_s
        dev['window_s'] = readings.trace.window_s
    else:
        metrics = e2e
    result = {'correct': correct, 'attempted': win['count'],
              'failed': win['failed'], 'metrics': metrics, 'device': dev}
    if trace:
        result['breakdown'] = readings.trace.breakdown()
    result['checks'] = compared
    for k, c in compared.items():
        log(f'check {k} = {c["value"]!r} limit {c["limit"]!r}')
    return result


def window_range():
    """The ``record_function`` range the trace reader takes as its
    window."""
    return torch.profiler.record_function(WINDOW)


def activities(ctx: Ctx) -> list:
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if ctx.device.type == 'cuda':
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def patched(obj, name: str, fn):
    """``obj.name`` replaced by ``fn`` on the instance for the block, then
    restored to what the instance had."""
    had = name in vars(obj)
    before = vars(obj).get(name)
    setattr(obj, name, fn)
    try:
        yield
    finally:
        if had:
            setattr(obj, name, before)
        else:
            delattr(obj, name)


def ranged(obj, name: str):
    """``obj.name`` run inside a ``record_function`` range of its name,
    for the block."""
    inner = getattr(obj, name)

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return inner(*args, **kwargs)
    return patched(obj, name, wrapped)
