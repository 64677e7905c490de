"""The JAX package's Orbax checkpoints read by the port
(``train/orbax_reader.py``, ``data/ocdbt.py``, ``zstd.py``) without orbax
or tensorstore, on the CPU, against orbax itself.

The JAX side runs in module fixtures: its CLI trains ``lgcn``, ``gat
--aggr mean`` and ``ltr_linear --load_base --freeze`` with
``--ckpt_backend orbax`` on a copy of ``data/dummy`` in this process (one
device); a subprocess with 4 virtual CPU devices (the XLA flag must come
before JAX starts) saves row-sharded arrays with and without OCDBT and
trains ``lgcn --mesh 2x2``; two processes run the JAX package's own
``tests/helpers/multihost_worker.py`` unchanged, whose cooperative saves
are written by 2 processes x 2 devices.  Then:

* every ``.orbax`` directory the JAX CLI wrote reads through
  ``DistCheckpointer.load`` / ``load_resume`` as ``OrbaxCheckpointer.load``
  / ``load_resume`` returns it, bit for bit (dtype, shape, tree, strings,
  scalars); the 4-device and 2-process saves and a tree of every dtype
  read as orbax restores them;
* the port's ``--ckpt_backend orbax --load RUN --no_train --predict`` of
  each JAX run gives the JAX package's ``--load`` metrics (1e-6) and is
  bit-equal to the port's load of the same params as a pickle; the same
  for the 4-device run and for the committed fixture runs
  (``tests/fixtures/jax_runs``, written by
  ``tests/helpers/make_jax_runs.py``: ``lgcn`` saved by 2 processes x 2
  devices, ``gat``), whose ``best.orbax`` also reads as orbax restores it;
* ``chip_smoke.write_orbax_dir``'s directory reads in orbax itself;
* ``--resume`` of a JAX run is refused by name, and so are a zarr v3
  array, filters, another compressor, dtype or order, a corrupt OCDBT
  file and an OCDBT version, compression or manifest kind that is not
  known; a missing chunk reads as the fill value.
"""

import contextlib
import json
import logging
import os
import pickle
import shutil
import socket
import subprocess
import sys

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest

from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from textgcn_tpu_torch import config as tconfig
from textgcn_tpu_torch import zstd
from textgcn_tpu_torch.train import checkpoint as tck
from textgcn_tpu_torch.train import orbax_reader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, 'tests', 'fixtures', 'jax_runs')
WORKER = os.path.join(REPO, 'tests', 'helpers', 'multihost_worker.py')
D = 16
COMMON = ['--data', 'dummy', '-k', '3', '5', '--batch_size', '16',
          '--quiet']
FLAGS = {'lgcn': ['--model', 'lgcn'],
         'gat': ['--model', 'gat', '--aggr', 'mean'],
         'ltr_linear': ['--model', 'ltr_linear']}
ORBAX_DIRS = ('latest_checkpoint.orbax', 'best.orbax', 'resume_state.orbax')

FOUR_DEVICES = '''
import os, sys
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'
os.environ['TEXTGCN_TPU_PLATFORM'] = 'cpu'
import jax
jax.config.update('jax_platforms', 'cpu')
import numpy as np
import orbax.checkpoint as ocp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
repo, out, work = sys.argv[1:4]
sys.path.insert(0, repo)
assert len(jax.devices()) == 4
mesh = Mesh(np.array(jax.devices()), ('x',))
rng = np.random.default_rng(5)
arrays = {'user_emb': rng.standard_normal((40, 64)).astype(np.float32),
          'item_emb': rng.standard_normal((24, 64)).astype(np.float32),
          'counts': np.arange(12, dtype=np.int32).reshape(4, 3)}
np.savez(os.path.join(out, 'arrays.npz'), **arrays)
tree = {'params': {k: jax.device_put(v, NamedSharding(mesh, P('x')))
                   for k, v in arrays.items()},
        'meta': {'epoch': 7, 'model': 'lgcn'}}
ocp.PyTreeCheckpointer().save(os.path.join(out, 'ocdbt.orbax'), tree)
ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=False)).save(
    os.path.join(out, 'files.orbax'), tree)
os.chdir(work)
from textgcn_tpu.cli import main
main(['--model', 'lgcn', '--data', 'dummy', '-k', '3', '5',
      '--batch_size', '16', '--quiet', '--emb_size', '16', '--epochs', '4',
      '--evaluate_every', '2', '--mesh', '2x2', '--ckpt_backend', 'orbax',
      '--uid', 'mesh4'])
print('FOUR_DEVICES_OK')
'''


@pytest.fixture(autouse=True)
def _close_port_logger():
    yield
    logger = logging.getLogger(tconfig.LOGGER_NAME)
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()


@contextlib.contextmanager
def _cpu_run_in(path):
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(path)
        mp.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
        mp.setenv('TEXTGCN_TPU_TEXT_ENCODER', 'stub')
        yield


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _clean_env():
    return {k: v for k, v in os.environ.items()
            if k not in ('XLA_FLAGS', 'JAX_PLATFORMS')}


def _numpy_restore(path):
    """orbax's restore of ``path`` with every array as numpy (a save by
    other devices or processes restores here only so)."""
    ck = ocp.PyTreeCheckpointer()
    meta = ck.metadata(path)
    tree = getattr(meta, 'item_metadata', meta)
    tree = getattr(tree, 'tree', tree)
    args = jax.tree.map(
        lambda m: ocp.RestoreArgs(restore_type=np.ndarray)
        if getattr(m, 'shape', None) is not None else ocp.RestoreArgs(),
        tree)
    return ck.restore(path, restore_args=args)


def _same_tree(got, want, path='', scalars_as_arrays=False):
    """Equal trees: dicts and lists alike, arrays of one dtype and shape
    and the same bytes, strings and Python scalars of one type."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _same_tree(got[k], want[k], f'{path}/{k}', scalars_as_arrays)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, f'{path}/{i}', scalars_as_arrays)
    elif isinstance(want, (np.ndarray, jax.Array)) and not (
            scalars_as_arrays and np.ndim(want) == 0
            and not isinstance(got, np.ndarray)):
        want = np.asarray(want)
        assert isinstance(got, np.ndarray), (path, type(got))
        if str(want.dtype) == 'bfloat16':
            assert got.dtype == np.float32, path
            np.testing.assert_array_equal(got, want.astype(np.float32))
        else:
            assert (got.dtype, got.shape) == (want.dtype, want.shape), path
            assert got.tobytes() == want.tobytes(), path
    elif scalars_as_arrays and isinstance(want, np.ndarray):
        assert got == want.item() and type(got) is type(want.item()), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


@pytest.fixture(scope='module')
def work(tmp_path_factory, dummy_dir):
    root = tmp_path_factory.mktemp('orbax')
    shutil.copytree(dummy_dir, root / 'dummy')
    return root


@pytest.fixture(scope='module')
def spawned(work, tmp_path_factory):
    """The 4-device subprocess and the two worker processes, started
    together; ``{'four': dir, 'two': dir}`` once all have ended."""
    four = tmp_path_factory.mktemp('four')
    two = tmp_path_factory.mktemp('two')
    work4 = tmp_path_factory.mktemp('work4')
    shutil.copytree(work / 'dummy', work4 / 'dummy')
    env = dict(_clean_env(), TEXTGCN_TPU_TEXT_ENCODER='stub')
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, '-c', FOUR_DEVICES, REPO, str(four), str(work4)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)]
    procs += [subprocess.Popen(
        [sys.executable, WORKER, str(p), str(port), str(two), '2', '2'],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for p in range(2)]
    yield procs, {'four': four, 'two': two,
                  'mesh4': work4 / 'runs' / 'dummy' / 'mesh4'}
    for p in procs:
        if p.poll() is None:
            p.kill()


@pytest.fixture(scope='module')
def saved(spawned):
    procs, dirs = spawned
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, out[-4000:]
        outs.append(out)
    assert 'FOUR_DEVICES_OK' in outs[0]
    assert all('MULTIHOST_OK' in out for out in outs[1:])
    return dirs


@pytest.fixture(scope='module')
def jax_runs(work, spawned):
    """``{model: run dir}`` of the JAX CLI with ``--ckpt_backend orbax``
    (the spawned saves run meanwhile)."""
    from textgcn_tpu.cli import main as jax_main
    out = {}
    with _cpu_run_in(work):
        for model in ('lgcn', 'gat'):
            jax_main([*FLAGS[model], *COMMON, '--emb_size', str(D),
                      '--epochs', '4', '--evaluate_every', '2',
                      '--ckpt_backend', 'orbax', '--uid', f'jax-{model}'])
            out[model] = work / 'runs' / 'dummy' / f'jax-{model}'
        jax_main([*FLAGS['ltr_linear'], *COMMON, '--emb_size', str(D),
                  '--load_base', str(out['lgcn']), '--freeze', '--epochs',
                  '2', '--evaluate_every', '1', '--ckpt_backend', 'orbax',
                  '--uid', 'jax-ltr_linear'])
        out['ltr_linear'] = work / 'runs' / 'dummy' / 'jax-ltr_linear'
    return out


def _pickle_twin(state: dict, path):
    """``best.pkl`` of the params, epoch and model of a load."""
    os.makedirs(path, exist_ok=True)
    params = jax.tree.map(np.asarray, state['params'])
    with open(os.path.join(path, 'best.pkl'), 'wb') as f:
        pickle.dump({**{k: v for k, v in state.items() if k != 'params'},
                     'params': params}, f)
    return str(path)


def _serve(work, flags, run, uid, *extra, d=D):
    """The JAX package's metrics of ``--load`` (``jax`` in ``uid``) or the
    port's trainer and ``predictions.tsv`` bytes."""
    argv = [*flags, *COMMON, '--emb_size', str(d), '--load', str(run),
            '--no_train', '--uid', uid, *extra]
    with _cpu_run_in(work):
        if uid.startswith('jax'):
            from textgcn_tpu.cli import main as jax_main
            return jax_main(argv).evaluate()
        from textgcn_tpu_torch.cli import main as port_main
        trainer = port_main([*argv, '--predict'])
        with open(work / trainer.cfg.save_path / 'predictions.tsv',
                  'rb') as f:
            return trainer, f.read()


def _assert_metrics(got, want):
    for name, values in want.items():
        np.testing.assert_allclose(got[name], values, rtol=0, atol=1e-6,
                                   err_msg=name)


def _same_serves(a, b):
    (ta, pa), (tb, pb) = a, b
    assert pa == pb
    assert ta.last_metrics == tb.last_metrics
    for name in ('user_emb', 'item_emb'):
        assert np.array_equal(getattr(ta.model, name).detach().numpy(),
                              getattr(tb.model, name).detach().numpy())


@pytest.mark.parametrize('model', list(FLAGS))
def test_reader_equals_orbax_load(model, jax_runs):
    from textgcn_tpu.train.checkpoint import OrbaxCheckpointer
    run = jax_runs[model]
    for name in ORBAX_DIRS:
        assert (run / name).is_dir()
    for path in (run, run / 'latest_checkpoint.orbax'):
        _same_tree(tck.DistCheckpointer().load(str(path)),
                   OrbaxCheckpointer().load(str(path)))
    _same_tree(tck.DistCheckpointer().load_resume(str(run)),
               OrbaxCheckpointer().load_resume(str(run)))


@pytest.mark.parametrize('model', list(FLAGS))
def test_cli_serves_jax_orbax_runs(model, work, jax_runs, tmp_path):
    from textgcn_tpu.train.checkpoint import OrbaxCheckpointer
    run = jax_runs[model]
    extra = ['--ckpt_backend', 'orbax']
    want = _serve(work, FLAGS[model], run, f'jax-load-{model}', *extra)
    port = _serve(work, FLAGS[model], run, f'port-{model}', *extra)
    _assert_metrics(port[0].last_metrics, want)
    twin = _pickle_twin(OrbaxCheckpointer().load(str(run)),
                        tmp_path / 'twin')
    _same_serves(port, _serve(work, FLAGS[model], twin, f'pkl-{model}'))


def test_every_dtype_and_node_reads_as_orbax_restores(tmp_path):
    import ml_dtypes
    rng = np.random.default_rng(1)
    tree = {'f4': rng.standard_normal((5, 3)).astype(np.float32),
            'f8': rng.standard_normal(4),
            'f2': rng.standard_normal((2, 2)).astype(np.float16),
            'i4': np.arange(-3, 3, dtype=np.int32),
            'i8': np.arange(6, dtype=np.int64).reshape(3, 2),
            'u4': np.array([0, 7, 2**32 - 1], np.uint32),
            'b1': np.array([True, False, True]),
            'bf16': rng.standard_normal(6).astype(ml_dtypes.bfloat16),
            'scalars': [3, 2.5, True, 'text'],
            'empty': {'d': {}, 'l': [], 'n': None},
            'nested': [{'w': np.ones((2, 2), np.float32)}, [np.zeros(1)]]}
    path = str(tmp_path / 'all.orbax')
    ocp.PyTreeCheckpointer().save(path, tree)
    _same_tree(orbax_reader.restore(path),
               ocp.PyTreeCheckpointer().restore(path))


@pytest.mark.parametrize('layout', ['ocdbt', 'files'])
def test_four_device_saves_read_as_saved(layout, saved):
    path = saved['four'] / f'{layout}.orbax'
    got = orbax_reader.restore(str(path))
    with np.load(saved['four'] / 'arrays.npz') as z:
        for name in z.files:
            assert got['params'][name].dtype == z[name].dtype
            np.testing.assert_array_equal(got['params'][name], z[name])
    assert got['meta'] == {'epoch': 7, 'model': 'lgcn'}
    _same_tree(got, _numpy_restore(str(path)), scalars_as_arrays=True)
    if layout == 'ocdbt':
        chunks = [k for k in orbax_reader._Ocdbt(str(path)).store.keys(
            'params.user_emb/') if not k.endswith('.zarray')]
        assert chunks == [f'params.user_emb/{i}.0' for i in range(4)]


@pytest.mark.parametrize('name', ['ckpt/latest_checkpoint.orbax',
                                  *(f'mesh_run/{d}' for d in ORBAX_DIRS)])
def test_two_process_saves_read_as_orbax_restores(name, saved):
    path = saved['two'] / name
    assert (path / 'ocdbt.process_1').is_dir()
    _same_tree(orbax_reader.restore(str(path)), _numpy_restore(str(path)),
               scalars_as_arrays=True)


def test_cli_serves_the_four_device_run(work, saved, tmp_path):
    run = saved['mesh4']
    twin = _pickle_twin(tck.DistCheckpointer().load(str(run)),
                        tmp_path / 'twin')
    np_twin = _numpy_restore(str(run / 'best.orbax'))
    with open(os.path.join(twin, 'best.pkl'), 'rb') as f:
        _same_tree(pickle.load(f)['params'], np_twin['params'])
    want = _serve(work, FLAGS['lgcn'], twin, 'jax-load-mesh4')
    port = _serve(work, FLAGS['lgcn'], run, 'port-mesh4', '--ckpt_backend',
                  'orbax')
    _assert_metrics(port[0].last_metrics, want)
    _same_serves(port, _serve(work, FLAGS['lgcn'], twin, 'pkl-mesh4'))


@pytest.mark.parametrize('model', ['lgcn', 'gat'])
def test_committed_fixture_reads_both_ways_and_serves(model, work):
    run = os.path.join(FIXTURES, model)
    best = os.path.join(run, 'best.orbax')
    got = orbax_reader.restore(best)
    _same_tree(got, _numpy_restore(best), scalars_as_arrays=True)
    flags = FLAGS[model]
    if model == 'lgcn':        # saved by 2 processes x 2 devices
        assert os.path.isdir(os.path.join(best, 'ocdbt.process_1'))
        with open(os.path.join(run, 'best.pkl'), 'rb') as f:
            twin = pickle.load(f)
        _same_tree(got['params'], twin['params'])
        want = _serve(work, flags, os.path.join(run, 'best.pkl'),
                      'jax-fixture-lgcn', d=64)
    else:
        want = _serve(work, flags, run, 'jax-fixture-gat', '--ckpt_backend',
                      'orbax', d=64)
    port = _serve(work, flags, run, f'port-fixture-{model}',
                  '--ckpt_backend', 'orbax', d=64)
    _assert_metrics(port[0].last_metrics, want)
    if model == 'lgcn':
        _same_serves(port, _serve(work, flags, os.path.join(run, 'best.pkl'),
                                  'pkl-fixture-lgcn', d=64))


def test_write_orbax_dir_reads_in_orbax(tmp_path):
    sys.path.insert(0, REPO)
    import chip_smoke
    rng = np.random.default_rng(3)
    state = {'params': {
        'user_emb': rng.standard_normal((4096, 64)).astype(np.float32),
        'item_emb': rng.standard_normal((1000, 64)).astype(np.float32),
        'convs': [{'w': rng.standard_normal((64, 64)).astype(np.float32),
                   'b': np.zeros(64, np.float32)} for _ in range(2)]},
        'epoch': 4, 'model': 'gat'}
    path = str(tmp_path / 'best.orbax')
    chip_smoke.write_orbax_dir(path, state)
    want = {'params': state['params'], 'meta': {'epoch': 4, 'model': 'gat'}}
    _same_tree(orbax_reader.restore(path), want)
    _same_tree(orbax_reader.restore(path), _numpy_restore(path),
               scalars_as_arrays=True)
    import tensorstore as ts
    kv = ts.KvStore.open({'driver': 'ocdbt',
                          'base': f'file://{path}/'}).result()
    keys = sorted(k.decode() for k in kv.list().result())
    assert keys == orbax_reader._Ocdbt(path).store.keys()
    assert 'params.user_emb/3.0' in keys


@pytest.mark.parametrize('backend', ['orbax', 'pickle'])
def test_resume_of_a_jax_run_is_refused(backend, work, jax_runs):
    from textgcn_tpu.cli import main as jax_main
    from textgcn_tpu_torch.cli import main as port_main
    run = jax_runs['lgcn']
    with _cpu_run_in(work):
        if backend == 'pickle':
            jax_main([*FLAGS['lgcn'], *COMMON, '--emb_size', str(D),
                      '--epochs', '2', '--evaluate_every', '2', '--uid',
                      'jax-lgcn-pickle'])
            run = work / 'runs' / 'dummy' / 'jax-lgcn-pickle'
        with pytest.raises(ValueError, match='RNG keys cannot be continued '
                           'in torch, so --resume of a JAX run is refused; '
                           '--load .* warm-starts from the same run'):
            port_main([*FLAGS['lgcn'], *COMMON, '--emb_size', str(D),
                       '--epochs', '4', '--evaluate_every', '2',
                       '--ckpt_backend', backend, '--resume', str(run),
                       '--uid', f'resume-{backend}'])


# --- refusals -----------------------------------------------------------------

def _files_copy(saved, tmp_path):
    path = tmp_path / 'files.orbax'
    shutil.copytree(saved['four'] / 'files.orbax', path)
    return path


def _edit_zarray(path, name, **changes):
    zarray = path / name / '.zarray'
    meta = json.loads(zarray.read_text())
    meta.update(changes)
    zarray.write_text(json.dumps(meta))


@pytest.mark.parametrize('edit,match', [
    (lambda p: (p / 'params.user_emb' / 'zarr.json').write_text('{}'),
     r'params\.user_emb is a zarr v3 array \(zarr\.json\)'),
    (lambda p: (p / '_METADATA').write_text(json.dumps(dict(
        json.loads((p / '_METADATA').read_text()), use_zarr3=True))),
     r'saved with zarr v3 \(use_zarr3\)'),
    (lambda p: _edit_zarray(p, 'params.user_emb',
                            filters=[{'id': 'delta', 'dtype': '<f4'}]),
     'has filters'),
    (lambda p: _edit_zarray(p, 'params.user_emb',
                            compressor={'id': 'blosc'}),
     "compressed with 'blosc': only zstd and none"),
    (lambda p: _edit_zarray(p, 'params.user_emb', dtype='>f4'),
     "has dtype '>f4'"),
    (lambda p: _edit_zarray(p, 'params.user_emb', zarr_format=3),
     'has zarr_format 3, only 2'),
    (lambda p: _edit_zarray(p, 'params.user_emb', order='F'),
     "has order 'F': only C order"),
], ids=['zarr_json', 'use_zarr3', 'filters', 'blosc', 'big_endian',
        'zarr_format', 'fortran_order'])
def test_a_zarr_array_it_does_not_know_is_refused(edit, match, saved,
                                                   tmp_path):
    path = _files_copy(saved, tmp_path)
    edit(path)
    with pytest.raises(ValueError, match=match):
        orbax_reader.restore(str(path))


@pytest.mark.parametrize('fill,want', [(None, 0.0), ('NaN', np.nan),
                                       (-1.5, -1.5)])
def test_a_missing_chunk_reads_as_the_fill_value(fill, want, saved,
                                                 tmp_path):
    path = _files_copy(saved, tmp_path)
    (path / 'params.user_emb' / '2.0').unlink()
    _edit_zarray(path, 'params.user_emb', fill_value=fill)
    got = orbax_reader.restore(str(path))['params']['user_emb']
    with np.load(saved['four'] / 'arrays.npz') as z:
        table = z['user_emb']
    rows = slice(20, 30)
    np.testing.assert_array_equal(got[:20], table[:20])
    np.testing.assert_array_equal(got[30:], table[30:])
    np.testing.assert_array_equal(got[rows], np.full_like(table[rows],
                                                          want))


def _rewrite(path, at: int, value: int):
    """Set byte ``at`` of an OCDBT file and its CRC-32C again."""
    raw = bytearray(path.read_bytes())
    raw[at] = value
    raw[-4:] = zstd.crc32c(bytes(raw[:-4])).to_bytes(4, 'little')
    path.write_bytes(bytes(raw))


def _written(tmp_path):
    """An OCDBT directory of ``chip_smoke.write_orbax_dir`` (manifests
    and nodes uncompressed, so a body byte can be edited)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    path = tmp_path / 'w.orbax'
    chip_smoke.write_orbax_dir(str(path), {'params': {
        'user_emb': np.ones((8, 4), np.float32),
        'item_emb': np.zeros((4, 4), np.float32)}, 'epoch': 1,
        'model': 'lgcn'})
    return path


@pytest.mark.parametrize('edit,match', [
    (lambda p: _rewrite(p / 'manifest.ocdbt', 12, 1),
     'OCDBT format version 1 is not supported'),
    (lambda p: _rewrite(p / 'manifest.ocdbt', 13, 2),
     r"OCDBT compression 2 is not supported \(only \{0: 'none', "
     r"1: 'zstd'\}\)"),
    (lambda p: _rewrite(p / 'manifest.ocdbt', 14 + 16, 1),
     r'manifest kind 1 \(numbered\) is not supported'),
    (lambda p: _rewrite(p / 'manifest.ocdbt', 0, 0x0D),
     r'magic 0x0ddb3a2a, expected 0x0cdb3a2a'),
    (lambda p: (p / 'manifest.ocdbt').write_bytes(
        (p / 'manifest.ocdbt').read_bytes()[:-1] + b'\x00'),
     'CRC-32C mismatch'),
    (lambda p: [_rewrite(n, 14, 1) for n in (
        p / 'ocdbt.process_0' / 'd').iterdir()
        if n.read_bytes()[:4] == b'\x0c\xdb\x20\xde'],
     'node of height 1 where 0 was expected'),
], ids=['version', 'compression', 'numbered', 'magic', 'crc', 'height'])
def test_an_ocdbt_store_it_does_not_know_is_refused(edit, match, tmp_path):
    path = _written(tmp_path)
    assert orbax_reader.restore(str(path))['meta']['epoch'] == 1
    edit(path)
    with pytest.raises(ValueError, match=match):
        tck.DistCheckpointer().load(str(path))
