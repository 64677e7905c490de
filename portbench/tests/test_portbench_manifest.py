"""``BENCHMARK.json`` against the files that hold each cell, configuration
and metric, the allowed characters, and a cell added by data alone."""

import json
import os
import re
import shutil

import pytest

from portbench import harness

REPO = os.path.dirname(harness.ROOT)
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


@pytest.fixture(scope='module')
def bench():
    with open(os.path.join(REPO, 'BENCHMARK.json')) as f:
        return json.load(f)


def test_names_units_and_lines(bench):
    names = []
    for c in bench['configs']:
        names.append(c['name'])
        assert all(NAME.match(k) for k in c['reduced'])
    for w in bench['workloads']:
        names.append(w['name'])
        assert NAME.match(w['config']) and NAME.match(w['traffic'])
    for m in bench['end_to_end'] + bench['per_layer']:
        names.append(m['name'])
        assert UNIT.match(m['unit']), m
        assert m['better'] in ('lower', 'higher')
    for n in names:
        assert NAME.match(n), n
    texts = [w['why'] for w in bench['workloads']]
    texts += [c['why'] for c in bench['configs']]
    texts += [c['source'] for c in bench['configs']]
    texts += [m['layer'] for m in bench['per_layer']] + bench['command']
    for t in texts:
        assert 1 <= len(t) <= 200 and '\n' not in t and '\t' not in t, t
    assert len(set(names)) == len(names)


def test_files_match_the_manifest(bench):
    for c in bench['configs']:
        with open(os.path.join(REPO, c['file'])) as f:
            conf = json.load(f)
        assert conf['name'] == c['name'] and conf['source'] == c['source']
        assert conf['reduced'] == c['reduced']
    readers = harness.metric_readers()
    for w in bench['workloads']:
        cell = harness.Cell.load(w['name'])
        with open(os.path.join(harness.ROOT, 'workloads',
                               f'{w["name"]}.json')) as f:
            raw = json.load(f)
        for k in ('name', 'config', 'traffic', 'chips', 'why'):
            assert raw[k] == w[k], (w['name'], k)
        assert cell.config['name'] == w['config']
        assert all(v is not None for v in cell.limits.values()), w['name']
    for m in bench['per_layer']:
        assert m['name'] in readers, m['name']
        assert readers[m['name']].UNIT == m['unit']
    assert sorted(readers) == sorted(m['name'] for m in bench['per_layer'])
    e2e = {m['name'] for m in bench['end_to_end']}
    assert all(m['moves'] in e2e for m in bench['per_layer'])


def test_end_to_end_units_are_what_a_run_prints(bench, tmp_path, small):
    units = {m['name']: m['unit'] for m in bench['end_to_end']}
    for w in bench['workloads']:
        r = harness.run(w['name'], 3, 0.2, False, device='cpu',
                        overrides=small, cache_dir=str(tmp_path))
        for name, v in r['metrics'].items():
            assert units[name] == v['unit']
        listed = {m['name'] for m in bench['end_to_end']
                  if w['name'] in m.get('workloads', [w['name']])}
        assert set(r['metrics']) == listed, w['name']


def test_traced_run_reports_its_per_layer_metrics(bench, tmp_path, small):
    """On the CPU the trace holds no device time, so the readers of the
    device leave their metrics out; the rest are there."""
    r = harness.run('adv-book.train', 3, 0.2, True, device='cpu',
                    overrides=small, cache_dir=str(tmp_path))
    assert {'train_host_ms_per_step', 'train_mfu', 'load_s'} \
        <= set(r['metrics'])
    assert set(r['breakdown']) == {'device_ops', 'idle_gaps'}
    assert 'busy_s' in r['device'] and r['device']['window_s'] > 0


def test_a_workload_file_adds_a_cell(tmp_path, small):
    root = tmp_path / 'bench'
    for sub in ('configs', 'workloads', 'traffic', 'metrics'):
        shutil.copytree(os.path.join(harness.ROOT, sub), root / sub)
    with open(root / 'workloads' / 'lgcn-book.train.json') as f:
        w = json.load(f)
    w['name'] = 'adv-book.serve'
    w['config'] = 'adv-amazon-book'
    w['traffic'] = 'serve-cohorts'
    w['limits'] = {'rank_gap': 1e-3, 'value_gap': 1e-3, 'answer_bad': 0,
                   'id_map_bad': 0}
    with open(root / 'workloads' / 'adv-book.serve.json', 'w') as f:
        json.dump(w, f)
    r = harness.run('adv-book.serve', 5, 0.2, False, device='cpu',
                    root=str(root), overrides=small,
                    cache_dir=str(tmp_path / 'cache'))
    assert r['correct'], r['checks']
    assert set(r['metrics']) == {'serve_users_per_s', 'serve_p95_ms',
                                 'setup_s'}


def test_flags_become_the_programs_command_line():
    argv = harness.flag_argv({'k': [20, 40], 'reshuffle': True,
                              'quiet': False, 'lr': 0.001})
    assert argv == ['-k', '20', '40', '--reshuffle', '--lr', '0.001']
    with pytest.raises(ValueError, match="harness's own"):
        harness.flag_argv({'seed': 3})


def copy_bench(tmp_path, config: dict):
    """The benchmark's data files with ``lgcn-book.train`` run on a
    configuration of its own, ``config`` over ``lgcn-amazon-book``'s."""
    root = tmp_path / 'bench'
    for sub in ('configs', 'workloads', 'traffic', 'metrics'):
        shutil.copytree(os.path.join(harness.ROOT, sub), root / sub)
    with open(root / 'configs' / 'lgcn-amazon-book.json') as f:
        c = json.load(f)
    c.update(config, name='lgcn-extra')
    with open(root / 'configs' / 'lgcn-extra.json', 'w') as f:
        json.dump(c, f)
    with open(root / 'workloads' / 'lgcn-book.train.json') as f:
        w = json.load(f)
    w.update(name='lgcn-extra.train', config='lgcn-extra')
    with open(root / 'workloads' / 'lgcn-extra.train.json', 'w') as f:
        json.dump(w, f)
    return str(root)


def test_a_configuration_file_passes_every_flag(tmp_path, small):
    """A flag the harness has never named reaches the program built from
    a configuration file alone."""
    import torch
    from portbench import graphgen
    flags = dict(json.load(open(os.path.join(
        harness.ROOT, 'configs', 'lgcn-amazon-book.json')))['flags'],
        refresh_every=4, reshuffle=True)
    root = copy_bench(tmp_path, {'flags': flags})
    cell = harness.Cell.load('lgcn-extra.train', root, small)
    ctx = harness.Ctx(cell, 5, torch.device('cpu'), None)
    ctx.folder, ctx.inter, _ = graphgen.materialise(
        cell.config['dataset'], str(tmp_path / 'cache'))
    ctx.parse()
    ctx.build()
    assert ctx.trainer.cfg.refresh_every == 4 and ctx.trainer.cfg.reshuffle
    assert ctx.settings['batch_size'] == small['batch_size']


def test_an_unknown_flag_or_a_missing_control_is_refused(tmp_path, small):
    flags = dict(json.load(open(os.path.join(
        harness.ROOT, 'configs', 'lgcn-amazon-book.json')))['flags'],
        no_such_flag=1)
    root = copy_bench(tmp_path, {'flags': flags})
    with pytest.raises(ValueError, match='refuses the flags'):
        harness.run('lgcn-extra.train', 5, 0.2, False, device='cpu',
                    root=root, overrides=small,
                    cache_dir=str(tmp_path / 'cache'))
    root = copy_bench(tmp_path / 'b', {'control': {}})
    with pytest.raises(ValueError, match='no control for train'):
        harness.run('lgcn-extra.train', 5, 0.2, False, device='cpu',
                    root=root, mode='control', overrides=small,
                    cache_dir=str(tmp_path / 'cache'))
