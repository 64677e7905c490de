"""The port's native interaction reader (``textgcn_tpu_torch/native.py``,
``csrc/graphbuild.cpp``) against its plain Python reader and the JAX
package's loader, on the CPU.

* A hypothesis property over generated TSV bytes: the native reader and
  the plain one give the same arrays and ids, or refuse with the same
  exception type and message.  The files hold Unicode ids, quoted fields
  with tabs, line breaks and doubled quotes, CRLF and lone CR line ends,
  blank lines, extra and reordered columns, duplicate rows, rows with a
  wrong field count, missing columns and bytes that are not UTF-8.
* ``load_interactions`` on ``data/dummy`` and on a synthetic set equals
  ``textgcn_tpu.data.core.load_interactions``, with either reader.
* Six processes that build the library at once into an empty directory
  all load one library; a broken compiler raises with its output and
  nothing falls back; ``TEXTGCN_TPU_NATIVE=0`` selects the plain reader.
"""

import csv
import importlib.util
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from textgcn_tpu_torch import native
from textgcn_tpu_torch.data import core

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DUMMY = os.path.join(REPO, 'data', 'dummy')


def _outcome(fn, path):
    try:
        u, i, users, items = fn(path)
    except Exception as e:  # noqa: BLE001 - the type is compared
        return type(e), str(e)
    assert u.dtype == i.dtype == np.int32
    return u.tolist(), i.tolist(), users, items


# --- the property -------------------------------------------------------------

ID_CHARS = st.sampled_from(list('ab_019') + ['é', 'ß', '中', '😀', 'Ω', ' ',
                                             '\t', '"', '\n', '\r', '\x00',
                                             ' ', '﻿'])
FIELD = st.text(ID_CHARS, max_size=5)
ENDS = st.sampled_from(['\n', '\r\n', '\r'])


def _render(field: str, quote: bool) -> str:
    return '"' + field.replace('"', '""') + '"' if quote else field


@st.composite
def tsv_files(draw):
    names = ['user_id', 'asin'] + draw(st.lists(
        st.sampled_from(['rating', 'time', 'review', 'asin', 'user']),
        max_size=2))
    names = draw(st.permutations(names))
    if draw(st.integers(0, 15)) == 0:
        names = [n for n in names if n != draw(st.sampled_from(
            ['user_id', 'asin']))] or ['x']
    ids = draw(st.lists(FIELD, min_size=1, max_size=6))
    n_rows = draw(st.integers(0, 12))
    rows = []
    for _ in range(n_rows):
        kind = draw(st.integers(0, 30))
        if kind == 0:
            rows.append(None)          # a blank line
            continue
        width = len(names) + (draw(st.sampled_from([-1, 1]))
                              if kind == 1 else 0)
        fields = [draw(st.sampled_from(ids)) if draw(st.booleans())
                  else draw(FIELD) for _ in range(max(width, 0))]
        rows.append(fields)
    if rows and draw(st.booleans()):
        rows.append(draw(st.sampled_from(rows)))    # a duplicate
    end = draw(ENDS)
    quote_all = draw(st.booleans())
    lines = ['\t'.join(_render(n, quote_all) for n in names)]
    for r in rows:
        lines.append('' if r is None else '\t'.join(
            _render(f, quote_all or any(c in f for c in '\t"\n\r')
                    or draw(st.integers(0, 5)) == 0) for f in r))
    text = end.join(lines) + (end if draw(st.booleans()) else '')
    raw = text.encode('utf-8')
    if draw(st.integers(0, 10)) == 0:
        at = draw(st.integers(0, len(raw)))
        bad = draw(st.sampled_from([b'\xff', b'\xc3', b'\xed\xa0\x80',
                                    b'\xe0\x80\x80', b'\xf4\x90\x80\x80',
                                    b'\xc0\xaf']))
        raw = raw[:at] + bad + raw[at:]
    if draw(st.integers(0, 10)) == 0:
        # an unquoted field that holds a quote, and text after a close quote
        raw += b'x"y\t"z"w' + end.encode()
    return raw


@settings(max_examples=300, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture,
                                 HealthCheck.too_slow])
@given(raw=tsv_files())
def test_native_reader_equals_the_python_reader(tmp_path, raw):
    path = str(tmp_path / 'train.tsv')
    with open(path, 'wb') as f:
        f.write(raw)
    assert _outcome(native.read_pairs, path) == _outcome(
        core._python_pairs, path), raw


@pytest.mark.parametrize('raw, match', [
    (b'user_id\tasin\nu\ta\nu\ta\tb\n', r':3: expected 2 fields, got 3'),
    (b'user_id\tasin\n\n\nu\n', r':4: expected 2 fields, got 1'),
    (b'user_id\tasin\n"u\n\nv"\ta\nw\n', r':3: expected 2 fields, got 1'),
    (b'user\tasin\nu\ta\n', r":1: the header needs user_id and asin "
                            r"columns, got \['user', 'asin'\]"),
    (b'user_id\tasin\nu\ta\n\xe9\tb\n', r':3: the bytes are not UTF-8'),
    (b'', r':1: no header'),
])
def test_each_refusal_names_the_path_and_the_line(tmp_path, raw, match):
    path = str(tmp_path / 'test.tsv')
    with open(path, 'wb') as f:
        f.write(raw)
    for fn in (native.read_pairs, core._python_pairs):
        with pytest.raises(ValueError, match=match) as e:
            fn(path)
        assert str(e.value).startswith(path)


def test_a_field_over_the_limit_is_refused_alike(tmp_path):
    path = str(tmp_path / 'train.tsv')
    with open(path, 'w', encoding='utf-8') as f:
        f.write('user_id\tasin\nu\ta\nu\t' + 'é' * 40 + '\n')
    old = csv.field_size_limit(40)
    try:
        assert _outcome(native.read_pairs, path)[3] == ['a', 'é' * 40]
        csv.field_size_limit(39)
        want = _outcome(core._python_pairs, path)
        assert want[0] is ValueError and ':3: field larger' in want[1]
        assert _outcome(native.read_pairs, path) == want
        # in the header, the first record
        csv.field_size_limit(6)
        want = _outcome(core._python_pairs, path)
        assert want[0] is ValueError and ':1: field larger' in want[1]
        assert _outcome(native.read_pairs, path) == want
    finally:
        csv.field_size_limit(old)


# --- load_interactions against the JAX package ---------------------------------

@pytest.fixture(scope='module')
def synthetic(tmp_path_factory):
    from textgcn_tpu_torch.tools.make_synthetic import generate
    out = str(tmp_path_factory.mktemp('syn') / 'syn')
    generate(out, n_users=300, n_items=120, seed=0, sharp=True, cold=0.2)
    return out


@pytest.mark.parametrize('reader', ['native', 'python'])
@pytest.mark.parametrize('which', ['dummy', 'synthetic'])
def test_load_interactions_equals_the_jax_loader(monkeypatch, synthetic,
                                                 which, reader):
    from textgcn_tpu.data.core import load_interactions as jax_load
    data_dir = DUMMY if which == 'dummy' else synthetic
    # the JAX package's pandas path: its own native library would be
    # built in place by every test worker at once
    monkeypatch.setenv(native.ENV, '0')
    want = jax_load(data_dir)
    monkeypatch.setenv(native.ENV, '1' if reader == 'native' else '0')
    got = core.load_interactions(data_dir)
    for name in ('n_users', 'n_items', 'n_train', 'n_test', 'user_id_map',
                 'item_id_map', 'true_test'):
        assert getattr(got, name) == getattr(want, name), name
    for name in ('pos_padded', 'pos_degree', 'test_users'):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)))
    for name in ('edge_user', 'edge_item', 'edge_weight', 'user_degree',
                 'item_degree'):
        np.testing.assert_array_equal(getattr(got.graph, name),
                                      np.asarray(getattr(want.graph, name)))


def test_test_file_rules_hold_with_the_native_reader(tmp_path, caplog,
                                                     monkeypatch):
    # a CLI run earlier in the worker stops the port's logger propagating
    # (and a --quiet one raises its level)
    monkeypatch.setattr(logging.getLogger('textgcn_tpu_torch'), 'propagate',
                        True)
    caplog.set_level(logging.WARNING, logger='textgcn_tpu_torch')
    (tmp_path / 'train.tsv').write_text('user_id\tasin\nu1\ta\nu2\tb\n')
    (tmp_path / 'test.tsv').write_text('user_id\tasin\nu2\tz\nu1\tb\n'
                                       'u1\ta\n')
    data = core.load_interactions(str(tmp_path))
    assert data.n_test == 2 and data.true_test == [[0, 1]]
    assert 'removing them' in caplog.text
    (tmp_path / 'test.tsv').write_text('user_id\tasin\nu3\ta\n')
    with pytest.raises(ValueError, match="users {'u3'} from test set"):
        core.load_interactions(str(tmp_path))


# --- the build ----------------------------------------------------------------

BUILD_ONE = '''
import importlib.util, sys
spec = importlib.util.spec_from_file_location('native_copy', sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
mod.BUILD_DIR = sys.argv[2]
mod.load()
print(mod.library_path())
'''


def test_six_concurrent_first_builds_load_one_library(tmp_path):
    build_dir = str(tmp_path / 'native')
    procs = [subprocess.Popen([sys.executable, '-c', BUILD_ONE,
                               native.__file__, build_dir],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    assert sorted(os.listdir(build_dir)) == sorted(
        ['.lock', os.path.basename(paths.pop())])


def _fresh_native(monkeypatch, tmp_path):
    spec = importlib.util.spec_from_file_location('native_fresh',
                                                  native.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, 'BUILD_DIR', str(tmp_path / 'native'))
    return mod


def test_a_broken_compiler_raises_and_does_not_fall_back(monkeypatch,
                                                         tmp_path):
    fresh = _fresh_native(monkeypatch, tmp_path)
    monkeypatch.setattr(core, 'native', fresh)
    monkeypatch.setenv('CXX', 'false')
    monkeypatch.delenv(native.ENV, raising=False)
    with pytest.raises(RuntimeError, match='cannot be built: false'):
        core.load_interactions(DUMMY)
    monkeypatch.setenv('CXX', os.path.join(str(tmp_path), 'no-such-cxx'))
    with pytest.raises(RuntimeError, match='no-such-cxx'):
        fresh.build()
    assert not [f for f in os.listdir(tmp_path / 'native')
                if f.endswith(('.so', '.tmp'))]
    # the plain reader needs no compiler
    monkeypatch.setenv(native.ENV, '0')
    assert core.load_interactions(DUMMY).n_users == 12


def test_the_variable_selects_the_reader(monkeypatch):
    calls = []
    real = native.read_pairs

    def counted(path):
        calls.append(path)
        return real(path)

    monkeypatch.setattr(native, 'read_pairs', counted)
    monkeypatch.delenv(native.ENV, raising=False)
    a = core.load_interactions(DUMMY)
    assert [os.path.basename(p) for p in calls] == ['train.tsv', 'test.tsv']
    monkeypatch.setenv(native.ENV, '0')
    b = core.load_interactions(DUMMY)
    assert len(calls) == 2
    assert a.true_test == b.true_test and a.user_id_map == b.user_id_map
    np.testing.assert_array_equal(a.graph.edge_item, b.graph.edge_item)
