"""The port's reader of Flax weights and of sharded checkpoints
(``textgcn_tpu_torch/data/flax_msgpack.py``, ``data/encoder.read_state``)
and ``auto`` on a directory with Flax weights only, against ``msgpack``,
``flax.serialization``, ``transformers`` and the JAX package's
``encode_sentences``, on the CPU.

* The decoder equals ``msgpack.unpackb`` on a hypothesis property over
  nested maps and arrays of ints at every width's boundary, floats
  (float32 and float64), str, bin and ext, and on every length field's
  boundary; malformed input raises with its byte offset.
* ``restore`` equals ``flax.serialization.msgpack_restore`` on float32,
  float16, bfloat16 and int32 arrays, a numpy scalar, a complex, and an
  array chunked under a small ``MAX_CHUNK_SIZE``.
* Tiny models (hidden 32, 2 layers) saved Flax-only by ``FlaxBertModel``,
  ``FlaxRobertaModel``, ``FlaxXLMRobertaModel`` and
  ``FlaxDistilBertModel`` (``save_pretrained``), each beside a
  ``modules.json`` with CLS pooling, ``Normalize`` and a ``max_seq_length``
  of 4, which ``auto`` must not read: the vectors within 1e-5 of the JAX
  package's under ``flax`` and under ``auto``, and ``read_state`` equal
  to ``bert_state_from_flax`` of ``from_pretrained``'s parameters bit for
  bit (also for a tree saved by a model with a head).
* Sharded directories (``max_shard_size`` small enough for 3 shards or
  more) of Flax, safetensors and ``pytorch_model.bin`` read bit-equal to
  single files.
* A directory with both formats holding different weights: ``flax``
  follows the msgpack, ``st`` and ``auto`` the safetensors, each equal to
  the JAX package's same backend.
* Refusals: a Flax-only MPNet directory under every backend, a Flax-only
  directory under ``st``.
* ``chip_smoke.pack_msgpack``'s bytes restore through ``msgpack_restore``,
  and ``write_flax_minilm`` (at a tiny shape) reads as ``write_minilm``'s
  directory and encodes under ``auto`` as it does under ``flax``.
"""

import json
import logging
import os
import shutil

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_encoder_families import SENTENCES, _write_tokenizer
from test_torch_encoder_families import _config as family_config
from test_torch_encoder_multilingual import offline  # noqa: F401 (autouse)
from test_torch_encoder_multilingual import xlmr_config
from test_torch_tokenizer_json import SPECIALS, save_fast, xlmr_unigram
from textgcn_tpu_torch.data import encoder, flax_msgpack
from textgcn_tpu_torch.data import text as port_text
from textgcn_tpu_torch.weights import bert_state_from_flax

msgpack = pytest.importorskip('msgpack')
serialization = pytest.importorskip('flax.serialization')
transformers = pytest.importorskip('transformers')
pytest.importorskip('sentence_transformers')

ATOL = 1e-5
FAMILIES = ('bert', 'roberta', 'xlmr', 'distilbert')
FLAX_MODELS = {'bert': 'FlaxBertModel', 'roberta': 'FlaxRobertaModel',
               'xlmr': 'FlaxXLMRobertaModel',
               'distilbert': 'FlaxDistilBertModel'}
SHARD = '12KB'


# --- the decoder ----------------------------------------------------------------

INT_EDGES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
             2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
             -2 ** 31, -2 ** 31 - 1, -2 ** 63]
LEAVES = (st.none() | st.booleans() | st.sampled_from(INT_EDGES)
          | st.integers(-2 ** 63, 2 ** 64 - 1)
          | st.floats(allow_nan=False) | st.text(max_size=40)
          | st.binary(max_size=40)
          | st.builds(msgpack.ExtType, st.integers(0, 127),
                      st.binary(max_size=20)))
TREES = st.recursive(
    LEAVES, lambda kids: st.lists(kids, max_size=5)
    | st.dictionaries(st.text(max_size=6) | st.binary(max_size=4), kids,
                      max_size=5), max_leaves=25)


@pytest.mark.parametrize('single_float', [False, True])
@settings(max_examples=60, deadline=None)
@given(tree=TREES)
def test_the_decoder_equals_msgpack(tree, single_float):
    data = msgpack.packb(tree, use_bin_type=True,
                         use_single_float=single_float)
    assert flax_msgpack.unpackb(data) == msgpack.unpackb(data)


LENGTHS = [0, 1, 2, 4, 8, 15, 16, 17, 31, 32, 255, 256, 65535, 65536]


@pytest.mark.parametrize('kind', ['str', 'bin', 'array', 'map', 'ext'])
def test_every_length_field(kind):
    """Each length across the fix/8/16/32 boundaries of its type (ext: the
    fixext sizes too)."""
    make = {'str': lambda n: 'é' * (n // 2) + 'x' * (n % 2),
            'bin': lambda n: bytes(range(256)) * (n // 256) + b'\x07' * (
                n % 256),
            'array': lambda n: list(range(n)),
            'map': lambda n: {str(i): i for i in range(n)},
            'ext': lambda n: msgpack.ExtType(5, b'\xab' * n)}[kind]
    for n in LENGTHS:
        data = msgpack.packb(make(n), use_bin_type=True)
        assert flax_msgpack.unpackb(data) == msgpack.unpackb(data), n


@pytest.mark.parametrize('data, match', [
    (b'\xc1', 'type code 0xc1 at byte 0'),
    (b'\x92\x01\xcd\x01', 'at byte 3 needs 2 bytes'),
    (b'\x01\x02', '1 bytes after the object, from byte 1'),
    (b'\x81\x01\x02', 'key of type int at byte 1'),
    (b'\x91\xd9\x05ab', 'a str at byte 3 needs 5 bytes'),
])
def test_malformed_input_raises_with_its_offset(data, match):
    with pytest.raises(ValueError, match=match):
        flax_msgpack.unpackb(data)


def _jax_bf16(a):
    import jax.numpy as jnp
    return np.asarray(a, dtype=jnp.bfloat16)


@pytest.mark.parametrize('kind', ['float32', 'float16', 'bfloat16', 'int32',
                                  'scalar', 'complex'])
def test_flax_ext_types_equal_msgpack_restore(kind):
    rng = np.random.default_rng(3)
    leaf = {'float32': lambda: rng.standard_normal((3, 5)).astype(
                np.float32),
            'float16': lambda: rng.standard_normal(7).astype(np.float16),
            'bfloat16': lambda: _jax_bf16(rng.standard_normal((2, 3, 4))),
            'int32': lambda: rng.integers(-9, 9, (4, 2)).astype(np.int32),
            'scalar': lambda: np.float32(1.25),
            'complex': lambda: complex(1.5, -2.0)}[kind]()
    tree = {'layer': {'0': {'kernel': leaf}}, 'count': 3}
    data = serialization.msgpack_serialize(tree)
    want = serialization.msgpack_restore(data)['layer']['0']['kernel']
    got = flax_msgpack.restore(data)
    assert got['count'] == 3
    got = got['layer']['0']['kernel']
    if kind == 'complex':
        assert got == want and isinstance(got, complex)
        return
    if kind == 'bfloat16':
        assert got.dtype == np.float32
        want = np.asarray(want, np.float32)
    else:
        assert got.dtype == want.dtype
    assert np.shape(got) == np.shape(want)
    np.testing.assert_array_equal(got, want)
    if kind == 'scalar':
        assert isinstance(got, np.generic)


def test_a_chunked_array_equals_msgpack_restore(monkeypatch):
    monkeypatch.setattr(serialization, 'MAX_CHUNK_SIZE', 64)
    big = np.arange(300, dtype=np.float32).reshape(15, 20)
    data = serialization.msgpack_serialize({'a': {'big': big},
                                            'small': big[:2, :3].copy()})
    assert b'__msgpack_chunked_array__' in data
    want = serialization.msgpack_restore(data)
    got = flax_msgpack.restore(data)
    np.testing.assert_array_equal(got['a']['big'], want['a']['big'])
    np.testing.assert_array_equal(got['small'], want['small'])
    assert got['a']['big'].shape == (15, 20)


def test_another_ext_type_is_refused():
    data = msgpack.packb({'w': msgpack.ExtType(9, b'xy')})
    assert flax_msgpack.unpackb(data) == {'w': (9, b'xy')}
    with pytest.raises(ValueError, match='ext type 9 at byte 3'):
        flax_msgpack.restore(data)


# --- Flax-only model directories -------------------------------------------------

def _st_modules(d, hidden):
    """Sentence Transformers' files for CLS pooling, ``Normalize`` and a
    ``max_seq_length`` of 4: read by ``st``, not by ``auto`` on a
    Flax-only directory."""
    modules = [{'idx': 0, 'name': '0', 'path': '',
                'type': 'sentence_transformers.models.Transformer'},
               {'idx': 1, 'name': '1', 'path': '1_Pooling',
                'type': 'sentence_transformers.models.Pooling'},
               {'idx': 2, 'name': '2', 'path': '2_Normalize',
                'type': 'sentence_transformers.models.Normalize'}]
    for sub in ('1_Pooling', '2_Normalize'):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    for path, conf in (('modules.json', modules),
                       ('sentence_bert_config.json', {'max_seq_length': 4}),
                       ('1_Pooling/config.json', {
                           'word_embedding_dimension': hidden,
                           'pooling_mode_cls_token': True,
                           'pooling_mode_mean_tokens': False})):
        with open(os.path.join(d, path), 'w') as f:
            json.dump(conf, f)


def _flax_dir(d, family, seed):
    """A tokenizer and a Flax-only model of ``family`` in ``d``."""
    if family == 'xlmr':
        os.makedirs(d)
        tok, cls = xlmr_unigram()
        save_fast(tok, cls, d, SPECIALS['unigram'])
        cfg = xlmr_config(tok.get_vocab_size())
    else:
        cfg = family_config(family, len(_write_tokenizer(d, family)))
    getattr(transformers, FLAX_MODELS[family])(cfg, seed=seed) \
        .save_pretrained(d)
    _st_modules(d, 32)
    return d


@pytest.fixture(scope='module')
def flax_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp('flax_only')
    out = {f: _flax_dir(str(root / f), f, k)
           for k, f in enumerate(FAMILIES)}
    for d in out.values():
        assert 'flax_model.msgpack' in os.listdir(d)
        assert encoder.weights_file(d, 'st') is None
    return out


class _Warnings(logging.Handler):
    """The port logger's records (the CLI may have stopped it
    propagating to the root, where ``caplog`` listens)."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.records = []

    def emit(self, record):
        self.records.append(record.getMessage())


@pytest.mark.parametrize('backend', ['flax', 'auto'])
@pytest.mark.parametrize('family', FAMILIES)
def test_a_flax_only_directory_encodes_as_the_jax_package(
        flax_dirs, family, backend, monkeypatch):
    from textgcn_tpu.data import text as jax_text
    monkeypatch.setenv(port_text.ENCODER_ENV, backend)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    d = flax_dirs[family]
    want = jax_text.encode_sentences(SENTENCES, d, 16)
    seen = _Warnings()
    logger = logging.getLogger('textgcn_tpu_torch')
    logger.addHandler(seen)
    try:
        got = port_text.encode_sentences(SENTENCES, d, 16)
    finally:
        logger.removeHandler(seen)
    assert got.shape == want.shape == (len(SENTENCES), 32)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # the Flax recipe: unit rows of the token mean over every token
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1, atol=1e-6)
    assert len([m for m in seen.records if 'Flax recipe' in m]) == (
        backend == 'auto')


@pytest.mark.parametrize('family', FAMILIES)
def test_read_state_equals_from_pretrained(flax_dirs, family):
    import jax
    d = flax_dirs[family]
    params = getattr(transformers, FLAX_MODELS[family]).from_pretrained(
        d).params
    _assert_same(encoder.read_state(d),
                 bert_state_from_flax(jax.tree.map(np.asarray, params)))


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k


def test_a_tree_saved_with_a_head_drops_its_base_key(flax_dirs, tmp_path):
    import jax
    d = str(tmp_path / 'head')
    cfg = transformers.BertConfig.from_pretrained(flax_dirs['bert'])
    transformers.FlaxBertForMaskedLM(cfg, seed=9).save_pretrained(d)
    raw = flax_msgpack.read_flax_file(os.path.join(d, 'flax_model.msgpack'))
    assert 'bert' in raw and 'embeddings' not in raw
    params = transformers.FlaxBertModel.from_pretrained(d).params
    _assert_same(encoder.read_state(d),
                 bert_state_from_flax(jax.tree.map(np.asarray, params)))


# --- sharded checkpoints -----------------------------------------------------------

@pytest.fixture(scope='module')
def sharded(flax_dirs, tmp_path_factory):
    """``fmt -> (single-file directory, sharded directory)``."""
    root = tmp_path_factory.mktemp('sharded')
    bert = flax_dirs['bert']
    transformers.FlaxBertModel.from_pretrained(bert).save_pretrained(
        str(root / 'flax'), max_shard_size=SHARD)
    torch.manual_seed(0)
    model = transformers.BertModel(
        transformers.BertConfig.from_pretrained(bert))
    model.save_pretrained(str(root / 'single'))
    model.save_pretrained(str(root / 'safetensors'), max_shard_size=SHARD)
    model.save_pretrained(str(root / 'bin'), max_shard_size=SHARD,
                          safe_serialization=False)
    return {'flax': (bert, str(root / 'flax')),
            'safetensors': (str(root / 'single'), str(root / 'safetensors')),
            'bin': (str(root / 'single'), str(root / 'bin'))}


@pytest.mark.parametrize('fmt, index, shard_suffix', [
    ('flax', 'flax_model.msgpack.index.json', '.msgpack'),
    ('safetensors', 'model.safetensors.index.json', '.safetensors'),
    ('bin', 'pytorch_model.bin.index.json', '.bin')])
def test_a_sharded_checkpoint_reads_as_one_file(sharded, fmt, index,
                                                shard_suffix):
    single, d = sharded[fmt]
    files = os.listdir(d)
    assert index in files
    assert len([f for f in files if f.endswith(shard_suffix)]) >= 3
    want = encoder.read_state(single)
    _assert_same(encoder.read_state(d), want)
    if fmt == 'flax':
        assert encoder.flax_only(d)
        assert encoder.weights_file(d, 'flax') == index
    else:
        assert encoder.weights_file(d, 'st') == index
        _assert_same(encoder.read_state(d, 'st'), want)


# --- both formats, and refusals -------------------------------------------------

@pytest.fixture(scope='module')
def both(flax_dirs, tmp_path_factory):
    """The Flax-only BERT directory with a torch ``model.safetensors`` of
    other weights beside its ``flax_model.msgpack``."""
    d = str(tmp_path_factory.mktemp('both') / 'bert')
    shutil.copytree(flax_dirs['bert'], d)
    torch.manual_seed(7)
    transformers.BertModel(transformers.BertConfig.from_pretrained(
        d)).save_pretrained(d)
    assert {'flax_model.msgpack', 'model.safetensors'} <= set(os.listdir(d))
    return d


@pytest.mark.parametrize('backend', ['flax', 'st', 'auto'])
def test_both_formats_follow_each_backends_library(both, backend,
                                                   monkeypatch):
    from textgcn_tpu.data import text as jax_text
    flax_state, st_state = (encoder.read_state(both),
                            encoder.read_state(both, 'st'))
    k = 'embeddings.word_embeddings.weight'
    assert not torch.equal(flax_state[k], st_state[k])
    assert not encoder.flax_only(both)
    monkeypatch.setenv(port_text.ENCODER_ENV, backend)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    want = jax_text.encode_sentences(SENTENCES, both, 16)
    got = port_text.encode_sentences(SENTENCES, both, 16)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.fixture(scope='module')
def mpnet_flax(flax_dirs, tmp_path_factory):
    """An MPNet directory whose only weights are a Flax tree: transformers
    has no ``FlaxMPNetModel``."""
    d = str(tmp_path_factory.mktemp('mpnet') / 'mpnet')
    tok = _write_tokenizer(d, 'mpnet')
    family_config('mpnet', len(tok)).save_pretrained(d)
    shutil.copy(os.path.join(flax_dirs['bert'], 'flax_model.msgpack'), d)
    return d


@pytest.mark.parametrize('case, backend, error, match', [
    ('mpnet', 'flax', NotImplementedError, 'mpnet has no Flax model'),
    ('mpnet', 'auto', NotImplementedError, 'mpnet has no Flax model'),
    ('mpnet', 'st', OSError, 'from_flax=True'),
    ('bert', 'st', OSError, 'there is a file for Flax weights')])
def test_a_flax_only_directory_is_refused(flax_dirs, mpnet_flax, case,
                                          backend, error, match):
    d = mpnet_flax if case == 'mpnet' else flax_dirs[case]
    with pytest.raises(error, match=match):
        encoder.encode(SENTENCES, d, 4, 'cpu', backend)
    if case == 'mpnet' and backend == 'flax':
        from textgcn_tpu.data.encoder_flax import flax_encode
        with pytest.raises(ValueError):
            flax_encode(SENTENCES, d, 4)


# --- chip_smoke.py's writer ---------------------------------------------------------

def test_the_chip_scripts_writer_restores_through_flax():
    import chip_smoke
    rng = np.random.default_rng(1)
    tree = {'embeddings': {'word_embeddings': {
                'embedding': rng.standard_normal((40, 8)).astype(np.float32)},
                'LayerNorm': {'scale': np.ones(8, np.float32),
                              'bias': np.zeros(8, np.float32)}},
            'wide': {str(i): np.full(i + 1, i, np.float32)
                     for i in range(20)},
            'ints': [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 63],
            'long': list(range(40)), 'name': 'n' * 40, 'longer': 'm' * 300,
            'raw': b'\x00' * 300, 'tiny': np.zeros(1, np.int8)}
    got = serialization.msgpack_restore(chip_smoke.pack_msgpack(tree))

    def same(a, b):
        if isinstance(b, dict):
            assert sorted(a) == sorted(b)
            for k in b:
                same(a[k], b[k])
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b

    same(got, tree)
    assert flax_msgpack.restore(chip_smoke.pack_msgpack(tree))['name'] \
        == 'n' * 40


def test_the_chip_scripts_flax_directories(tmp_path, monkeypatch):
    """``write_flax_minilm`` at a tiny shape: both directories read as
    ``write_minilm``'s safetensors and as ``FlaxBertModel`` reads them,
    and ``auto`` over the Flax-only one gives ``flax``'s vectors over the
    safetensors one bit for bit (the chip script's cache check)."""
    import jax

    import chip_smoke
    tiny = {**chip_smoke.MINILM, 'vocab_size': 256, 'hidden_size': 32,
            'num_hidden_layers': 2, 'num_attention_heads': 4,
            'intermediate_size': 64, 'max_position_embeddings': 64}
    monkeypatch.setattr(chip_smoke, 'MINILM', tiny)
    root = str(tmp_path)
    st_dir = chip_smoke.write_minilm(root)
    state = chip_smoke.random_weights(tiny, 0)
    flax_dir = chip_smoke.write_flax_minilm(root, 'flax_only', state)
    sharded = chip_smoke.write_flax_minilm(root, 'flax_sharded', state, 3)
    assert os.path.basename(flax_dir) == os.path.basename(st_dir)
    assert len([f for f in os.listdir(sharded)
                if f.endswith('.msgpack')]) == 3
    want = encoder.read_state(st_dir)
    for d in (flax_dir, sharded):
        assert encoder.flax_only(d)
        _assert_same(encoder.read_state(d), want)
        params = transformers.FlaxBertModel.from_pretrained(d).params
        _assert_same(bert_state_from_flax(jax.tree.map(np.asarray, params)),
                     want)
    texts = ['title of a longer description', 'review by 12', 'item', '']
    np.testing.assert_array_equal(
        encoder.encode(texts, flax_dir, 4, 'cpu', 'auto'),
        encoder.encode(texts, st_dir, 4, 'cpu', 'flax'))
