"""The port's text encoder (``textgcn_tpu_torch/data/encoder.py``) against
Hugging Face's slow ``BertTokenizer`` and the JAX package's
``encoder_flax.flax_encode``, on the CPU.

A tiny BERT of ``tests/test_encoder_flax.py``'s shape (32 wide, 2 layers,
4 heads, 64 inner, 32 positions) with seeded random weights is written to
disk by ``transformers`` (nothing is downloaded), over a ``vocab.txt``
that holds ``data/dummy``'s words, letters and their ``##`` pieces.

* Tokenizer: the ids equal the slow ``BertTokenizer``'s exactly, on
  ``data/dummy``'s reviews and item descriptions and on a hypothesis
  property over Unicode text (accents, CJK, punctuation, control
  characters, special tokens inside the text, words over 100 characters,
  truncation), for a lowercasing config, a cased one and one that keeps
  accents.
* ``encode`` equals ``flax_encode`` within 1e-5 absolute and cosine
  1 - 1e-6, from ``model.safetensors`` and from ``pytorch_model.bin``;
  the Flax parameters carried by ``weights.bert_state_from_flax`` give the
  same vectors, and ``read_state`` reads them from ``flax_model.msgpack``
  bit for bit.
* ``load_ltr_data`` on a copy of ``data/dummy`` without ``embeddings/``,
  under ``TEXTGCN_TPU_TEXT_ENCODER=flax`` and the tiny model, writes the
  JAX loader's ``.npy`` (1e-5) and ``.meta`` (equal).
* A fresh interpreter in which ``transformers``, ``safetensors`` and
  ``tokenizers`` cannot be imported still encodes.
"""

import csv
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from textgcn_tpu_torch.data import encoder
from textgcn_tpu_torch.data import text as port_text
from textgcn_tpu_torch.weights import bert_state_from_flax

transformers = pytest.importorskip('transformers')

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DUMMY = os.path.join(REPO, 'data', 'dummy')
SENTENCES = [
    'the cat sat on the mat',
    'a dog ran fast',
    'graph user item graph user item graph user item',
    'cat',
    'the the the the the the the the',
    'user item',
    '',
    'Review text from user_3 about asin_7: opinion 4!',
    'item number 2 title words [SEP] a longer description of item 2',
]
WORDS = ('the cat sat on mat a dog ran fast graph user item review text '
         'from about asin opinion number title words longer description of '
         'with detail The Cat Graph Item Review caf Émile').split()
TOKENIZER_CONFIGS = {
    'lower': dict(do_lower_case=True),
    'cased': dict(do_lower_case=False),
    'lower_keep_accents': dict(do_lower_case=True, strip_accents=False),
}
ATOL, COS = 1e-5, 1e-6


def _vocab():
    letters = [chr(c) for c in range(ord('a'), ord('z') + 1)]
    chars = (letters + [c.upper() for c in letters] + list('0123456789')
             + list('_:!.,-#\'') + ['é', 'É', 'ü', 'σ', 'ς', '中', '文'])
    out = ['[PAD]', '[UNK]', '[CLS]', '[SEP]', '[MASK]']
    for w in [*WORDS, *chars, *('##' + c for c in chars), '##s', '##ing']:
        if w not in out:
            out.append(w)
    return out


@pytest.fixture(scope='module')
def tokenizer_dirs(tmp_path_factory):
    """One tokenizer directory per config, written by ``transformers``."""
    from transformers import BertTokenizer
    out = {}
    for name, kw in TOKENIZER_CONFIGS.items():
        d = tmp_path_factory.mktemp(f'tok_{name}')
        (d / 'vocab.txt').write_text('\n'.join(_vocab()) + '\n')
        hf = BertTokenizer(vocab_file=str(d / 'vocab.txt'), **kw)
        hf.save_pretrained(str(d))
        out[name] = (hf, encoder.BertTokenizer.from_dir(str(d)))
    return out


def _write_bert(d, safe: bool):
    from transformers import BertConfig, BertModel, BertTokenizer
    os.makedirs(d, exist_ok=True)
    vocab = _vocab()
    with open(os.path.join(d, 'vocab.txt'), 'w') as f:
        f.write('\n'.join(vocab) + '\n')
    BertTokenizer(vocab_file=os.path.join(d, 'vocab.txt')).save_pretrained(d)
    torch.manual_seed(0)
    cfg = BertConfig(vocab_size=len(vocab), hidden_size=32,
                     num_hidden_layers=2, num_attention_heads=4,
                     intermediate_size=64, max_position_embeddings=32)
    BertModel(cfg).save_pretrained(d, safe_serialization=safe)
    return d


@pytest.fixture(scope='module')
def tiny_berts(tmp_path_factory):
    root = tmp_path_factory.mktemp('tiny_bert')
    return {'safetensors': _write_bert(str(root / 'st'), True),
            'bin': _write_bert(str(root / 'bin'), False)}


def _flax_encode(sentences, model_dir, batch_size):
    from textgcn_tpu.data.encoder_flax import flax_encode
    return flax_encode(sentences, model_dir, batch_size=batch_size)


def _assert_close(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    assert (cos >= 1 - COS).all(), cos


def _dummy_texts():
    with open(os.path.join(DUMMY, 'meta_synced.tsv'), newline='') as f:
        meta = list(csv.reader(f, delimiter='\t'))[1:]
    with open(os.path.join(DUMMY, 'reviews_text.tsv'), newline='') as f:
        reviews = list(csv.reader(f, delimiter='\t'))[1:]
    return ([' [SEP] '.join(r[1:]) for r in meta]
            + [r[2] for r in reviews])


# --- the tokenizer -----------------------------------------------------------

def _same_ids(pair, text, max_length):
    hf, port = pair
    want = hf(text, truncation=True, max_length=max_length)['input_ids']
    assert port.encode(text, max_length) == want, (text, max_length)


@pytest.mark.parametrize('config', TOKENIZER_CONFIGS)
def test_ids_equal_hf_on_dummy_text(tokenizer_dirs, config):
    texts = _dummy_texts() + SENTENCES
    for max_length in (8, 32, 512):
        for t in texts:
            _same_ids(tokenizer_dirs[config], t, max_length)
    hf, port = tokenizer_dirs[config]
    ids, mask = port(texts, 16)
    want = hf(texts, padding='longest', truncation=True, max_length=16)
    np.testing.assert_array_equal(ids, want['input_ids'])
    np.testing.assert_array_equal(mask, want['attention_mask'])


PIECES = ['a', 'b', 'x', 'the', 'cat', 'Graph', 'ITEM', 'items', '\u00e9',
          '\u00c9', 'e\u0301', '\u00fc', '\u00f1', '\u00c5', '\ufb01',
          '\u03a3', '\u039f\u0394\u039f\u03a3', '\u0130', '\u00df',
          '\u4e2d', '\u6587', '\u3400', '\ud55c', '\u30ab', '\u3001',
          '\u3002', '!', ',', '.', '-', "'", '#', '$', '^', '`', '~',
          '\u00bf', '\x00', '\x07', '\x1f', '\u200b', '\u00ad', '\ufffd',
          '\ufeff', ' ', '  ', '\t', '\n', '\r', '\u3000', '\u00a0',
          '\u2028', '\u0301', '\x85', '[SEP]', '[CLS]', '[UNK]', '[MASK]',
          '[PAD]', '[sep]', 'x' * 101, 'e' * 100, 'caf' + 'e' * 98, '##s',
          'sat', 'ing']
UNICODE = st.one_of(
    st.lists(st.sampled_from(PIECES), max_size=40).map(''.join),
    st.lists(st.sampled_from([p for p in PIECES if p.isascii()]),
             max_size=40).map(''.join),
    st.text(st.characters(max_codepoint=127), max_size=40),
    st.text(max_size=40))


@pytest.mark.parametrize('config', TOKENIZER_CONFIGS)
@settings(max_examples=200, deadline=None, derandomize=True)
@given(text=UNICODE, max_length=st.sampled_from([2, 5, 12, 64]))
def test_ids_equal_hf_on_unicode_text(tokenizer_dirs, config, text,
                                      max_length):
    _same_ids(tokenizer_dirs[config], text, max_length)


def test_a_word_over_100_characters_is_unk(tokenizer_dirs):
    _, port = tokenizer_dirs['lower']
    assert port.tokenize('x' * 101 + ' cat') == ['[UNK]', 'cat']
    assert port.tokenize('x' * 100) == ['x'] + ['##x'] * 99
    assert port.tokenize('cats') == ['cat', '##s']


@pytest.mark.parametrize('setting', [
    {'do_basic_tokenize': False}, {'tokenize_chinese_chars': False},
    {'never_split': ['cats']},
    {'added_tokens_decoder': {'5': {'content': 'the', 'special': False}}},
    # lstrip and rstrip are ported (MPNet's <mask> is lstrip:
    # tests/test_torch_encoder_families.py); single_word is not
    {'added_tokens_decoder': {'4': {'content': '[MASK]',
                                    'single_word': True}}},
])
def test_a_tokenizer_setting_not_ported_is_refused(tmp_path, setting):
    (tmp_path / 'vocab.txt').write_text('\n'.join(_vocab()) + '\n')
    (tmp_path / 'tokenizer_config.json').write_text(json.dumps(setting))
    with pytest.raises(NotImplementedError, match='not ported'):
        encoder.BertTokenizer.from_dir(str(tmp_path))


# --- the encoder -------------------------------------------------------------

@pytest.mark.parametrize('kind', ['safetensors', 'bin'])
def test_encode_matches_flax_encode(tiny_berts, kind):
    d = tiny_berts[kind]
    assert os.path.exists(os.path.join(
        d, 'model.safetensors' if kind == 'safetensors'
        else 'pytorch_model.bin'))
    want = _flax_encode(SENTENCES, d, 3)
    got = encoder.encode(SENTENCES, d, 3, 'cpu')
    _assert_close(got, want)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                               atol=1e-6)


def test_both_checkpoint_formats_read_the_same_state(tiny_berts, tmp_path):
    a = encoder.read_state(tiny_berts['safetensors'])
    b = encoder.read_state(tiny_berts['bin'])
    assert sorted(a) == sorted(b)
    assert not any(k.startswith(('pooler', 'bert.')) for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # a checkpoint with the ``bert.`` prefix and the old LayerNorm names
    old = {'bert.' + k.replace('LayerNorm.weight', 'LayerNorm.gamma')
           .replace('LayerNorm.bias', 'LayerNorm.beta'): v
           for k, v in torch.load(os.path.join(tiny_berts['bin'],
                                               'pytorch_model.bin'),
                                  weights_only=True).items()}
    old['cls.predictions.bias'] = torch.zeros(3)
    assert any('gamma' in k for k in old)
    torch.save(old, tmp_path / 'pytorch_model.bin')
    c = encoder.read_state(str(tmp_path))
    assert sorted(c) == sorted(a)
    assert all(torch.equal(a[k], c[k]) for k in a)


def test_flax_parameters_give_the_same_vectors(tmp_path, tiny_berts):
    """Random Flax weights (no torch checkpoint) in both packages: the
    directory holds ``flax_model.msgpack`` only, which ``read_state`` reads
    as ``bert_state_from_flax`` carries the parameters across, bit for bit
    (the reader itself: ``tests/test_torch_flax_weights.py``)."""
    import jax
    from transformers import BertConfig, FlaxBertModel
    d = str(tmp_path / 'flax_only')
    os.makedirs(d)
    for name in ('vocab.txt', 'tokenizer_config.json',
                 'special_tokens_map.json'):
        shutil.copy(os.path.join(tiny_berts['bin'], name), d)
    cfg = BertConfig.from_pretrained(tiny_berts['bin'])
    FlaxBertModel(cfg, seed=3).save_pretrained(d)
    assert os.listdir(d).count('flax_model.msgpack') == 1
    params = jax.tree.map(np.asarray,
                          FlaxBertModel.from_pretrained(d).params)
    state = bert_state_from_flax(params)
    assert sorted(state) == sorted(encoder.read_state(tiny_berts['bin']))
    read = encoder.read_state(d)
    assert sorted(read) == sorted(state)
    assert all(torch.equal(read[k], state[k]) for k in state)
    tok, model, max_length = encoder.load_encoder(d, 'cpu', state=state)
    assert max_length == 32
    got = encoder.encode_with(tok, model, max_length, SENTENCES, 4)
    np.testing.assert_array_equal(encoder.encode(SENTENCES, d, 4, 'cpu'),
                                  got)
    _assert_close(got, _flax_encode(SENTENCES, d, 4))


def test_safetensors_half_types_read_as_float32(tmp_path):
    from safetensors.torch import save_file
    tensors = {'f16': torch.randn(3, 5).half(),
               'bf16': torch.randn(7).bfloat16(),
               'f32': torch.randn(2, 2, 2)}
    path = str(tmp_path / 'x.safetensors')
    save_file(tensors, path, metadata={'format': 'pt'})
    got = encoder.read_safetensors(path)
    for k, t in tensors.items():
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], t.float()), k


@pytest.mark.parametrize('change, match', [
    # roberta, distilbert and mpnet run since the encoder families came
    # (tests/test_torch_encoder_families.py), xlm-roberta since the
    # multilingual encoders (tests/test_torch_encoder_multilingual.py)
    ({'model_type': 'gpt2'}, "'gpt2' is not ported yet"),
    ({'hidden_act': 'silu'}, "'silu' is not ported yet"),
    ({'position_embedding_type': 'relative_key'}, 'not ported yet'),
])
def test_another_model_is_refused(tiny_berts, change, match):
    with open(os.path.join(tiny_berts['bin'], 'config.json')) as f:
        config = json.load(f)
    with pytest.raises(NotImplementedError, match=match):
        encoder.BertEncoder({**config, **change})


@pytest.mark.parametrize('act', ['gelu', 'gelu_new', 'gelu_pytorch_tanh',
                                 'relu'])
def test_each_activation_matches_transformers(tmp_path, act):
    """The hidden state of ``transformers``' ``BertModel`` (eager
    attention) with the same weights, per ``hidden_act``."""
    from transformers import BertConfig, BertModel
    torch.manual_seed(1)
    cfg = BertConfig(vocab_size=40, hidden_size=16, num_hidden_layers=2,
                     num_attention_heads=2, intermediate_size=24,
                     max_position_embeddings=16, hidden_act=act,
                     attn_implementation='eager')
    ref = BertModel(cfg, add_pooling_layer=False).eval()
    ref.save_pretrained(str(tmp_path))
    port = encoder.BertEncoder(cfg.to_dict())
    port.load_state_dict(encoder.read_state(str(tmp_path)))
    ids = torch.randint(0, 40, (3, 9))
    mask = torch.ones(3, 9, dtype=torch.int64)
    mask[1, 5:] = 0
    mask[2, 2:] = 0
    with torch.no_grad():
        want = ref(input_ids=ids, attention_mask=mask).last_hidden_state
        got = port(ids, mask)
    keep = mask.bool()
    np.testing.assert_allclose(got[keep].numpy(), want[keep].numpy(),
                               atol=1e-5, rtol=0)


def test_a_name_resolves_in_the_hub_cache(tmp_path, monkeypatch,
                                          tiny_berts):
    hub = tmp_path / 'hf' / 'hub'
    base = hub / 'models--sentence-transformers--tiny-bert'
    snap = base / 'snapshots' / 'abc123'
    shutil.copytree(tiny_berts['safetensors'], snap)
    (base / 'snapshots' / 'zzz').mkdir()
    (base / 'refs').mkdir()
    (base / 'refs' / 'main').write_text('abc123')
    monkeypatch.delenv('HF_HUB_CACHE', raising=False)
    monkeypatch.setenv('HF_HOME', str(tmp_path / 'hf'))
    assert encoder.resolve_model_dir('tiny-bert') == str(snap)
    assert encoder.resolve_model_dir('sentence-transformers/tiny-bert') \
        == str(snap)
    with pytest.raises(FileNotFoundError) as e:
        encoder.resolve_model_dir('org/absent')
    assert str(hub / 'models--org--absent' / 'snapshots') in str(e.value)
    monkeypatch.setenv('HF_HUB_CACHE', str(hub))
    got = encoder.encode(SENTENCES[:2], 'tiny-bert', 2, 'cpu')
    _assert_close(got, encoder.encode(SENTENCES[:2],
                                      tiny_berts['safetensors'], 2, 'cpu'))


# --- the loader --------------------------------------------------------------

def test_load_ltr_data_writes_the_jax_caches(tmp_path, monkeypatch,
                                             tiny_berts):
    from textgcn_tpu.config import Config as JaxConfig
    from textgcn_tpu.data import text as jax_text
    from textgcn_tpu_torch import config as tconfig
    monkeypatch.setenv('TEXTGCN_TPU_TEXT_ENCODER', 'flax')
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    dirs = {}
    for side in ('jax', 'port'):
        dirs[side] = tmp_path / side / 'dummy'
        shutil.copytree(DUMMY, dirs[side],
                        ignore=shutil.ignore_patterns('embeddings'))
    model = tiny_berts['safetensors']
    jax_text.load_ltr_data(JaxConfig(data=str(dirs['jax']), bert_model=model,
                                     emb_batch_size=4).finalize())
    port_text.load_ltr_data(tconfig.Config(
        data=str(dirs['port']), bert_model=model,
        emb_batch_size=4).finalize())
    names = sorted(os.listdir(dirs['jax'] / 'embeddings'))
    assert names == sorted(os.listdir(dirs['port'] / 'embeddings'))
    assert len(names) == 4 and all(n.startswith(('item_', 'user_'))
                                   or n.endswith(('.npy', '.meta'))
                                   for n in names)
    for name in names:
        a, b = dirs['port'] / 'embeddings' / name, \
            dirs['jax'] / 'embeddings' / name
        if name.endswith('.npy'):
            _assert_close(np.load(a), np.load(b))
        else:
            assert a.read_text() == b.read_text(), name


def test_encode_sentences_routes_every_backend(monkeypatch, tiny_berts):
    """``flax`` runs the Flax recipe; ``st`` and ``auto`` Sentence
    Transformers' (this directory has no ``modules.json``: mean pooling,
    no normalisation)."""
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    flax = encoder.encode(SENTENCES, tiny_berts['bin'], 4, 'cpu')
    st = encoder.encode(SENTENCES, tiny_berts['bin'], 4, 'cpu', 'st')
    np.testing.assert_allclose(np.linalg.norm(flax, axis=-1), 1, atol=1e-6)
    np.testing.assert_allclose(
        flax, st / np.linalg.norm(st, axis=-1, keepdims=True), atol=1e-6)
    for backend, want in (('flax', flax), ('st', st), ('auto', st)):
        monkeypatch.setenv(port_text.ENCODER_ENV, backend)
        got = port_text.encode_sentences(SENTENCES, tiny_berts['bin'], 4)
        np.testing.assert_array_equal(got, want)
    monkeypatch.setenv(port_text.ENCODER_ENV, 'bogus')
    with pytest.raises(ValueError, match='bogus'):
        port_text.encode_sentences(SENTENCES, tiny_berts['bin'], 4)


def test_encodes_without_the_hugging_face_packages(tmp_path, tiny_berts):
    out = str(tmp_path / 'v.npy')
    code = (
        'import os, sys\n'
        "for m in ('transformers', 'safetensors', 'tokenizers', "
        "'sentence_transformers', 'flax', 'jax'):\n"
        '    sys.modules[m] = None\n'
        f'sys.path.insert(0, {REPO!r})\n'
        'import numpy as np\n'
        'from textgcn_tpu_torch.data.text import encode_sentences\n'
        "os.environ['TEXTGCN_TPU_TEXT_ENCODER'] = 'flax'\n"
        "os.environ['TEXTGCN_TPU_PLATFORM'] = 'cpu'\n"
        f'np.save({out!r}, encode_sentences({SENTENCES!r}, '
        f"{tiny_berts['safetensors']!r}, 3))\n"
        'import transformers\n')
    run = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120)
    # the encode ran; the last import shows the ban held
    assert run.stderr.strip().endswith(
        'import of transformers halted; None in sys.modules'), run.stderr
    _assert_close(np.load(out),
                  encoder.encode(SENTENCES, tiny_berts['safetensors'], 3,
                                 'cpu'))
