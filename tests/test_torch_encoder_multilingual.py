"""The port's multilingual encoders (``textgcn_tpu_torch/data/encoder.py``
with ``tokenizer_json.py``, ``encoder_models.py``) against the JAX
package's Sentence Transformers path (``textgcn_tpu.data.text._st_encode``)
and its Flax path (``encoder_flax.flax_encode``), on the CPU.

Tiny models (hidden 32, 2 layers, 4 heads, inner 64) are written by
``transformers`` with seeded random weights over ``tokenizer.json`` files
written by ``tokenizers`` (with ``tests/test_torch_tokenizer_json.py``'s
functions; nothing is downloaded):

* ``bert_unigram``: a ``bert`` with XLM-RoBERTa's Unigram tokenizer (the
  shape of paraphrase-multilingual-MiniLM-L12-v2);
* ``xlmr``: an ``xlm-roberta`` (paraphrase-multilingual-mpnet-base-v2's
  family) over the same tokenizer;
* ``distilbert``: a ``distilbert`` with a WordPiece ``tokenizer.json``
  (distiluse-base-multilingual-cased-v2's family), under a ``Dense``
  module with ``tanh``.

* ``st``: the vectors within 1e-5 of ``_st_encode`` for each model, each
  new pooling mode (``mean_sqrt_len_tokens``, ``weightedmean``,
  ``lasttoken``) alone and concatenated with the old ones, ``Dense`` with
  each activation (a chain of three, one without bias), ``do_lower_case``
  over the Unigram tokenizer, and ``Normalize``.
* ``flax``: ``xlm-roberta`` within 1e-5 of ``flax_encode``, from its torch
  checkpoint and from a ``FlaxXLMRobertaModel`` tree carried by
  ``weights.bert_state_from_flax``.
* A ``tokenizer.json`` wins over the vocabulary files for every model
  type; refusals by name: a Dense activation or module order that is not
  ported, a directory whose only tokenizer is ``sentencepiece.bpe.model``.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_tokenizer_json import (SPECIALS, _bert_like, save_fast,
                                       xlmr_unigram)
from textgcn_tpu_torch.data import encoder
from textgcn_tpu_torch.data.tokenizer_json import JsonTokenizer
from textgcn_tpu_torch.weights import bert_state_from_flax

transformers = pytest.importorskip('transformers')
pytest.importorskip('sentence_transformers')

SENTENCES = [
    'the cat sat on the mat',
    "Émile's café, naïve façade",
    'Item Title [SEP] its Description [SEP] ΟΔΟΣ',
    'русский текст '
    'пример',
    '한국어 텍스트   ह\u093fन\u094dद\u0940',
    'ｆｕｌｌ Ｗｉｄｔｈ '
    '中文文本',
    'cat',
    '',
    '  review text from user_3 about asin_7: opinion 4!  ',
    'item number 2 title words a longer description of item 2 with detail '
    'item number 2 title words a longer description of item 2 with detail',
]
ATOL = 1e-5
H, LAYERS, HEADS, INNER = 32, 2, 4, 64


def _perturb(model):
    with torch.no_grad():
        for name, p in model.named_parameters():
            if 'LayerNorm.bias' in name:
                p.normal_(0, 0.5)
    return model


def _write(d, family, seed):
    """A tiny model of ``family`` and its ``tokenizer.json``."""
    os.makedirs(d)
    if family == 'distilbert':
        tok, _ = _bert_like()
        save_fast(tok, transformers.DistilBertTokenizerFast, d,
                  SPECIALS['wordpiece'])
    else:
        tok, cls = xlmr_unigram()
        save_fast(tok, cls, d, SPECIALS['unigram'])
    vocab = tok.get_vocab_size()
    torch.manual_seed(seed)
    if family == 'bert':
        model = transformers.BertModel(transformers.BertConfig(
            vocab_size=vocab, hidden_size=H, num_hidden_layers=LAYERS,
            num_attention_heads=HEADS, intermediate_size=INNER,
            max_position_embeddings=64))
    elif family == 'xlmr':
        model = transformers.XLMRobertaModel(xlmr_config(vocab))
    else:
        model = transformers.DistilBertModel(transformers.DistilBertConfig(
            vocab_size=vocab, dim=H, n_layers=LAYERS, n_heads=HEADS,
            hidden_dim=INNER, max_position_embeddings=64))
    _perturb(model).save_pretrained(d)
    return d


def xlmr_config(vocab: int):
    """XLM-RoBERTa's 514 positions: with fewer, ``flax_encode``'s length
    cap (the positions, not the tokens they place) overflows the table on
    long texts."""
    return transformers.XLMRobertaConfig(
        vocab_size=vocab, hidden_size=H, num_hidden_layers=LAYERS,
        num_attention_heads=HEADS, intermediate_size=INNER,
        max_position_embeddings=514, type_vocab_size=1, pad_token_id=1,
        bos_token_id=0, eos_token_id=2)


@pytest.fixture(scope='module', autouse=True)
def offline():
    import huggingface_hub.constants as hub
    old = {k: os.environ.get(k) for k in ('HF_HUB_OFFLINE',
                                          'TRANSFORMERS_OFFLINE')}
    os.environ.update(HF_HUB_OFFLINE='1', TRANSFORMERS_OFFLINE='1')
    was, hub.HF_HUB_OFFLINE = hub.HF_HUB_OFFLINE, True
    yield
    hub.HF_HUB_OFFLINE = was
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.fixture(scope='module')
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp('multilingual')
    return {f: _write(str(root / f), f, seed=k)
            for k, f in enumerate(('bert', 'xlmr', 'distilbert'))}


def _dense(d, in_f, out_f, act, bias=True, seed=0):
    from sentence_transformers.models import Dense
    torch.manual_seed(seed)
    os.makedirs(d)
    Dense(in_f, out_f, bias=bias, activation_function=act).save(d)


# name: (model, pooling config, dense [(out, activation, bias)], Normalize,
# sentence_bert_config)
PIPELINES = {
    'bert_unigram': ('bert', {'pooling_mode_mean_tokens': True}, [], True,
                     {'max_seq_length': 64}),
    'bert_unigram_lower': ('bert', {'pooling_mode_mean_tokens': True}, [],
                           False, {'max_seq_length': 12,
                                   'do_lower_case': True}),
    'xlmr': ('xlmr', {'pooling_mode_mean_tokens': True}, [], True,
             {'max_seq_length': 64}),
    'distilbert_dense': ('distilbert', {'pooling_mode_mean_tokens': True},
                         [(16, torch.nn.Tanh(), True)], False,
                         {'max_seq_length': 64}),
    'dense_chain': ('bert', {'pooling_mode': 'cls'},
                    [(24, torch.nn.GELU(), True),
                     (16, torch.nn.Identity(), False),
                     (8, torch.nn.ReLU(), True)], True, {}),
    'mean_sqrt_len_tokens': ('xlmr',
                             {'pooling_mode': 'mean_sqrt_len_tokens'}, [],
                             False, {'max_seq_length': 10}),
    'weightedmean': ('xlmr', {'pooling_mode_weightedmean_tokens': True}, [],
                     False, {'max_seq_length': 40}),
    'lasttoken': ('bert', {'pooling_mode': 'lasttoken'}, [], False,
                  {'max_seq_length': 9}),
    'concatenated': ('distilbert',
                     {'pooling_mode': ['lasttoken', 'weightedmean',
                                       'mean_sqrt_len_tokens', 'max']},
                     [(16, torch.nn.Tanh(), True)], True, {}),
}


def st_dir(root, models, name):
    """A Sentence Transformers directory over ``PIPELINES[name]``'s model."""
    family, pooling, dense, normalize, sbert = PIPELINES[name]
    d = os.path.join(root, name)
    shutil.copytree(models[family], d)
    kinds = [('Transformer', ''), ('Pooling', '1_Pooling')]
    width = H
    os.makedirs(os.path.join(d, '1_Pooling'))
    with open(os.path.join(d, '1_Pooling', 'config.json'), 'w') as f:
        json.dump({'word_embedding_dimension': H, **pooling}, f)
    modes = pooling.get('pooling_mode', 'mean')
    width *= 1 if isinstance(modes, str) else len(modes)
    for k, (out, act, bias) in enumerate(dense):
        path = f'{2 + k}_Dense'
        _dense(os.path.join(d, path), width, out, act, bias, seed=k)
        kinds.append(('Dense', path))
        width = out
    if normalize:
        path = f'{len(kinds)}_Normalize'
        os.makedirs(os.path.join(d, path))
        kinds.append(('Normalize', path))
    with open(os.path.join(d, 'modules.json'), 'w') as f:
        json.dump([{'idx': k, 'name': str(k), 'path': p,
                    'type': f'sentence_transformers.models.{m}'}
                   for k, (m, p) in enumerate(kinds)], f)
    with open(os.path.join(d, 'sentence_bert_config.json'), 'w') as f:
        json.dump(sbert, f)
    return d


@pytest.mark.parametrize('pipeline', PIPELINES)
def test_st_matches_sentence_transformers(models, tmp_path, pipeline):
    from textgcn_tpu.data.text import _st_encode
    d = st_dir(str(tmp_path), models, pipeline)
    want = _st_encode(SENTENCES, d, 3)
    for backend in ('st', 'auto'):
        got = encoder.encode(SENTENCES, d, 3, 'cpu', backend)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    tok, model, _, pipe = encoder.load_sentence_encoder(d, 'cpu')
    assert isinstance(tok, JsonTokenizer)
    assert len(pipe.dense) == len(PIPELINES[pipeline][2])
    if PIPELINES[pipeline][3]:
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1,
                                   atol=1e-6)


# --- the Flax recipe ---------------------------------------------------------

def _flax_encode(sentences, model_dir, batch_size):
    from textgcn_tpu.data.encoder_flax import flax_encode
    return flax_encode(sentences, model_dir, batch_size=batch_size)


def test_flax_matches_flax_encode(models):
    want = _flax_encode(SENTENCES, models['xlmr'], 4)
    got = encoder.encode(SENTENCES, models['xlmr'], 4, 'cpu', 'flax')
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_flax_parameters_carry_across(models, tmp_path):
    """Random ``FlaxXLMRobertaModel`` weights (no torch checkpoint):
    ``bert_state_from_flax`` gives the port the same vectors."""
    import jax
    d = str(tmp_path / 'flax_xlmr')
    os.makedirs(d)
    for name in ('tokenizer.json', 'tokenizer_config.json',
                 'special_tokens_map.json'):
        shutil.copy(os.path.join(models['xlmr'], name), d)
    cfg = transformers.XLMRobertaConfig.from_pretrained(models['xlmr'])
    transformers.FlaxXLMRobertaModel(cfg, seed=5).save_pretrained(d)
    params = jax.tree.map(np.asarray, transformers.FlaxXLMRobertaModel
                          .from_pretrained(d).params)
    state = bert_state_from_flax(params)
    assert sorted(state) == sorted(encoder.read_state(models['xlmr']))
    tok, model, max_length = encoder.load_encoder(d, 'cpu', state=state)
    assert model.model_type == 'xlm-roberta' and max_length == 512
    got = encoder.encode_with(tok, model, max_length, SENTENCES, 4)
    np.testing.assert_allclose(got, _flax_encode(SENTENCES, d, 4),
                               atol=ATOL, rtol=0)


# --- which tokenizer, and refusals -------------------------------------------

@pytest.mark.parametrize('model_type', ['bert', 'distilbert', 'roberta',
                                        'xlm-roberta', 'mpnet'])
def test_a_tokenizer_json_wins_whatever_the_model_type(models, model_type):
    tok = encoder.load_tokenizer(models['bert'], model_type)
    assert isinstance(tok, JsonTokenizer)
    assert tok.encode('the cat') == JsonTokenizer.from_dir(
        models['bert']).encode('the cat')


def test_a_sentencepiece_model_alone_is_refused(models, tmp_path):
    d = str(tmp_path / 'spm_only')
    os.makedirs(d)
    for name in ('config.json', 'model.safetensors'):
        shutil.copy(os.path.join(models['xlmr'], name), d)
    (tmp_path / 'spm_only' / 'sentencepiece.bpe.model').write_bytes(b'\n\x05')
    for backend in ('flax', 'st'):
        with pytest.raises(NotImplementedError,
                           match='SentencePiece model sentencepiece.bpe'):
            encoder.encode(SENTENCES, d, 4, 'cpu', backend)


@pytest.mark.parametrize('change, match', [
    ({'activation_function': 'torch.nn.modules.activation.SiLU'},
     "Dense activation 'torch.nn.modules.activation.SiLU'"),
    ({'activation_function': 'my_package.Swish'},
     "Dense activation 'my_package.Swish'"),
    ({'module_output_name': 'token_embeddings'},
     "Dense module_output_name 'token_embeddings'"),
])
def test_a_dense_not_ported_is_refused_by_name(models, tmp_path, change,
                                               match):
    d = st_dir(str(tmp_path), models, 'distilbert_dense')
    path = os.path.join(d, '2_Dense', 'config.json')
    with open(path) as f:
        conf = json.load(f)
    with open(path, 'w') as f:
        json.dump({**conf, **change}, f)
    with pytest.raises(NotImplementedError, match=match):
        encoder.encode(SENTENCES, d, 4, 'cpu', 'st')


@pytest.mark.parametrize('order', [
    ['Transformer', 'Dense', 'Pooling'],
    ['Transformer', 'Pooling', 'Normalize', 'Dense'],
    ['Transformer', 'Pooling', 'LayerNorm'],
])
def test_a_module_order_not_ported_is_refused(models, tmp_path, order):
    d = st_dir(str(tmp_path), models, 'distilbert_dense')
    with open(os.path.join(d, 'modules.json'), 'w') as f:
        json.dump([{'idx': k, 'name': str(k), 'path': '',
                    'type': f'sentence_transformers.models.{m}'}
                   for k, m in enumerate(order)], f)
    with pytest.raises(NotImplementedError, match='are not ported'):
        encoder.read_pipeline(d)
