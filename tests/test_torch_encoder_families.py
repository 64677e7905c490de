"""The port's encoder families (``textgcn_tpu_torch/data/encoder.py``,
``encoder_models.py``, ``bpe.py``) against Hugging Face's slow
tokenizers, the JAX package's Sentence Transformers path
(``textgcn_tpu.data.text._st_encode``) and its Flax path
(``encoder_flax.flax_encode``), on the CPU.

Tiny models (hidden 32, 2 layers, 4 heads, inner 64) of each family are
written by ``transformers`` with seeded random weights, over vocabularies
written here: WordPiece for ``bert``, ``distilbert`` and ``mpnet``, and a
byte-level BPE learnt from ``data/dummy``'s text for ``roberta``
(``bpe.learn``).  Nothing
is downloaded.

* Tokenizers: the ids equal the slow ``RobertaTokenizer`` (with and
  without ``add_prefix_space``), ``MPNetTokenizer`` and
  ``DistilBertTokenizer`` on a hypothesis property over Unicode text
  (special tokens inside the text, MPNet's and RoBERTa's ``lstrip``
  ``<mask>``, contractions, whitespace runs, letters and numbers of many
  scripts) with truncation.
* ``st``: the vectors of every family within 1e-5 of ``_st_encode`` for
  Sentence Transformers directories with mean pooling and ``Normalize``,
  cls pooling with a ``max_seq_length`` below the text's length, max
  pooling with ``do_lower_case`` and ``Normalize``, mean and max
  concatenated, and no ``modules.json`` at all; the sentences include
  item text joined with `` [SEP] `` and a capital final sigma.
* ``flax``: bert, distilbert and roberta within 1e-5 of ``flax_encode``,
  from the torch checkpoints and from Flax parameter trees carried by
  ``weights.bert_state_from_flax`` (a sinusoidal DistilBERT among them).
* Refusals by name: a ``Dense`` activation the port does not run,
  ``flax`` on ``mpnet``, a directory whose only tokenizer is a
  SentencePiece model (``xlm-roberta``, the new pooling modes, ``Dense``
  and ``tokenizer.json`` directories run since the multilingual encoders:
  ``tests/test_torch_encoder_multilingual.py``).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from textgcn_tpu_torch.data import bpe, encoder
from textgcn_tpu_torch.weights import bert_state_from_flax

transformers = pytest.importorskip('transformers')
regex = pytest.importorskip('regex')

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DUMMY = os.path.join(REPO, 'data', 'dummy')
GPT2_PATTERN = (r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"""
                r"""| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")
SENTENCES = [
    'the cat sat on the mat',
    'A dog ran fast, didn\'t it?',
    'graph user item graph user item graph user item graph user item',
    'cat',
    '',
    '  Review text from user_3 about asin_7: opinion 4!  ',
    'item number 2 title words a longer description of item 2 with detail',
    'Émile\'s café',
    # the loader joins an item's fields with ' [SEP] '; a capital final
    # sigma tells a whole-text lower() from one per character
    'Item Title [SEP] its Description [SEP] ΟΔΟΣ',
    'ΟΔΟΣ [SEP] Σοφία',
]
ATOL = 1e-5
WORDS = ('the cat sat on mat a dog ran fast graph user item review text '
         'from about asin opinion number title words longer description of '
         'with detail it didn The Cat Graph Item Review caf Émile').split()
SIZES = dict(hidden=32, layers=2, heads=4, inner=64)


def _wordpiece_vocab(specials):
    letters = [chr(c) for c in range(ord('a'), ord('z') + 1)]
    chars = (letters + [c.upper() for c in letters] + list('0123456789')
             + list('_:!.,-#\'?')
             + ['é', 'É', 'ü', 'σ', 'ς', 'ο', 'δ', 'Ο', 'Δ', 'Σ', '中', '文'])
    out = list(specials)
    for w in [*WORDS, *chars, *('##' + c for c in chars), '##s', '##ing']:
        if w not in out:
            out.append(w)
    return out


def _bpe_vocab_and_merges(n_merges: int = 120):
    """A byte-level BPE learnt from ``data/dummy``'s words, cut by GPT-2's
    pattern through ``regex``."""
    with open(os.path.join(DUMMY, 'reviews_text.tsv'), encoding='utf-8') as f:
        corpus = f.read() + ' ' + ' '.join(SENTENCES + WORDS)
    return bpe.learn(regex.findall(GPT2_PATTERN, corpus), n_merges)


def _write_tokenizer(d, family, **kw):
    """The slow Hugging Face tokenizer of ``family`` written to ``d``."""
    os.makedirs(d, exist_ok=True)
    if family == 'roberta':
        vocab, merges = _bpe_vocab_and_merges()
        with open(os.path.join(d, 'vocab.json'), 'w') as f:
            json.dump(vocab, f)
        with open(os.path.join(d, 'merges.txt'), 'w') as f:
            f.write('#version: 0.2\n' + ''.join(f'{a} {b}\n'
                                                 for a, b in merges))
        tok = transformers.RobertaTokenizer(
            os.path.join(d, 'vocab.json'), os.path.join(d, 'merges.txt'),
            **kw)
    else:
        specials = (['<s>', '<pad>', '</s>', '<unk>', '[UNK]', '<mask>']
                    if family == 'mpnet'
                    else ['[PAD]', '[UNK]', '[CLS]', '[SEP]', '[MASK]'])
        with open(os.path.join(d, 'vocab.txt'), 'w') as f:
            f.write('\n'.join(_wordpiece_vocab(specials)) + '\n')
        cls = {'bert': transformers.BertTokenizer,
               'distilbert': transformers.DistilBertTokenizer,
               'mpnet': transformers.MPNetTokenizer}[family]
        tok = cls(os.path.join(d, 'vocab.txt'), **kw)
    tok.save_pretrained(d)
    return tok


def _config(family, vocab_size, **kw):
    h, n, a, i = (SIZES[k] for k in ('hidden', 'layers', 'heads', 'inner'))
    if family == 'distilbert':
        return transformers.DistilBertConfig(
            vocab_size=vocab_size, dim=h, n_layers=n, n_heads=a,
            hidden_dim=i, max_position_embeddings=64, **kw)
    cls = {'bert': transformers.BertConfig,
           'roberta': transformers.RobertaConfig,
           'mpnet': transformers.MPNetConfig}[family]
    extra = dict(max_position_embeddings=64) if family == 'bert' else dict(
        max_position_embeddings=66, pad_token_id=1, bos_token_id=0,
        eos_token_id=2)
    if family == 'roberta':
        extra['type_vocab_size'] = 1
    return cls(vocab_size=vocab_size, hidden_size=h, num_hidden_layers=n,
               num_attention_heads=a, intermediate_size=i, **extra, **kw)


def _write_model(d, family, seed=0):
    tok = _write_tokenizer(d, family)
    torch.manual_seed(seed)
    cls = {'bert': transformers.BertModel,
           'distilbert': transformers.DistilBertModel,
           'roberta': transformers.RobertaModel,
           'mpnet': transformers.MPNetModel}[family]
    model = cls(_config(family, len(tok)))
    with torch.no_grad():
        # a visible position table and relative bias, not init's zeros
        for name, p in model.named_parameters():
            if 'relative_attention_bias' in name or 'LayerNorm.bias' in name:
                p.normal_(0, 0.5)
    model.save_pretrained(d)
    return d


FAMILIES = ('bert', 'distilbert', 'roberta', 'mpnet')


@pytest.fixture(scope='module')
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp('families')
    return {f: _write_model(str(root / f), f, seed=k)
            for k, f in enumerate(FAMILIES)}


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


# --- the tokenizers ------------------------------------------------------------

TOKENIZERS = {
    'roberta': ('roberta', {}),
    'roberta_prefix': ('roberta', {'add_prefix_space': True}),
    'mpnet': ('mpnet', {}),
    # a special token beside the named ones, kept whole (all-mpnet-base-v2
    # lists <unk> in added_tokens_decoder beside its [UNK])
    'mpnet_added': ('mpnet', {'additional_special_tokens': ['<unk>']}),
    'distilbert': ('distilbert', {}),
}


@pytest.fixture(scope='module')
def tokenizer_pairs(tmp_path_factory):
    out = {}
    for name, (family, kw) in TOKENIZERS.items():
        d = str(tmp_path_factory.mktemp(f'tok_{name}'))
        hf = _write_tokenizer(d, family, **kw)
        out[name] = (hf, encoder.load_tokenizer(d, family))
    return out


PIECES = ['a', 'the', 'cat', 'Graph', 'ITEM', 'items', "'s", "'t", "'re",
          "'ve", "'m", "'ll", "'d", "'S", "'", 'it', 'didn', 'é', 'é',
          'Émile', 'Σοφ', '中文', '٣٤',
          'Ⅷ', '½', '42', '7', '!', '?!', ',', '.', '#$', '¿',
          '\U0001f600', '\x00', '\x1c', '​', '﻿', ' ', '  ', '\t',
          '\n', '\r\n', '　', ' ', ' ', '\x85', '<s>', '</s>',
          '<pad>', '<unk>', '<mask>', ' <mask>', '<mask> ', '[UNK]', '[CLS]',
          '[SEP]', '[MASK]', '[PAD]', '<S>', 'x' * 101]
UNICODE = st.one_of(
    st.lists(st.sampled_from(PIECES), max_size=30).map(''.join),
    st.text(st.characters(max_codepoint=127), max_size=30),
    st.text(st.characters(exclude_categories=('Cn', 'Cs')), max_size=30))


@pytest.mark.parametrize('name', TOKENIZERS)
@settings(max_examples=150, deadline=None, derandomize=True)
@given(text=UNICODE, max_length=st.sampled_from([2, 5, 12, 512]))
def test_ids_equal_the_slow_tokenizers(tokenizer_pairs, name, text,
                                       max_length):
    hf, port = tokenizer_pairs[name]
    want = hf(text, truncation=True, max_length=max_length)['input_ids']
    assert port.encode(text, max_length) == want, (text, max_length)


def test_the_pretokenizer_is_gpt2s_pattern():
    texts = ["it's  a   test\t\tof  'em", '  x', 'a  b',
             "x'sy 'S'LL", '12ab!!c  ', '٣٤٥a½']
    for t in texts:
        assert bpe.pretokenize(t) == regex.findall(GPT2_PATTERN, t), t


# --- Sentence Transformers ------------------------------------------------------

PIPELINES = {
    # pooling, Normalize, sentence_bert_config
    'mean_normalize': (['mean'], True, {'max_seq_length': 256}),
    'cls_short': (['cls'], False, {'max_seq_length': 8}),
    'max_lower_normalize': (['max'], True, {'max_seq_length': 48,
                                            'do_lower_case': True}),
    'mean_max': (['mean', 'max'], False, {}),
    'no_modules': None,
}


def _st_dir(root, model_dir, name):
    """A Sentence Transformers directory over ``model_dir``'s files."""
    d = os.path.join(root, name)
    shutil.copytree(model_dir, d)
    spec = PIPELINES[name]
    if spec is None:
        return d
    modes, normalize, sbert = spec
    modules = [{'idx': 0, 'name': '0', 'path': '',
                'type': 'sentence_transformers.models.Transformer'},
               {'idx': 1, 'name': '1', 'path': '1_Pooling',
                'type': 'sentence_transformers.models.Pooling'}]
    if normalize:
        modules.append({'idx': 2, 'name': '2', 'path': '2_Normalize',
                        'type': 'sentence_transformers.models.Normalize'})
        os.makedirs(os.path.join(d, '2_Normalize'))
    with open(os.path.join(d, 'modules.json'), 'w') as f:
        json.dump(modules, f)
    os.makedirs(os.path.join(d, '1_Pooling'))
    pooling = {'word_embedding_dimension': SIZES['hidden']}
    keys = {'cls': 'cls_token', 'mean': 'mean_tokens', 'max': 'max_tokens',
            'sqrt': 'mean_sqrt_len_tokens'}
    pooling.update({f'pooling_mode_{v}': k in modes for k, v in keys.items()})
    with open(os.path.join(d, '1_Pooling', 'config.json'), 'w') as f:
        json.dump(pooling, f)
    with open(os.path.join(d, 'sentence_bert_config.json'), 'w') as f:
        json.dump(sbert, f)
    return d


@pytest.mark.parametrize('pipeline', PIPELINES)
@pytest.mark.parametrize('family', FAMILIES)
def test_st_matches_sentence_transformers(models, tmp_path, family,
                                          pipeline):
    from textgcn_tpu.data.text import _st_encode
    d = _st_dir(str(tmp_path), models[family], pipeline)
    want = _st_encode(SENTENCES, d, 3)
    for backend in ('st', 'auto'):
        got = encoder.encode(SENTENCES, d, 3, 'cpu', backend)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if PIPELINES[pipeline] and PIPELINES[pipeline][1]:
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1,
                                   atol=1e-6)


def test_st_cuts_at_max_seq_length(models, tmp_path):
    d = _st_dir(str(tmp_path), models['mpnet'], 'cls_short')
    tok, model, max_length, pipe = encoder.load_sentence_encoder(d, 'cpu')
    assert (max_length, pipe.pooling, pipe.normalize) == (8, ('cls',), False)
    ids, mask = tok(SENTENCES, max_length)
    assert ids.shape[1] == 8 and model.model_type == 'mpnet'


# --- the Flax recipe ------------------------------------------------------------

def _flax_encode(sentences, model_dir, batch_size):
    from textgcn_tpu.data.encoder_flax import flax_encode
    return flax_encode(sentences, model_dir, batch_size=batch_size)


@pytest.mark.parametrize('family', ['bert', 'distilbert', 'roberta'])
def test_flax_matches_flax_encode(models, family):
    want = _flax_encode(SENTENCES, models[family], 4)
    got = encoder.encode(SENTENCES, models[family], 4, 'cpu', 'flax')
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize('family', ['distilbert_sinusoidal', 'roberta'])
def test_flax_parameters_carry_across(models, tmp_path, family):
    """Random Flax weights (no torch checkpoint): ``bert_state_from_flax``
    gives the port the same vectors."""
    import jax
    base = family.split('_')[0]
    d = str(tmp_path / family)
    tok = _write_tokenizer(d, base)
    kw = {'sinusoidal_pos_embds': True} if 'sinusoidal' in family else {}
    cfg = _config(base, len(tok), **kw)
    cls = {'distilbert': transformers.FlaxDistilBertModel,
           'roberta': transformers.FlaxRobertaModel}[base]
    cls(cfg, seed=5).save_pretrained(d)
    params = jax.tree.map(np.asarray, cls.from_pretrained(d).params)
    state = bert_state_from_flax(params)
    if kw:
        assert 'embeddings.position_embeddings.weight' not in state
    tok, model, max_length = encoder.load_encoder(d, 'cpu', state=state)
    got = encoder.encode_with(tok, model, max_length, SENTENCES, 4)
    np.testing.assert_allclose(got, _flax_encode(SENTENCES, d, 4),
                               atol=ATOL, rtol=0)


# --- refusals -------------------------------------------------------------------

def test_other_refusals(models, tmp_path):
    d = _st_dir(str(tmp_path), models['bert'], 'mean_normalize')
    with open(os.path.join(d, 'modules.json')) as f:
        modules = json.load(f)
    modules.insert(2, {'idx': 2, 'name': '2', 'path': '2_Dense',
                       'type': 'sentence_transformers.models.Dense'})
    with open(os.path.join(d, 'modules.json'), 'w') as f:
        json.dump(modules, f)
    os.makedirs(os.path.join(d, '2_Dense'))
    with open(os.path.join(d, '2_Dense', 'config.json'), 'w') as f:
        json.dump({'in_features': SIZES['hidden'], 'out_features': 8,
                   'activation_function':
                       'torch.nn.modules.activation.Softplus'}, f)
    with pytest.raises(NotImplementedError,
                       match="Dense activation 'torch.nn.modules"
                             ".activation.Softplus'"):
        encoder.encode(SENTENCES, d, 4, 'cpu', 'st')
    with pytest.raises(NotImplementedError, match='mpnet has no Flax'):
        encoder.encode(SENTENCES, models['mpnet'], 4, 'cpu', 'flax')
    only = tmp_path / 'spiece_only'
    shutil.copytree(models['roberta'], only)
    for name in ('vocab.json', 'merges.txt'):
        os.remove(only / name)
    (only / 'spiece.model').write_bytes(b'\n\x05')
    with pytest.raises(NotImplementedError,
                       match='SentencePiece model spiece.model'):
        encoder.load_tokenizer(str(only), 'roberta')
