"""The port's ``tokenizer.json`` reader (``textgcn_tpu_torch/data/
tokenizer_json.py``, ``unicode_classes.py``) against the Hugging Face
``tokenizers`` library and ``AutoTokenizer``'s fast tokenizers, on the CPU.

Three tokenizer directories are written here by ``tokenizers`` (nothing is
downloaded) and saved through ``transformers``' fast tokenizer classes:

* ``wordpiece``: WordPiece trained on ``data/dummy``'s text and a few
  multilingual lines, ``BertNormalizer``, ``BertPreTokenizer``,
  ``[CLS] $A [SEP]``;
* ``bytelevel``: a byte-level BPE trained the same way, ``ByteLevel``,
  ``RobertaProcessing``, an ``lstrip`` ``<mask>``;
* ``unigram``: ``UnigramTrainer`` on the same text with XLM-RoBERTa's
  chain: ``Precompiled`` (a charsmap of NFKC mappings built by
  ``tests/helpers/torch_charsmap.py``) then ``Replace(" {2,}", " ")``,
  ``Metaspace``, ``<s> $A </s>``, a normalized ``lstrip`` ``<mask>``.

* The ids equal ``Tokenizer.encode``'s and ``AutoTokenizer``'s (with
  truncation, and padded batches) on a hypothesis property over Unicode
  text: combining marks, Hangul syllables and jamo, Devanagari, CJK,
  full-width forms, emoji with ZWJ, flags, whitespace runs, controls and
  the special tokens inside the text.
* Four more tokenizers cover the other components (every normalizer and
  pre-tokenizer, BPE's unknowns, byte fallback, prefix and suffix,
  ``ignore_merges``, Unigram's byte fallback, ``single_word``, ``rstrip``,
  Metaspace's ``first`` and ``never``, Split's behaviours and patterns).
* ``Precompiled`` against ``tokenizers.normalizers.Precompiled``; the
  old Unicode classes of ``tokenizers`` over every assigned code point.
* Every component that is not ported raises ``NotImplementedError``
  naming it.
"""

import copy
import json
import os
import sys
import unicodedata

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from helpers.torch_charsmap import charsmap, nfkc_mappings
from textgcn_tpu_torch.data import tokenizer_json as tj
from textgcn_tpu_torch.data import unicode_classes as uc

tokenizers = pytest.importorskip('tokenizers')
transformers = pytest.importorskip('transformers')
from tokenizers import (AddedToken, Regex, Tokenizer, models,  # noqa: E402
                        normalizers as N, pre_tokenizers as P, processors,
                        trainers)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DUMMY = os.path.join(REPO, 'data', 'dummy')
MULTILINGUAL = [
    "\u00c9mile's caf\u00e9, na\u00efve fa\u00e7ade",
    '\u0395\u03bb\u03bb\u03b7\u03bd\u03b9\u03ba\u03ac '
    '\u039f\u0394\u039f\u03a3 \u03a3\u03bf\u03c6\u03af\u03b1',
    '\u0440\u0443\u0441\u0441\u043a\u0438\u0439 '
    '\u0442\u0435\u043a\u0441\u0442',
    '\ud55c\uad6d\uc5b4 \ud14d\uc2a4\ud2b8',
    '\u0939\u093f\u0928\u094d\u0926\u0940 \u092a\u093e\u0920',
    '\u4e2d\u6587\u6587\u672c\u793a\u4f8b',
    '\uff46\uff55\uff4c\uff4c \uff21\uff22\uff23', '\ufb01ne \ufb02ow',
    'the cat sat'] * 3


def corpus() -> list[str]:
    lines = []
    for name in ('reviews_text.tsv', 'meta_synced.tsv'):
        with open(os.path.join(DUMMY, name), encoding='utf-8') as f:
            lines += f.read().split('\n')
    return lines + MULTILINGUAL


def _bert_like():
    tok = Tokenizer(models.WordPiece(unk_token='[UNK]'))
    tok.normalizer = N.BertNormalizer(lowercase=True)
    tok.pre_tokenizer = P.BertPreTokenizer()
    tok.train_from_iterator(corpus(), trainers.WordPieceTrainer(
        vocab_size=400,
        special_tokens=['[PAD]', '[UNK]', '[CLS]', '[SEP]', '[MASK]']))
    v = tok.get_vocab()
    tok.post_processor = processors.TemplateProcessing(
        single='[CLS] $A [SEP]',
        special_tokens=[('[CLS]', v['[CLS]']), ('[SEP]', v['[SEP]'])])
    return tok, transformers.BertTokenizerFast


def _byte_level():
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = P.ByteLevel(add_prefix_space=False)
    tok.train_from_iterator(corpus(), trainers.BpeTrainer(
        vocab_size=400, initial_alphabet=P.ByteLevel.alphabet(),
        special_tokens=['<s>', '<pad>', '</s>', '<unk>']))
    tok.add_special_tokens([AddedToken('<mask>', lstrip=True,
                                       normalized=False)])
    v = tok.get_vocab()
    tok.post_processor = processors.RobertaProcessing(
        ('</s>', v['</s>']), ('<s>', v['<s>']))
    return tok, transformers.RobertaTokenizerFast


def xlmr_unigram(vocab_size: int = 300):
    """A Unigram tokenizer with XLM-RoBERTa's components, trained on
    ``corpus()``."""
    tok = Tokenizer(models.Unigram())
    tok.normalizer = N.Sequence([
        N.Precompiled(charsmap(nfkc_mappings())),
        N.Replace(Regex(' {2,}'), ' ')])
    tok.pre_tokenizer = P.Metaspace()
    tok.train_from_iterator(corpus(), trainers.UnigramTrainer(
        vocab_size=vocab_size, unk_token='<unk>',
        special_tokens=['<s>', '<pad>', '</s>', '<unk>']))
    tok.add_special_tokens([AddedToken('<mask>', lstrip=True,
                                       normalized=True)])
    v = tok.get_vocab()
    tok.post_processor = processors.TemplateProcessing(
        single='<s> $A </s>',
        special_tokens=[('<s>', v['<s>']), ('</s>', v['</s>'])])
    return tok, transformers.XLMRobertaTokenizerFast


SPECIALS = {
    'wordpiece': dict(unk_token='[UNK]', sep_token='[SEP]',
                      pad_token='[PAD]', cls_token='[CLS]',
                      mask_token='[MASK]'),
    'bytelevel': dict(bos_token='<s>', eos_token='</s>', unk_token='<unk>',
                      sep_token='</s>', pad_token='<pad>', cls_token='<s>',
                      mask_token='<mask>'),
}
SPECIALS['unigram'] = SPECIALS['bytelevel']
KINDS = {'wordpiece': _bert_like, 'bytelevel': _byte_level,
            'unigram': xlmr_unigram}


def save_fast(tok, cls, d, specials, model_max_length=512):
    """``tok`` saved through the fast tokenizer class ``cls``:
    ``tokenizer.json``, ``tokenizer_config.json`` and
    ``special_tokens_map.json``."""
    fast = cls(tokenizer_object=tok, model_max_length=model_max_length,
               **specials)
    fast.save_pretrained(d)
    return d


@pytest.fixture(scope='module')
def dirs(tmp_path_factory):
    out = {}
    for name, write in KINDS.items():
        d = str(tmp_path_factory.mktemp(name))
        tok, cls = write()
        out[name] = save_fast(tok, cls, d, SPECIALS[name])
    return out


@pytest.fixture(scope='module')
def triples(dirs):
    """``(tokenizers.Tokenizer, AutoTokenizer, the port)`` per directory."""
    return {name: (Tokenizer.from_file(os.path.join(d, 'tokenizer.json')),
                   transformers.AutoTokenizer.from_pretrained(d),
                   tj.JsonTokenizer.from_dir(d))
            for name, d in dirs.items()}


PIECES = [
    'a', 'the', 'cat', 'Graph', 'ITEM', "'s", "'t", '\u00e9', 'e\u0301',
    '\u00c9mile', '\u039f\u0394\u039f\u03a3', '\u03a3\u03bf\u03c6',
    '\u0440\u0443\u0441', '\u4e2d\u6587', '\ud55c\uad6d\uc5b4',
    '\uac01', '\u1100\u1161\u11a8', '\u1100', '\u1161', '\u11a8',
    '\u0939\u093f\u0928\u094d\u0926\u0940', '\u0915\u094d\u0937',
    '\u0915\u093f', '\ufb01', '\uff46\uff55\uff4c\uff4c', '\uff21',
    '\uff21\u0301', '\u2460', '\u00bd', '\u2167', '\u3231', '42',
    '\u0663', '!', '?!', ',', '.', '\u00bf', '\u0964', '\U0001F600',
    '\U0001F468\u200d\U0001F469\u200d\U0001F467', '\U0001F44D\U0001F3FD',
    '\U0001F1E6\U0001F1E7', '\u2764\ufe0f', '\u00a9\u200d\u2122', '\x00',
    '\x1c', '\u200b', '\ufeff', '\u00ad', '\u200d', ' ', '  ', '   ',
    '\t', '\n', '\r\n', '\u3000', '\u00a0', '\u2009', '\x85', '\u2028',
    '<s>', '</s>', '<pad>', '<unk>', '<mask>', ' <mask>', '<mask> ', '[UNK]',
    '[CLS]', '[SEP]', '[MASK]', '[PAD]', 'x' * 101, '\u0301',
    'a\u0301\u0301', '\u0903', 'a\u0903', '\u0600', '\u0600a', '\u01c5',
    '\u0130', '\u0345', '\U0001D400', '\U0001D7D8', '\u00df', '\u1e9e',
    '\U00010781', '\u32ff']
UNICODE = st.one_of(
    st.lists(st.sampled_from(PIECES), max_size=30).map(''.join),
    st.text(st.characters(max_codepoint=127), max_size=30),
    st.text(st.characters(exclude_categories=('Cn', 'Cs')), max_size=30))


@pytest.mark.parametrize('name', KINDS)
@settings(max_examples=200, deadline=None, derandomize=True)
@given(text=UNICODE, max_length=st.sampled_from([2, 3, 5, 12, 512]))
def test_ids_equal_the_fast_tokenizers(triples, name, text, max_length):
    raw, fast, port = triples[name]
    assert port.encode(text) == raw.encode(text).ids, text
    want = fast(text, truncation=True, max_length=max_length)['input_ids']
    assert port.encode(text, max_length) == want, (text, max_length)


@pytest.mark.parametrize('name', KINDS)
def test_padded_batches_equal_the_fast_tokenizers(triples, name):
    _, fast, port = triples[name]
    texts = corpus()[:40] + MULTILINGUAL + ['', ' <mask> x']
    ids, mask = port(texts, 16)
    want = fast(texts, padding='longest', truncation=True, max_length=16)
    np.testing.assert_array_equal(ids, want['input_ids'])
    np.testing.assert_array_equal(mask, want['attention_mask'])
    assert port.pad_id == fast.pad_token_id
    assert port.max_length() == 512


# --- the other components ------------------------------------------------

def _kitchen_sinks():
    """Four tokenizers over the components the three above leave out."""
    out = {}
    tok = Tokenizer(models.WordPiece(unk_token='[UNK]',
                                     max_input_chars_per_word=12))
    tok.normalizer = N.Sequence([N.NFKD(), N.StripAccents(), N.Lowercase(),
                                 N.Strip(), N.Replace('ab', 'X'),
                                 N.Prepend('#')])
    tok.pre_tokenizer = P.Sequence([
        P.Whitespace(), P.Digits(individual_digits=True),
        P.Punctuation(behavior='contiguous')])
    tok.train_from_iterator(corpus(), trainers.WordPieceTrainer(
        vocab_size=300, special_tokens=['[UNK]', '[CLS]', '[SEP]']))
    tok.add_tokens([AddedToken('item', single_word=True),
                    AddedToken('xx', rstrip=True, lstrip=True,
                               normalized=True),
                    AddedToken('ΟΔ', normalized=False)])
    v = tok.get_vocab()
    tok.post_processor = processors.BertProcessing(
        ('[SEP]', v['[SEP]']), ('[CLS]', v['[CLS]']))
    out['wordpiece_sequences'] = tok

    fallback = [f'<0x{b:02X}>' for b in range(0, 256, 3)]
    tok = Tokenizer(models.BPE(
        unk_token='<unk>', fuse_unk=True, byte_fallback=True,
        continuing_subword_prefix='##', end_of_word_suffix='</w>'))
    tok.normalizer = N.Sequence([N.NFC(), N.Replace(Regex(r'\s+'), ' ')])
    tok.pre_tokenizer = P.Sequence([
        P.Split(Regex(r'\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+'),
                behavior='isolated'),
        P.Metaspace(prepend_scheme='first', split=False)])
    tok.train_from_iterator(corpus(), trainers.BpeTrainer(
        vocab_size=500, special_tokens=['<unk>', '<s>', '</s>', *fallback],
        continuing_subword_prefix='##', end_of_word_suffix='</w>'))
    v = tok.get_vocab()
    tok.post_processor = processors.Sequence([
        processors.ByteLevel(),
        processors.TemplateProcessing(
            single='<s> $A </s> </s>',
            special_tokens=[('<s>', v['<s>']), ('</s>', v['</s>'])])])
    out['bpe_fallback'] = tok

    tok = Tokenizer(models.Unigram())
    tok.normalizer = N.Sequence([
        N.NFKC(), N.BertNormalizer(lowercase=False, strip_accents=True)])
    tok.pre_tokenizer = P.Sequence([
        P.WhitespaceSplit(), P.Split('e', behavior='merged_with_previous'),
        P.Split(Regex('[aeiou]'), behavior='merged_with_next', invert=True),
        P.Metaspace(prepend_scheme='first')])
    tok.train_from_iterator(corpus(), trainers.UnigramTrainer(
        vocab_size=300, unk_token='<unk>', special_tokens=[
            '<unk>', '<s>', *(f'<0x{b:02X}>' for b in range(256))]))
    out['unigram_first'] = tok

    tok = Tokenizer(models.BPE(ignore_merges=True))
    tok.normalizer = N.NFD()
    tok.pre_tokenizer = P.Sequence([
        P.Split(Regex(r'[.,!?]+'), behavior='removed'),
        P.ByteLevel(add_prefix_space=True, use_regex=False),
        P.Metaspace(prepend_scheme='never')])
    tok.train_from_iterator(corpus(), trainers.BpeTrainer(
        vocab_size=400, initial_alphabet=P.ByteLevel.alphabet(),
        special_tokens=['<s>']))
    out['bpe_ignore_merges'] = tok
    return out


@pytest.fixture(scope='module')
def sinks():
    """``(tokenizers, the port)`` per tokenizer, both read from its JSON
    text."""
    out = {}
    for name, tok in _kitchen_sinks().items():
        text = tok.to_str()
        if name == 'unigram_first':
            # the trainer takes no byte_fallback: switch it on in the file
            spec = json.loads(text)
            spec['model']['byte_fallback'] = True
            text = json.dumps(spec)
        out[name] = (Tokenizer.from_str(text),
                     tj.JsonTokenizer(tj.loads(text), pad_token=None))
    return out


@pytest.mark.parametrize('name', ['wordpiece_sequences', 'bpe_fallback',
                                  'unigram_first', 'bpe_ignore_merges'])
@settings(max_examples=150, deadline=None, derandomize=True)
@given(text=UNICODE)
def test_every_component_equals_tokenizers(sinks, name, text):
    raw, port = sinks[name]
    assert port.encode(text) == raw.encode(text).ids, text


def test_the_options_are_switched_on(sinks):
    spec = sinks['unigram_first'][1].spec
    assert spec['model']['byte_fallback'] is True
    raw, port = sinks['unigram_first']
    assert any(t.startswith('<0x') for t in raw.encode('ǅ𝐀 é').tokens)
    raw, port = sinks['bpe_fallback']
    tokens = raw.encode('a\U0001F600\U0001F600b').tokens
    assert '<unk>' in tokens and '<0x00>' not in tokens


PATTERNS = [r"\p{L}+|\p{N}{1,3}", r"\s+(?!\S)|\s+", r"[^\s\p{L}\p{N}]+",
            r"\w+|[^\w\s]+", r"\d+", r" ?\p{Lu}\p{Ll}*", r"[a-c\-]+",
            r"(?:ab|cd)+?x", r"\.{2,}", r" {2,}", r"[\p{P}\p{S}]",
            r"\P{L}+", r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"]


@pytest.mark.parametrize('pattern', PATTERNS)
@settings(max_examples=60, deadline=None, derandomize=True)
@given(text=UNICODE)
def test_regex_patterns_split_as_oniguruma(pattern, text):
    for behavior in ('isolated', 'contiguous', 'merged_with_next'):
        raw = P.Split(Regex(pattern), behavior=behavior)
        port = tj.build_pre_tokenizer({
            'type': 'Split', 'pattern': {'Regex': pattern},
            'behavior': behavior.title().replace('_', ''), 'invert': False})
        want = [p for p, _ in raw.pre_tokenize_str(text)]
        assert [p for p, _ in port([(text, 1)])] == want, (pattern, text)


def test_truncation_below_the_added_tokens(triples):
    raw, fast, port = triples['unigram']
    enc = raw.encode('the cat sat on the mat').ids
    assert port.encode('the cat sat on the mat', 1) == enc
    assert port.encode('the cat sat on the mat', 2) == [enc[0], enc[-1]]


# --- the charsmap and the Unicode classes ----------------------------------

@pytest.fixture(scope='module')
def precompiled():
    mapping = nfkc_mappings()
    blob = charsmap(mapping)
    return mapping, N.Precompiled(blob), tj.Charsmap(blob)


def test_the_charsmap_reads_back(precompiled):
    mapping, _, port = precompiled
    assert port.table == mapping
    # keys of several code points, one a prefix of another
    assert sum(len(k) > 1 for k in mapping) > 30
    assert port.first_match('Ａ\u0301x') == 'A'


CLUSTERS = st.lists(st.sampled_from([
    *nfkc_mappings(), 'a', 'e', '\uff21', '\u0301', '\u0308', '\u0327',
    '\u0903', '\u200d', '\u200c', '\ufe0e', '\ufe0f', '\U0001F3FD', '\r',
    '\n', '\u0600', '\u0d4e', '\uac01', '\u1100', '\u1161', '\u11a8',
    '\U0001F1E6', '\U0001F1E7', '\u00a9', '\u2122', '\U0001F600',
    '\uff9e', '\uff76', 'x', ' ', '\x01', '\u0e01', '\u0e33', '\u0915',
    '\u094d', '\u0930', '\u0941', '\u093c', '\u0995', '\u09cd', '\u0b4d',
    '\u0d4d', '\u0d15']),
    max_size=25).map(''.join)


@settings(max_examples=400, deadline=None, derandomize=True)
@given(text=st.one_of(CLUSTERS, UNICODE))
def test_precompiled_equals_tokenizers(precompiled, text):
    _, raw, port = precompiled
    assert port(text) == raw.normalize_str(text), text


def _assigned() -> str:
    return ''.join(chr(cp) for cp in range(sys.maxunicode + 1)
                   if not 0xD800 <= cp <= 0xDFFF
                   and unicodedata.category(chr(cp)) not in ('Cn', 'Co')
                   and chr(cp) != 'a')


@pytest.fixture(scope='module')
def every_char():
    """Every assigned code point (no private use), each between two
    ``a``."""
    return 'a' + 'a'.join(_assigned()) + 'a'


@pytest.mark.parametrize('kind, spec', [
    ('normalizer', {'type': 'BertNormalizer', 'clean_text': True,
                    'handle_chinese_chars': True, 'strip_accents': True,
                    'lowercase': False}),
    ('normalizer', {'type': 'StripAccents'}),
    ('normalizer', {'type': 'NFD'}), ('normalizer', {'type': 'NFKD'}),
    ('normalizer', {'type': 'NFKC'}), ('normalizer', {'type': 'NFC'}),
    ('normalizer', {'type': 'Lowercase'}),
    ('pre_tokenizer', {'type': 'BertPreTokenizer'}),
    ('pre_tokenizer', {'type': 'Whitespace'}),
    ('pre_tokenizer', {'type': 'Digits', 'individual_digits': False}),
])
def test_the_unicode_classes_are_tokenizers(every_char, kind, spec):
    """The old tables of ``unicode_classes`` hold over every assigned code
    point: each component, ported, gives ``tokenizers``' output."""
    if kind == 'normalizer':
        raw = getattr(N, spec['type'])(**{k: v for k, v in spec.items()
                                          if k != 'type'})
        assert tj.build_normalizer(spec)(every_char) \
            == raw.normalize_str(every_char)
    else:
        raw = getattr(P, spec['type'])(**{k: v for k, v in spec.items()
                                          if k != 'type'})
        want = [p for p, _ in raw.pre_tokenize_str(every_char)]
        got = [p for p, _ in tj.build_pre_tokenizer(spec)(
            [(every_char, 1)])]
        assert got == want


def test_graphemes_join_what_uax29_joins():
    assert uc.graphemes('e\u0301a\r\nb') == ['e\u0301', 'a', '\r\n', 'b']
    assert uc.graphemes('\U0001F1E6\U0001F1E7\U0001F1E8') == [
        '\U0001F1E6\U0001F1E7', '\U0001F1E8']
    assert uc.graphemes('각각\u0600a\x01\u0301') == [
        '각', '각', '\u0600a', '\x01', '\u0301']
    assert uc.graphemes('\U0001F468\u200d\U0001F469x') == [
        '\U0001F468\u200d\U0001F469', 'x']
    # Indic conjuncts (GB9c): a consonant, a virama, a consonant; not
    # across ZWNJ
    assert uc.graphemes('\u0915\u094d\u0958\u0301x') == [
        '\u0915\u094d\u0958\u0301', 'x']
    assert uc.graphemes('\u0930\u200c\u094d\u0958') == [
        '\u0930\u200c\u094d', '\u0958']


# --- refusals --------------------------------------------------------------

def _refusal(spec, path, value):
    spec = copy.deepcopy(spec)
    node = spec
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = value
    return spec


@pytest.mark.parametrize('path, value, match', [
    (('normalizer',), {'type': 'Nmt'}, "normalizer not ported: 'Nmt'"),
    (('normalizer',), {'type': 'Replace', 'pattern': {'Regex': '^a'},
                       'content': 'b'}, "anchor '\\^'"),
    (('normalizer',), {'type': 'Replace', 'pattern': {'Regex': '(a)\\1'},
                       'content': 'b'}, 'escape \\\\1'),
    (('normalizer',), {'type': 'Replace', 'pattern': {'Regex': '(?i)a'},
                       'content': 'b'}, 'group'),
    (('normalizer',), {'type': 'Replace', 'pattern': {'Regex': 'a*+'},
                       'content': 'b'}, 'possessive'),
    (('normalizer',), {'type': 'Replace', 'pattern': {'Regex': 'a*'},
                       'content': 'b'}, 'empty string'),
    (('normalizer',), {'type': 'Replace', 'pattern': {'Regex': '[a[b]]'},
                       'content': 'b'}, 'nested'),
    (('normalizer',), {'type': 'Replace',
                       'pattern': {'Regex': '\\p{Greek}'}, 'content': 'b'},
     "property 'Greek'"),
    (('normalizer',), {'type': 'NFC', 'extra': 1}, "'extra'"),
    (('pre_tokenizer',), {'type': 'UnicodeScripts'},
     "pre_tokenizer not ported: 'UnicodeScripts'"),
    (('pre_tokenizer',), {'type': 'CharDelimiterSplit', 'delimiter': 'x'},
     "'CharDelimiterSplit'"),
    (('pre_tokenizer',), {'type': 'Metaspace', 'replacement': '_',
                          'prepend_scheme': 'sometimes', 'split': True},
     "prepend_scheme not ported: 'sometimes'"),
    (('pre_tokenizer',), {'type': 'Split', 'pattern': {'Regex': 'a'},
                          'behavior': 'Sideways', 'invert': False},
     "split behavior not ported: 'Sideways'"),
    (('model',), {'type': 'WordLevel', 'vocab': {}, 'unk_token': 'x'},
     "model not ported: 'WordLevel'"),
    (('model', 'dropout'), 0.1, 'BPE dropout not ported: 0.1'),
    (('post_processor',), {'type': 'Pairwise'},
     "post_processor not ported: 'Pairwise'"),
    (('post_processor', 'single'),
     [{'Sequence': {'id': 'B', 'type_id': 0}}], 'TemplateProcessing sequence'),
    (('added_tokens', 0, 'casefold'), True, 'added_tokens options'),
    (('pretrained',), True, "keys not ported: {'pretrained': True}"),
])
def test_a_component_not_ported_is_refused_by_name(dirs, path, value,
                                                   match):
    name = 'bytelevel' if path[0] == 'model' else 'unigram'
    with open(os.path.join(dirs[name], 'tokenizer.json')) as f:
        spec = json.load(f)
    with pytest.raises(NotImplementedError, match=match):
        tj.JsonTokenizer(_refusal(spec, path, value), pad_token='<pad>')


def test_a_config_that_disagrees_is_refused(dirs, tmp_path):
    for name in ('tokenizer.json', 'special_tokens_map.json'):
        with open(os.path.join(dirs['unigram'], name)) as f:
            (tmp_path / name).write_text(f.read())
    for side in ('padding_side', 'truncation_side'):
        (tmp_path / 'tokenizer_config.json').write_text(json.dumps(
            {side: 'left'}))
        with pytest.raises(NotImplementedError,
                           match=side.replace('_', ' ')):
            tj.JsonTokenizer.from_dir(str(tmp_path))
    (tmp_path / 'tokenizer_config.json').write_text(json.dumps(
        {'added_tokens_decoder': {'9': {'content': '<extra>'}}}))
    with pytest.raises(NotImplementedError, match="'<extra>'"):
        tj.JsonTokenizer.from_dir(str(tmp_path))
    with open(os.path.join(dirs['wordpiece'], 'tokenizer.json')) as f:
        (tmp_path / 'tokenizer.json').write_text(f.read())
    (tmp_path / 'tokenizer_config.json').write_text(json.dumps(
        {'do_lower_case': False}))
    with pytest.raises(NotImplementedError, match='do_lower_case'):
        tj.JsonTokenizer.from_dir(str(tmp_path))
    with open(os.path.join(dirs['bytelevel'], 'tokenizer.json')) as f:
        (tmp_path / 'tokenizer.json').write_text(f.read())
    (tmp_path / 'tokenizer_config.json').write_text(json.dumps(
        {'add_prefix_space': True}))
    with pytest.raises(NotImplementedError, match='add_prefix_space'):
        tj.JsonTokenizer.from_dir(str(tmp_path))
