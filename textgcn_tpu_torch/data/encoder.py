"""The text encoder: BERT, DistilBERT, RoBERTa, XLM-RoBERTa and MPNet in
plain PyTorch, their tokenizers and a checkpoint reader, with no Hugging
Face package.

Two recipes, as ``TEXTGCN_TPU_TEXT_ENCODER`` names them
(``data/text.encode_sentences``):

* ``flax``: the JAX package's ``encoder_flax.flax_encode`` -- the
  transformer, its attention-masked token mean, L2 normalisation (both
  divisions floored at 1e-9), the length capped at 512 tokens and at the
  model's positions.  It runs ``bert``, ``distilbert``, ``roberta`` and
  ``xlm-roberta`` (transformers has no Flax MPNet, so ``mpnet`` is
  refused, as the JAX package's Flax path fails on it).
* ``st`` and ``auto``: Sentence Transformers' semantics
  (``textgcn_tpu/data/text._st_encode``), read from the model directory as
  ``SentenceTransformer`` reads it (``read_pipeline``): the modules of
  ``modules.json`` in order -- the transformer (its directory's
  ``sentence_bert_config.json`` gives ``max_seq_length`` and
  ``do_lower_case``), ``Pooling`` (``mean``, ``cls``, ``max``,
  ``mean_sqrt_len_tokens``, ``weightedmean`` or ``lasttoken``, or several
  concatenated, from its ``config.json``), any number of ``Dense`` modules
  (``nn.Linear`` from their ``config.json`` and weights, then ``Tanh``,
  ``Identity``, ``ReLU`` or ``GELU``; another activation is refused by
  name) and ``Normalize`` where it is listed.  A directory without
  ``modules.json`` gets Sentence Transformers' default: mean pooling, no
  normalisation.  Without a ``max_seq_length`` the limit is the
  tokenizer's ``model_max_length`` capped at the model's positions.  All
  five model types run.

The tokenizer is picked from the directory, as ``AutoTokenizer`` does:
its ``tokenizer.json`` when it has one, whatever the model type
(``tokenizer_json.JsonTokenizer``: the fast tokenizers' ids; WordPiece,
byte-level BPE, SentencePiece Unigram ...); else the slow Hugging Face
tokenizers' ids from the vocabulary files:

* ``BertTokenizer``, WordPiece from ``vocab.txt`` (``bert``,
  ``distilbert``, and ``mpnet`` with ``<s>``/``</s>``/``<pad>``/
  ``<mask>``): special tokens kept whole (one marked ``lstrip`` or
  ``rstrip``, as MPNet's ``<mask>``, eats the whitespace beside it), the
  text cleaned, spaces put around CJK characters, lower-cased and
  accent-stripped where the config says so, split on punctuation, then
  greedy longest-match WordPiece (``[UNK]`` for a word of more than 100
  characters); ``[CLS] ... [SEP]`` (MPNet ``<s> ... </s>``), truncated to
  ``max_length``, padded to the longest row;
* ``bpe.RobertaTokenizer``, byte-level BPE from ``vocab.json`` and
  ``merges.txt`` (``roberta``).

The models are in ``encoder_models.py``, what the tokenizers share in
``tokenizing.py``.  ``read_state`` reads the
weights in the order of each recipe's library (``WEIGHT_FILES``):
``flax`` as ``FlaxAutoModel`` does, ``flax_model.msgpack`` (or its
sharded ``.index.json``; ``flax_msgpack`` decodes them) first, then
torch's files; ``st`` as ``AutoModel`` does, ``model.safetensors`` (read
with numpy: F32, F16, BF16), its index, ``pytorch_model.bin`` (through
``torch.load(weights_only=True)``), its index, and a directory with Flax
weights only is refused with transformers' reason.  Torch keys are taken
with or without the family's prefix (``bert.``, ``distilbert.``,
``roberta.``, ``mpnet.``), a Flax tree with or without its base model's
key; the pooler and any head are ignored.  Under ``auto`` a directory
whose transformer has no torch weights but whose model directory has
Flax ones runs the ``flax`` recipe, as the JAX package's ``auto`` does
when Sentence Transformers fails on it (``encode``).
``resolve_model_dir`` takes ``--bert_model`` as a local
directory, or a name looked up in the Hugging Face cache
(``$HF_HUB_CACHE``, else ``$HF_HOME/hub``, else
``~/.cache/huggingface/hub``: ``models--<org>--<name>/snapshots/*/``);
nothing is fetched.  A directory whose only tokenizer file is a
SentencePiece model (``sentencepiece.bpe.model``, ``spiece.model``) is
refused by name.

Unlike the JAX package, rows are padded to the longest row of their
batch, not to power-of-two buckets: the buckets spare XLA recompiles, and
the padding mask makes the result the same.  Everything runs in float32
(TF32 off) on the entry point's device.
"""

from __future__ import annotations

import json
import logging
import os
import re
import time
import unicodedata
from dataclasses import dataclass

import numpy as np
import torch

from .encoder_models import BertEncoder, bert_name
from .tokenizing import (capped_length, pad_rows, read_json, special_tokens,
                         split_specials, truncate)

log = logging.getLogger('textgcn_tpu_torch')

MAX_LENGTH_CAP = 512
MAX_WORD_CHARS = 100
SPECIAL_DEFAULTS = {'unk_token': '[UNK]', 'sep_token': '[SEP]',
                    'pad_token': '[PAD]', 'cls_token': '[CLS]',
                    'mask_token': '[MASK]'}
# MPNetTokenizer's defaults; its mask token is lstrip
MPNET_SPECIALS = {'bos_token': '<s>', 'eos_token': '</s>',
                  'unk_token': '[UNK]', 'sep_token': '</s>',
                  'pad_token': '<pad>', 'cls_token': '<s>',
                  'mask_token': '<mask>'}
POOLING_MODES = ('cls', 'max', 'mean', 'mean_sqrt_len_tokens',
                 'weightedmean', 'lasttoken')
# Sentence Transformers' legacy pooling keys, in its order
_LEGACY_POOLING = (
    ('pooling_mode_cls_token', 'cls'), ('pooling_mode_max_tokens', 'max'),
    ('pooling_mode_mean_tokens', 'mean'),
    ('pooling_mode_mean_sqrt_len_tokens', 'mean_sqrt_len_tokens'),
    ('pooling_mode_weightedmean_tokens', 'weightedmean'),
    ('pooling_mode_lasttoken', 'lasttoken'))


# ---------------------------------------------------------------------------
# the model directory

def hub_cache_dirs() -> list[str]:
    """Where a Hugging Face cache may hold snapshots, in order."""
    if os.environ.get('HF_HUB_CACHE'):
        return [os.environ['HF_HUB_CACHE']]
    home = os.environ.get('HF_HOME') or os.path.join(
        os.environ.get('XDG_CACHE_HOME')
        or os.path.join(os.path.expanduser('~'), '.cache'), 'huggingface')
    return [os.path.join(home, 'hub')]


def resolve_model_dir(name: str) -> str:
    """The local directory of ``name``: itself when it is a directory, else
    its snapshot in the Hugging Face cache (a bare name is also tried under
    ``sentence-transformers/``, as Sentence Transformers does).  Raises
    ``FileNotFoundError`` naming every path tried."""
    if os.path.isdir(name):
        return name
    repos = [name] if '/' in name else [name, f'sentence-transformers/{name}']
    tried = [name]
    for cache in hub_cache_dirs():
        for repo in repos:
            base = os.path.join(cache, 'models--' + repo.replace('/', '--'))
            snaps = os.path.join(base, 'snapshots')
            tried.append(os.path.join(snaps, '*'))
            if not os.path.isdir(snaps):
                continue
            ref = os.path.join(base, 'refs', 'main')
            if os.path.exists(ref):
                with open(ref) as f:
                    pick = os.path.join(snaps, f.read().strip())
                if os.path.isdir(pick):
                    return pick
            found = sorted(os.listdir(snaps))
            if found:
                return os.path.join(snaps, found[-1])
    raise FileNotFoundError(
        f'text encoder model {name!r} not found (nothing is downloaded); '
        f'tried: {", ".join(tried)}')


# ---------------------------------------------------------------------------
# the tokenizer

def _is_whitespace(ch: str) -> bool:
    return ch in ' \t\n\r' or unicodedata.category(ch) == 'Zs'


def _is_control(ch: str) -> bool:
    return ch not in '\t\n\r' and unicodedata.category(ch).startswith('C')


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith('P')


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def _strip_accents(text: str) -> str:
    return ''.join(c for c in unicodedata.normalize('NFD', text)
                   if unicodedata.category(c) != 'Mn')


def _split_on_punctuation(text: str) -> list[str]:
    out: list[list[str]] = []
    new_word = True
    for ch in text:
        if _is_punctuation(ch):
            out.append([ch])
            new_word = True
        else:
            if new_word:
                out.append([])
            new_word = False
            out[-1].append(ch)
    return [''.join(w) for w in out]


class BertTokenizer:
    """WordPiece ids as the slow Hugging Face ``BertTokenizer`` (or
    ``DistilBertTokenizer``, ``MPNetTokenizer``) gives them, with its
    default basic tokenization (Chinese characters split, no
    ``never_split``) and no added tokens but the special ones."""

    def __init__(self, vocab: dict[str, int], *, do_lower_case: bool = True,
                 strip_accents: bool | None = None,
                 special: dict[str, str] | None = None,
                 added: dict[str, int] | None = None,
                 lstrip: frozenset[str] = frozenset(),
                 rstrip: frozenset[str] = frozenset(),
                 model_max_length: int | None = None):
        self.vocab = {**vocab, **(added or {})}
        self.do_lower_case = do_lower_case
        self.strip_accents = strip_accents
        self.special = {**SPECIAL_DEFAULTS, **(special or {})}
        self.lstrip, self.rstrip = lstrip, rstrip
        self.model_max_length = model_max_length
        # Sentence Transformers' do_lower_case: its Lowercase normalizer, a
        # character at a time, the special tokens kept whole
        self.lower = False
        # kept whole: split off the text first, never lower-cased
        self._whole = set(self.special.values()) | set(added or ())
        specials = '|'.join(map(re.escape, sorted(self._whole, key=len,
                                                  reverse=True)))
        self._specials = re.compile(f'({specials})')
        self._lower = re.compile(f'({specials})|(.+?)')
        self._pieces: dict[str, list[str]] = {}
        self.unk_id = self.vocab[self.special['unk_token']]
        self.cls_id = self.vocab[self.special['cls_token']]
        self.sep_id = self.vocab[self.special['sep_token']]
        self.pad_id = self.vocab[self.special['pad_token']]

    @classmethod
    def from_dir(cls, model_dir: str,
                 model_type: str = 'bert') -> 'BertTokenizer':
        vocab_path = os.path.join(model_dir, 'vocab.txt')
        if not os.path.exists(vocab_path):
            raise FileNotFoundError(f'no vocab.txt in {model_dir}')
        vocab: dict[str, int] = {}
        with open(vocab_path, encoding='utf-8') as f:
            for i, line in enumerate(f):
                vocab[line.rstrip('\n')] = i
        conf = read_json(os.path.join(model_dir, 'tokenizer_config.json'))
        if model_type == 'mpnet':
            defaults, lstrip = MPNET_SPECIALS, frozenset({'mask_token'})
        else:
            defaults, lstrip = SPECIAL_DEFAULTS, frozenset()
        special, added, lstrip, rstrip, mml = special_tokens(
            model_dir, conf, defaults, lstrip)
        unported = {k: conf[k] for k in ('do_basic_tokenize',
                                         'tokenize_chinese_chars')
                    if conf.get(k, True) is not True}
        if conf.get('never_split'):
            unported['never_split'] = conf['never_split']
        if unported:
            raise NotImplementedError(f'{model_dir}: tokenizer settings '
                                      f'not ported: {unported}')
        return cls(vocab, do_lower_case=conf.get('do_lower_case', True),
                   strip_accents=conf.get('strip_accents'), special=special,
                   added=added, lstrip=lstrip, rstrip=rstrip,
                   model_max_length=mml)

    def max_length(self, cap: int = MAX_LENGTH_CAP) -> int:
        """``encoder_flax._model_max_len``: the tokenizer's limit, capped."""
        return capped_length(self.model_max_length, cap)

    # --- the pieces of a text ------------------------------------------------

    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            if ch in '\x00\ufffd' or _is_control(ch):
                continue
            out.append(' ' if _is_whitespace(ch) else ch)
        return ''.join(out)

    def _basic(self, text: str) -> list[str]:
        whole = self._whole
        text = ''.join(f' {c} ' if _is_cjk(ord(c)) else c
                       for c in self._clean(text))
        words = []
        for word in unicodedata.normalize('NFC', text).split():
            if word not in whole:
                if self.do_lower_case:
                    word = word.lower()
                    if self.strip_accents is not False:
                        word = _strip_accents(word)
                elif self.strip_accents:
                    word = _strip_accents(word)
            words.extend([word] if word in whole
                         else _split_on_punctuation(word))
        return ' '.join(words).split()

    def _wordpiece(self, word: str) -> list[str]:
        pieces = self._pieces.get(word)
        if pieces is None:
            pieces = self._pieces[word] = self._wordpiece_of(word)
        return pieces

    def _wordpiece_of(self, word: str) -> list[str]:
        if len(word) > MAX_WORD_CHARS:
            return [self.special['unk_token']]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            while start < end:
                piece = word[start:end] if start == 0 \
                    else '##' + word[start:end]
                if piece in self.vocab:
                    break
                end -= 1
            else:
                return [self.special['unk_token']]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> list[str]:
        if self.do_lower_case or self.lower:
            # one character at a time, as Hugging Face does (so no final
            # sigma)
            text = self._lower.sub(
                lambda m: m.group(1) or m.group(2).lower(), text)
        tokens = []
        parts = split_specials(self._specials, text, self.lstrip,
                               self.rstrip)
        for i, part in enumerate(parts):
            if i % 2:
                tokens.append(part)
            else:
                tokens.extend(p for word in self._basic(part)
                              for p in self._wordpiece(word))
        return tokens

    def encode(self, text: str, max_length: int) -> list[int]:
        """``[CLS] ids [SEP]``, the ids cut to ``max_length - 2``."""
        ids = [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]
        return truncate(ids, self.cls_id, self.sep_id, max_length)

    def __call__(self, sentences: list[str], max_length: int):
        """``(ids, mask)``, int64 ``(B, L)``, padded to the longest row."""
        return pad_rows([self.encode(s, max_length) for s in sentences],
                        self.pad_id)


SENTENCEPIECE_FILES = ('sentencepiece.bpe.model', 'spiece.model')


def load_tokenizer(model_dir: str, model_type: str):
    """The tokenizer of a model directory: its ``tokenizer.json`` when it
    has one; else WordPiece from ``vocab.txt`` (``bert``, ``distilbert``,
    ``mpnet``) or byte-level BPE from ``vocab.json`` and ``merges.txt``
    (``roberta``).  A directory whose only tokenizer is a SentencePiece
    model is refused by name."""
    if os.path.exists(os.path.join(model_dir, 'tokenizer.json')):
        from .tokenizer_json import JsonTokenizer
        return JsonTokenizer.from_dir(model_dir)
    pieces = [f for f in SENTENCEPIECE_FILES
              if os.path.exists(os.path.join(model_dir, f))]
    if pieces:
        raise NotImplementedError(
            f'{model_dir} holds the SentencePiece model {pieces[0]} and no '
            'tokenizer.json: the port reads SentencePiece through '
            'tokenizer.json only')
    if model_type == 'roberta':
        from .bpe import RobertaTokenizer
        return RobertaTokenizer.from_dir(model_dir)
    return BertTokenizer.from_dir(model_dir, model_type)


# ---------------------------------------------------------------------------
# the checkpoint

_SAFETENSORS_DTYPES = {'F32': np.float32, 'F16': np.float16,
                       'BF16': np.uint16}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """The float32 tensors of a ``.safetensors`` file: an 8-byte
    little-endian header length, a JSON header, then the data."""
    with open(path, 'rb') as f:
        blob = f.read()
    n = int.from_bytes(blob[:8], 'little')
    header = json.loads(blob[8:8 + n])
    out = {}
    for name, meta in header.items():
        if name == '__metadata__':
            continue
        dtype = meta['dtype']
        if dtype not in _SAFETENSORS_DTYPES:
            raise NotImplementedError(
                f'{path}: tensor {name} of dtype {dtype} (the port reads '
                'F32, F16 and BF16)')
        start, end = meta['data_offsets']
        raw = np.frombuffer(blob, _SAFETENSORS_DTYPES[dtype], (end - start)
                            // np.dtype(_SAFETENSORS_DTYPES[dtype]).itemsize,
                            8 + n + start)
        if dtype == 'BF16':
            raw = (raw.astype(np.uint32) << 16).view(np.float32)
        out[name] = torch.from_numpy(
            raw.astype(np.float32).reshape(meta['shape']))
    return out


_RENAMES = (('LayerNorm.gamma', 'LayerNorm.weight'),
            ('LayerNorm.beta', 'LayerNorm.bias'))
_PREFIXES = ('bert.', 'distilbert.', 'roberta.', 'mpnet.')
_PARTS = ('embeddings.', 'encoder.', 'transformer.')
# the base model's key in a Flax tree saved by a model with a head
_FLAX_PREFIXES = ('bert', 'roberta', 'distilbert')
FLAX_FILES = ('flax_model.msgpack', 'flax_model.msgpack.index.json')
TORCH_FILES = ('model.safetensors', 'model.safetensors.index.json',
               'pytorch_model.bin', 'pytorch_model.bin.index.json')
# the files each recipe's library reads, in its order: FlaxAutoModel (its
# Flax files, model.safetensors, then with from_pt=True pytorch_model.bin
# and its index; it refuses a sharded model.safetensors, which the port
# reads last), and Sentence Transformers' AutoModel
WEIGHT_FILES = {
    'flax': (*FLAX_FILES, 'model.safetensors', 'pytorch_model.bin',
             'pytorch_model.bin.index.json', 'model.safetensors.index.json'),
    'st': TORCH_FILES,
}


def weights_file(model_dir: str, backend: str) -> str | None:
    """The first of ``WEIGHT_FILES[backend]`` in ``model_dir``, or None."""
    for name in WEIGHT_FILES[backend]:
        if os.path.exists(os.path.join(model_dir, name)):
            return name
    return None


def _read_torch_file(path: str) -> dict[str, torch.Tensor]:
    if path.endswith('.safetensors'):
        return read_safetensors(path)
    return torch.load(path, map_location='cpu', weights_only=True)


def read_index(path: str, read_shard) -> dict:
    """The tensors of a sharded checkpoint: each shard that the index's
    ``weight_map`` names read once with ``read_shard``, and each name taken
    from its shard."""
    with open(path, encoding='utf-8') as f:
        weight_map = json.load(f)['weight_map']
    where = os.path.dirname(path)
    shards = {s: read_shard(os.path.join(where, s))
              for s in dict.fromkeys(weight_map.values())}
    out = {}
    for name, shard in weight_map.items():
        if name not in shards[shard]:
            raise ValueError(f'{path}: {name} is not in its shard {shard}')
        out[name] = shards[shard][name]
    return out


def read_flax_state(path: str) -> dict[str, torch.Tensor]:
    """The encoder's ``state_dict`` from a ``flax_model.msgpack`` or its
    ``.index.json`` (shards of ``/``-joined names), read by ``flax_msgpack``:
    the base model's key dropped where a model with a head saved the tree,
    as ``FlaxPreTrainedModel.from_pretrained`` does, then
    ``weights.bert_state_from_flax``."""
    from ..weights import bert_state_from_flax
    from .flax_msgpack import flatten, read_flax_file, unflatten
    if path.endswith('.json'):
        tree = unflatten(read_index(path, lambda shard: flatten(
            read_flax_file(shard))))
    else:
        tree = read_flax_file(path)
    for prefix in _FLAX_PREFIXES:
        if prefix in tree and 'embeddings' not in tree:
            tree = tree[prefix]
            break
    return bert_state_from_flax(tree)


def read_state(model_dir: str, backend: str = 'flax'
               ) -> dict[str, torch.Tensor]:
    """The encoder's ``state_dict`` from the first file of
    ``WEIGHT_FILES[backend]`` in ``model_dir``: Flax's (``read_flax_state``)
    or torch's, a single file or sharded (``read_index``); of torch's the
    family's prefix dropped, the pooler, ``position_ids``/
    ``token_type_ids`` buffers and any head left out, old ``gamma``/
    ``beta`` names renamed, and DistilBERT's and MPNet's layer names mapped
    onto BERT's (``encoder_models.bert_name``).  ``st`` refuses a
    directory with Flax weights only, with transformers' reason."""
    name = weights_file(model_dir, backend)
    if name is None:
        if weights_file(model_dir, 'flax'):
            raise OSError(
                f'Error no file named pytorch_model.bin found in directory '
                f'{model_dir} but there is a file for Flax weights. Use '
                '`from_flax=True` to load this model from those weights. '
                '(Sentence Transformers cannot load it; '
                'TEXTGCN_TPU_TEXT_ENCODER=flax or auto reads it)')
        raise FileNotFoundError(f'none of {", ".join(WEIGHT_FILES[backend])}'
                                f' in {model_dir}')
    path = os.path.join(model_dir, name)
    if name in FLAX_FILES:
        return read_flax_state(path)
    raw = (read_index(path, _read_torch_file) if name.endswith('.json')
           else _read_torch_file(path))
    state = {}
    for name, t in raw.items():
        for prefix in _PREFIXES:
            if name.startswith(prefix):
                name = name[len(prefix):]
                break
        if not name.startswith(_PARTS) \
                or name.endswith(('position_ids', 'token_type_ids')):
            continue
        for old, new in _RENAMES:
            name = name.replace(old, new)
        state[bert_name(name)] = t.float()
    return state


# ---------------------------------------------------------------------------
# Sentence Transformers' model directory

@dataclass(frozen=True)
class DenseSpec:
    """A Sentence Transformers ``Dense`` module: ``nn.Linear`` and an
    activation (``DENSE_ACTIVATIONS``)."""
    weight: torch.Tensor
    bias: torch.Tensor | None
    activation: str


# the activations of Dense's config (their fully qualified torch names)
DENSE_ACTIVATIONS = {
    'torch.nn.modules.activation.Tanh': torch.tanh,
    'torch.nn.modules.linear.Identity': lambda x: x,
    'torch.nn.modules.activation.ReLU': torch.relu,
    'torch.nn.modules.activation.GELU': torch.nn.functional.gelu,
}


@dataclass(frozen=True)
class SentencePipeline:
    """What ``SentenceTransformer`` runs for a model directory."""
    transformer_dir: str
    max_seq_length: int | None = None
    do_lower_case: bool = False
    pooling: tuple[str, ...] = ('mean',)
    normalize: bool = False
    dense: tuple[DenseSpec, ...] = ()


def _pooling_modes(conf: dict, path: str) -> tuple[str, ...]:
    mode = conf.get('pooling_mode')
    if mode is None:
        modes = tuple(m for k, m in _LEGACY_POOLING if conf.get(k))
        modes = modes or ('mean',)
    else:
        modes = (mode,) if isinstance(mode, str) else tuple(mode)
    for m in modes:
        if m not in POOLING_MODES:
            raise NotImplementedError(
                f'{path}: pooling mode {m!r} is not ported: the port pools '
                f'with {", ".join(POOLING_MODES)}')
    return modes


def read_dense(module_dir: str) -> DenseSpec:
    """A ``Dense`` module's ``config.json`` (``in_features``,
    ``out_features``, ``bias``, ``activation_function``, Tanh when it is
    missing) and its ``linear.weight``/``linear.bias`` from
    ``model.safetensors`` or ``pytorch_model.bin``.  Refuses another
    activation, and another input or output than the sentence embedding,
    by name."""
    path = os.path.join(module_dir, 'config.json')
    conf = read_json(path)
    act = conf.get('activation_function', 'torch.nn.modules.activation.Tanh')
    if act not in DENSE_ACTIVATIONS:
        raise NotImplementedError(
            f'{path}: Dense activation {act!r} is not ported: the port runs '
            f'{", ".join(a.rsplit(".", 1)[-1] for a in DENSE_ACTIVATIONS)}')
    for key in ('module_input_name', 'module_output_name'):
        if conf.get(key, 'sentence_embedding') not in (None,
                                                       'sentence_embedding'):
            raise NotImplementedError(f'{path}: Dense {key} {conf[key]!r} '
                                      'is not ported')
    st_path = os.path.join(module_dir, 'model.safetensors')
    if os.path.exists(st_path):
        weights = read_safetensors(st_path)
    else:
        weights = {k: t.float() for k, t in torch.load(
            os.path.join(module_dir, 'pytorch_model.bin'), map_location='cpu',
            weights_only=True).items()}
    weight = weights['linear.weight']
    shape = (conf['out_features'], conf['in_features'])
    if tuple(weight.shape) != shape:
        raise ValueError(f'{module_dir}: linear.weight {tuple(weight.shape)}'
                         f', config {shape}')
    bias = weights['linear.bias'] if conf.get('bias', True) else None
    return DenseSpec(weight, bias, act)


def read_pipeline(model_dir: str) -> SentencePipeline:
    """The modules of ``model_dir/modules.json`` in order: a
    ``Transformer`` first, then ``Pooling``, any number of ``Dense`` and,
    where listed, ``Normalize``; any other module or order is refused by
    name.  Without ``modules.json``: the transformer at ``model_dir``, mean
    pooling, no normalisation."""
    modules = os.path.join(model_dir, 'modules.json')
    if not os.path.exists(modules):
        return SentencePipeline(model_dir)
    with open(modules, encoding='utf-8') as f:
        entries = json.load(f)
    kinds = [e['type'].rsplit('.', 1)[-1] for e in entries]
    dense = 0
    while kinds[2 + dense:3 + dense] == ['Dense']:
        dense += 1
    if kinds[:2] != ['Transformer', 'Pooling'] \
            or kinds[2 + dense:] not in ([], ['Normalize']):
        raise NotImplementedError(
            f'{modules}: modules {kinds} are not ported: the port runs a '
            'Transformer, then Pooling, then any Dense, then Normalize or '
            'nothing')
    where = [os.path.join(model_dir, e.get('path', '')) for e in entries]
    sbert = read_json(os.path.join(where[0], 'sentence_bert_config.json'))
    path = os.path.join(where[1], 'config.json')
    pooling = _pooling_modes(read_json(path), path)
    mml = sbert.get('max_seq_length')
    return SentencePipeline(
        where[0], None if mml is None else int(mml),
        bool(sbert.get('do_lower_case', False)), pooling,
        'Normalize' in kinds,
        tuple(read_dense(d) for d in where[2:2 + dense]))


# ---------------------------------------------------------------------------
# loading and encoding

def _model_and_tokenizer(model_dir: str, device, state: dict | None,
                         backend: str):
    config = read_json(os.path.join(model_dir, 'config.json'))
    if not config:
        raise FileNotFoundError(f'no config.json in {model_dir}')
    # built without storage: the checkpoint's tensors become the weights
    with torch.device('meta'):
        model = BertEncoder(config)
    tokenizer = load_tokenizer(model_dir, model.model_type)
    if state is None:
        state = read_state(model_dir, backend)
    model.load_state_dict(state, assign=True)
    return tokenizer, model.to(device).eval()


def load_encoder(model_dir: str, device, state: dict | None = None):
    """``(tokenizer, model, max_length)`` of the ``flax`` recipe: the model
    on ``device`` in float32 and in eval mode, its weights ``state`` (a
    ``state_dict``, e.g. ``weights.bert_state_from_flax``'s) or the
    directory's checkpoint; the length capped at 512 and at the model's
    positions.  ``mpnet`` is refused: transformers has no Flax MPNet."""
    config = read_json(os.path.join(model_dir, 'config.json'))
    if config.get('model_type') == 'mpnet':
        raise NotImplementedError(
            f'{model_dir}: mpnet has no Flax model in transformers, so the '
            "JAX package's flax backend cannot run it: use "
            'TEXTGCN_TPU_TEXT_ENCODER=st')
    tokenizer, model = _model_and_tokenizer(model_dir, device, state, 'flax')
    max_length = min(tokenizer.max_length(), model.max_positions,
                     model.max_tokens)
    return tokenizer, model, max_length


def load_sentence_encoder(model_dir: str, device):
    """``(tokenizer, model, max_length, pipeline)`` of Sentence
    Transformers' reading of ``model_dir`` (``read_pipeline``); the length
    is ``max_seq_length``, else the tokenizer's limit capped at the
    model's positions (and, past them, at the tokens the model can
    place)."""
    pipe = read_pipeline(model_dir)
    tokenizer, model = _model_and_tokenizer(pipe.transformer_dir, device,
                                            None, 'st')
    tokenizer.lower = pipe.do_lower_case
    if pipe.max_seq_length is not None:
        max_length = pipe.max_seq_length
    else:
        max_length = min(tokenizer.model_max_length or model.max_positions,
                         model.max_positions)
    return tokenizer, model, min(max_length, model.max_tokens), pipe


def pool(hidden: torch.Tensor, mask: torch.Tensor,
         modes: tuple[str, ...]) -> torch.Tensor:
    """Sentence Transformers' ``Pooling`` (5.6's arithmetic): each mode's
    ``(B, hidden)`` vector, concatenated in order.  ``weightedmean``
    weighs position ``k`` by ``k + 1``; ``lasttoken`` takes the last
    position the mask keeps."""
    w = mask[..., None].to(hidden.dtype)
    out = []
    for mode in modes:
        if mode == 'cls':
            out.append(hidden[:, 0])
        elif mode == 'max':
            out.append(hidden.masked_fill(w == 0, float('-inf')).max(1)
                       .values)
        elif mode in ('mean', 'mean_sqrt_len_tokens'):
            count = w.sum(1).clamp(min=1e-9)
            if mode == 'mean_sqrt_len_tokens':
                count = torch.sqrt(count)
            out.append((hidden * w).sum(1) / count)
        elif mode == 'weightedmean':
            ww = w * torch.arange(1, hidden.shape[1] + 1,
                                  device=hidden.device).to(hidden.dtype)[
                                      None, :, None]
            out.append((hidden * ww).sum(1) / ww.sum(1).clamp(min=1e-9))
        else:
            flipped = mask.flip(1)
            back = flipped.argmax(1)
            last = hidden.shape[1] - 1 - torch.where(
                flipped.amax(1) == 0, hidden.shape[1] - 1, back)
            out.append((hidden * w)[torch.arange(hidden.shape[0],
                                                 device=hidden.device),
                                    last])
    return torch.cat(out, dim=-1)


def dense_layers(specs: tuple[DenseSpec, ...], device) -> list:
    """The ``Dense`` modules as functions on ``device``."""
    layers = []
    for spec in specs:
        weight = spec.weight.to(device)
        bias = None if spec.bias is None else spec.bias.to(device)
        act = DENSE_ACTIVATIONS[spec.activation]
        layers.append(lambda x, w=weight, b=bias, f=act:
                      f(torch.nn.functional.linear(x, w, b)))
    return layers


def encode_with(tokenizer, model, max_length: int, sentences: list[str],
                batch_size: int, pooling: tuple[str, ...] = ('mean',),
                norm_floor: float | None = 1e-9,
                dense: tuple[DenseSpec, ...] = ()) -> np.ndarray:
    """``(len(sentences), D)`` float32 vectors: the transformer's last
    hidden state pooled (``pool``), through the ``dense`` modules, divided
    by its L2 norm floored at ``norm_floor`` (none when ``None``),
    ``batch_size`` rows a forward pass on the model's device.  The defaults
    are the ``flax`` recipe."""
    device = model.embeddings.word_embeddings.weight.device
    torch.backends.cuda.matmul.allow_tf32 = False
    width = model.embeddings.word_embeddings.embedding_dim * len(pooling)
    if dense:
        width = dense[-1].weight.shape[0]
    layers = dense_layers(dense, device)
    out = [np.zeros((0, width), np.float32)]
    with torch.no_grad():
        for start in range(0, len(sentences), batch_size):
            ids, mask = tokenizer(sentences[start:start + batch_size],
                                  max_length)
            ids = torch.from_numpy(ids).to(device)
            mask = torch.from_numpy(mask).to(device)
            emb = pool(model(ids, mask), mask, pooling)
            for layer in layers:
                emb = layer(emb)
            if norm_floor is not None:
                norm = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
                emb = emb / norm.clamp(min=norm_floor)
            out.append(emb.cpu().numpy())
    return np.concatenate(out).astype(np.float32)


BACKENDS = ('flax', 'st', 'auto')


def flax_only(model_dir: str) -> bool:
    """Whether Sentence Transformers fails on ``model_dir`` for want of
    torch weights (none of ``TORCH_FILES`` in its transformer's directory)
    while ``FlaxAutoModel`` reads it (``FLAX_FILES``)."""
    if weights_file(model_dir, 'flax') not in FLAX_FILES:
        return False
    return weights_file(read_pipeline(model_dir).transformer_dir,
                        'st') is None


def encode(sentences: list[str], model_dir: str, batch_size: int,
           device, backend: str = 'flax') -> np.ndarray:
    """The vectors of ``sentences`` from the model that ``model_dir`` names
    (a directory, or a name in the Hugging Face cache) on ``device``, by
    the recipe of ``backend``: ``flax`` (``load_encoder``), or ``st`` and
    ``auto`` (``load_sentence_encoder``: its pooling, its ``Dense``
    modules, and ``Normalize``'s L2 norm floored at 1e-12 where the
    directory lists it).  ``auto`` runs ``flax`` where the transformer's
    directory holds no torch weights and the model directory Flax ones
    (``flax_only``), with one warning.  Logs the rate."""
    if backend not in BACKENDS:
        raise ValueError(f'text encoder backend {backend!r}: use one of '
                         f'{", ".join(BACKENDS)}')
    device = torch.device(device)
    path = resolve_model_dir(model_dir)
    if backend == 'auto' and flax_only(path):
        log.warning(
            '%s holds no PyTorch weights (%s) but Flax weights (%s): '
            'Sentence Transformers cannot load it, so auto encodes by the '
            "Flax recipe, as the JAX package's auto does after Sentence "
            'Transformers fails (its modules.json is not read)', path,
            ', '.join(TORCH_FILES), weights_file(path, 'flax'))
        backend = 'flax'
    if backend == 'flax':
        tokenizer, model, max_length = load_encoder(path, device)
        recipe = {}
    else:
        tokenizer, model, max_length, pipe = load_sentence_encoder(path,
                                                                   device)
        recipe = {'pooling': pipe.pooling, 'dense': pipe.dense,
                  'norm_floor': 1e-12 if pipe.normalize else None}
    t0 = time.perf_counter()
    out = encode_with(tokenizer, model, max_length, sentences, batch_size,
                      **recipe)
    seconds = time.perf_counter() - t0
    log.info('Encoded %d sentences with %s (%s, %s) on %s in %.3f s (%.1f '
             'sentences/s)', len(sentences), path, model.model_type,
             backend, device, seconds, len(sentences) / max(seconds, 1e-9))
    return out
