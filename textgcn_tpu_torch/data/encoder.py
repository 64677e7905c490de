"""The text encoder: a BERT in plain PyTorch, its WordPiece tokenizer and a
checkpoint reader, with no Hugging Face package.

Counterpart of ``textgcn_tpu/data/encoder_flax.py`` (``flax_encode``): the
Sentence Transformers recipe of ``all-MiniLM-L6-v2`` (transformer, then the
attention-masked token mean, then L2 normalisation with 1e-9 floors),
computed with ``torch.matmul`` in float32 (TF32 off) on the entry point's
device.

* ``BertTokenizer``: the slow Hugging Face ``BertTokenizer``'s ids from a
  ``vocab.txt`` (and ``tokenizer_config.json``/``special_tokens_map.json``
  where they exist): special tokens kept whole, the text cleaned, spaces
  put around CJK characters, lower-cased and accent-stripped where the
  config says so, split on punctuation, then greedy longest-match
  WordPiece (``[UNK]`` for a word of more than 100 characters);
  ``[CLS] ... [SEP]``, truncated to ``max_length``, padded to the longest
  row.
* ``BertEncoder``: absolute position embeddings, token type 0,
  post-LayerNorm layers, attention as a plain product and softmax with the
  padding mask added as a bias of ``finfo(float32).min``, as Flax BERT
  computes it; ``hidden_act`` ``gelu`` (erf), ``gelu_new`` or
  ``gelu_pytorch_tanh`` (tanh) or ``relu``.  ``model_type`` must be
  ``bert``.
* ``read_state``: ``model.safetensors`` parsed with numpy (F32, F16,
  BF16), else ``pytorch_model.bin`` through ``torch.load(weights_only=
  True)``; keys with or without ``bert.``, the pooler ignored.  A
  Flax-only directory is refused.
* ``resolve_model_dir``: ``--bert_model`` as a local directory, or a name
  looked up in the Hugging Face cache (``$HF_HUB_CACHE``, else
  ``$HF_HOME/hub``, else ``~/.cache/huggingface/hub``:
  ``models--<org>--<name>/snapshots/*/``); nothing is fetched.

Unlike the JAX package, rows are padded to the longest row of their
batch, not to power-of-two buckets: the buckets spare XLA recompiles, and
the padding mask makes the result the same.
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
import time
import unicodedata

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

log = logging.getLogger('textgcn_tpu_torch')

MAX_LENGTH_CAP = 512
MAX_WORD_CHARS = 100
# the tokenizers' "no limit" sentinel lies above this
_NO_LIMIT = 100_000
SPECIAL_KEYS = ('unk_token', 'sep_token', 'pad_token', 'cls_token',
                'mask_token')
SPECIAL_DEFAULTS = {'unk_token': '[UNK]', 'sep_token': '[SEP]',
                    'pad_token': '[PAD]', 'cls_token': '[CLS]',
                    'mask_token': '[MASK]'}
ACTIVATIONS = {
    'gelu': F.gelu,
    'gelu_new': lambda x: F.gelu(x, approximate='tanh'),
    'gelu_pytorch_tanh': lambda x: F.gelu(x, approximate='tanh'),
    'relu': F.relu,
}


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


def _read_json(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path, encoding='utf-8') as f:
        return json.load(f)


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


def _token_content(value) -> str:
    return value['content'] if isinstance(value, dict) else value


class BertTokenizer:
    """WordPiece ids as the slow Hugging Face ``BertTokenizer`` gives them,
    with its default basic tokenization (Chinese characters split, no
    ``never_split``) and no added tokens but the special ones."""

    def __init__(self, vocab: dict[str, int], *, do_lower_case: bool = True,
                 strip_accents: bool | None = None,
                 special: dict[str, str] | None = None,
                 model_max_length: int | None = None):
        self.vocab = vocab
        self.do_lower_case = do_lower_case
        self.strip_accents = strip_accents
        self.special = {**SPECIAL_DEFAULTS, **(special or {})}
        self.model_max_length = model_max_length
        # kept whole: split off the text first, never lower-cased
        self._whole = set(self.special.values())
        specials = '|'.join(map(re.escape, sorted(self._whole, key=len,
                                                  reverse=True)))
        self._specials = re.compile(f'({specials})')
        self._lower = re.compile(f'({specials})|(.+?)')
        self._pieces: dict[str, list[str]] = {}
        self.unk_id = vocab[self.special['unk_token']]
        self.cls_id = vocab[self.special['cls_token']]
        self.sep_id = vocab[self.special['sep_token']]
        self.pad_id = vocab[self.special['pad_token']]

    @classmethod
    def from_dir(cls, model_dir: str) -> 'BertTokenizer':
        vocab_path = os.path.join(model_dir, 'vocab.txt')
        if not os.path.exists(vocab_path):
            if os.path.exists(os.path.join(model_dir, 'tokenizer.json')):
                raise NotImplementedError(
                    f'{model_dir} holds tokenizer.json but no vocab.txt: '
                    'the port reads WordPiece vocabularies from vocab.txt '
                    'only')
            raise FileNotFoundError(f'no vocab.txt in {model_dir}')
        vocab: dict[str, int] = {}
        with open(vocab_path, encoding='utf-8') as f:
            for i, line in enumerate(f):
                vocab[line.rstrip('\n')] = i
        conf = _read_json(os.path.join(model_dir, 'tokenizer_config.json'))
        smap = _read_json(os.path.join(model_dir, 'special_tokens_map.json'))
        special = {k: _token_content(smap.get(k, conf.get(
            k, SPECIAL_DEFAULTS[k]))) for k in SPECIAL_KEYS}
        unported = {k: conf[k] for k in ('do_basic_tokenize',
                                         'tokenize_chinese_chars')
                    if conf.get(k, True) is not True}
        if conf.get('never_split'):
            unported['never_split'] = conf['never_split']
        for entry in conf.get('added_tokens_decoder', {}).values():
            if entry['content'] not in special.values() or any(
                    entry.get(f) for f in ('lstrip', 'rstrip',
                                           'single_word')):
                unported.setdefault('added_tokens', []).append(entry)
        if unported:
            raise NotImplementedError(f'{model_dir}: tokenizer settings '
                                      f'not ported: {unported}')
        mml = conf.get('model_max_length')
        return cls(vocab, do_lower_case=conf.get('do_lower_case', True),
                   strip_accents=conf.get('strip_accents'), special=special,
                   model_max_length=None if mml is None else int(mml))

    def max_length(self, cap: int = MAX_LENGTH_CAP) -> int:
        """``encoder_flax._model_max_len``: the tokenizer's limit, capped."""
        mml = self.model_max_length
        if not mml or mml > _NO_LIMIT:
            return cap
        return min(int(mml), cap)

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
        if self.do_lower_case:
            # one character at a time, as Hugging Face does (so no final
            # sigma)
            text = self._lower.sub(
                lambda m: m.group(1) or m.group(2).lower(), text)
        tokens = []
        for i, part in enumerate(self._specials.split(text)):
            if i % 2:
                tokens.append(part)
            else:
                tokens.extend(p for word in self._basic(part)
                              for p in self._wordpiece(word))
        return tokens

    def encode(self, text: str, max_length: int) -> list[int]:
        """``[CLS] ids [SEP]``, the ids cut to ``max_length - 2``; as in
        Hugging Face's tokenizers, left whole where that would cut them
        all."""
        ids = [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]
        remove = len(ids) + 2 - max_length
        if 0 < remove < len(ids):
            ids = ids[:-remove]
        return [self.cls_id, *ids, self.sep_id]

    def __call__(self, sentences: list[str], max_length: int):
        """``(ids, mask)``, int64 ``(B, L)``, padded to the longest row."""
        rows = [self.encode(s, max_length) for s in sentences]
        width = max(map(len, rows))
        ids = np.full((len(rows), width), self.pad_id, np.int64)
        mask = np.zeros((len(rows), width), np.int64)
        for r, row in enumerate(rows):
            ids[r, :len(row)] = row
            mask[r, :len(row)] = 1
        return ids, mask


# ---------------------------------------------------------------------------
# the model

class BertLayer(nn.Module):
    """One post-LayerNorm encoder layer, under BERT's parameter names."""

    def __init__(self, hidden: int, heads: int, inner: int, eps: float,
                 act):
        super().__init__()
        self.heads = heads
        self.act = act
        self.attention = nn.Module()
        self.attention.self = nn.Module()
        for name in ('query', 'key', 'value'):
            setattr(self.attention.self, name, nn.Linear(hidden, hidden))
        self.attention.output = nn.Module()
        self.attention.output.dense = nn.Linear(hidden, hidden)
        self.attention.output.LayerNorm = nn.LayerNorm(hidden, eps=eps)
        self.intermediate = nn.Module()
        self.intermediate.dense = nn.Linear(hidden, inner)
        self.output = nn.Module()
        self.output.dense = nn.Linear(inner, hidden)
        self.output.LayerNorm = nn.LayerNorm(hidden, eps=eps)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, n, h = x.shape
        heads, sa = self.heads, self.attention.self

        def split(t):
            return t.view(b, n, heads, h // heads).transpose(1, 2)

        q = split(sa.query(x)) / math.sqrt(h // heads)
        k, v = split(sa.key(x)), split(sa.value(x))
        weights = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) + bias,
                                dim=-1)
        ctx = torch.matmul(weights, v).transpose(1, 2).reshape(b, n, h)
        out = self.attention.output
        x = out.LayerNorm(out.dense(ctx) + x)
        y = self.output.dense(self.act(self.intermediate.dense(x)))
        return self.output.LayerNorm(y + x)


class BertEncoder(nn.Module):
    """The BERT encoder's last hidden state, ``state_dict`` keys as the
    Hugging Face ``BertModel``'s without its pooler."""

    def __init__(self, config: dict):
        super().__init__()
        model_type = config.get('model_type')
        if model_type != 'bert':
            raise NotImplementedError(
                f'text encoder model_type {model_type!r} is not ported yet: '
                'the port runs BERT (all-MiniLM-L6-v2 is one)')
        act = config.get('hidden_act', 'gelu')
        if act not in ACTIVATIONS:
            raise NotImplementedError(
                f'hidden_act {act!r} is not ported yet: use one of '
                f'{sorted(ACTIVATIONS)}')
        kind = config.get('position_embedding_type', 'absolute')
        if kind != 'absolute':
            raise NotImplementedError(
                f'position_embedding_type {kind!r} is not ported yet')
        hidden, eps = config['hidden_size'], config.get('layer_norm_eps',
                                                        1e-12)
        self.max_positions = config.get('max_position_embeddings', 512)
        self.embeddings = nn.Module()
        self.embeddings.word_embeddings = nn.Embedding(config['vocab_size'],
                                                       hidden)
        self.embeddings.position_embeddings = nn.Embedding(
            self.max_positions, hidden)
        self.embeddings.token_type_embeddings = nn.Embedding(
            config.get('type_vocab_size', 2), hidden)
        self.embeddings.LayerNorm = nn.LayerNorm(hidden, eps=eps)
        self.encoder = nn.Module()
        self.encoder.layer = nn.ModuleList(
            BertLayer(hidden, config['num_attention_heads'],
                      config['intermediate_size'], eps, ACTIVATIONS[act])
            for _ in range(config['num_hidden_layers']))

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        emb = self.embeddings
        pos = torch.arange(ids.shape[1], device=ids.device)
        x = (emb.word_embeddings(ids) + emb.token_type_embeddings.weight[0]
             + emb.position_embeddings(pos))
        x = emb.LayerNorm(x)
        bias = torch.where(mask[:, None, None, :] > 0, 0.0,
                           torch.finfo(torch.float32).min).to(x.dtype)
        for layer in self.encoder.layer:
            x = layer(x, bias)
        return x


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


def read_state(model_dir: str) -> dict[str, torch.Tensor]:
    """The encoder's ``state_dict`` from ``model.safetensors`` or
    ``pytorch_model.bin``: the ``bert.`` prefix dropped, the pooler,
    ``position_ids`` and any head left out, old ``gamma``/``beta`` names
    renamed."""
    st = os.path.join(model_dir, 'model.safetensors')
    pt = os.path.join(model_dir, 'pytorch_model.bin')
    if os.path.exists(st):
        raw = read_safetensors(st)
    elif os.path.exists(pt):
        raw = torch.load(pt, map_location='cpu', weights_only=True)
    elif os.path.exists(os.path.join(model_dir, 'flax_model.msgpack')):
        raise NotImplementedError(
            f'{model_dir} holds Flax weights only (flax_model.msgpack): the '
            'port reads model.safetensors or pytorch_model.bin')
    else:
        raise FileNotFoundError(f'no model.safetensors or pytorch_model.bin '
                                f'in {model_dir}')
    state = {}
    for name, t in raw.items():
        if name.startswith('bert.'):
            name = name[len('bert.'):]
        if not name.startswith(('embeddings.', 'encoder.')) \
                or name.endswith('position_ids'):
            continue
        for old, new in _RENAMES:
            name = name.replace(old, new)
        state[name] = t.float()
    return state


def load_encoder(model_dir: str, device, state: dict | None = None
                 ) -> tuple[BertTokenizer, BertEncoder, int]:
    """``(tokenizer, model, max_length)`` of a model directory, the model
    on ``device`` in float32 and in eval mode, its weights ``state`` (a
    ``state_dict``, e.g. ``weights.bert_state_from_flax``'s) or the
    directory's checkpoint."""
    config = _read_json(os.path.join(model_dir, 'config.json'))
    if not config:
        raise FileNotFoundError(f'no config.json in {model_dir}')
    model = BertEncoder(config)
    tokenizer = BertTokenizer.from_dir(model_dir)
    model.load_state_dict(read_state(model_dir) if state is None else state)
    max_length = min(tokenizer.max_length(), model.max_positions)
    return tokenizer, model.to(device).eval(), max_length


def encode_with(tokenizer: BertTokenizer, model: BertEncoder,
                max_length: int, sentences: list[str],
                batch_size: int) -> np.ndarray:
    """``(len(sentences), hidden)`` float32 unit vectors: the transformer's
    last hidden state, its attention-masked token mean, L2-normalised
    (both divisions floored at 1e-9), ``batch_size`` rows a forward pass on
    the model's device."""
    device = model.embeddings.word_embeddings.weight.device
    torch.backends.cuda.matmul.allow_tf32 = False
    out = [np.zeros((0, model.embeddings.word_embeddings.embedding_dim),
                    np.float32)]
    with torch.no_grad():
        for start in range(0, len(sentences), batch_size):
            ids, mask = tokenizer(sentences[start:start + batch_size],
                                  max_length)
            ids = torch.from_numpy(ids).to(device)
            mask = torch.from_numpy(mask).to(device)
            hidden = model(ids, mask)
            w = mask[..., None].to(hidden.dtype)
            emb = (hidden * w).sum(1) / w.sum(1).clamp(min=1e-9)
            norm = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
            out.append((emb / norm.clamp(min=1e-9)).cpu().numpy())
    return np.concatenate(out).astype(np.float32)


def encode(sentences: list[str], model_dir: str, batch_size: int,
           device) -> np.ndarray:
    """``encode_with`` the model that ``model_dir`` names (a directory, or
    a name in the Hugging Face cache) on ``device``; logs the rate."""
    device = torch.device(device)
    path = resolve_model_dir(model_dir)
    tokenizer, model, max_length = load_encoder(path, device)
    t0 = time.perf_counter()
    out = encode_with(tokenizer, model, max_length, sentences, batch_size)
    seconds = time.perf_counter() - t0
    log.info('Encoded %d sentences with %s on %s in %.3f s (%.1f '
             'sentences/s)', len(sentences), path, device, seconds,
             len(sentences) / max(seconds, 1e-9))
    return out
