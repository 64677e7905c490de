"""RoBERTa's byte-level BPE tokenizer, with no Hugging Face package and no
``regex`` module.

The ids are the slow Hugging Face ``RobertaTokenizer``'s:

* the special tokens (``<s>``, ``</s>``, ``<unk>``, ``<pad>``,
  ``<mask>``) are split off the text first and kept whole; a token marked
  ``lstrip`` (``<mask>``) eats the whitespace before it, one marked
  ``rstrip`` the whitespace after it;
* ``add_prefix_space`` (from ``tokenizer_config.json``) puts a space before
  a text that does not start with whitespace;
* each remaining piece is cut by GPT-2's pattern ``'s|'t|'re|'ve|'m|'ll|'d|
  ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``, written here as
  a scanner over ``unicodedata.category`` (letters ``L*``, numbers ``N*``)
  and the Unicode ``White_Space`` set that ``regex``'s ``\\s`` matches;
* each word's UTF-8 bytes are mapped to printable characters
  (``bytes_to_unicode``) and merged by the ranks of ``merges.txt``;
* ``<s> ids </s>``, the ids cut to ``max_length - 2``, padded with
  ``<pad>`` to the longest row.
"""

from __future__ import annotations

import json
import os
import re
import unicodedata

from .tokenizing import (capped_length, pad_rows, read_json, special_tokens,
                         split_specials, truncate)

# regex's \s: the Unicode White_Space property
WHITESPACE = frozenset(map(chr, (
    0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0, 0x1680, *range(0x2000,
                                                                   0x200B),
    0x2028, 0x2029, 0x202F, 0x205F, 0x3000)))
CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
SPECIAL_DEFAULTS = {'bos_token': '<s>', 'eos_token': '</s>',
                    'unk_token': '<unk>', 'sep_token': '</s>',
                    'pad_token': '<pad>', 'cls_token': '<s>',
                    'mask_token': '<mask>'}
# Hugging Face marks RoBERTa's mask token lstrip: "<mask>" takes the space
# before it, as a word does
LSTRIP_DEFAULTS = frozenset({'mask_token'})


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's map of the 256 byte values to printable characters."""
    bs = (list(range(ord('!'), ord('~') + 1))
          + list(range(ord('¡'), ord('¬') + 1))
          + list(range(ord('®'), ord('ÿ') + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _kind(ch: str) -> str:
    """'s' whitespace, 'L' letter, 'N' number, 'o' anything else."""
    if ch in WHITESPACE:
        return 's'
    cat = unicodedata.category(ch)[0]
    return cat if cat in 'LN' else 'o'


def pretokenize(text: str) -> list[str]:
    """GPT-2's pattern, alternative by alternative, as ``regex.findall``
    applies it."""
    out = []
    kinds = [_kind(c) for c in text]
    n, i = len(text), 0

    def run(j: int, kind: str) -> int:
        while j < n and kinds[j] == kind:
            j += 1
        return j

    while i < n:
        if text[i] == "'":
            hit = next((c for c in CONTRACTIONS
                        if text.startswith(c, i)), None)
            if hit:
                out.append(hit)
                i += len(hit)
                continue
        start = i + 1 if text[i] == ' ' and i + 1 < n \
            and kinds[i + 1] != 's' else i
        if kinds[start] != 's':
            end = run(start, kinds[start])
            out.append(text[i:end])
            i = end
            continue
        end = run(i, 's')
        # \s+(?!\S): leave the last space to the word that follows
        if end < n and end - i > 1:
            end -= 1
        out.append(text[i:end])
        i = end
    return out


def _pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word, word[1:]))


class RobertaTokenizer:
    """Byte-level BPE ids as the slow Hugging Face ``RobertaTokenizer``
    gives them, with no added tokens but the special ones."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 *, add_prefix_space: bool = False,
                 special: dict[str, str] | None = None,
                 added: dict[str, int] | None = None,
                 lstrip: frozenset[str] = frozenset({'<mask>'}),
                 rstrip: frozenset[str] = frozenset(),
                 model_max_length: int | None = None):
        self.vocab = {**vocab, **(added or {})}
        self.ranks = {m: k for k, m in enumerate(merges)}
        self.add_prefix_space = add_prefix_space
        self.special = {**SPECIAL_DEFAULTS, **(special or {})}
        self.lstrip, self.rstrip = lstrip, rstrip
        self.model_max_length = model_max_length
        self.lower = False   # Sentence Transformers' do_lower_case
        self._whole = set(self.special.values()) | set(added or ())
        specials = '|'.join(map(re.escape, sorted(self._whole, key=len,
                                                  reverse=True)))
        self._specials = re.compile(f'({specials})')
        self._bytes = bytes_to_unicode()
        self._cache: dict[str, list[str]] = {}
        self.unk_id = self.vocab.get(self.special['unk_token'])
        self.cls_id = self.vocab[self.special['cls_token']]
        self.sep_id = self.vocab[self.special['sep_token']]
        self.pad_id = self.vocab[self.special['pad_token']]

    @classmethod
    def from_dir(cls, model_dir: str) -> 'RobertaTokenizer':
        paths = [os.path.join(model_dir, f) for f in ('vocab.json',
                                                      'merges.txt')]
        if not all(map(os.path.exists, paths)):
            raise FileNotFoundError(f'no vocab.json and merges.txt in '
                                    f'{model_dir}')
        with open(paths[0], encoding='utf-8') as f:
            vocab = json.load(f)
        with open(paths[1], encoding='utf-8') as f:
            lines = f.read().split('\n')[1:-1]
        merges = [tuple(m.split()) for m in lines]
        conf = read_json(os.path.join(model_dir, 'tokenizer_config.json'))
        special, added, lstrip, rstrip, mml = special_tokens(
            model_dir, conf, SPECIAL_DEFAULTS, LSTRIP_DEFAULTS)
        return cls(vocab, merges,
                   add_prefix_space=bool(conf.get('add_prefix_space',
                                                  False)),
                   special=special, added=added, lstrip=lstrip,
                   rstrip=rstrip, model_max_length=mml)

    def max_length(self, cap: int = 512) -> int:
        return capped_length(self.model_max_length, cap)

    def bpe(self, token: str) -> list[str]:
        pieces = self._cache.get(token)
        if pieces is not None:
            return pieces
        word = tuple(token)
        pairs = _pairs(word)
        while pairs:
            bigram = min(pairs, key=lambda p: self.ranks.get(p, float('inf')))
            if bigram not in self.ranks:
                break
            first, second = bigram
            merged, i = [], 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    merged.extend(word[i:])
                    break
                merged.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
            if len(word) == 1:
                break
            pairs = _pairs(word)
        self._cache[token] = pieces = list(word)
        return pieces

    def tokenize(self, text: str) -> list[str]:
        if self.add_prefix_space and text and not text[0].isspace():
            text = ' ' + text
        parts = split_specials(self._specials, text, self.lstrip,
                               self.rstrip)
        tokens = []
        for i, part in enumerate(parts):
            if i % 2:
                tokens.append(part)
                continue
            if self.lower:
                # one character at a time, as Sentence Transformers' Lowercase
                # normalizer does (so no final sigma)
                part = ''.join(map(str.lower, part))
            for word in pretokenize(part):
                tokens.extend(self.bpe(''.join(
                    self._bytes[b] for b in word.encode('utf-8'))))
        return tokens

    def encode(self, text: str, max_length: int) -> list[int]:
        """``<s> ids </s>``, the ids cut to ``max_length - 2``."""
        ids = [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]
        return truncate(ids, self.cls_id, self.sep_id, max_length)

    def __call__(self, sentences: list[str], max_length: int):
        """``(ids, mask)``, int64 ``(B, L)``, padded to the longest row."""
        return pad_rows([self.encode(s, max_length) for s in sentences],
                        self.pad_id)


def learn(words: list[str], n_merges: int, size: int | None = None):
    """A small byte-level BPE learnt from pre-tokenized ``words`` (as
    ``pretokenize`` cuts them), for synthetic RoBERTa directories:
    ``(vocab, merges)`` with ``<s>``, ``<pad>``, ``</s>``, ``<unk>``, every
    byte, then the ``n_merges`` most frequent pairs merged in turn (ties to
    the larger pair), ``<unusedK>`` fill up to ``size`` and ``<mask>``
    last."""
    from collections import Counter
    b2u = bytes_to_unicode()
    counts = Counter(''.join(b2u[b] for b in w.encode('utf-8'))
                     for w in words)
    vocab = ['<s>', '<pad>', '</s>', '<unk>'] + sorted(set(b2u.values()))
    splits = {w: list(w) for w in counts}
    merges = []
    for _ in range(n_merges):
        pairs = Counter()
        for w, c in counts.items():
            s = splits[w]
            for a, b in zip(s, s[1:]):
                pairs[a, b] += c
        if not pairs:
            break
        (a, b), _ = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        merges.append((a, b))
        vocab.append(a + b)
        for w, s in splits.items():
            out, i = [], 0
            while i < len(s):
                if i + 1 < len(s) and s[i] == a and s[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(s[i])
                    i += 1
            splits[w] = out
    vocab = list(dict.fromkeys(vocab))
    if size is not None:
        vocab += [f'<unused{i}>' for i in range(size - len(vocab) - 1)]
    return {t: k for k, t in enumerate(vocab + ['<mask>'])}, merges
