"""A ``tokenizer.json`` (the Hugging Face ``tokenizers`` format that fast
tokenizers, ``AutoTokenizer`` and Sentence Transformers load) read and run
in plain Python, with no Hugging Face package.

The ids are ``tokenizers``' ``Tokenizer.encode``'s, as ``AutoTokenizer``
calls it (``truncation=True``, ``max_length``, one sequence), in its
stages:

1. the added tokens are split off: first those marked not ``normalized``
   on the raw text, then, on the normalized pieces, the others (their text
   normalized too); the leftmost longest match wins, ``lstrip``/``rstrip``
   take the whitespace beside a match, a ``single_word`` token only
   matches between non-word characters;
2. the normalizer, on each piece between added tokens: ``BertNormalizer``,
   ``Lowercase``, ``NFC``, ``NFD``, ``NFKC``, ``NFKD``, ``StripAccents``,
   ``Replace`` (a string or an Oniguruma pattern), ``Strip``, ``Prepend``,
   ``Precompiled`` (SentencePiece's charsmap: the first common prefix of
   each grapheme cluster under 6 bytes, else of each character) and
   ``Sequence``;
3. the pre-tokenizer: ``BertPreTokenizer``, ``ByteLevel`` (GPT-2's
   pattern, ``bpe.pretokenize``), ``Metaspace`` (``prepend_scheme``
   ``always``/``first``/``never``, ``split``), ``Whitespace``,
   ``WhitespaceSplit``, ``Punctuation``, ``Digits``, ``Split`` and
   ``Sequence``;
4. the model on each pre-token: ``WordPiece`` (greedy longest match),
   ``BPE`` (merges by rank, leftmost first; ``byte_fallback``,
   ``fuse_unk``, ``ignore_merges``) and ``Unigram`` (the Viterbi best path
   over the pieces' scores; unknown characters fuse into one ``unk_id`` at
   the lowest score less 10; ``byte_fallback``);
5. truncation to ``max_length`` less the post-processor's tokens (none
   when ``max_length`` is below them), then the post-processor:
   ``TemplateProcessing``, ``BertProcessing``, ``RobertaProcessing``,
   ``ByteLevel`` (offsets only) and ``Sequence``.

Rows are padded with the pad token of ``tokenizer_config.json`` (or
``special_tokens_map.json``) to the longest row, on the right.  The file's
own ``truncation`` and ``padding`` are not read: the callers set both, as
``transformers`` does.  Any other component type or option raises
``NotImplementedError`` naming it, and so does a ``tokenizer_config.json``
that ``transformers`` would apply on top (a left padding or truncation
side, a ``do_lower_case``, ``strip_accents``, ``tokenize_chinese_chars``
or ``add_prefix_space`` that disagrees with the file).  ``Metaspace``'s ``first`` scheme
prefixes the pre-tokens that begin with a character standing for the
text's first one: what that character alone normalizes to, where the
normalized text begins with it (``tokenizers`` tracks every character's
original offsets; the port only those of the first).
"""

from __future__ import annotations

import base64
import heapq
import json
import os
import re
import struct

from . import unicode_classes as uc
from .bpe import bytes_to_unicode, pretokenize as gpt2_pretokenize
from .tokenizing import capped_length, pad_rows, read_json

# (text, how many of its first characters stand for the text's first
# character: Metaspace's ``first`` scheme reads it)
Split = tuple[str, int]


_POW10 = [float(f'1e{k}') for k in range(309)]
_U64_MAX = 2 ** 64 - 1


def serde_float(text: str) -> float:
    """A JSON number as ``serde_json`` (without ``float_roundtrip``, as
    ``tokenizers`` builds it) reads it: its digits as a ``u64`` (those that
    would overflow it dropped, each raising the exponent), rounded to
    ``f64``, then multiplied or divided by the ``f64`` power of ten; a
    17-digit score can land one ulp from ``float(text)``, and Unigram's
    best path breaks ties on it."""
    mantissa, _, exp_text = text.lstrip('-').lower().partition('e')
    whole, _, frac = mantissa.partition('.')
    digits, exp = whole + frac, int(exp_text or 0) - len(frac)
    while int(digits) > _U64_MAX:
        digits, exp = digits[:-1], exp + 1
    f = float(int(digits))
    while f and exp < -308:
        f /= 1e308
        exp += 308
    if f and exp > 308:
        raise ValueError(f'JSON number out of range: {text}')
    if f:
        f = f * _POW10[exp] if exp >= 0 else f / _POW10[-exp]
    return -f if text.startswith('-') else f


def loads(text: str) -> dict:
    """A ``tokenizer.json``'s text parsed as ``tokenizers`` parses it
    (``serde_float``)."""
    return json.loads(text, parse_float=serde_float)


def _refuse(kind: str, spec) -> NotImplementedError:
    return NotImplementedError(f'tokenizer.json {kind} not ported: {spec!r}')


def _check_keys(kind: str, spec: dict, allowed: set[str]):
    extra = set(spec) - allowed - {'type'}
    if extra:
        raise _refuse(f'{kind} {spec.get("type")!r} options',
                      {k: spec[k] for k in sorted(extra)})


def _pattern(spec: dict, kind: str) -> re.Pattern:
    pat = spec.get('pattern')
    if isinstance(pat, dict) and set(pat) == {'String'}:
        return re.compile(re.escape(pat['String']))
    if isinstance(pat, dict) and set(pat) == {'Regex'}:
        return uc.onig_to_re(pat['Regex'])
    raise _refuse(f'{kind} pattern', pat)


# ---------------------------------------------------------------------------
# SentencePiece's precompiled charsmap

class Charsmap:
    """The ``Precompiled`` normalizer: a Darts-clone double array over the
    UTF-8 keys (read in full into ``table``) and their replacements."""

    def __init__(self, blob: bytes):
        (size,) = struct.unpack_from('<I', blob)
        units = struct.unpack_from(f'<{size // 4}I', blob, 4)
        strings = blob[4 + size:]
        self.table: dict[str, str] = {}
        for key, value in _darts_keys(units):
            end = strings.index(b'\0', value)
            try:
                self.table[key.decode()] = strings[value:end].decode()
            except UnicodeDecodeError as e:
                raise _refuse('Precompiled charsmap key or value',
                              key) from e
        self.longest = max(map(len, self.table), default=0)
        self.starts = frozenset(k[0] for k in self.table)
        self._clusters: dict[str, str] = {}

    def first_match(self, chunk: str) -> str | None:
        """The replacement of the shortest key that starts ``chunk``."""
        for k in range(1, min(len(chunk), self.longest) + 1):
            hit = self.table.get(chunk[:k])
            if hit is not None:
                return hit
        return None

    def _cluster(self, g: str) -> str:
        out = self._clusters.get(g)
        if out is None:
            hit = None
            if len(g.encode('utf-8', 'surrogatepass')) < 6:
                hit = self.first_match(g)
            out = hit if hit is not None else ''.join(
                self.table.get(c, c) for c in g)
            self._clusters[g] = out
        return out

    def __call__(self, text: str) -> str:
        if self.starts.isdisjoint(text):
            return text
        return ''.join(map(self._cluster, uc.graphemes(text)))


def _darts_keys(units) -> list[tuple[bytes, int]]:
    """Every ``(key, value)`` of a Darts-clone double array: a unit's
    label in bits 0-7 (bit 31 marks a value unit), bit 8 a key's end,
    the offset to its children in bits 10-30 (times 256 when bit 9 is
    set)."""
    def offset(u):
        return (u >> 10) << ((u & (1 << 9)) >> 6)

    out, stack = [], [(0, b'')]
    n = len(units)
    while stack:
        pos, key = stack.pop()
        base = pos ^ offset(units[pos])
        if key and units[pos] & (1 << 8):
            out.append((key, units[base] & 0x7FFFFFFF))
        for c in range(1, 256):
            child = base ^ c
            if child < n and units[child] & 0x800000FF == c:
                stack.append((child, key + bytes((c,))))
    return out


# ---------------------------------------------------------------------------
# normalizers: str -> str

def _bert_normalizer(spec: dict):
    _check_keys('normalizer', spec, {'clean_text', 'handle_chinese_chars',
                                     'strip_accents', 'lowercase'})
    clean = spec.get('clean_text', True)
    chinese = spec.get('handle_chinese_chars', True)
    lower = spec.get('lowercase', True)
    strip = spec.get('strip_accents')
    strip = lower if strip is None else strip

    def run(text: str) -> str:
        if clean:
            text = ''.join(
                ' ' if c in uc.WHITESPACE else c for c in text
                if c not in '\x00\ufffd' and (c in '\t\n\r'
                                              or not uc.is_other(c)))
        if chinese:
            text = ''.join(f' {c} ' if _is_chinese(ord(c)) else c
                           for c in text)
        if strip:
            text = ''.join(c for c in uc.normalize('NFD', text)
                           if not uc.is_nonspacing_mark(c))
        if lower:
            text = ''.join(map(str.lower, text))
        return text
    return run


def _is_chinese(cp: int) -> bool:
    # tokenizers' ranges (0x2B920, not BERT's 0x2B820)
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B920 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def _lowercase(text: str) -> str:
    return ''.join(map(str.lower, text))


def _replace(spec: dict):
    _check_keys('normalizer', spec, {'pattern', 'content'})
    pattern, content = _pattern(spec, 'Replace'), spec['content']
    return lambda text: pattern.sub(lambda _: content, text)


def _strip(spec: dict):
    _check_keys('normalizer', spec, {'strip_left', 'strip_right'})
    ws = ''.join(uc.WHITESPACE)
    left, right = spec.get('strip_left', True), spec.get('strip_right', True)

    def run(text: str) -> str:
        if left:
            text = text.lstrip(ws)
        return text.rstrip(ws) if right else text
    return run


def _precompiled(spec: dict):
    _check_keys('normalizer', spec, {'precompiled_charsmap'})
    blob = spec.get('precompiled_charsmap')
    if not blob:
        return lambda text: text
    return Charsmap(base64.b64decode(blob))


def build_normalizer(spec: dict | None):
    """A function ``str -> str`` for a ``normalizer`` entry."""
    if spec is None:
        return None
    kind = spec.get('type')
    if kind == 'Sequence':
        _check_keys('normalizer', spec, {'normalizers'})
        steps = [build_normalizer(s) for s in spec['normalizers']]
        steps = [s for s in steps if s is not None]

        def run(text: str) -> str:
            for step in steps:
                text = step(text)
            return text
        return run
    if kind == 'BertNormalizer':
        return _bert_normalizer(spec)
    if kind in ('NFC', 'NFD', 'NFKC', 'NFKD'):
        _check_keys('normalizer', spec, set())
        return lambda text: uc.normalize(kind, text)
    if kind == 'Lowercase':
        return _lowercase
    if kind == 'StripAccents':
        _check_keys('normalizer', spec, set())
        return lambda text: ''.join(c for c in text
                                    if not uc.is_combining_mark(c))
    if kind == 'Replace':
        return _replace(spec)
    if kind == 'Strip':
        return _strip(spec)
    if kind == 'Prepend':
        _check_keys('normalizer', spec, {'prepend'})
        prefix = spec['prepend']
        return lambda text: prefix + text if text else text
    if kind == 'Precompiled':
        return _precompiled(spec)
    raise _refuse('normalizer', kind)


def _has_lowercase(spec: dict | None) -> bool:
    """Sentence Transformers' test before it adds ``Lowercase`` for
    ``do_lower_case``."""
    if spec is None:
        return False
    if spec.get('type') == 'Sequence':
        return any(s.get('type') == 'Lowercase' for s in spec['normalizers'])
    return spec.get('type') == 'Lowercase'


# ---------------------------------------------------------------------------
# pre-tokenizers: list[Split] -> list[Split]

def _spans_of(text: str, test) -> list[tuple[int, int, bool]]:
    """``(start, end, is_match)`` over ``text``: each character that
    ``test`` accepts is a match of its own."""
    out, last = [], 0
    for i, c in enumerate(text):
        if test(c):
            if last < i:
                out.append((last, i, False))
            out.append((i, i + 1, True))
            last = i + 1
    if last < len(text):
        out.append((last, len(text), False))
    return out


def _spans_re(text: str, pattern: re.Pattern) -> list[tuple[int, int, bool]]:
    out, last = [], 0
    for m in pattern.finditer(text):
        if last != m.start():
            out.append((last, m.start(), False))
        out.append((m.start(), m.end(), True))
        last = m.end()
    if last != len(text):
        out.append((last, len(text), False))
    return out


BEHAVIORS = ('Removed', 'Isolated', 'MergedWithPrevious', 'MergedWithNext',
             'Contiguous')


def _behavior(spec: dict, default: str | None = None) -> str:
    behavior = spec.get('behavior', default)
    if behavior not in BEHAVIORS:
        raise _refuse('split behavior', behavior)
    return behavior


def _apply(spans, behavior: str) -> list[tuple[int, int]]:
    """``tokenizers``' ``SplitDelimiterBehavior`` on the spans."""
    if behavior == 'Removed':
        return [(a, b) for a, b, m in spans if not m]
    if behavior == 'Isolated':
        return [(a, b) for a, b, _ in spans]
    out: list[list[int]] = []
    prev = False
    if behavior == 'MergedWithNext':
        for a, b, m in reversed(spans):
            if m and not prev and out:
                out[-1][0] = a
            else:
                out.append([a, b])
            prev = m
        return [tuple(s) for s in reversed(out)]
    for a, b, m in spans:
        if behavior == 'Contiguous':
            join = m == prev
        else:
            join = m and not prev
        if join and out:
            out[-1][1] = b
        else:
            out.append([a, b])
        prev = m
    return [tuple(s) for s in out]


def _cut(splits: list[Split], spans_fn, behavior: str,
         invert: bool = False) -> list[Split]:
    out = []
    for text, lead in splits:
        spans = spans_fn(text) if text else [(0, 0, False)]
        if invert:
            spans = [(a, b, not m) for a, b, m in spans]
        out.extend((text[a:b], max(0, lead - a))
                   for a, b in _apply(spans, behavior) if b > a)
    return out


class _ByteLevel:
    def __init__(self, spec: dict):
        _check_keys('pre_tokenizer', spec, {'add_prefix_space',
                                            'trim_offsets', 'use_regex'})
        self.prefix = spec.get('add_prefix_space', True)
        self.regex = spec.get('use_regex', True)
        self.bytes = bytes_to_unicode()

    def __call__(self, splits: list[Split]) -> list[Split]:
        out = []
        for text, lead in splits:
            if self.prefix and not text.startswith(' '):
                text = ' ' + text
                lead += lead > 0
            words = gpt2_pretokenize(text) if self.regex else [text]
            at = 0
            for w in words:
                head = w[:max(0, lead - at)]
                out.append((''.join(self.bytes[b] for b in w.encode()),
                            len(head.encode())))
                at += len(w)
        return out


class _Metaspace:
    def __init__(self, spec: dict):
        _check_keys('pre_tokenizer', spec, {'replacement', 'prepend_scheme',
                                            'split', 'add_prefix_space',
                                            'str_rep'})
        self.rep = spec.get('replacement', '▁')
        scheme = spec.get('prepend_scheme')
        if scheme is None:
            scheme = 'always' if spec.get('add_prefix_space', True) \
                else 'never'
        if scheme not in ('always', 'first', 'never'):
            raise _refuse('Metaspace prepend_scheme', scheme)
        self.scheme = scheme
        self.split = spec.get('split', True)

    def __call__(self, splits: list[Split]) -> list[Split]:
        out = []
        for text, lead in splits:
            text = text.replace(' ', self.rep)
            if text and not text.startswith(self.rep) and (
                    self.scheme == 'always'
                    or (self.scheme == 'first' and lead > 0)):
                text = self.rep + text
                lead += lead > 0
            if self.split:
                out.extend(_cut([(text, lead)],
                                lambda t: _spans_of(t, self.rep.__eq__),
                                'MergedWithNext'))
            elif text:
                out.append((text, lead))
        return out


def _uses_first(spec: dict | None) -> bool:
    if spec is None:
        return False
    if spec.get('type') == 'Sequence':
        return any(map(_uses_first, spec['pretokenizers']))
    return spec.get('type') == 'Metaspace' \
        and spec.get('prepend_scheme') == 'first'


def build_pre_tokenizer(spec: dict | None):
    """A function ``list[Split] -> list[Split]`` for a ``pre_tokenizer``
    entry (``None``: the identity)."""
    if spec is None:
        return lambda splits: splits
    kind = spec.get('type')
    if kind == 'Sequence':
        _check_keys('pre_tokenizer', spec, {'pretokenizers'})
        steps = [build_pre_tokenizer(s) for s in spec['pretokenizers']]

        def run(splits):
            for step in steps:
                splits = step(splits)
            return splits
        return run
    if kind == 'BertPreTokenizer':
        def bert(splits):
            splits = _cut(splits, lambda t: _spans_of(
                t, uc.WHITESPACE.__contains__), 'Removed')
            return _cut(splits, lambda t: _spans_of(
                t, uc.is_bert_punctuation), 'Isolated')
        return bert
    if kind == 'WhitespaceSplit':
        return lambda splits: _cut(splits, lambda t: _spans_of(
            t, uc.WHITESPACE.__contains__), 'Removed')
    if kind == 'Whitespace':
        # \w+|[^\w\s]+ in Rust's regex, not Oniguruma
        word, space = uc.class_body('rust_w'), uc.class_body('s')
        pattern = re.compile(f'[{word}]+|[^{word}{space}]+')
        return lambda splits: _cut(splits, lambda t: _spans_re(t, pattern),
                                   'Removed', invert=True)
    if kind == 'Punctuation':
        _check_keys('pre_tokenizer', spec, {'behavior'})
        behavior = _behavior(spec, 'Isolated')
        return lambda splits: _cut(splits, lambda t: _spans_of(
            t, uc.is_bert_punctuation), behavior)
    if kind == 'Digits':
        _check_keys('pre_tokenizer', spec, {'individual_digits'})
        behavior = 'Isolated' if spec.get('individual_digits') \
            else 'Contiguous'
        return lambda splits: _cut(splits, lambda t: _spans_of(
            t, uc.is_numeric), behavior)
    if kind == 'Split':
        _check_keys('pre_tokenizer', spec, {'pattern', 'behavior', 'invert'})
        pattern = _pattern(spec, 'Split')
        behavior, invert = _behavior(spec), bool(spec.get('invert'))
        return lambda splits: _cut(splits, lambda t: _spans_re(t, pattern),
                                   behavior, invert)
    if kind == 'ByteLevel':
        return _ByteLevel(spec)
    if kind == 'Metaspace':
        return _Metaspace(spec)
    raise _refuse('pre_tokenizer', kind)


# ---------------------------------------------------------------------------
# models: a pre-token -> ids

class WordPiece:
    def __init__(self, spec: dict):
        _check_keys('model', spec, {'vocab', 'unk_token',
                                    'continuing_subword_prefix',
                                    'max_input_chars_per_word'})
        self.vocab = spec['vocab']
        self.unk = spec.get('unk_token', '[UNK]')
        self.prefix = spec.get('continuing_subword_prefix', '##')
        self.max_chars = spec.get('max_input_chars_per_word', 100)
        self._cache: dict[str, list[int]] = {}

    def __call__(self, word: str) -> list[int]:
        ids = self._cache.get(word)
        if ids is None:
            ids = self._cache[word] = self._pieces(word)
        return ids

    def _pieces(self, word: str) -> list[int]:
        unk = [self.vocab[self.unk]]
        if len(word) > self.max_chars:
            return unk
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            while start < end:
                piece = word[start:end] if start == 0 \
                    else self.prefix + word[start:end]
                if piece in self.vocab:
                    break
                end -= 1
            else:
                return unk
            ids.append(self.vocab[piece])
            start = end
        return ids


def _byte_pieces(vocab: dict, text: str) -> list[int] | None:
    ids = [vocab.get(f'<0x{b:02X}>') for b in text.encode()]
    return None if None in ids else ids


class BPE:
    def __init__(self, spec: dict):
        _check_keys('model', spec, {'vocab', 'merges', 'dropout',
                                    'unk_token', 'continuing_subword_prefix',
                                    'end_of_word_suffix', 'fuse_unk',
                                    'byte_fallback', 'ignore_merges'})
        if spec.get('dropout') not in (None, 0, 0.0):
            raise _refuse('BPE dropout', spec['dropout'])
        self.vocab = spec['vocab']
        self.unk = spec.get('unk_token')
        self.prefix = spec.get('continuing_subword_prefix') or ''
        self.suffix = spec.get('end_of_word_suffix') or ''
        self.fuse_unk = bool(spec.get('fuse_unk', False))
        self.byte_fallback = bool(spec.get('byte_fallback', False))
        self.ignore_merges = bool(spec.get('ignore_merges', False))
        self.merges: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, m in enumerate(spec['merges']):
            a, b = m.split(' ', 1) if isinstance(m, str) else m
            new = a + b[len(self.prefix):]
            self.merges[self.vocab[a], self.vocab[b]] = (rank,
                                                         self.vocab[new])
        self._cache: dict[str, list[int]] = {}

    def __call__(self, word: str) -> list[int]:
        ids = self._cache.get(word)
        if ids is None:
            ids = self._cache[word] = self._word(word)
        return ids

    def _word(self, word: str) -> list[int]:
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        symbols: list[int] = []
        unk: int | None = None
        for i, ch in enumerate(word):
            s = ch if i == 0 else self.prefix + ch
            if i == len(word) - 1:
                s += self.suffix
            tid = self.vocab.get(s)
            if tid is not None:
                if unk is not None:
                    symbols.append(unk)
                    unk = None
                symbols.append(tid)
                continue
            if self.byte_fallback:
                ids = _byte_pieces(self.vocab, s)
                if ids is not None:
                    symbols.extend(ids)
                    continue
            if self.unk is not None:
                if unk is not None and not self.fuse_unk:
                    symbols.append(unk)
                unk = self.vocab[self.unk]
        if unk is not None:
            symbols.append(unk)
        return self._merge(symbols)

    def _merge(self, symbols: list[int]) -> list[int]:
        """``tokenizers``' ``Word::merge_all``: the lowest rank first, then
        the leftmost, over a linked list of symbols."""
        n = len(symbols)
        nxt = list(range(1, n + 1))
        prv = list(range(-1, n - 1))
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            m = self.merges.get((symbols[i], symbols[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            rank, pos, new = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] >= n:
                continue
            right = nxt[pos]
            m = self.merges.get((symbols[pos], symbols[right]))
            if m is None or m[1] != new:
                continue
            symbols[pos] = new
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[pos] < n:
                prv[nxt[pos]] = pos
            if prv[pos] >= 0:
                m = self.merges.get((symbols[prv[pos]], new))
                if m is not None:
                    heapq.heappush(heap, (m[0], prv[pos], m[1]))
            if nxt[pos] < n:
                m = self.merges.get((new, symbols[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [s for s, a in zip(symbols, alive) if a]


class Unigram:
    """SentencePiece's unigram model as ``tokenizers`` runs it
    (``encode_optimized``): the best path over the character lattice, each
    piece's end keeping the first best score, a character without a
    one-character piece an unknown at the lowest score less 10."""

    def __init__(self, spec: dict):
        _check_keys('model', spec, {'unk_id', 'vocab', 'byte_fallback'})
        self.vocab: dict[str, int] = {}
        self.scores: list[float] = []
        self.prefixes: set[str] = set()
        for i, (piece, score) in enumerate(spec['vocab']):
            self.vocab[piece] = i
            self.scores.append(float(score))
            for k in range(len(piece), 0, -1):
                if piece[:k] in self.prefixes:
                    break
                self.prefixes.add(piece[:k])
        self.unk_id = spec.get('unk_id')
        self.unk_score = min(self.scores) - 10.0
        self.byte_fallback = bool(spec.get('byte_fallback', False))
        self._cache: dict[str, list[int]] = {}

    def __call__(self, word: str) -> list[int]:
        ids = self._cache.get(word)
        if ids is None:
            ids = self._cache[word] = self._ids(word)
        return ids

    def _ids(self, word: str) -> list[int]:
        out = []
        for piece in self.pieces(word):
            pid = self.vocab.get(piece)
            if pid is None and self.byte_fallback:
                out.extend(_byte_pieces(self.vocab, piece) or [self._unk()])
            else:
                out.append(self._unk() if pid is None else pid)
        return out

    def _unk(self) -> int:
        if self.unk_id is None:
            raise ValueError('Unigram model without unk_id met an unknown '
                             'character')
        return self.unk_id

    def pieces(self, text: str) -> list[str]:
        n = len(text)
        score = [0.0] * (n + 1)
        start: list[int | None] = [None] * (n + 1)
        node = [0] * (n + 1)
        vocab, scores, prefixes = self.vocab, self.scores, self.prefixes
        for i in range(n):
            here = score[i]
            single = False
            k = i + 1
            while k <= n:
                piece = text[i:k]
                if piece not in prefixes:
                    break
                pid = vocab.get(piece)
                if pid is not None:
                    cand = scores[pid] + here
                    if start[k] is None or cand > score[k]:
                        score[k], start[k], node[k] = cand, i, pid
                    if k == i + 1:
                        single = True
                k += 1
            if not single:
                cand = self.unk_score + here
                if start[i + 1] is None or cand > score[i + 1]:
                    score[i + 1], start[i + 1] = cand, i
                    node[i + 1] = self._unk()
        out, end, unk_run = [], n, []
        while end > 0:
            s = start[end]
            if node[end] == self.unk_id:
                unk_run.append(text[s:end])
            else:
                if unk_run:
                    out.append(''.join(reversed(unk_run)))
                    unk_run = []
                out.append(text[s:end])
            end = s
        if unk_run:
            out.append(''.join(reversed(unk_run)))
        return out[::-1]


def build_model(spec: dict):
    kind = spec.get('type')
    models = {'WordPiece': WordPiece, 'BPE': BPE, 'Unigram': Unigram}
    if kind not in models:
        raise _refuse('model', kind)
    return models[kind](spec)


# ---------------------------------------------------------------------------
# post-processors: (the ids they add, ids -> ids)

def build_post_processor(spec: dict | None):
    """``(added, run)``: the number of tokens the post-processor adds to one
    sequence, and ``ids -> ids``."""
    if spec is None:
        return 0, lambda ids: ids
    kind = spec.get('type')
    if kind == 'Sequence':
        _check_keys('post_processor', spec, {'processors'})
        steps = [build_post_processor(s) for s in spec['processors']]

        def run(ids):
            for _, step in steps:
                ids = step(ids)
            return ids
        return sum(a for a, _ in steps), run
    if kind == 'ByteLevel':
        _check_keys('post_processor', spec, {'add_prefix_space',
                                             'trim_offsets', 'use_regex'})
        return 0, lambda ids: ids
    if kind in ('BertProcessing', 'RobertaProcessing'):
        _check_keys('post_processor', spec, {'sep', 'cls', 'trim_offsets',
                                             'add_prefix_space'})
        cls, sep = spec['cls'][1], spec['sep'][1]
        return 2, lambda ids: [cls, *ids, sep]
    if kind == 'TemplateProcessing':
        _check_keys('post_processor', spec, {'single', 'pair',
                                             'special_tokens'})
        parts = []
        for item in spec['single']:
            if 'Sequence' in item:
                if item['Sequence']['id'] != 'A':
                    raise _refuse('TemplateProcessing sequence', item)
                parts.append(None)
            else:
                name = item['SpecialToken']['id']
                parts.append(list(spec['special_tokens'][name]['ids']))
        added = sum(len(p) for p in parts if p is not None)

        def template(ids):
            out = []
            for p in parts:
                out.extend(ids if p is None else p)
            return out
        return added, template
    raise _refuse('post_processor', kind)


# ---------------------------------------------------------------------------
# added tokens

class AddedTokens:
    """The split on ``added_tokens``: leftmost longest matches of their
    text (normalized with the normalizer where marked ``normalized``)."""

    def __init__(self, entries: list[dict], normalizer):
        raw, norm = {}, {}
        for e in entries:
            unknown = set(e) - {'id', 'content', 'single_word', 'lstrip',
                                'rstrip', 'normalized', 'special'}
            if unknown:
                raise _refuse('added_tokens options', e)
            text = e['content']
            if e.get('normalized', not e.get('special', False)):
                key = normalizer(text) if normalizer else text
                norm[key] = e
            else:
                raw[text] = e
        self.raw, self.norm = self._matcher(raw), self._matcher(norm)

    @staticmethod
    def _matcher(entries: dict[str, dict]):
        if not entries:
            return None
        alts = sorted((t for t in entries if t), key=len, reverse=True)
        return re.compile('|'.join(map(re.escape, alts))), entries

    def split(self, text: str, lead: int, which: str) -> list:
        """``text`` cut on the tokens of ``which`` (``raw``/``norm``):
        ``Split`` pieces and ``int`` ids, in order."""
        matcher = self.raw if which == 'raw' else self.norm
        if matcher is None:
            return [(text, lead)] if text else []
        pattern, entries = matcher
        out, done = [], 0
        for m in pattern.finditer(text):
            start, stop = m.start(), m.end()
            e = entries[m[0]]
            if e.get('single_word') and (
                    (start > 0 and uc.is_word(text[start - 1]))
                    or (stop < len(text) and uc.is_word(text[stop]))):
                continue
            if e.get('lstrip'):
                while start > done and text[start - 1] in uc.WHITESPACE:
                    start -= 1
            if e.get('rstrip'):
                while stop < len(text) and text[stop] in uc.WHITESPACE:
                    stop += 1
            if done < start:
                out.append((text[done:start], max(0, lead - done)))
            out.append(e['id'])
            done = stop
        if done < len(text):
            out.append((text[done:], max(0, lead - done)))
        return out


# ---------------------------------------------------------------------------
# the tokenizer

class JsonTokenizer:
    """The ids of a ``tokenizer.json`` as the fast tokenizers give them
    (module docstring), with the callers' interface of the port's other
    tokenizers: ``encode(text, max_length)``, ``__call__(sentences,
    max_length) -> (ids, mask)``, ``max_length(cap)``, ``lower``."""

    def __init__(self, spec: dict, *, pad_token: str | None,
                 model_max_length: int | None = None):
        unported = {k: spec[k] for k in spec
                    if k not in ('version', 'truncation', 'padding',
                                 'added_tokens', 'normalizer',
                                 'pre_tokenizer', 'model', 'post_processor',
                                 'decoder')}
        if unported:
            raise _refuse('keys', unported)
        self.spec = spec
        self.model_max_length = model_max_length
        self.model = build_model(spec['model'])
        self.pre_tokenizer = build_pre_tokenizer(spec.get('pre_tokenizer'))
        self.added, self.post = build_post_processor(
            spec.get('post_processor'))
        self._lower = False
        self._normalize()
        self._leads = _uses_first(spec.get('pre_tokenizer'))
        self.pad_id = None if pad_token is None else self.token_id(pad_token)

    @property
    def lower(self) -> bool:
        return self._lower

    @lower.setter
    def lower(self, value: bool):
        """Sentence Transformers' ``do_lower_case``: a ``Lowercase``
        normalizer put first, unless the normalizer has one."""
        self._lower = bool(value)
        self._normalize()

    def _normalize(self):
        spec = self.spec.get('normalizer')
        if self._lower and not _has_lowercase(spec):
            rest = ([] if spec is None else spec['normalizers']
                    if spec.get('type') == 'Sequence' else [spec])
            spec = {'type': 'Sequence',
                    'normalizers': [{'type': 'Lowercase'}, *rest]}
        self.normalizer = build_normalizer(spec)
        self.added_tokens = AddedTokens(self.spec.get('added_tokens', []),
                                        self.normalizer)

    @classmethod
    def from_dir(cls, model_dir: str) -> 'JsonTokenizer':
        with open(os.path.join(model_dir, 'tokenizer.json'),
                  encoding='utf-8') as f:
            spec = loads(f.read())
        conf = read_json(os.path.join(model_dir, 'tokenizer_config.json'))
        smap = read_json(os.path.join(model_dir, 'special_tokens_map.json'))
        for side in ('padding_side', 'truncation_side'):
            if conf.get(side, 'right') != 'right':
                raise _refuse(side.replace('_', ' '), conf[side])
        pad = smap.get('pad_token', conf.get('pad_token'))
        if isinstance(pad, dict):
            pad = pad['content']
        known = {e['content'] for e in spec.get('added_tokens', [])}
        extra = [e['content']
                 for e in conf.get('added_tokens_decoder', {}).values()
                 if e['content'] not in known]
        if extra:
            raise _refuse('added tokens of tokenizer_config.json missing '
                          'from tokenizer.json', extra)
        # transformers' BERT- and RoBERTa-family fast classes rebuild a
        # BertNormalizer or ByteLevel that disagrees with these settings
        for part, key, setting in (
                ('normalizer', 'lowercase', 'do_lower_case'),
                ('normalizer', 'strip_accents', 'strip_accents'),
                ('normalizer', 'handle_chinese_chars',
                 'tokenize_chinese_chars'),
                ('pre_tokenizer', 'add_prefix_space', 'add_prefix_space')):
            component = spec.get(part) or {}
            if component.get('type') in ('BertNormalizer', 'ByteLevel') \
                    and conf.get(setting, component.get(key)) \
                    != component.get(key):
                raise _refuse(f'tokenizer_config.json {setting} against the '
                              f'{component["type"]}', conf[setting])
        mml = conf.get('model_max_length')
        return cls(spec, pad_token=pad,
                   model_max_length=None if mml is None else int(mml))

    def token_id(self, token: str) -> int:
        for e in self.spec.get('added_tokens', []):
            if e['content'] == token:
                return e['id']
        if token not in self.model.vocab:
            raise KeyError(f'token {token!r} is not in the tokenizer')
        return self.model.vocab[token]

    def _lead(self, piece: str) -> int:
        """How many characters of the normalized ``piece`` stand for its
        first character: what it normalizes to alone, where the whole
        starts so, else 1 (it merged with the next)."""
        head = self.normalizer(piece[0])
        return len(head) if self.normalizer(piece).startswith(head) else 1

    def max_length(self, cap: int = 512) -> int:
        return capped_length(self.model_max_length, cap)

    def tokenize(self, text: str) -> list[int]:
        """The ids before truncation and the post-processor."""
        ids: list[int] = []
        for part in self.added_tokens.split(text, 1, 'raw'):
            if isinstance(part, int):
                ids.append(part)
                continue
            piece, lead = part
            if self.normalizer is not None:
                if lead and self._leads:
                    lead = self._lead(piece)
                piece = self.normalizer(piece)
            for sub in self.added_tokens.split(piece, lead, 'norm'):
                if isinstance(sub, int):
                    ids.append(sub)
                    continue
                for word, _ in self.pre_tokenizer([sub]):
                    ids.extend(self.model(word))
        return ids

    def encode(self, text: str, max_length: int | None = None) -> list[int]:
        ids = self.tokenize(text)
        if max_length is not None and max_length >= self.added:
            ids = ids[:max_length - self.added]
        return self.post(ids)

    def __call__(self, sentences: list[str], max_length: int):
        """``(ids, mask)``, int64 ``(B, L)``, padded to the longest row."""
        if self.pad_id is None:
            raise ValueError('the tokenizer has no pad token')
        return pad_rows([self.encode(s, max_length) for s in sentences],
                        self.pad_id)


