"""SentencePiece's precompiled charsmap, built in plain Python, for tests
and synthetic model directories.

The blob that ``tokenizer.json``'s ``Precompiled`` normalizer carries
(base64) is a little-endian ``uint32`` byte size of the trie, the trie as
a Darts-clone double array of ``uint32`` units over the UTF-8 bytes of
the keys, then the replacement strings, each ending in a NUL byte; a
key's value is the byte offset of its replacement.

A unit of the double array: bits 0-7 the label (the byte that leads to
it), bit 8 set when the node ends a key, bits 10-30 the offset to the
node's children (shifted left by 8 more when bit 9 is set), bit 31 set
on a value unit, whose low 31 bits are the value.  The children of a
node at position ``p`` lie at ``(p ^ offset) ^ byte``, its value at
``p ^ offset``.

``nfkc_mappings`` gives the NFKC mappings of a set of code points, and
some sequences of two (a letter and a combining mark), the way
SentencePiece's ``nmt_nfkc`` rule table lists them.
"""

from __future__ import annotations

import base64
import struct
import unicodedata


def _tree(keys: dict[bytes, int]) -> dict:
    root: dict = {}
    for key, value in keys.items():
        node = root
        for b in key:
            node = node.setdefault(b, {})
        node[None] = value
    return root


def double_array(keys: dict[bytes, int]) -> list[int]:
    """The Darts-clone units of ``keys`` (non-empty byte strings, no NUL
    byte, values below 2**31), each node's children placed at the first
    free base that no other node uses."""
    units = [0] * 256
    used = [False] * 256
    used[0] = True
    bases: set[int] = set()
    queue = [(0, _tree(keys))]
    next_free = 1
    while queue:
        pos, node = queue.pop(0)
        labels = sorted(k for k in node if k is not None)
        if None in node:
            labels = [0] + labels
        if not labels:
            continue
        base = next_free
        while True:
            offset = pos ^ base
            fits = offset < (1 << 21) or (offset % 256 == 0
                                           and offset >> 8 < (1 << 21))
            if base not in bases and fits:
                block = (base | 255) + 1
                while len(units) < block:
                    units.extend([0] * 256)
                    used.extend([False] * 256)
                if not any(used[base ^ c] for c in labels):
                    break
            base += 1
        bases.add(base)
        offset = pos ^ base
        if offset < (1 << 21):
            units[pos] |= offset << 10
        else:
            units[pos] |= ((offset >> 8) << 10) | (1 << 9)
        if None in node:
            units[pos] |= 1 << 8
            units[base] = node[None] | (1 << 31)
            used[base] = True
        for c in labels:
            if c == 0:
                continue
            units[base ^ c] = c
            used[base ^ c] = True
            queue.append((base ^ c, node[c]))
        while next_free < len(used) and used[next_free]:
            next_free += 1
    return units


def charsmap(mapping: dict[str, str]) -> bytes:
    """The precompiled charsmap of ``mapping`` (key text to replacement
    text; a replacement may be empty)."""
    blob = bytearray()
    where: dict[str, int] = {}
    keys: dict[bytes, int] = {}
    for key in sorted(mapping, key=lambda k: k.encode()):
        value = mapping[key]
        if value not in where:
            where[value] = len(blob)
            blob += value.encode() + b'\0'
        keys[key.encode()] = where[value]
    units = double_array(keys)
    trie = struct.pack(f'<{len(units)}I', *units)
    return struct.pack('<I', len(trie)) + trie + bytes(blob)


def charsmap_b64(mapping: dict[str, str]) -> str:
    return base64.b64encode(charsmap(mapping)).decode()


def nfkc_mappings(limit: int = 400) -> dict[str, str]:
    """Up to ``limit`` single code points that NFKC changes (full-width
    forms, ligatures, compatibility digits and letters, Hangul compatibility
    jamo, katakana half-widths ...) with their NFKC forms, the Indic nukta
    consonants, some spaces and controls mapped to a space or removed as
    ``nmt_nfkc`` does, and letter + combining mark pairs mapped to their
    composed form."""
    out: dict[str, str] = {}
    ranges = [(0xA0, 0x17F), (0x2000, 0x2190), (0x2460, 0x24FF),
              (0x3000, 0x30FF), (0x3130, 0x318F), (0xFB00, 0xFB06),
              (0xFF01, 0xFFEE), (0x1D400, 0x1D420)]
    for lo, hi in ranges:
        for cp in range(lo, hi + 1):
            c = chr(cp)
            if unicodedata.category(c) in ('Cn', 'Cs'):
                continue
            n = unicodedata.normalize('NFKC', c)
            if n != c:
                out[c] = n
    picked = dict(list(out.items())[::max(1, len(out) // limit)][:limit])
    picked.update({'\u200b': '', '\ufeff': '', '\u00ad': '', '\t': ' ',
                   '\n': ' ', '\r': ' ', '\u3000': ' ', '\u00a0': ' ',
                   '\u2009': ' '})
    for base in 'aeiouAEIOUnc':
        for mark in '\u0300\u0301\u0302\u0303\u0308\u0327':
            composed = unicodedata.normalize('NFC', base + mark)
            if len(composed) == 1:
                picked[base + mark] = composed
    # the nukta consonants of Devanagari, Bengali and Oriya (composition
    # exclusions): their clusters show where Indic conjuncts (GB9c) join
    for cp in (*range(0x958, 0x960), 0x9DC, 0x9DD, 0x9DF, 0xB5C, 0xB5D):
        picked[chr(cp)] = unicodedata.normalize('NFKC', chr(cp))
    # a key that is a prefix of another: the first match wins
    picked['\uff21'] = 'A'
    picked['\uff21\u0301'] = '\u00c1'
    return picked
