"""Unicode classes as the ``tokenizers`` library (which reads
``tokenizer.json``) applies them, with no ``regex`` module: its old
character tables, extended grapheme clusters, and Oniguruma patterns
translated for Python's ``re``.

``tokenizers`` compiles in crates whose tables predate Python's
``unicodedata`` (Unicode 15.0): its BERT punctuation and control classes,
its non-spacing and combining marks and its compatibility decompositions
are older.  ``*_ADDED``/``*_REMOVED`` list the code points where its class
differs from the general categories of ``unicodedata`` (``*_KEPT``: the
characters that its normalization forms leave alone);
``tests/test_torch_tokenizer_json.py`` holds each class against
``tokenizers`` over every assigned code point.  Oniguruma's ``\\s``,
``\\d`` and ``\\p{..}`` are the current properties.
"""

from __future__ import annotations

import functools
import re
import sys
import unicodedata

# the old tables of ``tokenizers`` (see the module docstring)
PUNCT_ADDED = (
    (0x166D, 0x166D), (0x111C9, 0x111C9),)
PUNCT_REMOVED = (
    (0x61D, 0x61D), (0x9FD, 0x9FD), (0xA76, 0xA76), (0xC77, 0xC77),
    (0xC84, 0xC84), (0x1B7D, 0x1B7E), (0x2E43, 0x2E4F), (0x2E52, 0x2E5D),
    (0x10EAD, 0x10EAD), (0x10F55, 0x10F59), (0x10F86, 0x10F89),
    (0x1144B, 0x1144F), (0x1145A, 0x1145B), (0x1145D, 0x1145D),
    (0x11660, 0x1166C), (0x116B9, 0x116B9), (0x1183B, 0x1183B),
    (0x11944, 0x11946), (0x119E2, 0x119E2), (0x11A3F, 0x11A46),
    (0x11A9A, 0x11A9C), (0x11A9E, 0x11AA2), (0x11B00, 0x11B09),
    (0x11C41, 0x11C45), (0x11C70, 0x11C71), (0x11EF7, 0x11EF8),
    (0x11F43, 0x11F4F), (0x11FFF, 0x11FFF), (0x12FF1, 0x12FF2),
    (0x16E97, 0x16E9A), (0x16FE2, 0x16FE2), (0x1E95E, 0x1E95F),)
OTHER_REMOVED = (
    (0x890, 0x891), (0x8E2, 0x8E2), (0x110CD, 0x110CD), (0x13430, 0x1343F),)
MARK_ADDED = (
    (0x1CF2, 0x1CF3),)
MARK_REMOVED = (
    (0x7FD, 0x7FD), (0x898, 0x89F), (0x8CA, 0x8D3), (0x9FE, 0x9FE),
    (0xAFA, 0xAFF), (0xB55, 0xB55), (0xC04, 0xC04), (0xC3C, 0xC3C),
    (0xCF3, 0xCF3), (0xD00, 0xD00), (0xD3B, 0xD3C), (0xD81, 0xD81),
    (0xEBA, 0xEBA), (0xECE, 0xECE), (0x1715, 0x1715), (0x180F, 0x180F),
    (0x1ABF, 0x1ACE), (0x1CF7, 0x1CF7), (0x1DF6, 0x1DFA), (0xA82C, 0xA82C),
    (0xA8FF, 0xA8FF), (0x10D24, 0x10D27), (0x10EAB, 0x10EAC),
    (0x10EFD, 0x10EFF), (0x10F46, 0x10F50), (0x10F82, 0x10F85),
    (0x11070, 0x11070), (0x11073, 0x11074), (0x110C2, 0x110C2),
    (0x11145, 0x11146), (0x111C9, 0x111C9), (0x111CE, 0x111CF),
    (0x11241, 0x11241), (0x1133B, 0x1133B), (0x1145E, 0x1145E),
    (0x1182C, 0x1183A), (0x11930, 0x11935), (0x11937, 0x11938),
    (0x1193B, 0x1193E), (0x11940, 0x11940), (0x11942, 0x11943),
    (0x119D1, 0x119D7), (0x119DA, 0x119E0), (0x119E4, 0x119E4),
    (0x11A01, 0x11A0A), (0x11A33, 0x11A39), (0x11A3B, 0x11A3E),
    (0x11A47, 0x11A47), (0x11A51, 0x11A5B), (0x11A8A, 0x11A99),
    (0x11D31, 0x11D36), (0x11D3A, 0x11D3A), (0x11D3C, 0x11D3D),
    (0x11D3F, 0x11D45), (0x11D47, 0x11D47), (0x11D8A, 0x11D8E),
    (0x11D90, 0x11D91), (0x11D93, 0x11D97), (0x11EF3, 0x11EF6),
    (0x11F00, 0x11F01), (0x11F03, 0x11F03), (0x11F34, 0x11F3A),
    (0x11F3E, 0x11F42), (0x13440, 0x13440), (0x13447, 0x13455),
    (0x16F4F, 0x16F4F), (0x16F7F, 0x16F87), (0x16FE4, 0x16FE4),
    (0x16FF0, 0x16FF1), (0x1CF00, 0x1CF2D), (0x1CF30, 0x1CF46),
    (0x1E08F, 0x1E08F), (0x1E130, 0x1E136), (0x1E2AE, 0x1E2AE),
    (0x1E2EC, 0x1E2EF), (0x1E4EC, 0x1E4EF),)
MN_ADDED = (
    (0x1734, 0x1734),)
MN_REMOVED = (
    (0x7FD, 0x7FD), (0x898, 0x89F), (0x8CA, 0x8E1), (0x9FE, 0x9FE),
    (0xAFA, 0xAFF), (0xB55, 0xB55), (0xC04, 0xC04), (0xC3C, 0xC3C),
    (0xD00, 0xD00), (0xD3B, 0xD3C), (0xD81, 0xD81), (0xEBA, 0xEBA),
    (0xECE, 0xECE), (0x180F, 0x180F), (0x1885, 0x1886), (0x1ABF, 0x1ACE),
    (0x1DF6, 0x1DFB), (0xA82C, 0xA82C), (0xA8C5, 0xA8C5), (0xA8FF, 0xA8FF),
    (0xA9BD, 0xA9BD), (0x10D24, 0x10D27), (0x10EAB, 0x10EAC),
    (0x10EFD, 0x10EFF), (0x10F46, 0x10F50), (0x10F82, 0x10F85),
    (0x11070, 0x11070), (0x11073, 0x11074), (0x110C2, 0x110C2),
    (0x111C9, 0x111C9), (0x111CF, 0x111CF), (0x1123E, 0x1123E),
    (0x11241, 0x11241), (0x1133B, 0x1133B), (0x11438, 0x1143F),
    (0x11442, 0x11444), (0x11446, 0x11446), (0x1145E, 0x1145E),
    (0x1182F, 0x11837), (0x11839, 0x1183A), (0x1193B, 0x1193C),
    (0x1193E, 0x1193E), (0x11943, 0x11943), (0x119D4, 0x119D7),
    (0x119DA, 0x119DB), (0x119E0, 0x119E0), (0x11A01, 0x11A0A),
    (0x11A33, 0x11A38), (0x11A3B, 0x11A3E), (0x11A47, 0x11A47),
    (0x11A51, 0x11A56), (0x11A59, 0x11A5B), (0x11A8A, 0x11A96),
    (0x11A98, 0x11A99), (0x11C30, 0x11C36), (0x11C38, 0x11C3D),
    (0x11C3F, 0x11C3F), (0x11C92, 0x11CA7), (0x11CAA, 0x11CB0),
    (0x11CB2, 0x11CB3), (0x11CB5, 0x11CB6), (0x11D31, 0x11D36),
    (0x11D3A, 0x11D3A), (0x11D3C, 0x11D3D), (0x11D3F, 0x11D45),
    (0x11D47, 0x11D47), (0x11D90, 0x11D91), (0x11D95, 0x11D95),
    (0x11D97, 0x11D97), (0x11EF3, 0x11EF4), (0x11F00, 0x11F01),
    (0x11F36, 0x11F3A), (0x11F40, 0x11F40), (0x11F42, 0x11F42),
    (0x13440, 0x13440), (0x13447, 0x13455), (0x16F4F, 0x16F4F),
    (0x16FE4, 0x16FE4), (0x1CF00, 0x1CF2D), (0x1CF30, 0x1CF46),
    (0x1E000, 0x1E006), (0x1E008, 0x1E018), (0x1E01B, 0x1E021),
    (0x1E023, 0x1E024), (0x1E026, 0x1E02A), (0x1E08F, 0x1E08F),
    (0x1E130, 0x1E136), (0x1E2AE, 0x1E2AE), (0x1E2EC, 0x1E2EF),
    (0x1E4EC, 0x1E4EF), (0x1E944, 0x1E94A),)
NFD_KEPT = (
    (0x11938, 0x11938),)
NFKD_KEPT = (
    (0x32FF, 0x32FF), (0xA7F2, 0xA7F4), (0xAB69, 0xAB69), (0x10781, 0x10785),
    (0x10787, 0x107B0), (0x107B2, 0x107BA), (0x11938, 0x11938),
    (0x1E030, 0x1E06D), (0x1F16C, 0x1F16C), (0x1FBF0, 0x1FBF9),)
NFKC_KEPT = (
    (0x32FF, 0x32FF), (0xA7F2, 0xA7F4), (0xAB69, 0xAB69), (0x10781, 0x10785),
    (0x10787, 0x107B0), (0x107B2, 0x107BA), (0x1E030, 0x1E06D),
    (0x1F16C, 0x1F16C), (0x1FBF0, 0x1FBF9),)


def _codes(ranges) -> frozenset[int]:
    return frozenset(cp for lo, hi in ranges for cp in range(lo, hi + 1))


_PUNCT_ADDED, _PUNCT_REMOVED = _codes(PUNCT_ADDED), _codes(PUNCT_REMOVED)
_OTHER_REMOVED = _codes(OTHER_REMOVED)
_MARK_ADDED, _MARK_REMOVED = _codes(MARK_ADDED), _codes(MARK_REMOVED)
_MN_ADDED, _MN_REMOVED = _codes(MN_ADDED), _codes(MN_REMOVED)
_KEPT = {'NFD': _codes(NFD_KEPT), 'NFKD': _codes(NFKD_KEPT),
         'NFKC': _codes(NFKC_KEPT), 'NFC': frozenset()}

# the Unicode White_Space property: Rust's char::is_whitespace and
# Oniguruma's \s
WHITESPACE = frozenset(map(chr, (
    0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0, 0x1680,
    *range(0x2000, 0x200B), 0x2028, 0x2029, 0x202F, 0x205F, 0x3000)))
# word characters beyond letters, marks, Nd, Nl and Pc: Other_Alphabetic
# symbols; Rust's regex adds Join_Control, Oniguruma's \w Latin-1's No
_WORD_EXTRA = _codes(((0x24B6, 0x24E9), (0x1F130, 0x1F149),
                      (0x1F150, 0x1F169), (0x1F170, 0x1F189)))
_LATIN1_NO = _codes(((0xB2, 0xB3), (0xB9, 0xB9), (0xBC, 0xBE)))


@functools.lru_cache(maxsize=None)
def is_bert_punctuation(ch: str) -> bool:
    """``tokenizers``' BERT punctuation: ASCII punctuation, or its
    (older) Unicode P* class."""
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 \
            or 123 <= cp <= 126:
        return True
    if cp in _PUNCT_ADDED:
        return True
    return unicodedata.category(ch)[0] == 'P' and cp not in _PUNCT_REMOVED


@functools.lru_cache(maxsize=None)
def is_other(ch: str) -> bool:
    """``tokenizers``' (older) Cc, Cf, Co and Cs."""
    cat = unicodedata.category(ch)
    return cat[0] == 'C' and cat != 'Cn' and ord(ch) not in _OTHER_REMOVED


@functools.lru_cache(maxsize=None)
def is_combining_mark(ch: str) -> bool:
    """``tokenizers``' (older) Mn, Mc and Me: what ``StripAccents``
    drops."""
    cp = ord(ch)
    return cp in _MARK_ADDED or (unicodedata.category(ch)[0] == 'M'
                                 and cp not in _MARK_REMOVED)


@functools.lru_cache(maxsize=None)
def is_nonspacing_mark(ch: str) -> bool:
    """``tokenizers``' (older) Mn: what ``BertNormalizer`` strips after
    NFD."""
    cp = ord(ch)
    return cp in _MN_ADDED or (unicodedata.category(ch) == 'Mn'
                               and cp not in _MN_REMOVED)


def is_numeric(ch: str) -> bool:
    """Rust's ``char::is_numeric``: Nd, Nl and No."""
    return unicodedata.category(ch)[0] == 'N'


@functools.lru_cache(maxsize=None)
def _word(ch: str) -> bool:
    cat = unicodedata.category(ch)
    return (cat[0] in 'LM' or cat in ('Nd', 'Nl', 'Pc')
            or ord(ch) in _WORD_EXTRA)


def is_word(ch: str) -> bool:
    """Rust's regex ``\\w``, which a ``single_word`` token must not touch:
    letters, marks, Nd, Nl, Pc, Join_Control and the Other_Alphabetic
    symbols."""
    return _word(ch) or ch in '\u200c\u200d'


def onig_word(ch: str) -> bool:
    """Oniguruma's ``\\w``: ``is_word`` without Join_Control, with
    Latin-1's No."""
    return _word(ch) or ord(ch) in _LATIN1_NO


def normalize(form: str, text: str) -> str:
    """``unicodedata.normalize(form, text)`` that leaves the characters
    ``tokenizers``' tables have no decomposition for as they are."""
    kept = _KEPT[form]
    if text.isascii() or kept.isdisjoint(map(ord, text)):
        return unicodedata.normalize(form, text)
    out, start = [], 0
    for i, ch in enumerate(text):
        if ord(ch) in kept:
            out += [unicodedata.normalize(form, text[start:i]), ch]
            start = i + 1
    out.append(unicodedata.normalize(form, text[start:]))
    return ''.join(out)


# ---------------------------------------------------------------------------
# extended grapheme clusters (UAX #29 of Unicode 15.1)

(_OTHER, _CR, _LF, _CONTROL, _EXTEND, _ZWJ, _RI, _PREPEND, _SPACING, _L, _V,
 _T, _LV, _LVT) = range(14)
_PREPEND_CODES = _codes((
    (0x600, 0x605), (0x6DD, 0x6DD), (0x70F, 0x70F), (0x890, 0x891),
    (0x8E2, 0x8E2), (0xD4E, 0xD4E), (0x110BD, 0x110BD), (0x110CD, 0x110CD),
    (0x111C2, 0x111C3), (0x1193F, 0x1193F), (0x11941, 0x11941),
    (0x11A3A, 0x11A3A), (0x11A84, 0x11A89), (0x11D46, 0x11D46),
    (0x11F02, 0x11F02)))
# Other_Grapheme_Extend, emoji modifiers and tags: Extend beyond Mn and Me
_EXTEND_CODES = _codes((
    (0x9BE, 0x9BE), (0x9D7, 0x9D7), (0xB3E, 0xB3E), (0xB57, 0xB57),
    (0xBBE, 0xBBE), (0xBD7, 0xBD7), (0xCC2, 0xCC2), (0xCD5, 0xCD6),
    (0xD3E, 0xD3E), (0xD57, 0xD57), (0xDCF, 0xDCF), (0xDDF, 0xDDF),
    (0x1B35, 0x1B35), (0x200C, 0x200C), (0x302E, 0x302F), (0xFF9E, 0xFF9F),
    (0x1133E, 0x1133E), (0x11357, 0x11357), (0x114B0, 0x114B0),
    (0x114BD, 0x114BD), (0x115AF, 0x115AF), (0x11930, 0x11930),
    (0x1D165, 0x1D165), (0x1D16E, 0x1D172), (0x1F3FB, 0x1F3FF),
    (0xE0020, 0xE007F)))
# Mc that is not SpacingMark
_NOT_SPACING = _codes((
    (0x102B, 0x102C), (0x1038, 0x1038), (0x1062, 0x1064), (0x1067, 0x106D),
    (0x1083, 0x1083), (0x1087, 0x108C), (0x108F, 0x108F), (0x109A, 0x109C),
    (0x1A61, 0x1A61), (0x1A63, 0x1A64), (0xAA7B, 0xAA7B), (0xAA7D, 0xAA7D),
    (0x11720, 0x11721)))
_EXT_PICT = _codes((
    (0xA9, 0xA9), (0xAE, 0xAE), (0x203C, 0x203C), (0x2049, 0x2049),
    (0x2122, 0x2122), (0x2139, 0x2139), (0x2194, 0x2199), (0x21A9, 0x21AA),
    (0x231A, 0x231B), (0x2328, 0x2328), (0x2388, 0x2388), (0x23CF, 0x23CF),
    (0x23E9, 0x23F3), (0x23F8, 0x23FA), (0x24C2, 0x24C2), (0x25AA, 0x25AB),
    (0x25B6, 0x25B6), (0x25C0, 0x25C0), (0x25FB, 0x25FE), (0x2600, 0x2605),
    (0x2607, 0x2612), (0x2614, 0x2685), (0x2690, 0x2705), (0x2708, 0x2712),
    (0x2714, 0x2714), (0x2716, 0x2716), (0x271D, 0x271D), (0x2721, 0x2721),
    (0x2728, 0x2728), (0x2733, 0x2734), (0x2744, 0x2744), (0x2747, 0x2747),
    (0x274C, 0x274C), (0x274E, 0x274E), (0x2753, 0x2755), (0x2757, 0x2757),
    (0x2763, 0x2767), (0x2795, 0x2797), (0x27A1, 0x27A1), (0x27B0, 0x27B0),
    (0x27BF, 0x27BF), (0x2934, 0x2935), (0x2B05, 0x2B07), (0x2B1B, 0x2B1C),
    (0x2B50, 0x2B50), (0x2B55, 0x2B55), (0x3030, 0x3030), (0x303D, 0x303D),
    (0x3297, 0x3297), (0x3299, 0x3299), (0x1F000, 0x1F0FF),
    (0x1F10D, 0x1F10F), (0x1F12F, 0x1F12F), (0x1F16C, 0x1F171),
    (0x1F17E, 0x1F17F), (0x1F18E, 0x1F18E), (0x1F191, 0x1F19A),
    (0x1F1AD, 0x1F1E5), (0x1F201, 0x1F20F), (0x1F21A, 0x1F21A),
    (0x1F22F, 0x1F22F), (0x1F232, 0x1F23A), (0x1F23C, 0x1F23F),
    (0x1F249, 0x1F3FA), (0x1F400, 0x1F53D), (0x1F546, 0x1F64F),
    (0x1F680, 0x1F6FF), (0x1F774, 0x1F77F), (0x1F7D5, 0x1F7FF),
    (0x1F80C, 0x1F80F), (0x1F848, 0x1F84F), (0x1F85A, 0x1F85F),
    (0x1F888, 0x1F88F), (0x1F8AE, 0x1F8FF), (0x1F90C, 0x1F93A),
    (0x1F93C, 0x1F945), (0x1F947, 0x1FAFF), (0x1FC00, 0x1FFFD)))


# Indic_Conjunct_Break (GB9c): the consonants and viramas of Devanagari,
# Bengali, Gujarati, Oriya, Telugu and Malayalam
_LINKERS = frozenset('\u094d\u09cd\u0acd\u0b4d\u0c4d\u0d4d')
_CONSONANTS = _codes((
    (0x915, 0x939), (0x958, 0x95F), (0x978, 0x97F), (0x995, 0x9A8),
    (0x9AA, 0x9B0), (0x9B2, 0x9B2), (0x9B6, 0x9B9), (0x9DC, 0x9DD),
    (0x9DF, 0x9DF), (0x9F0, 0x9F1), (0xA95, 0xAA8), (0xAAA, 0xAB0),
    (0xAB2, 0xAB3), (0xAB5, 0xAB9), (0xAF9, 0xAF9), (0xB15, 0xB28),
    (0xB2A, 0xB30), (0xB32, 0xB33), (0xB35, 0xB39), (0xB5C, 0xB5D),
    (0xB5F, 0xB5F), (0xB71, 0xB71), (0xC15, 0xC28), (0xC2A, 0xC39),
    (0xC58, 0xC5A), (0xD15, 0xD3A)))


@functools.lru_cache(maxsize=None)
def _break_class(ch: str) -> int:
    cp = ord(ch)
    if ch == '\r':
        return _CR
    if ch == '\n':
        return _LF
    if cp == 0x200D:
        return _ZWJ
    if 0x1F1E6 <= cp <= 0x1F1FF:
        return _RI
    if cp in _PREPEND_CODES:
        return _PREPEND
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return _L
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return _V
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return _T
    if 0xAC00 <= cp <= 0xD7A3:
        return _LV if (cp - 0xAC00) % 28 == 0 else _LVT
    cat = unicodedata.category(ch)
    if cat in ('Mn', 'Me') or cp in _EXTEND_CODES:
        return _EXTEND
    if (cat == 'Mc' and cp not in _NOT_SPACING) or cp in (0xE33, 0xEB3):
        return _SPACING
    if cat in ('Cc', 'Cf', 'Zl', 'Zp', 'Cs'):
        return _CONTROL
    return _OTHER


def _conjunct(state: int, ch: str, cls: int) -> int:
    """GB9c's state after ``ch``: 0, 1 after a consonant and Extend or
    Linker characters (ZWNJ is not one), 2 once a Linker followed it."""
    if ord(ch) in _CONSONANTS:
        return 1
    if ch in _LINKERS:
        return 2 if state else 0
    return state if cls in (_EXTEND, _ZWJ) and ch != '\u200c' else 0


def graphemes(text: str) -> list[str]:
    """``text``'s extended grapheme clusters (rules GB3-GB13 of UAX #29,
    Indic conjuncts (GB9c) among them)."""
    if len(text) < 2:
        return [text] if text else []
    out, start = [], 0
    prev = _break_class(text[0])
    pict = ord(text[0]) in _EXT_PICT      # ExtPict Extend* so far
    zwj_after_pict = False
    ri_run = 1 if prev == _RI else 0
    conj = _conjunct(0, text[0], prev)
    for i in range(1, len(text)):
        ch = text[i]
        cur = _break_class(ch)
        if prev == _CR and cur == _LF:
            join = True
        elif prev in (_CONTROL, _CR, _LF) or cur in (_CONTROL, _CR, _LF):
            join = False
        elif prev == _L and cur in (_L, _V, _LV, _LVT):
            join = True
        elif prev in (_LV, _V) and cur in (_V, _T):
            join = True
        elif prev in (_LVT, _T) and cur == _T:
            join = True
        elif cur in (_EXTEND, _ZWJ, _SPACING) or prev == _PREPEND:
            join = True
        elif conj == 2 and ord(ch) in _CONSONANTS:
            join = True
        elif zwj_after_pict and ord(ch) in _EXT_PICT:
            join = True
        else:
            join = prev == _RI and cur == _RI and ri_run % 2 == 1
        if not join:
            out.append(text[start:i])
            start = i
        zwj_after_pict = cur == _ZWJ and pict
        pict = ord(ch) in _EXT_PICT or (pict and cur == _EXTEND)
        ri_run = ri_run + 1 if cur == _RI else 0
        conj = _conjunct(conj, ch, cur)
        prev = cur
    out.append(text[start:])
    return out


# ---------------------------------------------------------------------------
# Oniguruma patterns (tokenizer.json's Regex) for Python's re

_CATEGORIES = ('Lu', 'Ll', 'Lt', 'Lm', 'Lo', 'Mn', 'Mc', 'Me', 'Nd', 'Nl',
               'No', 'Pc', 'Pd', 'Ps', 'Pe', 'Pi', 'Pf', 'Po', 'Sm', 'Sc',
               'Sk', 'So', 'Zs', 'Zl', 'Zp', 'Cc', 'Cf', 'Co')


@functools.lru_cache(maxsize=None)
def class_body(name: str) -> str:
    """The inside of a ``re`` character class that holds the code points
    of ``name``: a general category or its letter, ``s`` (White_Space),
    ``d`` (Nd), ``w`` (Oniguruma's word characters) or ``rust_w`` (Rust's
    regex's)."""
    if name == 's':
        test = WHITESPACE.__contains__
    elif name == 'w':
        test = onig_word
    elif name == 'rust_w':
        test = is_word
    else:
        cats = {'d': ('Nd',)}.get(name) or tuple(
            c for c in _CATEGORIES if c.startswith(name))
        if name not in ('d', *_CATEGORIES, *{c[0] for c in _CATEGORIES}):
            raise NotImplementedError(f'Unicode property {name!r} in a '
                                      'tokenizer.json pattern')

        def test(ch, cats=cats):
            return unicodedata.category(ch) in cats
    ranges, lo = [], None
    for cp in range(sys.maxunicode + 1):
        if 0xD800 <= cp <= 0xDFFF:
            hit = False
        else:
            hit = test(chr(cp))
        if hit and lo is None:
            lo = cp
        elif not hit and lo is not None:
            ranges.append((lo, cp - 1))
            lo = None
    if lo is not None:
        ranges.append((lo, sys.maxunicode))
    return ''.join(f'\\U{a:08x}' if a == b else f'\\U{a:08x}-\\U{b:08x}'
                   for a, b in ranges)


_SIMPLE_ESCAPES = {'n': '\\n', 't': '\\t', 'r': '\\r', 'f': '\\f',
                   'v': '\\v', 'a': '\\a', 'e': '\\x1b'}
_CLASS_ESCAPES = {'s': ('s', False), 'S': ('s', True), 'd': ('d', False),
                  'D': ('d', True), 'w': ('w', False), 'W': ('w', True)}


def _escape(pattern: str, i: int):
    """``(python, negated_class_or_None, next_index)`` of the escape at
    ``pattern[i] == '\\'``."""
    if i + 1 >= len(pattern):
        raise NotImplementedError(f'pattern {pattern!r} ends in a backslash')
    ch = pattern[i + 1]
    if ch in _CLASS_ESCAPES:
        name, neg = _CLASS_ESCAPES[ch]
        return class_body(name), neg, i + 2
    if ch in 'pP' and pattern[i + 2:i + 3] == '{':
        end = pattern.find('}', i)
        name = pattern[i + 3:end]
        neg = ch == 'P'
        if name.startswith('^'):
            name, neg = name[1:], not neg
        return class_body(name), neg, end + 1
    if ch in _SIMPLE_ESCAPES:
        return _SIMPLE_ESCAPES[ch], None, i + 2
    if ch == 'u' and re.fullmatch('[0-9a-fA-F]{4}', pattern[i + 2:i + 6]):
        return re.escape(chr(int(pattern[i + 2:i + 6], 16))), None, i + 6
    if ch == 'x' and re.fullmatch('[0-9a-fA-F]{2}', pattern[i + 2:i + 4]):
        return re.escape(chr(int(pattern[i + 2:i + 4], 16))), None, i + 4
    if not ch.isalnum() and ch != '_' and ch.isascii():
        return re.escape(ch), None, i + 2
    raise NotImplementedError(f'escape \\{ch} in the tokenizer.json pattern '
                              f'{pattern!r} (Oniguruma and re may differ)')


def onig_to_re(pattern: str) -> re.Pattern:
    """``pattern`` (Oniguruma, Ruby syntax) compiled for ``re``: literals,
    ``.``, classes (ranges, negation, the escapes below inside), ``\\s
    \\S \\d \\D \\w \\W \\p{..} \\P{..}``, groups ``( (?: (?= (?! (?<=
    (?<!``, alternation and the greedy or lazy quantifiers.  Anything else
    (anchors, back-references, flags, possessive quantifiers, nested or
    intersected classes, a pattern that matches the empty string) raises
    ``NotImplementedError`` naming the pattern."""
    out, i, n = [], 0, len(pattern)
    while i < n:
        ch = pattern[i]
        if ch == '\\':
            body, neg, i = _escape(pattern, i)
            out.append(body if neg is None
                       else f'[{"^" if neg else ""}{body}]')
        elif ch == '[':
            j = i + 1
            parts = ['[']
            if pattern[j:j + 1] == '^':
                parts.append('^')
                j += 1
            first = True
            while j < n and (pattern[j] != ']' or first):
                c = pattern[j]
                if c == '[' or pattern.startswith('&&', j):
                    raise NotImplementedError(
                        f'nested or intersected class in the tokenizer.json '
                        f'pattern {pattern!r}')
                if c == '\\':
                    body, neg, j = _escape(pattern, j)
                    if neg:
                        raise NotImplementedError(
                            f'a negated class escape inside a class in the '
                            f'tokenizer.json pattern {pattern!r}')
                    parts.append(body)
                elif c == '-':
                    # a range's dash, or a literal one at either end
                    last = pattern[j + 1:j + 2] == ']'
                    parts.append('\\-' if first or last else '-')
                    j += 1
                else:
                    parts.append(re.escape(c))
                    j += 1
                first = False
            if j >= n:
                raise NotImplementedError(f'unterminated class in {pattern!r}')
            out.append(''.join(parts) + ']')
            i = j + 1
        elif ch == '(':
            for opener in ('(?:', '(?=', '(?!', '(?<=', '(?<!', '('):
                if pattern.startswith(opener, i) and (
                        opener != '(' or pattern[i + 1:i + 2] != '?'):
                    out.append(opener)
                    i += len(opener)
                    break
            else:
                raise NotImplementedError(
                    f'group {pattern[i:i + 4]!r}... in the tokenizer.json '
                    f'pattern {pattern!r}')
        elif ch in '*+?{':
            if ch == '{':
                m = re.match(r'\{(\d*)(,?)(\d*)\}', pattern[i:])
                if m is None or not (m[1] or m[3]):
                    out.append(re.escape(ch))
                    i += 1
                    continue
                out.append(m[0])
                i += len(m[0])
            else:
                out.append(ch)
                i += 1
            if pattern[i:i + 1] == '?':
                out.append('?')
                i += 1
            elif pattern[i:i + 1] == '+':
                raise NotImplementedError(
                    f'possessive quantifier in the tokenizer.json pattern '
                    f'{pattern!r}')
        elif ch in '^$':
            raise NotImplementedError(
                f'anchor {ch!r} in the tokenizer.json pattern {pattern!r} '
                '(line anchors in Oniguruma)')
        else:
            out.append(ch if ch in '.|)' else re.escape(ch))
            i += 1
    compiled = re.compile(''.join(out))
    if compiled.fullmatch('') is not None:
        raise NotImplementedError(f'the tokenizer.json pattern {pattern!r} '
                                  'matches the empty string')
    return compiled
