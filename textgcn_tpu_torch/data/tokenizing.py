"""What the port's tokenizers share: the tokenizer directory's files
(``special_tokens``), the split on special tokens that eat the
whitespace beside them (``split_specials``), truncation and padding as
Hugging Face's slow tokenizers do them."""

from __future__ import annotations

import json
import os
import re

import numpy as np

# the tokenizers' "no limit" sentinel lies above this
_NO_LIMIT = 100_000


def read_json(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path, encoding='utf-8') as f:
        return json.load(f)


def _token_content(value) -> str:
    return value['content'] if isinstance(value, dict) else value


def capped_length(model_max_length: int | None, cap: int) -> int:
    """``encoder_flax._model_max_len``: a tokenizer's limit, capped (the
    "no limit" sentinel counts as none)."""
    if not model_max_length or model_max_length > _NO_LIMIT:
        return cap
    return min(int(model_max_length), cap)


def special_tokens(model_dir: str, conf: dict, defaults: dict[str, str],
                   lstrip_defaults: frozenset[str] = frozenset()):
    """``(special, added, lstrip, rstrip, model_max_length)`` of a
    tokenizer directory: each named special token's text (``special``)
    from ``special_tokens_map.json``, else ``tokenizer_config.json``, else
    ``defaults``; the special entries of ``added_tokens_decoder`` (text to
    id: kept whole like the named ones, as all-mpnet-base-v2's ``<unk>``
    beside its ``[UNK]``); and the texts of the tokens that eat the
    whitespace before (``lstrip``) and after (``rstrip``) them, as their
    saved ``AddedToken`` says, else ``lstrip_defaults`` (keys).  Refuses
    an added token that is not special and a ``single_word`` one."""
    smap = read_json(os.path.join(model_dir, 'special_tokens_map.json'))
    special, flags = {}, {}
    for k, default in defaults.items():
        value = smap.get(k, conf.get(k, default))
        special[k] = _token_content(value)
        flags[special[k]] = (dict(value) if isinstance(value, dict)
                             else {'lstrip': k in lstrip_defaults})
    added, unported = {}, []
    for key, entry in conf.get('added_tokens_decoder', {}).items():
        content = entry['content']
        if entry.get('single_word') or not (
                entry.get('special') or content in special.values()):
            unported.append(entry)
            continue
        added[content] = int(key)
        flags[content] = entry
    if unported:
        raise NotImplementedError(f'{model_dir}: tokenizer settings not '
                                  f'ported: added_tokens {unported}')
    lstrip = frozenset(t for t, f in flags.items() if f.get('lstrip'))
    rstrip = frozenset(t for t, f in flags.items() if f.get('rstrip'))
    mml = conf.get('model_max_length')
    return (special, added, lstrip, rstrip,
            None if mml is None else int(mml))


def split_specials(pattern: re.Pattern, text: str, lstrip: set[str],
                   rstrip: set[str]) -> list[str]:
    """``text`` split on the special tokens (at the odd places), each
    marked one eating the whitespace beside it, as Hugging Face's
    ``tokenize`` does."""
    parts = pattern.split(text)
    for i in range(1, len(parts), 2):
        if parts[i] in rstrip and parts[i + 1]:
            parts[i + 1] = parts[i + 1].lstrip()
        if parts[i] in lstrip and parts[i - 1]:
            parts[i - 1] = parts[i - 1].rstrip()
    return parts


def pad_rows(rows: list[list[int]], pad_id: int):
    """``(ids, mask)``, int64 ``(B, L)``, padded to the longest row."""
    width = max(map(len, rows))
    ids = np.full((len(rows), width), pad_id, np.int64)
    mask = np.zeros((len(rows), width), np.int64)
    for r, row in enumerate(rows):
        ids[r, :len(row)] = row
        mask[r, :len(row)] = 1
    return ids, mask


def truncate(ids: list[int], first: int, last: int,
             max_length: int) -> list[int]:
    """``first ids last``, the ids cut to ``max_length - 2``; as in
    Hugging Face's tokenizers, left whole where that would cut them
    all."""
    remove = len(ids) + 2 - max_length
    if 0 < remove < len(ids):
        ids = ids[:-remove]
    return [first, *ids, last]
