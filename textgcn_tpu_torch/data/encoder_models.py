"""The text encoder's transformers in plain PyTorch: BERT, RoBERTa,
XLM-RoBERTa, DistilBERT and MPNet, one post-LayerNorm encoder under BERT's
``state_dict`` names (without the model prefix and the pooler).

``bert_name`` maps DistilBERT's and MPNet's checkpoint names onto BERT's
(``attention.q_lin``/``attention.attn.q`` -> ``attention.self.query``,
``sa_layer_norm``/``attention.LayerNorm`` -> ``attention.output.LayerNorm``,
``ffn.lin1`` -> ``intermediate.dense`` ...; DistilBERT's ``transformer.``
-> ``encoder.``).

``BertEncoder.forward(ids, mask)`` returns the last hidden state, float32
``(B, L, hidden)``; attention is a plain product and softmax with the
padding mask added as a bias of ``finfo(float32).min``.  The families
differ only in these:

* positions: ``0..L-1`` for ``bert`` and ``distilbert`` (DistilBERT's
  learned table, or the sinusoidal one of ``sinusoidal_pos_embds`` when
  the checkpoint holds none); for ``roberta``, ``xlm-roberta`` and
  ``mpnet``
  ``padding_idx + 1 + k`` for the k-th token that is not padding and
  ``padding_idx`` for padding (transformers'
  ``create_position_ids_from_input_ids``; MPNet's ``padding_idx`` is 1);
* token types: row 0 of ``token_type_embeddings`` is added for ``bert``,
  ``roberta`` and ``xlm-roberta`` (one row), none for ``distilbert`` and
  ``mpnet``;
* ``mpnet``'s ``encoder.relative_attention_bias`` table of 32 buckets
  (max distance 128), whose bias is computed once per length, on the CPU
  with transformers' float32 formula, and added to every layer's scores
  (``MPNetEncoder.compute_position_bias``);
* DistilBERT's config names its sizes ``dim``, ``n_layers``, ``n_heads``,
  ``hidden_dim`` and ``activation``, and its LayerNorm eps is 1e-12.

``xlm-roberta`` is RoBERTa's architecture under another name.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

ACTIVATIONS = {
    'gelu': F.gelu,
    'gelu_new': lambda x: F.gelu(x, approximate='tanh'),
    'gelu_pytorch_tanh': lambda x: F.gelu(x, approximate='tanh'),
    'relu': F.relu,
}
FAMILIES = ('bert', 'roberta', 'xlm-roberta', 'distilbert', 'mpnet')


def check_model_type(config: dict) -> str:
    """``config['model_type']`` when the port runs it; raises
    ``NotImplementedError`` naming it otherwise."""
    model_type = config.get('model_type')
    if model_type not in FAMILIES:
        raise NotImplementedError(
            f'text encoder model_type {model_type!r} is not ported yet: '
            f'the port runs {", ".join(FAMILIES)}')
    return model_type


def _activation(name: str):
    if name not in ACTIVATIONS:
        raise NotImplementedError(
            f'hidden_act {name!r} is not ported yet: use one of '
            f'{sorted(ACTIVATIONS)}')
    return ACTIVATIONS[name]


def padding_bias(mask: torch.Tensor, dtype) -> torch.Tensor:
    """``(B, 1, 1, L)``: 0 where ``mask`` is set, ``finfo.min`` at
    padding."""
    return torch.where(mask[:, None, None, :] > 0, 0.0,
                       torch.finfo(torch.float32).min).to(dtype)


def offset_positions(ids: torch.Tensor, padding_idx: int) -> torch.Tensor:
    """transformers' ``create_position_ids_from_input_ids``."""
    keep = ids.ne(padding_idx).int()
    return (torch.cumsum(keep, dim=1).type_as(keep) * keep).long() \
        + padding_idx


def attend(q, k, v, bias, heads: int) -> torch.Tensor:
    """Multi-head attention over ``(B, L, H)`` projections, the scores
    scaled by ``1/sqrt(H / heads)`` and shifted by ``bias``."""
    b, n, h = q.shape

    def split(t):
        return t.view(b, n, heads, h // heads).transpose(1, 2)

    scores = torch.matmul(split(q) / math.sqrt(h // heads),
                          split(k).transpose(-1, -2)) + bias
    ctx = torch.matmul(torch.softmax(scores, dim=-1), split(v))
    return ctx.transpose(1, 2).reshape(b, n, h)


# ---------------------------------------------------------------------------
# checkpoint names

# DistilBERT's and MPNet's names of a layer's parameters, as BERT's
_LAYER_NAMES = {
    'attention.q_lin': 'attention.self.query',
    'attention.k_lin': 'attention.self.key',
    'attention.v_lin': 'attention.self.value',
    'attention.out_lin': 'attention.output.dense',
    'sa_layer_norm': 'attention.output.LayerNorm',
    'ffn.lin1': 'intermediate.dense',
    'ffn.lin2': 'output.dense',
    'output_layer_norm': 'output.LayerNorm',
    'attention.attn.q': 'attention.self.query',
    'attention.attn.k': 'attention.self.key',
    'attention.attn.v': 'attention.self.value',
    'attention.attn.o': 'attention.output.dense',
    'attention.LayerNorm': 'attention.output.LayerNorm',
}
_LAYER_KEY = re.compile(r'(?:encoder|transformer)\.layer\.(\d+)\.(.+)'
                        r'\.(weight|bias)')


def bert_name(name: str) -> str:
    """``name`` (without the model prefix) under BERT's names."""
    m = _LAYER_KEY.fullmatch(name)
    if m is None:
        return name
    return f'encoder.layer.{m[1]}.{_LAYER_NAMES.get(m[2], m[2])}.{m[3]}'


# ---------------------------------------------------------------------------
# the encoder

def sinusoidal_table(n_pos: int, dim: int) -> torch.Tensor:
    """DistilBERT's fixed position table (``sinusoidal_pos_embds``)."""
    enc = np.array([[pos / np.power(10000, 2 * (j // 2) / dim)
                     for j in range(dim)] for pos in range(n_pos)])
    out = torch.empty(n_pos, dim)
    out[:, 0::2] = torch.FloatTensor(np.sin(enc[:, 0::2]))
    out[:, 1::2] = torch.FloatTensor(np.cos(enc[:, 1::2]))
    return out


def relative_buckets(length: int, num_buckets: int = 32,
                     max_distance: int = 128) -> torch.Tensor:
    """``(L, L)`` bucket of each (query, key) pair: transformers'
    ``MPNetEncoder.relative_position_bucket`` on the CPU."""
    pos = torch.arange(length, dtype=torch.long)
    n = -(pos[None, :] - pos[:, None])
    num_buckets //= 2
    ret = (n < 0).to(torch.long) * num_buckets
    n = torch.abs(n)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    large = max_exact + (torch.log(n.float() / max_exact)
                         / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).to(torch.long)
    large = torch.min(large, torch.full_like(large, num_buckets - 1))
    return ret + torch.where(is_small, n, large)


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
        sa = self.attention.self
        ctx = attend(sa.query(x), sa.key(x), sa.value(x), bias, self.heads)
        out = self.attention.output
        x = out.LayerNorm(out.dense(ctx) + x)
        y = self.output.dense(self.act(self.intermediate.dense(x)))
        return self.output.LayerNorm(y + x)


def _sizes(config: dict, model_type: str):
    """``(hidden, layers, heads, inner, activation, eps)``."""
    if model_type == 'distilbert':
        return (config['dim'], config['n_layers'], config['n_heads'],
                config['hidden_dim'], config.get('activation', 'gelu'),
                1e-12)
    return (config['hidden_size'], config['num_hidden_layers'],
            config['num_attention_heads'], config['intermediate_size'],
            config.get('hidden_act', 'gelu'),
            config.get('layer_norm_eps', 1e-12))


class BertEncoder(nn.Module):
    """The last hidden state of any of ``FAMILIES``, ``state_dict`` keys as
    the Hugging Face ``BertModel``'s without the pooler (``bert_name``
    maps the other families' checkpoints onto them)."""

    def __init__(self, config: dict):
        super().__init__()
        self.model_type = model_type = check_model_type(config)
        hidden, layers, heads, inner, act, eps = _sizes(config, model_type)
        act = _activation(act)
        kind = config.get('position_embedding_type', 'absolute')
        if kind != 'absolute':
            raise NotImplementedError(
                f'position_embedding_type {kind!r} is not ported yet')
        self.max_positions = config.get(
            'max_position_embeddings', 514 if model_type == 'mpnet' else 512)
        # RoBERTa's, XLM-RoBERTa's and MPNet's positions start after
        # padding_idx
        self.padding_idx = {'roberta': config.get('pad_token_id', 1),
                            'xlm-roberta': config.get('pad_token_id', 1),
                            'mpnet': 1}.get(model_type)
        self.max_tokens = self.max_positions - (
            0 if self.padding_idx is None else self.padding_idx + 1)
        self.sinusoidal = bool(config.get('sinusoidal_pos_embds', False))
        self.embeddings = nn.Module()
        self.embeddings.word_embeddings = nn.Embedding(config['vocab_size'],
                                                       hidden)
        self.embeddings.position_embeddings = nn.Embedding(
            self.max_positions, hidden)
        if self.sinusoidal:
            with torch.no_grad():
                self.embeddings.position_embeddings.weight.copy_(
                    sinusoidal_table(self.max_positions, hidden))
        self.token_types = model_type in ('bert', 'roberta', 'xlm-roberta')
        if self.token_types:
            self.embeddings.token_type_embeddings = nn.Embedding(
                config.get('type_vocab_size', 2), hidden)
        self.embeddings.LayerNorm = nn.LayerNorm(hidden, eps=eps)
        self.encoder = nn.Module()
        self.encoder.layer = nn.ModuleList(
            BertLayer(hidden, heads, inner, eps, act) for _ in range(layers))
        if model_type == 'mpnet':
            self.encoder.relative_attention_bias = nn.Embedding(
                config.get('relative_attention_num_buckets', 32), heads)
        self._buckets: dict[int, torch.Tensor] = {}

    def load_state_dict(self, state, strict: bool = True, **kwargs):
        key = 'embeddings.position_embeddings.weight'
        if self.sinusoidal and key not in state:
            table = self.embeddings.position_embeddings.weight
            state = {**state, key: sinusoidal_table(*table.shape)}
        return super().load_state_dict(state, strict=strict, **kwargs)

    def position_bias(self, length: int) -> torch.Tensor:
        """MPNet's ``(1, heads, L, L)`` relative-position bias that every
        layer adds, from buckets computed once per length."""
        buckets = self._buckets.get(length)
        if buckets is None:
            buckets = self._buckets[length] = relative_buckets(length)
        table = self.encoder.relative_attention_bias
        return table(buckets.to(table.weight.device)).permute(2, 0, 1)[None]

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        emb = self.embeddings
        if self.padding_idx is None:
            pos = torch.arange(ids.shape[1], device=ids.device)
        else:
            pos = offset_positions(ids, self.padding_idx)
        x = emb.word_embeddings(ids)
        if self.token_types:
            x = x + emb.token_type_embeddings.weight[0]
        x = emb.LayerNorm(x + emb.position_embeddings(pos))
        bias = padding_bias(mask, x.dtype)
        if self.model_type == 'mpnet':
            bias = self.position_bias(ids.shape[1]) + bias
        for layer in self.encoder.layer:
            x = layer(x, bias)
        return x
