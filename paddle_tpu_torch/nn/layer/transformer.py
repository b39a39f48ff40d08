"""Transformer layers — port of ``paddle_tpu/nn/layer/transformer.py``.

``MultiHeadAttention`` (with its ``Cache`` / ``StaticCache`` decoding
states), ``TransformerEncoderLayer`` / ``TransformerEncoder``,
``TransformerDecoderLayer`` / ``TransformerDecoder`` and the
encoder-decoder ``Transformer``, in paddle's ``[batch, seq, d_model]``
layout. Attention runs through the port's
``F.scaled_dot_product_attention`` router, as the JAX layers run through
theirs: the encoders' calls (s <= 512, so fewer score entries than
``flash_attention_min_seq_prod``; or a ``[b, 1, 1, s]`` padding bias, which
no flash kernel streams) take its dense path there as here.

Each layer is a ``Layer`` built on the CPU from ``generator`` (None:
PyTorch's default one); built outside another layer, ``Layer`` places it on
``device`` (None: the current place; ``"cpu"`` to stay on the host).
Hidden dropout is ``torch.nn.Dropout`` (``upscale_in_train``). A stacked
encoder or decoder holds the prototype layer as its first layer and deep
copies whose weights of two or more dims are redrawn
(:func:`_clone_layer`), as in the JAX package.
"""
from __future__ import annotations

import collections
import copy
import math

import torch
from torch import nn

from .. import functional as F
from .common import Linear
from .container import LayerList
from .layers import Layer
from .norm import LayerNorm

__all__ = [
    "MultiHeadAttention",
    "TransformerEncoderLayer",
    "TransformerEncoder",
    "TransformerDecoderLayer",
    "TransformerDecoder",
    "Transformer",
]


def _cast(module, dtype):
    """Cast ``module``'s floating tensors to ``dtype`` (None: as built)."""
    if dtype is not None:
        module.to(dtype=dtype)


def _convert_attention_mask(attn_mask, dtype):
    """A bool mask (True: attend) becomes additive: 0 where kept, -1e9
    where masked, in ``dtype``; any other mask passes as it is."""
    if attn_mask is None or attn_mask.dtype != torch.bool:
        return attn_mask
    return torch.where(attn_mask,
                       torch.zeros((), dtype=dtype, device=attn_mask.device),
                       torch.full((), -1e9, dtype=dtype,
                                  device=attn_mask.device))


class MultiHeadAttention(Layer):
    """paddle's ``MultiHeadAttention``: q/k/v/out projections around the
    SDPA router. ``need_weights`` is accepted and, as in the JAX package,
    no attention weights are returned."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, generator=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError("embed_dim must be divisible by num_heads")

        def proj(n_in):
            return Linear(n_in, embed_dim, weight_attr, bias_attr,
                          generator=generator)

        self.q_proj = proj(embed_dim)
        self.k_proj = proj(self.kdim)
        self.v_proj = proj(self.vdim)
        self.out_proj = proj(embed_dim)

    def _heads(self, t, b):
        return t.reshape(b, -1, self.num_heads, self.head_dim)

    def _prepare_qkv(self, query, key, value, cache=None):
        q = self.q_proj(query)
        b = q.shape[0]
        q = self._heads(q, b)
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._heads(self.k_proj(key), b)
            v = self._heads(self.v_proj(value), b)
        if isinstance(cache, self.Cache):
            k = torch.cat([cache.k, k], dim=1)
            v = torch.cat([cache.v, v], dim=1)
            cache = self.Cache(k, v)
        return q, k, v, cache

    def gen_cache(self, key, value=None, type=None):
        """A ``StaticCache`` of ``key``/``value``'s projections (cross
        attention), or an empty ``Cache`` that decoding steps extend."""
        b = key.shape[0]
        if type == MultiHeadAttention.StaticCache:
            k = self._heads(self.k_proj(key), b)
            v = self._heads(self.v_proj(key if value is None else value), b)
            return self.StaticCache(k, v)
        k = torch.zeros((b, 0, self.num_heads, self.head_dim),
                        dtype=key.dtype, device=key.device)
        return self.Cache(k, torch.zeros_like(k))

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        q, k, v, cache = self._prepare_qkv(query, key, value, cache)
        mask = _convert_attention_mask(attn_mask, q.dtype)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask,
            dropout_p=self.dropout if self.training else 0.0)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        return out if cache is None else (out, cache)


class TransformerEncoderLayer(Layer):
    """paddle's ``TransformerEncoderLayer``: pre-LN (``normalize_before``)
    or post-LN self-attention and feed-forward blocks; ``activation`` by
    name from the port's ``F``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, device=None, generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, dropout=attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, generator=generator)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, generator=generator)
        self.dropout = nn.Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, generator=generator)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.dropout1 = nn.Dropout(dropout)
        self.dropout2 = nn.Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, incremental_cache = self.self_attn(src, src, src, src_mask,
                                                    cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)

        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, incremental_cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src, type=MultiHeadAttention.Cache)


def _stack(layer, num_layers, generator):
    return LayerList([layer if i == 0 else _clone_layer(layer, generator)
                          for i in range(num_layers)])


class TransformerEncoder(Layer):
    """``num_layers`` encoder layers: ``encoder_layer`` itself first, then
    clones with redrawn weights; ``norm`` after the last, if given."""

    def __init__(self, encoder_layer, num_layers, norm=None, *, device=None,
                 generator=None):
        super().__init__()
        self.layers = _stack(encoder_layer, num_layers, generator)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask=src_mask)
            else:
                output, new_cache = mod(output, src_mask=src_mask,
                                        cache=cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    """paddle's ``TransformerDecoderLayer``: self-attention, cross-attention
    over ``memory`` and feed-forward blocks, pre- or post-LN."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, device=None, generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, dropout=attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, generator=generator)
        self.cross_attn = MultiHeadAttention(
            d_model, nhead, dropout=attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, generator=generator)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, generator=generator)
        self.dropout = nn.Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, generator=generator)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.norm3 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.dropout1 = nn.Dropout(dropout)
        self.dropout2 = nn.Dropout(dropout)
        self.dropout3 = nn.Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incremental_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                                    cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)

        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt, static_cache = self.cross_attn(tgt, memory, memory,
                                                memory_mask, cache[1])
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)

        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return (tgt if cache is None
                else (tgt, (incremental_cache, static_cache)))

    def gen_cache(self, memory):
        incremental = self.self_attn.gen_cache(memory,
                                               type=MultiHeadAttention.Cache)
        static = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(Layer):
    """``num_layers`` decoder layers, built as :class:`TransformerEncoder`
    builds its stack."""

    def __init__(self, decoder_layer, num_layers, norm=None, *, device=None,
                 generator=None):
        super().__init__()
        self.layers = _stack(decoder_layer, num_layers, generator)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask=tgt_mask,
                             memory_mask=memory_mask)
            else:
                output, new_cache = mod(output, memory, tgt_mask=tgt_mask,
                                        memory_mask=memory_mask,
                                        cache=cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        caches = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            caches = list(zip(*caches))
        return caches


def _clone_layer(layer, generator=None):
    """A deep copy of ``layer`` whose parameters of two or more dims are
    redrawn from ``N(0, 2 / (fan_in + fan_out))`` over their last two dims
    (paddle's ``[in, out]``, as in the JAX package). Draws are made on the
    CPU from ``generator`` and copied to each parameter's device and
    dtype."""
    new = copy.deepcopy(layer)
    with torch.no_grad():
        for p in new.parameters():
            if p.ndim >= 2:
                std = math.sqrt(2.0 / (p.shape[-2] + p.shape[-1]))
                draw = torch.empty(p.shape).normal_(0.0, std,
                                                    generator=generator)
                p.copy_(draw)
    return new


class Transformer(Layer):
    """paddle's encoder-decoder ``Transformer``."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None,
                 generator=None):
        super().__init__()
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, generator=generator)
            enc_norm = LayerNorm(d_model) if normalize_before else None
            self.encoder = TransformerEncoder(
                enc_layer, num_encoder_layers, enc_norm, generator=generator)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, generator=generator)
            dec_norm = LayerNorm(d_model) if normalize_before else None
            self.decoder = TransformerDecoder(
                dec_layer, num_decoder_layers, dec_norm, generator=generator)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)

    def generate_square_subsequent_mask(self, length):
        """fp32 ``[length, length]`` additive causal mask: 0 on and below
        the diagonal, -inf above, on the model's device."""
        param = next(iter(self.parameters()), None)
        dev = param.device if param is not None else torch.device("cpu")
        return torch.triu(torch.full((length, length), -math.inf,
                                     device=dev), 1)
