"""GPT-family decoder-only transformer — port of ``paddle_tpu/models/gpt.py``.

Pre-LN GPT blocks (LayerNorm → attention → residual → LayerNorm →
Linear-gelu(tanh)-Linear → residual), then ``ln_f`` and an LM head tied to
the input embedding (``h @ wteᵀ``). Parameter names match the JAX model's
``state_dict`` so :mod:`.convert` maps them one to one.

Serving passes ``cache=`` (one :mod:`~paddle_tpu_torch.serving.kv_cache`
view per layer) and a ``LengthMask``; attention then runs the cached kernel
K4 on the card. Training calls :meth:`GPTForCausalLM.loss`: causal attention
runs the packed kernels K5/K6 and the LayerNorms K7/K8 on the card, and the
loss is the chunked ``fused_linear_cross_entropy``. A ``(k, v)`` tuple as
``cache=`` takes the JAX model's deprecated grow-by-concat path (it warns
once). Tensor, sequence and pipeline parallelism are not ported (see
ROADMAP.md): ``use_tp`` and ``use_sep`` keep the JAX package's meaning at
degree 1 (the plain model), and a degree above 1 raises.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..framework.tensor import api
from ..nn import functional as F
from ..nn.initializer import Normal
from ..nn.layer.common import Linear
from ..nn.layer.container import LayerList
from ..nn.layer.layers import Layer, ParamAttr
from ..nn.layer.norm import LayerNorm
from ..utils import warn_once

__all__ = ["GPTConfig", "GPTEmbeddings", "GPTDecoderLayer", "GPTModel",
           "GPTForCausalLM"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 0  # 0 → 4*hidden
    max_position_embeddings: int = 1024
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-5
    use_tp: bool = False       # tensor-parallel projections (mp degree > 1)
    use_sep: bool = False      # ring-attention sequence parallelism (sep > 1)
    tie_embeddings: bool = True

    @property
    def ffn_size(self):
        return self.intermediate_size or 4 * self.hidden_size


def _mp_degree():
    """The model-parallel degree the JAX package reads from fleet's hybrid
    communicate group: 1, since the port has no such group (fleet is
    ROADMAP.md A8)."""
    return 1


def _sep_degree():
    """The sequence-parallel degree, as :func:`_mp_degree`: 1."""
    return 1


def _degree_one(cfg):
    """As in the JAX package, ``use_tp`` / ``use_sep`` change the model only
    at a model- / sequence-parallel degree above 1, which needs the hybrid
    mesh the port does not have yet (ROADMAP.md A8): there they raise rather
    than build the plain model in its place. ``tie_embeddings`` is read
    nowhere, there as here: the head is always tied."""
    for flag, degree, what in ((cfg.use_tp, _mp_degree(), "tensor"),
                               (cfg.use_sep, _sep_degree(), "sequence")):
        if flag and degree > 1:
            raise NotImplementedError(
                f"GPTConfig asks for {what} parallelism at degree {degree}; "
                "the port builds only the degree-1 model (ROADMAP.md A8)")


def _normal_(t, std, generator):
    with torch.no_grad():
        t.normal_(0.0, std, generator=generator)


def _linear(n_in, n_out, std, generator):
    """The port's ``Linear`` (``[in, out]`` weight, zero bias), its weight
    drawn from ``N(0, std^2)`` as the JAX model's ``Normal`` initializer."""
    return Linear(n_in, n_out, weight_attr=ParamAttr(initializer=Normal(
        0.0, std)), generator=generator)


def _apply(lin, x):
    """``lin``'s ``x @ W + b`` through the port's ``linear`` functional (its
    ``amp`` hook and JAX's dtype promotion) without a module call: the 48
    projections of a GPT-2 forward stay off ``nn.Module.__call__``."""
    return F.linear(x, lin.weight, lin.bias)


class GPTEmbeddings(Layer):
    def __init__(self, cfg: GPTConfig, generator=None):
        super().__init__()
        _degree_one(cfg)
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        _normal_(self.word_embeddings.weight, cfg.initializer_range,
                 generator)
        _normal_(self.position_embeddings.weight, cfg.initializer_range,
                 generator)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            seq = input_ids.shape[1]
            position_ids = torch.arange(
                seq, device=input_ids.device)[None, :].expand(
                    input_ids.shape[0], seq)
        h = (F.embedding(input_ids, self.word_embeddings.weight)
             + F.embedding(position_ids, self.position_embeddings.weight))
        return self.dropout(h)


class GPTDecoderLayer(Layer):
    """Pre-LN causal block: LN → attn → +res → LN → MLP(gelu) → +res."""

    def __init__(self, cfg: GPTConfig, generator=None):
        super().__init__()
        _degree_one(cfg)
        self.cfg = cfg
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.head_dim = h // cfg.num_heads
        std = cfg.initializer_range
        out_std = std / math.sqrt(2 * cfg.num_layers)
        self.qkv_proj = _linear(h, 3 * h, std, generator)
        self.out_proj = _linear(h, h, out_std, generator)
        self.up_proj = _linear(h, cfg.ffn_size, std, generator)
        self.down_proj = _linear(cfg.ffn_size, h, out_std, generator)
        self.ln_1 = LayerNorm(h, epsilon=cfg.layer_norm_eps)
        self.ln_2 = LayerNorm(h, epsilon=cfg.layer_norm_eps)
        self.attn_dropout = cfg.attention_dropout
        self.resid_dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, x, attn_mask=None, cache=None):
        b, s, h = x.shape
        residual = x
        y = self.ln_1(x)
        qkv = _apply(self.qkv_proj, y).view(b, s, 3, self.num_heads,
                                            self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if isinstance(cache, (tuple, list)):
            # DEPRECATED grow-by-concat path (the JAX model's shim): every
            # step re-materialises the whole K/V and changes its shape
            warn_once(
                "gpt-kv-cache-concat",
                "tuple KV cache on GPTDecoderLayer is deprecated: it "
                "grows by concat and copies the whole cache at every "
                "position. Use paddle_tpu_torch.serving.KVCache / "
                "GenerationEngine for O(1) static-shape decode.")
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
            cache = (k.detach(), v.detach())
        elif cache is not None:
            # serving.KVCache view: writes the new rows into the cache in
            # place and returns the K/V attention reads; causality and
            # validity live in attn_mask
            k, v, cache = cache.update(k, v)
        attn = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.attn_dropout if self.training else 0.0,
            is_causal=cache is None, training=self.training)
        attn = attn.reshape(b, s, h)
        x = residual + self.resid_dropout(_apply(self.out_proj, attn))
        residual = x
        y = self.ln_2(x)
        y = _apply(self.down_proj,
                   F.gelu(_apply(self.up_proj, y), approximate=True))
        out = residual + self.resid_dropout(y)
        return out if cache is None else (out, cache)


class GPTModel(Layer):
    def __init__(self, cfg: GPTConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = GPTEmbeddings(cfg, generator)
        self.layers = LayerList(
            [GPTDecoderLayer(cfg, generator) for _ in range(cfg.num_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps)

    def forward(self, input_ids, position_ids=None, attn_mask=None,
                cache=None):
        h = self.embeddings(input_ids, position_ids)
        if cache is not None:
            new_cache = []
            for layer, c in zip(self.layers, cache):
                h, c = layer(h, attn_mask=attn_mask, cache=c)
                new_cache.append(c)
            return self.ln_f(h), new_cache
        for layer in self.layers:
            h = layer(h, attn_mask=attn_mask)
        return self.ln_f(h)


class GPTForCausalLM(Layer):
    """LM head tied to the input embedding.

    Args:
        cfg: the :class:`GPTConfig`.
        device: ``None`` (the default) is the current place (``"gpu:0"``
            unless ``set_device`` chose another); ``"cpu"`` runs on the CPU.
            Without a card and without that request the constructor
            raises. ``Layer`` places the model.
        dtype: parameter dtype (default fp32).
        generator: the ``torch.Generator`` the weights are drawn from
            (``None``: PyTorch's default generator). Weights are drawn on
            the CPU, so one seed gives one model on every device.
    """

    def __init__(self, cfg: GPTConfig, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.cfg = cfg
        self.gpt = GPTModel(cfg, generator)
        if dtype is not None:
            self.to(dtype=dtype)

    @property
    def device(self):
        return self.gpt.embeddings.word_embeddings.weight.device

    def forward(self, input_ids, position_ids=None, attn_mask=None,
                cache=None):
        input_ids = torch.as_tensor(input_ids, device=self.device)
        if position_ids is not None:
            position_ids = torch.as_tensor(position_ids, device=self.device)
        w = self.gpt.embeddings.word_embeddings.weight  # [vocab, hidden]
        if cache is not None:
            h, new_cache = self.gpt(input_ids, position_ids, attn_mask,
                                    cache=cache)
            return F.matmul(h, w.t()), new_cache
        h = self.gpt(input_ids, position_ids, attn_mask)
        return F.matmul(h, w.t())

    @api
    def loss(self, input_ids, labels):
        """Fused LM loss: the tied head's matmul and softmax cross-entropy
        without materializing the ``[tokens, vocab]`` logits
        (``ops.fused.fused_linear_cross_entropy``), mean over tokens."""
        input_ids = torch.as_tensor(input_ids, device=self.device)
        h = self.gpt(input_ids)
        w = self.gpt.embeddings.word_embeddings.weight
        return F.fused_linear_cross_entropy(h, w, labels)

    def generate(self, prompt_ids, max_new_tokens=32, eos_id=None,
                 max_len=None, prefill_buckets=None):
        """Greedy generation through the static KV cache
        (:class:`paddle_tpu_torch.serving.GenerationEngine`, batch 1). The
        engine is kept on the model and reused while ``max_len`` and
        ``prefill_buckets`` stay the same."""
        from ..serving import GenerationEngine

        key = (max_len, tuple(prefill_buckets) if prefill_buckets else None)
        eng = getattr(self, "_serve_engine", None)
        if eng is None or getattr(self, "_serve_engine_key", None) != key:
            eng = GenerationEngine(self, max_batch=1, max_len=max_len,
                                   prefill_buckets=prefill_buckets,
                                   device=self.device)
            self._serve_engine = eng
            self._serve_engine_key = key
        return eng.generate(prompt_ids, max_new_tokens=max_new_tokens,
                            eos_id=eos_id)
