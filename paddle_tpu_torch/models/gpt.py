"""GPT-family decoder-only transformer — port of ``paddle_tpu/models/gpt.py``.

Pre-LN GPT blocks (LayerNorm → attention → residual → LayerNorm →
Linear-gelu(tanh)-Linear → residual), then ``ln_f`` and an LM head tied to
the input embedding (``h @ wteᵀ``). Parameter names match the JAX model's
``state_dict`` so :mod:`.convert` maps them one to one.

Serving passes ``cache=`` (one :mod:`~paddle_tpu_torch.serving.kv_cache`
view per layer) and a ``LengthMask``; attention then runs the cached kernel
K4 on the card. Training calls :meth:`GPTForCausalLM.loss`: causal attention
runs the packed kernels K5/K6 and the LayerNorms K7/K8 on the card, and the
loss is the chunked ``fused_linear_cross_entropy``. Tensor, sequence and
pipeline parallelism and the deprecated tuple cache of the JAX model are not
ported (see ROADMAP.md).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..framework.place import resolve_device
from ..nn import functional as F
from ..nn.layer.norm import LayerNorm

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

    @property
    def ffn_size(self):
        return self.intermediate_size or 4 * self.hidden_size


def _normal_(t, std, generator):
    with torch.no_grad():
        t.normal_(0.0, std, generator=generator)


def _linear(n_in, n_out, std, generator):
    lin = nn.Linear(n_in, n_out)
    _normal_(lin.weight, std, generator)
    with torch.no_grad():
        lin.bias.zero_()
    return lin


class GPTEmbeddings(nn.Module):
    def __init__(self, cfg: GPTConfig, generator=None):
        super().__init__()
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


class GPTDecoderLayer(nn.Module):
    """Pre-LN causal block: LN → attn → +res → LN → MLP(gelu) → +res."""

    def __init__(self, cfg: GPTConfig, generator=None):
        super().__init__()
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
        qkv = self.qkv_proj(y).view(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if cache is not None:
            # serving.KVCache view: writes the new rows into the cache in
            # place and returns the K/V attention reads; causality and
            # validity live in attn_mask
            k, v, cache = cache.update(k, v)
        attn = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.attn_dropout if self.training else 0.0,
            is_causal=cache is None, training=self.training)
        attn = attn.reshape(b, s, h)
        x = residual + self.resid_dropout(self.out_proj(attn))
        residual = x
        y = self.ln_2(x)
        y = self.down_proj(F.gelu(self.up_proj(y), approximate=True))
        out = residual + self.resid_dropout(y)
        return out if cache is None else (out, cache)


class GPTModel(nn.Module):
    def __init__(self, cfg: GPTConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = GPTEmbeddings(cfg, generator)
        self.layers = nn.ModuleList(
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


class GPTForCausalLM(nn.Module):
    """LM head tied to the input embedding.

    Args:
        cfg: the :class:`GPTConfig`.
        device: ``None`` (the default) is ``"cuda"``; pass ``"cpu"`` to run
            on the CPU. Without a card and without that request the
            constructor raises.
        dtype: parameter dtype (default fp32).
        generator: the ``torch.Generator`` the weights are drawn from
            (``None``: PyTorch's default generator). Weights are drawn on
            the CPU, so one seed gives one model on every device.
    """

    def __init__(self, cfg: GPTConfig, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.gpt = GPTModel(cfg, generator)
        self.to(device=dev, dtype=dtype)

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
            return torch.matmul(h, w.t()), new_cache
        h = self.gpt(input_ids, position_ids, attn_mask)
        return torch.matmul(h, w.t())

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
