"""BERT-family encoder models — port of ``paddle_tpu/models/bert.py``.

Word + position + token-type embeddings, a LayerNorm, then the port's
post-LN ``TransformerEncoder`` (gelu feed-forward) and a tanh pooler over
the first token. ``BertForPretraining`` adds the MLM transform (dense,
tanh-gelu, LayerNorm) and an NSP head; its MLM loss runs through
``fused_linear_cross_entropy`` with the tied word embedding, so the
``[tokens, vocab]`` logits never exist (the chunked loop, or K9-K11 under
``FLAGS_enable_flash_ce``). ``BertForSequenceClassification.scorer()`` is
the serving path (:class:`paddle_tpu_torch.serving.EncoderScorer`).

A ``[b, s]`` keep-mask becomes an fp32 additive ``[b, 1, 1, s]`` mask at
-1e4, as in the JAX package. With bf16 weights, attention promotes against
it (``_sdpa_raw``), so from the first attention output onward the encoder
runs in fp32, in JAX as here (``ROADMAP.md`` C, properties kept).

Parameter names match the JAX model's ``state_dict`` (``load_jax_state``).
Models are built on the CPU from ``generator``, cast to ``dtype`` and
placed by ``Layer`` on ``device`` (None: the current place; ``"cpu"`` to
stay on the host).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..framework.tensor import api
from ..nn import functional as F
from ..nn.layer.common import Linear, embedding_table
from ..nn.layer.layers import Layer
from ..nn.layer.norm import LayerNorm
from ..nn.layer.transformer import (TransformerEncoder,
                                    TransformerEncoderLayer, _cast)

__all__ = ["BertConfig", "BertEmbeddings", "BertModel", "BertPooler",
           "BertForPretraining", "BertForSequenceClassification",
           "bert_base", "bert_large"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12


def bert_base():
    return BertConfig()


def bert_large():
    return BertConfig(hidden_size=1024, num_layers=24, num_heads=16,
                      intermediate_size=4096)


def _on(module_device, x):
    """``x`` (array-like or tensor, or None) as a tensor on the model's
    device."""
    return None if x is None else torch.as_tensor(x, device=module_device)


def padding_bias(attention_mask):
    """The encoders' attention mask: a ``[b, s]`` keep-mask (1 kept, 0
    padding) becomes the fp32 additive ``[b, 1, 1, s]`` mask at -1e4; any
    other mask passes as it is."""
    if attention_mask is None or attention_mask.ndim != 2:
        return attention_mask
    neg = (1.0 - attention_mask.float()) * -1e4
    return neg[:, None, None, :]


class BertEmbeddings(Layer):
    """word + position + token-type embeddings -> LN -> dropout."""

    def __init__(self, cfg: BertConfig, *, device=None, generator=None):
        super().__init__()
        std = cfg.initializer_range
        self.word_embeddings = embedding_table(cfg.vocab_size,
                                               cfg.hidden_size, std, generator)
        self.position_embeddings = embedding_table(
            cfg.max_position_embeddings, cfg.hidden_size, std, generator)
        self.token_type_embeddings = embedding_table(
            cfg.type_vocab_size, cfg.hidden_size, std, generator)
        self.layer_norm = LayerNorm(cfg.hidden_size,
                                    epsilon=cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        if position_ids is None:
            # (1, s): broadcasts over the batch, as in the JAX package
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        h = (F.embedding(input_ids, self.word_embeddings.weight)
             + F.embedding(position_ids, self.position_embeddings.weight)
             + F.embedding(token_type_ids, self.token_type_embeddings.weight))
        return self.dropout(self.layer_norm(h))


class BertPooler(Layer):
    def __init__(self, cfg: BertConfig, *, device=None, generator=None):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size,
                            generator=generator)

    def forward(self, h):
        return torch.tanh(self.dense(h[:, 0]))


class BertModel(Layer):
    """Embeddings, post-LN encoder, pooler. ``forward`` returns
    ``(sequence_output, pooled_output)``."""

    def __init__(self, cfg: BertConfig, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg, generator=generator)
        enc_layer = TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout, activation="gelu",
            attn_dropout=cfg.attention_dropout, act_dropout=0.0,
            normalize_before=False, layer_norm_eps=cfg.layer_norm_eps,
            generator=generator)
        self.encoder = TransformerEncoder(enc_layer, cfg.num_layers,
                                          generator=generator)
        self.pooler = BertPooler(cfg, generator=generator)
        _cast(self, dtype)

    @property
    def device(self):
        return self.embeddings.word_embeddings.weight.device

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        """``attention_mask``: a ``[b, s]`` 1/0 padding mask (paddle's
        convention) or a broadcastable additive mask."""
        dev = self.device
        h = self.embeddings(_on(dev, input_ids), _on(dev, token_type_ids),
                            _on(dev, position_ids))
        out = self.encoder(h, src_mask=padding_bias(_on(dev,
                                                        attention_mask)))
        return out, self.pooler(out)


class BertForPretraining(Layer):
    """MLM + NSP heads; the MLM loss is the fused linear + cross-entropy
    with the tied word-embedding matrix."""

    def __init__(self, cfg: BertConfig, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.cfg = cfg
        self.bert = BertModel(cfg, generator=generator)
        self.transform = Linear(cfg.hidden_size, cfg.hidden_size,
                                generator=generator)
        self.transform_ln = LayerNorm(cfg.hidden_size,
                                      epsilon=cfg.layer_norm_eps)
        self.nsp_head = Linear(cfg.hidden_size, 2, generator=generator)
        _cast(self, dtype)

    @property
    def device(self):
        return self.bert.device

    def _mlm_hidden(self, input_ids, token_type_ids, attention_mask):
        """Shared MLM head pipeline: encoder -> transform -> gelu -> LN."""
        seq, pooled = self.bert(input_ids, token_type_ids,
                                attention_mask=attention_mask)
        h = self.transform_ln(F.gelu(self.transform(seq), approximate=True))
        return h, pooled

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        h, pooled = self._mlm_hidden(input_ids, token_type_ids,
                                     attention_mask)
        w = self.bert.embeddings.word_embeddings.weight
        return F.matmul(h, w, transpose_y=True), self.nsp_head(pooled)

    @api
    def loss(self, input_ids, mlm_labels, token_type_ids=None,
             attention_mask=None, nsp_labels=None, ignore_index=-100):
        """Fused MLM loss (mean over the labels that are not
        ``ignore_index``), plus the NSP cross-entropy when ``nsp_labels``
        is given."""
        h, pooled = self._mlm_hidden(input_ids, token_type_ids,
                                     attention_mask)
        w = self.bert.embeddings.word_embeddings.weight
        loss = F.fused_linear_cross_entropy(
            h, w, _on(self.device, mlm_labels), ignore_index=ignore_index)
        if nsp_labels is not None:
            nsp = _on(self.device, nsp_labels).reshape(-1, 1)
            loss = loss + F.cross_entropy(self.nsp_head(pooled), nsp).mean()
        return loss


class BertForSequenceClassification(Layer):
    def __init__(self, cfg: BertConfig, num_classes=2, dropout=None, *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        self.bert = BertModel(cfg, generator=generator)
        self.dropout = nn.Dropout(cfg.hidden_dropout if dropout is None
                                  else dropout)
        self.classifier = Linear(cfg.hidden_size, num_classes,
                                 generator=generator)
        _cast(self, dtype)

    @property
    def device(self):
        return self.bert.device

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids,
                              attention_mask=attention_mask)
        return self.classifier(self.dropout(pooled))

    def scorer(self, max_batch=8, seq_buckets=None, max_seq=None):
        """Serving path: a bucketed batch scorer
        (:class:`paddle_tpu_torch.serving.EncoderScorer`) — requests are
        padded to ``[max_batch, bucket]``, padding rows masked and
        dropped."""
        from ..serving import EncoderScorer

        return EncoderScorer(self, max_batch=max_batch,
                             seq_buckets=seq_buckets, max_seq=max_seq)
