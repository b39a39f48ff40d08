"""ERNIE-family encoder models — port of ``paddle_tpu/models/ernie.py``.

A BERT-class encoder (the port's post-LN ``TransformerEncoder``) with two
additions, as in the JAX package:

- a task-type embedding added into the input sum (ERNIE 2.0's continual
  multi-task pretraining; ``use_task_id``);
- an MLM head whose projection is the word embedding itself
  (``ErnieLMPredictionHead.decoder_weight`` is the same ``Parameter``) plus
  a ``[vocab]`` bias, which ``ErnieForPretraining.loss`` runs through
  ``fused_linear_cross_entropy``: the chunked loop, or K9-K11 with a live
  bias under ``FLAGS_enable_flash_ce``.

``ErnieDataCollator`` masks contiguous spans on host numpy batches with the
JAX package's ``RandomState`` draws, so a seed gives the same bits in both.

Parameter names match the JAX model's ``state_dict`` (the tied matrix is
listed once, as ``ernie.embeddings.word_embeddings.weight``). Models are
built on the CPU from ``generator``, cast to ``dtype`` and placed by
``Layer`` on ``device`` (None: the current place; ``"cpu"`` to stay on the
host).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..framework.tensor import api
from ..nn import functional as F
from ..nn.layer.common import Linear, embedding_table
from ..nn.layer.layers import Layer
from ..nn.layer.norm import LayerNorm
from ..nn.layer.transformer import TransformerEncoder, TransformerEncoderLayer
from .bert import _cast, _on, padding_bias

__all__ = [
    "ErnieConfig", "ErnieEmbeddings", "ErnieModel", "ErniePooler",
    "ErnieLMPredictionHead", "ErnieForPretraining",
    "ErnieForSequenceClassification", "ErnieForTokenClassification",
    "ErnieForQuestionAnswering", "ErnieDataCollator",
    "ernie_base", "ernie_large",
]


@dataclass
class ErnieConfig:
    vocab_size: int = 18000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 513
    type_vocab_size: int = 2
    task_type_vocab_size: int = 3
    use_task_id: bool = True
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    hidden_act: str = "gelu"


def ernie_base():
    return ErnieConfig()


def ernie_large():
    return ErnieConfig(hidden_size=1024, num_layers=24, num_heads=16,
                       intermediate_size=4096)


class ErnieEmbeddings(Layer):
    """word + position + sentence (token-type) [+ task] -> LN -> dropout."""

    def __init__(self, cfg: ErnieConfig, *, device=None, generator=None):
        super().__init__()
        std = cfg.initializer_range
        self.word_embeddings = embedding_table(cfg.vocab_size,
                                               cfg.hidden_size, std, generator)
        self.position_embeddings = embedding_table(
            cfg.max_position_embeddings, cfg.hidden_size, std, generator)
        self.token_type_embeddings = embedding_table(
            cfg.type_vocab_size, cfg.hidden_size, std, generator)
        self.use_task_id = cfg.use_task_id
        if cfg.use_task_id:
            self.task_type_embeddings = embedding_table(
                cfg.task_type_vocab_size, cfg.hidden_size, std, generator)
        self.layer_norm = LayerNorm(cfg.hidden_size,
                                    epsilon=cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                task_type_ids=None):
        b, s = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(
                s, device=input_ids.device)[None, :].expand(b, s)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        h = (F.embedding(input_ids, self.word_embeddings.weight)
             + F.embedding(position_ids, self.position_embeddings.weight)
             + F.embedding(token_type_ids, self.token_type_embeddings.weight))
        if self.use_task_id:
            if task_type_ids is None:
                task_type_ids = torch.zeros_like(input_ids)
            h = h + F.embedding(task_type_ids,
                                self.task_type_embeddings.weight)
        return self.dropout(self.layer_norm(h))


class ErniePooler(Layer):
    def __init__(self, cfg: ErnieConfig, *, device=None, generator=None):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size,
                            generator=generator)

    def forward(self, h):
        return torch.tanh(self.dense(h[:, 0]))


class ErnieModel(Layer):
    """Embeddings, post-LN encoder (``hidden_act`` feed-forward), pooler.
    ``forward`` returns ``(sequence_output, pooled_output)``."""

    def __init__(self, cfg: ErnieConfig, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = ErnieEmbeddings(cfg, generator=generator)
        enc_layer = TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout, activation=cfg.hidden_act,
            attn_dropout=cfg.attention_dropout, act_dropout=0.0,
            normalize_before=False, layer_norm_eps=cfg.layer_norm_eps,
            generator=generator)
        self.encoder = TransformerEncoder(enc_layer, cfg.num_layers,
                                          generator=generator)
        self.pooler = ErniePooler(cfg, generator=generator)
        _cast(self, dtype)

    @property
    def device(self):
        return self.embeddings.word_embeddings.weight.device

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, task_type_ids=None):
        dev = self.device
        h = self.embeddings(_on(dev, input_ids), _on(dev, token_type_ids),
                            _on(dev, position_ids), _on(dev, task_type_ids))
        out = self.encoder(h, src_mask=padding_bias(_on(dev,
                                                        attention_mask)))
        return out, self.pooler(out)


class ErnieLMPredictionHead(Layer):
    """transform -> activation -> LN -> tied-embedding projection (+bias).
    At loss time the projection runs inside the fused linear + CE."""

    def __init__(self, cfg: ErnieConfig, embedding_weights, *, device=None,
                 generator=None):
        super().__init__()
        self.transform = Linear(cfg.hidden_size, cfg.hidden_size,
                                generator=generator)
        self.activation = getattr(F, cfg.hidden_act)
        self.layer_norm = LayerNorm(cfg.hidden_size,
                                    epsilon=cfg.layer_norm_eps)
        self.decoder_weight = embedding_weights  # tied [vocab, hidden]
        self.decoder_bias = nn.Parameter(torch.zeros(cfg.vocab_size))

    def hidden(self, h):
        return self.layer_norm(self.activation(self.transform(h)))

    def forward(self, h):
        return (F.matmul(self.hidden(h), self.decoder_weight,
                         transpose_y=True) + self.decoder_bias)


class ErnieForPretraining(Layer):
    """MLM + sentence-order heads."""

    def __init__(self, cfg: ErnieConfig, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.cfg = cfg
        self.ernie = ErnieModel(cfg, generator=generator)
        self.lm_head = ErnieLMPredictionHead(
            cfg, self.ernie.embeddings.word_embeddings.weight,
            generator=generator)
        self.nsp_head = Linear(cfg.hidden_size, 2, generator=generator)
        _cast(self, dtype)

    @property
    def device(self):
        return self.ernie.device

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                task_type_ids=None):
        seq, pooled = self.ernie(input_ids, token_type_ids,
                                 attention_mask=attention_mask,
                                 task_type_ids=task_type_ids)
        return self.lm_head(seq), self.nsp_head(pooled)

    @api
    def loss(self, input_ids, mlm_labels, nsp_labels=None,
             token_type_ids=None, attention_mask=None, task_type_ids=None,
             ignore_index=-100):
        """MLM (+ sentence-order) loss; ``mlm_labels`` holds -100 on the
        unmasked positions. The biased vocab projection runs through the
        fused linear + CE: the logits never exist."""
        seq, pooled = self.ernie(input_ids, token_type_ids,
                                 attention_mask=attention_mask,
                                 task_type_ids=task_type_ids)
        h = self.lm_head.hidden(seq)
        mlm = F.fused_linear_cross_entropy(
            h, self.lm_head.decoder_weight, _on(self.device, mlm_labels),
            bias=self.lm_head.decoder_bias, ignore_index=ignore_index)
        if nsp_labels is None:
            return mlm
        nsp = _on(self.device, nsp_labels).reshape(-1, 1)
        return mlm + F.cross_entropy(self.nsp_head(pooled), nsp).mean()


class _ErnieHead(Layer):
    """An ``ErnieModel`` under a dropout and a ``Linear`` classifier."""

    def __init__(self, cfg, num_classes, dropout, dtype, generator):
        super().__init__()
        self.ernie = ErnieModel(cfg, generator=generator)
        if dropout is not False:
            self.dropout = nn.Dropout(cfg.hidden_dropout if dropout is None
                                      else dropout)
        self.classifier = Linear(cfg.hidden_size, num_classes,
                                 generator=generator)
        _cast(self, dtype)

    @property
    def device(self):
        return self.ernie.device


class ErnieForSequenceClassification(_ErnieHead):
    def __init__(self, cfg: ErnieConfig, num_classes=2, dropout=None, *,
                 device=None, dtype=None, generator=None):
        super().__init__(cfg, num_classes, dropout, dtype, generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                task_type_ids=None):
        _, pooled = self.ernie(input_ids, token_type_ids,
                               attention_mask=attention_mask,
                               task_type_ids=task_type_ids)
        return self.classifier(self.dropout(pooled))


class ErnieForTokenClassification(_ErnieHead):
    def __init__(self, cfg: ErnieConfig, num_classes=2, dropout=None, *,
                 device=None, dtype=None, generator=None):
        super().__init__(cfg, num_classes, dropout, dtype, generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                task_type_ids=None):
        seq, _ = self.ernie(input_ids, token_type_ids,
                            attention_mask=attention_mask,
                            task_type_ids=task_type_ids)
        return self.classifier(self.dropout(seq))


class ErnieForQuestionAnswering(_ErnieHead):
    def __init__(self, cfg: ErnieConfig, *, device=None, dtype=None,
                 generator=None):
        super().__init__(cfg, 2, False, dtype, generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                task_type_ids=None):
        seq, _ = self.ernie(input_ids, token_type_ids,
                            attention_mask=attention_mask,
                            task_type_ids=task_type_ids)
        logits = self.classifier(seq)
        return logits[:, :, 0], logits[:, :, 1]  # start, end


class ErnieDataCollator:
    """Knowledge-masking collator (host numpy): masks contiguous spans
    (ERNIE's phrase/entity-level masking) instead of independent tokens.
    Returns ``(input_ids, mlm_labels)`` with -100 on unmasked positions;
    the draws are the JAX package's, from ``RandomState(seed)``."""

    def __init__(self, vocab_size, mask_token_id=3, mlm_prob=0.15,
                 max_span=3, seed=0):
        self.vocab_size = vocab_size
        self.mask_token_id = mask_token_id
        self.mlm_prob = mlm_prob
        self.max_span = max_span
        self.rng = np.random.RandomState(seed)

    def __call__(self, batch_ids):
        ids = np.array(batch_ids, dtype=np.int64, copy=True)
        labels = np.full_like(ids, -100)
        b, s = ids.shape
        n_mask = min(max(1, int(s * self.mlm_prob)), s)
        for i in range(b):
            masked = 0
            while masked < n_mask:
                span = min(int(self.rng.randint(1, self.max_span + 1)), s)
                # start = s - span is drawable, so the last token can be
                # masked
                start = int(self.rng.randint(0, s - span + 1))
                for j in range(start, min(start + span, s)):
                    if labels[i, j] != -100:
                        continue
                    labels[i, j] = ids[i, j]
                    r = self.rng.rand()
                    if r < 0.8:
                        ids[i, j] = self.mask_token_id
                    elif r < 0.9:
                        ids[i, j] = self.rng.randint(0, self.vocab_size)
                    masked += 1
                if masked >= n_mask:
                    break
        return ids, labels
