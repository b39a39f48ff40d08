"""Prefill/decode generation engine over the static-shape KV cache — port of
``paddle_tpu/serving/engine.py`` (``GenerationEngine``).

Four steps, each one eager forward of the model under
``torch.inference_mode()`` with a ``LengthMask``:

* ``prefill`` — one request's prompt, padded to a length bucket, runs
  causally and writes its K/V into the request's batch slot;
* ``prefill_chunk_step`` (when ``prefill_chunk`` is set) — ONE fixed-size
  chunk of one prompt, written at ``(slot, offset)``; the scheduler
  interleaves a long prompt's chunks with decode ticks;
* ``decode_once`` — ONE token per batch slot, every slot at its own
  position, over ``[max_batch, 1]``;
* ``verify_once`` (when ``spec_k > 0``) — the speculative verifier over
  ``[max_batch, spec_k + 1]`` windows; acceptance and commitment happen on
  the host (:meth:`GenerationEngine.verify_once` +
  :meth:`GenerationEngine.commit_lengths`), which keeps the committed
  stream byte-identical to plain greedy decode.

On the card every attention call of these steps runs the cached kernel K4
and every LayerNorm kernel K7. There is no counterpart of the JAX engine's
``CompiledStep`` programs, donation or weight freezing: PyTorch runs
eagerly and the cache is updated in place. Where the JAX engine's telemetry
counts one compile a program and bucket, the port records the distinct
shapes each program was dispatched with (:attr:`GenerationEngine.
dispatch_shapes`), as ``EncoderScorer.padded_shapes`` does.

Sampling (temperature / top-k / top-p) is per slot. Each slot draws from
its own ``torch.Generator``, seeded by :meth:`set_slot_sampling`: the same
seed replays the same stream within the port. A ``torch.Generator`` cannot
reproduce the JAX engine's threefry keys, so sampled streams differ from
the JAX package's; greedy decoding is the cross-framework contract.
"""
from __future__ import annotations

import numpy as np
import torch

from ..fault import inject as _inject
from ..framework.place import resolve_device
from ..nn.functional import LengthMask
from ..profiler import telemetry as _telemetry
from ..profiler import tracing as _tracing
from .kv_cache import (
    MASK_MIN,
    ChunkView,
    DecodeView,
    KVCache,
    PrefillView,
    default_buckets,
    pick_bucket,
)

__all__ = ["GenerationEngine", "EncoderScorer"]


def _sample_next(logits, generators, temps, top_ks, top_ps):
    """Per-slot next-token selection over ``[batch, vocab]`` logits.

    Greedy slots (``temps[i] == 0``) take the argmax; sampled slots draw
    from the temperature-scaled distribution after top-k/top-p filtering,
    each from its OWN generator (``generators[i]``), by the Gumbel-max
    trick. ``temps``/``top_ks``/``top_ps`` are host numpy arrays, so an
    all-greedy batch pays only the argmax. Returns int64 ``[batch]`` on the
    logits' device."""
    greedy = torch.argmax(logits, dim=-1)
    sampled_slots = np.flatnonzero(temps > 0.0)
    if sampled_slots.size == 0:
        return greedy
    dev = logits.device
    vocab = logits.shape[-1]
    t = torch.as_tensor(temps, device=dev)
    tk = torch.as_tensor(top_ks, device=dev).long()
    tp = torch.as_tensor(top_ps, device=dev)
    scaled = logits.float() / torch.clamp_min(t, 1e-6)[:, None]
    # top-k: keep logits >= the k-th largest; top_k == 0 disables
    desc = torch.sort(scaled, dim=-1, descending=True).values
    k_idx = torch.clamp(tk - 1, 0, vocab - 1)
    k_thresh = torch.gather(desc, 1, k_idx[:, None])
    keep = torch.where((tk > 0)[:, None], scaled >= k_thresh, True)
    # top-p: smallest prefix of the sorted distribution with cumulative
    # probability >= top_p (exclusive cumsum < top_p keeps at least the head
    # token); top_p == 1 disables
    probs = torch.softmax(desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    cnt = torch.clamp_min(((cum - probs) < tp[:, None]).sum(-1), 1)
    p_thresh = torch.gather(desc, 1, (cnt - 1)[:, None])
    keep = keep & torch.where((tp < 1.0)[:, None], scaled >= p_thresh, True)
    filt = torch.where(keep, scaled, MASK_MIN)
    out = greedy.clone()
    for s in sampled_slots:
        u = torch.rand(vocab, generator=generators[s], device=dev)
        gumbel = -torch.log(-torch.log(u))
        out[s] = torch.argmax(filt[s] + gumbel)
    return out


class GenerationEngine:
    """Serve a decoder-only LM (``GPTForCausalLM``-shaped: callable as
    ``model(ids, position_ids=, attn_mask=, cache=) -> (logits, cache)``,
    with a ``cfg`` exposing ``num_layers/num_heads/hidden_size/
    max_position_embeddings``) with static-shape decode.

    Args:
        model: the language model; switched to ``eval()``. It must live on
            ``device``.
        max_batch: decode batch width == concurrent request slots.
        max_len: cache capacity per slot (prompt + generated tokens);
            defaults to, and may not exceed, the model's position table.
        prefill_buckets: prompt pad widths; defaults to powers of two up
            to ``max_len``.
        cache_dtype: K/V buffer dtype; defaults to the model's embedding
            weight dtype (bf16 weights → bf16 cache).
        spec_k: speculative-decoding draft window; 0 (default) builds no
            verifier.
        prefill_chunk: chunked-prefill width; None (default) keeps prefill
            one-shot per bucket. Prompts whose padded chunk count would
            overrun ``max_len`` (see :meth:`chunked_prefill_fits`) take the
            bucketed one-shot path.
        device: ``None`` (the default) is ``"cuda"``; pass ``"cpu"`` to
            serve on the CPU. Without a card and without that request the
            engine raises.
    """

    def __init__(self, model, *, max_batch=8, max_len=None,
                 prefill_buckets=None, cache_dtype=None, spec_k=0,
                 prefill_chunk=None, device=None):
        self.device = resolve_device(device)
        w = model.gpt.embeddings.word_embeddings.weight
        if w.device != self.device:
            raise ValueError(f"the model is on {w.device}, the engine on "
                             f"{self.device}")
        cfg = model.cfg
        model.eval()
        self.model = model
        self.max_batch = int(max_batch)
        self.max_len = int(max_len or cfg.max_position_embeddings)
        if self.max_len > cfg.max_position_embeddings:
            raise ValueError(
                f"max_len={self.max_len} exceeds the model's position "
                f"table ({cfg.max_position_embeddings})")
        self.prefill_buckets = tuple(sorted(
            int(b) for b in (prefill_buckets
                             or default_buckets(self.max_len))))
        if self.prefill_buckets[-1] > self.max_len:
            raise ValueError(
                f"prefill bucket {self.prefill_buckets[-1]} exceeds "
                f"max_len={self.max_len}")
        self.spec_k = int(spec_k)
        if self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if self.spec_k and self.spec_k + 1 > self.max_len:
            raise ValueError(
                f"spec_k={self.spec_k} needs a [*, {self.spec_k + 1}] "
                f"verify window but max_len is {self.max_len}")
        self.prefill_chunk = (None if prefill_chunk is None
                              else int(prefill_chunk))
        if self.prefill_chunk is not None and not (
                1 <= self.prefill_chunk <= self.max_len):
            raise ValueError(
                f"prefill_chunk={prefill_chunk} outside "
                f"[1, max_len={self.max_len}]")
        self.num_layers = cfg.num_layers
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.cache_dtype = cache_dtype or w.dtype
        self.cache = KVCache.alloc(
            self.num_layers, self.max_batch, self.max_len, self.num_heads,
            self.head_dim, self.cache_dtype, device=self.device)
        # per-slot sampling state; slot i's generator starts at seed i
        self._generators = [
            torch.Generator(device=self.device).manual_seed(i)
            for i in range(self.max_batch)]
        self._temps = np.zeros((self.max_batch,), np.float32)
        self._top_ks = np.zeros((self.max_batch,), np.int32)
        self._top_ps = np.ones((self.max_batch,), np.float32)
        #: program -> the distinct token shapes it was dispatched with, in
        #: first-use order (stands where JAX counts compiles)
        self.dispatch_shapes = {"serve_prefill": [], "serve_prefill_chunk": [],
                                "serve_decode": [], "serve_verify": []}
        self._footprints = None

    def _note_shape(self, program, toks):
        shapes = self.dispatch_shapes[program]
        shape = tuple(int(n) for n in toks.shape)
        if shape not in shapes:
            shapes.append(shape)

    # -- step bodies -----------------------------------------------------------
    def _tokens(self, arr):
        return torch.as_tensor(np.asarray(arr), device=self.device).long()

    @torch.inference_mode()
    def _prefill(self, toks, length, slot):
        bucket = toks.shape[1]
        i = torch.arange(bucket, dtype=torch.int32, device=self.device)
        # causal within the prompt AND key < prompt length: padded tail
        # queries give garbage logits that are never read
        lmask = LengthMask(
            i[None, :],
            torch.full((1,), length, dtype=torch.int32, device=self.device))
        views = [PrefillView(k, v, slot)
                 for k, v in zip(self.cache.ks, self.cache.vs)]
        logits, _ = self.model(self._tokens(toks), position_ids=i[None, :],
                               attn_mask=lmask, cache=views)
        # next-token logits live at the last VALID position
        next_tok = int(torch.argmax(logits[0, length - 1]))
        self.cache.lengths[slot] = min(length, self.max_len)
        return next_tok

    @torch.inference_mode()
    def _prefill_chunk(self, toks, chunk_len, off, slot):
        chunk = toks.shape[1]
        pos = off + torch.arange(chunk, dtype=torch.int32, device=self.device)
        # key j is valid for chunk row i iff j <= off + i over the slot's
        # full cached row
        lmask = LengthMask(pos[None, :])
        views = [ChunkView(k, v, slot, off)
                 for k, v in zip(self.cache.ks, self.cache.vs)]
        logits, _ = self.model(self._tokens(toks), position_ids=pos[None, :],
                               attn_mask=lmask, cache=views)
        # only meaningful on the FINAL chunk (the host reads it then)
        next_tok = int(torch.argmax(logits[0, chunk_len - 1]))
        self.cache.lengths[slot] = min(off + chunk_len, self.max_len)
        return next_tok

    def _decode_logits(self, cache, feed):
        ln = cache.lengths
        pos = torch.clamp_max(ln, self.max_len - 1)  # [b]
        # each slot's single query row sits at its own position
        lmask = LengthMask(pos[:, None])
        views = [DecodeView(k, v, pos) for k, v in zip(cache.ks, cache.vs)]
        logits, _ = self.model(self._tokens(feed),
                               position_ids=pos[:, None],
                               attn_mask=lmask, cache=views)
        return logits[:, -1]

    @torch.inference_mode()
    def _decode(self, feed):
        ln = self.cache.lengths
        next_tok = _sample_next(self._decode_logits(self.cache, feed),
                                self._generators, self._temps,
                                self._top_ks, self._top_ps)
        self.cache.lengths = ln + 1
        return next_tok

    @torch.inference_mode()
    def _verify(self, feed):
        w = self.spec_k + 1
        ln = self.cache.lengths
        # the scheduler guarantees ln + W <= max_len for LIVE slots; the
        # clamp only ever moves dead slots, whose rows nobody reads
        pos0 = torch.clamp_max(ln, self.max_len - w)  # [b]
        pos = pos0[:, None] + torch.arange(w, dtype=torch.int32,
                                           device=self.device)[None, :]
        lmask = LengthMask(pos)
        views = [DecodeView(k, v, pos0)
                 for k, v in zip(self.cache.ks, self.cache.vs)]
        logits, _ = self.model(self._tokens(feed), position_ids=pos,
                               attn_mask=lmask, cache=views)
        lv = logits.float()  # [b, W, vocab]
        # greedy[b, i] = the verifier's own next token GIVEN the window
        # prefix up to i; sampled slots never speculate: their committed
        # token is the window-position-0 draw
        greedy = torch.argmax(lv, dim=-1)
        tok0 = _sample_next(lv[:, 0], self._generators, self._temps,
                            self._top_ks, self._top_ps)
        # lengths UNCHANGED — the host commits the accepted count
        return greedy, tok0

    # -- host-side API -------------------------------------------------------
    def set_slot_sampling(self, slot, *, temperature=0.0, top_k=0,
                          top_p=1.0, seed=0):
        """Arm sampling for a batch slot: temperature scaling with
        optional top-k / top-p (nucleus) filtering, seeded per request.
        ``temperature=0`` keeps the slot greedy."""
        s = int(slot)
        if not (0 <= s < self.max_batch):
            raise ValueError(f"slot {slot} outside [0, {self.max_batch})")
        if temperature < 0 or not (0.0 < top_p <= 1.0) or top_k < 0:
            raise ValueError(
                f"bad sampling params: temperature={temperature} "
                f"top_k={top_k} top_p={top_p}")
        self._temps[s] = float(temperature)
        self._top_ks[s] = int(top_k)
        self._top_ps[s] = float(top_p)
        self._generators[s].manual_seed(int(seed))

    def clear_slot_sampling(self, slot):
        """Return a slot to greedy decoding (the default)."""
        s = int(slot)
        self._temps[s] = 0.0
        self._top_ks[s] = 0
        self._top_ps[s] = 1.0

    def slot_is_sampled(self, slot):
        return bool(self._temps[int(slot)] > 0.0)

    def prefill(self, slot, prompt_ids):
        """Prefill ``prompt_ids`` into batch slot ``slot``; returns the
        greedy next token (host int)."""
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if prompt.size >= self.max_len:
            raise ValueError(
                f"prompt of {prompt.size} tokens leaves no room to "
                f"generate within max_len={self.max_len}")
        if not (0 <= int(slot) < self.max_batch):
            raise ValueError(f"slot {slot} outside [0, {self.max_batch})")
        bucket = pick_bucket(prompt.size, self.prefill_buckets)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :prompt.size] = prompt
        # fault-injection point before any cache write, so the scheduler's
        # retry runs against an intact cache
        _inject.check("serve.prefill")
        self._note_shape("serve_prefill", toks)
        with _tracing.span("serve_prefill",
                           attrs={"slot": int(slot), "bucket": bucket,
                                  "prompt_tokens": int(prompt.size)}):
            return self._prefill(toks, int(prompt.size), int(slot))

    def chunked_prefill_fits(self, prompt_len):
        """True when a prompt of this length can prefill through the
        chunked step: every chunk write (final one included, PADDED to
        the chunk width) must land inside ``max_len``. Callers fall back to
        the bucketed one-shot prefill when this is False."""
        if self.prefill_chunk is None:
            return False
        c = self.prefill_chunk
        n = int(prompt_len)
        return n > 0 and c * ((n + c - 1) // c) <= self.max_len

    def prefill_chunk_step(self, slot, prompt_ids, off):
        """Run ONE prefill chunk: prompt tokens ``off .. off+chunk`` into
        slot ``slot``. Returns the greedy next token (host int) when this
        chunk completed the prompt, else None — callers re-enter with
        ``off + prefill_chunk`` next tick."""
        if self.prefill_chunk is None:
            raise RuntimeError(
                "engine was built without prefill_chunk; pass "
                "prefill_chunk= to GenerationEngine to enable chunked "
                "prefill")
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        c = self.prefill_chunk
        off = int(off)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if prompt.size >= self.max_len:
            raise ValueError(
                f"prompt of {prompt.size} tokens leaves no room to "
                f"generate within max_len={self.max_len}")
        if not (0 <= int(slot) < self.max_batch):
            raise ValueError(f"slot {slot} outside [0, {self.max_batch})")
        if off % c or not (0 <= off < prompt.size):
            raise ValueError(
                f"chunk offset {off} not a multiple of {c} inside the "
                f"{prompt.size}-token prompt")
        if off + c > self.max_len:
            raise ValueError(
                f"chunk [{off}, {off + c}) overruns max_len="
                f"{self.max_len}; gate on chunked_prefill_fits()")
        piece = prompt[off:off + c]
        toks = np.zeros((1, c), np.int32)
        toks[0, :piece.size] = piece
        _inject.check("serve.prefill")  # before any cache write: retry-safe
        self._note_shape("serve_prefill_chunk", toks)
        with _tracing.span("serve_prefill_chunk",
                           attrs={"slot": int(slot), "off": off,
                                  "chunk_tokens": int(piece.size),
                                  "prompt_tokens": int(prompt.size)}):
            tok = self._prefill_chunk(toks, int(piece.size), off, int(slot))
        if off + piece.size >= prompt.size:
            return tok
        return None

    def decode_once(self, last_tokens):
        """One batched decode step: ``last_tokens[b]`` is each slot's most
        recent token. Returns the next token per slot (np int32 [b])."""
        feed = np.asarray(last_tokens, np.int32).reshape(self.max_batch, 1)
        _inject.check("serve.decode")  # before any cache write
        self._note_shape("serve_decode", feed)
        with _tracing.span("serve_decode"):
            tok = self._decode(feed)
        return tok.cpu().numpy().astype(np.int32)

    def verify_once(self, window_tokens):
        """One speculative verify step over ``[max_batch, spec_k + 1]``
        windows (``window[b, 0]`` = slot b's last committed token,
        ``window[b, 1:]`` = draft tokens; pad unused lanes with 0).

        Returns ``(greedy [b, W] int32, tok0 [b] int32)`` numpy. Cache
        lengths are NOT advanced — call :meth:`commit_lengths` with the
        per-slot accepted counts."""
        if not self.spec_k:
            raise RuntimeError(
                "engine was built with spec_k=0; pass spec_k= to "
                "GenerationEngine to enable speculative decoding")
        w = self.spec_k + 1
        feed = np.asarray(window_tokens, np.int32).reshape(
            self.max_batch, w)
        _inject.check("serve.verify")  # before any cache write
        self._note_shape("serve_verify", feed)
        with _tracing.span("serve_verify", attrs={"window": w}):
            greedy, tok0 = self._verify(feed)
        return (greedy.cpu().numpy().astype(np.int32),
                tok0.cpu().numpy().astype(np.int32))

    @torch.inference_mode()
    def commit_lengths(self, advance):
        """Advance per-slot cached lengths by ``advance[b]`` tokens after
        host-side speculative acceptance (the K/V rows being committed were
        already written by the verify step)."""
        adv = torch.as_tensor(np.asarray(advance, np.int32).reshape(
            self.max_batch), device=self.device)
        self.cache.lengths = torch.clamp_max(self.cache.lengths + adv,
                                             self.max_len)

    def generate(self, prompt_ids, max_new_tokens=32, eos_id=None):
        """Greedy single-request generation (slot 0; other slots idle)."""
        with _tracing.span("generate",
                           attrs={"prompt_tokens": len(prompt_ids),
                                  "max_new_tokens": int(max_new_tokens)}):
            out = [self.prefill(0, prompt_ids)]
            while len(out) < int(max_new_tokens):
                if eos_id is not None and out[-1] == eos_id:
                    break
                feed = np.zeros((self.max_batch,), np.int32)
                feed[0] = out[-1]
                out.append(int(self.decode_once(feed)[0]))
        return out

    def lengths(self):
        """Per-slot cached-token counts (host numpy)."""
        return self.cache.lengths.cpu().numpy()

    def predicted_footprints(self, refresh=False):
        """Device-memory footprints of this engine's serving programs.
        Cached after the first call; ``refresh=True`` re-derives. The keys
        are the JAX engine's:

        * ``decode_peak_bytes`` — the live-set peak of one batched decode
          tick (cache + weights + activations). On the card it is measured:
          a greedy decode tick on a scratch cache of the engine's shape
          (no slot's rows, lengths or generator are touched, so a call
          mid-stream changes no stream), its transient the tick's
          ``max_memory_allocated`` above ``memory_allocated`` after
          ``reset_peak_memory_stats``, plus the weights and the cache. On
          the CPU it is arithmetic: ``cache_bytes`` + the parameters'
          bytes + one decode tick's logits (``max_batch × vocab`` in the
          weights' dtype). The JAX engine's arithmetic fallback is ``2 ×
          cache_bytes`` (its donated swap holds the old and new cache);
          the port writes the cache in place;
        * ``cache_bytes`` — the static KV cache allocation;
        * ``base_bytes`` — everything but the cache (weights, decode
          temps): resident whether or not any request is active;
        * ``per_token_bytes`` — KV bytes one cached token pins across all
          layers;
        * ``prefill_bucket_bytes`` — per-bucket KV bytes a request padded
          to that bucket pins at admit;
        * ``timeline`` — None: the JAX engine lints a jaxpr for it, and
          the port has none."""
        if self._footprints is not None and not refresh:
            return dict(self._footprints)
        cache_bytes = int(self.cache.nbytes())
        per_token = max(1, cache_bytes // (self.max_batch * self.max_len))
        params = sum(p.numel() * p.element_size()
                     for p in self.model.parameters())
        if self.device.type == "cuda":
            decode_peak = float(params + cache_bytes
                                + self._measure_decode_transient())
        else:
            w = self.model.gpt.embeddings.word_embeddings.weight
            logits = self.max_batch * w.shape[0] * w.element_size()
            decode_peak = float(cache_bytes + params + logits)
        self._footprints = {
            "decode_peak_bytes": decode_peak,
            "cache_bytes": float(cache_bytes),
            "base_bytes": max(0.0, decode_peak - cache_bytes),
            "per_token_bytes": float(per_token),
            "prefill_bucket_bytes": {
                int(b): float(per_token * min(self.max_len, int(b)))
                for b in self.prefill_buckets},
            "timeline": None,
        }
        return dict(self._footprints)

    @torch.inference_mode()
    def _measure_decode_transient(self):
        """Bytes one greedy decode tick allocates above what is resident,
        measured on a scratch cache (the engine's own cache, lengths and
        generators stay as they are)."""
        scratch = KVCache.alloc(
            self.num_layers, self.max_batch, self.max_len, self.num_heads,
            self.head_dim, self.cache_dtype, device=self.device)
        feed = np.zeros((self.max_batch, 1), np.int32)
        torch.cuda.synchronize(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        before = torch.cuda.memory_allocated(self.device)
        torch.argmax(self._decode_logits(scratch, feed), dim=-1)
        torch.cuda.synchronize(self.device)
        transient = torch.cuda.max_memory_allocated(self.device) - before
        del scratch
        return int(transient)


class EncoderScorer:
    """Bucketed batch scoring for encoder models (BERT classification) —
    port of the JAX package's ``EncoderScorer``.

    Requests are padded to ``[max_batch, seq_bucket]`` (the smallest of
    ``seq_buckets`` that fits a chunk's longest sequence; default
    ``default_buckets(max_seq)``) with a ``[max_batch, bucket]`` fp32
    keep-mask, scored by one eager forward under ``torch.inference_mode()``,
    and the padding rows dropped. No KV cache: encoders are single-shot.

    The JAX scorer compiles one ``serve_score`` executable per bucket and
    may freeze the weights into it; eager PyTorch has no such program, so
    ``freeze_weights`` is accepted and ignored, and ``padded_shapes`` (the
    ``(max_batch, bucket)`` shapes run, in first-use order) stands where
    JAX counts its compiles: one shape a bucket used.
    """

    def __init__(self, model, *, max_batch=8, seq_buckets=None,
                 max_seq=None, freeze_weights="auto"):
        del freeze_weights
        model.eval()
        self.model = model
        self.max_batch = int(max_batch)
        cfg = getattr(model, "cfg", None) or model.bert.cfg
        self.max_seq = int(max_seq or cfg.max_position_embeddings)
        self.seq_buckets = tuple(sorted(
            int(b) for b in (seq_buckets or default_buckets(self.max_seq))))
        self.padded_shapes = []

    @torch.inference_mode()
    def _step(self, ids, mask):
        shape = tuple(ids.shape)
        if shape not in self.padded_shapes:
            self.padded_shapes.append(shape)
        dev = self.model.device
        return self.model(torch.from_numpy(ids).to(dev),
                          attention_mask=torch.from_numpy(mask).to(dev))

    def score(self, sequences):
        """Score a list of token-id sequences; returns ``[n, classes]``
        numpy logits. Requests are chunked to ``max_batch`` and padded to
        the smallest bucket that fits the chunk's longest sequence."""
        seqs = [np.asarray(s, np.int64).reshape(-1) for s in sequences]
        if _telemetry.enabled():
            _telemetry.get_telemetry().declare_variants(
                "serve_score", len(self.seq_buckets))
        outs = []
        for lo in range(0, len(seqs), self.max_batch):
            chunk = seqs[lo:lo + self.max_batch]
            bucket = pick_bucket(max(len(s) for s in chunk),
                                 self.seq_buckets)
            ids = np.zeros((self.max_batch, bucket), np.int64)
            mask = np.zeros((self.max_batch, bucket), np.float32)
            for i, s in enumerate(chunk):
                ids[i, :len(s)] = s
                mask[i, :len(s)] = 1.0
            logits = self._step(ids, mask)[:len(chunk)]
            if logits.dtype in (torch.bfloat16, torch.float16):
                logits = logits.float()
            outs.append(logits.cpu().numpy())
        return np.concatenate(outs, axis=0)
