"""Continuous batching: slot-based request scheduling over the engine.

Port of ``paddle_tpu/serving/scheduler.py``: the same pure-Python
scheduler over :class:`paddle_tpu_torch.serving.GenerationEngine`.
Differences from the JAX package: a device OOM is also recognised as
``torch.cuda.OutOfMemoryError``; ``CostAwareAdmission`` is not ported yet
(it needs the engine's ``predicted_footprints``), so the ``admission=`` hook
takes any callable the caller provides. ``default_slo_monitor`` gives the
shipped serving SLOs (``profiler.slo.SERVING_SLOS``). The engine's
fault-injection points fire before any cache write, so a retry runs
against an intact cache.

The "heavy traffic from millions of users" workload (ROADMAP north star):
requests arrive continuously, and the decode batch must stay DENSE — a
finished sequence's slot is handed to the next queued request instead of
waiting for the whole batch to drain (the static-batch waste). Each
scheduler ``step()``:

1. **expire** — evict queued requests past their queue-wait budget and
   active/prefilling requests past their deadline (terminal
   ``finish_reason 'timeout'``), freeing their slots for this tick's
   admit;
2. **admit** — pop queued requests into free slots (FIFO, lowest slot
   first: deterministic given a deterministic arrival stream). Short
   prompts prefill one-shot into their slot; when the engine was built
   with ``prefill_chunk`` and the prompt spans several chunks, the
   request parks in a PREFILLING state instead and its prompt streams in
   chunk by chunk;
3. **prefill chunk** — at most ONE ``serve_prefill_chunk`` dispatch per
   tick (lowest prefilling slot first), interleaved with decode below:
   admitting a long prompt costs each tick one bounded chunk instead of
   one full-prompt prefill, so TTFT of concurrent streams stops scaling
   with the longest prompt in the mix (the chunked-prefill tentpole);
4. **decode** — ONE batched step over every active slot: plain
   ``serve_decode``, or — when the engine was built with ``spec_k`` and
   every live slot has window headroom — one SPECULATIVE
   ``serve_verify`` tick: a draft proposer (:mod:`.draft`) proposes up
   to k tokens per greedy slot, the ``[max_batch, k+1]`` verify forward
   scores them all at once, and the longest draft prefix matching the
   verifier's own greedy argmax is committed plus one verifier token.
   Rejection falls back to the verifier's token, so the committed stream
   is byte-identical to plain greedy decode — acceptance only buys
   speed. Sampled slots (``temperature > 0``) never speculate; their
   token is drawn inside the same dispatch;
5. **evict** — retire sequences that hit EOS or their token budget,
   freeing their slots for the next admit.

Resilience contract: every request, on every path, ends with
EXACTLY ONE terminal ``finish_reason`` from :data:`FINISH_REASONS` —

========  ===================================================================
reason    path
========  ===================================================================
eos       decode emitted the request's ``eos_id``
length    ``max_new_tokens`` generated
timeout   ``deadline_s`` (total) or ``max_queue_s`` (queue wait) exceeded
shed      rejected at submit: bounded queue full, admission policy said
          no, or an injected ``serve.admit`` fault
oom_evicted  chosen as the largest-footprint victim of a
          ``RESOURCE_EXHAUSTED`` or CUDA-OOM decode/prefill (survivors keep
          streaming)
error     prefill failed past the jittered retry budget
drained   terminated by ``drain()``/``shutdown()`` instead of being
          dropped silently
========  ===================================================================

Overload handling: ``Scheduler(max_queue=N)`` bounds the submit queue
(reject-on-full → ``shed``); an ``admission=`` policy callable sheds
when it returns False. Device faults: ``RESOURCE_EXHAUSTED`` raised by
the decode/prefill step is caught, the largest-footprint victim request is
evicted (``serve.oom_evictions``), and the tick retries at the reduced
active batch through :func:`paddle_tpu_torch.fault.retry` jittered backoff
(``serve.degraded_steps`` counts ticks that degraded). The ``serve.*``
fault-injection points (``paddle_tpu_torch.fault.inject``) fire BEFORE
the engine writes the KV cache, so the cache is still valid on retry.

Everything observable goes through the existing telemetry registry
(``profiler/telemetry.py``): ``serve.requests_in_flight`` /
``serve.queue_depth`` gauges, ``serve.admitted`` / ``serve.evicted`` /
``serve.tokens_generated`` / ``serve.decode_steps`` / ``serve.slot_steps``
counters, the resilience counters ``serve.shed`` / ``serve.timeouts`` /
``serve.oom_evictions`` / ``serve.degraded_steps`` / ``serve.drained`` /
``serve.errors`` / ``serve.evict_faults``, the speed-tier counters
``serve.prefill_chunks`` (chunked-prefill dispatches) /
``serve.spec_ticks`` / ``serve.spec_proposed`` / ``serve.spec_accepted``
/ ``serve.spec_fallback_ticks`` plus the ``serve.spec_acceptance_rate``
gauge (running accepted/proposed), and per-request ``serve.ttft_s`` /
``serve.tpot_s`` / ``serve.latency_s`` histograms.

Speculative fault surface: the host-side draft pass checks the
``serve.draft`` injection point (a fault skips drafting — the tick
decodes plain, parity unaffected); the verify dispatch checks
``serve.verify`` inside the engine BEFORE the verify forward, and any
verify failure (injected or real, OOM included) falls back to the plain
decode tick with its full OOM-degrade/retry machinery
(``serve.spec_fallback_ticks`` counts these). A mid-verify fault can
therefore never corrupt a stream: the cache is still untouched when the
fault fires, and the fallback tick recomputes the same token plain
greedy would have produced.

Determinism contract (regression-tested): with a fixed arrival stream and
seeded model, the admit/evict event log and every generated sequence are
identical run to run — slots are a min-heap, the active set is iterated in
slot order, decoding is greedy, and the OOM victim choice is a
deterministic (footprint, slot) max.

Request-scoped tracing (``profiler/tracing.py``, opt-in): ``submit`` mints
the request's trace — a ``request`` root span plus a ``queue`` child that
closes at admit; the prefill runs inside a ``prefill`` child (so the
engine's span and any compile events parent under it); every decode tick
records one ``decode_token`` span per *active* request over the shared
batched-dispatch interval (each carries a ``decode_span`` attr naming the
shared ``decode_step`` span it rode); evict closes the root with the
finish reason and latency stats. Abnormal terminations additionally record
an instantaneous event span named after the reason (``shed`` / ``timeout``
/ ``oom_evicted`` / ``error`` / ``drained``) under the request root, so a
trace query for shed/timeout events needs no attr filtering. One JSONL
export reconstructs the request's full life by filtering its trace id.

Gauge lifecycle (mirrors the DeviceLoader fix): ``serve.requests_in_flight``
and ``serve.queue_depth`` are retired when ``run()`` drains the batch and
on :meth:`Scheduler.shutdown` so a dead scheduler can't leave stale
in-flight stats in ``report()`` or a ``/metrics`` scrape.

SLO hook: pass ``slo=`` any object with a ``check()`` method — an
:class:`~paddle_tpu_torch.profiler.slo.SLOMonitor`, e.g.
:func:`default_slo_monitor` — and the scheduler calls it every
``slo_check_every`` ticks (plus once at drain).
"""
from __future__ import annotations

import heapq
import itertools
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..fault import inject as _inject
from ..fault.retry import TransientError
from ..fault.retry import retry as _retry
from ..profiler import telemetry as _telemetry
from ..profiler import tracing as _tracing
__all__ = ["Request", "Scheduler", "FINISH_REASONS"]

#: the closed set of terminal finish reasons — every submitted request ends
#: with exactly one of these, on every path (chaos-harness invariant)
FINISH_REASONS = ("eos", "length", "timeout", "shed", "oom_evicted",
                  "error", "drained")

_rid_counter = itertools.count()

#: distinct from None ("more chunks to go") — a chunked prefill that
#: exhausted its retry budget and must fail terminally
_CHUNK_FAILED = object()


def _is_oom(err):
    """Device OOM? A CUDA out-of-memory error, or an exception carrying
    XLA's ``RESOURCE_EXHAUSTED`` marker, which the injected ``oom`` fault
    raises (``paddle_tpu/profiler/devprof.py::is_oom_error``)."""
    return (isinstance(err, torch.cuda.OutOfMemoryError)
            or "RESOURCE_EXHAUSTED" in str(err))


@dataclass
class Request:
    """One generation request plus its serving lifecycle record."""

    prompt: list
    max_new_tokens: int = 32
    eos_id: int | None = None
    rid: int = field(default_factory=lambda: next(_rid_counter))
    #: total latency budget in seconds from submit (queue wait included);
    #: exceeded → evicted with ``finish_reason='timeout'`` at the next tick
    deadline_s: float | None = None
    #: queue-wait budget: a request still queued after this many seconds
    #: times out without ever taking a slot
    max_queue_s: float | None = None
    #: sampling knobs — per-slot data on the engine. ``temperature=0``
    #: (default) keeps the request greedy,
    #: preserving every parity gate; sampled requests never speculate.
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    #: per-request PRNG seed; None derives a deterministic seed from the
    #: rid so two sampled requests never share a stream by accident
    seed: int | None = None

    # lifecycle (ns timestamps on time.perf_counter_ns)
    tokens: list = field(default_factory=list)
    slot: int | None = None
    submit_ns: int | None = None
    first_token_ns: int | None = None
    done_ns: int | None = None
    finish_reason: str | None = None
    #: chunked prefill progress: prompt tokens already written to the
    #: cache while the request sits in the scheduler's PREFILLING state
    prefill_off: int = 0
    # tracing (None unless profiler.tracing is enabled at submit)
    trace_span: object = field(default=None, repr=False, compare=False)
    queue_span: object = field(default=None, repr=False, compare=False)
    prefill_span: object = field(default=None, repr=False, compare=False)

    @property
    def sampled(self):
        return self.temperature > 0.0

    @property
    def trace_id(self):
        """The request's trace id (None when tracing was off at submit)."""
        return getattr(self.trace_span, "trace_id", None)

    @property
    def finished(self):
        return self.done_ns is not None

    @property
    def ttft_s(self):
        """Time to first token (submit → prefill's token readback)."""
        if self.first_token_ns is None or self.submit_ns is None:
            return None
        return (self.first_token_ns - self.submit_ns) / 1e9

    @property
    def tpot_s(self):
        """Mean time per output token after the first."""
        if not self.finished or len(self.tokens) < 2:
            return None
        return ((self.done_ns - self.first_token_ns)
                / (len(self.tokens) - 1) / 1e9)

    @property
    def latency_s(self):
        if not self.finished:
            return None
        return (self.done_ns - self.submit_ns) / 1e9


def default_slo_monitor(**kwargs):
    """An :class:`~paddle_tpu_torch.profiler.slo.SLOMonitor` over the
    shipped serving overload specs (``SERVING_SLOS``) — pass straight to
    ``Scheduler(slo=default_slo_monitor())``."""
    from ..profiler.slo import SERVING_SLOS, SLOMonitor

    return SLOMonitor(SERVING_SLOS, **kwargs)


class Scheduler:
    """Slot-based continuous-batching scheduler over a
    :class:`~paddle_tpu_torch.serving.GenerationEngine`.

    Resilience knobs (all optional):

    Args:
        max_queue: bounded submit queue; a submit past the bound is shed
            (terminal ``finish_reason='shed'``, returned to the caller)
            instead of queueing work the tier can never finish.
        admission: callable ``policy(request, scheduler) -> bool``; False
            sheds the request.
        retry_tries / retry_base_delay / retry_sleep: the
            :func:`paddle_tpu_torch.fault.retry` budget used for transient
            prefill faults and OOM-degraded decode retries (``retry_sleep``
            is injectable so tests don't sleep).
        slo / slo_check_every: see the module docstring.
        speculative: run decode ticks through the engine's speculative
            verify step. ``None`` (default) auto-enables iff the engine
            was built with ``spec_k > 0``; pass False to force plain
            greedy ticks on a speculative engine (the chaos harness's
            clean-reference mode).
        draft: the :class:`~paddle_tpu_torch.serving.draft.DraftProposer`;
            defaults to :class:`~paddle_tpu_torch.serving.draft.NgramProposer`
            when speculation is on.
    """

    def __init__(self, engine, slo=None, slo_check_every=8, max_queue=None,
                 admission=None, retry_tries=3, retry_base_delay=0.02,
                 retry_sleep=time.sleep, speculative=None, draft=None):
        self.engine = engine
        self.queue = deque()
        self.active = {}  # slot -> Request (decoding)
        self.prefilling = {}  # slot -> Request (chunked prefill streaming)
        self.finished = []
        self.events = []  # (step_idx, kind, rid, slot) — kind in
        # {"admit","evict","shed","timeout","drained","error"}
        self._free = list(range(engine.max_batch))
        heapq.heapify(self._free)
        self._step_idx = 0
        self.decode_steps = 0
        self.slot_steps = 0
        self.max_queue = None if max_queue is None else int(max_queue)
        self.admission = admission
        self.retry_tries = max(1, int(retry_tries))
        self.retry_base_delay = float(retry_base_delay)
        self.retry_sleep = retry_sleep
        self.slo = slo
        self.slo_check_every = max(1, int(slo_check_every))
        self._session_span = None
        spec_k = int(getattr(engine, "spec_k", 0) or 0)
        self.speculative = (spec_k > 0 if speculative is None
                            else bool(speculative) and spec_k > 0)
        if self.speculative and draft is None:
            from .draft import NgramProposer

            draft = NgramProposer()
        self.draft = draft
        # running speculative totals backing serve.spec_acceptance_rate
        self._spec_proposed = 0
        self._spec_accepted = 0

    def holding(self):
        """Every request currently holding a slot (decoding OR streaming
        its prompt in) — the set admission/OOM accounting prices."""
        return list(self.active.values()) + list(self.prefilling.values())

    # -- submission ----------------------------------------------------------
    def submit(self, request: Request):
        """Queue a request, or shed it (terminal ``finish_reason='shed'``)
        when admission control rejects it — check the returned request's
        ``finish_reason``. Capacity is validated up front so a doomed
        request fails at submit with a ``ValueError``, not mid-serve."""
        n = len(request.prompt)
        if n == 0:
            raise ValueError("empty prompt")
        if n > self.engine.prefill_buckets[-1]:
            raise ValueError(
                f"prompt of {n} tokens exceeds the largest prefill bucket "
                f"{self.engine.prefill_buckets[-1]}")
        if n + request.max_new_tokens > self.engine.max_len:
            raise ValueError(
                f"prompt ({n}) + max_new_tokens ({request.max_new_tokens}) "
                f"exceeds the cache capacity max_len={self.engine.max_len}")
        request.submit_ns = time.perf_counter_ns()
        if _tracing.enabled():
            # the request's whole life lives under this root span; the
            # queue child measures submit→admit wait explicitly
            request.trace_span = _tracing.start_span(
                "request", trace_id=_tracing.get_tracer().new_trace_id(),
                attrs={"rid": request.rid, "prompt_tokens": n,
                       "max_new_tokens": request.max_new_tokens})
            request.queue_span = _tracing.start_span(
                "queue", parent=request.trace_span)
        tm = _telemetry.get_telemetry() if _telemetry.enabled() else None
        if tm is not None:
            tm.inc("serve.submitted")
        # admission control: injected faults, bounded queue, cost policy —
        # a rejected request ends terminally ('shed'), never silently
        try:
            _inject.check("serve.admit")
        except TransientError:
            return self._shed(request, "injected admission fault", tm)
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            return self._shed(request, "queue full", tm)
        if self.admission is not None and not self.admission(request, self):
            return self._shed(request, "admission policy", tm)
        self.queue.append(request)
        if tm is not None:
            tm.set_gauge("serve.queue_depth", len(self.queue))
        return request

    def _shed(self, req, why, tm):
        self.events.append((self._step_idx, "shed", req.rid, None))
        self._finish_unadmitted(req, "shed", tm, attrs={"why": why})
        return req

    # -- the serving loop ----------------------------------------------------
    def step(self):
        """One scheduler tick: expire → admit → prefill chunk → batched
        decode (speculative when armed) → evict. Returns the requests
        that finished during this tick."""
        tm = _telemetry.get_telemetry() if _telemetry.enabled() else None
        tr = _tracing.enabled()
        if tr and self._session_span is None:
            self._session_span = _tracing.start_span(
                "serve_session", attrs={"max_batch": self.engine.max_batch})
        done_now = []

        # expire: deadline / queue-wait budgets, BEFORE admit so freed
        # slots are handed to queued work this very tick
        self._expire(done_now, tm)

        # admit: fill free slots from the queue (FIFO, lowest slot first)
        while self.queue and self._free:
            req = self.queue.popleft()
            slot = heapq.heappop(self._free)
            self._admit_one(req, slot, done_now, tm, tr)

        # prefill chunk: at most ONE chunk dispatch per tick (lowest slot
        # first), so a tick's worst case is one bounded chunk + one
        # decode no matter how long the admitted prompts are — active
        # streams never stall for a whole long-prompt prefill
        if self.prefilling:
            self._advance_chunk(done_now, tm)

        # decode: one batched step over every active slot; a
        # RESOURCE_EXHAUSTED tick degrades (evict victim, retry) instead
        # of killing every in-flight request
        if self.active:
            self._decode_phase(done_now, tm, tr)

        self._step_idx += 1
        if tm is not None:
            tm.set_gauge("serve.requests_in_flight",
                         len(self.active) + len(self.prefilling))
            tm.set_gauge("serve.queue_depth", len(self.queue))
        if self.slo is not None and self._step_idx % self.slo_check_every == 0:
            self.slo.check()
        return done_now

    def _admit_one(self, req, slot, done_now, tm, tr):
        """Move one queued request into slot ``slot``: one-shot bucketed
        prefill for short prompts (the request decodes this very tick),
        or the PREFILLING parking state for multi-chunk prompts when the
        engine has chunked prefill."""
        req.slot = slot
        prefill_span = None
        if tr and req.trace_span is not None:
            if req.queue_span is not None:
                req.queue_span.end()
                req.queue_span = None
            prefill_span = _tracing.start_span(
                "prefill", parent=req.trace_span,
                attrs={"slot": slot, "prompt_tokens": len(req.prompt),
                       "sched_step": self._step_idx})
        if req.sampled:
            self._arm_sampling(req, slot)
        n = len(req.prompt)
        chunk = getattr(self.engine, "prefill_chunk", None)
        if chunk and n > chunk and self.engine.chunked_prefill_fits(n):
            # the prompt streams in one serve_prefill_chunk per tick; the
            # prefill span stays open across ticks and closes at the
            # final chunk (or at evict, if the request dies mid-prefill)
            if prefill_span is not None:
                prefill_span.set_attr("chunked", True)
            req.prefill_span = prefill_span
            req.prefill_off = 0
            self.prefilling[slot] = req
            self.events.append((self._step_idx, "admit", req.rid, slot))
            if tm is not None:
                tm.inc("serve.admitted")
            return
        # activated so the engine's serve_prefill span (and the bucket
        # compile, if this prompt hits a cold bucket) parent under it
        with _tracing.activate(prefill_span):
            tok = self._prefill_with_recovery(req, slot, done_now, tm)
        if tok is None:
            # transient faults outlasted the retry budget: this request
            # fails terminally; its slot goes back to the pool
            if prefill_span is not None:
                prefill_span.set_attr("failed", True).end()
            heapq.heappush(self._free, slot)
            req.slot = None
            self.events.append((self._step_idx, "error", req.rid, slot))
            self._finish_unadmitted(req, "error", tm)
            return
        req.first_token_ns = time.perf_counter_ns()
        req.tokens.append(tok)
        if prefill_span is not None:
            prefill_span.set_attr("token", tok).end()
        self.active[slot] = req
        self.events.append((self._step_idx, "admit", req.rid, slot))
        if tm is not None:
            tm.inc("serve.admitted")
            tm.inc("serve.prefill_tokens", len(req.prompt))
            tm.inc("serve.tokens_generated")
        if self._exhausted(req):
            done_now.append(self._evict(req))

    def _arm_sampling(self, req, slot):
        # None seed derives from the rid: deterministic for a fixed
        # submission order, never accidentally shared between requests
        seed = req.rid if req.seed is None else int(req.seed)
        self.engine.set_slot_sampling(
            slot, temperature=req.temperature, top_k=req.top_k,
            top_p=req.top_p, seed=seed)

    def _advance_chunk(self, done_now, tm):
        """Advance the lowest-slot PREFILLING request by exactly one
        prompt chunk. The final chunk yields the first token and the
        request joins the decode batch in this same tick."""
        slot = min(self.prefilling)
        req = self.prefilling[slot]
        with _tracing.activate(req.prefill_span):
            tok = self._chunk_with_recovery(req, slot, done_now, tm)
        if req.finished:
            # the OOM victim hunt inside our own recovery can only evict
            # OTHER requests, but a deadline/drain race is conceivable —
            # everything is already accounted, nothing more to do
            return
        if tok is _CHUNK_FAILED:
            if req.prefill_span is not None:
                req.prefill_span.set_attr("failed", True).end()
                req.prefill_span = None
            self.prefilling.pop(slot, None)
            heapq.heappush(self._free, slot)
            req.slot = None
            self.events.append((self._step_idx, "error", req.rid, slot))
            self._finish_unadmitted(req, "error", tm)
            return
        if tm is not None:
            tm.inc("serve.prefill_chunks")
        if tok is None:
            return  # more chunks to stream
        self.prefilling.pop(slot, None)
        req.first_token_ns = time.perf_counter_ns()
        req.tokens.append(tok)
        if req.prefill_span is not None:
            req.prefill_span.set_attr("token", tok)
            req.prefill_span.set_attr(
                "chunks", -(-len(req.prompt) // self.engine.prefill_chunk))
            req.prefill_span.end()
            req.prefill_span = None
        self.active[slot] = req
        if tm is not None:
            tm.inc("serve.prefill_tokens", len(req.prompt))
            tm.inc("serve.tokens_generated")
        if self._exhausted(req):
            done_now.append(self._evict(req))

    def _decode_phase(self, done_now, tm, tr):
        """One batched decode tick: speculative verify when armed and
        every live slot has window headroom, else plain serve_decode.
        Token bookkeeping is shared — both paths produce a per-slot
        emitted-token dict."""
        decode_span = None
        if tr:
            decode_span = _tracing.start_span(
                "decode_step", parent=self._session_span,
                attrs={"active": len(self.active),
                       "sched_step": self._step_idx})
        with _tracing.activate(decode_span):
            emitted = None
            if self.speculative and self._spec_headroom():
                emitted = self._spec_tick(done_now, tm, tr, decode_span)
            if emitted is None and self.active:
                emitted = self._plain_tick(done_now, tm)
        if decode_span is not None:
            decode_span.end()
        if emitted is None:
            return  # every active request was evicted before a step landed
        self.decode_steps += 1
        self.slot_steps += len(self.active)
        if tm is not None:
            tm.inc("serve.decode_steps")
            tm.inc("serve.slot_steps", len(self.active))
            tm.inc("serve.tokens_generated",
                   sum(len(v) for v in emitted.values()))
        for slot in sorted(self.active):
            req = self.active[slot]
            toks = emitted.get(slot, [])
            req.tokens.extend(toks)
            if decode_span is not None and req.trace_span is not None:
                # the batched dispatch is SHARED: one span per active
                # request over the same interval, linked to the shared
                # decode_step span — per-token intervals per request
                _tracing.get_tracer().record(
                    "decode_token", decode_span.start_ns,
                    decode_span.end_ns, parent=req.trace_span,
                    attrs={"slot": slot, "token": req.tokens[-1],
                           "index": len(req.tokens) - 1,
                           "emitted": len(toks),
                           "decode_span": decode_span.span_id,
                           "decode_trace": decode_span.trace_id})
            if self._exhausted(req):
                done_now.append(self._evict(req))

    def _plain_tick(self, done_now, tm):
        """The non-speculative tick: one ``serve_decode``, one token per
        active slot. Returns ``{slot: [token]}`` or None when recovery
        evicted every active request."""
        feed = np.zeros((self.engine.max_batch,), np.int32)
        for slot, req in self.active.items():
            feed[slot] = req.tokens[-1]
        out = self._decode_with_recovery(feed, done_now, tm)
        if out is None:
            return None
        return {slot: [int(out[slot])] for slot in self.active}

    def _spec_headroom(self):
        """True when every LIVE slot can absorb a full verify window
        without the write clamping back over valid rows (the engine's
        ``pos0 = min(ln, max_len - W)`` guard is only safe for slots
        nobody reads). Near-capacity ticks fall back to plain decode."""
        if not self.active:
            return False
        w = self.engine.spec_k + 1
        ml = self.engine.max_len
        for req in self.active.values():
            # cached tokens of an active slot: prompt + generated minus
            # the last emitted token (fed, not yet cached) — tracked
            # host-side so headroom costs no device readback
            if len(req.prompt) + len(req.tokens) - 1 + w > ml:
                return False
        for req in self.prefilling.values():
            if req.prefill_off + w > ml:
                return False
        return True

    def _spec_tick(self, done_now, tm, tr, decode_span):
        """One speculative tick: host-side DRAFT → one batched VERIFY
        forward → host-side ACCEPT of the longest draft prefix matching
        the verifier's own greedy argmax (plus one verifier token — on
        total rejection the tick degenerates to exactly a plain greedy
        step). Returns the per-slot emitted dict, or None to make the
        caller run a plain tick instead (no drafts, or verify faulted)."""
        del done_now  # no evictions here: verify failure falls back whole
        eng = self.engine
        k = eng.spec_k
        # DRAFT (host): proposals for greedy slots only — an injected
        # draft fault skips proposing and the tick decodes plain
        drafts = {}
        t0 = time.perf_counter_ns()
        try:
            _inject.check("serve.draft")
            for slot in sorted(self.active):
                req = self.active[slot]
                if req.sampled:
                    continue
                d = self.draft.propose(list(req.prompt) + req.tokens, k)
                if d:
                    drafts[slot] = [int(t) for t in d[:k]]
        except TransientError:
            drafts = {}
        if tr and decode_span is not None:
            _tracing.get_tracer().record(
                "draft", t0, time.perf_counter_ns(), parent=decode_span,
                attrs={"proposed": sum(len(d) for d in drafts.values())})
        if not drafts:
            return None  # nothing to verify: the plain tick is cheaper
        feed = np.zeros((eng.max_batch, k + 1), np.int32)
        for slot, req in self.active.items():
            feed[slot, 0] = req.tokens[-1]
        for slot, d in drafts.items():
            feed[slot, 1:1 + len(d)] = d
        # VERIFY: any failure — injected serve.verify fault or a real
        # OOM — falls back to the plain tick and its degrade machinery;
        # the injection point fires before any cache write, so the cache is
        # intact
        try:
            greedy, tok0 = eng.verify_once(feed)
        except Exception as e:
            if not (isinstance(e, TransientError) or _is_oom(e)):
                raise
            if tm is not None:
                tm.inc("serve.spec_fallback_ticks")
            return None
        # ACCEPT (host): compare drafts to the verifier's greedy stream
        t1 = time.perf_counter_ns()
        emitted = {}
        advance = np.zeros((eng.max_batch,), np.int32)
        proposed = accepted = 0
        for slot in sorted(self.active):
            req = self.active[slot]
            if req.sampled:
                # sampled slots commit their window-position-0 draw:
                # byte-identical to what a plain tick would have drawn
                toks = [int(tok0[slot])]
            else:
                d = drafts.get(slot, [])
                a = 0
                while a < len(d) and d[a] == int(greedy[slot, a]):
                    a += 1
                proposed += len(d)
                accepted += a
                toks = d[:a] + [int(greedy[slot, a])]
                if d:
                    self.draft.observe(list(req.prompt) + req.tokens, a)
            # budget first, then EOS — the same order plain eviction
            # applies them (_exhausted checks eos before length)
            toks = toks[:max(1, req.max_new_tokens - len(req.tokens))]
            if req.eos_id is not None and req.eos_id in toks:
                toks = toks[:toks.index(req.eos_id) + 1]
            emitted[slot] = toks
            advance[slot] = len(toks)
        # K/V rows for every committed token were already written by the
        # verify step itself — committing is just the length add
        eng.commit_lengths(advance)
        self._spec_proposed += proposed
        self._spec_accepted += accepted
        if tm is not None:
            tm.inc("serve.spec_ticks")
            if proposed:
                tm.inc("serve.spec_proposed", proposed)
                tm.inc("serve.spec_accepted", accepted)
            if self._spec_proposed:
                tm.set_gauge("serve.spec_acceptance_rate",
                             self._spec_accepted / self._spec_proposed)
        if tr and decode_span is not None:
            _tracing.get_tracer().record(
                "accept", t1, time.perf_counter_ns(), parent=decode_span,
                attrs={"proposed": proposed, "accepted": accepted})
        return emitted

    # -- resilience ----------------------------------------------------------
    def _expire(self, done_now, tm):
        """Evict requests past their budgets with ``finish_reason
        'timeout'``: queued requests check both ``max_queue_s`` and
        ``deadline_s``; active requests check ``deadline_s``."""
        now = time.perf_counter_ns()
        if self.queue:
            kept = deque()
            while self.queue:
                req = self.queue.popleft()
                waited = (now - req.submit_ns) / 1e9
                if ((req.max_queue_s is not None
                     and waited >= req.max_queue_s)
                        or (req.deadline_s is not None
                            and waited >= req.deadline_s)):
                    self.events.append(
                        (self._step_idx, "timeout", req.rid, None))
                    self._finish_unadmitted(req, "timeout", tm)
                else:
                    kept.append(req)
            self.queue = kept
        for holding in (self.active, self.prefilling):
            for slot in sorted(holding):
                req = holding.get(slot)
                if (req is not None and req.deadline_s is not None
                        and (now - req.submit_ns) / 1e9 >= req.deadline_s):
                    done_now.append(self._evict(req, reason="timeout"))

    def _prefill_with_recovery(self, req, slot, done_now, tm):
        """``engine.prefill`` under the fault-retry budget: transient
        errors back off and retry; a ``RESOURCE_EXHAUSTED`` evicts the
        largest-footprint victim first (so the retry runs against a
        lighter cache) — the ``serve.prefill`` injection point fires
        before any cache write, so the cache is retry-safe.
        Returns the first token, or None when the request must fail
        terminally (``finish_reason='error'``)."""

        def attempt():
            try:
                return self.engine.prefill(slot, req.prompt)
            except Exception as e:
                if _is_oom(e):
                    victim = self._pick_oom_victim()
                    if victim is not None:
                        done_now.append(
                            self._evict(victim, reason="oom_evicted"))
                    raise TransientError(
                        f"prefill RESOURCE_EXHAUSTED (rid {req.rid}); "
                        f"evicted victim, retrying") from e
                raise

        try:
            return _retry(attempt, tries=self.retry_tries,
                          base_delay=self.retry_base_delay,
                          retry_on=(TransientError,), sleep=self.retry_sleep)
        except TransientError:
            return None

    def _chunk_with_recovery(self, req, slot, done_now, tm):
        """One ``engine.prefill_chunk_step`` under the fault-retry
        budget — the chunked analogue of ``_prefill_with_recovery``. A
        ``RESOURCE_EXHAUSTED`` evicts the largest victim OTHER than the
        request itself before retrying. Returns the final-chunk token,
        None while chunks remain, or :data:`_CHUNK_FAILED` terminally."""

        def attempt():
            try:
                return self.engine.prefill_chunk_step(
                    slot, req.prompt, req.prefill_off)
            except Exception as e:
                if _is_oom(e):
                    victim = self._pick_oom_victim(exclude=req)
                    if victim is not None:
                        done_now.append(
                            self._evict(victim, reason="oom_evicted"))
                    raise TransientError(
                        f"prefill chunk RESOURCE_EXHAUSTED (rid {req.rid} "
                        f"off {req.prefill_off}); evicted victim, "
                        f"retrying") from e
                raise

        try:
            tok = _retry(attempt, tries=self.retry_tries,
                         base_delay=self.retry_base_delay,
                         retry_on=(TransientError,), sleep=self.retry_sleep)
        except TransientError:
            return _CHUNK_FAILED
        req.prefill_off += self.engine.prefill_chunk
        return tok

    def _decode_with_recovery(self, feed, done_now, tm):
        """One batched decode under the fault-retry budget. On
        ``RESOURCE_EXHAUSTED``: evict the largest-footprint victim
        (``finish_reason='oom_evicted'``) and retry the tick at the
        reduced active batch with jittered backoff — survivors keep
        streaming. Returns the per-slot tokens, or None when every active
        request was evicted before a decode succeeded."""
        degraded = False

        def attempt():
            nonlocal degraded
            if not self.active:
                return None
            try:
                return self.engine.decode_once(feed)
            except Exception as e:
                if not _is_oom(e):
                    raise
                victim = self._pick_oom_victim()
                if victim is None:
                    raise
                degraded = True
                vslot = victim.slot
                done_now.append(self._evict(victim, reason="oom_evicted"))
                feed[vslot] = 0
                raise TransientError(
                    f"decode RESOURCE_EXHAUSTED; evicted rid {victim.rid} "
                    f"(slot {vslot}), retrying at batch "
                    f"{len(self.active)}") from e

        # one eviction per attempt: worst case sheds the whole batch
        out = _retry(attempt, tries=self.engine.max_batch + 1,
                     base_delay=self.retry_base_delay,
                     retry_on=(TransientError,), sleep=self.retry_sleep)
        if degraded and tm is not None:
            tm.inc("serve.degraded_steps")
        return out

    def _pick_oom_victim(self, exclude=None):
        """The slot-holding request with the most KV-cache tokens (prompt
        + generated — mid-prefill requests count their full prompt); ties
        break toward the highest slot — deterministic, so chaos runs are
        replayable. ``exclude`` protects the request whose own dispatch
        hit the OOM (evicting it would orphan the retry)."""
        cands = [r for r in self.holding() if r is not exclude]
        if not cands:
            return None
        return max(cands,
                   key=lambda r: (len(r.prompt) + len(r.tokens), r.slot))

    def drain(self):
        """Terminate ALL outstanding work with ``finish_reason='drained'``
        — queued requests finish without ever taking a slot, active
        requests are evicted keeping their partial tokens — then retire
        the lifecycle gauges and take a final SLO sample. Nothing is
        dropped silently: afterwards every submitted request is in
        ``finished`` with a terminal reason. Returns ``finished``."""
        tm = _telemetry.get_telemetry() if _telemetry.enabled() else None
        while self.queue:
            req = self.queue.popleft()
            self.events.append((self._step_idx, "drained", req.rid, None))
            self._finish_unadmitted(req, "drained", tm)
        for holding in (self.active, self.prefilling):
            for slot in sorted(holding):
                req = holding.get(slot)
                if req is not None:
                    self._evict(req, reason="drained")
        self._retire_gauges()
        if self.slo is not None:
            self.slo.check()
        return self.finished

    def run(self, max_steps=None):
        """Drive ``step()`` until the queue and the batch drain (or
        ``max_steps`` ticks elapse); returns all finished requests. A full
        drain retires the in-flight gauges (they'd otherwise report the
        last tick's values forever) and takes a final SLO sample."""
        steps = 0
        while self.queue or self.active or self.prefilling:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        if not self.queue and not self.active and not self.prefilling:
            self._retire_gauges()
            if self.slo is not None:
                self.slo.check()
        return self.finished

    def _retire_gauges(self):
        """Drop the lifecycle gauges (NOT the counters/histograms): a
        drained or shut-down scheduler must not leave a stale queue depth
        in ``report()`` or a ``/metrics`` scrape — the DeviceLoader
        stale-gauge fix, applied to serving."""
        tm = _telemetry.get_telemetry()
        tm.clear_gauge("serve.requests_in_flight")
        tm.clear_gauge("serve.queue_depth")

    def shutdown(self):
        """Explicit teardown: drain outstanding work (terminal
        ``finish_reason='drained'``), retire the serve gauges and close
        the tracing session span. Safe to call repeatedly; the scheduler
        stays usable (a later ``step()`` republishes gauges and reopens a
        session span)."""
        self.drain()
        if self._session_span is not None:
            self._session_span.set_attr("decode_steps", self.decode_steps)
            self._session_span.end()
            self._session_span = None

    # -- bookkeeping ---------------------------------------------------------
    def _exhausted(self, req):
        if req.eos_id is not None and req.tokens[-1] == req.eos_id:
            req.finish_reason = "eos"
            return True
        if len(req.tokens) >= req.max_new_tokens:
            req.finish_reason = "length"
            return True
        return False

    def _account_reason(self, tm, reason):
        counter = {"shed": "serve.shed", "timeout": "serve.timeouts",
                   "oom_evicted": "serve.oom_evictions",
                   "drained": "serve.drained",
                   "error": "serve.errors"}.get(reason)
        if tm is not None and counter is not None:
            tm.inc(counter)

    def _record_event_span(self, req, name, attrs=None):
        """Instantaneous event span under the request root — shed/timeout/
        evict events are queryable by span NAME, not just root attrs."""
        now = time.perf_counter_ns()
        _tracing.get_tracer().record(
            name, now, now, parent=req.trace_span,
            attrs={"rid": req.rid, **(attrs or {})})

    def _finish_unadmitted(self, req, reason, tm, attrs=None):
        """Terminal bookkeeping for a request that never held a slot
        (shed / queue timeout / drained-from-queue / prefill error)."""
        if req.finished:
            return req
        if reason not in FINISH_REASONS:
            raise ValueError(f"internal: finish reason {reason!r} not in "
                             f"{FINISH_REASONS}")
        req.finish_reason = reason
        req.done_ns = time.perf_counter_ns()
        self.finished.append(req)
        if req.queue_span is not None:
            req.queue_span.end()
            req.queue_span = None
        if req.trace_span is not None:
            self._record_event_span(req, reason, attrs)
            req.trace_span.set_attr("finish_reason", reason)
            req.trace_span.set_attr("tokens", len(req.tokens))
            req.trace_span.end()
        self._account_reason(tm, reason)
        return req

    def _evict(self, req, reason=None):
        if req.finished:  # exactly-one-terminal-reason guard
            return req
        if reason is not None:
            if reason not in FINISH_REASONS:
                raise ValueError(f"internal: finish reason {reason!r} not "
                                 f"in {FINISH_REASONS}")
            req.finish_reason = reason
        tm = _telemetry.get_telemetry() if _telemetry.enabled() else None
        try:
            _inject.check("serve.evict")
        except TransientError:
            # eviction must complete — a faulting evict path may not lose
            # the request's accounting
            if tm is not None:
                tm.inc("serve.evict_faults")
        req.done_ns = time.perf_counter_ns()
        self.active.pop(req.slot, None)
        self.prefilling.pop(req.slot, None)
        if req.sampled:
            clear = getattr(self.engine, "clear_slot_sampling", None)
            if clear is not None:
                clear(req.slot)
        heapq.heappush(self._free, req.slot)
        self.events.append((self._step_idx, "evict", req.rid, req.slot))
        self.finished.append(req)
        if req.prefill_span is not None:
            # died mid-chunked-prefill: the long-lived span closes with
            # the terminal reason and the chunk offset it got to
            req.prefill_span.set_attr("interrupted", req.finish_reason)
            req.prefill_span.set_attr("prefill_off", req.prefill_off)
            req.prefill_span.end()
            req.prefill_span = None
        if req.trace_span is not None:
            if req.finish_reason not in ("eos", "length"):
                self._record_event_span(req, req.finish_reason,
                                        {"slot": req.slot})
            req.trace_span.set_attr("finish_reason", req.finish_reason)
            req.trace_span.set_attr("tokens", len(req.tokens))
            if req.ttft_s is not None:
                req.trace_span.set_attr("ttft_s", req.ttft_s)
            if req.latency_s is not None:
                req.trace_span.set_attr("latency_s", req.latency_s)
            req.trace_span.end()
        if tm is not None:
            tm.inc("serve.evicted")
            self._account_reason(tm, req.finish_reason)
            if req.ttft_s is not None:
                tm.observe("serve.ttft_s", req.ttft_s)
            if req.tpot_s is not None:
                tm.observe("serve.tpot_s", req.tpot_s)
            if req.latency_s is not None:
                tm.observe("serve.latency_s", req.latency_s)
        return req

    def occupancy(self):
        """Mean decode-batch occupancy: active slots per decode step over
        the batch width (1.0 = the decode batch stayed dense)."""
        if not self.decode_steps:
            return 0.0
        return self.slot_steps / (self.decode_steps * self.engine.max_batch)
