"""The port's serving resilience on the CPU: twins of all 21 tests of
``tests/test_serving_resilience.py`` (deadlines, admission control / load
shedding, OOM-safe degraded decode, drain accounting, the deterministic
chaos inject points), run on ``GenerationEngine(device="cpu")``.

Contracts under test (the JAX package's):
  * every request, on every path, ends with EXACTLY ONE terminal
    ``finish_reason`` from ``serving.FINISH_REASONS``;
  * an injected OOM mid-decode evicts exactly the largest-footprint
    victim and the SURVIVORS' token streams are identical to a clean run;
  * deadline / queue-wait expiry evicts with ``timeout`` and hands the
    freed slot to the next queued request in the same tick;
  * a full bounded queue, the cost-aware admission policy (whose shed set
    over a submit stream equals the JAX package's) and an injected
    ``serve.admit`` fault shed at submit with the counter;
  * ``drain()``/``shutdown()`` terminate ALL outstanding work with
    ``drained``;
  * readers of the retired ``serve.requests_in_flight``/``queue_depth``
    gauges stay absent-safe;
  * ``fault.inject`` rejects unknown points exactly like unknown kinds,
    and the ``stall`` kind sleeps instead of raising.

Everything is deterministic: ``retry_sleep`` is stubbed, faults are armed
at fixed hit counts, and the OOM victim choice is a (footprint, slot) max.
"""
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.fault import inject
from paddle_tpu_torch.fault.retry import TransientError
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.profiler import telemetry, tracing
from paddle_tpu_torch.serving import (
    FINISH_REASONS,
    CostAwareAdmission,
    GenerationEngine,
    Request,
    Scheduler,
)


def _gpt(seed=3, max_pos=64):
    model = GPTForCausalLM(GPTConfig(
        vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
        max_position_embeddings=max_pos, hidden_dropout=0.0,
        attention_dropout=0.0), device="cpu",
        generator=torch.Generator().manual_seed(seed))
    model.eval()
    return model


@pytest.fixture(scope="module")
def eng():
    """One 2-slot engine shared by the module: prefill fully resets a slot
    on admit, so cache state left by one test cannot leak into the
    next."""
    model = _gpt()
    e = GenerationEngine(model, max_batch=2, max_len=64,
                         prefill_buckets=(8, 16), device="cpu")
    e.prefill(0, [1] * 7)
    e.prefill(0, [1] * 12)
    e.decode_once(np.zeros(2, np.int32))
    return e


@pytest.fixture(autouse=True)
def _clean_faults():
    inject.disarm_all()
    yield
    inject.disarm_all()


def _sched(eng, **kw):
    kw.setdefault("retry_sleep", lambda s: None)  # tests never sleep
    return Scheduler(eng, **kw)


def _reqs(n, seed=5, max_new=6, vocab=97):
    rng = np.random.RandomState(seed)
    return [Request(prompt=rng.randint(0, vocab,
                                       int(rng.randint(3, 14))).tolist(),
                    max_new_tokens=max_new) for _ in range(n)]


def _assert_full_accounting(sched, submitted):
    assert len(sched.finished) == len(submitted)
    assert len({r.rid for r in sched.finished}) == len(submitted)
    for r in submitted:
        assert r.finished, f"rid {r.rid} never reached a terminal state"
        assert r.finish_reason in FINISH_REASONS, r.finish_reason


# ---------------------------------------------------------------------------
# OOM-safe degraded decode
# ---------------------------------------------------------------------------
def test_oom_mid_decode_evicts_victim_survivors_match_clean(eng):
    prompts = [r.prompt for r in _reqs(4, seed=8)]
    # clean reference streams
    clean = _sched(eng)
    clean_reqs = [Request(prompt=list(p), max_new_tokens=6) for p in prompts]
    for r in clean_reqs:
        clean.submit(r)
    clean.run()

    telemetry.reset()
    telemetry.enable()
    try:
        sched = _sched(eng)
        reqs = [Request(prompt=list(p), max_new_tokens=6) for p in prompts]
        for r in reqs:
            sched.submit(r)
        inject.arm("oom", "serve.decode", at=2)
        fin = sched.run()
        counters = telemetry.get_telemetry().counters()
    finally:
        telemetry.disable()
        telemetry.reset()

    _assert_full_accounting(sched, reqs)
    victims = [r for r in fin if r.finish_reason == "oom_evicted"]
    assert len(victims) == 1
    # deterministic victim: largest (prompt + generated) footprint among
    # the actives at the faulted tick, highest slot on ties
    assert counters["serve.oom_evictions"] == 1
    assert counters["serve.degraded_steps"] == 1
    # survivors stream EXACTLY the clean tokens — the degraded tick is
    # invisible to the slots that kept their cache
    survivors = [r for r in reqs if r.finish_reason in ("eos", "length")]
    assert survivors, "OOM eviction took out every request"
    for r, ref in zip(reqs, clean_reqs):
        if r.finish_reason in ("eos", "length"):
            assert r.tokens == ref.tokens, f"rid {r.rid} diverged"


def test_oom_during_prefill_evicts_active_victim_then_admits(eng):
    sched = _sched(eng)
    first, second = _reqs(2, seed=9)
    sched.submit(first)
    sched.step()  # first is active
    assert first.slot is not None
    inject.arm("oom", "serve.prefill", at=1)
    sched.submit(second)
    sched.run()
    _assert_full_accounting(sched, [first, second])
    # the only active request was the only possible victim; the freed HBM
    # let the retried prefill succeed and second finished normally
    assert first.finish_reason == "oom_evicted"
    assert second.finish_reason == "length"
    assert len(second.tokens) == second.max_new_tokens


# ---------------------------------------------------------------------------
# deadlines and queue-wait budgets
# ---------------------------------------------------------------------------
def test_deadline_expiry_evicts_with_timeout_and_frees_slot(eng):
    sched = _sched(eng)
    hog_a, hog_b, waiter = _reqs(3, seed=10, max_new=8)
    sched.submit(hog_a)
    sched.submit(hog_b)
    sched.step()  # both slots taken
    sched.submit(waiter)
    sched.step()
    assert waiter.slot is None  # still queued: no free slot
    # the first hog's total-latency budget expires mid-serve
    hog_a.deadline_s = 0.0
    sched.step()
    assert hog_a.finish_reason == "timeout"
    assert hog_a.tokens, "an admitted request keeps its partial tokens"
    # the freed slot went to the waiter IN THE SAME TICK (expire runs
    # before admit)
    assert waiter.slot == hog_a.slot
    sched.run()
    _assert_full_accounting(sched, [hog_a, hog_b, waiter])
    assert waiter.finish_reason == "length"


def test_queue_wait_budget_times_out_without_ever_taking_a_slot(eng):
    telemetry.reset()
    telemetry.enable()
    try:
        sched = _sched(eng)
        hogs = _reqs(2, seed=11, max_new=4)
        for r in hogs:
            sched.submit(r)
        sched.step()
        impatient = Request(prompt=[1, 2, 3], max_new_tokens=4,
                            max_queue_s=0.0)
        sched.submit(impatient)
        sched.step()
        counters = telemetry.get_telemetry().counters()
    finally:
        telemetry.disable()
        telemetry.reset()
    assert impatient.finish_reason == "timeout"
    assert impatient.slot is None and impatient.tokens == []
    assert counters["serve.timeouts"] == 1
    assert (sched._step_idx - 1, "timeout", impatient.rid, None) \
        in sched.events


# ---------------------------------------------------------------------------
# admission control + load shedding
# ---------------------------------------------------------------------------
def test_full_queue_sheds_at_submit_with_counter(eng):
    telemetry.reset()
    telemetry.enable()
    try:
        sched = _sched(eng, max_queue=2)
        reqs = _reqs(4, seed=12)
        out = [sched.submit(r) for r in reqs]
        counters = telemetry.get_telemetry().counters()
    finally:
        telemetry.disable()
        telemetry.reset()
    assert [r.finish_reason for r in out] == [None, None, "shed", "shed"]
    assert out[2] is reqs[2]  # the caller gets its own request back
    assert counters["serve.shed"] == 2
    assert counters["serve.submitted"] == 4
    shed_events = [e for e in sched.events if e[1] == "shed"]
    assert len(shed_events) == 2
    # shed requests are already terminal — the run serves the queued two
    sched.run()
    _assert_full_accounting(sched, reqs)


def test_cost_aware_admission_sheds_on_backlog(eng):
    # cap below two requests' worth: the second submit must shed
    policy = CostAwareAdmission(max_backlog_tokens=20)
    sched = _sched(eng, admission=policy)
    a = Request(prompt=[1] * 6, max_new_tokens=6)   # bucket 8 + 6 = 14
    b = Request(prompt=[1] * 6, max_new_tokens=6)
    sched.submit(a)
    sched.submit(b)
    assert a.finish_reason is None and b.finish_reason == "shed"
    # active requests count their REMAINING budget toward the backlog
    sched.run()
    assert a.finish_reason == "length"
    c = Request(prompt=[1] * 6, max_new_tokens=6)
    sched.submit(c)
    assert c.finish_reason is None  # backlog drained: admitted again
    sched.run()


def _shed_stream(mod, eng, policy):
    """Submit a seeded stream with ticks between waves; the shed rids'
    positions in the stream."""
    sched = mod.Scheduler(eng, admission=policy, retry_sleep=lambda s: None)
    rng = np.random.RandomState(21)
    reqs = [mod.Request(prompt=[1] * int(rng.randint(3, 15)),
                        max_new_tokens=int(rng.randint(2, 9)))
            for _ in range(12)]
    for lo in range(0, len(reqs), 4):
        for r in reqs[lo:lo + 4]:
            sched.submit(r)
        sched.step()
    sched.run()
    return [i for i, r in enumerate(reqs) if r.finish_reason == "shed"]


@pytest.mark.parametrize("cap", [20, 40, 64])
def test_cost_aware_admission_shed_set_equals_jax(eng, cap):
    import paddle_tpu.serving as jserving
    import paddle_tpu_torch.serving as pserving

    from tests.torch_port_util import gpt_pair

    jm, _ = gpt_pair(vocab=97, hidden=32, layers=1, heads=2, max_pos=64)
    jeng = jserving.GenerationEngine(jm, max_batch=2, max_len=64,
                                     prefill_buckets=(8, 16))
    want = _shed_stream(jserving, jeng,
                        jserving.CostAwareAdmission(max_backlog_tokens=cap))
    got = _shed_stream(pserving, eng,
                       pserving.CostAwareAdmission(max_backlog_tokens=cap))
    assert got == want
    assert 0 < len(got) < 12 or cap == 64


def test_injected_admit_fault_sheds_deterministically(eng):
    inject.arm("error", "serve.admit", at=2)
    sched = _sched(eng)
    reqs = _reqs(3, seed=13, max_new=3)
    out = [sched.submit(r) for r in reqs]
    assert [r.finish_reason for r in out] == [None, "shed", None]
    sched.run()
    _assert_full_accounting(sched, reqs)


# ---------------------------------------------------------------------------
# transient prefill faults: retry then terminal error
# ---------------------------------------------------------------------------
def test_prefill_transient_fault_retries_and_stream_is_unperturbed(eng):
    ref = _sched(eng)
    ref_req = Request(prompt=[7, 8, 9, 10], max_new_tokens=5)
    ref.submit(ref_req)
    ref.run()

    inject.arm("error", "serve.prefill", at=1)
    sched = _sched(eng)
    req = Request(prompt=[7, 8, 9, 10], max_new_tokens=5)
    sched.submit(req)
    sched.run()
    assert req.finish_reason == "length"
    assert req.tokens == ref_req.tokens  # the retry is invisible


def test_prefill_faults_past_retry_budget_fail_terminally(eng):
    # three at=1 entries: check() consumes one per hit (it breaks after a
    # fire, so later entries don't see that hit) — every attempt of the
    # default tries=3 budget faults, the 4th check (healthy) runs clean
    for _ in range(3):
        inject.arm("error", "serve.prefill", at=1)
    telemetry.reset()
    telemetry.enable()
    try:
        sched = _sched(eng)
        doomed, healthy = _reqs(2, seed=14, max_new=3)
        sched.submit(doomed)
        sched.submit(healthy)
        sched.run()
        counters = telemetry.get_telemetry().counters()
    finally:
        telemetry.disable()
        telemetry.reset()
    _assert_full_accounting(sched, [doomed, healthy])
    assert doomed.finish_reason == "error"
    assert doomed.slot is None and doomed.tokens == []
    assert counters["serve.errors"] == 1
    # the slot the failed prefill borrowed went back to the pool
    assert healthy.finish_reason == "length"
    assert ("error", doomed.rid) in [(e[1], e[2]) for e in sched.events]


# ---------------------------------------------------------------------------
# drain / shutdown accounting
# ---------------------------------------------------------------------------
def test_drain_accounts_for_queued_and_active_requests(eng):
    telemetry.reset()
    telemetry.enable()
    try:
        sched = _sched(eng)
        reqs = _reqs(4, seed=15, max_new=8)
        for r in reqs:
            sched.submit(r)
        sched.step()  # two active (slots), two still queued
        fin = sched.drain()
        tm = telemetry.get_telemetry()
        counters, gauges = tm.counters(), tm.gauges()
    finally:
        telemetry.disable()
        telemetry.reset()
    assert fin is sched.finished
    _assert_full_accounting(sched, reqs)
    assert all(r.finish_reason == "drained" for r in reqs)
    actives = [r for r in reqs if r.slot is not None]
    assert actives and all(r.tokens for r in actives)  # partials kept
    queued = [r for r in reqs if r.slot is None]
    assert queued and all(not r.tokens for r in queued)
    assert counters["serve.drained"] == 4
    # drain retires the lifecycle gauges (the stale-gauge contract)
    assert "serve.requests_in_flight" not in gauges
    assert "serve.queue_depth" not in gauges


def test_shutdown_drains_midflight_and_is_idempotent(eng):
    sched = _sched(eng)
    reqs = _reqs(3, seed=16, max_new=8)
    for r in reqs:
        sched.submit(r)
    sched.step()
    sched.shutdown()
    _assert_full_accounting(sched, reqs)
    assert all(r.finish_reason == "drained" for r in reqs)
    sched.shutdown()  # second shutdown: no double accounting
    assert len(sched.finished) == 3


def test_mixed_chaos_everything_reaches_exactly_one_terminal_state(eng):
    inject.arm("error", "serve.prefill", at=2)
    inject.arm("oom", "serve.decode", at=4)
    sched = _sched(eng, max_queue=3)
    submitted = [sched.submit(Request(prompt=[1, 2, 3], max_new_tokens=4,
                                      deadline_s=0.0))]
    for r in _reqs(6, seed=17, max_new=4):
        submitted.append(sched.submit(r))
    sched.run()
    sched.shutdown()
    _assert_full_accounting(sched, submitted)
    reasons = {r.finish_reason for r in submitted}
    assert "shed" in reasons and "timeout" in reasons


# ---------------------------------------------------------------------------
# retired-gauge reader safety (satellite regression)
# ---------------------------------------------------------------------------
def test_retired_gauge_readers_are_absent_safe():
    """After drain the serve gauges are ABSENT, not 0 — every
    reader must .get() with a default. Covers the SLO value fallback and
    the stdlib report tools."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "tools"))
    import telemetry_report

    from paddle_tpu_torch.profiler.slo import SERVING_SLOS, SLOSpec

    telemetry.reset()
    telemetry.enable()
    try:
        tm = telemetry.get_telemetry()
        tm.inc("serve.shed", 2)
        tm.inc("serve.decode_steps", 5)
        # no serve gauges at all — the post-drain registry shape
        assert "serve.queue_depth" not in tm.gauges()
        # a gauge-named spec falls through to the counters-read-as-0 path
        spec = SLOSpec.parse("serve.queue_depth < 16")
        ok, value = spec.evaluate(tm)
        assert ok is True and value == 0.0
        # the shipped serving SLOs never reference the retirable gauges
        for text in SERVING_SLOS:
            s = SLOSpec.parse(text)
            assert s.metric not in ("serve.requests_in_flight",
                                    "serve.queue_depth"), text
        # report tools render a gauge-free serve block without KeyError
        table = telemetry_report.build_table(
            {}, {}, {"serve.shed": 2.0, "serve.decode_steps": 5.0}, {}, {})
        assert "serve.shed" in table
        # bench_serve's reader idiom: absent gauge reads as the default
        assert tm.gauges().get("serve.requests_in_flight", 0.0) == 0.0
    finally:
        telemetry.disable()
        telemetry.reset()


# ---------------------------------------------------------------------------
# fault.inject: serve points, unknown-point error, stall kind
# ---------------------------------------------------------------------------
def test_unknown_point_raises_same_error_as_unknown_kind():
    with pytest.raises(ValueError, match="unknown fault kind"):
        inject.arm("meteor", "serve.decode")
    with pytest.raises(ValueError, match="unknown fault point"):
        inject.arm("error", "serve.decoed")  # typo must fail loudly
    for point in ("serve.admit", "serve.prefill", "serve.decode",
                  "serve.evict", "serve.draft", "serve.verify"):
        assert point in inject.POINTS
        inject.arm("error", point, at=99)  # all of them arm cleanly
    inject.disarm_all()


def test_stall_kind_sleeps_then_returns(monkeypatch):
    monkeypatch.setenv(inject.STALL_ENV_VAR, "0.02")
    inject.arm("stall", "serve.decode", at=1)
    t0 = time.perf_counter()
    assert inject.check("serve.decode") == "stall"
    assert time.perf_counter() - t0 >= 0.02
    assert inject.check("serve.decode") is None  # fires once


def test_evict_fault_does_not_lose_the_request(eng):
    inject.arm("error", "serve.evict", at=1)
    telemetry.reset()
    telemetry.enable()
    try:
        sched = _sched(eng)
        req = Request(prompt=[4, 5, 6], max_new_tokens=3)
        sched.submit(req)
        sched.run()
        counters = telemetry.get_telemetry().counters()
    finally:
        telemetry.disable()
        telemetry.reset()
    assert req.finish_reason == "length"  # eviction completed regardless
    assert req in sched.finished
    assert counters["serve.evict_faults"] == 1


# ---------------------------------------------------------------------------
# trace event spans for abnormal terminations
# ---------------------------------------------------------------------------
def test_shed_and_timeout_record_trace_event_spans(eng):
    tracing.reset()
    tracing.enable()
    try:
        sched = _sched(eng, max_queue=1)
        kept = Request(prompt=[1, 2, 3], max_new_tokens=2,
                       max_queue_s=0.0)
        sched.submit(kept)     # queued, will time out waiting
        shed = sched.submit(Request(prompt=[4, 5, 6], max_new_tokens=2))
        sched.step()
        spans = tracing.get_tracer().spans()
    finally:
        tracing.disable()
        tracing.reset()
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    assert shed.finish_reason == "shed"
    assert kept.finish_reason == "timeout"
    # event spans are queryable by NAME and parent under the request root
    (shed_ev,) = by_name["shed"]
    assert shed_ev.attrs["rid"] == shed.rid
    assert shed_ev.trace_id == shed.trace_id
    (timeout_ev,) = by_name["timeout"]
    assert timeout_ev.attrs["rid"] == kept.rid
    # root spans closed with the terminal reason
    roots = {s.attrs.get("rid"): s for s in by_name["request"]}
    assert roots[shed.rid].attrs["finish_reason"] == "shed"
    assert roots[kept.rid].attrs["finish_reason"] == "timeout"
    assert all(s.end_ns is not None for s in by_name["request"])


# ---------------------------------------------------------------------------
# chunked prefill + speculative decoding under faults
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def spec_eng():
    """A 2-slot engine with speculation AND chunked prefill armed, every
    step run once — the resilience paths below fault the new surfaces
    (mid-chunk expiry, between-chunk OOM, draft/verify faults)."""
    model = _gpt(seed=4)
    e = GenerationEngine(model, max_batch=2, max_len=64,
                         prefill_buckets=(8, 16), spec_k=4,
                         prefill_chunk=4, device="cpu")
    e.prefill(0, [1] * 7)
    e.prefill(0, [1] * 12)
    e.decode_once(np.zeros(2, np.int32))
    off, tok = 0, None
    while tok is None:  # two-chunk warm of the chunk step
        tok = e.prefill_chunk_step(0, [1] * 5, off)
        off += 4
    e.verify_once(np.zeros((2, 5), np.int32))  # lengths unchanged
    return e


def test_mid_chunk_deadline_expiry_is_exactly_one_timeout(spec_eng):
    sched = _sched(spec_eng)
    req = Request(prompt=list(range(1, 13)), max_new_tokens=4,
                  deadline_s=60.0)
    sched.submit(req)
    sched.step()  # admitted into the chunked path, ONE chunk advanced
    assert req.slot is not None and not req.finished
    assert req.prefill_off == 4  # mid-prefill: 1 of 3 chunks done
    req.deadline_s = 1e-9  # already elapsed: next tick must expire it
    sched.step()
    _assert_full_accounting(sched, [req])
    assert req.finish_reason == "timeout"
    assert not req.tokens  # died between chunks: no token, no double-count
    # the freed slot and the engine survive: a fresh request runs clean
    nxt = Request(prompt=list(range(1, 13)), max_new_tokens=4)
    sched.submit(nxt)
    sched.run()
    assert nxt.finish_reason == "length"
    assert len(nxt.tokens) == 4


def test_oom_between_chunks_evicts_decoder_not_the_prefiller(spec_eng):
    prompt = list(range(20, 31))  # 11 tokens -> chunks of 4, 4, 3
    clean = Request(prompt=list(prompt), max_new_tokens=8)
    solo = _sched(spec_eng)
    solo.submit(clean)
    solo.run()

    sched = _sched(spec_eng)
    hog = Request(prompt=[3, 5, 7], max_new_tokens=12)
    sched.submit(hog)
    sched.step()  # hog active and decoding
    # armed AFTER hog's one-shot prefill, so hit 1 is the newcomer's
    # first chunk: the OOM lands mid-chunked-prefill, and the victim must
    # be the DECODING neighbor (the requester is excluded — evicting it
    # would orphan the retry)
    inject.arm("oom", "serve.prefill", at=1)
    telemetry.reset()
    telemetry.enable()
    try:
        req = Request(prompt=list(prompt), max_new_tokens=8)
        sched.submit(req)
        sched.run()
        counters = telemetry.get_telemetry().counters()
    finally:
        telemetry.disable()
        telemetry.reset()
    _assert_full_accounting(sched, [hog, req])
    assert hog.finish_reason == "oom_evicted"
    assert counters["serve.oom_evictions"] == 1
    # the interrupted-then-retried prefiller still streams EXACTLY what a
    # clean solo run of the same prompt produced
    assert req.finish_reason == "length"
    assert req.tokens == clean.tokens


def test_draft_fault_decodes_plain_and_stream_is_byte_identical(spec_eng):
    # cyclic prompts guarantee the n-gram proposer WOULD draft; the
    # injected fault drops every proposal for one tick and the scheduler
    # must decode plain — output identical to the unfaulted run
    prompts = [[1, 2, 3] * 4, [4, 5] * 5]
    refs = [Request(prompt=list(p), max_new_tokens=10) for p in prompts]
    ref_sched = _sched(spec_eng)
    for r in refs:
        ref_sched.submit(r)
    ref_sched.run()

    inject.arm("error", "serve.draft", at=2)
    sched = _sched(spec_eng)
    reqs = [Request(prompt=list(p), max_new_tokens=10) for p in prompts]
    for r in reqs:
        sched.submit(r)
    sched.run()
    _assert_full_accounting(sched, reqs)
    for r, ref in zip(reqs, refs):
        assert r.tokens == ref.tokens
        assert r.finish_reason == "length"


def test_verify_fault_falls_back_to_plain_tick_with_counter(spec_eng):
    prompts = [[6, 7, 8] * 4, [9, 1] * 5]
    refs = [Request(prompt=list(p), max_new_tokens=10) for p in prompts]
    ref_sched = _sched(spec_eng, speculative=False)  # plain-greedy truth
    for r in refs:
        ref_sched.submit(r)
    ref_sched.run()

    inject.arm("error", "serve.verify", at=1)
    telemetry.reset()
    telemetry.enable()
    try:
        sched = _sched(spec_eng)
        reqs = [Request(prompt=list(p), max_new_tokens=10) for p in prompts]
        for r in reqs:
            sched.submit(r)
        sched.run()
        counters = telemetry.get_telemetry().counters()
    finally:
        telemetry.disable()
        telemetry.reset()
    _assert_full_accounting(sched, reqs)
    # the faulted tick degraded (counted) and later ticks speculated again
    assert counters["serve.spec_fallback_ticks"] == 1
    assert counters.get("serve.spec_ticks", 0) > 0
    for r, ref in zip(reqs, refs):
        assert r.tokens == ref.tokens


# ---------------------------------------------------------------------------
# the port's chaos and bench tools (torch_tools/), their tiny CPU config
# ---------------------------------------------------------------------------
def _tool(name):
    import importlib
    import os
    import sys

    tools = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "torch_tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    return importlib.import_module(name)


def test_chaos_harness_smoke_keeps_the_contract():
    """Every deterministic part of the contract; the recovery bar is a
    timing of this shared host, so only its figures are checked here (the
    card's run in ``chip_smoke.py`` holds the bar)."""
    res = _tool("torch_chaos_serve").run_chaos(seed=0, reps=1)
    problems = [p for p in res["problems"]
                if not p.startswith("post-chaos throughput")]
    assert not problems, problems
    assert res["clean_tokens_per_sec"] > 0
    assert res["recovery_tokens_per_sec"] > 0
    assert res["submitted"] == 26
    assert sum(res["finish_reasons"].values()) == 26
    for reason in ("shed", "timeout", "oom_evicted"):
        assert res["finish_reasons"].get(reason), reason
    assert res["survivors"] > 0 and res["slo_alerts"] > 0
    assert not inject.armed() and not telemetry.enabled()


def test_bench_serve_smoke_passes_its_contract(capsys):
    import json

    assert _tool("torch_bench_serve").main(["--smoke"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["speedup_vs_sequential"] > 0
    assert res["dispatch_shapes"]["serve_verify"] == [[4, 5]]
    assert res["continuous"]["tokens"] == res["sequential"]["tokens"] == 64
