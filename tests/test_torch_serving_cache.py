"""The port's static-cache serving tier on the CPU: twins of
``tests/test_serving.py`` (bucket helpers, the KV-cache layout, cached
greedy parity, ``model.generate``, EOS, the per-bucket dispatch shapes in
place of JAX's compile counts, the deprecated tuple cache, the
continuous-batching scheduler's determinism, isolation, refusals and
telemetry), and the engine's ``predicted_footprints`` and
``CostAwareAdmission``'s byte policy against the JAX package.

Not twinned here: ``test_decode_lint_clean_at_consecutive_positions`` and
``test_kv_cache_concat_rule_flags_legacy_gpt_cache`` lint a jaxpr
(``ROADMAP.md`` A9); ``test_encoder_scorer_parity_and_bucket_compiles``
has its twin in ``tests/test_torch_bert.py``.
"""
import warnings

import numpy as np
import pytest
import torch

from paddle_tpu.serving import CostAwareAdmission as JCostAware
from paddle_tpu.serving import GenerationEngine as JEngine
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import default_buckets as jdefault_buckets
from paddle_tpu.serving import pick_bucket as jpick_bucket

from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.profiler import telemetry
from paddle_tpu_torch.serving import (
    CostAwareAdmission,
    GenerationEngine,
    KVCache,
    Request,
    Scheduler,
    default_buckets,
    pick_bucket,
)
from tests.torch_port_util import gpt_pair, no_persistent_compile_cache  # noqa: F401


def _gpt_cfg(max_pos=128):
    return GPTConfig(vocab_size=97, hidden_size=32, num_layers=2,
                     num_heads=2, max_position_embeddings=max_pos,
                     hidden_dropout=0.0, attention_dropout=0.0)


def _gpt(seed=0, max_pos=128):
    model = GPTForCausalLM(_gpt_cfg(max_pos), device="cpu",
                           generator=torch.Generator().manual_seed(seed))
    model.eval()
    return model


def _engine(model, **kw):
    return GenerationEngine(model, device="cpu", **kw)


@torch.inference_mode()
def _greedy_eager(model, prompt, n):
    """Uncached reference: full forward over the growing sequence."""
    ids = list(prompt)
    out = []
    for _ in range(n):
        logits = model(torch.tensor([ids]))
        nxt = int(logits[0, -1].argmax())
        out.append(nxt)
        ids.append(nxt)
    return out


# ---------------------------------------------------------------------------
# bucketing + cache plumbing
# ---------------------------------------------------------------------------
def test_bucket_helpers():
    assert default_buckets(64) == (16, 32, 64)
    assert default_buckets(100) == (16, 32, 64, 100)
    for n in (16, 64, 100, 1024):
        assert default_buckets(n) == jdefault_buckets(n)
    assert pick_bucket(1, (8, 16)) == 8
    assert pick_bucket(8, (8, 16)) == 8   # boundary stays in its bucket
    assert pick_bucket(9, (8, 16)) == 16
    for n in range(1, 17):
        assert pick_bucket(n, (8, 16)) == jpick_bucket(n, (8, 16))
    with pytest.raises(ValueError, match="largest prefill bucket"):
        pick_bucket(17, (8, 16))


def test_kv_cache_alloc_layout():
    c = KVCache.alloc(num_layers=3, batch=2, max_len=16, num_heads=4,
                      head_dim=8, device="cpu")
    assert c.num_layers == 3 and c.batch == 2 and c.max_len == 16
    assert c.num_heads == 4 and c.head_dim == 8
    assert tuple(c.ks[0].shape) == (2, 16, 4, 8)
    assert c.lengths.dtype == torch.int32
    # 3 layers x (K+V) x 2*16*4*8 floats
    assert c.nbytes() == 3 * 2 * 2 * 16 * 4 * 8 * 4


# ---------------------------------------------------------------------------
# cached-vs-uncached greedy parity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("prompt_len", [5, 8])  # mid-bucket / boundary
def test_cached_greedy_parity_32_tokens(prompt_len,
                                        no_persistent_compile_cache):
    jm, tm = gpt_pair(vocab=97, hidden=32, layers=2, heads=2, max_pos=128)
    prompt = np.random.RandomState(7).randint(0, 97, prompt_len).tolist()
    got = _engine(tm, max_batch=2, max_len=64,
                  prefill_buckets=(8, 16)).generate(prompt, 32)
    assert got == _greedy_eager(tm, prompt, 32)
    want = JEngine(jm, max_batch=2, max_len=64,
                   prefill_buckets=(8, 16)).generate(prompt, 32)
    assert got == want


def test_generate_convenience_on_model_caches_engine():
    model = _gpt()
    prompt = [3, 1, 4, 1, 5]
    got = model.generate(prompt, max_new_tokens=8, max_len=64,
                         prefill_buckets=(8,))
    assert got == _greedy_eager(model, prompt, 8)
    eng = model._serve_engine
    model.generate(prompt, max_new_tokens=4, max_len=64,
                   prefill_buckets=(8,))
    assert model._serve_engine is eng


def test_generate_stops_at_eos():
    model = _gpt()
    eng = _engine(model, max_batch=1, max_len=64, prefill_buckets=(8,))
    free_run = eng.generate([1, 2, 3], max_new_tokens=8)
    eos = free_run[1]
    out = eng.generate([1, 2, 3], max_new_tokens=8, eos_id=eos)
    assert out == free_run[:free_run.index(eos) + 1]
    assert out[-1] == eos and len(out) < 8


# ---------------------------------------------------------------------------
# O(1) decode: one dispatch shape (JAX: one compile)
# ---------------------------------------------------------------------------
def test_decode_dispatches_one_shape_over_64_tokens():
    eng = _engine(_gpt(), max_batch=2, max_len=128, prefill_buckets=(8, 16))
    out = eng.generate([5, 6, 7], max_new_tokens=65)
    assert len(out) == 65
    assert eng.dispatch_shapes["serve_decode"] == [(2, 1)]  # 64 steps
    assert eng.dispatch_shapes["serve_prefill"] == [(1, 8)]


def test_prefill_dispatches_one_shape_per_bucket():
    eng = _engine(_gpt(), max_batch=2, max_len=64, prefill_buckets=(8, 16))
    eng.generate([1] * 5, max_new_tokens=3)    # bucket 8
    eng.generate([1] * 12, max_new_tokens=3)   # bucket 16
    eng.generate([1] * 7, max_new_tokens=3)    # bucket 8 again
    assert eng.dispatch_shapes["serve_prefill"] == [(1, 8), (1, 16)]
    assert eng.dispatch_shapes["serve_decode"] == [(2, 1)]


# ---------------------------------------------------------------------------
# the deprecated tuple cache
# ---------------------------------------------------------------------------
def test_tuple_cache_shim_still_works_and_warns_once():
    from paddle_tpu.framework.tensor import Tensor
    from paddle_tpu.utils import _WARNED_ONCE as J_WARNED

    from paddle_tpu_torch.utils import _WARNED_ONCE

    jm, tm = gpt_pair(vocab=97, hidden=32, layers=1, heads=2, max_pos=32)
    jl, layer = jm.gpt.layers[0], tm.gpt.layers[0]
    _WARNED_ONCE.discard("gpt-kv-cache-concat")
    J_WARNED.discard("gpt-kv-cache-concat")
    heads, hd = 2, 16
    rng = np.random.RandomState(0)
    k0 = rng.randn(1, 3, heads, hd).astype(np.float32)
    v0 = rng.randn(1, 3, heads, hd).astype(np.float32)
    x = rng.randn(1, 1, 32).astype(np.float32)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        with torch.no_grad():
            out, cache = layer(torch.from_numpy(x),
                               cache=(torch.from_numpy(k0),
                                      torch.from_numpy(v0)))
            out2, cache2 = layer(torch.from_numpy(x), cache=cache)
    msgs = [str(m.message) for m in w]
    assert sum("deprecated" in m for m in msgs) == 1  # warns ONCE
    assert tuple(cache[0].shape) == (1, 4, heads, hd)   # grew...
    assert tuple(cache2[0].shape) == (1, 5, heads, hd)  # ...again
    assert tuple(out2.shape) == (1, 1, 32)
    # the JAX layer's logits on the same weights and caches
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jout, jcache = jl(Tensor(x), cache=(Tensor(k0), Tensor(v0)))
        jout2, _ = jl(Tensor(x), cache=jcache)
    for a, b in ((out, jout), (out2, jout2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b._value),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------------
def _request_stream(seed, n, vocab=97):
    rng = np.random.RandomState(seed)
    return [Request(prompt=rng.randint(0, vocab,
                                       int(rng.randint(3, 14))).tolist(),
                    max_new_tokens=int(rng.randint(4, 12)), rid=i)
            for i in range(n)]


def _run_stream(seed):
    eng = _engine(_gpt(seed=3, max_pos=64), max_batch=4, max_len=64,
                  prefill_buckets=(8, 16))
    sched = Scheduler(eng)
    for req in _request_stream(seed, 9):
        sched.submit(req)
    finished = sched.run()
    return sched, {r.rid: list(r.tokens) for r in finished}


def test_scheduler_admit_evict_deterministic():
    s1, out1 = _run_stream(11)
    s2, out2 = _run_stream(11)
    assert s1.events == s2.events
    assert out1 == out2
    assert len(out1) == 9
    admits = [e for e in s1.events if e[1] == "admit"]
    assert len(admits) == 9 > s1.engine.max_batch
    assert 0.0 < s1.occupancy() <= 1.0


def test_scheduler_matches_single_request_generate():
    model = _gpt(seed=3, max_pos=64)
    sched = Scheduler(_engine(model, max_batch=3, max_len=64,
                              prefill_buckets=(8, 16)))
    reqs = _request_stream(5, 7)
    for r in reqs:
        sched.submit(r)
    sched.run()
    solo = _engine(model, max_batch=1, max_len=64, prefill_buckets=(8, 16))
    for r in reqs:
        want = solo.generate(r.prompt, max_new_tokens=r.max_new_tokens)
        assert r.tokens == want, f"request {r.rid} diverged"
        assert r.finish_reason == "length"
        assert r.ttft_s is not None and r.latency_s is not None


def test_scheduler_rejects_oversized_requests():
    sched = Scheduler(_engine(_gpt(max_pos=64), max_batch=2, max_len=32,
                              prefill_buckets=(8, 16)))
    with pytest.raises(ValueError, match="prefill bucket"):
        sched.submit(Request(prompt=[1] * 20, max_new_tokens=4))
    with pytest.raises(ValueError, match="cache capacity"):
        sched.submit(Request(prompt=[1] * 10, max_new_tokens=30))
    with pytest.raises(ValueError, match="empty prompt"):
        sched.submit(Request(prompt=[], max_new_tokens=4))


def test_scheduler_publishes_telemetry():
    telemetry.reset()
    telemetry.enable()
    try:
        sched = Scheduler(_engine(_gpt(max_pos=64), max_batch=2, max_len=64,
                                  prefill_buckets=(8, 16)))
        for r in _request_stream(2, 4):
            r.max_new_tokens = 4
            sched.submit(r)
        sched.run()
        tm = telemetry.get_telemetry()
        counters, gauges = tm.counters(), tm.gauges()
        ttft = tm.get("serve.ttft_s")
        latency = tm.get("serve.latency_s")
    finally:
        telemetry.disable()
        telemetry.reset()
    assert counters["serve.admitted"] == 4
    assert counters["serve.evicted"] == 4
    assert counters["serve.tokens_generated"] == 16
    assert counters["serve.decode_steps"] == sched.decode_steps
    assert "serve.requests_in_flight" not in gauges
    assert "serve.queue_depth" not in gauges
    assert ttft.get("count") == 4
    assert latency.get("count") == 4


def test_scheduler_gauges_retired_on_drain_and_shutdown():
    telemetry.reset()
    telemetry.enable()
    try:
        sched = Scheduler(_engine(_gpt(max_pos=64), max_batch=2, max_len=64,
                                  prefill_buckets=(8, 16)))
        for r in _request_stream(3, 3):
            r.max_new_tokens = 3
            sched.submit(r)
        tm = telemetry.get_telemetry()
        assert tm.gauges()["serve.queue_depth"] == 3.0
        sched.step()
        g = tm.gauges()
        assert g["serve.requests_in_flight"] == 2.0
        assert g["serve.queue_depth"] == 1.0
        sched.run(max_steps=1)
        assert "serve.requests_in_flight" in tm.gauges()
        sched.run()
        g = tm.gauges()
        assert "serve.requests_in_flight" not in g
        assert "serve.queue_depth" not in g
        for r in _request_stream(5, 1):
            r.max_new_tokens = 2
            sched.submit(r)
        sched.step()
        assert "serve.requests_in_flight" in tm.gauges()
        sched.shutdown()
        g = tm.gauges()
        assert "serve.requests_in_flight" not in g
        assert "serve.queue_depth" not in g
        tm.set_gauge("serve.tokens_per_s", 42.0)
        sched.shutdown()
        assert tm.gauges()["serve.tokens_per_s"] == 42.0
    finally:
        telemetry.disable()
        telemetry.reset()


# ---------------------------------------------------------------------------
# predicted footprints and the byte policy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_predicted_footprints_match_jax(dtype):
    import jax.numpy as jnp

    jm, tm = gpt_pair(vocab=97, hidden=32, layers=2, heads=2, max_pos=64)
    kw = dict(max_batch=3, max_len=48, prefill_buckets=(8, 16, 32))
    jfp = JEngine(jm, cache_dtype=getattr(jnp, dtype),
                  **kw).predicted_footprints()
    eng = _engine(tm, cache_dtype=getattr(torch, dtype), **kw)
    fp = eng.predicted_footprints()
    assert sorted(fp) == sorted(jfp) == sorted(
        ["decode_peak_bytes", "cache_bytes", "base_bytes", "per_token_bytes",
         "prefill_bucket_bytes", "timeline"])
    for key in ("cache_bytes", "per_token_bytes", "prefill_bucket_bytes"):
        assert fp[key] == jfp[key], key
    assert fp["timeline"] is None
    # the CPU decode peak: cache + parameters + one tick's logits
    params = sum(p.numel() * p.element_size() for p in tm.parameters())
    assert fp["decode_peak_bytes"] == fp["cache_bytes"] + params + 3 * 97 * 4
    assert fp["base_bytes"] == fp["decode_peak_bytes"] - fp["cache_bytes"]
    assert eng.predicted_footprints() == fp            # cached
    assert eng.predicted_footprints(refresh=True) == fp


def test_estimate_bytes_equals_jax_per_request():
    jm, tm = gpt_pair(vocab=97, hidden=32, layers=2, heads=2, max_pos=64)
    kw = dict(max_batch=2, max_len=40, prefill_buckets=(8, 16, 32))
    jeng, eng = JEngine(jm, **kw), _engine(tm, **kw)
    jpol, pol = JCostAware(policy="bytes"), CostAwareAdmission(policy="bytes")
    rng = np.random.RandomState(3)
    for _ in range(12):
        n, m = int(rng.randint(1, 33)), int(rng.randint(1, 40))
        assert pol.estimate_bytes(Request(prompt=[1] * n, max_new_tokens=m),
                                  eng) == jpol.estimate_bytes(
            JRequest(prompt=[1] * n, max_new_tokens=m), jeng)
        assert pol.estimate(Request(prompt=[1] * n, max_new_tokens=m),
                            eng) == jpol.estimate(
            JRequest(prompt=[1] * n, max_new_tokens=m), jeng)


def test_byte_policy_sheds_past_capacity():
    eng = _engine(_gpt(max_pos=64), max_batch=2, max_len=64,
                  prefill_buckets=(8, 16))
    fp = eng.predicted_footprints()
    probe = CostAwareAdmission(policy="bytes")
    one = probe.estimate_bytes(Request(prompt=[1] * 6, max_new_tokens=6),
                               eng)
    # room for one request's bytes, not two
    policy = CostAwareAdmission(policy="bytes",
                                capacity_bytes=fp["base_bytes"] + one + 1)
    sched = Scheduler(eng, admission=policy, retry_sleep=lambda s: None)
    a = sched.submit(Request(prompt=[1] * 6, max_new_tokens=6))
    b = sched.submit(Request(prompt=[1] * 6, max_new_tokens=6))
    assert a.finish_reason is None and b.finish_reason == "shed"
    sched.run()
    assert a.finish_reason == "length"
    # the CPU default capacity: base + headroom x cache
    roomy = CostAwareAdmission(policy="bytes")
    sched = Scheduler(eng, admission=roomy, retry_sleep=lambda s: None)
    reqs = [sched.submit(Request(prompt=[1] * 6, max_new_tokens=6))
            for _ in range(4)]
    assert not any(r.finish_reason == "shed" for r in reqs)
    sched.run()
    with pytest.raises(ValueError, match="policy"):
        CostAwareAdmission(policy="flops")


def test_predicted_footprints_mid_stream_leaves_every_stream_unchanged():
    model = _gpt(seed=5, max_pos=64)

    def serve(probe):
        eng = _engine(model, max_batch=3, max_len=64, prefill_buckets=(8, 16),
                      spec_k=2)
        sched = Scheduler(eng, retry_sleep=lambda s: None)
        rng = np.random.RandomState(9)
        reqs = [Request(prompt=rng.randint(0, 97, 6).tolist(),
                        max_new_tokens=14) for _ in range(2)]
        reqs.append(Request(prompt=[4, 5, 6], max_new_tokens=14,
                            temperature=0.8, top_k=20, seed=11))
        for r in reqs:
            sched.submit(r)
        for _ in range(4):
            sched.step()
        if probe:
            lengths = list(eng.lengths())
            states = [g.get_state() for g in eng._generators]
            cache = [k.clone() for k in eng.cache.ks]
            eng.predicted_footprints(refresh=True)
            assert list(eng.lengths()) == lengths
            assert all(torch.equal(a, g.get_state())
                       for a, g in zip(states, eng._generators))
            assert all(torch.equal(a, k) for a, k in zip(cache, eng.cache.ks))
        sched.run()
        return [r.tokens for r in reqs]

    assert serve(True) == serve(False)
