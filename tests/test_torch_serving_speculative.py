"""The port's serving speed tier on the CPU: twins of all 17 tests of
``tests/test_serving_speculative.py`` (speculative decoding, chunked
prefill and real sampling), on ``GenerationEngine(device="cpu")``.

Contracts under test:
  * speculative decoding NEVER changes output — 64+ tokens served with
    n-gram drafts + batched verify are byte-identical to plain greedy;
  * chunked prefill is invisible to the stream, and
    ``chunked_prefill_fits`` gates the overhang hazard;
  * sampling is real and deterministic within the port (per-slot seeded
    ``torch.Generator``s; a sampled neighbor never perturbs a greedy
    slot);
  * the dispatch contract: where the JAX package counts compiles (verify
    and chunk steps once each, decode at most once, prefill once per
    bucket, no recompile), the eager port records the distinct shapes each
    program was dispatched with (``GenerationEngine.dispatch_shapes``):
    one shape a program, one a bucket, and sampling state adds none (a
    declared difference, ``ROADMAP.md`` C);
  * ``NgramProposer`` prompt-lookup semantics.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.profiler import telemetry
from paddle_tpu_torch.serving import (
    DraftProposer,
    GenerationEngine,
    NgramProposer,
    Request,
    Scheduler,
)

MAX_LEN = 96
BUCKETS = (8, 16)


def _gpt(seed=0):
    model = GPTForCausalLM(GPTConfig(
        vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
        max_position_embeddings=128, hidden_dropout=0.0,
        attention_dropout=0.0), device="cpu",
        generator=torch.Generator().manual_seed(seed))
    model.eval()
    return model


@pytest.fixture(scope="module")
def model():
    return _gpt()


def _engine(model, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("prefill_buckets", BUCKETS)
    return GenerationEngine(model, device="cpu", **kw)


def _serve(eng, reqs, speculative=None):
    sched = Scheduler(eng, speculative=speculative,
                      retry_sleep=lambda s: None)
    for r in reqs:
        sched.submit(r)
    sched.run()
    return [tuple(r.tokens) for r in reqs]


def _reqs(prompts, max_new=64, **kw):
    return [Request(prompt=list(p), max_new_tokens=max_new, **kw)
            for p in prompts]


# ---------------------------------------------------------------------------
# NgramProposer units
# ---------------------------------------------------------------------------
def test_ngram_proposer_lookup_extrapolates_to_full_window():
    # trailing 3-gram [1,2,3] recurs at the front; the continuation is
    # extrapolated cyclically (period d=4) to fill the static window
    p = NgramProposer()
    assert p.propose([1, 2, 3, 4, 1, 2, 3], 4) == [4, 1, 2, 3]
    assert p.propose([1, 2, 3, 4, 1, 2, 3], 2) == [4, 1]


def test_ngram_proposer_prefers_longest_then_most_recent_match():
    # no 3-gram recurs; the trailing 1-gram `2` matches at i=1 and i=3 —
    # the MOST RECENT earlier occurrence (i=3) wins, continuation 9
    p = NgramProposer()
    assert p.propose([5, 2, 7, 2, 9, 2], 3)[0] == 9


def test_ngram_proposer_novel_text_and_degenerate_inputs():
    p = NgramProposer()
    assert p.propose([1, 2, 3, 4, 5], 4) == []  # no repeated n-gram
    assert p.propose([7], 4) == []              # too short to match
    assert p.propose([1, 2, 1], 0) == []        # no window to fill
    p.observe([1, 2, 1], 0)  # stateless hook: must simply not raise


def test_ngram_proposer_validates_ngram_bounds():
    with pytest.raises(ValueError):
        NgramProposer(max_ngram=1, min_ngram=2)
    with pytest.raises(ValueError):
        NgramProposer(min_ngram=0)


def test_draft_proposer_interface_is_abstract():
    with pytest.raises(NotImplementedError):
        DraftProposer().propose([1, 2], 4)


# ---------------------------------------------------------------------------
# speculative parity (the acceptance gate)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("prompt_len", [5, 16],
                         ids=["mid-bucket", "bucket-boundary"])
def test_spec_byte_identical_to_plain_greedy_64_tokens(model, prompt_len):
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, 97, prompt_len).tolist() for _ in range(4)]
    plain = _serve(_engine(model), _reqs(prompts))
    spec = _serve(_engine(model, spec_k=4), _reqs(prompts))
    assert spec == plain
    assert all(len(t) == 64 for t in spec)


def test_spec_with_chunked_prefill_matches_plain(model):
    rng = np.random.RandomState(12)
    # mixed lengths straddling the chunk width (4): 3 one-shot, rest
    # chunked — both admission paths feed the same speculative loop
    prompts = [rng.randint(0, 97, n).tolist() for n in (3, 6, 11, 16)]
    plain = _serve(_engine(model), _reqs(prompts, max_new=32))
    both = _serve(_engine(model, spec_k=4, prefill_chunk=4),
                  _reqs(prompts, max_new=32))
    assert both == plain


def test_scheduler_speculative_false_forces_plain_path(model):
    rng = np.random.RandomState(13)
    prompts = [rng.randint(0, 97, 7).tolist() for _ in range(2)]
    eng = _engine(model, spec_k=4)
    telemetry.reset()
    telemetry.enable()
    try:
        out = _serve(eng, _reqs(prompts, max_new=16), speculative=False)
        counters = telemetry.get_telemetry().counters()
    finally:
        telemetry.disable()
        telemetry.reset()
    assert not counters.get("serve.spec_ticks")
    assert out == _serve(_engine(model), _reqs(prompts, max_new=16))


def test_spec_compile_contract_everything_on(model):
    """JAX: verify and chunk compile once each, decode at most once,
    prefill once per bucket, no recompile. The port compiles nothing; its
    record of dispatched shapes holds the same contract."""
    rng = np.random.RandomState(14)
    prompts = [rng.randint(0, 97, n).tolist() for n in (5, 9, 13, 16)]
    telemetry.reset()
    telemetry.enable()
    try:
        eng = _engine(model, spec_k=4, prefill_chunk=4)
        _serve(eng, _reqs(prompts, max_new=48))
        counters = dict(telemetry.get_telemetry().counters())
    finally:
        telemetry.disable()
        telemetry.reset()
    assert counters.get("serve.spec_ticks", 0) > 0, \
        "speculation never engaged"
    assert counters.get("serve.prefill_chunks", 0) > 0, \
        "chunked prefill never engaged"
    shapes = eng.dispatch_shapes
    assert shapes["serve_verify"] == [(4, 5)]
    assert shapes["serve_prefill_chunk"] == [(1, 4)]
    assert len(shapes["serve_decode"]) <= 1  # fallback ticks only
    assert set(shapes["serve_decode"]) <= {(4, 1)}
    assert len(shapes["serve_prefill"]) <= len(BUCKETS)
    assert set(shapes["serve_prefill"]) <= {(1, b) for b in BUCKETS}


def test_spec_acceptance_telemetry_accounts(model):
    # a cyclic prompt is the n-gram proposer's best case: drafts must be
    # proposed, (mostly) accepted, and the counters must reconcile
    prompts = [[1, 2, 3] * 5 for _ in range(2)]
    eng = _engine(model, spec_k=4)
    telemetry.reset()
    telemetry.enable()
    try:
        _serve(eng, _reqs(prompts, max_new=24))
        tm = telemetry.get_telemetry()
        counters = dict(tm.counters())
        rate = tm.gauges().get("serve.spec_acceptance_rate")
    finally:
        telemetry.disable()
        telemetry.reset()
    proposed = counters.get("serve.spec_proposed", 0)
    accepted = counters.get("serve.spec_accepted", 0)
    assert proposed > 0
    assert 0 <= accepted <= proposed
    assert rate == pytest.approx(accepted / proposed)


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------
def test_chunked_prefill_fits_gates_the_clamp_hazard(model):
    eng = GenerationEngine(model, max_batch=2, max_len=10,
                           prefill_buckets=(8,), prefill_chunk=4,
                           device="cpu")
    assert eng.chunked_prefill_fits(7)        # rounds to 8 <= 10
    assert not eng.chunked_prefill_fits(9)    # rounds to 12 > 10: clamp
    assert not eng.chunked_prefill_fits(0)
    assert not _engine(model).chunked_prefill_fits(7)  # chunking off


def test_unchunkable_prompt_falls_back_to_one_shot_prefill(model):
    # 9 tokens round to 12 > max_len=10: the scheduler must take the
    # bucketed one-shot path and still finish the request normally
    eng = GenerationEngine(model, max_batch=2, max_len=10,
                           prefill_buckets=(4, 9), prefill_chunk=4,
                           device="cpu")
    req = Request(prompt=list(range(1, 10)), max_new_tokens=1)
    telemetry.reset()
    telemetry.enable()
    try:
        _serve(eng, [req])
        counters = telemetry.get_telemetry().counters()
    finally:
        telemetry.disable()
        telemetry.reset()
    assert req.finish_reason == "length"
    assert not counters.get("serve.prefill_chunks")


def test_chunk_step_rejects_misaligned_and_overhanging_offsets(model):
    eng = _engine(model, prefill_chunk=4)
    prompt = list(range(1, 12))
    with pytest.raises(ValueError):
        eng.prefill_chunk_step(0, prompt, 3)   # not a chunk multiple
    with pytest.raises(ValueError):
        eng.prefill_chunk_step(0, prompt, 12)  # outside the prompt


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------
def test_seeded_sampling_is_deterministic_and_seeds_diverge(model):
    prompts = [[5, 7, 11]] * 3
    streams = []
    for _ in range(2):
        eng = _engine(model, spec_k=4, prefill_chunk=4)
        reqs = [Request(prompt=list(prompts[i]), max_new_tokens=12,
                        temperature=0.8, top_k=10, top_p=0.9, seed=s)
                for i, s in enumerate((7, 7, 8))]
        streams.append(tuple(_serve(eng, reqs)))
    same_a, same_b, other = streams[0]
    assert streams[0] == streams[1]  # replay: byte-identical
    assert same_a == same_b          # same seed, same prompt: same draw
    assert same_a != other           # different seed diverges


def test_greedy_slot_unperturbed_by_sampled_neighbors(model):
    prompt = [5, 7, 11, 3]
    eng = _engine(model, spec_k=4)
    sampled = Request(prompt=list(prompt), max_new_tokens=12,
                      temperature=0.9, top_k=20, seed=21)
    greedy = Request(prompt=list(prompt), max_new_tokens=12)
    _serve(eng, [sampled, greedy])
    solo = Request(prompt=list(prompt), max_new_tokens=12)
    _serve(_engine(model), [solo])
    assert greedy.tokens == solo.tokens
    assert sampled.tokens != solo.tokens or True  # sampled may coincide


def test_sampling_state_is_data_not_shape(model):
    """Arming/clearing sampling adds no dispatch shape: the knobs are
    per-slot data beside the same ``[max_batch, 1]`` decode (JAX: no
    recompile)."""
    eng = _engine(model)
    eng.prefill(0, [1, 2, 3])
    eng.decode_once(np.zeros(4, np.int32))
    eng.set_slot_sampling(0, temperature=0.7, top_k=5, seed=3)
    eng.decode_once(np.zeros(4, np.int32))
    eng.clear_slot_sampling(0)
    eng.decode_once(np.zeros(4, np.int32))
    assert eng.dispatch_shapes["serve_decode"] == [(4, 1)]
    assert eng.dispatch_shapes["serve_prefill"] == [(1, 8)]
    assert not eng.slot_is_sampled(0)


def test_set_slot_sampling_validates(model):
    eng = _engine(model)
    with pytest.raises(ValueError):
        eng.set_slot_sampling(9, temperature=0.5)
    with pytest.raises(ValueError):
        eng.set_slot_sampling(0, temperature=-1.0)
    with pytest.raises(ValueError):
        eng.set_slot_sampling(0, temperature=0.5, top_p=0.0)
    with pytest.raises(ValueError):
        eng.set_slot_sampling(0, temperature=0.5, top_k=-2)
