"""The port's serving tier against the JAX package's, on the CPU, fp32.

Greedy decoding is the cross-framework contract: on the same carried-over
weights the port's token streams are byte-identical to the JAX engine's —
one-shot prefill (at a bucket where JAX reaches its Pallas cached kernel,
and at a short dense bucket), chunked prefill, decode past capacity, and
the continuous-batching scheduler with chunked prefill and speculative
decoding. Sampling is held to seeded replay within the port (a
``torch.Generator`` cannot reproduce JAX's threefry keys).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import interpret_mode
from paddle_tpu.serving import GenerationEngine as JEngine
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import Scheduler as JScheduler

from paddle_tpu_torch.serving import (
    FINISH_REASONS,
    GenerationEngine,
    Request,
    Scheduler,
)
from tests.torch_port_util import both_flags, gpt_pair, no_persistent_compile_cache  # noqa: F401


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(0, 97, n).tolist()


@pytest.mark.parametrize("route,min_kv,n", [
    ("kernel", 128, 100),   # bucket 128: JAX prefill runs its K4 Pallas kernel
    ("dense", 1024, 20),    # bucket 32, every call below min_kv: dense
])
def test_greedy_generate_matches_jax(route, min_kv, n,
                                     no_persistent_compile_cache):
    jm, tm = gpt_pair()
    prompt = _prompt(n, seed=n)
    with both_flags(blockwise_attention_min_kv=min_kv), interpret_mode():
        want = JEngine(jm, max_batch=2, max_len=256).generate(
            prompt, max_new_tokens=24)
        got = GenerationEngine(tm, max_batch=2, max_len=256,
                               device="cpu").generate(prompt,
                                                      max_new_tokens=24)
    assert got == want


def test_chunked_prefill_matches_jax_and_one_shot(
        no_persistent_compile_cache):
    """Chunk 128 of a 200-token prompt over a 256-row cache (JAX: K4 for
    both chunks at min_kv 128), then decode — equal to the JAX engine and
    to the port's own one-shot prefill."""
    jm, tm = gpt_pair()
    prompt = _prompt(200, seed=1)

    def run(eng):
        assert eng.chunked_prefill_fits(len(prompt))
        assert eng.prefill_chunk_step(0, prompt, 0) is None
        out = [eng.prefill_chunk_step(0, prompt, 128)]
        for _ in range(8):
            feed = np.zeros((eng.max_batch,), np.int32)
            feed[0] = out[-1]
            out.append(int(eng.decode_once(feed)[0]))
        return out, list(np.asarray(eng.lengths()))

    with both_flags(blockwise_attention_min_kv=128), interpret_mode():
        want = run(JEngine(jm, max_batch=2, max_len=256, prefill_chunk=128))
        got = run(GenerationEngine(tm, max_batch=2, max_len=256,
                                   prefill_chunk=128, device="cpu"))
        one_shot = GenerationEngine(tm, max_batch=2, max_len=256,
                                    device="cpu").generate(prompt, 9)
    assert got == want
    assert got[0] == one_shot


def test_decode_past_capacity_clamps_like_jax(no_persistent_compile_cache):
    """Decode keeps writing at ``max_len - 1`` once a slot is full (JAX's
    clamp; torch indexing does not clamp, the engine does)."""
    jm, tm = gpt_pair()
    prompt = _prompt(20, seed=2)
    want = JEngine(jm, max_batch=1, max_len=32).generate(prompt, 20)
    eng = GenerationEngine(tm, max_batch=1, max_len=32, device="cpu")
    assert eng.generate(prompt, 20) == want
    assert eng.lengths()[0] > 32  # lengths run on, positions are clamped


def test_chunk_gates_match_jax():
    jm, tm = gpt_pair(layers=1)
    j = JEngine(jm, max_batch=1, max_len=256, prefill_chunk=96)
    p = GenerationEngine(tm, max_batch=1, max_len=256, prefill_chunk=96,
                         device="cpu")
    for n in (1, 95, 96, 97, 192, 193, 255):
        assert p.chunked_prefill_fits(n) == j.chunked_prefill_fits(n), n
    with pytest.raises(ValueError, match="overruns max_len"):
        p.prefill_chunk_step(0, _prompt(250, 0), 192)


def _requests(cls, specs):
    return [cls(prompt=_prompt(n, seed=i), max_new_tokens=m)
            for i, (n, m) in enumerate(specs)]


# prompt lengths / budgets: two prompts span several 64-token chunks
_SPECS = [(10, 12), (150, 10), (40, 14), (90, 12)]


def test_scheduler_streams_match_jax(no_persistent_compile_cache):
    jm, tm = gpt_pair()
    kw = dict(max_batch=2, max_len=256, prefill_chunk=64, spec_k=4)
    js = JScheduler(JEngine(jm, **kw))
    ps = Scheduler(GenerationEngine(tm, device="cpu", **kw))
    jr = [js.submit(r) for r in _requests(JRequest, _SPECS)]
    pr = [ps.submit(r) for r in _requests(Request, _SPECS)]
    js.run()
    ps.run()
    assert [r.tokens for r in pr] == [r.tokens for r in jr]
    assert [r.finish_reason for r in pr] == [r.finish_reason for r in jr]
    assert all(r.finish_reason in FINISH_REASONS for r in pr)
    assert len(ps.finished) == len(pr)
    assert len({id(r) for r in ps.finished}) == len(pr)  # once each
    assert [e[1] for e in ps.events] == [e[1] for e in js.events]


def test_speculative_is_byte_identical_to_plain_greedy():
    _, tm = gpt_pair()
    # repetitive prompts so the n-gram proposer has drafts to offer
    specs = [[3, 1, 4, 1, 5] * 6, [7, 7, 2] * 9, [9, 8, 7, 6] * 5]

    def run(spec_k, speculative):
        eng = GenerationEngine(tm, max_batch=2, max_len=128, spec_k=spec_k,
                               device="cpu")
        s = Scheduler(eng, speculative=speculative)
        reqs = [s.submit(Request(prompt=p, max_new_tokens=20))
                for p in specs]
        s.run()
        return [r.tokens for r in reqs], s

    plain, _ = run(0, False)
    spec, sched = run(4, None)
    assert sched.speculative and sched._spec_proposed > 0
    assert spec == plain


def test_sampled_replay_is_deterministic_in_the_port():
    _, tm = gpt_pair(layers=1)

    def run(seed):
        eng = GenerationEngine(tm, max_batch=2, max_len=64, device="cpu")
        s = Scheduler(eng)
        sampled = s.submit(Request(prompt=_prompt(8, 0), max_new_tokens=16,
                                   temperature=0.9, top_k=20, top_p=0.95,
                                   seed=seed))
        greedy = s.submit(Request(prompt=_prompt(6, 1), max_new_tokens=16))
        s.run()
        return sampled.tokens, greedy.tokens

    a, ga = run(5)
    b, gb = run(5)
    c, gc = run(6)
    assert a == b and a != c
    alone = GenerationEngine(tm, max_batch=2, max_len=64,
                             device="cpu").generate(_prompt(6, 1), 16)
    assert ga == gb == gc == alone  # the greedy neighbour is unperturbed


def test_engine_without_cpu_request_raises_when_there_is_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    _, tm = gpt_pair(layers=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GenerationEngine(tm)


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    # every module of the port, walked with pkgutil, and the port's tools
    tools = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "torch_tools")
    code = ("import importlib, pkgutil, sys, paddle_tpu_torch as pt; "
            "mods = [importlib.import_module(m.name) for m in "
            "pkgutil.walk_packages(pt.__path__, 'paddle_tpu_torch.')]; "
            "assert len(mods) > 55, len(mods); "
            "names = {m.__name__ for m in mods}; "
            "new = {'paddle_tpu_torch.models.bert', "
            "'paddle_tpu_torch.models.ernie', "
            "'paddle_tpu_torch.nn.layer.transformer', "
            "'paddle_tpu_torch.nn.layer.common', "
            "'paddle_tpu_torch.nn.functional.loss', "
            "'paddle_tpu_torch.vision.models.resnet', "
            "'paddle_tpu_torch.vision.models.lenet', "
            "'paddle_tpu_torch.nn.functional.conv', "
            "'paddle_tpu_torch.nn.functional.pooling', "
            "'paddle_tpu_torch.nn.layer.conv', "
            "'paddle_tpu_torch.nn.layer.pooling', "
            "'paddle_tpu_torch.incubate.autotune', "
            "'paddle_tpu_torch.framework.layout_autotune', "
            "'paddle_tpu_torch.profiler.profiler', "
            "'paddle_tpu_torch.profiler.devprof', "
            "'paddle_tpu_torch.ops.cuda.cost'}; "
            "assert new <= names, new - names; "
            "from paddle_tpu_torch.serving import EncoderScorer; "
            "import paddle_tpu_torch.profiler; "
            f"sys.path.insert(0, {tools!r}); "
            "import torch_chaos_serve, torch_bench_serve; "
            "torch_chaos_serve.smoke_model(); "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.')); print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
