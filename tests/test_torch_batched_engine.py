"""The port's continuous-batching engine against the JAX one, on the tiny
stack with the same weights (fp32, fp32 KV cache): greedy ids must be
identical in every scenario of ``tests/test_batched_engine.py`` (the JAX
engine's own tests hold it to the JAX ``MLLMGenerator``), with int8 and
int4 weights too; in bf16 the port's engine gives the port's
``MLLMGenerator``'s ids. Plus the prefix cache on its own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_npu_tpu.models.generation.generate import rebuild_llm
from mllm_npu_tpu.models.generation.sampler import \
    ImageTokenLadder as JLadder
from mllm_npu_tpu.serve.batched_engine import \
    ContinuousBatchingEngine as JEngine
from mllm_npu_tpu.utils.testing import (TinySpec as JSpec,
                                        build_tiny_mllm as j_build,
                                        synthetic_batch)
from mllm_npu_tpu.utils.weights import quantize_llama_params
from mllm_npu_tpu_torch.models.generation.generate import MLLMGenerator
from mllm_npu_tpu_torch.models.generation.sampler import (ImageTokenLadder,
                                                          SamplingConfig)
from mllm_npu_tpu_torch.serve.batched_engine import ContinuousBatchingEngine
from mllm_npu_tpu_torch.serve.prefix_cache import PrefixCache
from mllm_npu_tpu_torch.utils.fake_tokenizer import FakeTokenizer
from mllm_npu_tpu_torch.utils.testing import TinySpec, build_tiny_mllm
from mllm_npu_tpu_torch.utils.weights import (from_jax_params,
                                              quantize_llama_)


@pytest.fixture(scope="module")
def stack():
    """The JAX tiny assembly and its parameters, and the port's with the
    same weights (fp32)."""
    spec = JSpec(batch=1, seq=32, image_size=56, nq=4)
    jm, jl, _ = j_build(spec)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              **synthetic_batch(spec, cmp_images=1))
    tm, _, _ = build_tiny_mllm(TinySpec(), device="cpu")
    tm.load_state_dict(from_jax_params(params["params"]), strict=True)
    return jm, jl, params, tm


def _ladder(cls):
    tok = FakeTokenizer()
    return cls(ids=tuple([tok.special["<img>"]]
                         + [tok.special[f"<img_{i:05d}>"] for i in range(4)]
                         + [tok.special["</img>"]]))


def _run(engine, prompts, T, stagger=0):
    """Submit ``prompts`` (a request after ``stagger`` ticks each when
    given) and drain; → the requests."""
    reqs = []
    for p in prompts:
        reqs.append(engine.submit(p, max_new_tokens=T))
        for _ in range(stagger):
            engine.step()
    engine.run_until_idle()
    return reqs


def _both(stack, prompts, T, stagger=0, **kw):
    """The same requests through the JAX engine and the port's, built with
    the same ``kw``; asserts every request is done without error and
    returns (JAX ids, port ids)."""
    jm, jl, params, tm = stack
    jkw = dict(kw)
    if "ladder" in jkw:
        jkw["ladder"] = _ladder(JLadder)
        kw["ladder"] = _ladder(ImageTokenLadder)
    je = JEngine(jm, jl, params, eos_token_id=-1, cache_dtype=jnp.float32,
                 **jkw)
    te = ContinuousBatchingEngine(tm, eos_token_id=-1,
                                  cache_dtype=torch.float32, **kw)
    out = []
    for eng in (je, te):
        reqs = _run(eng, prompts, T, stagger)
        assert all(r.done and r.error is None for r in reqs)
        out.append([list(map(int, r.tokens)) for r in reqs])
    return out


def test_matches_reference_engine(stack):
    prompts = [[3, 17, 42, 9, 100, 7], [5, 1, 88, 200, 14, 3, 77, 21, 9],
               [250, 4, 4, 4]]
    ref, got = _both(stack, prompts, 8, num_slots=4, max_len=64,
                     block_steps=3, prompt_bucket=8, max_prompt=16)
    assert got == ref
    assert all(len(t) == 8 for t in got)


def test_slot_recycling_more_requests_than_slots(stack):
    rs = np.random.RandomState(0)
    prompts = [list(rs.randint(3, 250, rs.randint(3, 12))) for _ in range(5)]
    ref, got = _both(stack, prompts, 6, num_slots=2, max_len=32,
                     block_steps=4, prompt_bucket=16)
    assert got == ref


def test_staggered_submission(stack):
    ref, got = _both(stack, [[3, 17, 42, 9], [5, 1, 88, 200, 14, 3]], 10,
                     stagger=2, num_slots=2, max_len=32, block_steps=2,
                     prompt_bucket=8)
    assert got == ref


def test_capacity_validation(stack):
    tm = stack[3]
    eng = ContinuousBatchingEngine(
        tm, num_slots=2, max_len=32, block_steps=2, prompt_bucket=8,
        max_prompt=16, eos_token_id=-1, cache_dtype=torch.float32)
    assert eng.capacity_for(5) == 22          # bucket 8 + block 2
    assert eng.capacity_for(9) == 14          # bucket 16 + block 2
    assert eng.capacity_for(17) == 0          # over max_prompt
    with pytest.raises(ValueError, match="max_prompt"):
        eng.submit(list(range(3, 20)), max_new_tokens=4)
    with pytest.raises(ValueError, match="cannot fit"):
        eng.submit([3, 4, 5], max_new_tokens=30)
    ref, got = _both(stack, [[3, 17, 42]], 6, num_slots=2, max_len=32,
                     block_steps=2, prompt_bucket=8, max_prompt=16)
    assert got == ref


def test_malformed_request_is_isolated(stack):
    jm, jl, params, tm = stack
    good = [3, 17, 42, 9]
    bad_kw = dict(embeds_cmp_mask=np.ones((1,), bool),
                  ids_cmp_mask=np.asarray([True, False]),
                  patch_positions=np.zeros((1, 2), np.float32))
    got = []
    for eng, images in (
            (JEngine(jm, jl, params, num_slots=2, max_len=64, block_steps=3,
                     prompt_bucket=8, eos_token_id=-1,
                     cache_dtype=jnp.float32), jnp.zeros((1, 7, 13, 2))),
            (ContinuousBatchingEngine(tm, num_slots=2, max_len=64,
                                      block_steps=3, prompt_bucket=8,
                                      eos_token_id=-1,
                                      cache_dtype=torch.float32),
             np.zeros((1, 7, 13, 2), np.float32))):
        r_bad = eng.submit([5, 1], max_new_tokens=6, images=images, **bad_kw)
        r_good = eng.submit(good, max_new_tokens=6)
        eng.run_until_idle()
        assert r_bad.done and r_bad.error is not None and r_bad.tokens == []
        assert r_good.done and r_good.error is None
        got.append(list(map(int, r_good.tokens)))
    assert got[1] == got[0]


def test_chunked_prefill_parity(stack):
    p_long = list(np.random.RandomState(3).randint(3, 250, 19))
    ref, got = _both(stack, [[3, 17, 42], p_long], 6, stagger=1, num_slots=2,
                     max_len=64, block_steps=2, prompt_bucket=8,
                     max_prompt=32, prefill_chunk=8)
    assert got == ref


def test_chunked_prefill_subchunk_short_prompt_parity(stack):
    """prefill_chunk < prompt_bucket: a short prompt's last real token lands
    in a chunk before the last (which is all padding)."""
    cases = [[3, 17, 42], [5, 1, 88, 200], [5, 1, 88, 200, 14],
             list(np.random.RandomState(7).randint(3, 250, 11))]
    ref, got = _both(stack, cases, 6, num_slots=4, max_len=64, block_steps=2,
                     prompt_bucket=8, max_prompt=16, prefill_chunk=4)
    assert got == ref


def test_chunked_prefill_capped_bucket_parity(stack):
    p = list(np.random.RandomState(11).randint(3, 250, 13))
    tm = stack[3]
    assert ContinuousBatchingEngine(tm, max_len=64, prompt_bucket=8,
                                    max_prompt=20,
                                    cache_dtype=torch.float32
                                    ).max_prompt == 16
    ref, got = _both(stack, [p], 6, num_slots=2, max_len=64, block_steps=2,
                     prompt_bucket=8, max_prompt=20, prefill_chunk=8)
    assert got == ref


@pytest.mark.parametrize("chunk", [None, 8])
def test_image_ladder_forcing(stack, chunk):
    """A prompt ending in <img> force-decodes the whole ladder; ladder
    tokens are suppressed elsewhere."""
    ladder = _ladder(ImageTokenLadder).ids
    prompt = ([3, 17, ladder[0]] if chunk is None
              else [5, 9, 44, 7, 3, 17, 250, 8, 99, ladder[0]])
    ref, got = _both(stack, [prompt], 6, num_slots=2, max_len=64,
                     block_steps=2, prompt_bucket=8, max_prompt=16,
                     prefill_chunk=chunk, ladder=True)
    assert got == ref
    assert got[0][:5] == list(ladder[1:])


def test_chunked_admission_fuzz_parity(stack):
    """Random (prompt_bucket, prefill_chunk, max_prompt, block_steps,
    prompt lengths), the space that held the reference's chunk and bucket
    bugs."""
    rs = np.random.RandomState(42)
    vocab = stack[1].vocab_size
    for trial in range(6):
        bucket = int(rs.choice([4, 8, 16]))
        chunk = int(rs.choice([max(bucket // 2, 2), bucket, bucket * 2]))
        max_prompt = int(rs.choice([17, 24, 32]))
        steps = int(rs.choice([2, 3]))
        cap = (max_prompt // bucket) * bucket
        prompts = [list(rs.randint(3, vocab, int(rs.randint(2, cap + 1))))
                   for _ in range(4)]
        ref, got = _both(stack, prompts, 5, num_slots=3, max_len=64,
                         block_steps=steps, prompt_bucket=bucket,
                         max_prompt=max_prompt, prefill_chunk=chunk)
        assert got == ref, (trial, bucket, chunk, max_prompt)


@pytest.mark.parametrize("chunk", [None, 8])
def test_prefix_cache_token_parity(stack, chunk):
    """Prompts that share a cached prefix (and one exact resubmission) give
    the reference's ids, and the store reports its hits."""
    sys_prompt = [7, 3, 99, 12, 45, 6, 81, 2, 33, 9]
    prompts = [sys_prompt + [100, 101, 5], sys_prompt + [200, 14, 77, 21],
               sys_prompt + [100, 101, 5]]
    jm, jl, params, tm = stack
    got, engines = [], []
    for eng in (JEngine(jm, jl, params, num_slots=2, max_len=48,
                        block_steps=3, prompt_bucket=8, eos_token_id=-1,
                        cache_dtype=jnp.float32, prefill_chunk=chunk,
                        prefix_cache=4),
                ContinuousBatchingEngine(tm, num_slots=2, max_len=48,
                                         block_steps=3, prompt_bucket=8,
                                         eos_token_id=-1,
                                         cache_dtype=torch.float32,
                                         prefill_chunk=chunk,
                                         prefix_cache=4)):
        toks = []
        for p in prompts:                    # one at a time: real hits
            toks.append(list(map(int, _run(eng, [p], 6)[0].tokens)))
        got.append(toks)
        engines.append(eng)
    assert got[1] == got[0]
    st = engines[1].stats()["prefix_cache"]
    assert st == engines[0].stats()["prefix_cache"]
    assert st["hits"] >= 2 and st["tokens_saved"] >= 16, st


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_engine_matches_reference(stack, bits):
    jm, jl, params, _ = stack
    jm_q, jl_q, params_q = rebuild_llm(
        jm, jl, params,
        lambda p: quantize_llama_params(p, bits=bits,
                                        group_size=jl.quant_group_size),
        quantization=f"int{bits}")
    tm, _, _ = build_tiny_mllm(TinySpec(), device="cpu")
    tm.load_state_dict(from_jax_params(params["params"]), strict=True)
    quantize_llama_(tm.language_model, bits=bits,
                    group_size=jl.quant_group_size)
    prompts = [[3, 17, 42, 9, 100, 7], [5, 1, 88, 200, 14, 3, 77, 21, 9]]
    kw = dict(num_slots=2, max_len=64, block_steps=3, prompt_bucket=8,
              eos_token_id=-1)
    je = JEngine(jm_q, jl_q, params_q, cache_dtype=jnp.float32, **kw)
    te = ContinuousBatchingEngine(tm, cache_dtype=torch.float32, **kw)
    got = [[list(map(int, r.tokens)) for r in _run(e, prompts, 6)]
           for e in (je, te)]
    assert got[1] == got[0]


def test_bf16_engine_matches_port_generator():
    """The serving setting: the generator casts the model to bf16 and
    decodes one request at a time; the batched engine over the same model
    with a bf16 cache gives the same ids, with and without chunks."""
    tm, _, _ = build_tiny_mllm(TinySpec(), device="cpu", seed=3)
    T = 8
    gen = MLLMGenerator(tm, sampling=SamplingConfig(max_new_tokens=T),
                        ladder=_ladder(ImageTokenLadder))
    prompts = [[3, 17, 42, 9, 100, 7], [5, 1, 88, 200, 14, 3, 77, 21, 9],
               [250, 4, 4, 4, 10]]
    want = [gen.generate(torch.tensor([p]))["generate_ids"][0].tolist()
            for p in prompts]
    for chunk in (None, 4):
        eng = ContinuousBatchingEngine(
            tm, num_slots=2, max_len=64, block_steps=3, prompt_bucket=8,
            ladder=gen.ladder, prefill_chunk=chunk)
        got = [list(map(int, r.tokens)) for r in _run(eng, prompts, T)]
        assert got == want, chunk


# ---------------------------------------------------------------------------
# the prefix cache alone
# ---------------------------------------------------------------------------

def test_prefix_cache_unit_longest_aligned_match():
    pc = PrefixCache(max_entries=4, granularity=4)
    k = torch.zeros((2, 1, 8, 1, 4))
    v = torch.ones((2, 1, 8, 1, 4))
    toks = np.arange(8, dtype=np.int32)
    pc.insert(toks, k, v)
    assert len(pc) == 1
    e = pc.lookup(toks)                      # capped at Sp - 1 → 4
    assert e is not None and len(e.tokens) == 4 and e.k.shape[2] == 4
    longer = np.concatenate([toks, toks])
    e = pc.lookup(longer)
    assert e is not None and len(e.tokens) == 8
    assert torch.equal(e.v, v)
    div = toks.copy()
    div[5] = 99
    e = pc.lookup(np.concatenate([div, div]))
    assert e is not None and len(e.tokens) == 4
    div2 = toks.copy()
    div2[2] = 99
    assert pc.lookup(np.concatenate([div2, div2])) is None
    e = pc.lookup(longer, align=8)
    assert e is not None and len(e.tokens) == 8
    assert pc.lookup(toks, align=8) is None
    assert pc.stats() == {"entries": 1, "hits": 4, "misses": 2,
                          "tokens_saved": 24}


def test_prefix_cache_lru_eviction():
    pc = PrefixCache(max_entries=2, granularity=2)
    k = torch.zeros((1, 1, 4, 1, 2))
    a, b, c = (np.asarray(x, np.int32) for x in
               ([1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]))
    pc.insert(a, k, k)
    pc.insert(b, k, k)
    pc.lookup(np.concatenate([a, a]))        # refresh a
    pc.insert(c, k, k)                       # evicts b
    assert pc.lookup(np.concatenate([b, b])) is None
    assert pc.lookup(np.concatenate([a, a])) is not None
    assert pc.lookup(np.concatenate([c, c])) is not None


def test_prefix_cache_entry_owns_its_memory():
    """An entry is a copy: changing the prefill cache it came from later
    (the chunked prefill writes into it in place) leaves it alone."""
    pc = PrefixCache(max_entries=1, granularity=2)
    k = torch.zeros((1, 1, 4, 1, 2))
    pc.insert(np.arange(4, dtype=np.int32), k, k)
    k.fill_(7.0)
    e = pc.lookup(np.arange(8, dtype=np.int32))
    assert e is not None and float(e.k.abs().max()) == 0.0
