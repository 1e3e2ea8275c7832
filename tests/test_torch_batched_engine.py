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
                        ladder=_ladder(ImageTokenLadder),
                        cast_params_bf16=True)
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


# ---------------------------------------------------------------------------
# sampling, speculation, the fp8 cache (the reference's slow tests, mirrored)
# ---------------------------------------------------------------------------

PROMPTS_SPEC = [[7, 8, 9, 7, 8, 9, 7, 8], [5, 1, 88, 200, 14, 3, 77, 21, 9],
                [4, 4, 4, 4, 4, 4]]


def test_speculative_engine_matches_reference_and_plain(stack):
    """speculative_k = 4: the port's ids equal the JAX speculative engine's
    and both engines' plain block decode."""
    spec_kw = dict(num_slots=4, max_len=64, prompt_bucket=8, max_prompt=16)
    ref, got = _both(stack, PROMPTS_SPEC, 10, speculative_k=4, **spec_kw)
    assert got == ref
    plain_ref, plain = _both(stack, PROMPTS_SPEC, 10, block_steps=3,
                             **spec_kw)
    assert got == plain == plain_ref


def _oracle_engine(stack, table=None, raw=None, **kw):
    """A port engine whose verify forward is an oracle: logits one-hot at
    ``table[token]`` (× 10), or the fixed row ``raw`` for every position."""
    tm = stack[3]
    eng = ContinuousBatchingEngine(tm, eos_token_id=-1,
                                   cache_dtype=torch.float32, **kw)
    L, B, _, Hkv, D = eng.state["k"].shape
    V = tm.language_model.config.vocab_size

    def verify(toks, positions, write_pos):
        if table is not None:
            logits = torch.nn.functional.one_hot(table[toks], V).float() * 10
        else:
            logits = raw.expand(*toks.shape, V).clone()
        W = toks.shape[1]
        z = torch.zeros(L, B, W, Hkv, D)
        return logits, z, z
    eng._verify = verify
    return eng


@torch.inference_mode()
def _set(eng, **values):
    """Write engine state (inference tensors) in place."""
    for name, v in values.items():
        eng.state[name].copy_(torch.as_tensor(v))


def test_speculative_acceptance_mechanics(stack):
    """The reference's oracle check of one tick: a row whose history holds
    the oracle's chain accepts all k drafts (k + 1 tokens), a row with no
    repeated n-gram emits one, idle rows nothing; positions, budgets and
    histories move by what was emitted."""
    k, W = 4, 5
    table = torch.zeros(stack[1].vocab_size, dtype=torch.long)
    for a, b in [(8, 1), (1, 2), (2, 3), (3, 4), (4, 5)]:
        table[a] = b
    eng = _oracle_engine(stack, table=table, num_slots=4, max_len=64,
                         prompt_bucket=16, speculative_k=k)
    rep = [5, 6, 9, 7, 8, 1, 2, 3, 4, 9, 7, 8]
    rnd = [3, 17, 42, 100, 5, 60, 11, 2]
    hist = eng.state["hist"].clone()
    hist[0, :len(rep)] = torch.tensor(rep)
    hist[1, :len(rnd)] = torch.tensor(rnd)
    _set(eng, hist=hist, hist_len=[len(rep), len(rnd), 0, 0],
         cur_tok=[8, 2, 0, 0],
         active=[True, True, False, False], write_pos=[12, 8, 0, 0],
         rope_pos=[12, 8, 0, 0], n_gen=[1, 1, 0, 0], max_gen=[32, 32, 0, 0])
    with torch.inference_mode():
        eng._spec_tick()
    toks, mask = eng._toks, eng._emitted
    assert mask[0].sum() == W and toks[0].tolist() == [1, 2, 3, 4, 5]
    assert mask[1].sum() == 1
    assert mask[2].sum() == 0 and mask[3].sum() == 0
    st = eng.state
    assert st["write_pos"].tolist() == [12 + W, 9, 0, 0]
    assert st["hist_len"].tolist() == [12 + W, 9, 0, 0]
    assert st["n_gen"].tolist() == [1 + W, 2, 0, 0]
    assert st["hist"][0, 12:12 + W].tolist() == [1, 2, 3, 4, 5]
    assert st["key_valid"][0, 12:12 + W].all()
    assert not st["key_valid"][1, 9:].any()


def test_speculative_ladder_mechanics(stack):
    """The reference's ladder oracle: mid-ladder a greedy and a sampled row
    both emit k + 1 forced tokens in one tick; at the ladder's end a greedy
    row emits the forced tokens and the argmax, a sampled one the forced
    tokens and a token drawn from the post-``</img>`` logits (which varies
    with the seed and is never a ladder token)."""
    k, W, B = 4, 5, 4
    V = stack[1].vocab_size
    lad = tuple(range(20, 31))
    raw = (torch.arange(V, dtype=torch.float32) % 7) * 0.05
    raw[20:31] = -5.0
    eng = _oracle_engine(stack, raw=raw, num_slots=B, max_len=64,
                         prompt_bucket=16, speculative_k=k,
                         enable_sampling=True,
                         ladder=ImageTokenLadder(ids=lad))

    def tick(seed):
        _set(eng, cur_tok=[20, 20, 28, 28], active=[True] * B,
             do_sample=[False, True, True, False],
             temp=[1.0, 1.0, 4.0, 1.0], top_p=[1.0] * B,
             seed=[seed * 10 + i for i in range(B)], write_pos=[8] * B,
             rope_pos=[8] * B, n_gen=[1] * B, max_gen=[32] * B,
             hist_len=[0] * B)
        with torch.inference_mode():
            eng._spec_tick()
        return eng._toks.clone(), eng._emitted.clone()

    toks, mask = tick(0)
    for r in (0, 1):
        assert mask[r].sum() == W and toks[r].tolist() == [21, 22, 23, 24,
                                                           25]
    g_corr = int(torch.argmax(raw))
    assert mask[3].sum() == 3 and toks[3, :3].tolist() == [29, 30, g_corr]
    assert mask[2].sum() == 3 and toks[2, :2].tolist() == [29, 30]
    corr = {int(tick(s)[0][2, 2]) for s in range(6)}
    assert len(corr) >= 2 and all(c < 20 or c > 30 for c in corr)


def _engine_pair(stack, cache=("float32", "float32"), **kw):
    """The JAX engine and the port's with the same ``kw`` and the caches
    ``cache`` (jnp and torch dtype names)."""
    jm, jl, params, tm = stack
    jkw = dict(kw)
    if jkw.pop("ladder", None):
        jkw["ladder"] = _ladder(JLadder)
        kw["ladder"] = _ladder(ImageTokenLadder)
    je = JEngine(jm, jl, params, eos_token_id=-1,
                 cache_dtype=getattr(jnp, cache[0]), **jkw)
    te = ContinuousBatchingEngine(tm, eos_token_id=-1,
                                  cache_dtype=getattr(torch, cache[1]), **kw)
    return je, te


def test_per_request_sampling_mixed_with_greedy(stack):
    """enable_sampling: a greedy row among sampled ones keeps the
    reference's ids; a sampled row's ids are a function of its seed
    (the same alone as among others, and in another slot); a near-zero
    temperature collapses onto greedy; do_sample on a greedy engine
    raises."""
    jm, jl, params, tm = stack
    T = 8
    kw = dict(num_slots=4, max_len=64, block_steps=3, prompt_bucket=8)
    (ref,), _ = _both(stack, [[3, 17, 42, 9]], T, **kw)
    cold_ref = _both(stack, [[250, 4, 4]], T, **kw)[0][0]
    eng = ContinuousBatchingEngine(tm, eos_token_id=-1,
                                   cache_dtype=torch.float32,
                                   enable_sampling=True, **kw)
    r_g = eng.submit([3, 17, 42, 9], max_new_tokens=T)
    r_s = eng.submit([5, 1, 88], max_new_tokens=T, do_sample=True,
                     temperature=0.9, top_p=0.9, seed=7)
    r_c = eng.submit([250, 4, 4], max_new_tokens=T, do_sample=True,
                     temperature=1e-4, top_p=1.0, seed=3)
    eng.run_until_idle()
    assert r_g.tokens == ref and r_c.tokens == cold_ref
    assert len(r_s.tokens) == T
    # alone, in slot 0 instead of slot 1: the same draws
    alone = eng.submit([5, 1, 88], max_new_tokens=T, do_sample=True,
                       temperature=0.9, top_p=0.9, seed=7)
    eng.run_until_idle()
    assert alone.tokens == r_s.tokens
    other = eng.submit([5, 1, 88], max_new_tokens=T, do_sample=True,
                       temperature=0.9, top_p=0.9, seed=8)
    eng.run_until_idle()
    assert other.tokens != r_s.tokens
    with pytest.raises(ValueError, match="enable_sampling"):
        ContinuousBatchingEngine(tm, **kw).submit([3, 4], do_sample=True)


def test_speculative_mixed_sampled_and_greedy_slots(stack):
    """Under speculation a sampled row rides the same verify forward but
    emits exactly one token a tick (no ladder here), drawn as the plain
    sampled engine draws it; the greedy row keeps the reference's ids."""
    jm, jl, params, tm = stack
    T = 8
    kw = dict(num_slots=4, max_len=64, prompt_bucket=8, max_prompt=16)
    ref = _both(stack, [[3, 17, 42, 9, 100, 7]], T, block_steps=3,
                **kw)[0][0]
    eng = ContinuousBatchingEngine(tm, eos_token_id=-1,
                                   cache_dtype=torch.float32,
                                   speculative_k=4, enable_sampling=True,
                                   **kw)
    r_g = eng.submit([3, 17, 42, 9, 100, 7], max_new_tokens=T)
    r_s = eng.submit([5, 1, 88, 200], max_new_tokens=T, do_sample=True,
                     temperature=0.8, top_p=0.9, seed=7)
    deltas, last = [], len(r_s.tokens)
    while eng.step():
        if len(r_s.tokens) != last:
            deltas.append(len(r_s.tokens) - last)
            last = len(r_s.tokens)
    assert r_g.tokens == ref
    assert len(r_s.tokens) == T and set(deltas) == {1}
    plain = ContinuousBatchingEngine(tm, eos_token_id=-1,
                                     cache_dtype=torch.float32,
                                     block_steps=3, enable_sampling=True,
                                     **kw)
    r_p = plain.submit([5, 1, 88, 200], max_new_tokens=T, do_sample=True,
                       temperature=0.8, top_p=0.9, seed=7)
    plain.run_until_idle()
    assert r_p.tokens == r_s.tokens


def test_fp8_cache_engine_matches_reference(stack):
    """An fp8 (e4m3) static cache: the port's ids equal the JAX fp8
    engine's (both store e4m3 and attend in bf16 with fp32 sums), and the
    first token the f32 engine's (the prefill never reads the cache)."""
    prompt = [3, 17, 42, 9, 100, 7]
    T = 24
    je, te = _engine_pair(stack, ("float8_e4m3fn", "float8_e4m3fn"),
                          num_slots=2, max_len=64, block_steps=2,
                          prompt_bucket=8)
    assert te.state["k"].dtype == torch.float8_e4m3fn
    got = [list(map(int, _run(e, [prompt], T)[0].tokens)) for e in (je, te)]
    assert got[1] == got[0]
    f32 = _both(stack, [prompt], T, num_slots=2, max_len=64, block_steps=2,
                prompt_bucket=8)[1][0]
    assert got[1][0] == f32[0]


def test_fp8_kv_decode_attention_error_bound():
    """The reference's bound on the fp8 storage path: with an e4m3 cache
    the port's ``decode_attention`` computes in bf16, within 8% relative
    RMS of the fp32 result (fp8 q and probabilities would measure ~10.5%),
    and a bf16 cache within 1%."""
    from mllm_npu_tpu_torch.ops import decode_attention
    rs = np.random.RandomState(0)
    B, Hq, Hkv, D, Sk = 2, 8, 4, 64, 256
    q = torch.from_numpy(rs.randn(B, 1, Hq, D).astype(np.float32))
    k = torch.from_numpy(rs.randn(B, Sk, Hkv, D).astype(np.float32))
    v = torch.from_numpy(rs.randn(B, Sk, Hkv, D).astype(np.float32))
    mask = torch.ones(B, 1, 1, Sk, dtype=torch.bool)
    ref = decode_attention(q, k, v, mask)
    qb = q.bfloat16()
    denom = ref.pow(2).mean().sqrt()
    for dt, bound in ((torch.float8_e4m3fn, 0.08), (torch.bfloat16, 0.01)):
        o = decode_attention(qb, k.to(dt), v.to(dt), mask).float()
        assert float((o - ref).pow(2).mean().sqrt() / denom) < bound, dt


@pytest.mark.parametrize("cache", ["f32", "fp8"])
def test_speculative_ladder_parity_and_sampled_forcing(stack, cache):
    """Ladder + speculation: greedy ids equal the reference's speculative
    engine's (f32 and fp8 caches) and the plain ladder engine's; a sampled
    request whose prompt ends with ``<img>`` still emits the exact forced
    ladder."""
    n_img, T = 4, 7
    lad = _ladder(ImageTokenLadder)
    prompt = [3, 17, lad.ids[0]]
    name = {"f32": "float32", "fp8": "float8_e4m3fn"}[cache]
    je, te = _engine_pair(stack, (name, name), num_slots=2, max_len=64,
                          prompt_bucket=8, ladder=True, speculative_k=3)
    got = [list(map(int, _run(e, [prompt], T)[0].tokens)) for e in (je, te)]
    assert got[1] == got[0]
    assert got[1][:n_img + 1] == list(lad.ids[1:])
    if cache == "f32":
        plain = _both(stack, [prompt], T, num_slots=2, max_len=64,
                      block_steps=2, prompt_bucket=8, ladder=True)[1][0]
        assert got[1] == plain
    eng = ContinuousBatchingEngine(
        stack[3], num_slots=2, max_len=64, prompt_bucket=8, eos_token_id=-1,
        cache_dtype=getattr(torch, name), ladder=lad, speculative_k=3,
        enable_sampling=True)
    r1 = eng.submit(prompt, max_new_tokens=T)
    r2 = eng.submit(prompt, max_new_tokens=T, do_sample=True,
                    temperature=0.9, top_p=0.95, seed=3)
    eng.run_until_idle()
    assert r1.tokens == got[1]
    assert r2.tokens[:n_img + 1] == list(lad.ids[1:])


@pytest.mark.parametrize("chunk", [None, 8])
def test_speculative_with_prefix_cache_parity(stack, chunk):
    """A prompt admitted through a prefix-cache hit into a speculative
    engine (its history seeded from the whole prompt): the reference's
    ids, hits and tokens saved."""
    sys_prompt = [7, 3, 99, 12, 45, 6, 81, 2, 33, 9]
    prompts = [sys_prompt + [100, 101, 5], sys_prompt + [200, 14, 77, 21],
               sys_prompt + [100, 101, 5]]
    je, te = _engine_pair(stack, num_slots=2, max_len=64, block_steps=3,
                          prompt_bucket=8, prefill_chunk=chunk,
                          prefix_cache=4, speculative_k=4)
    got = [[list(map(int, _run(e, [p], 8)[0].tokens)) for p in prompts]
           for e in (je, te)]
    assert got[1] == got[0]
    st = te.stats()["prefix_cache"]
    assert st == je.stats()["prefix_cache"]
    assert st["hits"] >= 2 and st["tokens_saved"] >= 16


def test_speculative_full_ladder_burst_single_tick(stack):
    """k spanning the ladder: the whole forced chain and the token after it
    in one verify tick (the reference's seedx k = 63 burst, at tiny
    scale), with the plain ladder engine's ids."""
    tok = FakeTokenizer()
    n_img = 4
    lad = _ladder(ImageTokenLadder)
    k, T = n_img + 1, n_img + 4
    prompt = [3, 17, 42, lad.ids[0]]
    plain = _both(stack, [prompt], T, num_slots=1, max_len=64, block_steps=2,
                  prompt_bucket=8, ladder=True)
    eng = ContinuousBatchingEngine(stack[3], num_slots=1, max_len=64,
                                   prompt_bucket=8, eos_token_id=-1,
                                   cache_dtype=torch.float32, ladder=lad,
                                   speculative_k=k)
    assert tok.special["<img>"] == lad.ids[0]
    r = eng.submit(prompt, max_new_tokens=T)
    deltas, last = [], len(r.tokens)
    while eng.step():
        if len(r.tokens) != last:
            deltas.append(len(r.tokens) - last)
            last = len(r.tokens)
    assert r.tokens == plain[1][0] == plain[0][0]
    # the prefill's first token, then the rest of the chain and the token
    # after it from one tick
    assert deltas[0] == 1 and deltas[1] >= n_img + 1, deltas


def test_speculative_capacity_headroom(stack):
    """A verify window needs k + 1 columns of headroom past the budget."""
    eng = ContinuousBatchingEngine(stack[3], num_slots=2, max_len=32,
                                   block_steps=2, prompt_bucket=8,
                                   speculative_k=5,
                                   cache_dtype=torch.float32)
    assert eng.headroom == 6 and eng.capacity_for(5) == 32 - 8 - 6
    with pytest.raises(ValueError, match="cannot fit"):
        eng.submit([3, 4, 5], max_new_tokens=20)
