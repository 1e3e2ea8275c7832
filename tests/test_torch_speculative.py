"""Prompt-lookup speculative decoding of the single-request generator
against the reference (CPU, fp32, fp32 cache): the port's
``speculative_decode_loop`` and ``ladder_propose`` against the JAX ones on
oracle models (the same tokens and verify forwards), and the tiny
generator with ``speculative_k`` against the JAX generator and the port's
plain greedy decode (ids identical), EOS included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_npu_tpu.models.generation import sampler as jsampler
from mllm_npu_tpu.models.generation.generate import MLLMGenerator as JGen
from mllm_npu_tpu.utils.testing import (TinySpec as JSpec,
                                        build_tiny_mllm as j_build,
                                        synthetic_batch)
from mllm_npu_tpu_torch.models.generation.generate import MLLMGenerator
from mllm_npu_tpu_torch.models.generation.sampler import (
    ImageTokenLadder, SamplingConfig, ladder_propose, speculative_decode_loop)
from mllm_npu_tpu_torch.utils.testing import TinySpec, build_tiny_mllm
from mllm_npu_tpu_torch.utils.weights import from_jax_params


def _oracle_both(next_of, V, real, Sp, k, T, first, ladder=None, eos=-1):
    """One oracle model (token → logits one-hot at ``next_of(token)``)
    through the JAX loop and the port's: → ((tokens, iters) JAX, port)."""
    ctx = np.asarray([real + [0] * (Sp - len(real))], np.int32)
    cfg_kw = dict(max_new_tokens=T, do_sample=False, eos_token_id=eos)

    def j_step(toks, cache):
        logits = jax.nn.one_hot(next_of(toks), V) * 10.0
        h = jnp.zeros(toks.shape + (4,), jnp.float32)
        return logits, h, {**cache, "pos": cache["pos"] + toks.shape[1]}

    def t_step(toks, cache):
        logits = torch.nn.functional.one_hot(
            torch.tensor(np.asarray(next_of(toks.numpy()))).long(),
            V).float() * 10.0
        h = torch.zeros(toks.shape + (4,))
        return logits, h, {**cache, "pos": cache["pos"] + toks.shape[1]}

    jl = None if ladder is None else jsampler.ImageTokenLadder(ids=ladder)
    tl = None if ladder is None else ImageTokenLadder(ids=ladder)
    jt, _, _, jn = jsampler.speculative_decode_loop(
        j_step, {"pos": jnp.asarray([len(real)], jnp.int32)},
        jnp.asarray([first], jnp.int32), jnp.zeros((1, 4), jnp.float32),
        jsampler.SamplingConfig(**cfg_kw), jnp.asarray(ctx), ladder=jl, k=k,
        ngram=2, prompt_len=jnp.asarray(len(real), jnp.int32))
    tt, _, _, tn = speculative_decode_loop(
        t_step, {"pos": len(real)}, torch.tensor([first]), torch.zeros(1, 4),
        SamplingConfig(**cfg_kw), torch.from_numpy(ctx), ladder=tl, k=k,
        ngram=2, prompt_len=len(real))
    return (np.asarray(jt[0]).tolist(), int(jn)), (tt[0].tolist(), tn)


def test_speculative_padded_prompt_still_accepts():
    """A period-3 prompt padded 8 → 16: the pad never enters an n-gram, so
    full k-runs are accepted: T = 12 at k = 4 in at most 4 verify
    forwards; the tokens and the forwards are the reference's."""
    cyc = lambda t: jnp.where(t == 7, 9, jnp.where(t == 9, 11, 7))
    ref, got = _oracle_both(cyc, 32, [7, 9, 11, 7, 9, 11, 7, 9], 16, 4, 12,
                            11)
    assert got == ref
    assert got[0] == [11, 7, 9, 11, 7, 9, 11, 7, 9, 11, 7, 9]
    assert got[1] <= (12 + 4) // 5 + 1


def test_speculative_ladder_advances_k_plus_1():
    """Inside the forced ladder the proposals are its chain, accepted by
    construction (the oracle never predicts a ladder token): 9 forced
    tokens and free text in at most 4 forwards at k = 4, as the
    reference."""
    ladder = tuple(range(20, 30))
    ref, got = _oracle_both(lambda t: jnp.full_like(t, 2), 32, [3, 17, 20], 8,
                            4, 12, 21, ladder=ladder)
    assert got == ref
    assert got[0] == [21, 22, 23, 24, 25, 26, 27, 28, 29, 2, 2, 2]
    assert got[1] <= 4


def test_speculative_loop_stops_at_eos_mid_window():
    cyc = lambda t: jnp.where(t == 7, 9, jnp.where(t == 9, 11, 7))
    ref, got = _oracle_both(cyc, 32, [7, 9, 11, 7, 9, 11, 7, 9], 8, 4, 12,
                            11, eos=9)
    assert got == ref
    assert got[0][:3] == [11, 7, 9] and got[0][3:] == [0] * 9


def test_ladder_propose_overrides_and_falls_back():
    """The reference's cases: mid-ladder the chain then the caller's
    proposals past ``</img>``; the whole chain from ``<img>``; ``</img>``
    and tokens outside the ladder leave the proposals alone. Batched rows
    give each its own answer, equal to JAX's."""
    ids = (5, 6, 7, 8, 9)
    props = torch.tensor([101, 102, 103, 104]).expand(4, 4)
    cur = torch.tensor([6, 5, 9, 3])
    got = ladder_propose(cur, props, ImageTokenLadder(ids=ids)).tolist()
    assert got == [[7, 8, 9, 104], [6, 7, 8, 9], [101, 102, 103, 104],
                   [101, 102, 103, 104]]
    jl = jsampler.ImageTokenLadder(ids=ids)
    for row, c in enumerate(cur.tolist()):
        want = jsampler.ladder_propose(jnp.asarray(c),
                                       jnp.asarray(props[row].numpy()), jl)
        assert got[row] == np.asarray(want).tolist()


@pytest.fixture(scope="module")
def generators():
    spec = JSpec(batch=1, seq=32, image_size=56, nq=4)
    jm, jl, _ = j_build(spec)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              **synthetic_batch(spec, cmp_images=1))
    tm, _, _ = build_tiny_mllm(TinySpec(), device="cpu")
    tm.load_state_dict(from_jax_params(params["params"]), strict=True)
    return jm, jl, params, tm


PROMPTS = ([7, 9, 11, 7, 9, 11, 7, 9], [3, 17, 42, 9, 100], [250, 4])


@pytest.mark.parametrize("eos_pick", [None, 3])
def test_speculative_generate_matches_reference_and_plain(generators,
                                                          eos_pick):
    """Repetitive, arbitrary and short prompts: the port's speculative
    generator (k = 4, 2-grams) gives the JAX speculative generator's ids
    and the port's plain greedy ids; with EOS set to the plain run's 4th
    token it stops where the plain run does."""
    jm, jl, params, tm = generators
    base = dict(max_new_tokens=12, eos_token_id=-1)
    plain = MLLMGenerator(tm, sampling=SamplingConfig(**base),
                          cache_dtype=torch.float32, cast_params_bf16=True)
    spec = MLLMGenerator(tm, sampling=SamplingConfig(**base),
                         cache_dtype=torch.float32, speculative_k=4,
                         speculative_ngram=2, cast_params_bf16=True)
    jspec = JGen(jm, jl, params, sampling=jsampler.SamplingConfig(**base),
                 cache_dtype=jnp.float32, speculative_k=4,
                 speculative_ngram=2)
    for p in PROMPTS:
        ids = torch.tensor([p])
        sampling = None
        if eos_pick is not None:
            first = plain.generate(ids)["generate_ids"][0]
            kw = dict(base, eos_token_id=int(first[eos_pick]))
            sampling = SamplingConfig(**kw)
            jspec.sampling = jsampler.SamplingConfig(**kw)
        want = plain.generate(ids, sampling=sampling)["generate_ids"]
        got = spec.generate(ids, sampling=sampling)["generate_ids"]
        assert spec.last_timings["speculative_k"] == 4
        ref = np.asarray(jspec.generate(jnp.asarray([p], jnp.int32),
                                        sampling=jspec.sampling)
                         ["generate_ids"])
        assert got.tolist() == want.tolist() == ref.tolist(), p
    # a repetitive prompt takes fewer verify forwards than tokens
    spec.generate(torch.tensor([PROMPTS[0]]))
    assert spec.last_timings["decode_steps"] < 11


def test_sampled_or_batched_calls_do_not_speculate(generators):
    *_, tm = generators
    spec = MLLMGenerator(tm, sampling=SamplingConfig(max_new_tokens=4),
                         cache_dtype=torch.float32, speculative_k=3,
                         cast_params_bf16=True)
    spec.generate(torch.tensor([PROMPTS[1], PROMPTS[1]]))
    assert spec.last_timings["speculative_k"] == 0
    spec.generate(torch.tensor([PROMPTS[1]]), sampling=SamplingConfig(
        max_new_tokens=4, do_sample=True))
    assert spec.last_timings["speculative_k"] == 0
