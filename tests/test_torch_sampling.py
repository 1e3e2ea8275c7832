"""Sampled decoding of the port against the reference (CPU): the nucleus
filter keeps exactly the support the JAX ``sample_rows`` keeps (ties at
the cutoff included), greedy rows are the argmax, and the port's draws
follow the filtered softmax (a chi-square test). ``jax.random``'s bits are
not reproduced: a draw is Gumbel-max with noise hashed from (seed, token
index, vocab index), so it depends on those alone."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_npu_tpu.models.generation import sampler as jsampler
from mllm_npu_tpu_torch.models.generation.generate import MLLMGenerator
from mllm_npu_tpu_torch.models.generation.sampler import (
    NEG_INF, SamplingConfig, gumbel_noise, nucleus_filter, sample_rows)
from mllm_npu_tpu_torch.utils.testing import TinySpec, build_tiny_mllm

# a chi-square test's p-value below this fails it
P_MIN = 1e-3


def _reference_filtered(monkeypatch, logits, temp, top_p):
    """The filtered logits the JAX ``sample_rows`` hands to
    ``jax.random.categorical`` (captured in place of the vmapped draw)."""
    seen = {}

    def fake_vmap(fn):
        def run(rngs, filtered):
            seen["filtered"] = np.asarray(filtered)
            return jnp.zeros(filtered.shape[0], jnp.int32)
        return run
    monkeypatch.setattr(jsampler, "jax", types.SimpleNamespace(
        vmap=fake_vmap, random=jax.random, nn=jax.nn))
    B = logits.shape[0]
    jsampler.sample_rows(jnp.asarray(logits),
                         jax.random.split(jax.random.PRNGKey(0), B),
                         jnp.asarray(temp), jnp.asarray(top_p),
                         jnp.ones((B,), bool))
    return seen["filtered"]


def _seeded_logits(B, V, seed):
    """Seeded logits with ties: each row repeats a few values, so equal
    logits straddle the nucleus cutoff."""
    rs = np.random.RandomState(seed)
    levels = rs.normal(0, 2, (B, 12)).astype(np.float32)
    return np.take_along_axis(levels, rs.randint(0, 12, (B, V)), axis=1)


@pytest.mark.parametrize("temp,top_p", [(0.7, 0.9), (1.0, 0.5), (1.3, 0.99),
                                        (0.05, 0.3)])
def test_nucleus_support_matches_the_reference(monkeypatch, temp, top_p):
    """On rows with tied logits, the kept entries are the reference's
    exactly and their scaled values equal to 1e-6 (relative). (At top_p 1
    the cut falls where the fp32 running sum crosses 1.0, which the two
    libraries round in their own orders: not a case to hold bit for
    bit.)"""
    B, V = 16, 257
    logits = np.concatenate([_seeded_logits(B // 2, V, 1),
                             np.random.RandomState(2).normal(
                                 0, 3, (B // 2, V)).astype(np.float32)])
    t = np.full((B,), temp, np.float32)
    p = np.full((B,), top_p, np.float32)
    want = _reference_filtered(monkeypatch, logits, t, p)
    got = nucleus_filter(torch.from_numpy(logits), torch.from_numpy(t),
                         torch.from_numpy(p)).numpy()
    keep = want > NEG_INF / 2
    np.testing.assert_array_equal(got > NEG_INF / 2, keep)
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6)
    assert keep.sum(axis=1).min() >= 1


def test_greedy_rows_and_cold_rows_are_the_argmax():
    """do_sample False rows give the first argmax; a near-zero temperature
    with top_p 1 collapses a sampled row onto the argmax too (the
    reference's cold-row check)."""
    B, V = 8, 300
    logits = torch.from_numpy(
        np.random.RandomState(3).normal(0, 1, (B, V)).astype(np.float32))
    logits[0, 7] = logits[0, 9] = logits[0].max() + 1   # a tie: index 7
    seed = torch.arange(B) * 17
    index = torch.arange(B)
    do_sample = torch.tensor([False, True] * (B // 2))
    got = sample_rows(logits, seed, index, torch.full((B,), 1e-4),
                      torch.ones(B), do_sample)
    assert torch.equal(got, torch.argmax(logits, dim=-1))
    assert int(got[0]) == 7


def test_draws_depend_on_seed_and_index_alone():
    """The same (seed, index) draws the same token in any row, beside any
    other rows; another seed or index draws differently somewhere."""
    V = 500
    logits = torch.from_numpy(
        np.random.RandomState(4).normal(0, 1, (1, V)).astype(np.float32))
    rows = 64
    lg = logits.expand(rows, V)
    seed = torch.full((rows,), 12345)
    index = torch.arange(rows)
    one = lambda x: torch.full((rows,), x)
    a = sample_rows(lg, seed, index, one(0.8), one(0.95),
                    torch.ones(rows, dtype=torch.bool))
    perm = torch.randperm(rows, generator=torch.Generator().manual_seed(0))
    b = sample_rows(lg, seed[perm], index[perm], one(0.8), one(0.95),
                    torch.ones(rows, dtype=torch.bool))
    assert torch.equal(b, a[perm])
    c = sample_rows(lg, seed + 1, index, one(0.8), one(0.95),
                    torch.ones(rows, dtype=torch.bool))
    assert not torch.equal(a, c)
    assert len(set(a.tolist())) > 8          # the index moves the draw
    noise = gumbel_noise(seed[:2], index[:2], V)
    assert torch.isfinite(noise).all()


def _chi_square_p(counts: np.ndarray, probs: np.ndarray) -> float:
    expected = probs * counts.sum()
    stat = float(((counts - expected) ** 2 / expected).sum())
    df = len(counts) - 1
    return float(torch.special.gammaincc(torch.tensor(df / 2.0,
                                                      dtype=torch.float64),
                                         torch.tensor(stat / 2.0,
                                                      dtype=torch.float64)))


@pytest.mark.parametrize("temp,top_p,seed", [(0.7, 0.9, 1), (1.0, 0.6, 2)])
def test_draws_follow_the_filtered_softmax(temp, top_p, seed):
    """2^15 draws (token indices 0..2^15-1 under one seed) of one row of
    seeded logits over a 1000-token vocab: none outside the nucleus, and
    the counts of the nucleus's top 16 ids and the rest of it pass a
    chi-square test against the filtered softmax at p >= 0.001."""
    V, N = 1000, 1 << 15
    rs = np.random.RandomState(seed)
    logits = torch.from_numpy(rs.normal(0, 2.5, (1, V)).astype(np.float32))
    one = lambda x, dt=torch.float32: torch.full((1,), x, dtype=dt)
    filtered = nucleus_filter(logits, one(temp), one(top_p))[0]
    support = filtered > NEG_INF / 2
    probs = torch.softmax(filtered.double(), dim=-1)
    draws = []
    for start in range(0, N, 4096):
        idx = torch.arange(start, start + 4096)
        draws.append(sample_rows(
            logits.expand(4096, V), torch.full((4096,), 99 + seed), idx,
            one(temp).expand(4096), one(top_p).expand(4096),
            torch.ones(4096, dtype=torch.bool)))
    draws = torch.cat(draws)
    assert bool(support[draws].all())
    order = torch.argsort(probs, descending=True)
    top = order[:min(16, int(support.sum()) - 1)]
    counts = torch.bincount(draws, minlength=V).double()
    c = torch.cat([counts[top], (counts.sum() - counts[top].sum())[None]])
    p = torch.cat([probs[top], (1 - probs[top].sum())[None]])
    assert _chi_square_p(c.numpy(), p.numpy()) >= P_MIN


def test_generator_samples_reproducibly():
    """``MLLMGenerator`` with do_sample: the same seed gives the same ids,
    another seed other ids, a batch row the ids it has alone under its
    (seed, row) stream, and do_sample False the greedy ids."""
    tm, _, _ = build_tiny_mllm(TinySpec(), device="cpu", seed=5)
    gen = MLLMGenerator(tm, sampling=SamplingConfig(max_new_tokens=8))
    hot = SamplingConfig(max_new_tokens=8, do_sample=True, temperature=1.5,
                         top_p=0.98)
    ids = torch.tensor([[3, 17, 42, 9, 100, 7]])
    a = gen.generate(ids, sampling=hot, seed=1)["generate_ids"]
    assert torch.equal(gen.generate(ids, sampling=hot,
                                    seed=1)["generate_ids"], a)
    assert not torch.equal(gen.generate(ids, sampling=hot,
                                        seed=2)["generate_ids"], a)
    both = gen.generate(ids.repeat(2, 1), sampling=hot, seed=1)
    assert torch.equal(both["generate_ids"][0], a[0])
    greedy = gen.generate(ids)["generate_ids"]
    cold = SamplingConfig(max_new_tokens=8, do_sample=True,
                          temperature=1e-5, top_p=1.0)
    assert torch.equal(gen.generate(ids, sampling=cold)["generate_ids"],
                       greedy)
