"""The cached steps the batched engine runs, against the JAX package on
the same inputs (fp32, CPU): the Llama's single-token step with per-row
positions (a [B] ``cache["pos"]``: its logits and the columns it writes)
and its multi-token cached step (a scalar position, S > 1: the chunked
prefill), and ``decode_attention`` under a per-row mask, all to atol 1e-5
(the difference is summation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_npu_tpu.models.language_models.llama import (
    LlamaConfig as JConfig, LlamaForCausalLM as JLlama, _write_decode_column)
from mllm_npu_tpu.ops.attention import decode_attention as j_decode_attention
from mllm_npu_tpu_torch.models.language_models.llama import (
    LlamaConfig, LlamaForCausalLM, write_decode_column)
from mllm_npu_tpu_torch.ops import decode_attention
from mllm_npu_tpu_torch.utils.weights import llama_from_jax

ATOL = 1e-5
B, MAX_LEN = 3, 24


@pytest.fixture(scope="module")
def pair():
    kw = dict(lora_rank=8, rope_theta=500000.0)
    jcfg = JConfig.tiny(vocab_size=512, **kw)
    jm = JLlama(jcfg, dtype=jnp.float32)
    tree = jm.init(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))
    rs = np.random.RandomState(3)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, x: (rs.normal(0, 0.05, x.shape).astype(np.float32)
                         if path[-1].key == "lora_b" else np.asarray(x)),
        tree["params"])
    tm = LlamaForCausalLM(LlamaConfig.tiny(vocab_size=512, **kw),
                          dtype=torch.float32)
    tm.load_state_dict(llama_from_jax(tree), strict=True)
    return jm, {"params": tree}, jcfg, tm


def _random_cache(cfg, batch, seed):
    rs = np.random.RandomState(seed)
    shape = (cfg.num_hidden_layers, batch, MAX_LEN, cfg.num_key_value_heads,
             cfg.head_dim)
    return (rs.normal(0, 1, shape).astype(np.float32),
            rs.normal(0, 1, shape).astype(np.float32))


def test_per_row_position_step_matches(pair):
    """Three rows at three fill levels, with a per-row key mask (the
    engine's key_valid) and per-row RoPE positions: the same logits, and
    each row's column written at its own position."""
    jm, params, jcfg, tm = pair
    k, v = _random_cache(jcfg, B, 0)
    rs = np.random.RandomState(1)
    pos = np.asarray([5, 17, 2], np.int32)
    key_valid = rs.rand(B, MAX_LEN) < 0.8
    rope = np.asarray([[3], [15], [2]], np.int32)
    toks = rs.randint(3, 512, (B, 1)).astype(np.int32)
    am = key_valid[:, None, None, :]
    jl, _, jc = jm.apply(params, input_ids=jnp.asarray(toks),
                         cache={"k": jnp.asarray(k), "v": jnp.asarray(v),
                                "pos": jnp.asarray(pos)},
                         positions=jnp.asarray(rope),
                         attn_mask=jnp.asarray(am))
    tc = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
          "pos": torch.from_numpy(pos).long()}
    with torch.no_grad():
        h, tc = tm(torch.from_numpy(toks).long(),
                   positions=torch.from_numpy(rope).long(), cache=tc,
                   attn_mask=torch.from_numpy(am))
        tl = tm.logits(h)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               atol=ATOL)
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]),
                               atol=ATOL)
    # only each row's own column moved
    moved = (tc["k"].numpy() != k).any(axis=(0, 3, 4))
    want = np.zeros((B, MAX_LEN), bool)
    want[np.arange(B), pos] = True
    np.testing.assert_array_equal(moved, want)


def test_per_row_positions_default_from_the_cache(pair):
    """Without explicit positions a row's RoPE position is its cache
    position, as in the reference."""
    jm, params, jcfg, tm = pair
    k, v = _random_cache(jcfg, B, 2)
    pos = np.asarray([1, 7, 12], np.int32)
    toks = np.asarray([[4], [9], [300]], np.int32)
    jl, _, _ = jm.apply(params, input_ids=jnp.asarray(toks),
                        cache={"k": jnp.asarray(k), "v": jnp.asarray(v),
                               "pos": jnp.asarray(pos)})
    with torch.no_grad():
        h, _ = tm(torch.from_numpy(toks).long(),
                  cache={"k": torch.from_numpy(k), "v": torch.from_numpy(v),
                         "pos": torch.from_numpy(pos).long()})
        tl = tm.logits(h)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


@pytest.mark.parametrize("off,S", [(0, 8), (8, 8), (6, 5), (16, 8)])
def test_multi_token_cached_step_matches(pair, off, S):
    """A chunk of S tokens at scalar position ``off`` over a filled
    cache: written first, then attended causally from q_offset = off."""
    jm, params, jcfg, tm = pair
    k, v = _random_cache(jcfg, 1, 4 + off)
    rs = np.random.RandomState(5)
    toks = rs.randint(3, 512, (1, S)).astype(np.int32)
    positions = (off + np.arange(S, dtype=np.int32))[None]
    jl, _, jc = jm.apply(params, input_ids=jnp.asarray(toks),
                         cache={"k": jnp.asarray(k), "v": jnp.asarray(v),
                                "pos": jnp.asarray(off, jnp.int32)},
                         positions=jnp.asarray(positions))
    tc = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
          "pos": off}
    with torch.no_grad():
        h, tc = tm(torch.from_numpy(toks).long(),
                   positions=torch.from_numpy(positions).long(), cache=tc)
        tl = tm.logits(h)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               atol=ATOL)
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]),
                               atol=ATOL)
    assert tc["pos"] == off + S


def test_per_row_verify_window_is_not_ported(pair):
    *_, tm = pair
    cache = {"k": torch.zeros(2, 2, MAX_LEN, 2, 32),
             "v": torch.zeros(2, 2, MAX_LEN, 2, 32),
             "pos": torch.tensor([1, 2])}
    with pytest.raises(NotImplementedError, match="10b"):
        tm(torch.ones(2, 3, dtype=torch.long), cache=cache)


def test_write_decode_column_per_row_matches():
    rs = np.random.RandomState(6)
    cache = rs.normal(size=(2, 4, 10, 2, 8)).astype(np.float32)
    col = rs.normal(size=(2, 4, 1, 2, 8)).astype(np.float32)
    pos = np.asarray([0, 9, 3, 3], np.int32)
    want = _write_decode_column(jnp.asarray(cache), jnp.asarray(col),
                                jnp.asarray(pos))
    got = torch.from_numpy(cache.copy())
    write_decode_column(got, torch.from_numpy(col),
                        torch.from_numpy(pos).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("Hq,Hkv", [(4, 2), (8, 1)])
def test_decode_attention_per_row_mask_matches(Hq, Hkv):
    rs = np.random.RandomState(7)
    Sk, D = 40, 16
    q = rs.normal(size=(B, 1, Hq, D)).astype(np.float32)
    k, v = (rs.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
            for _ in range(2))
    kc, vc = (rs.normal(size=(B, 1, Hkv, D)).astype(np.float32)
              for _ in range(2))
    mask = rs.rand(B, 1, 1, Sk) < 0.6
    mask[1] = False                     # a row that sees only itself
    want = j_decode_attention(*map(jnp.asarray, (q, k, v, mask)),
                              k_cur=jnp.asarray(kc), v_cur=jnp.asarray(vc))
    got = decode_attention(*map(torch.from_numpy, (q, k, v, mask)),
                           k_cur=torch.from_numpy(kc),
                           v_cur=torch.from_numpy(vc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
