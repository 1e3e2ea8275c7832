"""The cached steps the batched engine runs, against the JAX package on
the same inputs (fp32, CPU): the Llama's single-token step with per-row
positions (a [B] ``cache["pos"]``: its logits and the columns it writes),
its verify window (per-row positions, S > 1), its multi-token cached step
(a scalar position, S > 1: the chunked prefill), and ``decode_attention``
under a per-row mask, all to atol 1e-5 (the difference is summation
order); the same steps over fp8 and f32 caches, the fp8 cache write's
bytes, and fused projections; and each of them again with as many KV heads
as query heads (MHA, as Llama-2-13B's 40/40)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_npu_tpu.models.language_models.llama import (
    LlamaConfig as JConfig, LlamaForCausalLM as JLlama, _write_decode_column,
    init_cache as j_init_cache)
from mllm_npu_tpu.ops.attention import decode_attention as j_decode_attention
from mllm_npu_tpu_torch.models.language_models.llama import (
    LlamaConfig, LlamaForCausalLM, init_cache, write_decode_column)
from mllm_npu_tpu_torch.ops import decode_attention
from mllm_npu_tpu_torch.utils.weights import llama_from_jax

ATOL = 1e-5
B, MAX_LEN = 3, 24
# the tiny config's KV heads: GQA 4/2, and MHA 4/4 (Llama-2-13B's layout)
GQA, MHA = 2, 4


def _tiny(cls, kv_heads=GQA, **kw):
    return dataclasses.replace(cls.tiny(**kw), num_key_value_heads=kv_heads)


def _pair(kv_heads):
    kw = dict(lora_rank=8, rope_theta=500000.0)
    jcfg = _tiny(JConfig, kv_heads, vocab_size=512, **kw)
    jm = JLlama(jcfg, dtype=jnp.float32)
    tree = jm.init(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))
    rs = np.random.RandomState(3)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, x: (rs.normal(0, 0.05, x.shape).astype(np.float32)
                         if path[-1].key == "lora_b" else np.asarray(x)),
        tree["params"])
    tm = LlamaForCausalLM(_tiny(LlamaConfig, kv_heads, vocab_size=512, **kw),
                          dtype=torch.float32)
    tm.load_state_dict(llama_from_jax(tree), strict=True)
    return jm, {"params": tree}, jcfg, tm


@pytest.fixture(scope="module")
def pair():
    return _pair(GQA)


@pytest.fixture(scope="module")
def mha_pair():
    return _pair(MHA)


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


@pytest.mark.parametrize("W", [2, 5])
def test_per_row_verify_window_matches(pair, W):
    """The speculative verify window: W tokens a row at per-row positions
    over a read-only cache, causal within the window; the same logits and
    [L, B, W, Hkv, D] columns as the reference, the cache untouched."""
    jm, params, jcfg, tm = pair
    k, v = _random_cache(jcfg, B, 8)
    rs = np.random.RandomState(9)
    pos = np.asarray([3, 12, 7], np.int32)
    key_valid = rs.rand(B, MAX_LEN) < 0.8
    rope = pos[:, None] + np.arange(W, dtype=np.int32)
    toks = rs.randint(3, 512, (B, W)).astype(np.int32)
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
    for name in ("k_col", "v_col"):
        assert tc[name].shape == (jcfg.num_hidden_layers, B, W,
                                  jcfg.num_key_value_heads, jcfg.head_dim)
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=ATOL)
    np.testing.assert_array_equal(tc["k"].numpy(), k)
    np.testing.assert_array_equal(tc["v"].numpy(), v)
    assert torch.equal(tc["pos"], torch.from_numpy(pos).long())


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


@pytest.mark.parametrize("Hq,Hkv", [(4, 2), (8, 1), (4, 4)])
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


def test_write_decode_column_window_matches():
    """W columns a row (the verify window), one row's window running past
    the cache's end clamped onto its last column, as the reference's
    update clamps an idle row's."""
    rs = np.random.RandomState(8)
    cache = rs.normal(size=(2, 4, 12, 2, 8)).astype(np.float32)
    col = rs.normal(size=(2, 4, 3, 2, 8)).astype(np.float32)
    pos = np.asarray([0, 9, 3, 5], np.int32)
    want = _write_decode_column(jnp.asarray(cache), jnp.asarray(col),
                                jnp.asarray(pos))
    got = torch.from_numpy(cache.copy())
    write_decode_column(got, torch.from_numpy(col),
                        torch.from_numpy(pos).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# e4m3 edge values: subnormals (2^-9 is the least), ties between
# neighbours, ±448 (the largest finite), between 448 and 464 (round to
# 448), 464 (a tie: rounds to 448 by even) and beyond (the reference's
# cast gives NaN, the port saturates)
FP8_EDGES = np.asarray(
    [0.0, -0.0, 2.0 ** -9, 2.0 ** -10, 3 * 2.0 ** -10, 2.0 ** -7 * 1.0625,
     0.3, 1.0625, 1.1875, -1.1875, 15.5, 17.0, 240.0, 248.0, 440.0, 447.0,
     448.0, -448.0, 450.0, 456.0, 463.9, -463.9, 464.0, -464.0],
    np.float32)
FP8_OVER = np.asarray([465.0, 500.0, 1e4, -500.0, -1e4], np.float32)


def _fp8_bytes_ref(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn)).view(
        np.uint8)


def test_fp8_cache_write_matches_the_reference_bytes():
    """The port's fp8 cache write (``to_cache``, via the per-row scatter
    and the chunk write) gives the reference's bytes for every |x| < 464,
    on edge values and 4096 seeded ones; beyond, the reference's bytes are
    NaN (0x7F / 0xFF) and the port's saturate at ±448 (0x7E / 0xFE)."""
    from mllm_npu_tpu_torch.models.language_models.llama import to_cache
    rs = np.random.RandomState(11)
    vals = np.concatenate([FP8_EDGES, (rs.standard_normal(4096)
                                       * rs.choice([1e-3, 1.0, 60.0, 300.0],
                                                   4096)).astype(np.float32)
                           .clip(-463.9, 463.9)])
    got = to_cache(torch.from_numpy(vals), torch.float8_e4m3fn).view(
        torch.uint8).numpy()
    np.testing.assert_array_equal(got, _fp8_bytes_ref(vals))
    # the same bytes through the per-row scatter into a 1-byte cache
    col = torch.from_numpy(vals[:24].reshape(1, 1, 1, 24, 1))
    cache = init_cache(LlamaConfig.tiny(), 1, 4, dtype=torch.float8_e4m3fn)
    k = cache["k"][:1, :1, :, :1, :1].expand(1, 1, 4, 24, 1).contiguous()
    write_decode_column(k, col, torch.tensor([2]))
    np.testing.assert_array_equal(k[0, 0, 2, :, 0].view(torch.uint8).numpy(),
                                  _fp8_bytes_ref(vals[:24]))
    # overflow: pinned on both sides
    over = to_cache(torch.from_numpy(FP8_OVER), torch.float8_e4m3fn)
    np.testing.assert_array_equal(over.view(torch.uint8).numpy(),
                                  [0x7E, 0x7E, 0x7E, 0xFE, 0xFE])
    np.testing.assert_array_equal(_fp8_bytes_ref(FP8_OVER),
                                  [0x7F, 0x7F, 0x7F, 0xFF, 0xFF])


CACHE_DTYPE_CASES = [("float32", "float8_e4m3fn", ATOL),
                     ("bfloat16", "float32", 8e-2),
                     ("bfloat16", "float8_e4m3fn", 8e-2)]


@pytest.mark.parametrize("model_dtype,cache_dtype,atol", CACHE_DTYPE_CASES)
def test_cached_steps_with_other_cache_dtypes(model_dtype, cache_dtype,
                                              atol, kv_heads=GQA):
    """The chunk step narrows (fp8) or widens (f32) its keys into the cache
    and reads the cache back in the compute dtype, and the per-row step
    reads a 1-byte cache in bf16, as the reference's; logits within
    ``atol`` (fp32 model: summation order; bf16 model: every product
    rounded to bf16 in another order, up to ~10 bf16 steps at the tiny
    model's |logit| <= 2), the written bytes equal (fp32 model)."""
    jcfg = _tiny(JConfig, kv_heads, vocab_size=512, rope_theta=500000.0)
    jm = JLlama(jcfg, dtype=getattr(jnp, model_dtype))
    tree = jm.init(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray, tree["params"])
    tm = LlamaForCausalLM(_tiny(LlamaConfig, kv_heads, vocab_size=512,
                                rope_theta=500000.0),
                          dtype=getattr(torch, model_dtype))
    tm.load_state_dict(llama_from_jax(tree), strict=True)
    jdt, tdt = getattr(jnp, cache_dtype), getattr(torch, cache_dtype)
    k, v = _random_cache(jcfg, 2, 12)
    k, v = (np.asarray(jnp.asarray(x).astype(jdt)) for x in (k, v))
    t = lambda x: torch.from_numpy(x.view(np.uint8).copy()).view(tdt) \
        if tdt.itemsize == 1 else torch.from_numpy(x.copy())
    rs = np.random.RandomState(13)
    toks = rs.randint(3, 512, (2, 6)).astype(np.int32)
    positions = (5 + np.arange(6, dtype=np.int32))[None].repeat(2, 0)
    # the chunk step at scalar position 5
    jl, _, jc = jm.apply({"params": tree}, input_ids=jnp.asarray(toks),
                         cache={"k": jnp.asarray(k), "v": jnp.asarray(v),
                                "pos": jnp.asarray(5, jnp.int32)},
                         positions=jnp.asarray(positions))
    tc = {"k": t(k), "v": t(v), "pos": 5}
    with torch.no_grad():
        h, tc = tm(torch.from_numpy(toks).long(),
                   positions=torch.from_numpy(positions).long(), cache=tc)
        tl = tm.logits(h)
    assert tc["k"].dtype == tdt
    np.testing.assert_allclose(tl.float().numpy(),
                               np.asarray(jl, np.float32), atol=atol)
    if model_dtype == "float32":
        np.testing.assert_array_equal(
            tc["k"].view(torch.uint8).numpy(),
            np.asarray(jc["k"]).view(np.uint8))
    # the per-row single-token step over the cache as the chunk left it
    pos = np.asarray([11, 9], np.int32)
    tok = toks[:, :1]
    jl, _, jc2 = jm.apply({"params": tree}, input_ids=jnp.asarray(tok),
                          cache={"k": jc["k"], "v": jc["v"],
                                 "pos": jnp.asarray(pos)})
    with torch.no_grad():
        h, tc = tm(torch.from_numpy(tok).long(),
                   cache={"k": tc["k"], "v": tc["v"],
                          "pos": torch.from_numpy(pos).long()})
        tl = tm.logits(h)
    np.testing.assert_allclose(tl.float().numpy(),
                               np.asarray(jl, np.float32), atol=atol)


def _fused_tree(tree):
    from mllm_npu_tpu.utils.weights import fuse_llama_projections
    return jax.tree_util.tree_map(np.asarray, fuse_llama_projections(tree))


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_fused_projections_match(bits, kv_heads=GQA):
    """qkv_proj and gate_up_proj (the reference's fused tree, carried over
    by ``llama_from_jax``): the prefill and a cached step give the fused
    JAX model's logits, and the port's own ``fuse_llama_projections_``
    (on the float model, or after quantizing it) gives the same buffers
    and the unfused model's logits, to 1e-4 (fp32; summation order)."""
    from mllm_npu_tpu.models.generation.generate import rebuild_llm
    from mllm_npu_tpu.utils.weights import quantize_llama_params
    from mllm_npu_tpu_torch.utils.weights import (fuse_llama_projections_,
                                                  quantize_llama_)
    kw = dict(vocab_size=512, rope_theta=500000.0)
    jcfg = _tiny(JConfig, kv_heads, **kw)
    jm = JLlama(jcfg, dtype=jnp.float32)
    ids = np.random.RandomState(14).randint(3, 512, (2, 8)).astype(np.int32)
    tree = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.asarray(ids))["params"])
    jf_cfg = dataclasses.replace(jcfg, fused_projections=True)
    jf_tree = _fused_tree(tree)
    if bits:
        jf_tree = quantize_llama_params(jf_tree, bits=bits, group_size=64)
        jf_cfg = dataclasses.replace(jf_cfg, quantization=f"int{bits}",
                                     quant_group_size=64)
    jf = JLlama(jf_cfg, dtype=jnp.float32)
    jl, _, _ = jf.apply({"params": jf_tree}, jnp.asarray(ids))
    tcfg = _tiny(LlamaConfig, kv_heads, **kw)
    tf = LlamaForCausalLM(dataclasses.replace(
        tcfg, fused_projections=True,
        quantization=f"int{bits}" if bits else "none", quant_group_size=64),
        dtype=torch.float32)
    tf.load_state_dict(llama_from_jax(jf_tree), strict=True)
    with torch.no_grad():
        h, _ = tf(torch.from_numpy(ids).long())
        np.testing.assert_allclose(tf.logits(h).numpy(), np.asarray(jl),
                                   atol=ATOL)
    # the port's transform, before and after quantizing: the same buffers
    for order in ("fuse_first", "quantize_first"):
        tm = LlamaForCausalLM(tcfg, dtype=torch.float32)
        tm.load_state_dict(llama_from_jax(tree), strict=True)
        if order == "fuse_first" or not bits:
            fuse_llama_projections_(tm)
            if bits:
                quantize_llama_(tm, bits=bits, group_size=64)
        else:
            quantize_llama_(tm, bits=bits, group_size=64)
            fuse_llama_projections_(tm)
        assert tm.config.fused_projections
        want = tf.state_dict()
        got = tm.state_dict()
        assert sorted(got) == sorted(want)
        for name in got:
            torch.testing.assert_close(got[name], want[name], rtol=0,
                                       atol=0, msg=name)
    # and a cached step of the fused model against the fused JAX model
    cache = j_init_cache(jf_cfg, 2, 16, dtype=jnp.float32)
    _, _, cache = jf.apply({"params": jf_tree}, jnp.asarray(ids),
                           cache=cache, prefill=True)
    jl, _, _ = jf.apply({"params": jf_tree}, jnp.asarray(ids[:, :1]),
                        cache=cache)
    tc = init_cache(tf.config, 2, 16, dtype=torch.float32)
    with torch.no_grad():
        _, tc = tf(torch.from_numpy(ids).long(), cache=tc, prefill=True)
        h, _ = tf(torch.from_numpy(ids[:, :1]).long(), cache=tc)
        np.testing.assert_allclose(tf.logits(h).numpy(), np.asarray(jl),
                                   atol=ATOL)


@pytest.mark.parametrize("case", ["per_row", "per_row_default",
                                  "multi_token", "verify_window"])
def test_mha_cached_steps_match(mha_pair, case):
    """The batched engine's cached steps with MHA (q, k and v each the
    model's width, as Llama-2-13B): each GQA test above on the MHA pair."""
    if case == "per_row":
        test_per_row_position_step_matches(mha_pair)
    elif case == "per_row_default":
        test_per_row_positions_default_from_the_cache(mha_pair)
    elif case == "multi_token":
        for off, S in ((0, 8), (6, 5)):
            test_multi_token_cached_step_matches(mha_pair, off, S)
    else:
        test_per_row_verify_window_matches(mha_pair, 5)


@pytest.mark.parametrize("model_dtype,cache_dtype,atol", CACHE_DTYPE_CASES)
def test_mha_cached_steps_with_other_cache_dtypes(model_dtype, cache_dtype,
                                                  atol):
    test_cached_steps_with_other_cache_dtypes(model_dtype, cache_dtype, atol,
                                              kv_heads=MHA)


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_mha_fused_projections_match(bits):
    """qkv_proj at MHA: q, k and v each the model's width."""
    test_fused_projections_match(bits, kv_heads=MHA)


def test_fuse_refuses_lora_and_shards():
    from mllm_npu_tpu_torch.utils.weights import fuse_llama_projections_
    tm = LlamaForCausalLM(LlamaConfig.tiny(lora_rank=4), dtype=torch.float32)
    with pytest.raises(ValueError, match="merge"):
        fuse_llama_projections_(tm)
    with pytest.raises(NotImplementedError, match="item 12"):
        LlamaForCausalLM(LlamaConfig.tiny(fused_projections=True,
                                          fused_shards=2))
