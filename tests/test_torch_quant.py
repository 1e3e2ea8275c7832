"""Weight-only int8 / int4 in the port against the JAX package
(``mllm_npu_tpu/ops/quant.py``), on the CPU.

- Storage: the port's quantized bytes and scales are bit-identical to the
  reference's, with values transposed ([N, K] here, [K, N] there).
- Products: the plain versions of K4 and K5 against the reference's
  Pallas kernels in interpret mode, and against its jnp fallback at
  awkward N. fp32 x; atol 1e-5 · max|ref| (the same fp32 products summed
  in another order).
- Modules and the quantized Llama (LoRA merged, cast to bf16, quantized,
  as ``MLLMGenerator`` does): fp32 compute, atol 1e-4 on logits, as for
  the bf16 Llama; the port's own transforms give bit-identical buffers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_npu_tpu.models.language_models.llama import (
    LlamaConfig as JConfig, LlamaForCausalLM as JLlama, init_cache as j_cache)
from mllm_npu_tpu.ops import quant as jq
from mllm_npu_tpu.utils.weights import (merge_lora_params,
                                        quantize_llama_params)
from mllm_npu_tpu_torch.models.language_models.llama import (
    LlamaConfig, LlamaForCausalLM, init_cache)
from mllm_npu_tpu_torch.ops import quant as tq
from mllm_npu_tpu_torch.utils.weights import (linear_from_jax, llama_from_jax,
                                              merge_lora_, quantize_llama_)

REL = 1e-5
ATOL = 1e-4


def _w(K, N, seed=0, zero_col=None):
    w = np.random.RandomState(seed).normal(0, 0.05, (K, N)).astype(np.float32)
    if zero_col is not None:
        w[:, zero_col] = 0.0
    return w


def _close(got, ref, rel=REL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref,
                               atol=rel * np.abs(ref).max(), rtol=0)


# -- storage ----------------------------------------------------------------

@pytest.mark.parametrize("K,N", [(64, 32), (256, 100), (4096, 7)])
def test_int8_storage_bit_identical(K, N):
    w = _w(K, N, zero_col=3)
    ref = jq.quantize_int8(jnp.asarray(w))
    got = tq.quantize_int8(torch.from_numpy(w.T.copy()))
    assert got.values.dtype == torch.int8 and got.values.shape == (N, K)
    np.testing.assert_array_equal(got.values.numpy(),
                                  np.asarray(ref.values).T)
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    assert got.scale[3] == 1.0 and (got.values[3] == 0).all()
    np.testing.assert_array_equal(
        tq.dequantize_int8(got, torch.float32).numpy(),
        np.asarray(jq.dequantize_int8(ref, jnp.float32)).T)


@pytest.mark.parametrize("K,N,group,G", [
    (512, 32, 128, 128),      # four groups
    (256, 100, 256, 256),     # one group of the default size
    (200, 16, 128, 200),      # 128 does not divide K: one group of G = K
])
def test_int4_storage_bit_identical(K, N, group, G):
    w = _w(K, N, seed=1, zero_col=0)
    ref = jq.quantize_int4(jnp.asarray(w), group_size=group)
    got = tq.quantize_int4(torch.from_numpy(w.T.copy()), group_size=group)
    assert got.values.shape == (N, K // 2)
    assert got.scale.shape == (K // G, N)
    np.testing.assert_array_equal(got.values.numpy(),
                                  np.asarray(ref.values).T)
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_array_equal(
        tq.dequantize_int4(got, torch.float32).numpy(),
        np.asarray(jq.dequantize_int4(ref, jnp.float32)).T)


def test_nibble_pack_round_trip():
    """Every pair of values in [-8, 7] packs as the reference packs it and
    unpacks to itself."""
    v = np.arange(-8, 8, dtype=np.int32)
    lo, hi = (a.ravel() for a in np.meshgrid(v, v))
    got = tq._pack_nibbles(torch.from_numpy(lo), torch.from_numpy(hi))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jq._pack_nibbles(jnp.asarray(lo),
                                                 jnp.asarray(hi))))
    ulo, uhi = tq._unpack_lo_hi(got)
    np.testing.assert_array_equal(ulo.numpy(), lo)
    np.testing.assert_array_equal(uhi.numpy(), hi)


# -- products ---------------------------------------------------------------

def _x(M, K, seed=2):
    return np.random.RandomState(seed).normal(0, 1, (M, K)).astype(np.float32)


@pytest.mark.parametrize("M,K,N", [(4, 256, 128), (1, 512, 256),
                                   (9, 256, 256)])
def test_int8_plain_matches_interpret_kernel(M, K, N):
    x, w = _x(M, K), _w(K, N)
    jqt = jq.quantize_int8(jnp.asarray(w))
    ref = jq.int8_matmul(jnp.asarray(x), jqt, block_m=8, block_n=128,
                         block_k=min(K, 256), interpret=True)
    tqt = tq.quantize_int8(torch.from_numpy(w.T.copy()))
    got = tq.int8_matmul(torch.from_numpy(x), *tqt)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    _close(got, ref)


@pytest.mark.parametrize("M,K,N,group", [(4, 256, 128, 128),
                                         (1, 512, 256, 256),
                                         (9, 512, 128, 128)])
def test_int4_plain_matches_interpret_kernel(M, K, N, group):
    x, w = _x(M, K), _w(K, N)
    jqt = jq.quantize_int4(jnp.asarray(w), group_size=group)
    ref = jq.int4_matmul(jnp.asarray(x), jqt, block_m=8, block_n=128,
                         block_k=256, interpret=True)
    tqt = tq.quantize_int4(torch.from_numpy(w.T.copy()), group_size=group)
    got = tq.int4_matmul(torch.from_numpy(x), *tqt)
    _close(got, ref)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("N", [100, 77])
def test_plain_matches_fallback_at_awkward_n(bits, N):
    """N off the TPU's 128-lane tiling: the reference takes its jnp
    fallback; the port has one path."""
    x, w = _x(3, 256).reshape(1, 3, 256), _w(256, N)
    if bits == 8:
        ref = jq.int8_matmul(jnp.asarray(x), jq.quantize_int8(jnp.asarray(w)),
                             interpret=True)
        got = tq.int8_matmul(torch.from_numpy(x),
                             *tq.quantize_int8(torch.from_numpy(w.T.copy())))
    else:
        ref = jq.int4_matmul(jnp.asarray(x),
                             jq.quantize_int4(jnp.asarray(w), 128),
                             interpret=True)
        got = tq.int4_matmul(torch.from_numpy(x),
                             *tq.quantize_int4(torch.from_numpy(w.T.copy()),
                                               128))
    assert got.shape == (1, 3, N)
    _close(got, ref)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_modules_match_reference(bits):
    """Int8Linear / Int4Linear against Int8Dense / Int4Dense with the same
    quantized params, loaded through ``linear_from_jax``."""
    K, N = 256, 96
    w = _w(K, N, seed=4)
    if bits == 8:
        qt = jq.quantize_int8(jnp.asarray(w))
        params = {"kernel_q": qt.values, "scale": qt.scale}
        jmod = jq.Int8Dense(N, dtype=jnp.float32)
        tmod = tq.Int8Linear(K, N, dtype=torch.float32)
    else:
        qt = jq.quantize_int4(jnp.asarray(w), group_size=128)
        params = {"kernel_q": qt.values, "scale_g": qt.scale}
        jmod = jq.Int4Dense(N, group_size=128, dtype=jnp.float32)
        tmod = tq.Int4Linear(K, N, group_size=128, dtype=torch.float32)
    x = _x(6, K).reshape(2, 3, K)
    ref = jmod.apply({"params": params}, jnp.asarray(x))
    tmod.load_state_dict({k[2:]: v for k, v in
                          linear_from_jax(params, "m").items()})
    assert [n for n, _ in tmod.named_parameters()] == []
    got = tmod(torch.from_numpy(x))
    _close(got, ref)


# -- the quantized Llama ----------------------------------------------------

@pytest.fixture(scope="module")
def float_llama():
    """Tiny JAX Llama with r8 LoRA and non-zero adapters (so the merge is
    exercised), fp32 params."""
    jcfg = JConfig.tiny(vocab_size=512, lora_rank=8, rope_theta=500000.0)
    tree = JLlama(jcfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))["params"]
    rs = np.random.RandomState(3)

    def fix(path, x):
        x = np.asarray(x)
        if path[-1].key == "lora_b":
            return rs.normal(0, 0.05, x.shape).astype(np.float32)
        return x
    return jcfg, jax.tree_util.tree_map_with_path(fix, tree)


def _reference_quantized(jcfg, tree, bits):
    """The reference generator's order: merge LoRA in fp32, cast the fp32
    params to bf16, quantize from those values."""
    merged = merge_lora_params(tree, jcfg.lora_alpha)
    cast = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x,
        merged)
    return quantize_llama_params(cast, bits=bits,
                                 group_size=jcfg.quant_group_size)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_llama_prefill_and_decode_match(float_llama, bits):
    import dataclasses
    jcfg, tree = float_llama
    qcfg = dataclasses.replace(jcfg, lora_rank=0, quantization=f"int{bits}")
    qtree = _reference_quantized(jcfg, tree, bits)
    jm, params = JLlama(qcfg, dtype=jnp.float32), {"params": qtree}
    tm = LlamaForCausalLM(LlamaConfig.tiny(
        vocab_size=512, rope_theta=500000.0, quantization=f"int{bits}"),
        dtype=torch.float32)
    tm.load_state_dict(llama_from_jax(qtree), strict=True)
    assert all(p.dtype == torch.float32 for p in tm.parameters())

    B, Sp, steps = 2, 11, 4
    rs = np.random.RandomState(1)
    ids = rs.randint(3, 512, (B, Sp)).astype(np.int32)
    pos = np.broadcast_to(np.arange(Sp, dtype=np.int32), (B, Sp))
    max_len = Sp + steps
    jc = j_cache(qcfg, B, max_len, dtype=jnp.float32)
    jl, _, jc = jm.apply(params, input_ids=jnp.asarray(ids), cache=jc,
                         positions=jnp.asarray(pos), prefill=True)
    tc = init_cache(tm.config, B, max_len, dtype=torch.float32)
    with torch.no_grad():
        h, tc = tm(torch.from_numpy(ids).long(), cache=tc,
                   positions=torch.from_numpy(pos.copy()).long(),
                   prefill=True)
        np.testing.assert_allclose(tm.logits(h).numpy(), np.asarray(jl),
                                   atol=ATOL)
    toks = rs.randint(3, 512, (steps, B, 1)).astype(np.int32)
    for t in range(steps):
        p = np.full((B, 1), Sp + t, np.int32)
        jl, _, jc = jm.apply(params, input_ids=jnp.asarray(toks[t]),
                             cache=jc, positions=jnp.asarray(p))
        with torch.no_grad():
            h, tc = tm(torch.from_numpy(toks[t]).long(), cache=tc,
                       positions=torch.from_numpy(p).long())
            np.testing.assert_allclose(tm.logits(h).numpy(), np.asarray(jl),
                                       atol=ATOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_port_transforms_give_identical_buffers(float_llama, bits):
    """merge_lora_ → bf16 cast → quantize_llama_ on the float port model
    reproduces the reference's quantized tree byte for byte."""
    jcfg, tree = float_llama
    qtree = _reference_quantized(jcfg, tree, bits)
    want = llama_from_jax(qtree)
    tm = LlamaForCausalLM(LlamaConfig.tiny(
        vocab_size=512, lora_rank=8, rope_theta=500000.0),
        dtype=torch.float32)
    tm.load_state_dict(llama_from_jax(tree), strict=True)
    merge_lora_(tm)
    for p in tm.parameters():
        p.data = p.data.to(torch.bfloat16)
    quantize_llama_(tm, bits=bits, group_size=jcfg.quant_group_size)
    assert tm.config.lora_rank == 0
    assert tm.config.quantization == f"int{bits}"
    assert tm.model.layers[0].self_attn.config is tm.config
    got = tm.state_dict()
    assert sorted(got) == sorted(want)
    for name, t in want.items():
        g = got[name]
        if name.endswith("weight_q"):
            assert g.dtype == torch.int8
        elif name.endswith(("scale", "scale_g")):
            assert g.dtype == torch.float32
        else:   # norms and the embedding stay (bf16) float
            g = g.float()
        np.testing.assert_array_equal(g.numpy(), t.numpy(), err_msg=name)


def test_quantize_requires_merged_lora():
    tm = LlamaForCausalLM(LlamaConfig.tiny(vocab_size=64, lora_rank=4),
                          dtype=torch.float32)
    with pytest.raises(ValueError, match="merge"):
        quantize_llama_(tm, bits=8)
    with pytest.raises(NotImplementedError):
        LlamaForCausalLM(LlamaConfig.tiny(vocab_size=64, lora_rank=4,
                                          quantization="int8"))



def test_generator_merge_lora_folds_adapters():
    """MLLMGenerator(merge_lora=True) folds each adapter into its base in
    fp32 before the bf16 cast: no adapter is left, lora_rank is 0, and a
    merged weight equals W + (α/r)·B·A cast to bf16."""
    from mllm_npu_tpu_torch.models.generation.generate import MLLMGenerator
    from mllm_npu_tpu_torch.models.language_models.llama import LoRALinear
    from mllm_npu_tpu_torch.utils.testing import TinySpec, build_tiny_mllm
    tm, _, _ = build_tiny_mllm(TinySpec(), device="cpu",
                               llama_kw=dict(lora_rank=8))
    mod = tm.language_model.model.layers[0].self_attn.q_proj
    want = (mod.weight.float() + (mod.lora_B.weight.float()
                                  @ mod.lora_A.weight.float()) * mod.scale
            ).to(torch.bfloat16)
    gen = MLLMGenerator(tm, merge_lora=True)
    lm = gen.model.language_model
    assert not any(isinstance(m, LoRALinear) for m in lm.modules())
    assert gen.lm_config.lora_rank == 0 and gen.lm_config is lm.config
    got = lm.model.layers[0].self_attn.q_proj.weight
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
