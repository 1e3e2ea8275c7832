"""Tiny Llama with LoRA: the port against the JAX model with the same
weights (``llama_from_jax``). Prefill logits over a right-padded batch and
four cached decode steps agree to 1e-4 (fp32 on the CPU; the difference is
summation order through two layers and the vocab head)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_npu_tpu.models.language_models.llama import (
    LlamaConfig as JConfig, LlamaForCausalLM as JLlama, init_cache as j_cache)
from mllm_npu_tpu.ops import SegmentIds as JSeg
from mllm_npu_tpu_torch.models.language_models.llama import (
    LlamaConfig, LlamaForCausalLM, init_cache)
from mllm_npu_tpu_torch.ops import SegmentIds
from mllm_npu_tpu_torch.utils.weights import llama_from_jax

ATOL = 1e-4


def _with_nonzero_lora_b(tree, seed=3):
    """lora_b starts at zero in the reference; give it values so the
    adapter path is exercised."""
    rs = np.random.RandomState(seed)

    def fix(path, x):
        x = np.asarray(x)
        if path[-1].key == "lora_b":
            return rs.normal(0, 0.05, x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(fix, tree)


@pytest.fixture(scope="module")
def pair():
    kw = dict(lora_rank=8, rope_theta=500000.0)
    jcfg = JConfig.tiny(vocab_size=512, **kw)
    jm = JLlama(jcfg, dtype=jnp.float32)
    ids = jnp.ones((1, 8), jnp.int32)
    tree = _with_nonzero_lora_b(
        jm.init(jax.random.PRNGKey(0), ids)["params"])
    tm = LlamaForCausalLM(LlamaConfig.tiny(vocab_size=512, **kw),
                          dtype=torch.float32)
    tm.load_state_dict(llama_from_jax(tree), strict=True)
    return jm, {"params": tree}, jcfg, tm


@pytest.mark.parametrize("padded", [False, True])
def test_prefill_and_cached_decode_match(pair, padded):
    jm, params, jcfg, tm = pair
    B, Sp, steps = 2, 13, 4
    rs = np.random.RandomState(1)
    ids = rs.randint(3, 512, (B, Sp)).astype(np.int32)
    pm = np.ones((B, Sp), np.int32)
    if padded:
        pm[1, 9:] = 0
    row_len = pm.sum(-1)
    pos = np.clip(np.cumsum(pm, -1) - 1, 0, None).astype(np.int32)
    max_len = Sp + steps

    jc = j_cache(jcfg, B, max_len, dtype=jnp.float32)
    jl, _, jc = jm.apply(params, input_ids=jnp.asarray(ids), cache=jc,
                         positions=jnp.asarray(pos),
                         segment_ids=JSeg(q=jnp.asarray(pm),
                                          kv=jnp.asarray(pm)),
                         prefill=True)
    tc = init_cache(tm.config, B, max_len, dtype=torch.float32)
    seg = torch.from_numpy(pm)
    with torch.no_grad():
        h, tc = tm(torch.from_numpy(ids).long(),
                   positions=torch.from_numpy(pos).long(), cache=tc,
                   segment_ids=SegmentIds(q=seg, kv=seg), prefill=True)
        tl = tm.logits(h)
    real = pm.astype(bool)
    np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real],
                               atol=ATOL)

    valid = np.concatenate([real, np.ones((B, max_len - Sp), bool)], 1)
    am = valid[:, None, None, :]
    toks = rs.randint(3, 512, (steps, B, 1)).astype(np.int32)
    for t in range(steps):
        p = (row_len + t)[:, None].astype(np.int32)
        jl, _, jc = jm.apply(params, input_ids=jnp.asarray(toks[t]),
                             cache=jc, positions=jnp.asarray(p),
                             attn_mask=jnp.asarray(am))
        with torch.no_grad():
            h, tc = tm(torch.from_numpy(toks[t]).long(),
                       positions=torch.from_numpy(p).long(), cache=tc,
                       attn_mask=torch.from_numpy(am))
            tl = tm.logits(h)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert tc["pos"] == int(jc["pos"]) == Sp + steps
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               atol=ATOL)


def test_lora_changes_output(pair):
    """The adapters contribute (guards against a silently dropped
    adapter path)."""
    _, _, _, tm = pair
    ids = torch.arange(3, 11)[None]
    with torch.no_grad():
        a = tm.logits(tm(ids)[0])
        saved = {n: p.clone() for n, p in tm.named_parameters()
                 if "lora_B" in n}
        for n, p in tm.named_parameters():
            if "lora_B" in n:
                p.zero_()
        b = tm.logits(tm(ids)[0])
        for n, p in tm.named_parameters():
            if n in saved:
                p.copy_(saved[n])
    assert (a - b).abs().max() > 1e-3


def test_presets_match_reference():
    for name in ("llama3_8b", "llama2_13b", "tiny"):
        j, t = getattr(JConfig, name)(), getattr(LlamaConfig, name)()
        for f in ("vocab_size", "hidden_size", "intermediate_size",
                  "num_hidden_layers", "num_attention_heads",
                  "num_key_value_heads", "max_position_embeddings",
                  "rms_norm_eps", "rope_theta", "head_dim"):
            assert getattr(j, f) == getattr(t, f), (name, f)
