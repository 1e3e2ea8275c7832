"""SEED's training step and QLoRA in the port against the JAX package, on
the CPU in fp32 at tiny widths (the Qwen-ViT tower with its attention
pool, both resamplers, a Llama with r4 LoRA on all seven projections),
weights initialised by the JAX package and carried across by
``from_jax_params``:

- one step's losses (total, lm, rec; cosine and MSE, ``vit_down``) on a
  batch that mixes the comprehension and the generation branch, and every
  trainable gradient; the trainable set is the reference's mask, name for
  name; with the Llama's bases quantized (int8, int4: a JAX QLoRA tree
  loaded as it is) the same;
- ``QuantMatmul``'s dx against ``jax.vjp`` of the reference's
  ``quant_matmul`` (Pallas kernel in interpret mode forward), and a tiny
  QLoRA Llama's loss and LoRA gradients, the port's own quantization of
  the float base giving the reference's buffers byte for byte.

Tolerances: losses 1e-5 absolute (means of fp32 values summed in other
orders); gradients 1e-4 of the tensor's largest |value| (fp32 sums in
other orders through the backward of a few layers); dx 1e-5 of its
largest |value|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_npu_tpu.models.language_models.llama import (
    LlamaConfig as JLlamaConfig, LlamaForCausalLM as JLlama,
    causal_lm_loss as j_causal_lm_loss, lora_frozen_patterns)
from mllm_npu_tpu.models.mllm import SEED as JSEED
from mllm_npu_tpu.models.multimodal_encoder import qwenvl_vit as jq
from mllm_npu_tpu.models.multimodal_projector.attention_resampler import (
    AttentionResampler as JResampler)
from mllm_npu_tpu.ops import quant as jquant
from mllm_npu_tpu.train.train_state import trainable_mask
from mllm_npu_tpu.utils.testing import TinySpec as JSpec
from mllm_npu_tpu.utils.testing import synthetic_batch
from mllm_npu_tpu.utils.weights import quantize_llama_params
from mllm_npu_tpu_torch.models.language_models.llama import (
    LlamaConfig, LlamaForCausalLM, causal_lm_loss)
from mllm_npu_tpu_torch.ops import quant as tq
from mllm_npu_tpu_torch.train.train import batch_to_device, mllm_loss
from mllm_npu_tpu_torch.utils.testing import TinySpec, build_tiny_mllm
from mllm_npu_tpu_torch.utils.weights import (from_jax_params,
                                              llama_from_jax,
                                              quantize_llama_)

LOSS_ATOL = 1e-5
GRAD_REL = 1e-4
LLAMA_KW = dict(lora_rank=4, lora_alpha=8.0)
SPEC = JSpec(batch=2, seq=64, max_images=3, image_size=56, nq=4)
GROUP = 64


def _nonzero_lora_b(tree, seed=3):
    """lora_b starts at zero in the reference; give it values so every
    adapter passes a gradient to its lora_a."""
    rs = np.random.RandomState(seed)

    def fix(path, x):
        if getattr(path[-1], "key", None) == "lora_b":
            return jnp.asarray(rs.normal(0, 0.05, np.shape(x)), jnp.float32)
        return x
    return jax.tree_util.tree_map_with_path(fix, tree)


def _floating(x) -> bool:
    return jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating)


def _named(tree) -> dict:
    """A JAX tree shaped like the params → port names (integer leaves, and
    JAX's float0 gradients of them, as int8 zeros)."""
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x) if _floating(x)
        else np.zeros(np.shape(x), np.int8), tree)
    return {k: v.numpy() for k, v in from_jax_params(tree).items()}


def _j_seed(mse: bool, quant: str):
    """The reference's tiny SEED-X (Qwen tower, LoRA Llama, both
    resamplers) and its params; with ``quant`` the Llama's float base
    quantized by ``quantize_llama_params`` (the reference trainer's
    ``--quantize_base``)."""
    lm_cfg = JLlamaConfig.tiny(vocab_size=SPEC.vocab, **LLAMA_KW)
    vis_cfg = jq.QwenViTConfig.tiny(image_size=SPEC.image_size)
    H, W = lm_cfg.hidden_size, vis_cfg.output_dim

    def seed(cfg):
        return JSEED(
            language_model=JLlama(cfg, dtype=jnp.float32),
            vision_encoder=jq.VisionTransformerWithAttnPool(vis_cfg),
            projector=JResampler(grid_size=2, embed_dim=H, num_heads=4,
                                 kv_dim=W, dtype=jnp.float32),
            output_projector=JResampler(grid_size=2, embed_dim=W,
                                        num_heads=4, kv_dim=H,
                                        dtype=jnp.float32),
            freeze_vision_encoder=True, lm_loss_scale=1.0,
            add_patch_pos=True, patch_pos_dim=H, rec_loss_scale=3.0,
            vit_down=True, mse=mse, num_img_out_tokens=SPEC.nq)
    batch = synthetic_batch(SPEC, cmp_images=2, gen_images=1, rng=5)
    fm = seed(lm_cfg)
    params = jax.jit(fm.init)(jax.random.PRNGKey(0), **batch)
    params = {"params": _nonzero_lora_b(params["params"])}
    if not quant:
        return fm, params, batch
    bits = int(quant[3:])
    qcfg = JLlamaConfig.tiny(vocab_size=SPEC.vocab, quantization=quant,
                             quant_group_size=GROUP, **LLAMA_KW)
    p = dict(params["params"])
    p["language_model"] = quantize_llama_params(p["language_model"],
                                                bits=bits, group_size=GROUP)
    return seed(qcfg), {"params": p}, batch


@pytest.mark.parametrize("quant", ["", "int8", "int4"],
                         ids=["bf16_recipe", "qlora_int8", "qlora_int4"])
@pytest.mark.parametrize("mse", [False, True], ids=["cosine", "mse"])
def test_seed_train_step_matches_reference(mse, quant):
    jm, params, batch = _j_seed(mse, quant)

    def loss(p):
        out = jm.apply(p, **batch)
        return out["total_loss"], out
    grads, ref = jax.grad(loss, has_aux=True, allow_int=True)(params)

    llama_kw = dict(LLAMA_KW)
    if quant:
        llama_kw.update(quantization=quant, quant_group_size=GROUP)
    tm, _, _ = build_tiny_mllm(TinySpec(), device="cpu", seed_x=True,
                               tower="qwen", train=True, llama_kw=llama_kw)
    tm.mse = mse
    tm.rec_loss_scale = 3.0
    tm.load_state_dict(from_jax_params(jax.tree_util.tree_map(
        np.asarray, params["params"])), strict=True)
    tm.train()
    tb = batch_to_device({k: np.asarray(v) for k, v in batch.items()},
                         "cpu")
    total, metrics = mllm_loss(tm, tb)
    total.backward()

    assert set(metrics) == {"lm_loss", "rec_loss"}
    assert float(metrics["rec_loss"].detach()) > 0
    for key, got in (("total_loss", total), ("lm_loss", metrics["lm_loss"]),
                     ("rec_loss", metrics["rec_loss"])):
        np.testing.assert_allclose(float(got.detach()), float(ref[key]),
                                   atol=LOSS_ATOL, rtol=0, err_msg=key)

    # the trainable set: the reference's mask (vision tower and every
    # LoRA base frozen), name for name; a quantized lm_head's float scale
    # is a leaf the reference's mask leaves trainable (its gradient is 0),
    # a frozen buffer here
    frozen = ("vision_encoder",) + lora_frozen_patterns()
    mask = trainable_mask(params, frozen)
    ones = _named(jax.tree_util.tree_map(
        lambda m, p: np.full(np.shape(p), float(m), np.float32),
        mask, params)["params"])
    want = {k for k, v in ones.items() if v.size and (v == 1).all()}
    if quant:
        want -= {"language_model.lm_head.scale",
                 "language_model.lm_head.scale_g"}
    got = {n for n, p in tm.named_parameters() if p.requires_grad}
    assert got == want

    jg = _named(grads["params"])
    for name, p in tm.named_parameters():
        if not p.requires_grad:
            assert p.grad is None, name
            continue
        ref_g = jg[name]
        bound = GRAD_REL * max(np.abs(ref_g).max(), 1e-12)
        assert np.abs(p.grad.numpy() - ref_g).max() <= bound, name


@pytest.mark.parametrize("bits,G", [(8, None), (4, 64), (4, 128)])
def test_quant_matmul_grad_matches_reference_vjp(bits, G):
    """``QuantMatmul``: the forward and dx against ``jax.vjp`` of the
    reference's ``quant_matmul`` on the same quantized weight; no
    gradient for the values and scales."""
    rs = np.random.RandomState(bits)
    M, K, N = 37, 256, 96
    x = rs.randn(M, K).astype(np.float32)
    g = rs.randn(M, N).astype(np.float32)
    w = (rs.randn(K, N) * 0.05).astype(np.float32)      # reference [K, N]
    if bits == 8:
        jqt = jquant.quantize_int8(jnp.asarray(w))
        tqt = tq.quantize_int8(torch.from_numpy(w.T.copy()))
    else:
        jqt = jquant.quantize_int4(jnp.asarray(w), group_size=G)
        tqt = tq.quantize_int4(torch.from_numpy(w.T.copy()), G)
    y, vjp = jax.vjp(lambda a: jquant.quant_matmul(
        a, jqt.values, jqt.scale, None, bits, True), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    values, scale = tqt.values, tqt.scale.requires_grad_()
    out = tq.quant_matmul(xt, values, scale, bits)
    out.backward(torch.from_numpy(g))
    for got, ref in ((out.detach().numpy(), np.asarray(y)),
                     (xt.grad.numpy(), np.asarray(jdx))):
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    assert scale.grad is None


@pytest.mark.parametrize("bits", [8, 4])
def test_qlora_llama_matches_reference(bits):
    """A tiny QLoRA Llama: the port quantizes the float base in place
    (``quantize_llama_(keep_lora=True)``, the trainer's
    ``--quantize_base``) into the reference's ``quantize_llama_params``
    buffers byte for byte; the loss and every LoRA gradient match the
    reference's through its quantized product's VJP."""
    quant = f"int{bits}"
    jf = JLlama(JLlamaConfig.tiny(vocab_size=512, **LLAMA_KW),
                dtype=jnp.float32)
    rs = np.random.RandomState(0)
    ids = rs.randint(3, 512, (2, 40)).astype(np.int32)
    fparams = jf.init(jax.random.PRNGKey(1), jnp.asarray(ids))["params"]
    fparams = _nonzero_lora_b(fparams)
    qparams = quantize_llama_params(fparams, bits=bits, group_size=GROUP)
    jm = JLlama(JLlamaConfig.tiny(vocab_size=512, quantization=quant,
                                  quant_group_size=GROUP, **LLAMA_KW),
                dtype=jnp.float32)

    def loss(p):
        logits, _, _ = jm.apply({"params": p}, jnp.asarray(ids))
        return j_causal_lm_loss(logits, jnp.asarray(ids))
    jloss, jgrads = jax.value_and_grad(loss, allow_int=True)(qparams)

    tm = LlamaForCausalLM(LlamaConfig.tiny(vocab_size=512, **LLAMA_KW),
                          dtype=torch.float32)
    tm.load_state_dict(llama_from_jax(jax.tree_util.tree_map(
        np.asarray, fparams)), strict=True)
    quantize_llama_(tm, bits=bits, group_size=GROUP, keep_lora=True)
    want = llama_from_jax(jax.tree_util.tree_map(np.asarray, qparams))
    got = tm.state_dict()
    assert sorted(got) == sorted(want)
    for name, t in want.items():
        np.testing.assert_array_equal(got[name].numpy(), t.numpy(), name)

    for p in tm.parameters():
        p.requires_grad_(False)
    lora = {n: p for n, p in tm.named_parameters() if "lora_" in n}
    for p in lora.values():
        p.requires_grad_(True)
    tids = torch.from_numpy(ids).long()
    h, _ = tm(tids)
    tloss = causal_lm_loss(tm.logits(h), tids)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               atol=LOSS_ATOL,
                               rtol=0)
    jg = {k: v.numpy() for k, v in llama_from_jax(jax.tree_util.tree_map(
        lambda x: np.asarray(x) if _floating(x)
        else np.zeros(np.shape(x), np.int8), jgrads)).items()}
    assert len(lora) == 2 * 7 * 2
    for name, p in lora.items():
        bound = GRAD_REL * np.abs(jg[name]).max()
        assert np.abs(p.grad.numpy() - jg[name]).max() <= bound, name


# ---- the trainer on the SEED-X recipe, tiny ------------------------------

SEED_YAML = """
mllm:
  mllm_model:
    _target_: mllm_npu_tpu_torch.models.factory.build_seed
    freeze_vision_encoder: true
    lm_loss_scale: 1.0
    rec_loss_scale: 3.0
    add_patch_pos: true
    vit_down: true
    mse: true
    vision_encoder:
      _target_: mllm_npu_tpu_torch.models.factory.build_qwen_vit
    projector:
      _target_: mllm_npu_tpu_torch.models.factory.build_attention_resampler
      grid_size: 8
      embed_dim: 5120
      num_heads: 32
      kv_dim: 4096
    output_projector:
      _target_: mllm_npu_tpu_torch.models.factory.build_attention_resampler
      grid_size: 8
      embed_dim: 4096
      num_heads: 32
      kv_dim: 5120
  language_model:
    _target_: mllm_npu_tpu_torch.models.factory.get_peft_model_with_resize_embedding
    vocab_size: 4096
    peft_config:
      _target_: mllm_npu_tpu_torch.configs.passthrough_dict
      r: 4
      lora_alpha: 8
      lora_dropout: 0.0
      target_modules: [q_proj, v_proj, k_proj, o_proj, gate_proj, down_proj, up_proj]
    model:
      _target_: mllm_npu_tpu_torch.models.factory.build_llama2
  processor:
    _target_: mllm_npu_tpu_torch.data.processor.init_processor
    processor_json: {proc_json}
"""


@pytest.fixture
def seed_files(tmp_path, monkeypatch):
    """A tiny SEED YAML (``DEBUG_FLAG``: the builders' tiny configs) and
    the port's ``pretrain_data.yaml`` pointed at seeded caption tars and
    OCR jsonl, its lengths, batch sizes and image tokens cut."""
    import json

    import yaml

    from mllm_npu_tpu_torch.configs import load_config
    from test_torch_ocr import make_caption_tars, make_ocr_data

    monkeypatch.setenv("DEBUG_FLAG", "True")
    import mllm_npu_tpu_torch.train.trackers as trackers
    monkeypatch.setattr(trackers, "build_trackers",
                        lambda out, cfg: trackers.Trackers(out, cfg, tb=False))
    proc_json = tmp_path / "proc.json"
    proc_json.write_text(json.dumps({
        "size": {"height": 56, "width": 56}, "do_normalize": True,
        "image_mean": [0.5, 0.5, 0.5], "image_std": [0.5, 0.5, 0.5]}))
    model_yaml = tmp_path / "seed.yaml"
    model_yaml.write_text(SEED_YAML.format(proc_json=proc_json))
    jdir, idir = make_ocr_data(tmp_path / "ocr", n=6)
    tars = make_caption_tars(tmp_path / "tars", n=8)
    cfg = load_config("mllm_npu_tpu_torch/configs/dataset/pretrain_data.yaml")
    for node in cfg["datapipes"]:
        node.update(max_length=160, batch_size=2, num_img_in_tokens=4,
                    num_img_out_tokens=4, cycle_count=100,
                    resolution_grids=["1x1", "1x2", "2x1"],
                    shard_for_host=False)
        if node["_target_"].endswith("build_ocr_datapipes_caption"):
            node.update(data_dir=str(jdir), image_dir=str(idir))
        else:
            node.update(data_dir=[str(tars)])
    data_yaml = tmp_path / "data.yaml"
    data_yaml.write_text(yaml.safe_dump(cfg))
    return tmp_path, model_yaml, data_yaml


def _seed_argv(model_yaml, data_yaml, out, steps, save, lr="1e-3",
               quant=""):
    return (["--model", str(model_yaml), "--train_dataset", str(data_yaml),
             "--output_dir", str(out), "--max_steps", str(steps),
             "--save_steps", str(save), "--log_steps", "1",
             "--warmup_steps", "0", "--learning_rate", lr,
             "--fake_tokenizer", "--device", "cpu",
             "--lr_scheduler_type", "constant_with_warmup"]
            + (["--quantize_base", quant, "--quant_group_size", "64"]
               if quant else []))


def test_trainer_logs_every_loss_term(seed_files):
    """The log carries every loss term the model returns, as the
    reference's: SEED's ``rec_loss`` in the records and ``metrics.jsonl``,
    equal to the model's on the step's batch (lr 0: the step changes no
    weight)."""
    import json

    from mllm_npu_tpu_torch.train.train import main
    tmp, model_yaml, data_yaml = seed_files
    out = tmp / "lr0"
    run = main(_seed_argv(model_yaml, data_yaml, out, 3, 100, lr="0.0"))
    runs = [json.loads(x) for x in
            (out / "wandb" / "metrics.jsonl").read_text().splitlines()]
    assert len(runs) == 3
    assert all({"loss", "lm_loss", "rec_loss", "grad_norm"} <= set(r)
               for r in runs)
    assert any(r["rec_loss"] > 0 for r in runs)
    with torch.no_grad():
        want = run.model(**run.last_batches[0])
    for key in ("rec_loss", "lm_loss"):
        assert runs[-1][key] == pytest.approx(float(want[key]), abs=1e-6)
        assert run.records[-1][key] == runs[-1][key]
    assert runs[-1]["loss"] == pytest.approx(float(want["total_loss"]),
                                             abs=1e-6)


@pytest.mark.parametrize("quant", ["", "int4"], ids=["float", "qlora_int4"])
def test_seed_trainer_on_the_mixture_and_exact_resume(seed_files, quant):
    """``train.main`` on the SEED-X YAML over the pretrain mixture (both
    entries run), bf16-recipe layout or int4 QLoRA: the loss falls,
    ``rec_loss`` is logged, and a resume from a checkpoint continues with
    an uninterrupted run's losses and weights."""
    from mllm_npu_tpu_torch.ops.quant import Int4Linear
    from mllm_npu_tpu_torch.train.train import main
    tmp, model_yaml, data_yaml = seed_files
    kinds = []
    full = main(_seed_argv(model_yaml, data_yaml, tmp / "full", 6, 100,
                           quant=quant),
                on_step=lambda rec: kinds.extend(rec["datasets"]))
    assert set(kinds) == {"laion-coco", "llavar-ocr"}, kinds
    losses = [r["loss"] for r in full.records]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert all("rec_loss" in r for r in full.records)
    head = full.model.language_model.lm_head
    assert isinstance(head, Int4Linear) == bool(quant)

    out = tmp / "out"
    main(_seed_argv(model_yaml, data_yaml, out, 3, 3, quant=quant))
    resumed = main(_seed_argv(model_yaml, data_yaml, out, 6, 100,
                              quant=quant))
    assert [r["step"] for r in resumed.records] == [4, 5, 6]
    for a, b in zip(resumed.records, full.records[3:]):
        assert abs(a["loss"] - b["loss"]) < 1e-5, (a, b)
        assert abs(a["rec_loss"] - b["rec_loss"]) < 1e-5, (a, b)
    for (n, a), (_, b) in zip(resumed.model.named_parameters(),
                              full.model.named_parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=n)
