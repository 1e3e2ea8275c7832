"""The port's training path against the JAX package, on the CPU in fp32.

A tiny assembly (Llama with r4 LoRA on q/v, SigLIP, resampler) is
initialised by the JAX package and loaded into the port's training build
(``build_mllm(train=True)``) through ``from_jax_params``. One and two steps
of the port's ``make_train_step`` (AdamW, global-norm clip, cosine
schedule) are held against the reference's ``make_train_step`` with the
same batch and dropout 0: the loss within 1e-5, the trainable gradients
within 1e-5, the updated parameters and the Adam moments within 1e-4
(the two sum in other orders; Adam divides by √v, which amplifies fp32
noise in small gradients). The port's ``grad_norm`` is held against the
JAX norm over the trainable gradients (the reference logs the norm over
every gradient, frozen ones included; ROADMAP queue 3).

Then the step's behaviour, as the reference's tests hold it: gradient
accumulation equals the big batch, the packed loss equals the padded loss,
frozen parameters do not move, remat ``nothing``/``dots`` give the same
gradients as none (with LoRA dropout on), dropout is active only in
training, the schedules, the checkpoint round trip, and the CLI end to end
with an exact resume.
"""

import io
import json
import tarfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from mllm_npu_tpu.train.scheduler import get_scheduler as j_scheduler
from mllm_npu_tpu.train.train_state import OptimizerConfig as JOptConfig
from mllm_npu_tpu.train.train_state import create_train_state
from mllm_npu_tpu.train.train_state import make_train_step as j_make_step
from mllm_npu_tpu.utils.testing import TinySpec as JSpec
from mllm_npu_tpu.utils.testing import build_tiny_mllm as j_build
from mllm_npu_tpu.utils.testing import synthetic_batch
from mllm_npu_tpu_torch.models.language_models.llama import (
    LlamaConfig, LlamaForCausalLM, causal_lm_loss, chunked_causal_lm_loss,
    packed_positions, set_lora_dropout_seed)
from mllm_npu_tpu_torch.ops.flash_attention import FlashAttention
from mllm_npu_tpu_torch.train.checkpoint import CheckpointManager
from mllm_npu_tpu_torch.train.scheduler import get_scheduler
from mllm_npu_tpu_torch.train.train_state import (AdamW, OptimizerConfig,
                                                  compute_grads,
                                                  make_train_step,
                                                  trainable_parameters)
from mllm_npu_tpu_torch.train.train import batch_to_device, mllm_loss
from mllm_npu_tpu_torch.utils.testing import TinySpec, build_tiny_mllm
from mllm_npu_tpu_torch.utils.weights import from_jax_params

LLAMA_KW = dict(lora_rank=4, lora_alpha=8.0, lora_targets=("q_proj",
                                                           "v_proj"))
SPEC = JSpec(batch=2, seq=64)


def _nonzero_lora_b(tree, seed=3):
    """lora_b starts at zero in the reference; give it values so every
    adapter gets a gradient from the first step."""
    rs = np.random.RandomState(seed)

    def fix(path, x):
        if getattr(path[-1], "key", None) == "lora_b":
            return jnp.asarray(rs.normal(0, 0.05, np.shape(x)), jnp.float32)
        return x
    return jax.tree_util.tree_map_with_path(fix, tree)


@pytest.fixture(scope="module")
def reference():
    jm, _, _ = j_build(SPEC, llama_kw=LLAMA_KW)
    batch = synthetic_batch(SPEC, cmp_images=2)
    params = jm.init(jax.random.PRNGKey(0), **batch)
    params = {"params": _nonzero_lora_b(params["params"])}
    return jm, params, batch


def _port(params, **build_kw):
    tm, _, _ = build_tiny_mllm(TinySpec(), device="cpu", train=True,
                               llama_kw=LLAMA_KW, **build_kw)
    tm.load_state_dict(from_jax_params(jax.tree_util.tree_map(
        np.asarray, params["params"])), strict=True)
    tm.train()
    return tm


def _to_port(batch):
    return batch_to_device({k: np.asarray(v) for k, v in batch.items()},
                           "cpu")


def _jax_loss(jm):
    def loss_fn(p, b):
        out = jm.apply(p, **b)
        return out["total_loss"], {"lm_loss": out["lm_loss"]}
    return loss_fn


def _named(tree):
    """A JAX tree shaped like the params (grads, moments) → port names."""
    return {k: v.numpy() for k, v in from_jax_params(jax.tree_util.tree_map(
        np.asarray, tree)).items()}


def _adam_moments(opt_state, params):
    adam = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1

    def fill(m, p):
        return np.zeros(np.shape(p), np.float32) \
            if isinstance(m, optax.MaskedNode) else np.asarray(m, np.float32)
    is_masked = lambda x: isinstance(x, optax.MaskedNode)  # noqa: E731
    mu = jax.tree_util.tree_map(fill, adam[0].mu["params"],
                                params["params"], is_leaf=is_masked)
    nu = jax.tree_util.tree_map(fill, adam[0].nu["params"],
                                params["params"], is_leaf=is_masked)
    return _named(mu), _named(nu)


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_two_train_steps_match_reference(reference, mu_dtype):
    jm, params, batch = reference
    cfg = dict(lr=1e-3, warmup_steps=1, total_steps=10, mu_dtype=mu_dtype)
    jstate = create_train_state(params, JOptConfig(
        frozen_patterns=("vision_encoder", "/base/"), **cfg))
    jstep = jax.jit(j_make_step(_jax_loss(jm)))
    tm = _port(params)
    opt = AdamW(trainable_parameters(tm), OptimizerConfig(**cfg))
    tstep = make_train_step(tm, mllm_loss, opt)
    tbatch = _to_port(batch)
    trainable = {n for n, _ in trainable_parameters(tm)}
    assert trainable and not any(n.startswith("vision_encoder")
                                 for n in trainable)
    assert all(not n.endswith(("self_attn.q_proj.weight",
                               "self_attn.v_proj.weight"))
               for n in trainable)

    for step in range(2):
        jgrads = jax.grad(lambda p: _jax_loss(jm)(p, batch)[0])(
            jstate.params)
        jstate, jloss, jmetrics = jstep(jstate, batch)
        tloss, tmetrics = tstep([tbatch])
        assert abs(float(tloss) - float(jloss)) <= 1e-5, step
        jg = _named(jgrads["params"])
        got = dict(trainable_parameters(tm))
        norm = np.sqrt(sum(float((jg[n].astype(np.float64) ** 2).sum())
                           for n in trainable))
        assert abs(float(tmetrics["grad_norm"]) - norm) <= 1e-4 * norm
        for n in trainable:
            np.testing.assert_allclose(got[n].grad.numpy(), jg[n],
                                       atol=1e-5, err_msg=f"grad {n}")
        jp = _named(jstate.params["params"])
        for n, p in tm.named_parameters():
            np.testing.assert_allclose(p.detach().float().numpy(), jp[n],
                                       atol=1e-4, err_msg=f"param {n}")
        mu, nu = _adam_moments(jstate.opt_state, jstate.params)
        for n in trainable:
            np.testing.assert_allclose(opt.mu[n].float().numpy(), mu[n],
                                       atol=1e-4, err_msg=f"mu {n}")
            np.testing.assert_allclose(opt.nu[n].numpy(), nu[n], atol=1e-4,
                                       err_msg=f"nu {n}")
    assert opt.count == int(jstate.step) == 2


def test_grad_accumulation_equals_big_batch(reference):
    """Two micro-batches of B/2 give the loss and update of one batch of B
    (``tests/test_train_step.py:104``): the loss is a mean over supervised
    targets and both halves carry the same count."""
    _, params, batch = reference
    b = _to_port(batch)
    halves = []
    for i in range(2):
        h = {k: v[i:i + 1] for k, v in b.items()
             if k not in ("images", "embeds_cmp_mask", "embeds_gen_mask",
                          "patch_positions")}
        h.update(images=b["images"][i:i + 1],
                 embeds_cmp_mask=b["embeds_cmp_mask"][i:i + 1],
                 embeds_gen_mask=b["embeds_gen_mask"][i:i + 1],
                 patch_positions=b["patch_positions"][i:i + 1])
        halves.append(h)
    cfg = OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    out = []
    for micro in (halves, [b]):
        tm = _port(params)
        opt = AdamW(trainable_parameters(tm), cfg)
        loss, _ = make_train_step(tm, mllm_loss, opt)(micro)
        out.append((float(loss), {n: p.detach().clone()
                                  for n, p in tm.named_parameters()}))
    assert abs(out[0][0] - out[1][0]) < 2e-5
    for n, p in out[0][1].items():
        np.testing.assert_allclose(p.numpy(), out[1][1][n].numpy(),
                                   atol=1e-4, rtol=3e-5, err_msg=n)


def test_packed_matches_padded_loss(reference):
    """pack_samples + segment-id attention + per-segment positions give the
    padded batch's loss (``tests/test_train_step.py:152``)."""
    from mllm_npu_tpu_torch.data.utils import collate_static, pack_samples
    _, params, _ = reference
    tm = _port(params)
    rs = np.random.RandomState(3)
    H, nq = 56, 4
    samples = []
    for _ in range(4):
        L = int(rs.randint(24, 30))
        ids = rs.randint(10, 4096, (L,)).astype(np.int32)
        labels = ids.copy()
        cmp_mask = np.zeros((L,), bool)
        cmp_mask[2:2 + nq] = True
        labels[2:2 + nq] = -100
        samples.append({
            "input_ids": ids, "attention_mask": np.ones((L,), np.int32),
            "labels": labels, "ids_cmp_mask": cmp_mask,
            "ids_gen_mask": np.zeros((L,), bool),
            "images": rs.randn(1, H, H, 3).astype(np.float32),
            "embeds_cmp_mask": np.array([True]),
            "embeds_gen_mask": np.array([False]),
            "patch_position": rs.rand(1, 2).astype(np.float32)})
    padded = collate_static(samples, max_length=64, max_images=4,
                            image_size=H, pad_token_id=0)
    packed = pack_samples(samples, max_length=64, max_rows=2, max_images=4,
                          image_size=H)
    assert int((packed["attention_mask"] > 0).sum()) == \
        int(padded["attention_mask"].sum())
    with torch.no_grad():
        lp = float(tm(**batch_to_device(padded, "cpu"))["lm_loss"])
        lk = float(tm(**batch_to_device(packed, "cpu"))["lm_loss"])
    assert abs(lp - lk) < 2e-5, (lp, lk)


def test_frozen_params_unchanged_after_step(reference):
    """The vision tower and every LoRA base keep their values and hold no
    gradient or optimizer state (``tests/test_train_step.py:207``)."""
    _, params, batch = reference
    tm = _port(params)
    frozen = {n: p.detach().clone() for n, p in tm.named_parameters()
              if not p.requires_grad}
    assert any(n.startswith("vision_encoder.") for n in frozen)
    assert any(n.endswith("q_proj.weight") for n in frozen)
    lm_before = tm.language_model.model.layers[0].mlp.gate_proj.weight \
        .detach().clone()
    opt = AdamW(trainable_parameters(tm), OptimizerConfig(warmup_steps=0))
    make_train_step(tm, mllm_loss, opt)([_to_port(batch)])
    for n, p in tm.named_parameters():
        if n in frozen:
            assert torch.equal(p, frozen[n]), n
            assert p.grad is None and n not in opt.mu
    # gate_proj carries no adapter here, so it trains (the reference's
    # mask freezes only the LoRA bases)
    assert (tm.language_model.model.layers[0].mlp.gate_proj.weight
            - lm_before).abs().max() > 0


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_gives_the_same_grads(reference, policy):
    """Per-layer checkpointing (with LoRA dropout on, so the replay must
    draw the same masks) gives the gradients of no checkpointing, and runs
    the flash forward twice per layer."""
    _, params, batch = reference
    b = _to_port(batch)
    grads = {}
    for remat in (False, True):
        kw = dict(LLAMA_KW, lora_dropout=0.3, remat=remat,
                  remat_policy=policy)
        tm, _, _ = build_tiny_mllm(TinySpec(), device="cpu", train=True,
                                   llama_kw=kw)
        tm.load_state_dict(from_jax_params(jax.tree_util.tree_map(
            np.asarray, params["params"])), strict=True)
        tm.train()
        set_lora_dropout_seed(tm, 1234)
        calls = []
        orig = FlashAttention.forward

        def counting(ctx, *a, orig=orig):
            calls.append(1)
            return orig(ctx, *a)
        FlashAttention.forward = staticmethod(counting)
        try:
            compute_grads(tm, mllm_loss, [b])
        finally:
            FlashAttention.forward = staticmethod(orig)
        n_layers = tm.language_model.config.num_hidden_layers
        # the resampler once, each Llama layer once (twice under remat)
        assert len(calls) == 1 + n_layers * (2 if remat else 1)
        grads[remat] = {n: p.grad.clone()
                        for n, p in trainable_parameters(tm)}
    for n, g in grads[False].items():
        np.testing.assert_allclose(grads[True][n].numpy(), g.numpy(),
                                   atol=1e-6, err_msg=n)


def test_lora_dropout_active_only_in_training():
    """Dropout changes the output only with a seed set and in training
    mode, is deterministic for a seed, and differs between seeds
    (``tests/test_llama.py:92``)."""
    cfg = LlamaConfig.tiny(lora_rank=4, lora_alpha=8.0, lora_dropout=0.5,
                           lora_targets=("q_proj",))
    torch.manual_seed(0)
    m = LlamaForCausalLM(cfg, dtype=torch.float32)
    for p in m.parameters():
        torch.nn.init.normal_(p, std=0.05)
    ids = torch.randint(0, cfg.vocab_size, (1, 8))
    with torch.no_grad():
        det = m(ids)[0]
        set_lora_dropout_seed(m, 7)
        a, b = m(ids)[0], m(ids)[0]
        set_lora_dropout_seed(m, 8)
        c = m(ids)[0]
        m.eval()
        e = m(ids)[0]
    assert torch.equal(a, b) and not torch.equal(a, det)
    assert not torch.equal(a, c) and torch.equal(e, det)


def test_dropout_rate():
    from mllm_npu_tpu_torch.models.language_models.llama import LoRALinear
    lin = LoRALinear(64, 64, 4, 8.0, torch.float32, dropout=0.25)
    lin.dropout_seed = 5
    x = torch.ones(64, 64, 64)
    kept = (lin._dropout(x) != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.01
    assert torch.allclose(lin._dropout(x)[lin._dropout(x) != 0],
                          torch.tensor(1 / 0.75))


@pytest.mark.parametrize("name", ["constant", "constant_with_warmup",
                                  "linear", "cosine"])
def test_schedules_match_reference(name):
    kw = dict(base_lr=3e-4, warmup_steps=10, total_steps=100,
              min_lr_ratio=0.05)
    ours, ref = get_scheduler(name, **kw), j_scheduler(name, **kw)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        # the reference's schedules run in fp32: 1e-6 of the base rate
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6,
                                   atol=1e-6 * kw["base_lr"],
                                   err_msg=f"{name} @ {step}")


def test_packed_positions_and_losses():
    seg = torch.tensor([[1, 1, 1, 2, 2, 0, 0], [1, 1, 1, 1, 1, 1, 1]])
    assert packed_positions(seg).tolist() == [[0, 1, 2, 0, 1, 0, 1],
                                              list(range(7))]
    g = torch.Generator().manual_seed(0)
    h = torch.randn(2, 13, 16, generator=g)
    w = torch.randn(50, 16, generator=g)
    labels = torch.randint(0, 50, (2, 13), generator=g)
    labels[0, 5:] = -100
    dense = causal_lm_loss(h @ w.t(), labels)
    for chunk in (1, 4, 12, 64):
        chunked = chunked_causal_lm_loss(h, w, labels, chunk=chunk,
                                         compute_dtype=torch.float32)
        assert abs(float(dense) - float(chunked)) < 1e-5


def test_chunked_loss_matches_dense_through_the_model(reference):
    """``ce_loss_chunk`` gives the dense loss and gradients."""
    _, params, batch = reference
    b = _to_port(batch)
    out = []
    for chunk in (0, 16):
        tm = _port(params, ce_loss_chunk=chunk)
        loss, _ = compute_grads(tm, mllm_loss, [b])
        out.append((float(loss), {n: p.grad for n, p in
                                  trainable_parameters(tm)}))
    assert abs(out[0][0] - out[1][0]) < 1e-5
    for n, g in out[0][1].items():
        np.testing.assert_allclose(out[1][1][n].numpy(), g.numpy(),
                                   atol=1e-5, err_msg=n)


def test_checkpoint_round_trip_is_exact(reference, tmp_path):
    _, params, batch = reference
    tm = _port(params)
    cfg = OptimizerConfig(lr=1e-3, warmup_steps=0, mu_dtype="bfloat16")
    opt = AdamW(trainable_parameters(tm), cfg)
    make_train_step(tm, mllm_loss, opt)([_to_port(batch)])
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3):
        mgr.save(step, tm, opt, data_state={"steps": step, "pipe": None})
    assert mgr.steps() == [2, 3]
    tm2 = _port(params)
    opt2 = AdamW(trainable_parameters(tm2), cfg)
    data, step = mgr.restore(tm2, opt2)
    assert step == 3 and data == {"steps": 3, "pipe": None}
    for (n, a), (_, b) in zip(tm.named_parameters(), tm2.named_parameters()):
        assert torch.equal(a, b), n
    assert opt2.count == opt.count
    for n in opt.mu:
        assert torch.equal(opt.mu[n], opt2.mu[n])
        assert opt2.mu[n].dtype == torch.bfloat16
        assert torch.equal(opt.nu[n], opt2.nu[n])


# ---- CLI end to end ------------------------------------------------------

MODEL_YAML = """
mllm:
  mllm_model:
    _target_: mllm_npu_tpu_torch.models.factory.build_mllm
    freeze_vision_encoder: true
    lm_loss_scale: 1.0
    add_patch_pos: true
    vision_encoder:
      _target_: mllm_npu_tpu_torch.models.factory.build_siglip
    projector:
      _target_: mllm_npu_tpu_torch.models.factory.build_attention_resampler
      grid_size: 2
      embed_dim: 128
      num_heads: 4
      kv_dim: 64
  language_model:
    _target_: mllm_npu_tpu_torch.models.factory.get_peft_model_with_resize_embedding
    vocab_size: 4096
    peft_config:
      _target_: mllm_npu_tpu_torch.configs.passthrough_dict
      r: 4
      lora_alpha: 8
      lora_dropout: 0.05
      target_modules: [q_proj, v_proj]
    model:
      _target_: mllm_npu_tpu_torch.models.factory.build_llama3
  processor:
    _target_: mllm_npu_tpu_torch.data.processor.init_processor
    processor_json: {proc_json}
"""

DATA_YAML = """
_target_: mllm_npu_tpu_torch.data.datapipes.build_multi_datapipes
_recursive_: False
datapipes:
  - _target_: mllm_npu_tpu_torch.data.tasks.image_caption.build_caption_datapipes_with_pixels
    data_dir: {data_dir}
    max_length: 96
    batch_size: 4
    similarity_thr: 0.2
    min_resolution: 100
    num_img_in_tokens: 4
    num_img_out_tokens: 4
    img_first_ratio: 1.0
    cycle_count: 200
    multi_resolution: True
    resolution_grids: ["1x1"]
    base_resolution: 448
    dataset_name: test
    shard_for_host: False
sample_weights: [1.0]
"""


def _make_caption_tar(path: Path, n=12):
    with tarfile.open(path, "w") as tar:
        for i in range(n):
            buf = io.BytesIO()
            Image.new("RGB", (500, 500), (i * 10 % 255, 20, 30)).save(
                buf, format="JPEG")
            for ext, data in ((".txt", f"an image number {i}".encode()),
                              (".jpg", buf.getvalue()),
                              (".json",
                               json.dumps({"similarity": .9}).encode())):
                info = tarfile.TarInfo(f"s{i:04d}{ext}")
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))


@pytest.fixture
def cli_files(tmp_path, monkeypatch):
    monkeypatch.setenv("DEBUG_FLAG", "True")
    import mllm_npu_tpu_torch.train.trackers as trackers
    # TensorBoard is optional; keep it (and TensorFlow) out of the test
    monkeypatch.setattr(trackers, "build_trackers",
                        lambda out, cfg: trackers.Trackers(out, cfg, tb=False))
    _make_caption_tar(tmp_path / "shard-000.tar")
    proc_json = tmp_path / "proc.json"
    proc_json.write_text(json.dumps({
        "size": {"height": 56, "width": 56}, "do_normalize": True,
        "image_mean": [0.5, 0.5, 0.5], "image_std": [0.5, 0.5, 0.5]}))
    model_yaml = tmp_path / "model.yaml"
    model_yaml.write_text(MODEL_YAML.format(proc_json=proc_json))
    data_yaml = tmp_path / "data.yaml"
    data_yaml.write_text(DATA_YAML.format(data_dir=tmp_path))
    return tmp_path, model_yaml, data_yaml


def _argv(model_yaml, data_yaml, out, steps, save):
    return ["--model", str(model_yaml), "--train_dataset", str(data_yaml),
            "--output_dir", str(out), "--max_steps", str(steps),
            "--save_steps", str(save), "--log_steps", "1",
            "--warmup_steps", "0", "--learning_rate", "1e-3",
            "--fake_tokenizer", "--device", "cpu",
            # a schedule that does not depend on --max_steps, so the
            # interrupted and the uninterrupted runs share it
            "--lr_scheduler_type", "constant_with_warmup"]


def test_train_cli_end_to_end_and_exact_resume(cli_files):
    """Steps, a checkpoint, the JSONL metrics, then a resume to more steps
    with the losses of an uninterrupted run (``tests/test_train_cli.py:86``;
    the resume is exact because the data position and the optimizer state
    are restored and dropout seeds follow the step)."""
    from mllm_npu_tpu_torch.train.train import main
    tmp, model_yaml, data_yaml = cli_files
    full = main(_argv(model_yaml, data_yaml, tmp / "full", 4, 100))
    assert [r["step"] for r in full.records] == [1, 2, 3, 4]

    out = tmp / "out"
    run = main(_argv(model_yaml, data_yaml, out, 2, 2))
    assert sorted(p.name for p in out.glob("checkpoint_*")) == \
        ["checkpoint_2"]
    runs = [json.loads(x) for x in
            (out / "wandb" / "metrics.jsonl").read_text().splitlines()]
    assert len(runs) == 2 and all({"loss", "lr", "grad_norm"} <= set(r)
                                  for r in runs)
    cfg = json.loads((out / "wandb" / "config.json").read_text())
    assert cfg["learning_rate"] == 1e-3 and cfg["device"] == "cpu"
    assert all(np.isfinite(r["loss"]) for r in run.records)

    resumed = main(_argv(model_yaml, data_yaml, out, 4, 100))
    assert [r["step"] for r in resumed.records] == [3, 4]
    for a, b in zip(resumed.records, full.records[2:]):
        assert abs(a["loss"] - b["loss"]) < 1e-5, (a, b)
    for (n, a), (_, b) in zip(resumed.model.named_parameters(),
                              full.model.named_parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=n)


def test_train_cli_refuses_what_is_not_ported(cli_files):
    from mllm_npu_tpu_torch.train.train import main
    tmp, model_yaml, data_yaml = cli_files
    base = _argv(model_yaml, data_yaml, tmp / "x", 1, 1)
    orbax = tmp / "orbax" / "checkpoint_0"     # the JAX package's layout
    orbax.mkdir(parents=True)
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    for extra in (["--mesh_fsdp", "2"],
                  ["--params_checkpoint", str(orbax.parent)],
                  ["--dataloader_workers", "2"]):
        with pytest.raises(NotImplementedError):
            main(base + extra)
    with pytest.raises(ValueError, match="int8 or int4"):
        main(base + ["--quantize_base", "int2"])


def test_train_cli_raises_without_gpu(cli_files, monkeypatch):
    """The trainer runs on ``cuda`` unless asked for the CPU."""
    from mllm_npu_tpu_torch.train.train import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tmp, model_yaml, data_yaml = cli_files
    argv = _argv(model_yaml, data_yaml, tmp / "g", 1, 1)
    argv = argv[:argv.index("--device")] + argv[argv.index("--device") + 2:]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
