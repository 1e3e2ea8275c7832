"""Whole assemblies from the reference's checkpoint layouts, through the
port's builders and through the reference's (``mllm_npu_tpu/models/
factory.py`` and ``init_assembly_params``) on the same files: an HF Llama
directory at its base vocabulary, an HF SigLIP directory or a
``qwen_vit_G.pt``-style tower, and a peft-wrapped assembly
``pytorch_model.bin`` over them. Both sides run outside ``DEBUG_FLAG``
with the full-width configs pointed at the tiny ones.

Also: the reference's skip of the 8B embeddings (the port resizes them),
the refusals (a missing path, an unknown or a missing key, a shape that
differs; an assembly entry of another shape skipped and counted), the
converter and ``--params_checkpoint`` (worker and evaluator, both
flavours), and training over a loaded base resumed in a new process."""

import base64
import io
import json
import logging
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.torch as st
import torch
from PIL import Image

from mllm_npu_tpu.data.processor import ImageProcessor as JProc
from mllm_npu_tpu.models import factory as jfactory
from mllm_npu_tpu.models.multimodal_encoder.qwenvl_vit import (
    QwenViTConfig as JQwenCfg, VisionTransformerWithAttnPool as JQwen)
from mllm_npu_tpu.serve.engine import InferenceEngine as JEngine
from mllm_npu_tpu.utils import weights as JW
from mllm_npu_tpu.utils.fake_tokenizer import FakeTokenizer as JTok
from mllm_npu_tpu.utils.testing import (TinySpec as JSpec,
                                        synthetic_batch as j_batch)
from mllm_npu_tpu_torch.data.processor import ImageProcessor
from mllm_npu_tpu_torch.models import factory
from mllm_npu_tpu_torch.models.multimodal_encoder.qwenvl_vit import (
    QwenViTConfig, VisionTransformerWithAttnPool)
from mllm_npu_tpu_torch.serve.engine import InferenceEngine
from mllm_npu_tpu_torch.utils import weights as W
from mllm_npu_tpu_torch.utils.fake_tokenizer import FakeTokenizer
from mllm_npu_tpu_torch.utils.testing import TinySpec, synthetic_batch

import checkpoint_sources as src

REPO = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
ATOL = 1e-5
COMMON = dict(resolution_grids=("1x1", "1x2", "2x1", "2x2"),
              base_resolution=448, num_img_in_tokens=4,
              num_img_out_tokens=4, max_new_tokens=10)
PEFT = {"r": src.LORA["r"], "lora_alpha": src.LORA["lora_alpha"],
        "lora_dropout": 0.0, "target_modules": src.LORA["target_modules"]}

MODEL_YAML = """
mllm:
  mllm_model:
    _target_: mllm_npu_tpu_torch.models.factory.build_mllm
    freeze_vision_encoder: true
    add_patch_pos: true
    pretrained_model_path: {asm}
    vision_encoder:
      _target_: mllm_npu_tpu_torch.models.factory.build_siglip
      pretrained_model_name_or_path: {siglip}
    projector:
      _target_: mllm_npu_tpu_torch.models.factory.build_attention_resampler
      grid_size: 2
      embed_dim: 128
      num_heads: 4
      kv_dim: 64
  language_model:
    _target_: mllm_npu_tpu_torch.models.factory.get_peft_model_with_resize_embedding
    vocab_size: {vocab}
    peft_config:
      _target_: mllm_npu_tpu_torch.configs.passthrough_dict
      r: {r}
      lora_alpha: {alpha}
      lora_dropout: 0.0
      target_modules: [q_proj, v_proj, k_proj, o_proj, gate_proj, down_proj, up_proj]
    model:
      _target_: mllm_npu_tpu_torch.models.factory.build_llama3
      pretrained_model_name_or_path: {llama}
  tokenizer:
    _target_: transformers.AutoTokenizer.from_pretrained
    pretrained_model_name_or_path: tokenizer-not-on-disk
  processor:
    _target_: mllm_npu_tpu_torch.data.processor.init_processor
    processor_json: {proc}
"""


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The reference's layouts, written once: an HF Llama directory
    (safetensors shards, base vocabulary), an HF SigLIP directory, a
    ``qwen_vit_G.pt``, the comprehension and the SEED assemblies (peft)."""
    root = tmp_path_factory.mktemp("pretrained")
    llama = src.hf_llama_state()
    (root / "llama").mkdir()
    names = sorted(llama)
    for i, part in enumerate((names[:9], names[9:]), 1):
        st.save_file({n: llama[n] for n in part},
                     root / "llama" / f"model-0000{i}-of-00002.safetensors")
    (root / "siglip").mkdir()
    st.save_file(src.hf_siglip_state(), root / "siglip" / "model.safetensors")
    torch.save(src.qwen_vit_state(), root / "qwen_vit_G.pt")
    lm = {f"language_model.{k}": v for k, v in
          src.peft_language_model_state(src.hf_llama_state(seed=5)).items()}
    g = torch.Generator().manual_seed(9)
    asm = dict(lm)
    asm.update({f"projector.{k}": v for k, v in
                src.resampler_state(128, 64, 2, seed=3).items()})
    asm["patch_pos_embed"] = 0.1 * torch.randn(4, 128, generator=g)
    torch.save(asm, root / "assembly.bin")
    seed_asm = dict(lm)
    seed_asm.update({f"projector.{k}": v for k, v in
                     src.resampler_state(128, 128, 2, seed=4).items()})
    seed_asm.update({f"output_projector.{k}": v for k, v in
                     src.resampler_state(128, 128, 2, seed=6).items()})
    seed_asm["patch_pos_embed"] = 0.1 * torch.randn(4, 128, generator=g)
    torch.save(seed_asm, root / "seed_assembly.bin")
    proc = root / "proc.json"
    proc.write_text(json.dumps({
        "size": {"height": 56, "width": 56}, "do_normalize": True,
        "image_mean": [0.5, 0.5, 0.5], "image_std": [0.5, 0.5, 0.5]}))
    return root


def _yaml(files, path, asm="assembly.bin"):
    path.write_text(MODEL_YAML.format(
        asm=files / asm if asm else "null", siglip=files / "siglip",
        llama=files / "llama", vocab=src.VOCAB, r=PEFT["r"],
        alpha=PEFT["lora_alpha"], proc=files / "proc.json"))
    return path


@pytest.fixture
def full_width(monkeypatch):
    monkeypatch.delenv("DEBUG_FLAG", raising=False)
    src.patch_tiny(monkeypatch.setattr)


def _lm(mod, files, dtype):
    # remat off: the reference's generator does not trace under it
    base = mod.build_llama3(pretrained_model_name_or_path=str(
        files / "llama"), dtype=dtype, remat=False)
    return mod.get_peft_model_with_resize_embedding(
        model=base, peft_config=dict(PEFT), vocab_size=src.VOCAB)


def _comprehension(files, asm="assembly.bin"):
    """The comprehension assembly from the files: → (port model, JAX
    module, JAX params)."""
    asm = str(files / asm) if asm else None
    kw = dict(add_patch_pos=True, pretrained_model_path=asm)
    tm = factory.build_mllm(
        language_model=_lm(factory, files, torch.float32),
        vision_encoder=factory.build_siglip(
            pretrained_model_name_or_path=str(files / "siglip"),
            dtype=torch.float32),
        projector=factory.build_attention_resampler(
            2, 128, 4, kv_dim=64, dtype=torch.float32),
        device="cpu", param_dtype=torch.float32, **kw)
    bundle = jfactory.build_mllm(
        language_model=_lm(jfactory, files, jnp.float32),
        vision_encoder=jfactory.build_siglip(
            pretrained_model_name_or_path=str(files / "siglip"),
            dtype=jnp.float32),
        projector=jfactory.build_attention_resampler(
            2, 128, 4, kv_dim=64, dtype=jnp.float32), **kw)
    params = jfactory.init_assembly_params(
        bundle, j_batch(JSpec(batch=1, seq=64, image_size=56, nq=4),
                        cmp_images=1))
    return tm, bundle.module, params


def _seed(files):
    """The SEED assembly with the Qwen tower from the files."""
    qpath = str(files / "qwen_vit_G.pt")
    cfg, jcfg = QwenViTConfig.tiny(), JQwenCfg.tiny()
    tower = factory.ModelSpec(
        cfg, torch.float32, lambda: VisionTransformerWithAttnPool(cfg),
        qpath, W.qwen_vit_state)
    jtower = jfactory.ModelBundle(
        module=JQwen(jcfg), config=jcfg,
        params=JW.torch_to_flax_qwen_vit(torch.load(qpath), jcfg))
    kw = dict(add_patch_pos=True, vit_down=True, mse=True,
              num_img_out_tokens=4, rec_loss_scale=1.0,
              pretrained_model_path=str(files / "seed_assembly.bin"))
    tm = factory.build_seed(
        language_model=_lm(factory, files, torch.float32),
        vision_encoder=tower,
        projector=factory.build_attention_resampler(
            2, 128, 4, kv_dim=128, dtype=torch.float32),
        output_projector=factory.build_attention_resampler(
            2, 128, 4, kv_dim=128, dtype=torch.float32),
        device="cpu", param_dtype=torch.float32, **kw)
    bundle = jfactory.build_seed(
        language_model=_lm(jfactory, files, jnp.float32),
        vision_encoder=jtower,
        projector=jfactory.build_attention_resampler(
            2, 128, 4, kv_dim=128, dtype=jnp.float32),
        output_projector=jfactory.build_attention_resampler(
            2, 128, 4, kv_dim=128, dtype=jnp.float32), **kw)
    params = jfactory.init_assembly_params(
        bundle, j_batch(JSpec(batch=2, seq=64, max_images=2, image_size=56,
                              nq=4), cmp_images=1, gen_images=1))
    return tm, bundle.module, params


@pytest.mark.parametrize("kind", ["comprehension", "seed"])
def test_assembly_forward_matches_reference(full_width, files, kind):
    tm, jm, params = (_comprehension if kind == "comprehension" else
                      _seed)(files)
    assert tm.checkpoint_report["skipped"] == []
    # every loaded parameter equals the reference's, where both read files
    flat = {".".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                params["params"])}
    emb = flat["language_model.model.embed_tokens.embedding"]
    np.testing.assert_allclose(
        tm.language_model.model.embed_tokens.weight.detach().numpy(),
        np.asarray(emb), atol=1e-6, rtol=0)
    batch = synthetic_batch(TinySpec(), batch=2, seq=64, max_images=2,
                            cmp_images=1, gen_images=int(kind == "seed"),
                            rng=7)
    ref = jm.apply(params, **{k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["input_ids"] = tb["input_ids"].long()
    tb["labels"] = tb["labels"].long()
    with torch.no_grad():
        got = tm(**tb)
    keys = ("lm_loss", "total_loss") + (("rec_loss",) if kind == "seed"
                                        else ())
    for key in keys:
        np.testing.assert_allclose(float(got[key]), float(ref[key]),
                                   atol=ATOL, rtol=0, err_msg=key)


def _png_b64(w, h, seed=0):
    rs = np.random.RandomState(seed)
    buf = io.BytesIO()
    Image.fromarray((rs.rand(h, w, 3) * 255).astype(np.uint8)).save(
        buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _reference_ids(je, q, b64):
    ids, patches, pos, cmp = je._prepare_comprehension(q, b64)
    if patches is None:
        out = je.generator.generate(jnp.asarray(ids[None]))
    else:
        n = patches.shape[0]
        out = je.generator.generate(
            jnp.asarray(ids[None]), images=jnp.asarray(patches),
            embeds_cmp_mask=jnp.ones((n,), bool),
            ids_cmp_mask=jnp.asarray(cmp[None]),
            patch_positions=jnp.asarray(pos))
    return np.asarray(out["generate_ids"][0])


REQUESTS = (("what is shown in this picture?", (896, 896)),
            ("describe it", (384, 1152)), ("what is the capital?", None))


def test_loaded_engine_ids_equal_reference(full_width, files):
    """The tiny engines over the loaded assemblies, at the serving defaults
    (bf16 weights and cache): identical greedy ids."""
    tm, jm, params = _comprehension(files)
    je = JEngine(model=jm, lm_config=jm.language_model.config, params=params,
                 tokenizer=JTok(), image_transform=JProc(height=56, width=56),
                 **COMMON)
    te = InferenceEngine(model=tm, tokenizer=FakeTokenizer(),
                         image_transform=ImageProcessor(height=56, width=56),
                         device="cpu", **COMMON)
    for i, (q, size) in enumerate(REQUESTS):
        b64 = _png_b64(*size, seed=i) if size else ""
        np.testing.assert_array_equal(te.comprehension_ids(q, b64),
                                      _reference_ids(je, q, b64))


def test_port_resizes_the_8b_embeddings_the_reference_skips(
        full_width, files, caplog):
    """The 8B YAML's path without an assembly: the reference converts the
    base at its own vocabulary, raises the config to the resized one and
    then skips ``embed_tokens`` and ``lm_head`` as mismatched (they stay
    random); the port resizes them by the mean rule the reference's
    ``torch_to_flax_llama(vocab_size=…)`` applies."""
    caplog.set_level(logging.WARNING)
    tm, _, params = _comprehension(files, asm=None)
    skipped = [r.getMessage() for r in caplog.records
               if "skipping mismatched weight" in r.getMessage()]
    assert any("embed_tokens" in m for m in skipped)
    assert any("lm_head" in m for m in skipped)
    base = st.load_file(next((files / "llama").glob("*1-of*")))
    base.update(st.load_file(next((files / "llama").glob("*2-of*"))))
    emb = base["model.embed_tokens.weight"].numpy()
    jemb = np.asarray(params["params"]["language_model"]["model"][
        "embed_tokens"]["embedding"])
    assert jemb.shape == (src.VOCAB, 128)
    assert not np.allclose(jemb[:src.BASE_VOCAB], emb)      # skipped
    got = tm.language_model.model.embed_tokens.weight.detach().numpy()
    np.testing.assert_array_equal(got[:src.BASE_VOCAB], emb)
    np.testing.assert_allclose(got, JW.resize_embedding(emb, src.VOCAB, 1.0),
                               atol=1e-6, rtol=0)
    head = tm.language_model.lm_head.weight.detach().numpy()
    np.testing.assert_allclose(
        head, JW.resize_embedding(base["lm_head.weight"].numpy(), src.VOCAB,
                                  3.0), atol=1e-6, rtol=0)
    assert tm.checkpoint_report["skipped"] == []


def test_assembly_entry_of_another_shape_is_skipped_and_counted(
        full_width, files, tmp_path, caplog):
    asm = torch.load(files / "assembly.bin")
    asm["projector.query"] = torch.zeros(9, 128)
    torch.save(asm, tmp_path / "odd.bin")
    caplog.set_level(logging.WARNING)
    tm = factory.build_mllm(
        language_model=_lm(factory, files, torch.float32),
        vision_encoder=factory.build_siglip(
            pretrained_model_name_or_path=str(files / "siglip")),
        projector=factory.build_attention_resampler(2, 128, 4, kv_dim=64),
        add_patch_pos=True, pretrained_model_path=str(tmp_path / "odd.bin"),
        device="cpu", param_dtype=torch.float32)
    assert tm.checkpoint_report["skipped"] == ["projector.query"]
    assert "projector.query" in caplog.text
    assert tm.projector.query.abs().sum() > 0       # seeded, not the zeros
    torch.testing.assert_close(tm.patch_pos_embed, asm["patch_pos_embed"],
                               rtol=0, atol=0)


@pytest.mark.parametrize("debug", [False, True])
def test_refusals(full_width, files, tmp_path, monkeypatch, debug):
    """Outside DEBUG_FLAG: a configured path that does not exist, a key the
    model does not hold, a component checkpoint missing a key, a component
    tensor of another shape each raise. Under DEBUG_FLAG every path
    resolves to None (tiny seeded models), and the loading rules
    themselves still raise."""
    shapes = {"projector.query": torch.Size([4, 128])}
    if debug:
        monkeypatch.setenv("DEBUG_FLAG", "True")
        spec = factory.build_llama3(pretrained_model_name_or_path=str(
            tmp_path / "nope"))
        assert spec.checkpoint is None
        tm = factory.build_component(spec, device="cpu")
        assert tm.checkpoint_report["loaded"] == {}
    else:
        with pytest.raises(FileNotFoundError, match="does not exist"):
            factory.build_llama3(pretrained_model_name_or_path=str(
                tmp_path / "nope"))
    with pytest.raises(KeyError, match="not parameters"):
        factory.load_state_(torch.nn.Linear(2, 2), {"bias": torch.zeros(2),
                                                    "extra": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape"):
        factory.load_state_(torch.nn.Linear(2, 2), {"bias": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        W.merge_partial_state({}, {"projector.query": torch.zeros(2)}, shapes,
                              "t")
    if debug:
        return
    sd = src.hf_llama_state()
    bad = dict(sd)
    bad.pop("model.layers.1.mlp.up_proj.weight")
    torch.save(bad, tmp_path / "missing.bin")
    with pytest.raises(KeyError, match="missing"):
        factory.build_mllm(
            language_model=factory.get_peft_model_with_resize_embedding(
                model=factory.build_llama3(
                    pretrained_model_name_or_path=str(tmp_path /
                                                      "missing.bin")),
                peft_config=dict(PEFT), vocab_size=src.VOCAB),
            vision_encoder=factory.build_siglip(),
            projector=factory.build_attention_resampler(2, 128, 4, 64),
            device="cpu")
    bad = dict(sd)
    bad["model.norm.weight"] = torch.ones(5)
    torch.save(bad, tmp_path / "shape.bin")
    with pytest.raises(ValueError, match="model.norm.weight"):
        factory.build_component(factory.build_llama3(
            pretrained_model_name_or_path=str(tmp_path / "shape.bin")),
            device="cpu")
    asm = {"language_model.base_model.model.model.layers.0.mlp.up_proj."
           "lora_Q.default.weight": torch.zeros(1)}
    torch.save(asm, tmp_path / "unknown.bin")
    with pytest.raises(KeyError, match="not parameters"):
        _comprehension(files, asm=tmp_path / "unknown.bin")


def test_hub_ids_go_through_huggingface_hub(full_width, monkeypatch,
                                            tmp_path):
    """A path of the form org/name that is not on disk is resolved by
    ``huggingface_hub.snapshot_download``, imported only then; its failure
    (no package, no network) raises FileNotFoundError. The module is a
    stand-in: nothing here reaches a network."""
    calls = []

    def ok(repo_id):
        calls.append(repo_id)
        return str(tmp_path)

    def fails(repo_id):
        raise OSError("offline")
    for fn in (ok, fails):
        monkeypatch.setitem(sys.modules, "huggingface_hub",
                            types.SimpleNamespace(snapshot_download=fn))
        if fn is ok:
            assert factory._maybe("some-org/some-model") == str(tmp_path)
        else:
            with pytest.raises(FileNotFoundError, match="hub download"):
                factory._maybe("some-org/some-model")
    assert calls == ["some-org/some-model"]


def test_converter_then_params_checkpoint_gives_the_same_ids(
        full_width, files, tmp_path):
    """``tools.convert_checkpoint`` on a YAML naming the files, then the
    worker's and the evaluator's ``--params_checkpoint``: the model built
    on ``meta`` and filled from the shards alone, equal to the YAML's
    build tensor for tensor, and the same greedy ids."""
    from mllm_npu_tpu_torch.evaluate.run import build_eval_model
    from mllm_npu_tpu_torch.serve.worker import (load_engine_from_config,
                                                 parse_worker_args)
    from mllm_npu_tpu_torch.tools.convert_checkpoint import main as convert
    yaml = _yaml(files, tmp_path / "model.yaml")
    info = convert(["--model-config", str(yaml), "--out",
                    str(tmp_path / "conv"), "--device", "cpu"])
    saved = json.loads((tmp_path / "conv" / "convert_info.json").read_text())
    assert saved == info and info["shards"] == 1 and info["skipped"] == []
    assert {"n_params", "bytes", "convert_seconds"} <= set(info)
    assert list((tmp_path / "conv" / "checkpoint-0").glob("*.safetensors"))
    kw = dict(max_new_tokens=6, device="cpu", fake_tokenizer=True)
    direct = load_engine_from_config(str(yaml), **kw)
    args = parse_worker_args(["--model-config", str(yaml),
                              "--params-checkpoint", str(tmp_path / "conv")])
    restored = load_engine_from_config(
        args.model_config, params_checkpoint=args.params_checkpoint, **kw)
    a, b = direct.generator.model, restored.generator.model
    assert b.checkpoint_report["seeded"] == 0
    assert set(b.checkpoint_report["loaded"]) == {
        "patch_pos_embed", "language_model", "vision_encoder", "projector"}
    for (n, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), n
    em = build_eval_model(str(yaml), max_new_tokens=6, device="cpu",
                          params_checkpoint=str(tmp_path / "conv"),
                          fake_tokenizer=True)
    for i, (q, size) in enumerate(REQUESTS):
        b64 = _png_b64(*size, seed=i) if size else ""
        want = direct.comprehension_ids(q, b64)
        np.testing.assert_array_equal(restored.comprehension_ids(q, b64),
                                      want)
        np.testing.assert_array_equal(
            em.engine.comprehension_ids(q, b64), want)


CHILD = """
import sys
sys.path[:0] = [{repo!r}, {tests!r}]
import checkpoint_sources as src
src.patch_tiny(setattr, jax=False)
import mllm_npu_tpu_torch.train.trackers as trackers
trackers.build_trackers = (
    lambda out, cfg: trackers.Trackers(out, cfg, tb=False))
from mllm_npu_tpu_torch.train.train import main
run = main({argv!r})
import json
print("LOSSES", json.dumps([r["loss"] for r in run.records]))
"""


def _caption_tar(path, n=12):
    import tarfile
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


def _train_argv(yaml, data, out, steps):
    return ["--model", str(yaml), "--train_dataset", str(data),
            "--output_dir", str(out), "--max_steps", str(steps),
            "--save_steps", "2", "--log_steps", "1", "--warmup_steps", "0",
            "--learning_rate", "1e-3", "--fake_tokenizer", "--device", "cpu",
            "--lr_scheduler_type", "constant_with_warmup"]


def _child(argv):
    env = {k: v for k, v in os.environ.items() if k != "DEBUG_FLAG"}
    res = subprocess.run(
        [sys.executable, "-c", CHILD.format(repo=str(REPO), tests=str(TESTS),
                                            argv=argv)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    line = [x for x in res.stdout.splitlines() if x.startswith("LOSSES")][-1]
    return json.loads(line[len("LOSSES"):])


def test_training_over_a_loaded_base_resumes_in_a_new_process(
        full_width, files, tmp_path, monkeypatch):
    """Two steps over the loaded assembly, a checkpoint, then two more in a
    new process: the losses of one uninterrupted run. The checkpoint holds
    the trainable parameters alone; the frozen ones (every LoRA base, the
    vision tower) come back from the files. The evaluator takes the
    trainer's directory too: its trainable parameters over the YAML's
    model."""
    from mllm_npu_tpu_torch.evaluate.run import build_eval_model
    from mllm_npu_tpu_torch.train.train import main
    import mllm_npu_tpu_torch.train.trackers as trackers
    yaml = _yaml(files, tmp_path / "model.yaml")
    _caption_tar(tmp_path / "shard-000.tar")
    data = tmp_path / "data.yaml"
    from test_torch_train import DATA_YAML
    data.write_text(DATA_YAML.format(data_dir=tmp_path))
    monkeypatch.setattr(trackers, "build_trackers",
                        lambda out, cfg: trackers.Trackers(out, cfg,
                                                           tb=False))
    full = main(_train_argv(yaml, data, tmp_path / "full", 4))
    losses = [r["loss"] for r in full.records]
    assert len(losses) == 4 and all(np.isfinite(losses))
    first = _child(_train_argv(yaml, data, tmp_path / "out", 2))
    resumed = _child(_train_argv(yaml, data, tmp_path / "out", 4))
    np.testing.assert_allclose(first, losses[:2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(resumed, losses[2:], rtol=0, atol=1e-5)
    state = torch.load(tmp_path / "out" / "checkpoint_4" / "state.pt",
                       weights_only=True)["params"]
    frozen = factory.frozen_parameter_names(full.model)
    assert state and not set(state) & frozen
    siglip = st.load_file(files / "siglip" / "model.safetensors")
    torch.testing.assert_close(
        full.model.vision_encoder.vision_model.post_layernorm.weight.float(),
        siglip["vision_model.post_layernorm.weight"].to(torch.bfloat16).float(),
        rtol=0, atol=0)
    em = build_eval_model(str(yaml), max_new_tokens=4, device="cpu",
                          params_checkpoint=str(tmp_path / "out"),
                          fake_tokenizer=True)
    got = dict(em.engine.generator.model.named_parameters())
    for name, t in state.items():
        torch.testing.assert_close(got[name], t.to(got[name].dtype), rtol=0,
                                   atol=0, msg=name)


def test_trainer_from_the_converter_starts_where_the_files_do(
        full_width, files, tmp_path, monkeypatch):
    """The converter writes the training build's dtypes (the trained
    parameters in fp32, the frozen ones in bf16), so the trainer's
    ``--params_checkpoint`` on its directory gives, step for step, the
    losses of a run from the YAML's files."""
    from mllm_npu_tpu_torch.tools.convert_checkpoint import main as convert
    from mllm_npu_tpu_torch.train.train import main
    from mllm_npu_tpu_torch.utils.checkpoint_files import converted_state
    import mllm_npu_tpu_torch.train.trackers as trackers
    yaml = _yaml(files, tmp_path / "model.yaml")
    convert(["--model-config", str(yaml), "--out", str(tmp_path / "conv"),
             "--device", "cpu"])
    _caption_tar(tmp_path / "shard-000.tar")
    data = tmp_path / "data.yaml"
    from test_torch_train import DATA_YAML
    data.write_text(DATA_YAML.format(data_dir=tmp_path))
    monkeypatch.setattr(trackers, "build_trackers",
                        lambda out, cfg: trackers.Trackers(out, cfg,
                                                           tb=False))
    direct = main(_train_argv(yaml, data, tmp_path / "direct", 3))
    restored = main(_train_argv(yaml, data, tmp_path / "restored", 3)
                    + ["--params_checkpoint", str(tmp_path / "conv")])
    assert restored.model.checkpoint_report["seeded"] == 0
    state = converted_state(tmp_path / "conv")
    frozen = factory.frozen_parameter_names(direct.model)
    for name, p in direct.model.named_parameters():
        want = torch.bfloat16 if name in frozen else torch.float32
        assert state[name].dtype == p.dtype == want, name
    losses = [r["loss"] for r in direct.records]
    assert len(losses) == 3 and all(np.isfinite(losses))
    np.testing.assert_array_equal([r["loss"] for r in restored.records],
                                  losses)


@pytest.mark.parametrize("case", ["whole", "missing", "unexpected", "shape"])
def test_trainer_checkpoint_restore_is_strict(full_width, files, tmp_path,
                                              case):
    """The evaluator's restore of the trainer's directory: every trainable
    parameter required, a name the model does not hold or a shape that
    differs (even one that would broadcast) raises."""
    from mllm_npu_tpu_torch.evaluate.run import load_model
    from mllm_npu_tpu_torch.utils.convert import restore_trainer_params_
    model, _, _ = load_model(str(_yaml(files, tmp_path / "model.yaml")),
                             device="cpu", fake_tokenizer=True)
    frozen = factory.frozen_parameter_names(model)
    g = torch.Generator().manual_seed(0)
    params = {n: torch.randn(p.shape, generator=g)
              for n, p in model.named_parameters() if n not in frozen}
    norm = "language_model.model.norm.weight"
    assert norm in params
    if case == "missing":
        del params[norm]
    elif case == "unexpected":
        params["language_model.not_a_parameter"] = torch.zeros(3)
    elif case == "shape":
        params[norm] = params[norm][:1]
    (tmp_path / "out" / "checkpoint_3").mkdir(parents=True)
    torch.save({"params": params},
               tmp_path / "out" / "checkpoint_3" / "state.pt")
    if case == "whole":
        assert restore_trainer_params_(model, tmp_path / "out") == 3
        got = dict(model.named_parameters())
        for name, t in params.items():
            torch.testing.assert_close(got[name], t.to(got[name].dtype),
                                       rtol=0, atol=0, msg=name)
        return
    err = ValueError if case == "shape" else KeyError
    with pytest.raises(err, match={"missing": "trainable parameters missing",
                                   "unexpected": "not parameters",
                                   "shape": "checkpoint shape"}[case]):
        restore_trainer_params_(model, tmp_path / "out")
