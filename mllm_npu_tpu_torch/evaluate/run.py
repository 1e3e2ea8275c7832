"""Evaluation dispatcher (twin of ``evaluate/run.py``):

  python -m mllm_npu_tpu_torch.evaluate.run \\
      --config_path mllm_npu_tpu_torch/configs/models/seedx_llama2_13b_qwenvl_vitg.yaml \\
      --dataset_name mmlu --data_path ./evaluate/eval_data/mmlu/ --fake_tokenizer

Builds the model stack from the port's YAML and runs one of the seven
benchmarks, writing the reference's result file into the working
directory. Weights are drawn from ``--seed`` (checkpoint loading is queue
1 item 16); the stack runs on ``--device`` (default ``cuda``; ``--device
cpu`` with ``DEBUG_FLAG=True`` runs the tiny stack on a CPU). Without a
tokenizer on disk, ``--fake_tokenizer`` (or ``DEBUG_FLAG=True``, as the
reference) takes the offline ``FakeTokenizer``.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

DEFAULT_CONFIG = ("mllm_npu_tpu_torch/configs/models/"
                  "seedx_llama2_13b_qwenvl_vitg.yaml")
# the reference's batched engine for --prefix_cache (evaluate/run.py:69-72);
# a prompt longer than max_prompt raises there and here (a limit of
# the reference, kept)
PREFIX_ENGINE = dict(num_slots=2, max_len=2560, max_prompt=2048,
                     batch_prompt_bucket=512)


def load_model(config_path: str, *, device=None, seed: int = 0,
               fake_tokenizer: bool = False):
    """The YAML's assembly with weights from ``seed`` on ``device``, its
    tokenizer and image processor → (model, tokenizer, processor). The
    tokenizer is ``FakeTokenizer`` (at the model's vocab) with
    ``fake_tokenizer``, and under ``DEBUG_FLAG=True`` when the configured
    one is not on disk or does not load, as the reference's."""
    from mllm_npu_tpu_torch.configs import instantiate, load_config
    from mllm_npu_tpu_torch.utils.device import resolve_device
    from mllm_npu_tpu_torch.utils.fake_tokenizer import FakeTokenizer

    device = resolve_device(device)
    cfg = load_config(config_path)["mllm"]
    llm = instantiate(cfg["language_model"])
    model = instantiate(cfg["mllm_model"], language_model=llm, device=device,
                        seed=seed)
    debug = os.environ.get("DEBUG_FLAG") == "True"
    path = cfg["tokenizer"].get("pretrained_model_name_or_path", "")
    tokenizer = None
    if not (fake_tokenizer or (debug and not Path(str(path)).exists())):
        try:
            tokenizer = instantiate(cfg["tokenizer"])
        except Exception:
            if not debug:
                raise
    if tokenizer is None:
        tokenizer = FakeTokenizer(vocab_size=llm.config.vocab_size)
    return model, tokenizer, instantiate(cfg["processor"])


def eval_model_for(model, tokenizer, processor, *, max_new_tokens: int = 512,
                   prefix_cache: int = 0, prefix_engine: dict = None,
                   device=None, **engine_kw):
    """An ``EvalModel`` over ``model`` (served in place: its fp32
    parameters are stored in bf16): the single-request engine, or with
    ``prefix_cache`` > 0 the batched engine with an N-entry prompt-prefix
    cache at ``prefix_engine``'s slots and lengths (default the
    reference's, ``PREFIX_ENGINE``). ``engine_kw`` go to either engine
    (``base_resolution``, ``quantize_int8``, ``quantize_int4``,
    ``fuse_projections``: the model is converted in place)."""
    from mllm_npu_tpu_torch.evaluate.evaluator import EvalModel
    from mllm_npu_tpu_torch.serve.engine import (BatchedInferenceEngine,
                                                 InferenceEngine)
    nq = model.projector.num_queries
    common = dict(model=model, tokenizer=tokenizer,
                  image_transform=processor, num_img_in_tokens=nq,
                  num_img_out_tokens=nq, max_new_tokens=max_new_tokens,
                  device=device, **engine_kw)
    if prefix_cache:
        return EvalModel(BatchedInferenceEngine(
            prefix_cache=prefix_cache, **(prefix_engine or PREFIX_ENGINE),
            **common))
    return EvalModel(InferenceEngine(**common))


def build_eval_model(config_path: str, max_new_tokens: int = 512,
                     params_checkpoint: str = None, prefix_cache: int = 0,
                     *, device=None, seed: int = 0,
                     fake_tokenizer: bool = False):
    """The reference's ``build_eval_model``: the YAML's stack (weights from
    ``seed``) behind the single-request engine, or with ``prefix_cache``
    the batched engine whose prefix cache prefills a repeated few-shot
    preamble once."""
    if params_checkpoint:
        raise NotImplementedError(
            "--params_checkpoint (orbax params from the JAX package) is not "
            "ported yet (ROADMAP queue 1 item 16)")
    model, tokenizer, processor = load_model(
        config_path, device=device, seed=seed, fake_tokenizer=fake_tokenizer)
    return eval_model_for(model, tokenizer, processor,
                          max_new_tokens=max_new_tokens,
                          prefix_cache=prefix_cache, device=device)


def dispatch(model, dataset_name: str, data_path: str, max_items=None):
    """Run one benchmark on ``model``; its result file goes to the working
    directory, under the reference's name."""
    from mllm_npu_tpu_torch.evaluate import mm_benchmarks as mm
    from mllm_npu_tpu_torch.evaluate import text_benchmarks as tb
    if dataset_name == "mmlu":
        return tb.mmlu_eval(model, data_path,
                            max_items_per_subject=max_items)
    if dataset_name == "cmmlu":
        return tb.cmmlu_eval(model, data_path,
                             max_items_per_subject=max_items)
    if dataset_name == "bbh":
        return tb.bbh_eval(model, data_path,
                           max_items_per_subject=max_items)
    if dataset_name == "ceval":
        return tb.ceval_eval(model, data_path,
                             max_items_per_subject=max_items)
    if dataset_name == "seed_bench":
        return mm.seed_bench2_eval(model, data_path, max_items=max_items)
    if dataset_name == "mme":
        return mm.mme_eval(model, data_path, max_items=max_items)
    if dataset_name == "mm_vet":
        return mm.mm_vet_eval(model, data_path, max_items=max_items)
    raise ValueError(f"unknown dataset {dataset_name}")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="evaluate the mllm on a GPU")
    parser.add_argument("--config_path", type=str, default=DEFAULT_CONFIG)
    parser.add_argument("--dataset_name", type=str, default="mmlu")
    parser.add_argument("--data_path", type=str,
                        default="./evaluate/eval_data/mmlu/")
    parser.add_argument("--max_items", type=int, default=None)
    parser.add_argument("--params_checkpoint", type=str, default=None,
                        help="orbax params to evaluate: not ported yet "
                             "(queue 1 item 16), raises")
    parser.add_argument("--prefix_cache", type=int, default=0,
                        help="N-entry prompt-prefix KV cache via the "
                             "batched engine: the repeated few-shot "
                             "preamble prefills once")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--fake_tokenizer", action="store_true",
                        help="the offline FakeTokenizer at the model's vocab")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    model = build_eval_model(args.config_path,
                             params_checkpoint=args.params_checkpoint,
                             prefix_cache=args.prefix_cache,
                             device=args.device, seed=args.seed,
                             fake_tokenizer=args.fake_tokenizer)
    try:
        return dispatch(model, args.dataset_name, args.data_path,
                        args.max_items)
    finally:
        if hasattr(model.engine, "close"):
            model.engine.close()


if __name__ == "__main__":
    main()
