"""Single-image comprehension demo of the port (twin of
``demo/img2txt_inference.py``).

  python -m mllm_npu_tpu_torch.demo_img2txt --image photo.jpg \\
      --question "What is unusual in the image?" --fake_tokenizer

Builds the model from the port's YAML, its weights from the checkpoints
the YAML names in the reference's ``pretrained/`` layout (a path that does
not exist raises; a null one is drawn from ``--seed``), on ``--device``
(default ``cuda``; ``--device cpu`` with ``DEBUG_FLAG=True`` runs the tiny
stack on a CPU, without checkpoints).
``build_engine(quantize_int8=True)`` (or ``quantize_int4=True``) serves
the Llama's weights in int8 (int4).
"""

from __future__ import annotations

import argparse
import base64
from pathlib import Path

DEFAULT_CONFIG = "models/mllm_llama3_8b_siglip_vit.yaml"


def build_engine(config: str = DEFAULT_CONFIG, *, device=None, seed: int = 0,
                 fake_tokenizer: bool = True, max_new_tokens: int = 120,
                 quantize_int8: bool = False, quantize_int4: bool = False):
    from mllm_npu_tpu_torch.configs import instantiate, load_config
    from mllm_npu_tpu_torch.serve.engine import InferenceEngine
    from mllm_npu_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    cfg = load_config(config)["mllm"]
    llm = instantiate(cfg["language_model"])
    model = instantiate(cfg["mllm_model"], language_model=llm,
                        device=device, seed=seed)
    if fake_tokenizer:
        from mllm_npu_tpu_torch.utils.fake_tokenizer import FakeTokenizer
        tokenizer = FakeTokenizer(vocab_size=llm.config.vocab_size)
    else:
        tokenizer = instantiate(cfg["tokenizer"])
    nq = model.projector.num_queries
    return InferenceEngine(model=model, tokenizer=tokenizer,
                           image_transform=instantiate(cfg["processor"]),
                           num_img_in_tokens=nq, num_img_out_tokens=nq,
                           max_new_tokens=max_new_tokens, device=device,
                           quantize_int8=quantize_int8,
                           quantize_int4=quantize_int4)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=DEFAULT_CONFIG)
    parser.add_argument("--image", required=True)
    parser.add_argument("--question", default="Describe the image.")
    parser.add_argument("--max_new_tokens", type=int, default=120)
    parser.add_argument("--fake_tokenizer", action="store_true")
    parser.add_argument("--device", default=None)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    engine = build_engine(args.config, device=args.device, seed=args.seed,
                          fake_tokenizer=args.fake_tokenizer,
                          max_new_tokens=args.max_new_tokens)
    image_b64 = base64.b64encode(Path(args.image).read_bytes()).decode()
    print("Q:", args.question)
    print("A:", engine.comprehension(args.question, image_b64))


if __name__ == "__main__":
    main()
