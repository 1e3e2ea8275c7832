"""Caption → image demo of the port (twin of
``demo/txt2img_generation.py``): SEED decodes ``{caption}<img>`` into the
forced image tokens, the output projector maps their hidden states to the
de-tokenizer's features, and the SDXL adapter denoises (50 Euler steps,
guidance 7.5) and decodes a 1024×1024 image.

  python -m mllm_npu_tpu_torch.demo_txt2img --caption "a brown dog in \\
      the snow" --out out.jpg --fake_tokenizer

The weights come from the checkpoints the YAMLs name, in the
reference's ``pretrained/`` layout (``pretrained/weight.md``); a path
that does not exist raises, a null one is drawn from ``--seed``. It runs
on ``--device`` (default ``cuda``); ``DEBUG_FLAG=True ... --device cpu``
runs the tiny stack (tiny SEED, tiny UNet and VAE, no checkpoints) on a
CPU.
"""

from __future__ import annotations

import argparse
import base64
from pathlib import Path

DEFAULT_CONFIG = "models/seedx_llama2_13b_qwenvl_vitg.yaml"
DEFAULT_GENERATION = "generation/sd_xl_resampler.yaml"


def build_engine(config: str = DEFAULT_CONFIG,
                 generation_config: str = DEFAULT_GENERATION, *,
                 device=None, seed: int = 0, fake_tokenizer: bool = True):
    """The SEED engine with its de-tokenizer, as the worker builds them."""
    from mllm_npu_tpu_torch.configs import CONFIG_DIR
    from mllm_npu_tpu_torch.serve.worker import load_engine_from_config
    gen = Path(generation_config)
    if not gen.exists():
        gen = CONFIG_DIR / gen
    return load_engine_from_config(config, generation_config=str(gen),
                                   device=device, seed=seed,
                                   fake_tokenizer=fake_tokenizer)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=DEFAULT_CONFIG)
    parser.add_argument("--generation_config", default=DEFAULT_GENERATION)
    parser.add_argument("--caption", required=True)
    parser.add_argument("--out", default="generated.jpg")
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--fake_tokenizer", action="store_true")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    engine = build_engine(args.config, args.generation_config,
                          device=args.device, seed=args.seed,
                          fake_tokenizer=args.fake_tokenizer)
    jpeg = base64.b64decode(engine.generation(
        args.caption, num_inference_steps=args.steps))
    Path(args.out).write_bytes(jpeg)
    t = engine.last_timings
    print(f"saved {args.out}: features {t['features_s']:.2f} s, denoise "
          f"{t['denoise_s']:.2f} s ({t['steps']} steps), VAE "
          f"{t['vae_s']:.2f} s, total {t['request_s']:.2f} s")


if __name__ == "__main__":
    main()
