"""Convert the checkpoints a model YAML names into one directory the
port restores with ``--params-checkpoint`` (twin of
``scripts/tools/convert_checkpoint.py``):

    python -m mllm_npu_tpu_torch.tools.convert_checkpoint \\
        --model-config mllm_npu_tpu_torch/configs/models/seedx_llama2_13b_qwenvl_vitg.yaml \\
        --out ckpt/seedx

The YAML's components load from the reference's layouts (HF directories,
``qwen_vit_G.pt``, the peft assembly ``pytorch_model.bin``) on
``--device`` (default ``cuda``); what no file supplies is drawn from
``--seed``. The port's whole state_dict goes to
``<out>/checkpoint-<step>/`` as safetensors shards of at most 5 GB, and
``<out>/convert_info.json`` records the parameters, bytes and seconds
(printed as one JSON line too).
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--model-config", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--step", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from mllm_npu_tpu_torch.utils.convert import convert_model_checkpoint
    info = convert_model_checkpoint(args.model_config, args.out,
                                    step=args.step, device=args.device,
                                    seed=args.seed)
    print(json.dumps(info))
    return info


if __name__ == "__main__":
    main()
