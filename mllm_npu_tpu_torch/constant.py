"""Special-token constants shared by data, models and serving (the port's
own copy of ``mllm_npu_tpu/constant.py``)."""

BOI_TOKEN = "<img>"
EOI_TOKEN = "</img>"
BOP_TOKEN = "<patch>"
EOP_TOKEN = "</patch>"
IMG_TOKEN = "<img_{:05d}>"

IGNORE_INDEX = -100

# number of learnable image tokens emitted/consumed per image span
NUM_IMG_TOKENS = 64


def image_tokens_str(n: int, bo: str = BOI_TOKEN, eo: str = EOI_TOKEN) -> str:
    """``<img><img_00000>…<img_{n-1}></img>`` (copy of
    ``data/tasks/image_caption.py:78``)."""
    return bo + "".join(IMG_TOKEN.format(i) for i in range(n)) + eo
