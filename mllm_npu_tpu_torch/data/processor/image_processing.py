"""Image preprocessing from JSON processor configs (the port's copy of
``mllm_npu_tpu/data/processor/image_processing.py``): resize (PIL resample
code), rescale, normalize, NHWC float32 output. The port keeps NHWC at its
public functions and converts once, at the SigLIP patch conv."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
from PIL import Image


@dataclasses.dataclass
class ImageProcessor:
    height: int = 384
    width: int = 384
    do_resize: bool = True
    do_rescale: bool = True
    rescale_factor: float = 1.0 / 255.0
    do_normalize: bool = True
    image_mean: tuple = (0.5, 0.5, 0.5)
    image_std: tuple = (0.5, 0.5, 0.5)
    resample: int = 3      # PIL code: 2=bilinear, 3=bicubic

    @property
    def image_size(self) -> int:
        assert self.height == self.width
        return self.height

    def __call__(self, image: Image.Image) -> np.ndarray:
        if self.do_resize and image.size != (self.width, self.height):
            image = image.resize((self.width, self.height),
                                 resample=self.resample)
        arr = np.asarray(image.convert("RGB"), np.float32)
        if self.do_rescale:
            arr = arr * self.rescale_factor
        else:
            # raw PIL arrays are 0-255: scale as torchvision ToTensor does
            arr = arr / 255.0
        if self.do_normalize:
            mean = np.asarray(self.image_mean, np.float32)
            std = np.asarray(self.image_std, np.float32)
            arr = (arr - mean) / std
        return arr  # [H, W, 3] float32


def init_processor(processor_name: str = None, processor_json: str = None,
                   **kw) -> ImageProcessor:
    """Construct from a processor JSON; a path that does not exist is
    looked up by file name in this package's ``configs/processor_configs``."""
    cfg = {}
    if processor_json is not None:
        path = Path(processor_json)
        if not path.exists():
            path = (Path(__file__).resolve().parents[2] / "configs"
                    / "processor_configs" / path.name)
        with open(path) as f:
            cfg = json.load(f)
    size = cfg.get("size", {})
    return ImageProcessor(
        height=size.get("height", 384),
        width=size.get("width", 384),
        do_resize=cfg.get("do_resize", True),
        do_rescale=cfg.get("do_rescale", True),
        rescale_factor=cfg.get("rescale_factor", 1.0 / 255.0),
        do_normalize=cfg.get("do_normalize", True),
        image_mean=tuple(cfg.get("image_mean", (0.5, 0.5, 0.5))),
        image_std=tuple(cfg.get("image_std", (0.5, 0.5, 0.5))),
        resample=cfg.get("resample", 3),
    )
