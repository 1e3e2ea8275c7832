from mllm_npu_tpu_torch.data.processor.image_processing import (
    ImageProcessor, init_processor)

__all__ = ["ImageProcessor", "init_processor"]
