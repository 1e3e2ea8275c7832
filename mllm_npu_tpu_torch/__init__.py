"""PyTorch/CUDA port of ``mllm_npu_tpu`` for one NVIDIA H100.

The JAX package beside it is the reference this port is held against.
Nothing here imports ``jax`` or any ``mllm_npu_tpu`` module: what the port
needs from the reference (constants, the fake tokenizer, the anyres image
code, the configs) it keeps as its own copy.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU and no explicit CPU request they raise (see
:func:`mllm_npu_tpu_torch.utils.device.resolve_device`).
"""
