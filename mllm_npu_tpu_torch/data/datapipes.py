"""Mixture multiplexer + dataloader assembly (the port's copy of
``mllm_npu_tpu/data/datapipes.py``)."""

from __future__ import annotations

from typing import Optional

from mllm_npu_tpu_torch.configs import instantiate
from mllm_npu_tpu_torch.data.streams import (SampleMultiplexer,
                                             process_index_count)


def build_multi_datapipes(datapipes, tokenizer=None, image_transform=None,
                          sample_weights=None, seed: Optional[int] = None):
    """Instantiate N task pipelines from config nodes and weighted-sample
    across them; seed = 888 + process index (reference
    datapipes.py:104-105 uses 888 + dist rank). Task builders that don't
    take a seed kwarg keep their own; ones that do inherit the mixture
    seed so the whole tree is one deterministic function of it. The
    returned multiplexer is checkpointable (state_dict/load_state_dict)."""
    if sample_weights is None:
        sample_weights = [1] * len(datapipes)
    assert len(sample_weights) == len(datapipes)

    if seed is None:
        seed = 888 + process_index_count()[0]
    pipes = []
    for i, node in enumerate(datapipes):
        kw = {} if "seed" in node else {"seed": seed + i}
        pipes.append(instantiate(node, tokenizer=tokenizer,
                                 image_transform=image_transform, **kw))
    weights = {p: w for p, w in zip(pipes, sample_weights)}
    return SampleMultiplexer(weights, seed=seed)
