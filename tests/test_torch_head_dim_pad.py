"""Head dims the flash kernels do not take (D % 8 != 0 or D < 8), on the
CPU: the port's ``multi_head_attention`` sends such a call on the card
through ``ops.head_dim_padded`` (q, k, v zero-padded along D to a multiple
of 8, the scale of the true D, the output sliced back), as the reference
pads D into its kernel (``flash_attention_padded``). Here the plain
attention (``flash_attention_reference``, fp32) takes the kernel's place;
the forward and the q/k/v gradients are held against the reference's
``multi_head_attention`` and ``jax.grad`` within 1e-5, and one forward
against ``flash_attention_padded`` in interpret mode. B1, S 64, H 2, fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_npu_tpu import ops as jops
from mllm_npu_tpu_torch import ops as tops
from mllm_npu_tpu_torch.ops.flash_attention import flash_attention_reference

B, S, H = 1, 64, 2
ATOL = 1e-5


def _inputs(D, seed):
    rs = np.random.RandomState(seed)
    return [rs.normal(0, 1.0, (B, S, H, D)).astype(np.float32)
            for _ in range(4)]          # q, k, v, the output's cotangent


def _plain_kernel(seen):
    """The plain attention in the kernel's place, recording the head dim
    and scale it was handed."""
    def attend(q, k, v, *, scale, **kw):
        seen.append((q.shape[-1], k.shape[-1], v.shape[-1], scale,
                     q.is_contiguous()))
        return flash_attention_reference(q, k, v, scale=scale, **kw)
    return attend


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [4, 36, 100])
def test_padded_head_dim_matches_the_reference(D, causal):
    q, k, v, g = _inputs(D, seed=D + causal)

    def jax_loss(q, k, v):
        out = jops.multi_head_attention(q, k, v, causal=causal)
        return jnp.sum(out * g), out
    (_, jout), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    seen = []
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = tops.head_dim_padded(_plain_kernel(seen), *leaves, causal=causal)
    (out * torch.from_numpy(g)).sum().backward()
    Dp = tops.kernel_head_dim(D)
    assert Dp % 8 == 0 and Dp >= 8 and Dp - D < 8
    assert seen == [(Dp, Dp, Dp, D ** -0.5, True)]
    assert out.shape == (B, S, H, D)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=ATOL, rtol=0)
    for got, ref in zip(leaves, jgrads):
        assert got.grad.shape == (B, S, H, D)
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref),
                                   atol=ATOL, rtol=0)


def test_padded_head_dim_matches_flash_attention_padded():
    q, k, v, _ = _inputs(36, seed=7)
    ref = jops.flash_attention_padded(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), interpret=True)
    out = tops.head_dim_padded(_plain_kernel([]), *(torch.from_numpy(t)
                                                    for t in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def test_a_given_scale_is_kept():
    q, k, v, _ = _inputs(4, seed=3)
    seen = []
    tops.head_dim_padded(_plain_kernel(seen), *(torch.from_numpy(t)
                                                for t in (q, k, v)),
                         scale=0.3)
    assert seen[0][3] == 0.3
    assert tops.kernel_head_dim(64) == 64 and tops.kernel_head_dim(1) == 8
