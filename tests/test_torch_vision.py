"""Vision path of the port against the JAX reference with the same
weights: SigLIP (tiny), the bicubic position resize, the attention
resampler, ``embed_and_scatter``, and the copied anyres/processor code.
fp32 on the CPU; model outputs agree to 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mllm_npu_tpu.data import utils as jdata
from mllm_npu_tpu.data.processor import ImageProcessor as JProc
from mllm_npu_tpu.models import mllm as jmllm
from mllm_npu_tpu.models.multimodal_encoder.siglip_vit import (
    SigLIPConfig as JSigCfg, SigLIPVisionEncoder as JSig)
from mllm_npu_tpu.models.multimodal_projector.attention_resampler import (
    AttentionResampler as JResampler)
from mllm_npu_tpu.models.vit_common import (
    get_2d_sincos_pos_embed as j_sincos, interpolate_abs_pos as j_interp)
from mllm_npu_tpu.utils.testing import (TinySpec as JSpec,
                                        build_tiny_mllm as j_build,
                                        synthetic_batch)
from mllm_npu_tpu_torch.data import utils as tdata
from mllm_npu_tpu_torch.data.processor import ImageProcessor
from mllm_npu_tpu_torch.models import mllm as tmllm
from mllm_npu_tpu_torch.models.multimodal_encoder.siglip_vit import (
    SigLIPConfig, SigLIPVisionEncoder)
from mllm_npu_tpu_torch.models.multimodal_projector.attention_resampler \
    import AttentionResampler
from mllm_npu_tpu_torch.models.vit_common import (get_2d_sincos_pos_embed,
                                                  interpolate_abs_pos)
from mllm_npu_tpu_torch.utils.testing import TinySpec, build_tiny_mllm
from mllm_npu_tpu_torch.utils.weights import (from_jax_params,
                                              resampler_from_jax,
                                              siglip_from_jax)

ATOL = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("image_size", [56, 84])
def test_siglip_matches(image_size):
    cfg_kw = dict(image_size=image_size)
    jm = JSig(JSigCfg.tiny(**cfg_kw))
    x = np.random.RandomState(0).randn(3, image_size, image_size, 3)
    x = x.astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = jm.apply(params, jnp.asarray(x))
    tm = SigLIPVisionEncoder(SigLIPConfig.tiny(**cfg_kw))
    tm.load_state_dict(siglip_from_jax(_np_tree(params["params"])),
                       strict=True)
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("src,tgt", [(8, 27), (4, 6), (6, 4), (5, 5)])
def test_interpolate_abs_pos_matches(src, tgt):
    pos = np.random.RandomState(1).randn(src * src, 24).astype(np.float32)
    ref = j_interp(jnp.asarray(pos), tgt * tgt)
    out = interpolate_abs_pos(torch.from_numpy(pos), tgt * tgt)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_sincos_table_identical():
    np.testing.assert_array_equal(get_2d_sincos_pos_embed(64, 8),
                                  j_sincos(64, 8))


@pytest.mark.parametrize("kv_dim,L", [(48, 25), (64, 16), (None, 36)])
def test_resampler_matches(kv_dim, L):
    E = 64
    jm = JResampler(grid_size=4, embed_dim=E, num_heads=4, kv_dim=kv_dim)
    x = np.random.RandomState(2).randn(3, L, kv_dim or E).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = jm.apply(params, jnp.asarray(x))
    tm = AttentionResampler(grid_size=4, embed_dim=E, num_heads=4,
                            kv_dim=kv_dim)
    tm.load_state_dict(resampler_from_jax(_np_tree(params["params"])),
                       strict=True)
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_resampler_tables_kept_per_length():
    """One module fed 25, then 16, then 25 keys matches JAX each time:
    the position tables it keeps are per key count."""
    E, kv_dim = 64, 48
    jm = JResampler(grid_size=4, embed_dim=E, num_heads=4, kv_dim=kv_dim)
    rs = np.random.RandomState(3)
    xs = [rs.randn(2, L, kv_dim).astype(np.float32) for L in (25, 16, 25)]
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(xs[0]))
    tm = AttentionResampler(grid_size=4, embed_dim=E, num_heads=4,
                            kv_dim=kv_dim)
    tm.load_state_dict(resampler_from_jax(_np_tree(params["params"])),
                       strict=True)
    for x in xs:
        with torch.no_grad():
            out = tm(torch.from_numpy(x))
        np.testing.assert_allclose(out.numpy(),
                                   np.asarray(jm.apply(params, jnp.asarray(x))),
                                   atol=ATOL)
    assert len(tm._pos_tables) == 2


@pytest.fixture(scope="module")
def tiny_pair():
    spec = JSpec(batch=2, seq=32, image_size=56, nq=4, max_images=3)
    jm, _, _ = j_build(spec)
    batch = synthetic_batch(spec, cmp_images=2)
    params = jm.init(jax.random.PRNGKey(0), **batch)
    tree = _np_tree(params["params"])
    tm, _, _ = build_tiny_mllm(TinySpec(), device="cpu")
    tm.load_state_dict(from_jax_params(tree), strict=True)
    return jm, params, tm, batch


@pytest.mark.parametrize("sel", [(True, True, False), (False, True, True)])
def test_embed_and_scatter_matches(tiny_pair, sel):
    """Selected images (not the first ones) are compacted, projected with
    their tile positions and scattered at ids_cmp_mask, row-major."""
    jm, params, tm, batch = tiny_pair
    sel = np.asarray(sel)
    args = dict(images=np.array(batch["images"]),
                embeds_cmp_mask=sel,
                ids_cmp_mask=np.array(batch["ids_cmp_mask"]),
                patch_positions=np.array(batch["patch_positions"]))
    ids = np.array(batch["input_ids"])
    ref, ref_img = jm.apply(params, jnp.asarray(ids),
                            *[jnp.asarray(args[k]) for k in args],
                            method=jm.embed_and_scatter)
    with torch.no_grad():
        out, img = tm.embed_and_scatter(
            torch.from_numpy(ids).long(),
            *[torch.from_numpy(args[k]) for k in args])
    np.testing.assert_allclose(img.numpy(), np.asarray(ref_img), atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_compact_and_scatter_helpers_match():
    rs = np.random.RandomState(3)
    x = rs.randn(5, 3, 4).astype(np.float32)
    sel = np.array([False, True, False, True, True])
    np.testing.assert_array_equal(
        tmllm.compact_selected(torch.from_numpy(x),
                               torch.from_numpy(sel)).numpy(),
        np.asarray(jmllm.compact_selected(jnp.asarray(x), jnp.asarray(sel))))
    emb = rs.randn(2, 9, 4).astype(np.float32)
    mask = np.zeros((2, 9), bool)
    mask[0, 2:5] = mask[1, 4:7] = True
    img = rs.randn(2, 3, 4).astype(np.float32)
    np.testing.assert_array_equal(
        tmllm.scatter_image_embeds(torch.from_numpy(emb),
                                   torch.from_numpy(mask),
                                   torch.from_numpy(img)).numpy(),
        np.asarray(jmllm.scatter_image_embeds(
            jnp.asarray(emb), jnp.asarray(mask), jnp.asarray(img))))


@pytest.mark.parametrize("size", [(896, 896), (384, 1152), (500, 300)])
def test_anyres_tiles_identical(size):
    rs = np.random.RandomState(4)
    img = Image.fromarray((rs.rand(size[1], size[0], 3) * 255)
                          .astype(np.uint8))
    grids = ["1x1", "1x2", "1x3", "2x1", "3x1", "1x4", "4x1", "2x2"]
    jp, jpos = jdata.process_anyres_image(
        img, JProc(height=56, width=56),
        jdata.grid_pinpoints_from_resolution_grids(grids, 448), 448)
    tp, tpos = tdata.process_anyres_image(
        img, ImageProcessor(height=56, width=56),
        tdata.grid_pinpoints_from_resolution_grids(grids, 448), 448)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tpos, jpos)
