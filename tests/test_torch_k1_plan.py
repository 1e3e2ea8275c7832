"""The Python side of K1's Hopper design (``ops/flash_attention.py``): the
tile shape a call gets and its shared memory (head dims to 160), the split
of the head dim between the two swizzles of its tensor maps, and the
mirror of the kernel's rule for which K/V tiles it loads and which of them
it masks, held against the dense mask of the plain version on seeded
shapes. Runs on the CPU."""

import importlib

import numpy as np
import pytest
import torch

fa = importlib.import_module("mllm_npu_tpu_torch.ops.flash_attention")


@pytest.mark.parametrize("B,Sq,Hq,expect", [
    (5, 729, 16, 128),    # SigLIP: 6 × 16 × 5 = 480 blocks of 128 rows
    (1, 339, 32, 64),     # Llama prefill: 3 × 32 = 96 blocks would idle SMs
    (5, 64, 32, 64),      # resampler: 64 query rows fill one warpgroup
    (8, 600, 32, 128),    # Llama training layer
    (56, 64, 32, 64),     # resampler training: Sq = 64
    (1, 129, 66, 128),    # 2 × 66 = 132 blocks: exactly the SMs
    (1, 129, 65, 64),     # 130 blocks: one short
    (1, 1, 4096, 64),     # one row a block would waste 127 of 128
])
def test_k1_block_q(B, Sq, Hq, expect):
    assert fa.k1_block_q(B, Sq, Hq, num_sms=132) == expect
    assert fa.k1_block_q(B, Sq, Hq, num_sms=132) in fa.K1_BLOCK_Q


def test_k1_block_q_follows_the_card():
    # the same call on a card with fewer SMs fills it with 128-row blocks
    assert fa.k1_block_q(1, 339, 32, num_sms=96) == 128
    assert fa.k1_block_q(1, 339, 32, num_sms=97) == 64


@pytest.mark.parametrize("D", range(8, 161, 8))
def test_k1_head_split(D):
    hi, lo = fa.k1_head_split(D)
    assert hi % 64 == 0 and lo in (0, 16, 32, 48)
    assert hi + lo == -(-D // 16) * 16       # the wgmma k-granule
    assert hi + lo - D in (0, 8)             # TMA zero-fills at most 8
    expect = {8: (0, 16), 32: (0, 32), 64: (64, 0), 72: (64, 16),
              80: (64, 16), 104: (64, 48), 128: (128, 0), 136: (128, 16),
              160: (128, 32)}
    if D in expect:
        assert (hi, lo) == expect[D]


@pytest.mark.parametrize("B,Sq,Hq,D,expect", [
    (5, 1024, 16, 104, 128),   # Qwen-ViT-G: 8 × 16 × 5 = 640 blocks
    (5, 256, 32, 128, 128),    # its attention pool: 2 × 32 × 5 = 320
    (5, 64, 32, 160, 64),      # the SEED-X input projector: Sq = 64
    (1, 64, 32, 128, 64),      # the SEED-X output projector
    (1, 339, 40, 128, 64),     # Llama-2-13B prefill: 120 blocks idle SMs
    (5, 1024, 16, 160, 64),    # a full grid, but 128 rows do not fit
    (5, 1024, 16, 144, 128),   # 216 KB at 128 rows: fits
])
def test_k1_plan_at_the_seedx_shapes(B, Sq, Hq, D, expect):
    """The tile each SEED-X shape gets, and a shared-memory plan within the
    227 KB a block may use, from the 1- and 2-warpgroup tiles."""
    block_q, smem = fa.k1_plan(B, Sq, Hq, D, num_sms=132)
    assert block_q == expect == fa.k1_block_q(B, Sq, Hq, 132, D)
    assert smem == fa.k1_smem_bytes(block_q, D) <= fa.K1_MAX_SMEM


def test_k1_smem_bytes_mirrors_the_kernel():
    """Cfg::SMEM of csrc/flash_fwd.cu: 6 tiles of rows × DP bf16, the
    segment ids, the barriers and the 1024-byte alignment. At 128 rows
    D = 104 (DP 112) needs about 170 KB and D = 160 240 KB, over the
    limit; at 64 rows D = 160 takes 120 KB."""
    assert fa.k1_smem_bytes(128, 104) == 6 * 128 * 112 * 2 + 1040 + 96 + 1024
    assert fa.k1_smem_bytes(128, 128) < fa.K1_MAX_SMEM
    assert fa.k1_smem_bytes(128, 144) < fa.K1_MAX_SMEM
    assert fa.k1_smem_bytes(128, 160) > fa.K1_MAX_SMEM
    assert fa.k1_smem_bytes(64, 160) == 6 * 64 * 160 * 2 + 528 + 96 + 1024
    assert fa.K1_MAX_SMEM == 227 * 1024


@pytest.mark.parametrize("D", [168, 256, 100, 4])
def test_k1_plan_refuses_head_dims_it_does_not_take(D):
    with pytest.raises(ValueError, match="head dim"):
        fa.k1_plan(5, 1024, 16, D, num_sms=132)


def test_k1_plan_refuses_a_tile_that_does_not_fit(monkeypatch):
    monkeypatch.setattr(fa, "k1_block_q", lambda *a, **k: 128)
    assert fa.k1_plan(5, 64, 32, 128, num_sms=132)[0] == 128
    with pytest.raises(ValueError, match="shared memory"):
        fa.k1_plan(5, 64, 32, 160, num_sms=132)


def _segments(kind, B, Sq, Sk, rs):
    if kind is None:
        return None
    if kind == "ones":
        q = np.ones((B, Sq), np.int32)
        return fa.SegmentIds(q=torch.from_numpy(q),
                             kv=torch.from_numpy(q.copy()))
    if kind == "packed":        # lengths drawn from the seed, padded tail
        q = np.zeros((B, Sq), np.int32)
        for b in range(B):
            pos, seg = 0, 1
            while pos < Sq - 7:
                n = int(rs.randint(5, max(6, Sq // 2)))
                q[b, pos:pos + n] = seg
                pos, seg = pos + n, seg + 1
        return fa.SegmentIds(q=torch.from_numpy(q),
                             kv=torch.from_numpy(q.copy()))
    if kind == "masked_rows":   # rows whose keys are all masked
        q = np.ones((B, Sq), np.int32)
        kv = np.ones((B, Sk), np.int32)
        q[0, rs.choice(Sq, size=min(3, Sq), replace=False)] = 9
        return fa.SegmentIds(q=torch.from_numpy(q), kv=torch.from_numpy(kv))
    raise ValueError(kind)


MASK_CASES = [
    # B, Sq, Sk, causal, segments
    (1, 339, 339, True, "ones"),      # the Llama prefill
    (2, 339, 339, True, "packed"),
    (3, 600, 600, True, "packed"),    # the Llama training layer
    (2, 64, 729, False, None),        # the resampler
    (1, 729, 729, False, None),       # SigLIP
    (1, 1, 1, True, None),
    (1, 63, 65, False, None),
    (1, 65, 63, True, None),
    (2, 129, 729, True, None),        # causal, Sq < Sk
    (1, 729, 129, True, None),        # causal, Sq > Sk
    (2, 70, 70, True, "masked_rows"),
    (2, 200, 300, False, "masked_rows"),
]


@pytest.mark.parametrize("block_q", fa.K1_BLOCK_Q)
@pytest.mark.parametrize("B,Sq,Sk,causal,kind", MASK_CASES)
def test_k1_tile_rule_covers_the_dense_mask(block_q, B, Sq, Sk, causal,
                                            kind):
    """Every tile the kernel does not load is fully masked for the block's
    rows, and every tile it takes unmasked is fully visible to the warp's
    rows, against the mask the plain version builds."""
    rs = np.random.RandomState(Sq * 1000 + Sk)
    seg = _segments(kind, B, Sq, Sk, rs)
    q = torch.from_numpy(rs.randn(B, Sq, 1, 8).astype(np.float32))
    k = torch.from_numpy(rs.randn(B, Sk, 1, 8).astype(np.float32))
    _, mask = fa._masked_logits(q, k, causal, seg, 1.0)
    mask = mask.reshape(-1, Sq, Sk).expand(B, Sq, Sk)
    unmasked = 0
    for b in range(B):
        for q0 in range(0, Sq, block_q):
            rows = slice(q0, min(q0 + block_q, Sq))
            n_kv = fa.k1_kv_tiles(q0, block_q, Sq, Sk, causal)
            assert not mask[b, rows, n_kv * block_q:].any()
            for j in range(n_kv):
                k0 = j * block_q
                keys = slice(k0, min(k0 + block_q, Sk))
                for r0 in range(q0, min(q0 + block_q, Sq), fa.K1_WARP_ROWS):
                    wrows = slice(r0, min(r0 + fa.K1_WARP_ROWS, Sq))
                    ids = {} if seg is None else dict(
                        q_ids=seg.q[b, wrows], kv_ids=seg.kv[b, keys])
                    if not fa.k1_needs_mask(r0, k0, block_q, Sk, causal,
                                            **ids):
                        unmasked += 1
                        assert mask[b, wrows, keys].all(), (b, r0, k0)
    if Sq >= 339 and kind != "packed" or (Sq, kind) == (600, "packed"):
        assert unmasked > 0     # the rule is not "mask every tile"


def test_k1_needs_mask_rule():
    # a full tile below the diagonal of a one-segment warp: no mask
    ids = dict(q_ids=torch.ones(16, dtype=torch.int32),
               kv_ids=torch.ones(64, dtype=torch.int32))
    assert not fa.k1_needs_mask(128, 64, 64, 339, True, **ids)
    # the ragged last tile, the diagonal, a second segment in the tile
    assert fa.k1_needs_mask(128, 320, 64, 339, False)
    assert fa.k1_needs_mask(64, 64, 64, 339, True)
    two = torch.ones(64, dtype=torch.int32)
    two[40:] = 2
    assert fa.k1_needs_mask(128, 64, 64, 339, True,
                            q_ids=ids["q_ids"], kv_ids=two)
    # a warp whose rows all lie past Sq masks (its rows are never written)
    assert fa.k1_needs_mask(400, 0, 64, 339, False,
                            q_ids=torch.ones(0, dtype=torch.int32),
                            kv_ids=ids["kv_ids"])
