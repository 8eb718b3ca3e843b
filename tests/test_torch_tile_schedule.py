"""The tile schedule of the segment mask against the dense mask, on the CPU.

The TMA + wgmma flash kernels (csrc/flash_fwd.cu, the dq and dkv kernels of
csrc/flash_bwd.cu) class every (query tile, key tile) pair before they run:
skip (never loaded), full (no mask) or mixed (per-element mask).  The rule
lives once in ``ops.flash_attention.tile_schedule`` and the kernels mirror it
(``hopper::tile_class``).  A wrong class would drop attended pairs (skip) or
keep masked ones (full), so every class is held against the dense mask of
``attend(i, j) = q[i] == kv[j] && kv[j] != PAD`` with pad past the sequence.
"""

import numpy as np
import pytest
import torch

from simpletuner_tpu_torch.ops.flash_attention import (
    DKV_BLOCKS,
    DKV_BLOCKS_256,
    DQ_BLOCKS,
    DQ_BLOCKS_256,
    FWD_BLOCKS,
    FWD_BLOCKS_256,
    SEGMENT_PAD_ID,
    TILE_FULL,
    TILE_MIXED,
    TILE_SKIP,
    tile_schedule,
)


def _flux_ids(length, txt_len=512, valid=77):
    ids = np.zeros((1, length), np.int32)
    ids[:, valid:txt_len] = SEGMENT_PAD_ID
    return ids


def _packed_ids():
    ids = np.zeros((2, 300), np.int32)
    ids[:, 130:] = 1
    ids[1, 280:] = SEGMENT_PAD_ID
    return ids


def _random_packing(seed, batch=3, length=1500):
    rng = np.random.default_rng(seed)
    ids = np.full((batch, length), SEGMENT_PAD_ID, np.int32)
    for b in range(batch):
        pos, segment = 0, 0
        while pos < length:
            run = int(rng.integers(1, 400))
            ids[b, pos:pos + run] = SEGMENT_PAD_ID if rng.random() < 0.2 else segment
            pos, segment = pos + run, segment + 1
    return ids


def _check_against_dense(q_ids, kv_ids, sq, sk, blocks, batch):
    block_q, block_k = blocks
    q_t = None if q_ids is None else torch.from_numpy(q_ids)
    kv_t = None if kv_ids is None else torch.from_numpy(kv_ids)
    classes = tile_schedule(q_t, kv_t, sq, sk, block_q, block_k, batch=batch).numpy()
    n_q, n_k = -(-sq // block_q), -(-sk // block_k)
    assert classes.shape == (batch, n_q, n_k)

    def padded(ids, length, tiles, block):
        ids = np.zeros((batch, length), np.int32) if ids is None else ids
        out = np.full((batch, tiles * block), SEGMENT_PAD_ID, np.int32)
        out[:, :length] = ids
        return out

    q_all, kv_all = padded(q_ids, sq, n_q, block_q), padded(kv_ids, sk, n_k, block_k)
    dense = (q_all[:, :, None] == kv_all[:, None, :]) & (kv_all[:, None, :] != SEGMENT_PAD_ID)
    for b in range(batch):
        for i in range(n_q):
            for j in range(n_k):
                block = dense[b, i * block_q:(i + 1) * block_q, j * block_k:(j + 1) * block_k]
                cls = classes[b, i, j]
                assert cls in (TILE_SKIP, TILE_FULL, TILE_MIXED)
                if cls == TILE_SKIP:
                    assert not block.any(), (b, i, j)
                elif cls == TILE_FULL:
                    assert block.all(), (b, i, j)
    return classes


CASES = {
    "flux_1024px": (_flux_ids(4608), 4608),
    "flux_ragged_4173": (_flux_ids(4173), 4173),
    "packed_300": (_packed_ids(), 300),
    "ragged_1000_no_ids": (None, 1000),
    "random_packing": (_random_packing(0), 1500),
}


@pytest.mark.parametrize("blocks", [FWD_BLOCKS, DKV_BLOCKS, DQ_BLOCKS, FWD_BLOCKS_256, DKV_BLOCKS_256, DQ_BLOCKS_256],
                         ids=["fwd", "dkv", "dq", "fwd_d256", "dkv_d256", "dq_d256"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_classes_agree_with_the_dense_mask(case, blocks):
    ids, length = CASES[case]
    batch = 1 if ids is None else ids.shape[0]
    classes = _check_against_dense(ids, ids, length, length, blocks, batch)
    if ids is not None:
        assert (classes == TILE_SKIP).any() or case == "ragged_1000_no_ids"


def test_missing_ids_on_one_side():
    kv = _random_packing(1, batch=2, length=700)
    _check_against_dense(None, kv, 500, 700, FWD_BLOCKS, 2)
    _check_against_dense(kv[:, :500], None, 500, 700, DKV_BLOCKS, 2)


def test_flux_schedule_counts():
    # 1024 px Flux: 77 valid T5 tokens of 512, then 4096 image tokens; key
    # tiles 1-3 and query tiles 1-3 are all pad, tile 0 is mixed both ways,
    # the 32 x 32 image tile pairs need no mask
    classes = tile_schedule(torch.from_numpy(_flux_ids(4608)), torch.from_numpy(_flux_ids(4608)),
                            4608, 4608, *FWD_BLOCKS)
    counts = {name: int((classes == cls).sum()) for name, cls in
              (("skip", TILE_SKIP), ("full", TILE_FULL), ("mixed", TILE_MIXED))}
    assert counts == {"skip": 207, "full": 1024, "mixed": 65}
    assert (classes[0, 1:4] == TILE_SKIP).all() and (classes[0, :, 1:4] == TILE_SKIP).all()
    # no ids but a ragged S: the last tile holds pad past the end, so the
    # last query tile and the last key tile are mixed, the rest full
    ragged = tile_schedule(None, None, 1000, 1000, *FWD_BLOCKS)
    assert (ragged[0, :-1, :-1] == TILE_FULL).all()
    assert (ragged[0, -1] == TILE_MIXED).all() and (ragged[0, :, -1] == TILE_MIXED).all()


def test_flux_schedule_counts_dq_blocks():
    # the dq kernel's 128-row query tiles against 64-key tiles: query tiles
    # 1-3 (rows 128-511) are all pad and skip every key tile, as do key tiles
    # 2-7 (keys 128-511) against every query tile; query tile 0 (text and
    # pad) is mixed against every key tile it sees, and so is key tile 1
    # (keys 64-127: the last valid text tokens and pad)
    classes = tile_schedule(torch.from_numpy(_flux_ids(4608)), torch.from_numpy(_flux_ids(4608)),
                            4608, 4608, *DQ_BLOCKS)
    counts = {name: int((classes == cls).sum()) for name, cls in
              (("skip", TILE_SKIP), ("full", TILE_FULL), ("mixed", TILE_MIXED))}
    assert counts == {"skip": 414, "full": 2080, "mixed": 98}
    assert (classes[0, 1:4] == TILE_SKIP).all() and (classes[0, :, 2:8] == TILE_SKIP).all()
    assert (classes[0, 0, [0, 1, *range(8, 72)]] == TILE_MIXED).all() and (classes[0, 4:, 1] == TILE_MIXED).all()
    assert (classes[0, 4:, 0] == TILE_FULL).all() and (classes[0, 4:, 8:] == TILE_FULL).all()
