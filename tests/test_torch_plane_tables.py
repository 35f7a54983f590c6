"""PyTorch port, kernel B1's host tables (CPU only): the tiles and level
pieces the plane kernel walks cover every canvas byte exactly once, the
per-level division magic is exact over each level's whole numerator range,
and a numpy emulation of the kernel's tile walk (csrc/planes.cu: packed
taps, blend rows, multiply-high floor, gap bytes written as 0) equals the
plain version on a canvas pre-filled with 0xAB."""

import numpy as np
import pytest
import torch

from waldboost_tpu_torch import channels as tch
from waldboost_tpu_torch import packing, polyphase
from waldboost_tpu_torch.ops import planes as tpl

torch.set_num_threads(1)

COL = {c: i for i, c in enumerate(polyphase.META_COLS)}
PIECE = {c: i for i, c in enumerate(polyphase.PIECE_COLS)}

# (frame, n_per_oct, packer halo): VGA and 1080p grad_hist (baked halo 2),
# VGA and 4K FPGA (halo 0)
PLANS = {"vga": ((480, 640), 8, 1), "1080p": ((1080, 1920), 8, 1),
         "vga_halo0": ((480, 640), 4, 0), "4k_halo0": ((2160, 3840), 4, 0)}


def _tables(name):
    hw, npo, halo = PLANS[name]
    packed = packing._packed_plan_cached(hw[0], hw[1], 2, npo, (12, 12),
                                         halo=halo)
    return packed, polyphase.plane_tables(packed, packed.halo, hw)


def _magic_floor(n, m, s):
    """umulhi(2n, m) >> s on uint64 numpy arrays."""
    return ((2 * n.astype(np.uint64)) * np.uint64(m)) >> np.uint64(32 + s)


def _check_magic(den, m, s, brute_limit=1 << 22):
    assert 0 < m < 1 << 32 and 0 <= s < 32
    k = np.arange(256, dtype=np.uint64)
    # f(N) never decreases with N: equal to k at both ends of
    # [k*den, k*den + den - 1] means equal on all of it
    np.testing.assert_array_equal(_magic_floor(k * np.uint64(den), m, s), k)
    np.testing.assert_array_equal(
        _magic_floor(k[:255] * np.uint64(den) + np.uint64(den - 1), m, s),
        k[:255])
    assert (2 * 255 * den) < 1 << 32
    n_max = 255 * den
    if n_max <= brute_limit:
        n = np.arange(n_max + 1, dtype=np.uint64)
    else:
        n = np.random.RandomState(den % 1000).randint(
            0, n_max + 1, brute_limit).astype(np.uint64)
    np.testing.assert_array_equal(_magic_floor(n, m, s), n // np.uint64(den))


@pytest.mark.parametrize("name", sorted(PLANS))
def test_div_magic_exact_on_plans(name):
    """Every level's (magic, shift) floors every numerator the level can
    make, N in [0, 255 * den_h * den_w]."""
    _, t = _tables(name)
    for row in t.meta:
        den = int(row[COL["den_h"]]) * int(row[COL["den_w"]])
        m = int(np.int32(row[COL["magic"]]).view(np.uint32))
        _check_magic(den, m, int(row[COL["shift"]]))
        assert polyphase.div_magic(den) == (m, int(row[COL["shift"]]))


LIMIT = (2 ** 31 - 1) // 255   # the largest den with 255*den < 2**31


@pytest.mark.parametrize("den", [1, 2, 3, 7, 255, 4096, 65535, 65537,
                                 4141564, 2 ** 22, 2 ** 22 + 1, 2 ** 23 - 1,
                                 2 ** 23, 8388593, LIMIT - 1, LIMIT])
def test_div_magic_adversarial(den):
    m, s = polyphase.div_magic(den)
    _check_magic(den, m, s)


def test_div_magic_rejects_overflow():
    with pytest.raises(ValueError):
        polyphase.div_magic(LIMIT + 1)
    with pytest.raises(ValueError):
        polyphase.div_magic(0)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_tiles_and_pieces_cover_canvas_once(name):
    """Tiles partition the plane canvas; each tile's pieces lie inside it
    and overlap nothing; each level's pieces make up its block exactly; the
    rest is gap.  So every canvas byte (of all four planes, which share the
    tiling) has exactly one writer, and whole aligned words too: a tile
    starts on a word."""
    packed, t = _tables(name)
    PH, PW = t.plane_hw
    TR, TC = t.tile_hw
    assert TC % 4 == 0
    tiles = np.zeros((PH, PW), np.int32)
    for y0, x0, b, e in t.tiles:
        assert y0 % TR == 0 and x0 % TC == 0
        tiles[y0:y0 + TR, x0:x0 + TC] += 1
        for p in t.pieces[b:e]:
            ya, yb, xa, xb = p[:4]
            assert y0 <= ya < yb <= min(y0 + TR, PH)
            assert x0 <= xa < xb <= min(x0 + TC, PW)
    assert (tiles == 1).all()
    assert t.tiles[:, 2].min() == 0 and t.tiles[:, 3].max() == len(t.pieces)
    want = np.full((PH, PW), -1, np.int32)
    for li, row in enumerate(t.meta):
        y0, x0, hq, wq = (row[COL[c]] for c in ("y0", "x0", "hq", "wq"))
        assert (want[y0:y0 + hq, x0:x0 + wq] == -1).all()
        want[y0:y0 + hq, x0:x0 + wq] = li
    owner = np.full((PH, PW), -1, np.int32)
    for p in t.pieces:
        ya, yb, xa, xb = p[:4]
        li = want[ya, xa]
        assert li >= 0 and (owner[ya:yb, xa:xb] == -1).all()
        owner[ya:yb, xa:xb] = li
        # each piece carries its level's parameters
        m = t.meta[li]
        for c in ("oct_off", "ow", "oh", "hq", "den_h", "den_w", "magic",
                  "shift"):
            assert p[PIECE[c]] == m[COL[c]], c
        assert p[PIECE["rbase"]] == m[COL["tap_h"]] - m[COL["y0"]]
        assert p[PIECE["jt"]] == m[COL["tap_w"]] // 2 - m[COL["x0"]]
    np.testing.assert_array_equal(owner, want)
    assert len(t.meta) == len(packed.levels)


def _emulate(octs, t):
    """csrc/planes.cu in numpy: per tile, per (row, phase a), per piece the
    blend row V over [cmin, cmax] and the words of planes (a, 0), (a, 1);
    the canvas starts as 0xAB, so a byte no job writes shows."""
    B = octs.shape[0]
    PH, PW = t.plane_hw
    TR, TC = t.tile_hw
    out = np.full((B, 4, PH, PW), 0xAB, np.uint8)
    for b in range(B):
        img = octs[b].astype(np.int64)
        for y0t, x0t, pb, pe in t.tiles:
            for y in range(y0t, min(y0t + TR, PH)):
                for a in (0, 1):
                    words = np.zeros((2, TC), np.int64)
                    for p in t.pieces[pb:pe]:
                        r = {c: int(v) for c, v in zip(polyphase.PIECE_COLS,
                                                       p)}
                        if not r["ya"] <= y < r["yb"]:
                            continue
                        ow, oh, cmin = r["ow"], r["oh"], r["cmin"]
                        rt = t.rtap[r["rbase"] + a * r["hq"] + y]
                        r0, fr = rt & 0xFFFF, rt >> 16
                        r1 = min(r0 + 1, oh - 1)
                        base = r["oct_off"]
                        cols = np.arange(cmin, cmin + r["n"])
                        assert cols[-1] < ow
                        V = 2 * (r["den_h"] - fr) * img[base + r0 * ow
                                                        + cols] \
                            + 2 * fr * img[base + r1 * ow + cols]
                        assert len(V) <= polyphase.v_max(TC)
                        xa, xb = r["xa"], r["xb"]
                        x = np.arange(xa, xb)
                        c = t.ctap[r["jt"] + x]
                        magic = int(np.int32(r["magic"]).view(np.uint32))
                        for q in (0, 1):
                            c0, fc = (c[:, q] & 0xFFFF) - cmin, c[:, q] >> 16
                            assert (c0 >= 0).all()
                            c1 = np.minimum(c0 + 1, ow - 1 - cmin)
                            n = (r["den_w"] - fc) * V[c0] + fc * V[c1]
                            assert (n < 1 << 32).all()
                            v = (n.astype(np.uint64) * np.uint64(magic)) \
                                >> np.uint64(32 + r["shift"])
                            assert (v <= 255).all()
                            words[q, x - x0t] = v
                    xe = min(x0t + TC, PW)
                    for q in (0, 1):
                        out[b, 2 * a + q, y, x0t:xe] = words[q, :xe - x0t]
    return out


@pytest.mark.parametrize("hw,npo,halo", [((48, 64), 2, 1), ((97, 131), 2, 1),
                                         ((97, 131), 4, 0), ((30, 40), 2, 0)])
def test_tile_walk_emulation_matches_plain(hw, npo, halo):
    rng = np.random.RandomState(hw[0] + npo)
    imgs = torch.from_numpy(rng.randint(0, 256, (2,) + hw).astype(np.uint8))
    packed = packing._packed_plan_cached(hw[0], hw[1], 2, npo, (8, 8),
                                         halo=halo)
    t = polyphase.plane_tables(packed, packed.halo, hw)
    ops = tpl.PlaneOperands.build(t, "cpu")
    octs = tpl.octave_buffer(tch.level_octaves(imgs, len(t.oct_hw)))
    want = tpl.planes_plain(octs, ops).numpy().reshape(
        (2, 4) + t.plane_hw)
    np.testing.assert_array_equal(_emulate(octs.numpy(), t), want)


def test_planes_write_every_byte_of_out():
    """The wrapper's ``out`` buffer: every byte is overwritten (gaps as
    0), on the CPU by the plain version."""
    hw = (48, 64)
    packed = packing._packed_plan_cached(hw[0], hw[1], 2, 2, (8, 8), halo=1)
    t = polyphase.plane_tables(packed, packed.halo, hw)
    ops = tpl.PlaneOperands.build(t, "cpu")
    imgs = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, (2,) + hw).astype(np.uint8))
    octs = tpl.octave_buffer(tch.level_octaves(imgs, len(t.oct_hw)))
    out = torch.full((2, 2, 2) + t.plane_hw, 0xAB, dtype=torch.uint8)
    got = tpl.planes(octs, ops, out=out)
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(out, tpl.planes_plain(octs, ops))
    with pytest.raises(ValueError):
        tpl.planes(octs, ops, out=out[:1])
