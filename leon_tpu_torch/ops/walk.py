"""Anchor search + bidirectional de Bruijn walk, encode and decode
(counterpart of leon_tpu/ops/walk.py; the walk policy is frozen by
FORMAT.md §6).

Device half (new), kernel K4 (csrc/walk.cu), one CUDA thread per read:

- ``walk_encode``: anchor search and the fused right-then-left walk; per-read
  counts and the read's events in walk order (replaces _anchor_state and
  _walk_fused, walk.py:113-161, 247-381).
- ``walk_pack``: the reference's flat u16 buffer, byte for byte
  (walk.py:432-543), from walk_encode's output and the per-read exclusive
  prefix (``torch.cumsum``).
- ``walk_decode``: the decode re-walk from the flat event streams, bases
  packed 16 per u32 (walk.py:700-936).

Each has a plain PyTorch version, a step-by-step translation of the JAX
scan over (B,) tensors, which the wrappers take for CPU tensors. u32
values ride in int64 masked to 32 bits.

Host half: copies of walk.py:567-618 (unpack_compact), 680-683
(unpack_conf16_bits) and 810-816 (unpack_codes_u32_np).
"""

from __future__ import annotations

import numpy as np
import torch

from leon_tpu_torch import kernels
from leon_tpu_torch.ops import bloom
from leon_tpu_torch.ops.kmer import MAX_K, unpack_codes

_M32 = 0xFFFFFFFF


def _i16(x: torch.Tensor) -> torch.Tensor:
    """int64 holding u16 values -> int16 with the same bits."""
    return torch.where(x >= 1 << 15, x - (1 << 16), x).to(torch.int16)


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding u32 values -> int32 with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _sel4(vals, idx: torch.Tensor) -> torch.Tensor:
    """vals[idx] over a python list of four (B,) tensors."""
    return torch.where(idx == 0, vals[0],
           torch.where(idx == 1, vals[1],
           torch.where(idx == 2, vals[2], vals[3])))


def _first(flags) -> torch.Tensor:
    """Index of the first True of four (B,) masks, 0 when none."""
    z = torch.zeros_like(flags[0], dtype=torch.int64)
    return torch.where(flags[0], z,
           torch.where(flags[1], z + 1,
           torch.where(flags[2], z + 2,
           torch.where(flags[3], z + 3, z))))


def _rol1(x):
    return bloom.rol(x, 1)


def _ror1(x):
    return bloom.ror(x, 1)


def _candidates(in_r, fwd, f, r, k: int, tab, bitset, H: int, n_words: int):
    """One walk step's 4 candidate (f, r) chains and their solidity
    (walk.py:299-313). Returns (cfs, crs, sis int64 0/1)."""
    T, Tc, Trot, Tcrot = ([int(v) for v in tab[i]] for i in range(4))
    o = torch.where(in_r, (fwd >> (2 * (k - 1))) & 3, fwd & 3)
    fb_r = _rol1(f ^ bloom.take4(tab[2], o))
    rb_r = _ror1(r ^ bloom.take4(tab[1], o))
    fb_l = _ror1(f ^ bloom.take4(tab[0], o))
    rb_l = _rol1(r ^ bloom.take4(tab[3], o))
    cfs, crs, sis = [], [], []
    for c in range(4):
        cf = torch.where(in_r, fb_r ^ T[c], fb_l ^ Trot[c])
        cr = torch.where(in_r, rb_r ^ Tcrot[c], rb_l ^ Tc[c])
        sis.append(bloom.probe_plain(bitset, cf, cr, H, n_words).to(torch.int64))
        cfs.append(cf)
        crs.append(cr)
    return cfs, crs, sis


def _advance(in_r, fwd, b, k: int):
    kmask = (1 << (2 * k)) - 1
    return torch.where(in_r, ((fwd << 2) | b) & kmask, (fwd >> 2) | (b << (2 * (k - 1))))


def _schedule(lengths, apos, anchored, s: int, k: int):
    """Fused-walk schedule at step s (walk.py:271-282): (in_r, switch,
    side-local index, position j, active)."""
    nr = torch.clamp(lengths - k - apos, min=0)
    total = torch.clamp(lengths - k, min=0)
    in_r = s < nr
    lidx = torch.where(in_r, torch.full_like(nr, s), s - nr)
    j = torch.where(in_r, apos + k + s, apos - 1 - lidx)
    return in_r, nr == s, lidx, j, anchored & (s < total)


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------


def _check_walk_args(packed, lengths, bitset, n_words: int, k: int, H: int, L: int) -> None:
    kernels.need(1 <= k <= MAX_K, f"walk: k={k} > {MAX_K} needs multiword keys")
    kernels.need(L >= k + 1, f"walk: batch width {L} < k+1")
    kernels.need(packed.dtype == torch.int32 and packed.dim() == 2
                 and packed.shape[1] == (L + 15) // 16,
                 "walk_encode: packed must be (B, ceil(L/16)) int32")
    kernels.need(lengths.dtype == torch.int32 and lengths.shape == (packed.shape[0],),
                 "walk_encode: lengths must be (B,) int32")
    kernels.need(bitset.dtype == torch.int32 and bitset.dim() == 1
                 and 0 < n_words <= bitset.shape[0],
                 "walk: bitset must be (>= n_words,) int32")
    kernels.need(lengths.device == packed.device == bitset.device,
                 "walk_encode: tensors on two devices")
    kernels.need(1 <= H <= 8, f"walk: H={H} not in [1, 8]")


def walk_encode(packed: torch.Tensor, lengths: torch.Tensor, bitset: torch.Tensor,
                n_words: int, k: int, H: int, seed: int, L: int,
                with_conf: bool) -> dict:
    """Anchor search + fused walk of a packed read batch.

    Returns a dict of tensors:
      meta (B, 6) int32: anchored, apos, nbif_r, nerr_r, nbif_l, nerr_l;
      tot (2, B) int32: the read's error and bifurcation event counts;
      ev_gap (B, ME) int16: error gaps (u16), ev_nt (B, ME) uint8: errnt
        ranks, ev_bif (B, ME) uint8: bif ranks — each read's events in walk
        order (right side, then left), valid in the first tot slots;
      conf (B, ceil(L/16)) int16: confirmed-position bits (u16), or (B, 0)
        without with_conf."""
    _check_walk_args(packed, lengths, bitset, n_words, k, H, L)
    if not kernels.on_cuda(packed, "walk_encode"):
        return walk_encode_plain(packed, lengths, bitset, n_words, k, H, seed, L, with_conf)
    packed, lengths, bitset = packed.contiguous(), lengths.contiguous(), bitset.contiguous()
    B = packed.shape[0]
    ME = max(1, L - k)
    L16c = (L + 15) // 16 if with_conf else 0
    dev = packed.device
    out = dict(
        meta=torch.empty(B, 6, dtype=torch.int32, device=dev),
        tot=torch.empty(2, B, dtype=torch.int32, device=dev),
        ev_gap=torch.empty(B, ME, dtype=torch.int16, device=dev),
        ev_nt=torch.empty(B, ME, dtype=torch.uint8, device=dev),
        ev_bif=torch.empty(B, ME, dtype=torch.uint8, device=dev),
        conf=torch.empty(B, L16c, dtype=torch.int16, device=dev),
    )
    if B:
        tab = kernels.host_tables(bloom.tables(seed, k))
        rc = kernels.lib().lt_walk_encode(
            packed.data_ptr(), lengths.data_ptr(), B, packed.shape[1], L, k, H,
            int(n_words), tab.ctypes.data, bitset.data_ptr(), int(with_conf), ME,
            out["meta"].data_ptr(), out["tot"].data_ptr(), out["ev_gap"].data_ptr(),
            out["ev_nt"].data_ptr(), out["ev_bif"].data_ptr(), out["conf"].data_ptr(),
            kernels.stream(packed))
        kernels.check(rc, "walk_encode")
        kernels.launches["walk_encode"] += 1
    return out


def walk_encode_plain(packed: torch.Tensor, lengths: torch.Tensor, bitset: torch.Tensor,
                      n_words: int, k: int, H: int, seed: int, L: int,
                      with_conf: bool) -> dict:
    """Plain version of walk_encode: the reference's anchor scan
    (walk.py:113-144, 357-381) and fused walk (247-354), step by step."""
    _check_walk_args(packed, lengths, bitset, n_words, k, H, L)
    dev = packed.device
    codes = unpack_codes(packed, L)
    B = codes.shape[0]
    ME = max(1, L - k)
    P = L - k + 1
    tab = bloom.tables(seed, k)
    lengths = lengths.to(torch.int64)
    ar = torch.arange(B, device=dev)

    # anchor scan: rolling (f, r) at every k-mer position
    f = torch.zeros(B, dtype=torch.int64, device=dev)
    r = torch.zeros_like(f)
    hf = torch.empty(B, P, dtype=torch.int64, device=dev)
    hr = torch.empty_like(hf)
    for j in range(L):
        x = codes[:, j]
        if j >= k:
            o = codes[:, j - k]
            f = _rol1(f ^ bloom.take4(tab[2], o)) ^ bloom.take4(tab[0], x)
            r = _ror1(r ^ bloom.take4(tab[1], o)) ^ bloom.take4(tab[3], x)
        else:
            f = _rol1(f) ^ bloom.take4(tab[0], x)
            r = r ^ bloom.rol(bloom.take4(tab[1], x), j)
        if j >= k - 1:
            hf[:, j - k + 1] = f
            hr[:, j - k + 1] = r
    valid = torch.arange(P, device=dev)[None, :] <= (lengths[:, None] - k)
    member = bloom.probe_plain(bitset, hf, hr, H, n_words) & valid
    anchored = member.any(dim=1)
    v = torch.where(member, torch.minimum(hf, hr), torch.full_like(hf, _M32))
    apos = torch.argmin(v, dim=1)  # first index on ties
    win = codes[ar[:, None], torch.clamp(apos[:, None] + torch.arange(k, device=dev), max=L - 1)]
    afwd = torch.zeros(B, dtype=torch.int64, device=dev)
    for i in range(k):
        afwd = (afwd << 2) | win[:, i]
    a1, a2 = hf[ar, apos], hr[ar, apos]

    # fused walk
    fwd, f, r = afwd, a1, a2
    last = torch.full_like(apos, -1)
    cnt = {n: torch.zeros_like(apos) for n in ("nerr_r", "nerr_l", "nbif_r", "nbif_l")}
    ev_gap = torch.zeros(B, ME, dtype=torch.int64, device=dev)
    ev_nt = torch.zeros_like(ev_gap)
    ev_bif = torch.zeros_like(ev_gap)
    conf = torch.zeros(B, L + 1, dtype=torch.bool, device=dev)
    for s in range(ME):
        in_r, sw, lidx, j, active = _schedule(lengths, apos, anchored, s, k)
        fwd = torch.where(sw, afwd, fwd)
        f = torch.where(sw, a1, f)
        r = torch.where(sw, a2, r)
        last = torch.where(sw, -1, last)
        b = codes[ar, torch.clamp(j, 0, L - 1)]
        cfs, crs, sis = _candidates(in_r, fwd, f, r, k, tab, bitset, H, n_words)
        scount = sis[0] + sis[1] + sis[2] + sis[3]
        cums = [sis[0], sis[0] + sis[1], sis[0] + sis[1] + sis[2], scount]
        solid_b = _sel4(sis, b) == 1
        rank = _sel4(cums, b) - 1
        is_conf = active & solid_b & (scount == 1)
        is_bif = active & solid_b & (scount >= 2)
        is_err = active & ~solid_b
        ns = [1 - x for x in sis]
        cns = [ns[0], ns[0] + ns[1], ns[0] + ns[1] + ns[2], ns[0] + ns[1] + ns[2] + ns[3]]
        ent = _sel4(cns, b) - 1
        gap = lidx - last - 1
        last = torch.where(is_err, lidx, last)
        b_min_solid = _first([x > 0 for x in sis])
        b_adv = torch.where(is_err & (scount >= 1), b_min_solid, b)
        f = _sel4(cfs, b_adv)
        r = _sel4(crs, b_adv)
        fwd = _advance(in_r, fwd, b_adv, k)

        e_slot = cnt["nerr_r"] + cnt["nerr_l"]
        ev_gap[ar[is_err], e_slot[is_err]] = torch.clamp(gap, min=0)[is_err]
        ev_nt[ar[is_err], e_slot[is_err]] = ent[is_err]
        b_slot = cnt["nbif_r"] + cnt["nbif_l"]
        ev_bif[ar[is_bif], b_slot[is_bif]] = rank[is_bif]
        cnt["nerr_r"] += (is_err & in_r).to(torch.int64)
        cnt["nerr_l"] += (is_err & ~in_r).to(torch.int64)
        cnt["nbif_r"] += (is_bif & in_r).to(torch.int64)
        cnt["nbif_l"] += (is_bif & ~in_r).to(torch.int64)
        conf[ar[is_conf], torch.clamp(j, 0, L)[is_conf]] = True

    meta = torch.stack([anchored.to(torch.int64), apos, cnt["nbif_r"], cnt["nerr_r"],
                        cnt["nbif_l"], cnt["nerr_l"]], dim=1).to(torch.int32)
    tot = torch.stack([cnt["nerr_r"] + cnt["nerr_l"], cnt["nbif_r"] + cnt["nbif_l"]]).to(torch.int32)
    if with_conf:
        L16 = (L + 15) // 16
        bits = torch.zeros(B, 16 * L16, dtype=torch.int64, device=dev)
        bits[:, :L] = conf[:, :L].to(torch.int64)
        w = torch.ones(16, dtype=torch.int64, device=dev) << torch.arange(16, device=dev)
        conf16 = _i16((bits.reshape(B, L16, 16) * w).sum(dim=2))
    else:
        conf16 = torch.zeros(B, 0, dtype=torch.int16, device=dev)
    return dict(meta=meta, tot=tot, ev_gap=ev_gap.to(torch.int16),
                ev_nt=ev_nt.to(torch.uint8), ev_bif=ev_bif.to(torch.uint8), conf=conf16)


def pack_len(B: int, L: int, k: int, cap_err: int, cap_bif: int, with_conf: bool) -> int:
    """u16 length of the flat encode buffer (walk.py:440-446)."""
    ME = max(1, L - k)
    L16c = (L + 15) // 16 if with_conf else 0
    return 4 + (3 if ME <= 255 else 6) * B + cap_err + cap_err // 8 + cap_bif // 8 + B * L16c


def _check_pack_args(enc: dict, incl: torch.Tensor, cap_err: int, cap_bif: int) -> None:
    kernels.need(cap_err % 8 == 0 and cap_bif % 8 == 0,
                 "walk_pack: event capacities must be multiples of 8")
    B = enc["meta"].shape[0]
    kernels.need(incl.dtype == torch.int64 and incl.shape == (2, B),
                 "walk_pack: incl must be the (2, B) int64 cumsum of tot")


def walk_pack(enc: dict, incl: torch.Tensor, L: int, k: int, cap_err: int,
              cap_bif: int, with_conf: bool) -> torch.Tensor:
    """The reference's flat u16 encode buffer (walk.py:440-446) as int16.
    incl = torch.cumsum(enc["tot"], 1): each read's events start at its
    exclusive prefix; events past a capacity are dropped like the
    reference's scatter (mode="drop")."""
    _check_pack_args(enc, incl, cap_err, cap_bif)
    if not kernels.on_cuda(incl, "walk_pack"):
        return walk_pack_plain(enc, incl, L, k, cap_err, cap_bif, with_conf)
    B, ME = enc["ev_gap"].shape
    dev = incl.device
    n_out = pack_len(B, L, k, cap_err, cap_bif, with_conf)
    out = torch.empty(n_out, dtype=torch.int16, device=dev)
    nt_s = torch.empty(max(cap_err, 1), dtype=torch.uint8, device=dev)
    bif_s = torch.empty(max(cap_bif, 1), dtype=torch.uint8, device=dev)
    L16c = (L + 15) // 16 if with_conf else 0
    t = {n: enc[n].contiguous() for n in ("meta", "tot", "ev_gap", "ev_nt", "ev_bif", "conf")}
    incl = incl.contiguous()
    rc = kernels.lib().lt_walk_pack(
        B, ME, L16c, int(with_conf), int(ME > 255),
        t["meta"].data_ptr(), t["tot"].data_ptr(), incl.data_ptr(),
        t["ev_gap"].data_ptr(), t["ev_nt"].data_ptr(), t["ev_bif"].data_ptr(),
        t["conf"].data_ptr(), cap_err, cap_bif,
        nt_s.data_ptr(), bif_s.data_ptr(), out.data_ptr(), n_out, kernels.stream(incl))
    kernels.check(rc, "walk_pack")
    kernels.launches["walk_pack"] += 1
    return out


def walk_pack_plain(enc: dict, incl: torch.Tensor, L: int, k: int, cap_err: int,
                    cap_bif: int, with_conf: bool) -> torch.Tensor:
    """Plain version of walk_pack (walk.py:460-543)."""
    _check_pack_args(enc, incl, cap_err, cap_bif)
    dev = incl.device
    meta = enc["meta"].to(torch.int64)
    tot = enc["tot"].to(torch.int64)
    B, ME = enc["ev_gap"].shape
    total_err = int(incl[0, -1]) if B else 0
    total_bif = int(incl[1, -1]) if B else 0
    base = incl - tot
    out = torch.zeros(pack_len(B, L, k, cap_err, cap_bif, with_conf), dtype=torch.int64,
                      device=dev)
    out[:4] = torch.tensor([total_err & 0xFFFF, (total_err >> 16) & 0xFFFF,
                            total_bif & 0xFFFF, (total_bif >> 16) & 0xFFFF], device=dev)
    o = 4
    anch, apos, nbif_r, nerr_r, nbif_l, nerr_l = meta.unbind(1)
    if ME <= 255:
        scal = torch.stack([apos | (anch << 15), nerr_r | (nbif_r << 8),
                            nerr_l | (nbif_l << 8)], dim=1)
    else:
        scal = meta
    out[o:o + scal.numel()] = scal.reshape(-1)
    o += scal.numel()

    slot = torch.arange(ME, device=dev)[None, :]

    def flat(vals, which, cap):
        """Events of every read at base + slot, dropped past cap."""
        idx = base[which][:, None] + slot
        keep = (slot < tot[which][:, None]) & (idx < cap)
        res = torch.zeros(cap, dtype=torch.int64, device=dev)
        res[idx[keep]] = vals.to(torch.int64)[keep]
        return res

    def pack2(v):
        sh = 2 * torch.arange(8, device=dev)
        return (v.reshape(-1, 8) << sh).sum(dim=1)

    out[o:o + cap_err] = flat(enc["ev_gap"].to(torch.int64) & 0xFFFF, 0, cap_err)
    o += cap_err
    out[o:o + cap_err // 8] = pack2(flat(enc["ev_nt"], 0, cap_err))
    o += cap_err // 8
    out[o:o + cap_bif // 8] = pack2(flat(enc["ev_bif"], 1, cap_bif))
    o += cap_bif // 8
    if with_conf:
        out[o:] = enc["conf"].to(torch.int64).reshape(-1) & 0xFFFF
    return _i16(out)


def encode_batch_compact_packed(packed, lengths, bitset, k: int, H: int, n_words: int,
                                seed: int, cap_err: int | None, cap_bif: int | None,
                                with_conf: bool, L: int):
    """The reference's encode_batch_compact_packed (walk.py:554-564): the
    flat u16 buffer as an int16 tensor. With cap_err/cap_bif None the caps
    are the chunk's event totals rounded up to 8, so nothing overflows.
    Returns (buffer, cap_err, cap_bif)."""
    enc = walk_encode(packed, lengths, bitset, n_words, k, H, seed, L, with_conf)
    incl = torch.cumsum(enc["tot"], dim=1)
    if cap_err is None or cap_bif is None:
        totals = incl[:, -1].cpu().tolist() if packed.shape[0] else [0, 0]
        cap_err = -(-int(totals[0]) // 8) * 8 if cap_err is None else cap_err
        cap_bif = -(-int(totals[1]) // 8) * 8 if cap_bif is None else cap_bif
    return walk_pack(enc, incl, L, k, cap_err, cap_bif, with_conf), cap_err, cap_bif


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _check_decode_args(scal, errgaps, errnts, bifs, bitset, n_words, k, H, L) -> None:
    kernels.need(1 <= k <= MAX_K, f"walk_decode: k={k} > {MAX_K} needs multiword keys")
    kernels.need(scal.dtype == torch.int32 and scal.dim() == 2 and scal.shape[1] in (10, 11),
                 "walk_decode: scal must be (B, 9+W) int32 with W <= 2")
    kernels.need(scal.shape[1] - 9 == (k + 15) // 16, "walk_decode: scal width != 9+W")
    kernels.need(errgaps.dtype == torch.int32 and errgaps.dim() == 1,
                 "walk_decode: errgaps must be (n_err,) int32")
    kernels.need(errnts.dtype == torch.uint8 and errnts.shape == errgaps.shape,
                 "walk_decode: errnts must be (n_err,) uint8")
    kernels.need(bifs.dtype == torch.uint8 and bifs.dim() == 1,
                 "walk_decode: bifs must be (n_bif,) uint8")
    kernels.need(bitset.dtype == torch.int32 and 0 < n_words <= bitset.shape[0],
                 "walk_decode: bitset must be (>= n_words,) int32")
    kernels.need(scal.device == errgaps.device == errnts.device == bifs.device == bitset.device,
                 "walk_decode: tensors on two devices")
    kernels.need(1 <= H <= 8 and L >= k + 1, "walk_decode: bad H or L")


def walk_decode(scal: torch.Tensor, errgaps: torch.Tensor, errnts: torch.Tensor,
                bifs: torch.Tensor, bitset: torch.Tensor, n_words: int, k: int, H: int,
                seed: int, L: int) -> torch.Tensor:
    """Decode re-walk (the reference's decode_batch_flat_packed,
    walk.py:819-839). scal: (B, 9+W) int32 columns [apos, anchored, length,
    nerr_r, nerr_l, nbif_r, nbif_l, err_base, bif_base, anchor words];
    errgaps (n_err,) int32, errnts (n_err,) uint8, bifs (n_bif,) uint8: the
    chunk's flat event streams, read-major, right then left. Returns
    (B, ceil(L/16)) int32 holding bases packed 16 per u32
    (pack_codes_u32 layout); positions outside each read's walk are 0."""
    _check_decode_args(scal, errgaps, errnts, bifs, bitset, n_words, k, H, L)
    if not kernels.on_cuda(scal, "walk_decode"):
        return walk_decode_plain(scal, errgaps, errnts, bifs, bitset, n_words, k, H, seed, L)
    B, cols = scal.shape
    L16 = (L + 15) // 16
    out = torch.empty(B, L16, dtype=torch.int32, device=scal.device)
    if B:
        scal, errgaps, errnts = scal.contiguous(), errgaps.contiguous(), errnts.contiguous()
        bifs, bitset = bifs.contiguous(), bitset.contiguous()
        tab = kernels.host_tables(bloom.tables(seed, k))
        rc = kernels.lib().lt_walk_decode(
            scal.data_ptr(), B, cols - 9, errgaps.data_ptr(), errnts.data_ptr(),
            bifs.data_ptr(), errgaps.shape[0], bifs.shape[0], L, L16, k, H,
            int(n_words), tab.ctypes.data, bitset.data_ptr(), out.data_ptr(),
            kernels.stream(scal))
        kernels.check(rc, "walk_decode")
        kernels.launches["walk_decode"] += 1
    return out


def walk_decode_plain(scal: torch.Tensor, errgaps: torch.Tensor, errnts: torch.Tensor,
                      bifs: torch.Tensor, bitset: torch.Tensor, n_words: int, k: int,
                      H: int, seed: int, L: int) -> torch.Tensor:
    """Plain version of walk_decode: decode_batch_flat, decode_batch and
    _walk_decode_fused (walk.py:700-936), step by step."""
    _check_decode_args(scal, errgaps, errnts, bifs, bitset, n_words, k, H, L)
    dev = scal.device
    B = scal.shape[0]
    W = scal.shape[1] - 9
    ME = max(1, L - k)
    tab = bloom.tables(seed, k)
    s64 = scal.to(torch.int64)
    apos, lengths = s64[:, 0], s64[:, 2]
    anchored = s64[:, 1] != 0
    nerr_r, nerr_l, nbif_r, nbif_l = s64[:, 3], s64[:, 4], s64[:, 5], s64[:, 6]
    err_base, bif_base = s64[:, 7], s64[:, 8]
    afwd = s64[:, 9] & _M32
    if W == 2:
        afwd = afwd | ((s64[:, 10] & _M32) << 32)
    ar = torch.arange(B, device=dev)
    slot = torch.arange(ME, device=dev)[None, :]

    def plane(flat, base, counts):
        if flat.numel() == 0:
            return torch.zeros(B, ME, dtype=torch.int64, device=dev)
        idx = torch.clamp(base[:, None] + slot, 0, flat.numel() - 1)
        return torch.where(slot < counts[:, None], flat.to(torch.int64)[idx], 0)

    gap_r = plane(errgaps, err_base, nerr_r)
    gap_l = plane(errgaps, err_base + nerr_r, nerr_l)
    en_r = plane(errnts, err_base, nerr_r)
    en_l = plane(errnts, err_base + nerr_r, nerr_l)
    bf_r = plane(bifs, bif_base, nbif_r)
    bf_l = plane(bifs, bif_base + nbif_r, nbif_l)
    ep_r = apos[:, None] + k - 1 + torch.cumsum(gap_r + 1, dim=1)
    ep_l = apos[:, None] - torch.cumsum(gap_l + 1, dim=1)

    def err_plane_of(ep, en, nerr):
        okm = slot < nerr[:, None]
        idx = torch.where(okm, torch.clamp(ep, 0, L - 1), L)
        pl = torch.zeros(B, L + 1, dtype=torch.int64, device=dev)
        pl[ar[:, None].expand(B, ME), idx] = torch.where(okm, en + 4, 0)
        return pl[:, :L]

    err_plane = err_plane_of(ep_r, en_r, nerr_r) | err_plane_of(ep_l, en_l, nerr_l)

    posm = torch.arange(L, device=dev)[None, :]
    rel = posm - apos[:, None]
    in_anchor = (rel >= 0) & (rel < k) & anchored[:, None]
    anchor_code = (afwd[:, None] >> (2 * (k - 1 - torch.clamp(rel, 0, k - 1)))) & 3
    out = torch.where(in_anchor, anchor_code, 0)
    out = torch.cat([out, torch.zeros(B, 1, dtype=torch.int64, device=dev)], dim=1)

    f, r = bloom.hash_keys_plain(afwd, k, tab)
    a1, a2 = f, r
    qs = torch.arange(2 * ME, device=dev)[None, :]
    qr = bf_r[ar[:, None], torch.clamp(qs, 0, ME - 1)]
    ql = bf_l[ar[:, None], torch.clamp(qs - nbif_r[:, None], 0, ME - 1)]
    qbif = torch.where(qs < nbif_r[:, None], qr, ql)

    fwd = afwd
    pbif = torch.zeros(B, dtype=torch.int64, device=dev)
    for s in range(ME):
        in_r, sw, lidx, j, active = _schedule(lengths, apos, anchored, s, k)
        fwd = torch.where(sw, afwd, fwd)
        f = torch.where(sw, a1, f)
        r = torch.where(sw, a2, r)
        ev = err_plane[ar, torch.clamp(j, 0, L - 1)]
        is_err = active & (ev >= 4)
        rank_ns = ev & 3
        cfs, crs, sis = _candidates(in_r, fwd, f, r, k, tab, bitset, H, n_words)
        scount = sis[0] + sis[1] + sis[2] + sis[3]
        is_bif = active & ~is_err & (scount >= 2)
        rank = qbif[ar, torch.clamp(pbif, 0, 2 * ME - 1)]
        excl = [torch.zeros_like(scount), sis[0], sis[0] + sis[1], sis[0] + sis[1] + sis[2]]
        ns = [1 - x for x in sis]
        exns = [torch.zeros_like(scount), ns[0], ns[0] + ns[1], ns[0] + ns[1] + ns[2]]
        b_bif = _first([(sis[c] > 0) & (excl[c] == rank) for c in range(4)])
        b_uniq = _first([sis[c] > 0 for c in range(4)])
        b_err = _first([(ns[c] > 0) & (exns[c] == rank_ns) for c in range(4)])
        b = torch.where(is_err, b_err, torch.where(is_bif, b_bif, b_uniq))
        pbif = pbif + is_bif.to(torch.int64)
        b_adv = torch.where(is_err & (scount >= 1), b_uniq, b)
        f = _sel4(cfs, b_adv)
        r = _sel4(crs, b_adv)
        fwd = _advance(in_r, fwd, b_adv, k)
        out[ar, torch.where(active, torch.clamp(j, 0, L - 1), L)] = torch.where(active, b, 0)
    codes = out[:, :L]
    L16 = (L + 15) // 16
    pad = torch.zeros(B, 16 * L16, dtype=torch.int64, device=dev)
    pad[:, :L] = codes
    sh = 2 * torch.arange(16, device=dev)
    return _i32((pad.reshape(B, L16, 16) << sh).sum(dim=2))


# ---------------------------------------------------------------------------
# Host half: copies of walk.py:567-618, 680-683, 810-816
# ---------------------------------------------------------------------------


def unpack_compact(buf: np.ndarray, n: int, B: int, L: int,
                   cap_err: int, cap_bif: int, with_conf: bool = True,
                   k: int = 0) -> dict | None:
    """Host-side unpack of the flat u16 encode buffer. Returns None on
    capacity overflow. `n` = true reads (pad lanes have anchored=0 and no
    events). `k` selects the packed-scal layout (ME = L - k <= 255 -> 3
    u16/read)."""
    total_err = int(buf[0]) | (int(buf[1]) << 16)
    total_bif = int(buf[2]) | (int(buf[3]) << 16)
    if total_err > cap_err or total_bif > cap_bif:
        return None
    ME = max(1, L - k)
    o = 4
    if k and ME <= 255:
        sp = buf[o : o + 3 * B].reshape(B, 3)
        o += 3 * B
        scal = np.empty((B, 6), dtype=np.uint16)
        scal[:, 0] = sp[:, 0] >> 15                 # anchored
        scal[:, 1] = sp[:, 0] & 0x7FFF              # apos
        scal[:, 2] = sp[:, 1] >> 8                  # nbif_r
        scal[:, 3] = sp[:, 1] & 0xFF                # nerr_r
        scal[:, 4] = sp[:, 2] >> 8                  # nbif_l
        scal[:, 5] = sp[:, 2] & 0xFF                # nerr_l
    else:
        scal = buf[o : o + 6 * B].reshape(B, 6)
        o += 6 * B
    errgap = buf[o : o + cap_err]
    o += cap_err
    errnt16 = buf[o : o + cap_err // 8]
    o += cap_err // 8
    bif16 = buf[o : o + cap_bif // 8]
    o += cap_bif // 8
    L16 = (L + 15) // 16 if with_conf else 0
    conf16 = buf[o : o + B * L16].reshape(B, L16)

    def unpack2_16(v, m):
        out = np.empty((v.shape[0], 8), dtype=np.uint8)
        for i in range(8):
            out[:, i] = (v >> (2 * i)) & 3
        return out.reshape(-1)[:m]

    return dict(
        anchored=scal[:n, 0].astype(bool),
        apos=scal[:n, 1].astype(np.int32),
        nbif_r=scal[:n, 2].astype(np.int32), nerr_r=scal[:n, 3].astype(np.int32),
        nbif_l=scal[:n, 4].astype(np.int32), nerr_l=scal[:n, 5].astype(np.int32),
        errgap_flat=errgap[:total_err],
        errnt_flat=unpack2_16(errnt16, total_err),
        bif_flat=unpack2_16(bif16, total_bif),
        conf16=conf16[:n],
        compact=True,
    )


def unpack_conf16_bits(conf16: np.ndarray, L: int) -> np.ndarray:
    """(B, ceil(L/16)) uint16 -> (B, L) bool confirmed mask."""
    bits = (conf16[:, :, None] >> np.arange(16, dtype=np.uint16)[None, None, :]) & 1
    return bits.reshape(conf16.shape[0], -1)[:, :L].astype(bool)


def unpack_codes_u32_np(packed: np.ndarray, L: int) -> np.ndarray:
    """(B, W16) u32 packed bases -> (B, L) uint8."""
    B = packed.shape[0]
    out = np.empty((B, packed.shape[1], 16), dtype=np.uint8)
    for j in range(16):
        out[:, :, j] = (packed >> np.uint32(2 * j)) & 3
    return out.reshape(B, -1)[:, :L]
