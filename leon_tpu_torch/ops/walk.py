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

Kernels K18 and K19 (csrc/walk.cu): K4's encode and decode re-walk for
17 <= k <= 255, width-free (the base leaving the window is read from a
ring of the walked bases in shared memory, its size set by k alone), the
main path's route for 32 <= k <= 255:
``walk_encode_words`` (K4's outputs, so ``walk_pack`` serves both) and
``walk_decode_words`` (scal of width 9+W, W = ceil(k/16), up to 25).
``encode_batch_compact_packed`` and ``decode_batch_flat_packed`` pick the
kernel by k. walk_encode_plain and walk_decode_plain, over (B, W) words,
are the plain versions of both generations.

Kernel K15 (csrc/walk.cu), also one thread per read, for k <= 255:

- ``encode_batch``: the reference's dense, slot-ordered event tensors
  (walk.py:621-665, the tensor-level interface), from unpacked codes; its
  plain version ``encode_batch_plain`` runs ``walk_planes_plain`` (the
  anchor state and the two one-sided scans, walk.py:357-402) and the
  reference's slotify, gap and confirmed-mask steps.

Each has a plain PyTorch version, a step-by-step translation of the JAX
scan over (B,) tensors, which the wrappers take for CPU tensors. u32
values ride in int64 masked to 32 bits.

Host half: copies of walk.py:567-618 (unpack_compact), 668-671
(unpack_dense), 680-683 (unpack_conf16_bits) and 810-816
(unpack_codes_u32_np).
"""

from __future__ import annotations

import numpy as np
import torch

from leon_tpu_torch import kernels
from leon_tpu_torch.ops import bloom
from leon_tpu_torch.ops.kmer import (MAX_K, MAX_K_WORDS, MIN_K_WIDE, i32_bits, need_words_k,
                                      shl2, shr2_ins, unpack_codes, words_for_k)

_M32 = 0xFFFFFFFF


def _i16(x: torch.Tensor) -> torch.Tensor:
    """int64 holding u16 values -> int16 with the same bits."""
    return torch.where(x >= 1 << 15, x - (1 << 16), x).to(torch.int16)


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
    (walk.py:299-313), the window (B, W) words. Returns (cfs, crs, sis
    int64 0/1)."""
    t = 2 * (k - 1)
    o = torch.where(in_r, (fwd[:, t // 32] >> (t % 32)) & 3, fwd[:, 0] & 3)
    return _candidates_o(in_r, o, f, r, tab, bitset, H, n_words)


def _candidates_o(in_r, o, f, r, tab, bitset, H: int, n_words: int):
    """_candidates given o, the base leaving the window (the k-mer's first
    base on a right step, its last on a left step)."""
    T, Tc, Trot, Tcrot = ([int(v) for v in tab[i]] for i in range(4))
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
    """The next window: shl2 masked to 2k bits on a right step, the
    reference's unmasked shr2_ins on a left step."""
    return torch.where(in_r[:, None], shl2(fwd, b, k), shr2_ins(fwd, b, k))


def _pack_window(codes, pos, k: int):
    """(B, W) int64-held u32 forward words of codes[i, pos[i] : pos[i]+k]
    (walk.py:147-161: base i at bit 2(k-1-i), columns clipped to L-1)."""
    B, L = codes.shape
    win = torch.gather(codes, 1,
                       torch.clamp(pos[:, None] + torch.arange(k, device=codes.device), max=L - 1))
    words = torch.zeros(B, words_for_k(k), dtype=torch.int64, device=codes.device)
    for i in range(k):
        t = 2 * (k - 1 - i)
        words[:, t // 32] |= win[:, i] << (t % 32)
    return words


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


def _check_walk_args(packed, lengths, bitset, n_words: int, k: int, H: int, L: int,
                     max_k: int, min_k: int = 1) -> None:
    kernels.need(min_k <= k <= max_k, f"walk: k={k} not in [{min_k}, {max_k}]")
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
    _check_walk_args(packed, lengths, bitset, n_words, k, H, L, MAX_K)
    if not kernels.on_cuda(packed, "walk_encode"):
        return walk_encode_plain(packed, lengths, bitset, n_words, k, H, seed, L, with_conf)
    return _encode_launch(packed, lengths, bitset, n_words, k, H, seed, L, with_conf, False)


def _encode_launch(packed, lengths, bitset, n_words: int, k: int, H: int, seed: int, L: int,
                   with_conf: bool, words: bool) -> dict:
    """K4 (words False) or K18 on the card into freshly allocated outputs."""
    packed, lengths, bitset = packed.contiguous(), lengths.contiguous(), bitset.contiguous()
    B = packed.shape[0]
    ME = L - k
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
        name = "walk_encode_words" if words else "walk_encode"
        head = (packed.data_ptr(), lengths.data_ptr(), B, packed.shape[1], L, k, H, int(n_words))
        tail = (tab.ctypes.data, bitset.data_ptr(), int(with_conf), ME,
                out["meta"].data_ptr(), out["tot"].data_ptr(), out["ev_gap"].data_ptr(),
                out["ev_nt"].data_ptr(), out["ev_bif"].data_ptr(), out["conf"].data_ptr(),
                kernels.stream(packed))
        lib = kernels.lib()
        rc = (lib.lt_walk_encode_words if words else lib.lt_walk_encode)(*head, *tail)
        kernels.check(rc, name)
        kernels.launches[name] += 1
    return out


def _anchor_plain(codes: torch.Tensor, lengths: torch.Tensor, bitset: torch.Tensor, k: int,
                  H: int, n_words: int, tab):
    """The reference's anchor scan and choice (walk.py:113-144, 357-381) on
    (B, L) int64 codes and lengths: (anchored, apos, f and r at the
    anchor). Scans all L columns; positions past len - k never anchor."""
    dev = codes.device
    B, L = codes.shape
    P = L - k + 1
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
    ar = torch.arange(B, device=dev)
    return anchored, apos, hf[ar, apos], hr[ar, apos]


def walk_encode_words(packed: torch.Tensor, lengths: torch.Tensor, bitset: torch.Tensor,
                      n_words: int, k: int, H: int, seed: int, L: int,
                      with_conf: bool) -> dict:
    """walk_encode for 17 <= k <= 255 (kernel K18; the main path takes it
    for 32 <= k <= 255): the same arguments and outputs."""
    _check_walk_args(packed, lengths, bitset, n_words, k, H, L, MAX_K_WORDS, MIN_K_WIDE)
    if not kernels.on_cuda(packed, "walk_encode_words"):
        return walk_encode_plain(packed, lengths, bitset, n_words, k, H, seed, L, with_conf)
    return _encode_launch(packed, lengths, bitset, n_words, k, H, seed, L, with_conf, True)


def walk_encode_plain(packed: torch.Tensor, lengths: torch.Tensor, bitset: torch.Tensor,
                      n_words: int, k: int, H: int, seed: int, L: int,
                      with_conf: bool) -> dict:
    """Plain version of walk_encode (K4) and walk_encode_words (K18), k <=
    255: the reference's anchor scan (walk.py:113-144, 357-381) and fused
    walk (247-354), step by step, the window as (B, W) words."""
    _check_walk_args(packed, lengths, bitset, n_words, k, H, L, MAX_K_WORDS)
    dev = packed.device
    codes = unpack_codes(packed, L)
    B = codes.shape[0]
    ME = max(1, L - k)
    tab = bloom.tables(seed, k)
    lengths = lengths.to(torch.int64)
    ar = torch.arange(B, device=dev)
    anchored, apos, a1, a2 = _anchor_plain(codes, lengths, bitset, k, H, n_words, tab)
    afwd = _pack_window(codes, apos, k)

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
        fwd = torch.where(sw[:, None], afwd, fwd)
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
    Returns (buffer, cap_err, cap_bif). k <= 31 walks with K4, 32 <= k <=
    255 with K18; walk_pack serves both."""
    enc = (walk_encode if k <= MAX_K else walk_encode_words)(
        packed, lengths, bitset, n_words, k, H, seed, L, with_conf)
    incl = torch.cumsum(enc["tot"], dim=1)
    if cap_err is None or cap_bif is None:
        totals = incl[:, -1].cpu().tolist() if packed.shape[0] else [0, 0]
        cap_err = -(-int(totals[0]) // 8) * 8 if cap_err is None else cap_err
        cap_bif = -(-int(totals[1]) // 8) * 8 if cap_bif is None else cap_bif
    return walk_pack(enc, incl, L, k, cap_err, cap_bif, with_conf), cap_err, cap_bif


# ---------------------------------------------------------------------------
# Dense encode (k <= 255): kernel K15 and its plain version
# ---------------------------------------------------------------------------

# encode_batch's outputs in the reference's order; "s" = (B,), "e" = (B, ME),
# "l" = (B, L)
DENSE = (("anchored", "s", torch.bool), ("apos", "s", torch.int32),
         ("nbif_r", "s", torch.int32), ("nerr_r", "s", torch.int32),
         ("nbif_l", "s", torch.int32), ("nerr_l", "s", torch.int32),
         ("bif_r", "e", torch.uint8), ("errpos_r", "e", torch.int32),
         ("errnt_r", "e", torch.uint8), ("gap_r", "e", torch.int32),
         ("bif_l", "e", torch.uint8), ("errpos_l", "e", torch.int32),
         ("errnt_l", "e", torch.uint8), ("gap_l", "e", torch.int32),
         ("confirmed", "l", torch.bool))


def _check_dense_args(codes, lengths, bitset, n_words: int, k: int, H: int) -> None:
    need_words_k(k, "encode_batch")
    kernels.need(codes.dtype == torch.uint8 and codes.dim() == 2 and codes.shape[1] >= k,
                 "encode_batch: codes must be (B, L >= k) uint8")
    kernels.need(lengths.dtype == torch.int32 and lengths.shape == (codes.shape[0],),
                 "encode_batch: lengths must be (B,) int32")
    kernels.need(bitset.dtype == torch.int32 and bitset.dim() == 1
                 and 0 < n_words <= min(bitset.shape[0], bloom.MAX_WORDS),
                 "encode_batch: bitset must be (>= n_words,) int32")
    kernels.need(codes.device == lengths.device == bitset.device,
                 "encode_batch: tensors on two devices")
    kernels.need(1 <= H <= 8, f"encode_batch: H={H} not in [1, 8]")


def encode_batch(codes: torch.Tensor, lengths: torch.Tensor, bitset: torch.Tensor, k: int,
                 H: int, n_words: int, seed: int) -> dict:
    """Dense, slot-ordered event tensors of a read batch (counterpart of
    leon_tpu walk.encode_batch, walk.py:621-665; kernel K15 walk_dense).

    codes (B, L) uint8 base codes 0..3, lengths (B,) int32, bitset int32
    (>= n_words,). Returns the reference's 15 arrays with its dtypes:
    anchored (B,) bool; apos, nbif_r, nerr_r, nbif_l, nerr_l (B,) int32;
    per side (r, l) bif and errnt (B, ME) uint8, errpos (absolute) and gap
    (side-local) (B, ME) int32, zero past each side's event count;
    confirmed (B, L) bool. ME = max(1, L - k)."""
    _check_dense_args(codes, lengths, bitset, n_words, k, H)
    if not kernels.on_cuda(codes, "encode_batch"):
        return encode_batch_plain(codes, lengths, bitset, k, H, n_words, seed)
    codes, lengths, bitset = codes.contiguous(), lengths.contiguous(), bitset.contiguous()
    B, L = codes.shape
    ME = max(1, L - k)
    dims = {"s": (B,), "e": (B, ME), "l": (B, L)}
    out = {n: torch.empty(dims[d], dtype=t, device=codes.device) for n, d, t in DENSE}
    if B:
        ptrs = np.array([out[n].data_ptr() for n, _, _ in DENSE], dtype=np.uint64)
        tab = kernels.host_tables(bloom.tables(seed, k))
        packed = torch.empty((B, (L + 15) // 16), dtype=torch.int32, device=codes.device)
        rc = kernels.lib().lt_walk_dense(
            codes.data_ptr(), lengths.data_ptr(), B, L, k, H, int(n_words), tab.ctypes.data,
            bitset.data_ptr(), ME, ptrs.ctypes.data, packed.data_ptr(), kernels.stream(codes))
        kernels.check(rc, "walk_dense")
        kernels.launches["walk_dense"] += 1
    return out


def _walk_side_plain(codes, lengths, apos, anchored, state0, bitset, k: int, H: int,
                     n_words: int, tab, right: bool, ME: int):
    """One walk direction, step by step (walk.py:171-244): the window as
    (B, W) int64 words, shl2 on the right, the unmasked shr2_ins on the
    left. Returns step planes (B, ME): is_bif, rank, is_err, ent, is_conf."""
    B, L = codes.shape
    dev = codes.device
    s_all = torch.arange(ME, device=dev)[None, :]
    j_all = apos[:, None] + k + s_all if right else apos[:, None] - 1 - s_all
    active_all = anchored[:, None] & (j_all >= 0) & (j_all < lengths[:, None])
    b_all = torch.gather(codes, 1, torch.clamp(j_all, 0, L - 1))
    in_r = torch.full((B,), right, dtype=torch.bool, device=dev)
    t_out = 2 * (k - 1) if right else 0
    fwd, f, r = state0
    ys = []
    for s in range(ME):
        b, active = b_all[:, s], active_all[:, s]
        o = (fwd[:, t_out // 32] >> (t_out % 32)) & 3
        cfs, crs, sis = _candidates_o(in_r, o, f, r, tab, bitset, H, n_words)
        scount = sis[0] + sis[1] + sis[2] + sis[3]
        cums = [sis[0], sis[0] + sis[1], sis[0] + sis[1] + sis[2], scount]
        solid_b = _sel4(sis, b) == 1
        rank = _sel4(cums, b) - 1
        ns = [1 - x for x in sis]
        cns = [ns[0], ns[0] + ns[1], ns[0] + ns[1] + ns[2], ns[0] + ns[1] + ns[2] + ns[3]]
        ent = _sel4(cns, b) - 1
        is_err = active & ~solid_b
        b_adv = torch.where(is_err & (scount >= 1), _first([x > 0 for x in sis]), b)
        f = _sel4(cfs, b_adv)
        r = _sel4(crs, b_adv)
        fwd = shl2(fwd, b_adv, k) if right else shr2_ins(fwd, b_adv, k)
        ys.append((active & solid_b & (scount >= 2), rank, is_err, ent,
                   active & solid_b & (scount == 1)))
    return tuple(torch.stack(y, dim=1) for y in zip(*ys))


def walk_planes_plain(codes: torch.Tensor, lengths: torch.Tensor, bitset: torch.Tensor, k: int,
                      H: int, n_words: int, seed: int) -> dict:
    """The reference's walk_planes (walk.py:384-402): anchor search, then
    each direction's step planes (B, ME) from the anchor state. Codes are
    taken & 3."""
    _check_dense_args(codes, lengths, bitset, n_words, k, H)
    ME = max(1, codes.shape[1] - k)
    c = codes.to(torch.int64) & 3
    lens = lengths.to(torch.int64)
    tab = bloom.tables(seed, k)
    anchored, apos, a1, a2 = _anchor_plain(c, lens, bitset, k, H, n_words, tab)
    state0 = (_pack_window(c, apos, k), a1, a2)
    out = dict(anchored=anchored, apos=apos)
    for side, right in (("r", True), ("l", False)):
        planes = _walk_side_plain(c, lens, apos, anchored, state0, bitset, k, H, n_words, tab,
                                  right, ME)
        for name, p in zip(("bif", "rank", "err", "bnt", "conf"), planes):
            out[f"{name}_{side}"] = p
    return out


def encode_batch_plain(codes: torch.Tensor, lengths: torch.Tensor, bitset: torch.Tensor, k: int,
                       H: int, n_words: int, seed: int) -> dict:
    """Plain version of encode_batch: walk_planes_plain, then the
    reference's slotify, _gap_plane and _conf_mask (walk.py:633-665)."""
    e = walk_planes_plain(codes, lengths, bitset, k, H, n_words, seed)
    dev = codes.device
    B, L = codes.shape
    ME = max(1, L - k)
    s = torch.arange(ME, device=dev)[None, :]

    def slotify(plane, vals, dtype):
        slot = torch.cumsum(plane.to(torch.int64), dim=1) - 1
        idx = torch.where(plane, slot, ME)
        out = torch.zeros(B, ME + 1, dtype=torch.int64, device=dev)
        out.scatter_(1, idx, torch.where(plane, vals.to(torch.int64), 0))
        return out[:, :ME].to(dtype)

    def gap_plane(is_err):
        prev = torch.cummax(torch.where(is_err, s, -1), dim=1).values
        prev = torch.cat([torch.full((B, 1), -1, dtype=torch.int64, device=dev),
                          prev[:, :-1]], dim=1)
        return s - prev - 1

    apos = e["apos"]
    j = {"r": apos[:, None] + k + s, "l": apos[:, None] - 1 - s}
    conf = torch.zeros(B, L + 1, dtype=torch.bool, device=dev)
    out = dict(anchored=e["anchored"], apos=apos.to(torch.int32))
    for side in ("r", "l"):
        out[f"nbif_{side}"] = e[f"bif_{side}"].sum(dim=1).to(torch.int32)
        out[f"nerr_{side}"] = e[f"err_{side}"].sum(dim=1).to(torch.int32)
    for side in ("r", "l"):
        err = e[f"err_{side}"]
        out[f"bif_{side}"] = slotify(e[f"bif_{side}"], e[f"rank_{side}"], torch.uint8)
        out[f"errpos_{side}"] = slotify(err, j[side], torch.int32)
        out[f"errnt_{side}"] = slotify(err, e[f"bnt_{side}"], torch.uint8)
        out[f"gap_{side}"] = slotify(err, gap_plane(err), torch.int32)
        hi = L if side == "r" else L - 1
        col = torch.where(e[f"conf_{side}"], torch.clamp(j[side], 0, hi), L)
        conf.scatter_(1, col, torch.ones_like(col, dtype=torch.bool))
    out["confirmed"] = conf[:, :L]
    return {n: out[n] for n, _, _ in DENSE}


def unpack_dense(enc_np: dict, n: int) -> dict:
    """Adapt a host-transferred encode_batch dict to BlockEncoder's dense
    form: the first n (true) reads (a copy of leon_tpu walk.py:668-671)."""
    return {kk: v[:n] for kk, v in enc_np.items()}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _check_decode_args(scal, errgaps, errnts, bifs, bitset, n_words, k, H, L,
                       max_k: int, min_k: int = 1) -> None:
    kernels.need(min_k <= k <= max_k, f"walk_decode: k={k} not in [{min_k}, {max_k}]")
    kernels.need(scal.dtype == torch.int32 and scal.dim() == 2
                 and scal.shape[1] == 9 + words_for_k(k),
                 f"walk_decode: scal must be (B, 9+W) int32, W = {words_for_k(k)}")
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
    walk.py:819-839), k <= 31 (kernel K4). scal: (B, 9+W) int32 columns
    [apos, anchored, length, nerr_r, nerr_l, nbif_r, nbif_l, err_base,
    bif_base, anchor words]; errgaps (n_err,) int32, errnts (n_err,) uint8,
    bifs (n_bif,) uint8: the chunk's flat event streams, read-major, right
    then left. Returns (B, ceil(L/16)) int32 holding bases packed 16 per u32
    (pack_codes_u32 layout); positions outside each read's walk are 0."""
    _check_decode_args(scal, errgaps, errnts, bifs, bitset, n_words, k, H, L, MAX_K)
    if not kernels.on_cuda(scal, "walk_decode"):
        return walk_decode_plain(scal, errgaps, errnts, bifs, bitset, n_words, k, H, seed, L)
    return _decode_launch(scal, errgaps, errnts, bifs, bitset, n_words, k, H, seed, L, False)


def walk_decode_words(scal: torch.Tensor, errgaps: torch.Tensor, errnts: torch.Tensor,
                      bifs: torch.Tensor, bitset: torch.Tensor, n_words: int, k: int, H: int,
                      seed: int, L: int) -> torch.Tensor:
    """walk_decode for 17 <= k <= 255 (kernel K19; the main path takes it
    for 32 <= k <= 255): scal (B, 9+W), W = ceil(k/16) = 2..16, up to 25
    columns."""
    _check_decode_args(scal, errgaps, errnts, bifs, bitset, n_words, k, H, L, MAX_K_WORDS,
                       MIN_K_WIDE)
    if not kernels.on_cuda(scal, "walk_decode_words"):
        return walk_decode_plain(scal, errgaps, errnts, bifs, bitset, n_words, k, H, seed, L)
    return _decode_launch(scal, errgaps, errnts, bifs, bitset, n_words, k, H, seed, L, True)


def decode_batch_flat_packed(scal, errgaps, errnts, bifs, bitset, n_words: int, k: int, H: int,
                             seed: int, L: int) -> torch.Tensor:
    """The reference's decode_batch_flat_packed: K4 for k <= 31, K19 for
    32 <= k <= 255."""
    return (walk_decode if k <= MAX_K else walk_decode_words)(
        scal, errgaps, errnts, bifs, bitset, n_words, k, H, seed, L)


def _decode_launch(scal, errgaps, errnts, bifs, bitset, n_words: int, k: int, H: int, seed: int,
                   L: int, words: bool) -> torch.Tensor:
    B, cols = scal.shape
    L16 = (L + 15) // 16
    out = torch.empty(B, L16, dtype=torch.int32, device=scal.device)
    if B:
        scal, errgaps, errnts = scal.contiguous(), errgaps.contiguous(), errnts.contiguous()
        bifs, bitset = bifs.contiguous(), bitset.contiguous()
        tab = kernels.host_tables(bloom.tables(seed, k))
        name = "walk_decode_words" if words else "walk_decode"
        args = (scal.data_ptr(), B, cols - 9, errgaps.data_ptr(), errnts.data_ptr(),
                bifs.data_ptr(), errgaps.shape[0], bifs.shape[0], L, L16, k, H, int(n_words))
        tail = (tab.ctypes.data, bitset.data_ptr(), out.data_ptr(), kernels.stream(scal))
        lib = kernels.lib()
        rc = (lib.lt_walk_decode_words if words else lib.lt_walk_decode)(*args, *tail)
        kernels.check(rc, name)
        kernels.launches[name] += 1
    return out


def walk_decode_plain(scal: torch.Tensor, errgaps: torch.Tensor, errnts: torch.Tensor,
                      bifs: torch.Tensor, bitset: torch.Tensor, n_words: int, k: int,
                      H: int, seed: int, L: int) -> torch.Tensor:
    """Plain version of walk_decode (K4) and walk_decode_words (K19), k <=
    255: decode_batch_flat, decode_batch and _walk_decode_fused
    (walk.py:700-936), step by step, the window as (B, W) words."""
    _check_decode_args(scal, errgaps, errnts, bifs, bitset, n_words, k, H, L, MAX_K_WORDS)
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
    afwd = s64[:, 9 : 9 + W] & _M32
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
    t = 2 * (k - 1 - torch.clamp(rel, 0, k - 1))
    anchor_code = (torch.gather(afwd, 1, t // 32) >> (t % 32)) & 3
    out = torch.where(in_anchor, anchor_code, 0)
    out = torch.cat([out, torch.zeros(B, 1, dtype=torch.int64, device=dev)], dim=1)

    f, r = bloom.hash_words_plain(afwd, k, tab)
    a1, a2 = f, r
    qs = torch.arange(2 * ME, device=dev)[None, :]
    qr = bf_r[ar[:, None], torch.clamp(qs, 0, ME - 1)]
    ql = bf_l[ar[:, None], torch.clamp(qs - nbif_r[:, None], 0, ME - 1)]
    qbif = torch.where(qs < nbif_r[:, None], qr, ql)

    fwd = afwd
    pbif = torch.zeros(B, dtype=torch.int64, device=dev)
    for s in range(ME):
        in_r, sw, lidx, j, active = _schedule(lengths, apos, anchored, s, k)
        fwd = torch.where(sw[:, None], afwd, fwd)
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
    return i32_bits((pad.reshape(B, L16, 16) << sh).sum(dim=2))


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
