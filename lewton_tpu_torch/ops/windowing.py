"""Windowing and overlap-add, with a stream axis.

Ports lewton_tpu/ops/windowing.py: ``init_window_carry`` (:57-63), the f32
overlap-add ``overlap_add_batch`` (:66-148) as plain torch ops (XLA fused
it in the reference; no kernel exists for it), ``compact_i16`` (:29-54),
and the bookkeeping around the overlap kernel in its three input forms,
``overlap_add_i16_kernel_batch`` (:151-222): the per-packet scalar table
(13 columns, same map) and the carry's ``plen``/``started``. The reference
runs one stream under ``vmap``; here every [T] quantity is [S, T] and the
carry leaves have a leading stream axis.
"""

from __future__ import annotations

import torch

from .overlap_kernel import (overlap_i16, overlap_i16_audio,
                             overlap_i16_audio_ref, overlap_i16_ref,
                             overlap_i16_split, overlap_i16_split_ref)

__all__ = ["init_window_carry", "overlap_table", "overlap_add_i16_kernel_batch",
           "overlap_add_batch", "compact_i16"]


def init_window_carry(channels: int, w: int, streams: int, device="cuda"):
    """Fresh carry for S streams on ``device`` (the card unless the caller
    names another): (pwr [S, C, W] f32, plen [S] i32, started [S] bool)."""
    return (torch.zeros((streams, channels, w), dtype=torch.float32,
                        device=device),
            torch.zeros((streams,), dtype=torch.int32, device=device),
            torch.zeros((streams,), dtype=torch.bool, device=device))


def _carry_out(new_pwr, new_plen, valid, carry):
    """The carry after each stream's last valid packet (valid packets are
    a chunk prefix): (pwr [S, C, W], plen [S], started [S]); a stream with
    no valid packet keeps its carry."""
    pwr0, plen0, started0 = carry
    S = valid.shape[0]
    nvalid = valid.to(torch.int32).sum(1)
    last = torch.clamp(nvalid - 1, min=0)
    any_valid = nvalid > 0
    s = torch.arange(S, device=valid.device)
    plen_out = torch.where(any_valid, new_plen[s, last], plen0)
    pwr_out = (None if new_pwr is None else
               torch.where(any_valid[:, None, None], new_pwr[s, last], pwr0))
    return pwr_out, plen_out, started0 | any_valid


def overlap_add_batch(audio, blockflag, prev_flag, next_flag, valid, slope0,
                      slope1, n0: int, n1: int, carry, out=None):
    """f32 overlap-add for S streams from the full IMDCT output.

    audio: f32 [S, T, C, n1] (short blocks in [:n0]); blockflag i32,
    prev_flag/next_flag/valid bool: [S, T] (valid a prefix per stream);
    carry (pwr [S, C, W], plen [S], started [S]); ``out``: f32
    [S, T, C, 3n1/4] to write the samples into, or None. Returns ((out f32
    [S, T, C, 3n1/4], out_len i32 [S, T]), new_carry). Same ops as the
    reference in the same order, except that the mix is computed over the
    first W columns only (past W the reference mixes zero slopes and zero
    carry, and its overlap mask is off there)."""
    W = n1 // 2
    outw = 3 * n1 // 4
    pwr0, plen0, started0 = carry
    dev = audio.device
    long_blk = blockflag == 1

    def i32(x):  # a device fill (no host-to-device copy)
        return torch.full((), x, dtype=torch.int32, device=dev)

    def pad_w(x):
        return torch.nn.functional.pad(x, (0, W - x.shape[-1]))

    # right region -> the next packet's pwr: short [n0/2, n0); long & next
    # [W, n1); long & !next the short window centred in the long block
    sel = torch.where(long_blk, torch.where(next_flag, i32(0), i32(1)),
                      i32(2))[..., None, None]
    new_pwr = torch.where(
        sel == 0, audio[..., W:],
        torch.where(sel == 1,
                    pad_w(audio[..., (3 * n1 - n0) // 4:(3 * n1 + n0) // 4]),
                    pad_w(audio[..., n0 // 2:n0])))
    new_plen = torch.where(long_blk & next_flag, i32(W), i32(n0 // 2))

    # packet t consumes packet t-1's right region
    pwr_seq = torch.cat([pwr0[:, None], new_pwr[:, :-1]], 1)
    plen_seq = torch.cat([plen0[:, None], new_plen[:, :-1]], 1)
    vi = valid.to(torch.int32)
    started_seq = started0[:, None] | ((torch.cumsum(vi, 1) - vi) > 0)

    # the current block shifted so that its left region starts at 0
    ls = (n1 - n0) // 4
    a_shift = torch.where(
        (long_blk & ~prev_flag)[..., None, None],
        torch.nn.functional.pad(audio[..., ls:], (0, ls)), audio)[..., :outw]
    use_s1 = long_blk & prev_flag
    lhs = torch.where(use_s1[..., None], slope1, slope0)  # [S, T, W]
    rev0 = torch.cat([slope0[: n0 // 2].flip(0),
                      torch.zeros(W - n0 // 2, dtype=slope0.dtype, device=dev)])
    rhs = torch.where((plen_seq == W)[..., None], slope1.flip(0), rev0)
    overlap_len = torch.minimum(plen_seq,
                                torch.where(use_s1, i32(W), i32(n0 // 2)))
    iota = torch.arange(outw, device=dev)
    in_ov = (iota[:W] < overlap_len[..., None])[..., None, :]  # [S, T, 1, W]
    head = a_shift[..., :W]
    mixed = torch.cat([
        torch.where(in_ov, head * lhs[..., None, :] + pwr_seq * rhs[..., None, :],
                    head),
        a_shift[..., W:]], -1)

    right_start = torch.where(long_blk & ~next_flag, i32((3 * n1 - n0) >> 2),
                              torch.where(long_blk, i32(W), i32(n0 >> 1)))
    left_start = torch.where(long_blk & ~prev_flag, i32((n1 - n0) >> 2), i32(0))
    out_len = torch.where(valid & started_seq, right_start - left_start,
                          i32(0))
    out = torch.where((iota < out_len[..., None])[..., None, :], mixed,
                      torch.zeros((), dtype=mixed.dtype, device=dev), out=out)
    return (out, out_len), _carry_out(new_pwr, new_plen, valid, carry)


def compact_i16(out, out_len, cap: int):
    """Pack each stream's ragged per-packet PCM into one contiguous i16
    buffer: out f32 [S, T, C, outw] (zero past out_len), out_len [S, T] ->
    (pcm i16 [S, cap, C], total i32 [S]).

    The buffer is the reference's bit for bit, zeros past ``total``
    included. The reference writes each packet full width at its running
    offset in packet order (``dynamic_update_slice``, whose start is clamped
    to ``cap - outw``), so a later packet overwrites the padding tail of the
    one before. Here the offsets come from one cumulative sum and every
    buffer position gathers from the last packet whose write covers it, in
    one pass over [S, cap, C] with no loop over packets. i16 conversion:
    x32768, clamp, truncate toward zero. Needs cap >= outw; callers choose
    cap >= total + n1, as for the reference."""
    S, T, C, outw = out.shape
    if cap < outw:
        raise ValueError(f"compact_i16: cap {cap} < packet width {outw}")
    i16 = torch.trunc(torch.clamp(out * 32768.0, -32768.0, 32767.0)).to(
        torch.int16)
    lens = out_len.to(torch.int64)
    start = torch.clamp(torch.cumsum(lens, 1) - lens, max=cap - outw)
    pos = torch.arange(cap, device=out.device).expand(S, cap).contiguous()
    t = torch.searchsorted(start, pos, right=True) - 1  # start[:, 0] == 0
    off = pos - torch.gather(start, 1, t)
    s = torch.arange(S, device=out.device)[:, None]
    vals = i16[s, t, :, torch.clamp(off, max=outw - 1)]  # [S, cap, C]
    pcm = torch.where((off < outw)[..., None], vals, torch.zeros_like(vals))
    return pcm, lens.sum(1).to(torch.int32)


def overlap_table(blockflag, prev_flag, next_flag, valid, slope0, slope1,
                  n0: int, n1: int, plen0, started0):
    """The overlap kernel's per-packet scalars and window slopes.

    Returns (scal f32 [S, T, 13], slopes f32 [4, n1/2], out_len i32 [S, T],
    new_plen i32 [S, T]). Column map (lewton_tpu/ops/windowing.py:199-207):
    0 use_s1, 1 plen==W, 2 lapped start, 3/4 previous right-region class
    long/short-in-long, 5 t==0, 6 overlap length, 7 out_len, 8 blockflag,
    9 valid, 10/11 own right-region class, 12 previous blockflag."""
    S, T = blockflag.shape
    W = n1 // 2
    dev = blockflag.device
    long_blk = blockflag == 1

    def i32(x):  # a fill on the device: a host scalar copied over would
        # synchronise the stream (a pageable host-to-device copy)
        return torch.full((), x, dtype=torch.int32, device=dev)

    new_plen = torch.where(long_blk & next_flag, i32(W), i32(n0 // 2))
    # right-region class: 0 = long&next, 1 = long&!next (short window
    # centred in the long block), 2 = short
    sel = torch.where(long_blk, torch.where(next_flag, i32(0), i32(1)), i32(2))
    plen_seq = torch.cat([plen0[:, None], new_plen[:, :-1]], 1)
    sel_prev = torch.cat([torch.zeros_like(sel[:, :1]), sel[:, :-1]], 1)
    vi = valid.to(torch.int32)
    before = torch.cumsum(vi, 1) - vi
    started_seq = started0[:, None] | (before > 0)
    use_s1 = long_blk & prev_flag
    overlap_len = torch.minimum(plen_seq,
                                torch.where(use_s1, i32(W), i32(n0 // 2)))
    right_start = torch.where(long_blk & ~next_flag, i32((3 * n1 - n0) >> 2),
                              torch.where(long_blk, i32(W), i32(n0 >> 1)))
    left_start = torch.where(long_blk & ~prev_flag, i32((n1 - n0) >> 2), i32(0))
    out_len = torch.where(valid & started_seq, right_start - left_start,
                          i32(0))

    def f(b):
        return b.to(torch.float32)

    t_iota = torch.arange(T, device=dev)[None, :].expand(S, T)
    scal = torch.stack([
        f(use_s1), f(plen_seq == W), f(long_blk & ~prev_flag),
        f(sel_prev == 0), f(sel_prev == 1), f(t_iota == 0),
        f(overlap_len), f(out_len), f(long_blk), f(valid),
        f(sel == 0), f(sel == 1),
        torch.cat([torch.zeros_like(f(long_blk[:, :1])),
                   f(long_blk[:, :-1])], 1),
    ], dim=-1).contiguous()
    rev0 = torch.cat([slope0[: n0 // 2].flip(0),
                      torch.zeros(W - n0 // 2, dtype=slope0.dtype, device=dev)])
    slopes = torch.stack([slope0, slope1, rev0, slope1.flip(0)]).contiguous()
    return scal, slopes, out_len, new_plen


def overlap_add_i16_kernel_batch(audio, blockflag, prev_flag, next_flag,
                                 valid, slope0, slope1, n0: int, n1: int,
                                 carry, ct_in: bool = False,
                                 x_rep: bool = False, x_split: bool = False,
                                 plain: bool = False, out=None):
    """Overlap-add + i16 for S streams through the overlap kernel, in the
    reference's three input forms (lewton_tpu/ops/windowing.py:151-222):

    - ``x_split``: ((U, V), X short or None), the Wang-split halves of the
      long DCT-IV X, [C, S*T, n1/4] each, and X short [C, S*T, n0/2];
    - ``x_rep`` (needs ``ct_in``): (X long [C, S*T, n1/2], X short or
      None), the half-width DCT-IV outputs;
    - otherwise IMDCT audio [S*T, C, n1] ([C, S*T, n1] with ``ct_in``),
      pre-selected, or a (long, short) pair of un-selected outputs (short
      None when n0 == n1).

    blockflag i32, prev_flag/next_flag/valid bool: [S, T] (valid a prefix
    per stream); carry (pwr [S, C, W], plen [S], started [S]). With
    ``plain`` the kernel's plain version runs on any device. ``out``: i16
    [S, T, C*3n1/4] to write the samples into, or None. Returns ((out i16
    [S, T, C*3n1/4], out_len i32 [S, T]), new_carry)."""
    pwr0, plen0, started0 = carry
    scal, slopes, out_len, new_plen = overlap_table(
        blockflag, prev_flag, next_flag, valid, slope0, slope1, n0, n1,
        plen0, started0)
    tail = (scal, slopes, pwr0, n0, n1)
    if x_split:
        (u, v), x_short = audio
        fn = overlap_i16_split_ref if plain else overlap_i16_split
        out, pwr_out = fn(u, v, x_short, *tail, out=out)
    elif x_rep:
        if not ct_in:
            raise ValueError("the X form takes channel-major input (ct_in)")
        fn = overlap_i16_ref if plain else overlap_i16
        out, pwr_out = fn(*audio, *tail, out=out)
    else:
        long_a, short_a = audio if isinstance(audio, tuple) else (audio, None)
        fn = overlap_i16_audio_ref if plain else overlap_i16_audio
        out, pwr_out = fn(long_a, short_a, *tail, ct_in, out=out)
    _, plen_out, started_out = _carry_out(None, new_plen, valid, carry)
    return (out, out_len), (pwr_out, plen_out, started_out)
