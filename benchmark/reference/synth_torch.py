"""A plain PyTorch reference of the device half of a Vorbis audio packet, for
any channel count, submap mux and coupling chain (floor 1 only), and a
whole-file decoder on it that reuses the NumPy reference's host half.

It is the independent check of what the device computes for a multichannel
setup, written from the Vorbis I spec and not from the program under test
(it imports neither ``lewton_tpu_torch`` nor JAX):

- the floor-1 curve (spec 7.2.4 step 2): the line between successive used
  posts in x order, in closed form (the spec's ``render_line`` steps to
  y0 + sign(dy) floor(|dy| (x - x0) / (x1 - x0)) at x), held at the last
  used post's value up to n/2, then the inverse-dB table (spec 10.1).
  Departure: the spec leaves ``hy`` unset when no post after the first is
  used; here, as in libvorbis and the NumPy reference, it is 0;
- inverse coupling (spec 4.3.5), the mapping's steps in reverse order,
  each step the square-polar rule on its magnitude and angle vectors.
  Departure: none, but a channel in several steps sees each step's output
  in turn, so the order is part of the result;
- the product of curve and residue (spec 4.3.6; a channel whose floor is
  unused gives zeros);
- the IMDCT by its definition (spec 4.3.7, the Vorbis sign and scale:
  y[j] = sum_k X[k] cos(pi/(2n) (2k+1) (2j+1+n/2))), in float64 with the
  cosines' arguments reduced exactly in integers, rounded once to f32;
  TF32 is off;
- the window (spec 4.3.1) and the overlap-add of the previous packet's
  right part, in f32 (spec 4.3.8);
- lewton's i16 conversion: scale by 32768, clamp, truncate toward zero.

:func:`packet_audio` takes the entropy half's output as dense tensors, rows
of packets: the mode, the residue vectors [C, >= n/2] before coupling, the
floors' use, and each channel's posts in x order (index-space values, the
floor multiplier applied) with their used flags, as
``audio.decode_packet_entropy`` gives them. :func:`decode` reads a whole
file with the NumPy reference's Ogg reader and entropy half and returns
interleaved i16 PCM [n, C], cut as ``decode.Reference`` cuts it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .audio import _window_geometry, decode_packet_entropy
from .errors import AudioBadFormat, AudioIsHeader
from .header import read_header_ident, read_header_setup
from .ogg_demux import PacketReader
from .tables import floor1_inverse_db_table

__all__ = ["Layout", "layout_of", "packet_spectra", "packet_audio",
           "overlap_add", "to_i16", "decode_frames", "decode"]

#: x of a post slot a floor does not have: past every block
NO_POST = 1 << 20


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclass
class Layout:
    """What the device half needs of a setup: block sizes, each mode's
    block flag and coupling steps (magnitude, angle) in stream order, and
    the sorted x positions of each (mode, channel)'s floor-1 posts."""

    n0: int
    n1: int
    blockflag: list[int]  # [M]
    coupling: list[list[tuple[int, int]]]  # [M] steps, in the mapping's order
    xs: list[list[np.ndarray]]  # [M][C] sorted post x positions

    @property
    def channels(self) -> int:
        return len(self.xs[0])

    @property
    def posts(self) -> int:
        return max(len(x) for row in self.xs for x in row)


def layout_of(ident, setup) -> Layout:
    """The :class:`Layout` of a parsed setup (the NumPy reference's header
    records, or any with the same fields). Floor 0 is not covered."""
    blockflag, coupling, xs = [], [], []
    for mode in setup.modes:
        mp = setup.mappings[mode.mapping]
        row = []
        for c in range(ident.channels):
            fl = setup.floors[mp.submap_floor[mp.mux[c]]]
            if fl.floor_type != 1:
                raise NotImplementedError("floor 0 has no torch reference")
            row.append(np.sort(np.asarray(fl.x_list, np.int64)))
        blockflag.append(int(mode.blockflag))
        coupling.append(list(zip(mp.coupling_magnitude, mp.coupling_angle)))
        xs.append(row)
    return Layout(ident.bs0, ident.bs1, blockflag, coupling, xs)


def _curves(xs, ys, flags, width: int) -> torch.Tensor:
    """Floor-1 curves f32 [B, width] of B post sets: ``xs`` i64 [B, P]
    sorted (``NO_POST`` past a floor's posts), ``ys`` index-space values
    and ``flags`` the used flags in the same order."""
    dev = ys.device
    B, P = ys.shape
    # the first post (x 0) starts every curve; a post past the floor's is
    # never used
    used = flags.clone()
    used[:, 0] = True
    used &= xs < NO_POST
    # the used posts first, in x order
    key, order = torch.sort(torch.where(used, xs, NO_POST), dim=1,
                            stable=True)
    y = torch.gather(ys, 1, order)
    n_used = used.sum(1)
    last = (n_used - 1).clamp(min=0)
    hx = torch.gather(key, 1, last[:, None])[:, 0]
    hy = torch.gather(y, 1, last[:, None])[:, 0]
    hx = torch.where(n_used > 1, hx, torch.zeros_like(hx))
    hy = torch.where(n_used > 1, hy, torch.zeros_like(hy))
    x = torch.arange(width, device=dev, dtype=torch.int64).expand(B, width)
    lo = (torch.searchsorted(key.contiguous(), x.contiguous(), right=True)
          - 1).clamp(0, P - 1)
    hi = (lo + 1).clamp(max=P - 1)
    x0, x1 = torch.gather(key, 1, lo), torch.gather(key, 1, hi)
    y0, y1 = torch.gather(y, 1, lo), torch.gather(y, 1, hi)
    dy = y1 - y0
    adx = (x1 - x0).clamp(min=1)
    line = y0 + torch.sign(dy) * torch.div(dy.abs() * (x - x0), adx,
                                           rounding_mode="floor")
    idx = torch.where(x < hx[:, None], line, hy[:, None]).clamp(0, 255)
    table = torch.from_numpy(np.array(floor1_inverse_db_table())).to(dev)
    return table[idx]


def _couple(residue: torch.Tensor, steps) -> torch.Tensor:
    """Inverse coupling of residue [R, C, W], the steps in reverse."""
    for mag, ang in reversed(steps):
        m, a = residue[:, mag], residue[:, ang]
        mpos, apos = m > 0, a > 0
        new_m = torch.where(mpos, torch.where(apos, m, m + a),
                            torch.where(apos, m, m - a))
        new_a = torch.where(mpos, torch.where(apos, m - a, m),
                            torch.where(apos, m + a, m))
        residue[:, mag], residue[:, ang] = new_m, new_a
    return residue


def _imdct_matrix(n: int, device) -> torch.Tensor:
    """f64 [n/2, n]: cos(pi/(2n) (2k+1) (2j+1+n/2)), the integer product
    reduced modulo 4n (the cosine's period in these units) first."""
    k = torch.arange(n // 2, dtype=torch.int64, device=device)
    j = torch.arange(n, dtype=torch.int64, device=device)
    r = torch.remainder((2 * k[:, None] + 1) * (2 * j[None, :] + 1 + n // 2),
                        4 * n)
    return torch.cos(r.to(torch.float64) * (np.pi / (2 * n)))


def _device(a, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    return a.device if isinstance(a, torch.Tensor) else torch.device("cpu")


def _on(a, dev, dtype) -> torch.Tensor:
    return torch.as_tensor(a if isinstance(a, torch.Tensor)
                           else np.asarray(a)).to(dev, dtype)


def packet_spectra(layout: Layout, mode, residue, used, ys, flags,
                   device=None) -> torch.Tensor:
    """Spectra f32 [R, C, n1/2] of R packets (a short block's in [:n0/2],
    zeros past it): coupling undone, times the floor curves. ``mode`` i64
    [R]; ``residue`` [R, C, w] before coupling, any w (zeros past it; the
    part past n/2 is not read); ``used`` bool [R, C]; ``ys`` / ``flags``
    [R, C, >= P] in x order."""
    dev = _device(residue, device)
    mode, used = _on(mode, dev, torch.int64), _on(used, dev, torch.bool)
    ys, flags = _on(ys, dev, torch.int64), _on(flags, dev, torch.bool)
    residue = _on(residue, dev, torch.float32)
    R, C = used.shape
    n0, n1 = layout.n0, layout.n1
    W = n1 // 2
    res = torch.zeros((R, C, W), dtype=torch.float32, device=dev)
    w = min(W, residue.shape[-1])
    res[:, :, :w] = residue[:, :, :w]
    P = layout.posts
    spectra = torch.zeros_like(res)
    for m in range(len(layout.blockflag)):
        rows = torch.nonzero(mode == m).flatten()
        if not len(rows):
            continue
        half = (n1 if layout.blockflag[m] else n0) // 2
        r = _couple(res[rows, :, :half].clone(), layout.coupling[m])
        xs = np.full((C, P), NO_POST, np.int64)
        for c, x in enumerate(layout.xs[m]):
            xs[c, :len(x)] = x
        xs = torch.from_numpy(xs).to(dev).expand(len(rows), C, P)
        curve = _curves(xs.reshape(-1, P), ys[rows, :, :P].reshape(-1, P),
                        flags[rows, :, :P].reshape(-1, P), half)
        curve = curve.reshape(len(rows), C, half)
        spectra[rows, :, :half] = torch.where(used[rows][:, :, None],
                                              curve * r, 0.0)
    return spectra


def packet_audio(layout: Layout, mode, residue, used, ys, flags,
                 device=None) -> torch.Tensor:
    """IMDCT outputs f32 [R, C, n1] of R packets (a short block's in
    [:n0], zeros past it), from :func:`packet_spectra`'s inputs."""
    _no_tf32()
    spectra = packet_spectra(layout, mode, residue, used, ys, flags, device)
    dev, (R, C, _) = spectra.device, spectra.shape
    n0, n1 = layout.n0, layout.n1
    out = torch.zeros((R, C, n1), dtype=torch.float32, device=dev)
    bf = torch.tensor(layout.blockflag, device=dev)[
        _on(mode, dev, torch.int64)]
    for flag, n in ((1, n1), (0, n0)):
        rows = torch.nonzero(bf == flag).flatten()
        if len(rows):
            x = spectra[rows, :, :n // 2].to(torch.float64)
            out[rows, :, :n] = (x @ _imdct_matrix(n, dev)).to(torch.float32)
    return out


def _slope(half: int, device) -> torch.Tensor:
    """The window's rising half (spec 4.3.1): sin(pi/2 sin^2(pi (i + 1/2)
    / (2 half))), in f64, rounded once to f32."""
    i = torch.arange(half, dtype=torch.float64, device=device)
    v = torch.sin(0.5 * np.pi * (i + 0.5) / half)
    return torch.sin(0.5 * np.pi * v * v).to(torch.float32)


def overlap_add(layout: Layout, audio: torch.Tensor, blockflag: int,
                prev_flag: bool, next_flag: bool, prev):
    """(PCM f32 [C, samples], the right part to keep) of one packet's IMDCT
    output ``audio`` [C, >= n] after the right part ``prev`` of the packet
    before (None before the first: no PCM)."""
    n1, n0 = layout.n1, layout.n0
    ident = _Blocks(n0, n1)
    left, right, right_end, left_long = _window_geometry(
        ident, blockflag, prev_flag, next_flag)
    keep = audio[:, right:right_end]
    if prev is None:
        return audio[:, :0], keep
    plen = prev.shape[1]
    lhs = _slope((n1 if left_long else n0) // 2, audio.device)[:plen]
    pcm = audio[:, left:right].clone()
    pcm[:, :plen] = audio[:, left:left + plen] * lhs + prev * lhs.flip(0)
    return pcm, keep


@dataclass
class _Blocks:  # the two fields of an ident header the geometry reads
    bs0: int
    bs1: int


def to_i16(x: torch.Tensor) -> torch.Tensor:
    """f32 -> i16: scale by 32768, clamp to [-32768, 32767], truncate."""
    x = x.to(torch.float32).clamp(-2.0, 2.0) * 32768.0
    return torch.trunc(x.clamp(-32768.0, 32767.0)).to(torch.int16)


def decode_frames(layout: Layout, fr: dict, device=None):
    """Decode frames of S streams of T packets each (the program's dense
    frame layout: ``mode``, ``prev_flag``, ``next_flag``, ``valid`` [S, T],
    ``residue`` [S, T, C*w] or [S, T, C, w], ``f_used`` [S, T, C],
    ``f1_ys`` / ``f1_flags`` [S, T, C, P] in x order), each stream from an
    empty window. Returns [[PCM f32 [C, samples] of each valid packet]
    of each stream]."""
    S, T = np.asarray(fr["mode"]).shape
    C = layout.channels

    def flat(k):
        a = np.asarray(fr[k])
        return a.reshape((S * T,) + a.shape[2:])

    res = flat("residue").reshape(S * T, C, -1)
    audio = packet_audio(layout, flat("mode"), res, flat("f_used"),
                         flat("f1_ys"), flat("f1_flags"), device)
    audio = audio.reshape(S, T, C, layout.n1)
    mode, valid = np.asarray(fr["mode"]), np.asarray(fr["valid"])
    pf, nf = np.asarray(fr["prev_flag"]), np.asarray(fr["next_flag"])
    pcm = []
    for s in range(S):
        prev, out = None, []
        for t in range(T):
            if not valid[s, t]:
                continue
            p, prev = overlap_add(layout, audio[s, t],
                                  layout.blockflag[mode[s, t]],
                                  bool(pf[s, t]), bool(nf[s, t]), prev)
            out.append(p)
        pcm.append(out)
    return pcm


def decode(data: bytes, device=None) -> np.ndarray:
    """Interleaved i16 PCM [samples, channels] of the first logical stream
    of ``data``: the NumPy reference's Ogg reader and entropy half, this
    file's device half, cut at the end-of-stream granule as lewton's
    reader (and ``decode.Reference``) cuts it."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    rdr = PacketReader(data)
    heads, serial = [], None
    while len(heads) < 3:
        p = rdr.read_packet()
        if p is None:
            raise AudioBadFormat("stream ends inside its headers")
        serial = p.stream_serial if serial is None else serial
        if p.stream_serial == serial:
            heads.append(p.data)
    ident = read_header_ident(heads[0])
    setup = read_header_setup(heads[2], ident)
    layout = layout_of(ident, setup)
    C, P = ident.channels, layout.posts
    plans, pages = [], []
    while (p := rdr.read_packet()) is not None:
        if p.stream_serial != serial:
            continue
        try:
            plans.append(decode_packet_entropy(ident, setup, p.data))
        except (AudioBadFormat, AudioIsHeader):
            continue  # no PCM, window state untouched
        pages.append((p.last_in_stream, p.last_in_page, p.absgp_page))
    R = len(plans)
    res = np.zeros((R, C, layout.n1 // 2), np.float32)
    used = np.zeros((R, C), bool)
    ys = np.zeros((R, C, P), np.int64)
    flags = np.zeros((R, C, P), bool)
    for i, plan in enumerate(plans):
        res[i, :, :plan.n // 2] = plan.residue
        for c, f in enumerate(plan.floors):
            if f[0] != "f1":
                continue
            so = f[1].floor.sort_order
            used[i, c] = True
            ys[i, c, :len(so)] = np.asarray(f[1].final_y)[so]
            flags[i, c, :len(so)] = np.asarray(f[1].step2_flag)[so]
    modes = np.array([p.mode_number for p in plans], np.int64)
    audio = packet_audio(layout, modes, res, used, ys, flags, device)
    out, prev, cur_absgp = [], None, 0
    for i, plan in enumerate(plans):
        pcm, prev = overlap_add(layout, audio[i], plan.mode_blockflag,
                                plan.prev_window_flag, plan.next_window_flag,
                                prev)
        last_in_stream, last_in_page, absgp = pages[i]
        keep = pcm.shape[1]
        if cur_absgp is not None and last_in_stream:
            keep = min(keep, max(0, (absgp or 0) - cur_absgp))
        if last_in_page and absgp is not None:
            cur_absgp = absgp
        elif cur_absgp is not None:
            cur_absgp += keep
        out.append(pcm[:, :keep])
    pcm = (torch.cat(out, dim=1) if out
           else torch.zeros((C, 0), dtype=torch.float32))
    return to_i16(pcm).T.contiguous().cpu().numpy()
