"""Decode an Ogg Vorbis file to a WAV file, or stream it as raw s16le paced
at the audio rate (analog of lewton's examples/player.rs, which plays
through OpenAL; the default sink here is a .wav next to the input).

    python -m lewton_tpu_torch.examples.player FILE.ogg [OUT.wav] \\
        [--backend numpy|native|torch] [--realtime]

``torch`` decodes on the card; ``numpy`` and ``native`` are the CPU
decoders. With ``--realtime`` the PCM goes to OUT (stdout for ``-`` or
none) packet by packet, e.g. ``... --realtime - | aplay -f S16_LE -r 44100
-c 2``.
"""

import argparse
import struct
import sys
import time

from ..inside_ogg import BACKENDS, OggStreamReader


def write_wav(path, pcm_i16, rate):
    """Minimal RIFF/WAVE writer: 16-bit PCM, interleaved [n, ch]."""
    n, ch = pcm_i16.shape
    data = pcm_i16.astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(data)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, ch, rate, rate * ch * 2,
                            ch * 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(data)))
        f.write(data)


def stream_realtime(r, sink, rate):
    """Decode packet by packet and write raw interleaved s16le to ``sink``,
    paced at the wall-clock audio rate; returns the samples written."""
    t0 = time.monotonic()
    emitted = 0
    while (pcm := r.read_dec_packet_itl()) is not None:
        if not pcm.size:
            continue
        due = t0 + emitted / rate
        now = time.monotonic()
        if due > now:
            time.sleep(due - now)
        sink.write(pcm.astype("<i2").tobytes())
        sink.flush()
        emitted += pcm.size // max(r.ident_hdr.channels, 1)
    return emitted


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m lewton_tpu_torch.examples.player")
    ap.add_argument("input")
    ap.add_argument("output", nargs="?")
    ap.add_argument("--backend", default="native", choices=BACKENDS)
    ap.add_argument("--realtime", action="store_true",
                    help="stream raw s16le to OUTPUT (or stdout with '-') "
                    "paced at the audio rate, packet by packet")
    args = ap.parse_args(argv)
    r = OggStreamReader(args.input, backend=args.backend)
    rate = r.ident_hdr.sample_rate
    if args.realtime:
        if args.output in (None, "-"):
            n = stream_realtime(r, sys.stdout.buffer, rate)
        else:
            with open(args.output, "wb") as sink:
                n = stream_realtime(r, sink, rate)
        print(f"streamed {n} samples @ {rate} Hz in realtime",
              file=sys.stderr)
        return
    out = args.output or args.input.rsplit(".", 1)[0] + ".wav"
    pcm = r.read_all_i16()
    write_wav(out, pcm, rate)
    secs = pcm.shape[0] / rate
    print(f"wrote {out}: {pcm.shape[0]} samples x {pcm.shape[1]} ch "
          f"({secs:.2f}s @ {rate} Hz)")


if __name__ == "__main__":
    main()
