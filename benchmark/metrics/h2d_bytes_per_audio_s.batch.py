"""Bytes copied host to device per second of audio decoded
(``BatchDecoder.last_stats["h2d_bytes"]``): the transport's encoding of the
frames (i16 or 12-bit packed residue, the small frame arrays)."""


def read(run):
    audio = sum(b["audio_s"] for b in run.batches)
    h2d = sum(b["h2d_bytes"] for b in run.batches)
    return h2d / audio if audio and h2d else None
