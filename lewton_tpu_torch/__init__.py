"""lewton_tpu_torch — the PyTorch + CUDA port of lewton_tpu.

The port decodes Ogg/Vorbis files: the reference's Python host front-end
(Ogg demux, header parsers, entropy decode into dense frames), then its
per-chunk decode (floor spectra -> IMDCT GEMMs -> windowed overlap-add, i16
or f32) on an NVIDIA Hopper card through hand-written CUDA kernels
(``csrc/``: K1 floor spectra, K2 overlap-add + i16, K3 fused floor render),
with a plain PyTorch version of each kernel beside it for CPU runs and for
comparison on the card. Its entry points put tensors on the card unless
the caller names another device. It needs only torch and numpy: nothing
here imports JAX or ``lewton_tpu``. The host modules, constant tables and
synthetic frames it reads are its own copies, which the tests hold equal
to the reference's.

Layout mirrors the reference: ``inside_ogg.py`` (OggStreamReader),
``ogg/``, ``header.py``, ``audio.py``, ``floor.py``, ``residue.py``
(the host front-end), ``models/decoder.py`` (setup tables, the per-chunk
core, pack_frames, StreamDecoder), ``ops/`` (coupling, floor numerics,
floor and synth kernels, IMDCT and DCT-IV GEMMs with the Wang split,
overlap scalar table, overlap kernel), ``parallel/`` (chunk loop,
transport, 12-bit residues, BatchDecoder), ``native/`` (the C++ host
front-end), and the serving surfaces: ``serve.py`` (StreamingScheduler,
many streams in continuous batches), ``aio.py`` (HeadersReader,
AsyncOggStreamReader over an async byte source) and ``profiling.py``
(StageTimer, ``trace`` through torch.profiler). The CPU decoders of the
reference are here too: ``OggStreamReader(backend="numpy")`` (``audio``'s
numpy synthesis, with the ``debug.taps`` record points) and
``backend="native"`` (the C++ decoder), and the lewton-compatible C ABI
(``native/lewton_tpu.h``, ``_build.capi_library``).

Public API (the reference's, lewton_tpu/__init__.py, after lewton
src/lib.rs:16-21): :class:`OggStreamReader`, :func:`read_headers`, the
per-packet :func:`read_header_ident` / :func:`read_header_comment` /
:func:`read_header_setup` + :func:`read_audio_packet` /
:func:`read_audio_packet_generic`, and the :class:`VorbisError`
hierarchy. Importing the package builds and loads no library: the host
library is built at its first use.

Importing the package pins full-fp32 GEMMs: TF32 keeps a 10-bit mantissa,
which is in the class of shortened-mantissa GEMMs that fail the +/-2 LSB
conformance contract (lewton_tpu/ops/imdct.py PRECISION notes).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from .audio import (  # noqa: E402,F401
    PreviousWindowRight,
    get_decoded_sample_count,
    read_audio_packet,
    read_audio_packet_generic,
)
from .errors import (  # noqa: E402,F401
    AudioBadFormat,
    AudioIsHeader,
    BadHeader,
    HeaderIsAudio,
    NotVorbisHeader,
    OggError,
    VorbisError,
)
from .header import (  # noqa: E402,F401
    CommentHeader,
    HeaderSet,
    IdentHeader,
    SetupHeader,
    read_header_comment,
    read_header_ident,
    read_header_setup,
)
from .inside_ogg import OggStreamReader, read_headers  # noqa: E402,F401
from .ogg import Packet, PacketReader  # noqa: E402,F401

__version__ = "0.1.0"
