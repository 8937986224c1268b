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
transport, 12-bit residues, BatchDecoder).

Importing the package pins full-fp32 GEMMs: TF32 keeps a 10-bit mantissa,
which is in the class of shortened-mantissa GEMMs that fail the +/-2 LSB
conformance contract (lewton_tpu/ops/imdct.py PRECISION notes).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
