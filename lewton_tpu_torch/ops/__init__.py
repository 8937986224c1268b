"""Device-side (torch) numeric ops of the Vorbis synthesis half.

Each op is a function over statically shaped tensors, batched over packets
(and, one level up, over streams), on the device of its inputs. The host
entropy front-end (``lewton_tpu_torch.audio.decode_packet_entropy``, or the
C++ library) produces the dense inputs. The exports are the reference's
(lewton_tpu/ops/__init__.py).
"""

from .coupling import inverse_coupling_batch  # noqa: F401
from .floor_curve import floor0_curve_batch, floor1_curve_batch  # noqa: F401
from .imdct import imdct_batch  # noqa: F401
from .windowing import overlap_add_batch  # noqa: F401
