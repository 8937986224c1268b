from .batch import (  # noqa: F401
    BatchDecoder,
    MixedBatchDecoder,
    decode_chunk_batch,
    decode_chunk_sharded,
    make_mesh,
)
