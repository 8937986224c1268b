from .demux import Packet, PacketReader, OggError, crc32_ogg  # noqa: F401
