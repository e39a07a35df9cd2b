"""MSK144 wire-protocol constants and codecs (LDPC, CRC, 77-bit messages)."""

from . import crc, ldpc_tables, msg77  # noqa: F401
from .crc import attach_crc, check_crc, crc13_bits
from .ldpc_tables import encode as ldpc_encode
from .msg77 import CallsignHashTable, pack77, plausible_message_type, unpack77

__all__ = [
    "crc",
    "ldpc_tables",
    "msg77",
    "attach_crc",
    "check_crc",
    "crc13_bits",
    "ldpc_encode",
    "CallsignHashTable",
    "pack77",
    "unpack77",
    "plausible_message_type",
]
