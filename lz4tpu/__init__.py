"""lz4tpu — an LZ4 codec framework with a GPU decode path.

A from-scratch rebuild of the capabilities of the reference Ada library
``m7a/bo-lz4-ada`` (streaming LZ4 frame/legacy/skippable/raw-block
decompression with xxhash32 verification), re-designed around a
data-parallel device pipeline:

- host layer: frame parsing, streaming FSM, native (C++) token scan /
  ring decode / hash-chain encoder (``lz4tpu.native``, ``lz4tpu.stream``)
- device layer: batched, byte-parallel block decode as XLA programs and
  xxhash32 as a Pallas-Triton kernel over device-resident byte buffers
  (``lz4tpu.device``), on an NVIDIA GPU
- scale-out: data-parallel decode over a ``jax.sharding.Mesh`` with
  ordered gather (``lz4tpu.dist``)
- plus a capability the reference lacks: an LZ4 encoder.

Public surface mirrors the reference API semantics (reference:
lib/lz4ada.ads): ``Decompressor`` (init / from_header / for_block /
update / end_of_frame), ``XXHash32``, the five exceptions, and the
reservation policy enum.
"""

from .constants import (
    FOR_ALL,
    FOR_LEGACY,
    FOR_MODERN,
    HISTORY_SIZE,
    EndOfFrame,
    Reservation,
)
from .errors import (
    ChecksumError,
    DataCorruption,
    Lz4Error,
    NotSupported,
    TooFewHeaderBytes,
    TooLittleMemory,
    hex8,     # reference To_Hex(U8)  (lz4ada.ads:306 — test helper)
    hex32,    # reference To_Hex(U32) (lz4ada.ads:307)
)
from .stream import Decompressor, Format
from .xxh32 import XXHash32, xxh32
from .api import (
    Compressor,
    compress,
    decompress,
    decompress_host,
    decompress_into,
    min_buffer_size,
)


def decompress_to_device(data, reservation=FOR_ALL, **kw):
    """Decode to a device-resident uint8 jax.Array (see pipeline)."""
    from .pipeline import decompress_to_device as _impl

    return _impl(data, reservation, **kw)


def __getattr__(name):
    """PEP 562 lazy re-export: ``lz4tpu.DecodeSession`` IS the class in
    lz4tpu.serve (so isinstance/identity work), imported only on first
    touch — serve pulls in jax, which CLI error paths never need."""
    if name == "DecodeSession":
        from .serve import DecodeSession as _cls

        globals()["DecodeSession"] = _cls
        return _cls
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__version__ = "0.1.0"

__all__ = [
    "Decompressor",
    "Format",
    "XXHash32",
    "xxh32",
    "Compressor",
    "compress",
    "decompress",
    "decompress_host",
    "decompress_to_device",
    "DecodeSession",
    "Reservation",
    "EndOfFrame",
    "FOR_ALL",
    "FOR_LEGACY",
    "FOR_MODERN",
    "HISTORY_SIZE",
    "Lz4Error",
    "ChecksumError",
    "DataCorruption",
    "NotSupported",
    "TooFewHeaderBytes",
    "TooLittleMemory",
    "__version__",
]
