"""Streams decoding past 2**31-1 bytes: the batched pipeline's
sequence table uses int32 global output coordinates, so such streams
must route to the size-unbounded streaming host engine instead of
silently truncating coordinates."""

import struct

import numpy as np
import pytest

import lz4tpu
from lz4tpu import pipeline as pl
from lz4tpu.constants import FOR_ALL


def _huge_zero_stream() -> bytes:
    """A ~9 MB stream that declares ~2.2 GiB of zeros: one compressed
    4 MiB zero block repeated 550 times inside a single modern frame
    (no content checksum so the frame stays valid without computing
    2.2 GiB worth of xxh32 here)."""
    one = lz4tpu.compress(b"\x00" * (4 << 20), content_checksum=False,
                          block_independence=True)
    buf = np.frombuffer(one, np.uint8)
    parsed = pl.parse_frames(buf)
    blk = parsed.frames[0].blocks[0]
    body = one[blk.comp_off:blk.comp_off + blk.comp_len]
    header = one[:blk.comp_off - 4]            # magic + descriptor
    size_word = struct.pack("<I", len(body))
    return (header + (size_word + body) * 550
            + struct.pack("<I", 0))


@pytest.fixture(scope="module")
def huge():
    return _huge_zero_stream()


def test_build_seq_table_raises_typed(huge):
    buf = np.frombuffer(huge, np.uint8)
    parsed = pl.parse_frames(buf)
    with pytest.raises(pl.BatchCapacityExceeded):
        pl.build_seq_table(buf, parsed, FOR_ALL, huge)


def test_decompress_device_falls_back_to_host(huge, monkeypatch):
    sentinel = b"host-engine-took-over"
    calls = []

    def fake_host(data, reservation):
        calls.append(len(data))
        return sentinel

    import lz4tpu.api as api
    monkeypatch.setattr(api, "decompress_host", fake_host)
    assert pl.decompress_device(huge) == sentinel
    assert calls


def test_decompress_to_device_raises_clear_error(huge):
    with pytest.raises(ValueError, match="2\\*\\*31"):
        lz4tpu.decompress_to_device(huge)


def test_host_engine_actually_decodes_it(huge):
    """The fallback target really handles the stream (decode a prefix
    through the streaming engine; full 2.2 GiB materialization is not
    CI-appropriate)."""
    arr = np.frombuffer(huge, np.uint8)
    ctx, consumed = lz4tpu.Decompressor.from_header(arr)
    total = 0
    while consumed < arr.size and total < (64 << 20):
        got, chunk = ctx.update(arr[consumed:consumed + 65536])
        assert chunk.count(b"\x00") == len(chunk) or not chunk
        total += len(chunk)
        consumed += got if got else 65536
    assert total >= (64 << 20)
