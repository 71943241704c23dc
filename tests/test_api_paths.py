"""Coverage for api.py paths the vector suite misses: the batch host
decoder's output-buffer growth, the streaming fallback's mid-frame EOF
diagnostic, and the explicit backend="device" entry."""

import numpy as np
import pytest

import lz4tpu
from lz4tpu.errors import DataCorruption


def test_batch_host_grows_output_buffer():
    # No content size in the header -> the batch decoder starts from a
    # reservation-derived cap and must grow while decoding (both the
    # compressed-block and uncompressed-block growth paths).
    rng = np.random.default_rng(5)
    payload = (bytes(2_000_000)                       # compressible
               + rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes())
    frame = lz4tpu.compress(payload, block_max_code=4)
    assert frame[4] & 0x08 == 0                       # no content size
    assert lz4tpu.decompress_host(frame) == payload


def test_truncated_frame_mid_stream_diagnostic():
    from lz4tpu import corpus

    data = corpus.cases()["text_cli_default"][0]
    with pytest.raises(DataCorruption):
        lz4tpu.decompress(data[:len(data) // 2])


def test_backend_device_explicit():
    from lz4tpu import corpus

    data, ref = corpus.cases()["concatenated_frames"]
    assert lz4tpu.decompress(data, backend="device") == ref


class TestStreamingCompressor:
    """lz4tpu.Compressor: incremental frames bit-identical to the
    one-shot compress() for the same options."""

    def _stream(self, payload, chunk, **kw):
        c = lz4tpu.Compressor(**kw)
        out = bytearray()
        for i in range(0, len(payload), chunk):
            out += c.update(payload[i:i + chunk])
        out += c.finish()
        return bytes(out)

    def test_matches_one_shot_across_chunkings(self):
        rng = np.random.default_rng(9)
        payload = (b"streaming compressor parity " * 9000
                   + rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes())
        ref = lz4tpu.compress(payload, block_max_code=4)
        for chunk in (7, 1000, 65536, 1 << 20):
            assert self._stream(payload, chunk, block_max_code=4) == ref

    def test_block_checksum_and_independence(self):
        payload = b"abcdef" * 40_000
        for kw in (dict(block_checksum=True),
                   dict(block_independence=True),
                   dict(content_checksum=False)):
            ref = lz4tpu.compress(payload, block_max_code=4, **kw)
            got = self._stream(payload, 12_345, block_max_code=4, **kw)
            assert got == ref
            assert lz4tpu.decompress(got) == payload

    def test_empty_input(self):
        got = self._stream(b"", 1)
        assert got == lz4tpu.compress(b"")
        assert lz4tpu.decompress(got) == b""

    def test_finish_is_terminal(self):
        c = lz4tpu.Compressor()
        c.update(b"x")
        c.finish()
        with pytest.raises(ValueError):
            c.update(b"y")
        with pytest.raises(ValueError):
            c.finish()


def test_fault_precedence_zero_length_block_checksum():
    """One corruption, two faults: flipping the stored block's size
    word to 0x80000000 creates a zero-length uncompressed block whose
    checksum fails IN STREAM ORDER before the (now misaligned) later
    structure does.  The reference reports the checksum fault
    (lz4ada.adb:661-714 verifies each block's trailer as it reaches
    it); the device pipeline must re-derive the same diagnostic
    instead of surfacing its parse-time structural error."""
    rng = np.random.default_rng(11)
    payload = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
    frame = lz4tpu.compress(payload, block_max_code=6,
                            block_checksum=True)
    assert frame[7:11] == b"\x40\x00\x00\x80"      # stored, 64 bytes
    bad = bytearray(frame)
    bad[7] = 0                                     # len 64 -> len 0
    bad = bytes(bad)
    outcomes = []
    for run in (lambda: lz4tpu.decompress_host(bad),
                lambda: lz4tpu.decompress(bad, backend="device"),
                lambda: lz4tpu.decompress_to_device(bad)):
        with pytest.raises(lz4tpu.ChecksumError) as e:
            run()
        outcomes.append(str(e.value))
    assert outcomes[0] == outcomes[1] == outcomes[2]


# ---- round-5 additions: decompress_into validation, flexible
# reservation, auto-backend probe failure, batch content-size
# undershoot fallback ----

def test_decompress_into_rejects_bad_dst():
    frame = lz4tpu.compress(b"abc" * 100)
    with pytest.raises(ValueError, match="1-D uint8"):
        lz4tpu.decompress_into(frame, np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError, match="writable"):
        lz4tpu.decompress_into(frame, bytes(1000))


def test_decompress_into_flexible_reservation():
    from lz4tpu.constants import Reservation

    frame = lz4tpu.compress(b"abc" * 100)
    dst = bytearray(4096)
    n = lz4tpu.decompress_into(frame, dst, Reservation.USE_FIRST)
    assert bytes(dst[:n]) == b"abc" * 100


def test_decompress_into_truncated_mid_frame():
    frame = lz4tpu.compress(b"abc" * 100)
    with pytest.raises(DataCorruption, match="middle of a frame"):
        lz4tpu.decompress_into(frame[:-6], bytearray(4096))


def test_decompress_auto_platform_probe_failure(monkeypatch):
    # A JAX backend that fails to start is an error, not a silent
    # host run: auto must not hide a broken device path.
    import jax

    def _raise():
        raise RuntimeError("backend down")

    frame = lz4tpu.compress(b"auto " * 100)
    monkeypatch.setattr(jax, "devices", _raise)
    with pytest.raises(RuntimeError, match="backend down"):
        lz4tpu.decompress(frame, backend="auto")


class _FakeDevice:
    def __init__(self, platform):
        self.platform = platform


@pytest.mark.parametrize("name,expect", [("gpu", "gpu"), ("cpu", "cpu"),
                                         ("rocm", None), ("metal", None)])
def test_platform_decision(monkeypatch, name, expect):
    """One function decides the platform: GPU or CPU, anything else
    raises; interpret mode follows the CPU."""
    import jax

    from lz4tpu import device

    monkeypatch.setattr(jax, "devices", lambda: [_FakeDevice(name)])
    if expect is None:
        with pytest.raises(RuntimeError, match="NVIDIA GPU"):
            device.platform()
    else:
        assert device.platform() == expect
        assert device.interpret() == (expect == "cpu")


def test_decompress_auto_routes_by_platform_and_size(monkeypatch):
    """auto: the device pipeline on a GPU for >= 64 KiB, the host
    engine otherwise (counted under "host" in the stats)."""
    import lz4tpu.device as device
    import lz4tpu.pipeline as pl
    from lz4tpu.pipeline import DecodeStats

    calls = []
    monkeypatch.setattr(pl, "decompress_device",
                        lambda d, r, stats: calls.append(len(d)) or b"dev")
    big_payload = np.random.default_rng(9).integers(
        0, 256, 100_000, dtype=np.uint8).tobytes()
    big = lz4tpu.compress(big_payload, content_checksum=False)
    assert len(big) >= 1 << 16
    small = lz4tpu.compress(b"small " * 10)
    monkeypatch.setattr(device, "platform", lambda: "gpu")
    assert lz4tpu.decompress(big, backend="auto") == b"dev"
    st = DecodeStats()
    assert lz4tpu.decompress(small, backend="auto", stats=st) == b"small " * 10
    assert st.engine_bytes == {"host": 60}
    monkeypatch.setattr(device, "platform", lambda: "cpu")
    assert lz4tpu.decompress(big, backend="auto") == big_payload
    assert calls == [len(big)]
    with pytest.raises(ValueError, match="unknown backend"):
        lz4tpu.decompress(small, backend="gpu")


def test_decompress_host_empty_input():
    assert lz4tpu.decompress_host(b"") == b""


def test_batch_content_size_undershoot_streaming_parity():
    # Declared content size below the real output: the batch decoder's
    # linear buffer (sized from the declaration) overflows with a
    # status raise, and decompress_host falls back to the streaming
    # engine's byte-exact content-size diagnostic.
    from lz4tpu.xxh32 import xxh32

    frame = lz4tpu.compress(b"undershoot " * 400, content_size=True,
                            content_checksum=False)
    declared = int.from_bytes(frame[6:14], "little") - 40
    body = frame[4:6] + declared.to_bytes(8, "little")
    hc = (xxh32(body) >> 8) & 0xFF
    bad = (frame[:6] + declared.to_bytes(8, "little") + bytes([hc])
           + frame[15:])
    with pytest.raises(DataCorruption) as ei:
        lz4tpu.decompress_host(bad)
    # the message is the streaming engine's reference-parity string
    assert "size" in str(ei.value).lower() or "corrupt" in str(ei.value).lower()
