"""XXHash32 unit tests: pure-Python vs native vs known values.

Known-answer values match the reference's inline micro-test
(reference: test_suite/lz4test.adb:129-147) and the xxhash spec
test vectors.
"""

import os

import pytest

from lz4tpu.xxh32 import XXHash32, xxh32


def test_reference_inline_vector_byte_at_a_time():
    tc = bytes(
        [0x1A] * 14 + [0x11, 0x10]
    )
    ctx = XXHash32()
    for b in tc:
        ctx.update(bytes([b]))
    assert ctx.final() == 0xF994EF8A


def test_known_values():
    assert xxh32(b"") == 0x02CC5D05
    assert XXHash32(seed=0).update(b"").final() == 0x02CC5D05
    # Classic xxhash sanity strings
    assert XXHash32().update(b"Hello, world.").final() == xxh32(b"Hello, world.")


def test_refinalizable_and_resettable():
    h = XXHash32()
    h.update(b"abc")
    mid = h.final()
    h.update(b"def")
    assert h.final() == XXHash32().update(b"abcdef").final()
    h.reset()
    h.update(b"abc")
    assert h.final() == mid


@pytest.mark.parametrize("n", [0, 1, 3, 4, 15, 16, 17, 64, 1023, 4096, 70000])
def test_native_matches_python(n):
    native = pytest.importorskip("lz4tpu.native")
    if not native.available():
        pytest.skip("native engine unavailable")
    data = os.urandom(n)
    assert native.native_xxh32(data) == XXHash32().update(data).final()
    # streaming split points
    h = native.NativeXXH32()
    h.update(data[: n // 3]).update(data[n // 3:])
    assert h.final() == XXHash32().update(data).final()


def test_batched_block_device_digests():
    """One launch hashes every block: the per-range kernel must match
    the scalar reference on a real block layout, including sub-stripe
    ranges and ranges ending at unaligned offsets."""
    import numpy as np

    from lz4tpu import FOR_ALL, corpus
    from lz4tpu.device.xxh32 import xxh32_ranges
    from lz4tpu.frame import parse_frames

    data = corpus.cases()["text_linked_64k_blockcsum"][0]
    buf = np.frombuffer(data, np.uint8)
    parsed = parse_frames(buf, FOR_ALL)
    offs = [b.comp_off for f in parsed.frames for b in f.blocks]
    lens = [b.comp_len for f in parsed.frames for b in f.blocks]
    offs += [0, 7, len(data) - 3]
    lens += [3, 15, 3]
    got = xxh32_ranges(buf, offs, lens)
    exp = [xxh32(data[o:o + n]) for o, n in zip(offs, lens)]
    assert got == exp


def test_verify_device_block_checksums():
    """verify="device" routes block checksums through the kernel over
    the staged compressed buffer — and still catches faults."""
    import jax.numpy as jnp
    import numpy as np

    import lz4tpu
    from lz4tpu import FOR_ALL
    from lz4tpu.errors import ChecksumError
    from lz4tpu.frame import parse_frames
    from lz4tpu.pipeline import _verify_checksums_device, build_seq_table

    payload = b"the quick brown fox jumps over the lazy dog " * 400
    data = lz4tpu.compress(payload, block_checksum=True)
    buf = np.frombuffer(data, np.uint8)
    parsed = parse_frames(buf, FOR_ALL)
    table = build_seq_table(buf, parsed, FOR_ALL, data)
    out_dev = jnp.asarray(np.frombuffer(payload, np.uint8))
    _verify_checksums_device(parsed, out_dev, table, jnp.asarray(buf))
    bad = bytearray(data)
    bad[25] ^= 0x40     # corrupt block payload -> block checksum fails
    bbuf = np.frombuffer(bytes(bad), np.uint8)
    with pytest.raises(ChecksumError):
        _verify_checksums_device(parse_frames(buf, FOR_ALL), out_dev, table,
                                 jnp.asarray(bbuf))


_LENGTHS = [0, 1, 15, 16, 17, 31, 32, 127, 128, 129, 143, 1000, 4096, 65537]


@pytest.mark.parametrize("n", _LENGTHS)
def test_kernel_and_plain_lane_states_match_native(n):
    """The Triton kernel (interpret mode here) and its plain-JAX
    reference agree lane for lane, and both fold to native xxh32, at
    lengths around the stripe (16) and unroll (8 stripes) boundaries
    and at unaligned starts."""
    import numpy as np

    from lz4tpu import native
    from lz4tpu.device import xxh32 as dx

    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, n + 40, dtype=np.uint8)
    offs, lens = [0, 3, 40], [n, n, n]
    d, st, ns = dx.prepare_ranges(data, offs, lens)
    k_lanes, k_tails = dx.lane_states(d, st, ns, interpret=True)
    x_lanes, x_tails = dx.lane_states_xla(d, st, ns)
    assert np.array_equal(np.asarray(k_lanes), np.asarray(x_lanes))
    assert np.array_equal(np.asarray(k_tails), np.asarray(x_tails))
    assert dx.xxh32_ranges(data, offs, lens) == [
        native.native_xxh32(data[o:o + n]) for o in offs]


def test_prepare_ranges_buckets_shapes():
    """Data pads to a power of two and the range count to a power of
    two with empty ranges, so one compiled kernel serves many sizes."""
    import numpy as np

    from lz4tpu.device import xxh32 as dx

    d, st, ns = dx.prepare_ranges(np.ones(5000, np.uint8), [0, 1, 2],
                                  [100, 17, 4999])
    assert d.shape == (8192,) and st.shape == ns.shape == (4,)
    assert list(ns) == [6, 1, 312, 0] and list(st) == [0, 1, 2, 0]


@pytest.mark.gpu
def test_triton_kernel_on_gpu(gpu):
    """On the card the kernel is compiled through Triton (a Triton
    custom call in the HLO, not the interpreter) and matches native
    xxh32 at every tested length."""
    import numpy as np

    from lz4tpu import native
    from lz4tpu.device import xxh32 as dx

    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, 1 << 20, dtype=np.uint8)
    offs = [0, 5, 1000, 77]
    lens = [1 << 20, 65536 + 3, 15, 300_001]
    d, st, ns = dx.prepare_ranges(data, offs, lens)
    hlo = dx.lane_states.lower(d, st, ns, interpret=False).as_text()
    assert "triton" in hlo
    assert dx.xxh32_ranges(data, offs, lens) == [
        native.native_xxh32(data[o:o + n]) for o, n in zip(offs, lens)]


def test_verify_device_multiframe_fault_order():
    """Frames verify in order, each frame's block checksums before its
    content checksum (advisor r2 medium): content-checksum fault in
    frame 1 + block-checksum fault in frame 2 must raise frame 1's
    error from BOTH verify modes, matching the streaming reference's
    per-frame interleaving (lz4ada.adb:672-676, 491-513)."""
    import numpy as np
    import pytest

    import lz4tpu
    from lz4tpu.errors import ChecksumError
    from lz4tpu.pipeline import decompress_to_device

    f1 = bytearray(lz4tpu.compress(b"alpha " * 300, content_checksum=True,
                                   block_checksum=False))
    f2 = bytearray(lz4tpu.compress(b"beta " * 300, content_checksum=False,
                                   block_checksum=True))
    f1[-2] ^= 0x01          # frame 1 content checksum byte
    f2[25] ^= 0x40          # frame 2 block payload -> block checksum
    data = bytes(f1 + f2)
    msgs = {}
    for mode in ("host", "device"):
        with pytest.raises(ChecksumError) as ei:
            decompress_to_device(data, verify=mode)
        msgs[mode] = str(ei.value)
    assert msgs["host"] == msgs["device"]
    assert "Content" in msgs["host"] or "content" in msgs["host"]
