"""Device pipeline tests (virtual CPU backend).

The batched pipeline (host parse -> sequence table -> device resolve)
must be bit-exact with the streaming host engine on every vector and
raise the same reference-parity errors on every corruption vector.
"""

import numpy as np
import pytest

from lz4tpu import Lz4Error, Reservation, compress, decompress_host
from lz4tpu.pipeline import decompress_device
from conftest import error_vector_names, good_vector_names


@pytest.mark.parametrize("name", good_vector_names())
def test_device_matches_reference(vectors_dir, name):
    data = (vectors_dir / f"{name}.lz4").read_bytes()
    ref = (vectors_dir / f"{name}.bin").read_bytes()
    assert decompress_device(data) == ref


def test_device_z9m(vectors_dir):
    data = (vectors_dir / "z9m.lz4").read_bytes()
    out = decompress_device(data)
    assert len(out) == 9437166 and out == b"\x00" * len(out)


@pytest.mark.parametrize("name", error_vector_names())
def test_device_error_parity(vectors_dir, name):
    data = (vectors_dir / f"{name}.err").read_bytes()
    declared = (vectors_dir / f"{name}.eds").read_text().splitlines()[0]
    with pytest.raises(Lz4Error) as exc_info:
        decompress_device(data, Reservation.SINGLE_FRAME)
    assert exc_info.value.ada_image() == declared


def test_device_round_trip_own_encoder():
    payload = (b"The quick brown fox. " * 3000) + bytes(range(256)) * 40
    frame = compress(payload, block_max_code=4, block_checksum=True)
    assert decompress_device(frame) == payload


def test_device_deep_chain():
    """A pathological chain: every sequence copies from the previous
    one, depth ~ number of sequences. Exercises the doubling re-entry
    path."""
    # repeated pattern with short period so matches chain tightly
    payload = bytes([i % 7 for i in range(100_000)])
    frame = compress(payload, block_max_code=4)
    assert decompress_device(frame) == payload
    assert decompress_host(frame) == payload


def test_sparse_programs_share_compiles_across_offsets():
    """A sparse program's compile key leaves out where its copies read
    the compressed input: identical blocks at different stream offsets
    (every 64 KiB block of a zeros frame) share one compiled program."""
    from lz4tpu.device import sparse_decode as sp

    a = (sp.SparseOp("copy", 0, 1, src=7),
         sp.SparseOp("fill", 1, 65535, pattern=b"\x00"))
    b = (sp.SparseOp("copy", 0, 1, src=9000),
         sp.SparseOp("fill", 1, 65535, pattern=b"\x00"))
    assert sp._program_key(a) == sp._program_key(b)
    selfop = (sp.SparseOp("copy", 0, 300, src=0),
              sp.SparseOp("self", 300, 300, src=0))
    moved = (sp.SparseOp("copy", 0, 300, src=0),
             sp.SparseOp("self", 300, 300, src=10))
    assert sp._program_key(selfop) != sp._program_key(moved)

    zeros = bytes(6 * 65536)
    frame = compress(zeros, block_max_code=4, block_independence=True)
    sp._compile_program.cache_clear()
    assert decompress_device(frame) == zeros
    info = sp._compile_program.cache_info()
    assert info.misses == 1 and info.hits == 5


def test_resolver_deep_chain_round_bound():
    """A provenance chain as deep as the sequence count (every sequence
    copies the byte before it) resolves in doubling_rounds(S) rounds —
    and one round fewer than ceil(log2(S)) leaves bytes unresolved, so
    the bound is what makes the output right."""
    import jax.numpy as jnp

    from lz4tpu.device import decode as dr

    S = 70_000
    # unresolved pointers gather comp[0], which is not the literal
    comp = jnp.asarray(np.frombuffer(b"\x00Q\x00\x00", np.uint8))
    cols = np.zeros((5, S), np.int32)
    cols[0] = np.arange(S)          # out_start
    cols[1, 0] = 1                  # byte 0 is the only literal ...
    cols[2, 0] = 1                  # ... read from comp[1]
    cols[3] = 1                     # match_off
    cols[4, 1:] = 1                 # match_len
    n_out = dr.bucket(S)
    rounds = dr.doubling_rounds(S)
    assert rounds == 18
    out = dr.resolve(comp, jnp.asarray(cols), np.int32(S), n_out=n_out,
                     rounds=rounds)
    assert bytes(np.asarray(out)[:S]) == b"Q" * S
    short = dr.resolve(comp, jnp.asarray(cols), np.int32(S), n_out=n_out,
                       rounds=rounds - 3)
    assert bytes(np.asarray(short)[:S]) != b"Q" * S


def test_sparse_uniform_fills_execute():
    """Uniform fills (jnp.full inside the program) and pattern tiling
    execute end-to-end: a zeros-dominated frame, a two-byte-period
    frame, and two uniform fills back to back."""
    zeros = bytes(2_000_000) + b"tail!" * 10
    frame = compress(zeros, block_max_code=7)
    assert decompress_device(frame) == zeros

    ab = b"ab" * 700_000
    frame2 = compress(ab, block_max_code=7)
    assert decompress_device(frame2) == ab

    two = bytes(600_000) + b"\xff" * 600_000 + b"END!"
    frame3 = compress(two, block_max_code=7)
    assert decompress_device(frame3) == two


def test_decompress_to_device(vectors_dir):
    """Device-resident decode: output stays a jax.Array in HBM and is
    bit-exact; checksum verification still reference-parity."""
    import jax
    import jax.numpy as jnp

    import lz4tpu

    for name in ("t100k", "skipz100", "z101legacyplus"):
        data = (vectors_dir / f"{name}.lz4").read_bytes()
        ref = (vectors_dir / f"{name}.bin").read_bytes()
        out = lz4tpu.decompress_to_device(data)
        assert isinstance(out, jax.Array) and out.dtype == jnp.uint8
        assert bytes(jax.device_get(out).tobytes()) == ref
    # verify="host" catches a corrupted content checksum
    bad = bytearray((vectors_dir / "t100k.lz4").read_bytes())
    bad[-1] ^= 0xFF
    with pytest.raises(Lz4Error):
        lz4tpu.decompress_to_device(bytes(bad))
    # verify="none" skips checksum verification but still validates
    # the sequence grammar
    out = lz4tpu.decompress_to_device(bytes(bad), verify="none")
    assert out.shape[0] == 102400


def test_xxh32_ranges_of_device_array():
    """Content-checksum hashing of a device-resident array matches the
    reference digest for ranges at unaligned starts and ends, exact
    stripes, sub-stripe and empty ranges — all in one launch."""
    import jax.numpy as jnp

    from lz4tpu.device.xxh32 import xxh32_ranges
    from lz4tpu.xxh32 import xxh32

    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 200_000, dtype=np.uint8)
    ranges = ((0, 200_000), (7, 199_003), (100, 100 + (1 << 15)),
              (5, 5 + (1 << 15) + 13), (0, 16), (3, 3))
    got = xxh32_ranges(jnp.asarray(data), [lo for lo, _ in ranges],
                       [hi - lo for lo, hi in ranges])
    assert got == [xxh32(data[lo:hi].tobytes()) for lo, hi in ranges]


def test_decompress_to_device_verify_device(vectors_dir):
    """verify="device": content checksums computed by the xxh32 kernel
    over the device-resident output; decoded bytes never fetched.  Same acceptance and same reference-parity rejection as
    the host verifier."""
    import jax

    import lz4tpu

    for name in ("t100k", "concat390", "z2841", "z1", "emptycraft"):
        data = (vectors_dir / f"{name}.lz4").read_bytes()
        ref = (vectors_dir / f"{name}.bin").read_bytes()
        out = lz4tpu.decompress_to_device(data, verify="device")
        assert bytes(jax.device_get(out).tobytes()) == ref
    # corrupted content checksum raises the same parity error
    bad = bytearray((vectors_dir / "t100k.lz4").read_bytes())
    bad[-1] ^= 0xFF
    with pytest.raises(Lz4Error) as ei_dev:
        lz4tpu.decompress_to_device(bytes(bad), verify="device")
    with pytest.raises(Lz4Error) as ei_host:
        lz4tpu.decompress_to_device(bytes(bad), verify="host")
    assert ei_dev.value.ada_image() == ei_host.value.ada_image()


def test_sparse_classifier_rejections():
    """The sparse builder must return None (caller falls back) for
    chains that are not sparse-shaped: deep pattern chains, segment
    blowup, and overlapping matches needing too many chunks."""
    import numpy as np

    from lz4tpu.device import sparse_decode as sp

    buf = np.arange(256, dtype=np.uint8)

    def prog(ll, ml, mo, ls):
        return sp.build_sparse_program(
            np.asarray(ll, np.int32), np.asarray(ml, np.int32),
            np.asarray(mo, np.int32), np.asarray(ls, np.int32), buf,
        )

    # pattern chain deeper than the resolver cap: each seq's small-
    # offset match reaches into the previous fill's pattern
    n = 40
    ll = [1] + [0] * (n - 1)
    ml = [0] + [8] * (n - 1)
    mo = [1] + [5] * (n - 1)
    ls = [0] * n
    assert prog(ll, ml, mo, ls) is None

    # segment blowup: more ops than MAX_OPS
    n = sp.MAX_OPS + 2
    assert prog([1] * n, [0] * n, [1] * n, [0] * n) is None

    # overlapping large-offset match expanding into too many chunks
    ll = [300, 0]
    ml = [0, 300 * (sp.MAX_SELF_CHUNKS + 2)]
    mo = [1, 300]
    ls = [0, 0]
    assert prog(ll, ml, mo, ls) is None

    # and a healthy RLE-ish chain still classifies
    assert prog([4, 0], [0, 5000], [1, 4], [0, 0]) is not None


def test_forced_resolver_engine(vectors_dir):
    """Every chain through the byte-parallel resolver (sparse chains
    included) decodes bit-exact — the contract the sharded span
    path relies on."""
    from lz4tpu.constants import FOR_ALL
    from lz4tpu.frame import parse_frames
    from lz4tpu.pipeline import (
        _chains_of, assemble_device_segments, build_seq_table,
        resolve_chains, stage_comp,
    )

    for name in ("t100k", "z101legacyplus"):
        data = (vectors_dir / f"{name}.lz4").read_bytes()
        ref = (vectors_dir / f"{name}.bin").read_bytes()
        buf = np.frombuffer(data, np.uint8)
        table = build_seq_table(buf, parse_frames(buf, FOR_ALL), FOR_ALL,
                                data)
        chains = [c for c in _chains_of(table) if c.out_hi > c.out_lo]
        segs = resolve_chains(table, chains, stage_comp(buf))
        out = assemble_device_segments(segs, table.n_out)
        assert np.asarray(out).tobytes() == ref


def test_plan_overflow_isolation_multi_chain(vectors_dir):
    """Chains classify one by one: a text chain next to a zeros chain
    goes to the resolver while the zeros chain runs as a sparse
    program, and the public pipeline stays bit-exact."""
    from lz4tpu.constants import FOR_ALL
    from lz4tpu.frame import parse_frames
    from lz4tpu.pipeline import DecodeStats, build_seq_table, plan_decode

    good = (vectors_dir / "t100k.lz4").read_bytes()
    zeros = bytes(300_000)
    data = good + compress(zeros)
    ref = (vectors_dir / "t100k.bin").read_bytes() + zeros

    buf = np.frombuffer(data, np.uint8)
    parsed = parse_frames(buf, FOR_ALL)
    table = build_seq_table(buf, parsed, FOR_ALL, data)
    st = DecodeStats()
    plan = plan_decode(buf, table, st)
    assert len(plan.dense) == 1 and len(plan.sparse) == 1
    assert st.engine_bytes == {"resolve": len(ref) - len(zeros),
                               "sparse": len(zeros)}
    assert decompress_device(data) == ref
