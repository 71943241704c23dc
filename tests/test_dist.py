"""Multi-device (shard_map) decode tests on the virtual 8-CPU mesh."""

import jax
import jax.numpy as jnp
import pytest

from lz4tpu import compress, decompress_host
from lz4tpu.dist import decompress_sharded, make_mesh
from conftest import good_vector_names


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device backend")
    return make_mesh()


@pytest.mark.parametrize(
    "name", [n for n in good_vector_names() if n in
             ("t1111k", "b3444k", "z2841", "t100k", "concat390",
              "z101legacyplus", "skipz100", "empty", "a2246", "t2")]
)
def test_sharded_matches_reference(vectors_dir, mesh, name):
    data = (vectors_dir / f"{name}.lz4").read_bytes()
    ref = (vectors_dir / f"{name}.bin").read_bytes()
    assert decompress_sharded(data, mesh) == ref


def test_sharded_z9m(vectors_dir, mesh):
    out = decompress_sharded((vectors_dir / "z9m.lz4").read_bytes(), mesh)
    assert len(out) == 9437166 and out == b"\x00" * len(out)


def test_sharded_cross_span_chains(mesh):
    """Data whose matches chain across the 8 span boundaries."""
    payload = (b"abcdefghij" * 26 + b"X") * 500  # period crosses spans
    frame = compress(payload, block_max_code=4)
    assert decompress_sharded(frame, mesh) == payload
    assert decompress_host(frame) == payload


def test_chain_sharded_dense(mesh):
    """Multiple independent chains decode chain-parallel, each device
    running the single-device engines on its share, ordered
    reassembly."""
    import numpy as np

    from lz4tpu import FOR_ALL
    from lz4tpu.dist import decode_sharded_chains
    from lz4tpu.frame import parse_frames
    from lz4tpu.pipeline import build_seq_table

    rng = np.random.default_rng(5)
    frames = b"".join(
        compress(
            (b"chain %d payload " % k) * 300
            + rng.integers(0, 256, 2000, dtype=np.uint8).tobytes()
        )
        for k in range(5)
    )
    ref = decompress_host(frames)
    assert decompress_sharded(frames, mesh) == ref  # auto -> chains
    buf = np.frombuffer(frames, np.uint8)
    parsed = parse_frames(buf, FOR_ALL)
    table = build_seq_table(buf, parsed, FOR_ALL, frames)
    out = decode_sharded_chains(table, buf, mesh)
    assert out.tobytes() == ref


def test_chain_sharded_mixed_engines(mesh):
    """A sharded corpus mixing RLE (sparse program) and text (resolver)
    chains: each device group classifies like the single-device
    pipeline, so zeros never crawl through pointer doubling."""
    import numpy as np

    from lz4tpu import FOR_ALL
    from lz4tpu.dist import decode_sharded_chains
    from lz4tpu.frame import parse_frames
    from lz4tpu.pipeline import build_seq_table

    rng = np.random.default_rng(6)
    frames = (
        compress(b"\x00" * 100_000)
        + compress(b"text payload with repetition " * 1500
                   + rng.integers(0, 256, 5000, dtype=np.uint8).tobytes())
        + compress(bytes([7]) * 60_000)
    )
    ref = decompress_host(frames)
    buf = np.frombuffer(frames, np.uint8)
    parsed = parse_frames(buf, FOR_ALL)
    table = build_seq_table(buf, parsed, FOR_ALL, frames)
    out = decode_sharded_chains(table, buf, mesh)
    assert out.tobytes() == ref
    assert decompress_sharded(frames, mesh) == ref


@pytest.mark.parametrize("name", __import__("conftest").error_vector_names())
def test_sharded_error_parity(vectors_dir, mesh, name):
    """Corruption vectors raise the same exception class and exact
    message through the sharded path as through the streaming engine
    (which the error suite pins byte-identical to the reference)."""
    from lz4tpu.constants import Reservation
    from lz4tpu.errors import Lz4Error

    data = (vectors_dir / f"{name}.err").read_bytes()
    expected = (vectors_dir / f"{name}.eds").read_text().splitlines()[0]
    with pytest.raises(Lz4Error) as exc:
        decompress_sharded(data, mesh, Reservation.SINGLE_FRAME)
    assert exc.value.ada_image() == expected


def test_sharded_partial_meshes(vectors_dir):
    data = (vectors_dir / "t100k.lz4").read_bytes()
    ref = (vectors_dir / "t100k.bin").read_bytes()
    for n in (1, 2, 4):
        if len(jax.devices()) >= n:
            assert decompress_sharded(data, make_mesh(n)) == ref


def test_chain_sharded_to_device(mesh):
    """decode_sharded_chains_to_device: outputs stay on the devices
    that decoded them (no host gather), segments reassemble to the
    exact stream, and chains actually land on multiple devices."""
    import numpy as np

    from lz4tpu import frame as fr
    from lz4tpu import pipeline as pl
    from lz4tpu.dist import decode_sharded_chains_to_device

    rng = np.random.default_rng(11)
    parts = [
        bytes(rng.integers(0, 256, 20_000, dtype=np.uint8))
        if k % 2 else (b"chunk %d " % k) * 4000
        for k in range(6)
    ]
    blob = b"".join(compress(p, content_checksum=False) for p in parts)
    want = b"".join(parts)
    buf = np.frombuffer(blob, np.uint8)
    parsed = fr.parse_frames(buf)
    table = pl.build_seq_table(buf, parsed, pl.Reservation.SZ_8_MIB, buf)

    segs = decode_sharded_chains_to_device(table, buf, mesh)
    out = bytearray(table.n_out)
    devices_used = set()
    for lo, arr in segs:
        devices_used |= {d.id for d in arr.devices()}
        got = np.asarray(jax.device_get(arr))
        out[lo:lo + got.size] = got.tobytes()
    assert bytes(out) == want
    assert len(devices_used) > 1, devices_used


def test_deep_chain_convergence_net():
    """Adversarial chain deeper than 2**16 hops inside one span: local
    pointer doubling capped at 16 rounds leaves in-span pointers behind
    and ships wrong bytes, so the rounds must come from the chain's
    sequence count — ceil(log2(S_max)) + 1, which decode_sharded uses,
    is exact with no convergence flag to poll."""
    import numpy as np

    from lz4tpu import dist
    from lz4tpu.device import decode as dev
    from lz4tpu.pipeline import BlockSpan, SeqTable

    # seq 0 emits "ABCDE"; every later seq copies the previous 5 bytes
    # (mo=5): resolving byte i takes ~i/5 hops -> depth ~ span/5.
    N = 600_000
    lit = b"ABCDE"
    n_out = 5 * (N + 1)
    out_start = (np.arange(N + 1, dtype=np.int64) * 5).astype(np.int32)
    lit_len = np.zeros(N + 1, np.int32)
    lit_len[0] = 5
    lit_src = np.zeros(N + 1, np.int32)
    match_len = np.full(N + 1, 5, np.int32)
    match_len[0] = 0
    match_off = np.full(N + 1, 5, np.int32)
    table = SeqTable(
        out_start=out_start, lit_len=lit_len, lit_src=lit_src,
        match_len=match_len, match_off=match_off, n_out=n_out,
        frame_out_start=np.array([0, n_out], np.int64),
        spans=[BlockSpan(0, 0, N + 1, 0, n_out, False)],
    )
    buf = np.frombuffer(lit, np.uint8)
    mesh = dist.make_mesh()
    expected = (lit * (N + 1))

    # (a) 16 capped rounds: the bytes are WRONG
    n_dev = mesh.devices.size
    span = max(1024, -(-n_out // n_dev))
    span = (span + 127) & ~127
    w_tail = min(dist.HISTORY_SIZE, span)
    s_pad = dev.bucket(out_start.size, minimum=128)
    args = (
        jnp.asarray(dev.pad_to(buf, dev.bucket(buf.size), 0)),
        jnp.asarray(dev.pad_to(out_start, s_pad, span * n_dev)),
        jnp.asarray(dev.pad_to(lit_len, s_pad, 0)),
        jnp.asarray(dev.pad_to(lit_src, s_pad, 0)),
        jnp.asarray(dev.pad_to(match_off, s_pad, 1)),
        jnp.asarray(dev.pad_to(
            (lit_len + match_len) > 0, s_pad, False)),
        jnp.int32(n_out),
    )
    assert span // 5 > (1 << 16), "test must exceed the cap"
    out_capped = dist._sharded_resolve(
        *args, span=span, w_tail=w_tail, local_iters=16,
        tail_iters=dist._ceil_log2(max(2, n_dev)) + 1, mesh=mesh,
    )
    assert bytes(np.asarray(out_capped)[:n_out]) != expected, (
        "capped rounds must not be enough for this chain"
    )

    # (b) the public path sizes rounds from the chain and is exact
    assert dev.doubling_rounds(N + 1) == 21
    out = dist.decode_sharded(table, buf, mesh)
    assert bytes(out[:n_out]) == expected
