"""The byte-parallel resolver as the dense-chain engine: its round
bound, one launch per request, shape buckets and padding."""

import numpy as np
import pytest

import lz4tpu
from lz4tpu import FOR_ALL, corpus, pipeline
from lz4tpu.device import decode as dev
from lz4tpu.frame import parse_frames
from lz4tpu.pipeline import (
    DecodeStats, _chains_of, _dense_runs, build_seq_table,
    decompress_to_device, resolve_chains, stage_comp,
)


def _table(frame):
    buf = np.frombuffer(frame, np.uint8)
    return buf, build_seq_table(buf, parse_frames(buf, FOR_ALL), FOR_ALL,
                                frame)


@pytest.mark.parametrize("seqs,rounds", [(1, 1), (2, 2), (3, 3), (4, 3),
                                         (5, 4), (1024, 11), (1025, 12)])
def test_doubling_rounds_is_ceil_log2_plus_one(seqs, rounds):
    assert dev.doubling_rounds(seqs) == rounds


def test_rounds_come_from_the_largest_chain():
    """Independent chains never point into each other: the rounds
    follow the largest chain's sequence count, not the request's."""
    rng = np.random.default_rng(1)
    frame = (lz4tpu.compress(corpus.log_text(rng, 150_000),
                             block_max_code=4, block_independence=True)
             + lz4tpu.compress(corpus.log_text(rng, 20_000)))
    _buf, table = _table(frame)
    chains = _chains_of(table)
    biggest = max(c.seq_hi - c.seq_lo for c in chains)
    total = sum(c.seq_hi - c.seq_lo for c in chains)
    assert dev.doubling_rounds(biggest) < dev.doubling_rounds(total)
    st = DecodeStats()
    out = decompress_to_device(frame, stats=st)
    assert np.asarray(out).tobytes() == lz4tpu.decompress_host(frame)
    (_n_out, _s, _c, rounds), = st.resolve_launches
    assert rounds == dev.doubling_rounds(biggest)


def test_one_launch_for_many_chains():
    """A frame of 64 KiB independent text blocks resolves every block in
    ONE launch, laid out back to back; no sparse program runs."""
    frame, payload = corpus.cases()["text_independent_64k"]
    _buf, table = _table(frame)
    assert len(_chains_of(table)) == 5
    st = DecodeStats()
    out = decompress_to_device(frame, stats=st)
    assert np.asarray(out).tobytes() == payload
    assert len(st.resolve_launches) == 1
    assert st.engine_chains == {"resolve": 5}
    assert st.engine_bytes == {"resolve": len(payload)}


def test_launch_shapes_are_power_of_two_buckets():
    """Output, sequence and input extents are padded to powers of two
    (sequences to at least 128), so requests of similar size share a
    compiled program."""
    rng = np.random.default_rng(2)
    launches = []
    for n in (66_000, 68_000):
        st = DecodeStats()
        frame = lz4tpu.compress(corpus.log_text(rng, n))
        decompress_to_device(frame, stats=st)
        (n_out, s_pad, comp, rounds), = st.resolve_launches
        assert n_out == 131072 and comp == dev.bucket(len(frame))
        assert s_pad >= 128 and s_pad & (s_pad - 1) == 0
        launches.append((n_out, s_pad, comp, rounds))
    assert launches[0] == launches[1]


def test_padded_sequences_and_tail_produce_nothing():
    """Padding never leaks into the output: a request whose size is
    not a bucket returns exactly its bytes, padded sequences claim no
    byte, and the padded output tail is cut off."""
    frame = lz4tpu.compress(b"0123456789" * 1000 + b"!")
    buf, table = _table(frame)
    segs = resolve_chains(table, _chains_of(table), stage_comp(buf))
    (lo, arr), = segs
    assert lo == 0 and arr.shape == (10001,)
    assert np.asarray(arr).tobytes() == b"0123456789" * 1000 + b"!"


def test_stage_comp_pads_to_a_power_of_two():
    buf = np.arange(3000, dtype=np.uint8)
    comp = stage_comp(buf)
    assert comp.shape == (4096,)
    got = np.asarray(comp)
    assert np.array_equal(got[:3000], buf) and not got[3000:].any()


class _C:
    def __init__(self, seq_lo, seq_hi, out_lo, out_hi):
        self.seq_lo, self.seq_hi = seq_lo, seq_hi
        self.out_lo, self.out_hi = out_lo, out_hi


def test_dense_runs_merge_only_adjacent_chains():
    """Chains adjacent in both the table and the output share one run
    (one slice, one output segment); a gap — a sparse chain between
    them — starts a new run."""
    chains = [_C(0, 10, 0, 100), _C(10, 25, 100, 300), _C(30, 40, 500, 600),
              _C(40, 41, 600, 700)]
    assert _dense_runs(chains) == [[0, 25, 0, 300], [30, 41, 500, 700]]


@pytest.mark.parametrize("n_out,want", [
    (1 << 30, 1 << 30),                  # the largest shared launch
    ((1 << 30) + 1, (1 << 31) - 1),      # a bucket of 2^31 is capped
    ((1 << 31) - 1, (1 << 31) - 1),      # the largest batch output
])
def test_launch_output_pad_stays_int32(n_out, want):
    """Outputs between 2^30 and 2^31 - 1 bytes pad to 2^31 - 1, not to
    2^31: the pad is written into the int32 sequence table and used as
    the out-of-range scatter index."""
    n_out_pad, s_pad = pipeline.launch_shape(n_out, 5)
    assert n_out_pad == want and s_pad == 128
    cols = np.empty(4, np.int32)
    cols[:] = n_out_pad
    assert int(cols[0]) == n_out_pad


def test_launch_groups_split_at_the_output_limit(monkeypatch):
    """Dense chains share a launch up to _LAUNCH_MAX_OUT bytes; a chain
    larger than that gets a launch of its own."""
    monkeypatch.setattr(pipeline, "_LAUNCH_MAX_OUT", 1000)
    chains = [_C(0, 5, 0, 400), _C(5, 9, 400, 800), _C(9, 12, 800, 1200),
              _C(12, 20, 1200, 3700), _C(20, 21, 3700, 3800)]
    groups = pipeline._launch_groups(chains)
    assert [[c.out_lo for c in g] for g in groups] == [
        [0, 400], [800], [1200], [3700]]


def test_capped_launches_decode_bit_exact(monkeypatch):
    """With the launch limit and the pad cap shrunk to small sizes that
    are not powers of two, a request splits into several launches whose
    output pads stop at the cap, and the bytes still match."""
    monkeypatch.setattr(pipeline, "_LAUNCH_MAX_OUT", 100_000)
    monkeypatch.setattr(pipeline, "_LAUNCH_MAX_PAD", 70_000)
    rng = np.random.default_rng(3)
    payload = corpus.log_text(rng, 200_000)
    frame = lz4tpu.compress(payload, block_max_code=4, block_independence=True)
    st = DecodeStats()
    out = decompress_to_device(frame, stats=st)
    assert np.asarray(out).tobytes() == payload
    assert st.engine_bytes == {"resolve": len(payload)}
    assert len(st.resolve_launches) == 3
    assert {n for n, _s, _c, _r in st.resolve_launches} == {65536, 70_000}


def test_mixed_request_segments_land_in_place():
    """Dense chains split by sparse ones resolve in one launch and come
    back as one segment per run, each at its output offset."""
    frame, payload = corpus.cases()["mixed_engines"]
    st = DecodeStats()
    out = decompress_to_device(frame, stats=st)
    assert np.asarray(out).tobytes() == payload
    assert len(st.resolve_launches) == 1
    assert set(st.engine_bytes) == {"resolve", "sparse"}
    assert sum(st.engine_bytes.values()) == len(payload)


@pytest.mark.gpu
def test_resolver_on_gpu_matches_host(gpu):
    """On the card: a multi-MiB text frame through the resolver, bit
    for bit against the host engine."""
    payload = corpus.log_text(np.random.default_rng(5), 6 << 20)
    frame = lz4tpu.compress(payload, block_independence=True)
    st = DecodeStats()
    out = decompress_to_device(frame, verify="device", stats=st)
    assert np.asarray(out).tobytes() == payload
    assert st.engine_bytes == {"resolve": len(payload)}
