"""Data-parallel LZ4 decode over a JAX device mesh.

Sharding model (new capability vs the strictly single-threaded
reference — see SURVEY.md section 2 "Parallelism strategies"), two
tiers:

1. CHAIN-PARALLEL (streams of several chains): chains (frames /
   independent blocks) are balanced across devices by output bytes;
   each device runs what the single-device pipeline runs — sparse
   programs and one resolver launch for its share of dense chains.
   No collective during compute; outputs reassemble in stream order.
2. RESOLVER SPAN-SHARDING (one chain, e.g. a linked-block frame): the
   decoded output range splits into equal spans, one per device, each
   running the byte-parallel resolver (device/decode.py) on its span.
   Back-references reach at most 64 KiB backwards, so after local
   pointer doubling every escaping pointer lands in the 64 KiB tail of
   an earlier span; one ``all_gather`` of tails (64 KiB * 4 B per
   device) plus a short doubling pass resolves all cross-span chains.

Communication: tier 1 exchanges nothing during compute; tier 2 is one
``all_gather`` under ``jax.shard_map``, which XLA hands to NCCL over
NVLink.  The mesh is flat and 1-D: every GPU of a host reaches every
other at the same rate, so the algorithm alone shapes it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .constants import HISTORY_SIZE

AXIS = "dp"


def initialize_multihost(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
) -> None:
    """Join a multi-process JAX job (one process per host, or per GPU).

    Thin wrapper over ``jax.distributed.initialize`` with every
    argument explicit: nothing in a plain GPU cluster tells JAX the
    coordinator (``host:port``), the process count or this process's
    rank.  After this, ``jax.devices()`` spans every process and
    ``make_mesh()`` builds a global mesh; ``decompress_sharded`` then
    shards work across every device, and XLA carries the collectives
    over NCCL.

    Per-host input staging: ``decompress_sharded`` stages replicated
    inputs via ``jax.make_array_from_process_local_data``, launches
    per-chain work only on each host's addressable devices, and merges
    host outputs with a ``process_allgather`` (tested end-to-end by
    tests/test_multihost.py with two real JAX processes).
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def _ceil_log2(n: int) -> int:
    k = 0
    while (1 << k) < n:
        k += 1
    return k


def _local_resolve(
    comp,            # uint8 [n_comp] replicated compressed bytes
    out_start,       # int32 [S] replicated sequence table (global coords)
    lit_len,
    lit_src,
    match_off,
    produces,
    n_real,          # int32 [] total real output size
    *,
    span: int,       # static: output bytes per device
    w_tail: int,     # static: tail window (<= span)
    local_iters: int,
    tail_iters: int,
):
    """Runs inside shard_map; returns this device's span of output."""
    from .device.decode import initial_sources

    d = jax.lax.axis_index(AXIS)
    lo = d * span
    pos = lo + jnp.arange(span, dtype=jnp.int32)

    # Ownership map for this span. Sequences starting before the span
    # scatter onto local position 0; scatter-max keeps the latest one,
    # which is exactly the sequence that owns the span's first byte.
    s_ids = jnp.arange(out_start.shape[0], dtype=jnp.int32)
    local_start = jnp.where(
        produces & (out_start < lo + span),
        jnp.maximum(out_start - lo, 0),
        span,  # dropped
    )
    claims = jnp.zeros((span,), jnp.int32).at[local_start].max(s_ids, mode="drop")
    seq_id = jax.lax.cummax(claims)

    src = initial_sources(pos, seq_id, out_start, lit_len, lit_src,
                          match_off)
    src = jnp.where(pos < n_real, src, -1)

    # Local pointer doubling. Pointers pointing before the span (an
    # "escape") stay put; everything in-span resolves or becomes an
    # escape value inherited from its source.  Every hop lands in an
    # earlier sequence, so local_iters = ceil(log2(S_max)) + 1 rounds
    # leave no in-span pointer behind.
    for _ in range(local_iters):
        hop = jnp.take(src, jnp.clip(src - lo, 0, span - 1))
        src = jnp.where(src >= lo, hop, src)

    # Cross-span exchange: every escape lands in the last `w_tail`
    # bytes of an earlier span (back-references reach < 64 KiB).
    tail = jax.lax.dynamic_slice_in_dim(src, span - w_tail, w_tail)
    tails = jax.lax.all_gather(tail, AXIS)           # [D, w_tail]
    tails = tails.reshape(-1)                         # [D * w_tail]

    def tail_index(p):
        # global position -> index into the gathered tails
        j = p // span
        return j * w_tail + (p - (j + 1) * span + w_tail)

    # Resolve chains *between* tails (an escape in one tail points
    # into the previous tail, at most D-1 deep).
    for _ in range(tail_iters):
        t_idx = jnp.clip(tail_index(tails), 0, tails.shape[0] - 1)
        hop = jnp.take(tails, t_idx)
        tails = jnp.where(tails >= 0, hop, tails)

    # Substitute this span's escapes through the resolved tails.
    esc_idx = jnp.clip(tail_index(src), 0, tails.shape[0] - 1)
    sub = jnp.take(tails, esc_idx)
    src = jnp.where(src >= 0, sub, src)

    return jnp.take(comp, jnp.clip(-src - 1, 0, comp.shape[0] - 1))


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (AXIS,))


@functools.partial(
    jax.jit,
    static_argnames=("span", "w_tail", "local_iters", "tail_iters", "mesh"),
)
def _sharded_resolve(
    comp, out_start, lit_len, lit_src, match_off, produces, n_real,
    *, span, w_tail, local_iters, tail_iters, mesh,
):
    fn = functools.partial(
        _local_resolve,
        span=span,
        w_tail=w_tail,
        local_iters=local_iters,
        tail_iters=tail_iters,
    )
    return jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(), P()),
        out_specs=P(AXIS),
    )(comp, out_start, lit_len, lit_src, match_off, produces, n_real)


def decode_sharded(table, buf: np.ndarray, mesh: Mesh) -> np.ndarray:
    """Decode a parsed+scanned buffer across all devices of `mesh`
    (tier 2: resolver span-sharding).

    ``table`` is a lz4tpu.pipeline.SeqTable; returns uint8[n_out].
    """
    from .device import decode as dev
    from .pipeline import _chains_of

    n_dev = mesh.devices.size
    span = max(
        1024, -(-table.n_out // n_dev)
    )
    span = (span + 127) & ~127  # keep lane-aligned spans
    w_tail = min(HISTORY_SIZE, span)
    s_pad = dev.bucket(max(table.out_start.size, 1), minimum=128)
    comp_pad = dev.bucket(buf.size)
    n_total = span * n_dev

    # Chain depth is bounded by the largest chain's sequence count (each
    # hop lands in a strictly earlier sequence of the same chain).
    local_iters = dev.doubling_rounds(
        max(c.seq_hi - c.seq_lo for c in _chains_of(table)))
    tail_iters = _ceil_log2(max(2, n_dev)) + 1

    produces = (table.lit_len + table.match_len) > 0
    args = (
        dev.pad_to(buf, comp_pad, 0),
        dev.pad_to(table.out_start, s_pad, n_total),
        dev.pad_to(table.lit_len, s_pad, 0),
        dev.pad_to(table.lit_src, s_pad, 0),
        dev.pad_to(table.match_off, s_pad, 1),
        dev.pad_to(produces, s_pad, False),
        np.int32(table.n_out),
    )
    multihost = jax.process_count() > 1
    if multihost:
        # inputs are replicated: every host stages its (identical) copy
        rep = NamedSharding(mesh, P())
        args = tuple(
            jax.make_array_from_process_local_data(rep, np.asarray(a))
            for a in args
        )
    else:
        args = tuple(jnp.asarray(a) for a in args)
    out = _sharded_resolve(
        *args,
        span=span,
        w_tail=w_tail,
        local_iters=local_iters,
        tail_iters=tail_iters,
        mesh=mesh,
    )
    if multihost:
        from jax.experimental import multihost_utils

        out = multihost_utils.process_allgather(out, tiled=True)
    return np.asarray(out)[: table.n_out]


# ---------------------------------------------------------------------------
# Chain-parallel decode: the single-device engines on every device
# ---------------------------------------------------------------------------

def _mesh_devices(mesh: Mesh) -> list:
    """Mesh devices ordered round-robin across processes, so greedy
    chain assignment spreads load over HOSTS first (mesh.devices.flat
    is process-major: without interleaving, a few large chains all
    land on host 0's devices and host shares skew)."""
    devs = list(mesh.devices.flat)
    by_proc: dict = {}
    for d in devs:
        by_proc.setdefault(d.process_index, []).append(d)
    cols = list(by_proc.values())
    out = []
    i = 0
    while len(out) < len(devs):
        for col in cols:
            if i < len(col):
                out.append(col[i])
        i += 1
    return out


def _balance_chains(chains, n_dev: int) -> list[list[int]]:
    """Greedy largest-first assignment of chains to devices, balanced
    by *output* bytes (expansion-ratio skew means input bytes are the
    wrong load measure — SURVEY.md §7)."""
    order = sorted(
        range(len(chains)),
        key=lambda i: chains[i].out_hi - chains[i].out_lo,
        reverse=True,
    )
    load = [0] * n_dev
    groups: list[list[int]] = [[] for _ in range(n_dev)]
    for i in order:
        d = min(range(n_dev), key=load.__getitem__)
        groups[d].append(i)
        load[d] += chains[i].out_hi - chains[i].out_lo
    return groups


def sharded_span_assignment(table, mesh: Mesh) -> dict:
    """Deterministic chain->host map for the device-resident decode:
    ``{process_index: [(out_lo, out_hi), ...]}`` whose spans partition
    ``[0, n_out)`` exactly.  Pure function of (table, mesh) — every
    host computes the identical assignment with no communication, so a
    multi-host consumer knows which host holds which span without any
    metadata exchange (the same property _multihost_ordered_merge
    relies on)."""
    from .pipeline import _chains_of

    chains = _chains_of(table)
    devices = _mesh_devices(mesh)
    groups = _balance_chains(chains, len(devices))
    by_proc: dict = {}
    for dev, g in zip(devices, groups):
        for i in g:
            c = chains[i]
            if c.out_hi > c.out_lo:
                by_proc.setdefault(dev.process_index, []).append(
                    (c.out_lo, c.out_hi)
                )
    for spans in by_proc.values():
        spans.sort()
    return by_proc


def decode_sharded_chains_to_device(table, buf: np.ndarray, mesh: Mesh,
                                    stats=None) -> list:
    """Chain-parallel decode with every output left on the device that
    decoded it: returns [(out_lo, device uint8 array)] — the
    multi-device counterpart of decompress_to_device.  Per LOCAL
    device, its chains are planned exactly like the single-device
    pipeline (sparse programs + one resolver launch) and issued
    asynchronously, so executions overlap across devices.  There is no
    host gather and no cross-device collective; consumers feed
    per-device pipelines directly.

    Multi-host: each host launches only its addressable devices'
    chains and returns only THOSE spans — they cover exactly the spans
    ``sharded_span_assignment(table, mesh)`` lists for this
    ``jax.process_index()`` (a device's output-adjacent chains come
    back as one segment).  The per-host span lists partition
    ``[0, n_out)``, so a distributed consumer routes reads by the
    (communication-free, deterministic) assignment; no host ever
    fetches another host's bytes.
    """
    from .device import sparse_decode as sp
    from .pipeline import _chains_of, plan_decode, resolve_chains, stage_comp

    chains = _chains_of(table)
    devices = _mesh_devices(mesh)
    groups = _balance_chains(chains, len(devices))
    my_proc = jax.process_index()
    segs = []
    for dev, g in zip(devices, groups):
        if not g or dev.process_index != my_proc:
            continue
        plan = plan_decode(buf, table, stats,
                           chains=[chains[i] for i in g])
        if not plan.sparse and not plan.dense:
            continue
        comp_dev = stage_comp(buf, dev)
        for chain, prog in plan.sparse:
            segs.append((chain.out_lo, sp.decode_sparse_device(prog, comp_dev)))
        if plan.dense:
            segs += resolve_chains(table, plan.dense, comp_dev, device=dev)
    return segs


def decode_sharded_chains(table, buf: np.ndarray, mesh: Mesh,
                          stats=None) -> np.ndarray:
    """Chain-parallel decode gathered to host memory in stream order
    (tier 1).  Each device gets its own right-sized asynchronous
    launches rather than one padded SPMD program, so chain-size skew
    costs no padding; executions overlap across devices.  On a
    multi-host job each host drives its own devices the same way."""
    segs = decode_sharded_chains_to_device(table, buf, mesh, stats)
    multihost = jax.process_count() > 1
    out = (np.zeros if multihost else np.empty)(table.n_out, np.uint8)
    for (lo, _a), arr in zip(segs, jax.device_get([a for _lo, a in segs])):
        out[lo:lo + arr.size] = arr
    if multihost:
        out = _multihost_ordered_merge(out, table, mesh)
    return out


def _multihost_ordered_merge(out: np.ndarray, table, mesh: Mesh) -> np.ndarray:
    """Scalable ordered merge for chain-sharded multi-host decode.

    Each host ships exactly its own chains' bytes — concatenated in
    canonical (chain-index) order and padded to the largest per-host
    share — so total traffic is O(n_out), not the O(n_out * hosts) of
    a full-size-array exchange.  The chain->host assignment is
    recomputed deterministically on every host (_balance_chains is
    pure), so no index metadata travels."""
    from jax.experimental import multihost_utils

    from .pipeline import _chains_of

    chains = _chains_of(table)
    devices = _mesh_devices(mesh)
    groups = _balance_chains(chains, len(devices))
    n_proc = jax.process_count()
    proc_chains: list[list[int]] = [[] for _ in range(n_proc)]
    for dev, g in zip(devices, groups):
        proc_chains[dev.process_index].extend(g)
    for pc in proc_chains:
        pc.sort()
    shares = [
        sum(chains[i].out_hi - chains[i].out_lo for i in pc)
        for pc in proc_chains
    ]
    max_share = max(shares + [1])
    local = np.zeros(max_share, np.uint8)
    off = 0
    for i in proc_chains[jax.process_index()]:
        c = chains[i]
        local[off:off + c.out_hi - c.out_lo] = out[c.out_lo:c.out_hi]
        off += c.out_hi - c.out_lo
    gathered = np.asarray(multihost_utils.process_allgather(local))
    merged = np.zeros(table.n_out, np.uint8)
    for p, pc in enumerate(proc_chains):
        off = 0
        for i in pc:
            c = chains[i]
            n_c = c.out_hi - c.out_lo
            merged[c.out_lo:c.out_hi] = gathered[p, off:off + n_c]
            off += n_c
    return merged


def decompress_sharded(data, mesh: Mesh | None = None, reservation=None,
                       stats=None) -> bytes:
    """One-shot data-parallel decode across a device mesh.

    Strategy: a stream of several chains shards chain-wise (tier 1); a
    single chain span-shards through the resolver (tier 2: local
    doubling + 64 KiB tail exchange).

    Fault precedence matches the reference via the same
    batch->streaming re-derivation as pipeline.decompress_device.
    ``stats`` (a ``pipeline.DecodeStats``) counts the bytes each engine
    decoded, the host engine's included."""
    from .constants import FOR_ALL
    from .errors import Lz4Error

    if reservation is None:
        reservation = FOR_ALL
    try:
        return _decompress_sharded_batch(data, mesh, reservation, stats)
    except Lz4Error:
        from .api import decompress_host

        out = decompress_host(data, reservation)
        if stats is not None:
            stats.note_engine("host", 0, len(out))
        return out


def _decompress_sharded_batch(data, mesh: Mesh | None, reservation,
                              stats) -> bytes:
    from .frame import parse_frames
    from .pipeline import (
        BatchCapacityExceeded, _chains_of, _verify_checksums,
        build_seq_table,
    )

    if mesh is None:
        mesh = make_mesh()
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    if buf.size == 0:
        return b""
    parsed = parse_frames(buf, reservation)
    try:
        table = build_seq_table(buf, parsed, reservation, data,
                               pooled_cols=True)
    except BatchCapacityExceeded:
        # stream decodes past int32 coordinates: host engine takes over
        from .api import decompress_host

        out = decompress_host(data, reservation)
        if stats is not None:
            stats.note_engine("host", 0, len(out))
        return out
    if table.n_out == 0:
        _verify_checksums(buf, parsed, buf[:0], table)
        return b""
    live = [c for c in _chains_of(table) if c.out_hi > c.out_lo]
    if len(live) > 1:
        out = decode_sharded_chains(table, buf, mesh, stats)
    else:
        out = decode_sharded(table, buf, mesh)
        if stats is not None:
            stats.note_engine("resolve_sharded", 1, table.n_out)
    _verify_checksums(buf, parsed, out, table)
    return out.tobytes()


# ---------------------------------------------------------------------------
# Data-parallel encode (BASELINE config: multi-host DP encoder round-trip)
# ---------------------------------------------------------------------------

def compress_sharded(
    data,
    mesh: Mesh | None = None,
    *,
    block_max_code: int = 7,
    content_checksum: bool = True,
    block_checksum: bool = False,
    content_size: bool = False,
    block_independence: bool = False,
) -> bytes:
    """LZ4 frame compression with block-parallel device match finding.

    Encoding is embarrassingly parallel even with linked blocks: block
    k's 64 KiB history is *input* data, known upfront, so every block's
    sorted-gram candidate pass (device/encode.py) runs concurrently —
    here as a batch matmul-style vmap whose leading (block) axis is
    sharded across the mesh.  Token emission stays on the host per
    block (byte-granular), and the frame assembles in block order, so
    output is bit-identical to ``compress(backend="device")``.
    """
    import struct

    from .api import _BLOCK_CODE_SIZE, _frame_descriptor
    from .device.encode import _candidates_compact_device
    from .native import compress_block_cands
    from .xxh32 import xxh32
    from .constants import MAGIC_MODERN

    data = bytes(data)
    if mesh is None:
        mesh = make_mesh()
    block_max = _BLOCK_CODE_SIZE[block_max_code]
    n_blocks = -(-len(data) // block_max)     # 0 blocks for empty input
    HCAP = 65536

    # Stage fixed-shape per-block buffers: [zero pad | history | block].
    width = HCAP + block_max
    width_pad = (width + 1023) // 1024 * 1024
    n_pad = -(-n_blocks // mesh.size) * mesh.size
    bufs = np.zeros((n_pad, width_pad), np.uint8)
    first_valid = np.zeros(n_pad, np.int32)
    spans = []
    for b in range(n_blocks):
        pos = b * block_max
        chunk = data[pos:pos + block_max]
        hist = b"" if block_independence else data[max(0, pos - HCAP):pos]
        bufs[b, HCAP - len(hist):HCAP] = np.frombuffer(hist, np.uint8)
        bufs[b, HCAP:HCAP + len(chunk)] = np.frombuffer(chunk, np.uint8)
        first_valid[b] = HCAP - len(hist)
        spans.append((len(hist), len(chunk)))

    if n_blocks:
        sharding = NamedSharding(mesh, P(AXIS, None))
        # vmapped compact deltas come back (B, 2, n) uint16 — 4 B per
        # payload byte across the link (round-2 verdict next-#5):
        # shard the block axis
        out_sharding = NamedSharding(mesh, P(AXIS, None, None))
        batched = jax.jit(
            jax.vmap(
                functools.partial(_candidates_compact_device.__wrapped__,
                                  n_pad=width_pad)
            ),
            in_shardings=sharding,
            out_shardings=out_sharding,
        )
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils

            gbufs = jax.make_array_from_process_local_data(sharding, bufs)
            cands = np.asarray(
                multihost_utils.process_allgather(batched(gbufs), tiled=True)
            )
        else:
            cands = np.asarray(
                jax.device_get(batched(jax.device_put(bufs, sharding)))
            )

    out = bytearray(struct.pack("<I", MAGIC_MODERN))
    out += _frame_descriptor(
        len(data) if content_size else None,
        block_max_code, content_checksum, block_checksum,
        block_independence,
    )
    for b in range(n_blocks):
        hist_len, src_len = spans[b]
        fv = int(first_valid[b])
        # Hand the emitter a buffer that STARTS at the first real byte:
        # its backward match extension stops at position 0, so it can
        # never walk into the zero padding before the history (which
        # would emit back-references reaching before the frame start).
        # Deltas -> positions rebased to fv; a delta reaching before fv
        # (into the zero padding) is dropped, and the last 3/7 real
        # positions are masked exactly like compact_candidates does
        # (their grams read past the real data), keeping the sharded
        # frame bit-identical to the sequential device encoder.
        L = HCAP + src_len - fv
        d = np.array(cands[b, :, fv:HCAP + src_len], np.int32)
        d[0, max(0, L - 3):] = 0
        d[1, max(0, L - 7):] = 0
        rel = np.arange(L, dtype=np.int32)
        cand = np.where((d > 0) & (rel[None, :] - d >= 0),
                        rel[None, :] - d, -1).astype(np.int32)
        comp = compress_block_cands(
            bufs[b, fv:], HCAP - fv, src_len, cand, lazy=True
        )
        chunk = data[b * block_max: b * block_max + src_len]
        if comp and len(comp) < src_len:
            out += struct.pack("<I", len(comp))
            out += comp
            blk = comp
        else:
            out += struct.pack("<I", src_len | 0x80000000)
            out += chunk
            blk = chunk
        if block_checksum:
            out += struct.pack("<I", xxh32(blk))
    out += b"\x00\x00\x00\x00"
    if content_checksum:
        out += struct.pack("<I", xxh32(data))
    return bytes(out)
