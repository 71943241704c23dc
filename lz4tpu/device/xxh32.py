"""xxhash32 of device-resident bytes (reference: lib/lz4ada.adb:923-1026).

xxh32 is a serial chain: four u32 lane accumulators fed 16-byte
stripes, then a serial avalanche.  One range cannot be split, but the
ranges a frame verifies — every block checksum, every frame's content
checksum — are independent.  The kernel therefore runs one Pallas
program per hashed range (Triton route), the four lanes held as one
4-wide ``uint32`` vector, so a frame's block checksums spread over the
GPU's SMs in one launch.  Only the lane states and the <= 15 tail bytes
of each range cross to the host, which folds them into the digest
(constant work per range).

``lane_states_xla`` is the same computation in plain JAX (a
``lax.fori_loop`` over stripes, all ranges in step): the reference the
kernel is tested and timed against.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import interpret as _interpret
from .decode import bucket
from ..xxh32 import XXHash32

P1 = 2654435761
P2 = 2246822519
P3 = 3266489917
P4 = 668265263
P5 = 374761393
_LANE_INIT = ((P1 + P2) & 0xFFFFFFFF, P2, 0, (-P1) & 0xFFFFFFFF)
# stripes per loop iteration: their loads issue together, ahead of the
# serial multiply-rotate chain that consumes them (16 measured fastest
# of 8/16/32 on an H100; PERF.md)
_UNROLL = 16


def _round(acc, w):
    acc = acc + w * jnp.uint32(P2)
    acc = (acc << 13) | (acc >> 19)
    return acc * jnp.uint32(P1)


def _lanes_kernel(start_ref, nstr_ref, words_ref, out_ref):
    """Program r hashes the n_stripes[r] stripes at byte start[r] of the
    data, read as little-endian u32 words: a stripe's four lane words
    are two overlapping 4-word loads funnel-shifted by start % 4."""
    from jax.experimental import pallas as pl

    r = pl.program_id(0)
    start = start_ref[r]
    n = nstr_ref[r]
    q = start // 4
    sh = ((start % 4) * 8).astype(jnp.uint32)
    lane = jax.lax.broadcasted_iota(jnp.int32, (4,), 0)
    acc = jnp.full((4,), _LANE_INIT[3], jnp.uint32)
    for k in (2, 1, 0):
        acc = jnp.where(lane == k, jnp.uint32(_LANE_INIT[k]), acc)

    def stripe(wq):
        lo = words_ref[pl.ds(wq, 4)]
        hi = words_ref[pl.ds(wq + 1, 4)]
        # (hi << (32 - sh)) without a 32-bit shift when sh == 0
        return (lo >> sh) | ((hi << (jnp.uint32(31) - sh)) << 1)

    def body(i, acc):
        base = q + i * (4 * _UNROLL)
        words = [stripe(base + 4 * u) for u in range(_UNROLL)]
        for w in words:
            acc = _round(acc, w)
        return acc

    def tail(i, acc):
        return _round(acc, stripe(q + 4 * i))

    acc = jax.lax.fori_loop(0, n // _UNROLL, body, acc)
    acc = jax.lax.fori_loop((n // _UNROLL) * _UNROLL, n, tail, acc)
    out_ref[pl.ds(4 * r, 4)] = acc


def _tails(data, starts, nstripes):
    idx = (starts + 16 * nstripes)[:, None] + jnp.arange(16)[None, :]
    return jnp.take(data, jnp.clip(idx, 0, data.shape[0] - 1))


@functools.partial(jax.jit, static_argnames=("interpret",))
def lane_states(data, starts, nstripes, *, interpret: bool):
    """(lanes uint32 [R, 4], tails uint8 [R, 16]) of R byte ranges of
    ``data`` through the Triton kernel."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as pltr

    n_ranges = starts.shape[0]
    words = jax.lax.bitcast_convert_type(data.reshape(-1, 4), jnp.uint32)
    lanes = pl.pallas_call(
        _lanes_kernel,
        grid=(n_ranges,),
        out_shape=jax.ShapeDtypeStruct((4 * n_ranges,), jnp.uint32),
        backend="triton",
        compiler_params=pltr.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="xxh32_lanes",
    )(starts, nstripes, words)
    return lanes.reshape(n_ranges, 4), _tails(data, starts, nstripes)


@jax.jit
def lane_states_xla(data, starts, nstripes):
    """``lane_states`` in plain JAX: one ``fori_loop`` step per stripe,
    every range advancing in step."""
    init = jnp.broadcast_to(
        jnp.asarray(np.array(_LANE_INIT, np.uint32)), (starts.shape[0], 4))

    def body(i, acc):
        idx = (starts + 16 * i)[:, None] + jnp.arange(16)[None, :]
        b = jnp.take(data, jnp.clip(idx, 0, data.shape[0] - 1))
        b = b.astype(jnp.uint32).reshape(-1, 4, 4)
        w = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
        return jnp.where((i < nstripes)[:, None], _round(acc, w), acc)

    lanes = jax.lax.fori_loop(0, jnp.max(nstripes), body, init)
    return lanes, _tails(data, starts, nstripes)


def _finalize(lanes, n: int, tail: bytes) -> int:
    """Fold a 4-lane state and the < 16-byte tail into the digest
    (reference: lz4ada.adb:993-1017)."""
    if n < 16:
        return XXHash32().update(tail).final()
    s0, s1, s2, s3 = (int(x) for x in lanes)

    def rotl(v, r):
        return ((v << r) | (v >> (32 - r))) & 0xFFFFFFFF

    h = (rotl(s0, 1) + rotl(s1, 7) + rotl(s2, 12) + rotl(s3, 18) + n)
    h &= 0xFFFFFFFF
    i = 0
    while i + 4 <= len(tail):
        w = int.from_bytes(tail[i:i + 4], "little")
        h = (rotl((h + w * P3) & 0xFFFFFFFF, 17) * P4) & 0xFFFFFFFF
        i += 4
    while i < len(tail):
        h = (rotl((h + tail[i] * P5) & 0xFFFFFFFF, 11) * P1) & 0xFFFFFFFF
        i += 1
    h ^= h >> 15
    h = (h * P2) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * P3) & 0xFFFFFFFF
    h ^= h >> 16
    return h


def prepare_ranges(data, offsets, lengths):
    """Bucketed operands of ``lane_states``: (data zero-padded to a
    power of two with at least 16 bytes of slack for the kernel's
    overlapping word loads, starts, n_stripes), the range count padded
    with empty ranges — so one compiled kernel serves every request of
    similar size."""
    data = jnp.asarray(data, jnp.uint8)
    n_pad = bucket(data.shape[0] + 16)
    if n_pad != data.shape[0]:
        data = jnp.pad(data, (0, n_pad - data.shape[0]))
    r_pad = bucket(len(offsets), minimum=1)
    starts = np.zeros(r_pad, np.int32)
    nstr = np.zeros(r_pad, np.int32)
    starts[:len(offsets)] = offsets
    nstr[:len(lengths)] = np.asarray(lengths, np.int64) // 16
    return data, starts, nstr


def xxh32_ranges(data, offsets, lengths) -> list[int]:
    """xxh32(seed=0) of ``data[o:o+n]`` for every (o, n) pair, where
    ``data`` is a uint8 array (device-resident or host).  All ranges
    hash in one kernel launch; one fetch brings back lane states and
    tails."""
    offsets = [int(o) for o in offsets]
    lengths = [int(n) for n in lengths]
    if not offsets:
        return []
    data, starts, nstr = prepare_ranges(data, offsets, lengths)
    lanes, tails = jax.device_get(
        lane_states(data, starts, nstr, interpret=_interpret()))
    return [_finalize(lanes[k], n, bytes(tails[k][: n % 16]))
            for k, n in enumerate(lengths)]
