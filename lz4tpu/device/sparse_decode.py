"""Sparse-chain decoder: few big segments as pure XLA data movement.

Zeros-like streams (a 9 MB run of zeros is a handful of sequences) and
incompressible data (literal runs, uncompressed blocks) spend all their
bytes in a few giant segments.  The reference handles these in the
same byte loop as everything else (lib/lz4ada.adb:780-817); on the
device the right shape is a tiny host-built *program* of vector
operations:

  copy  dst <- comp[src : src+n]     literal runs / uncompressed blocks
  fill  dst <- tile(pattern)[:n]     matches with small offsets (RLE);
                                     the pattern bytes are resolved on
                                     the host by chasing segment
                                     metadata (cheap: sparse chains
                                     have few segments)
  self  dst <- out[src : src+n]      large-offset matches; split into
                                     offset-sized chunks when the match
                                     self-overlaps

The program runs as one XLA computation: a concatenation of slices and
fills (``jnp.full`` for a uniform byte), or a chain of
dynamic_update_slice ops when a segment copies earlier output.  Chains
whose matches cannot be expressed this way (deep patterns, too many
chunks) are rejected at build time and go to the resolver
(device/decode.py).

jit caching is keyed on the op list without the copies' input offsets
(those are runtime operands), so blocks of one layout anywhere in any
stream share a compiled program.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
import typing

import numpy as np

MAX_PATTERN = 64        # resolve fill patterns up to this offset
MAX_SELF_CHUNKS = 32    # split budget for self-overlapping big matches
MAX_OPS = 512           # program-size cap: beyond this, not "sparse"


class SparseOp(typing.NamedTuple):
    # NamedTuple, not a frozen dataclass: program builds construct one
    # op per segment and object.__setattr__-based init was the largest
    # term in copy-heavy plans (b3444k: 54 ops)
    kind: str            # 'copy' | 'fill' | 'self'
    dst: int
    n: int
    src: int = 0         # comp offset ('copy') / out offset ('self')
    pattern: bytes = b""  # 'fill' only


@dataclasses.dataclass
class SparseProgram:
    ops: tuple           # tuple[SparseOp, ...] (hashable for jit cache)
    n_out: int


class _Unsupported(Exception):
    pass


class _Builder:
    def __init__(self, buf: np.ndarray):
        self.buf = buf
        self.ops: list = []
        self._dsts: list = []   # ops are contiguous, sorted by dst
        self.pos = 0

    def _byte_at(self, p: int, depth: int = 0) -> int:
        """Resolve the decoded byte at output position p from segment
        metadata (host side, no decoding)."""
        if depth > 16:
            raise _Unsupported("pattern chain too deep")
        # ops partition [0, pos) in dst order: bisect for the owner
        # (the old linear reversed-scan was O(ops) per pattern byte —
        # 0.17 ms of the b3444k plan)
        i = bisect.bisect_right(self._dsts, p) - 1
        if i >= 0:
            op = self.ops[i]
            if op.dst <= p < op.dst + op.n:
                rel = p - op.dst
                if op.kind == "copy":
                    return int(self.buf[op.src + rel])
                if op.kind == "fill":
                    return op.pattern[rel % len(op.pattern)]
                return self._byte_at(op.src + rel, depth + 1)
        raise _Unsupported("byte before chain start")

    def _push(self, op: SparseOp):
        if len(self.ops) >= MAX_OPS:
            raise _Unsupported("too many segments for the sparse path")
        self.ops.append(op)
        self._dsts.append(op.dst)
        self.pos += op.n

    def literal(self, comp_off: int, n: int):
        if n:
            self._push(SparseOp("copy", self.pos, n, src=int(comp_off)))

    def match(self, off: int, n: int):
        if n == 0:
            return
        if off <= MAX_PATTERN:
            pattern = bytes(
                self._byte_at(self.pos - off + k) for k in range(off)
            )
            self._push(SparseOp("fill", self.pos, n, pattern=pattern))
            return
        if n <= off:
            self._push(SparseOp("self", self.pos, n, src=self.pos - off))
            return
        # self-overlapping large-offset match: offset-sized chunks
        if (n + off - 1) // off > MAX_SELF_CHUNKS:
            raise _Unsupported("overlapping match needs too many chunks")
        rem = n
        while rem > 0:
            take = min(rem, off)
            self._push(SparseOp("self", self.pos, take, src=self.pos - off))
            rem -= take


def build_sparse_program(
    lit_len: np.ndarray,
    match_len: np.ndarray,
    match_off: np.ndarray,
    lit_src: np.ndarray,
    buf: np.ndarray,
) -> SparseProgram | None:
    """Try to express one chain as a sparse program; None if it isn't
    sparse-shaped (the caller falls back to another engine)."""
    b = _Builder(buf)
    try:
        # one bulk tolist() per array: per-element numpy-scalar
        # conversion dominates this Python loop for copy-heavy chains
        for ls, ll, mo, ml in zip(lit_src.tolist(), lit_len.tolist(),
                                  match_off.tolist(), match_len.tolist()):
            b.literal(ls, ll)
            b.match(mo if mo > 1 else 1, ml)
    except _Unsupported:
        return None
    return SparseProgram(ops=tuple(b.ops), n_out=b.pos)


def _program_key(ops: tuple) -> tuple:
    """The static part of a program: everything but the compressed-input
    offsets of its copies, which are runtime operands — blocks of the
    same layout at different places in a stream share one compile."""
    return tuple((op.kind, op.dst, op.n, op.src if op.kind == "self" else 0,
                  op.pattern) for op in ops)


@functools.lru_cache(maxsize=256)
def _compile_program(key: tuple, n_out: int):
    """Compile a sparse program to a jitted ``fn(comp, copy_srcs)``
    returning uint8 [n_out]."""
    import jax
    import jax.numpy as jnp

    def _fill_seg(n, pattern):
        if len(set(pattern)) == 1:      # uniform byte -> pure memset
            return jnp.full((n,), pattern[0], jnp.uint8)
        pat = jnp.asarray(np.frombuffer(pattern, np.uint8))
        reps = (n + len(pattern) - 1) // len(pattern)
        return jnp.tile(pat, reps)[:n]

    has_self = any(op[0] == "self" for op in key)

    def run(comp, copy_srcs):
        # Without 'self' ops the segments tile the output in order with
        # no holes: one concatenation — no zero-init, no update copies.
        out = jnp.zeros((max(n_out, 1),), jnp.uint8) if has_self else None
        segs = []
        k = 0
        for kind, dst, n, src, pattern in key:
            if kind == "copy":
                seg = jax.lax.dynamic_slice(comp, (copy_srcs[k],), (n,))
                k += 1
            elif kind == "fill":
                seg = _fill_seg(n, pattern)
            else:
                seg = jax.lax.dynamic_slice(out, (src,), (n,))
            if has_self:
                out = jax.lax.dynamic_update_slice(out, seg, (dst,))
            else:
                segs.append(seg)
        if has_self:
            return out[:n_out]
        return segs[0] if len(segs) == 1 else jnp.concatenate(segs)

    return jax.jit(run)


def decode_sparse_device(program: SparseProgram, comp_dev):
    """Run the program on device; returns the uint8 [n_out] array.
    ``comp_dev`` is the request's staged compressed buffer (any
    padding beyond the stream is never read)."""
    srcs = np.array([op.src for op in program.ops if op.kind == "copy"],
                    np.int32)
    fn = _compile_program(_program_key(program.ops), program.n_out)
    return fn(comp_dev, srcs)
