"""Byte-parallel LZ4 decode on the device: the dense-chain engine.

This replaces the reference's sequential pointer-chasing hot loop
(reference: lib/lz4ada.adb:716-904) with a data-parallel formulation of
gathers and scatters, which the GPU runs natively:

1. **Sequence table** (host, native token scan): each block's token
   stream becomes per-sequence records (literal length/source, match
   length/offset) with output offsets.
2. **Ownership map**: each output byte finds its sequence with a
   scatter-max + running max — O(n) vector work.
3. **Source resolution**: each output byte's provenance is either a
   literal byte in the compressed input, or ``out[i - offset]``.
   Self-overlapping matches are collapsed with a modulo (generalizing
   the reference's doubling replay, lz4ada.adb:893-903) so every match
   byte points strictly before its own match start.  Remaining chains
   are resolved by pointer doubling — ``src = src[src]``.
4. **Byte gather**: one final gather pulls every output byte from the
   compressed input's literal regions.

Encoding convention: values < 0 are resolved literal pointers
(``-(comp_index) - 1``); values >= 0 are unresolved output positions.

Round bound: a match byte points strictly before its sequence's match
start, so every hop lands in an earlier sequence *of the same chain*
(chains never point into each other).  A provenance chain is therefore
at most S_max hops deep, S_max being the sequence count of the largest
chain, and ``ceil(log2(S_max)) + 1`` doubling rounds resolve every byte
— no convergence flag is needed.

Many chains resolve in ONE launch: the caller lays them out back to
back in one output space (``resolve``'s ``cols``).  Shapes are static
and bucketed to powers of two by the caller, so compiled programs are
reused across requests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# rows of the packed sequence-table operand of ``resolve``
COLS = ("out_start", "lit_len", "lit_src", "match_off", "match_len")
# padding value of each row: a padded sequence produces no byte
COL_PAD = {"lit_len": 0, "lit_src": 0, "match_off": 1, "match_len": 0}


def doubling_rounds(max_chain_seqs: int) -> int:
    """Pointer-doubling rounds that resolve every chain of at most
    ``max_chain_seqs`` sequences: ceil(log2(S)) + 1."""
    return (max(1, max_chain_seqs) - 1).bit_length() + 1


def initial_sources(pos, seq_id, out_start, lit_len, lit_src, match_off):
    """Per-byte provenance before doubling: a literal pointer, or the
    output position the byte copies (strictly before its match start).
    ``seq_id`` is the owning sequence of each position in ``pos``."""
    os_ = jnp.take(out_start, seq_id)
    ll = jnp.take(lit_len, seq_id)
    ls = jnp.take(lit_src, seq_id)
    mo = jnp.take(match_off, seq_id)
    local = pos - os_
    mstart = os_ + ll
    lit_ptr = -(ls + local) - 1
    match_ptr = mstart - mo + jax.lax.rem(pos - mstart, mo)
    return jnp.where(local < ll, lit_ptr, match_ptr)


@functools.partial(jax.jit, static_argnames=("n_out", "rounds"))
def resolve(comp, cols, n_real, *, n_out: int, rounds: int):
    """Decode a packed sequence table to bytes.

    comp:   uint8 [C] compressed input (any padding)
    cols:   int32 [5, S] rows ``COLS``; out_start in output coordinates
            (padded sequences: out_start = n_out, see ``COL_PAD``)
    n_real: int32 [] real output size (<= n_out); the padded tail
            gathers comp[0] and is sliced away by the caller
    Returns uint8 [n_out].
    """
    out_start, lit_len, lit_src, match_off, match_len = (
        cols[i] for i in range(len(COLS)))
    produces = (lit_len + match_len) > 0
    s_ids = jnp.arange(out_start.shape[0], dtype=jnp.int32)
    pos = jnp.arange(n_out, dtype=jnp.int32)

    # Ownership: seq_id[i] = index of the sequence producing byte i.
    claims = jnp.zeros((n_out,), jnp.int32).at[
        jnp.where(produces, out_start, n_out)].max(s_ids, mode="drop")
    seq_id = jax.lax.cummax(claims)

    src = initial_sources(pos, seq_id, out_start, lit_len, lit_src,
                          match_off)
    src = jnp.where(pos < n_real, src, -1)

    def double(_, s):
        hop = jnp.take(s, jnp.clip(s, 0, n_out - 1))
        return jnp.where(s >= 0, hop, s)

    src = jax.lax.fori_loop(0, rounds, double, src)
    return jnp.take(comp, jnp.clip(-src - 1, 0, comp.shape[0] - 1))


def bucket(n: int, minimum: int = 1024) -> int:
    """Round up to the next power of two (bounds the jit cache)."""
    b = minimum
    while b < n:
        b <<= 1
    return b


def pad_to(arr: np.ndarray, n: int, fill) -> np.ndarray:
    out = np.full((n,), fill, dtype=arr.dtype)
    out[: arr.size] = arr
    return out
