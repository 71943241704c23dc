#!/usr/bin/env python3
"""Decode benchmark on one NVIDIA GPU.

    python bench.py [--seed N] [--reps R]    # decode throughput
    python bench.py --kernels [--reps R]     # hand-written kernel checks

Decode mode times ``decompress_to_device(frame, verify="device")`` end
to end — compressed bytes on the host to verified bytes in device
memory, parse, token scan, staging and checksums included — with
``block_until_ready`` as the sync, after one warm-up call that compiles.
Its inputs are generated from ``--seed`` (lz4tpu.corpus) in the shapes
of the three inputs the seed's BASELINE names, all framed with the lz4
CLI defaults (4 MiB independent blocks, content checksum):

  z9m     9,437,166 zero bytes
  t1111k  1,137,664 bytes of log text
  b3444k  3,526,656 incompressible bytes

``--kernels`` measures what decides whether the hand-written pieces
stay: the Triton xxh32 kernel against its plain-JAX version
(``lax.fori_loop`` over stripes) and against host verification
(device-to-host copy plus native xxh32), at 4 MiB and 64 MiB of content
and 1,024 blocks of 64 KiB; a 64 MiB zeros frame decoded by its sparse
programs beside the card's copy rate (timed inside one program, free of
dispatch); and the sparse engine against the resolver on short chains,
which sets the planner's per-sequence byte floor.

Every output line is one JSON object naming the platform, device kind,
device count and the card's power limit.  Without a GPU the benchmark
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

MiB = 1 << 20
HERE = os.path.dirname(os.path.abspath(__file__))


def card() -> dict:
    """Identity of the card every result is stamped with."""
    import jax

    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, check=True)
    dev = jax.devices()[0]
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "count": len(jax.devices()),
            "nvidia_smi": r.stdout.strip().splitlines()[0]}


def times(fn, reps: int, warm: bool = True) -> list[float]:
    """A warm-up call (compiles) unless the caller already made one,
    then ``reps`` timed calls; ``fn`` syncs with ``block_until_ready``
    (or a host fetch) before returning."""
    if warm:
        fn()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return out


def emit(ident: dict, **fields) -> None:
    print(json.dumps({**fields, **ident}), flush=True)


def bench_decode(ident: dict, seed: int, reps: int) -> None:
    import numpy as np

    import lz4tpu
    from lz4tpu import corpus
    from lz4tpu.pipeline import DecodeStats

    rng = np.random.default_rng(seed)
    payloads = {
        "z9m": corpus.zeros(9_437_166),
        "t1111k": corpus.log_text(rng, 1_137_664),
        "b3444k": corpus.incompressible(rng, 3_526_656),
    }
    for name, payload in payloads.items():
        frame = lz4tpu.compress(payload, block_independence=True)
        st = DecodeStats()

        def run():
            lz4tpu.decompress_to_device(frame, verify="device",
                                        stats=st).block_until_ready()

        ts = times(run, reps)
        got = np.asarray(lz4tpu.decompress_to_device(frame)).tobytes()
        if got != payload:
            raise AssertionError(f"{name}: decode differs from payload")
        med = statistics.median(ts)
        emit(ident, input=name, out_bytes=len(payload),
             comp_bytes=len(frame), seconds=ts, median_s=med,
             gb_per_s=len(payload) / med / 1e9,
             engine_bytes={k: v // (reps + 1)
                           for k, v in st.engine_bytes.items()})


def bench_kernels(ident: dict, reps: int) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    import lz4tpu
    from lz4tpu import corpus, native
    from lz4tpu.device import interpret
    from lz4tpu.device import sparse_decode as sp
    from lz4tpu.device import xxh32 as dx
    from lz4tpu.pipeline import _chains_of, build_seq_table, plan_decode
    from lz4tpu.pipeline import stage_comp
    from lz4tpu.frame import parse_frames

    rng = np.random.default_rng(0)
    # longest range (in stripes) the plain version may take on: its time
    # grows with that range's stripe count, measured at 4 MiB first
    plain_budget = 4 * MiB // 16
    cases = {
        "content_4MiB": (4 * MiB, [0], [4 * MiB]),
        "content_64MiB": (64 * MiB, [0], [64 * MiB]),
        "blocks_1024x64KiB": (64 * MiB,
                              [k * (64 * MiB // 1024) for k in range(1024)],
                              [64 * MiB // 1024] * 1024),
    }
    for name, (size, offs, lens) in cases.items():
        host_data = rng.integers(0, 256, size, dtype=np.uint8)
        want = [native.native_xxh32(host_data[o:o + n])
                for o, n in zip(offs, lens)]
        d, st, ns = dx.prepare_ranges(host_data, offs, lens)
        d.block_until_ready()
        variants = {
            "triton_kernel": lambda: jax.device_get(
                dx.lane_states(d, st, ns, interpret=interpret())),
            "plain_fori_loop": lambda: jax.device_get(
                dx.lane_states_xla(d, st, ns)),
        }
        for variant, fn in variants.items():
            steps = max(lens) // 16
            if variant == "plain_fori_loop" and steps > plain_budget:
                # one fori_loop step per stripe: at 64 MiB of content it
                # would run for minutes
                emit(ident, kernel="xxh32", case=name, variant=variant,
                     bytes=size, seconds=None, median_s=None,
                     note="not measured: exceeds the time budget")
                continue
            t0 = time.perf_counter()
            lanes, tails = fn()         # compiles; checked below
            first = time.perf_counter() - t0
            got = [dx._finalize(lanes[k], n, bytes(tails[k][: n % 16]))
                   for k, n in enumerate(lens)]
            if got != want:
                raise AssertionError(f"{name} {variant}: wrong digests")
            slow = variant == "plain_fori_loop"
            ts = times(fn, 1 if slow else reps, warm=False)
            if slow and name == "content_4MiB":
                plain_budget = int(steps * 60 / max(ts[0], 1e-9))
            emit(ident, kernel="xxh32", case=name, variant=variant,
                 bytes=size, first_call_s=first, seconds=ts,
                 median_s=statistics.median(ts))

        exact = jax.device_put(host_data)

        def host():
            h = np.asarray(jax.device_get(exact))
            return [native.native_xxh32(h[o:o + n])
                    for o, n in zip(offs, lens)]

        if host() != want:
            raise AssertionError(f"{name} host: wrong digests")
        ts = times(host, reps)
        emit(ident, kernel="xxh32", case=name, variant="verify_host",
             bytes=size, seconds=ts, median_s=statistics.median(ts))

    zeros = corpus.zeros(64 * MiB)
    frame = lz4tpu.compress(zeros, block_independence=True)
    buf = np.frombuffer(frame, np.uint8)
    table = build_seq_table(buf, parse_frames(buf), lz4tpu.FOR_ALL, frame)
    plan = plan_decode(buf, table)
    if plan.dense or len(plan.sparse) != len(_chains_of(table)):
        raise AssertionError("zeros frame did not plan as sparse")
    comp = stage_comp(buf)

    def programs():
        for _c, prog in plan.sparse:
            out = sp.decode_sparse_device(prog, comp)
        out.block_until_ready()

    ts = times(programs, reps)
    emit(ident, kernel="sparse_fill", case="zeros_64MiB",
         programs=len(plan.sparse), seconds=ts,
         median_s=statistics.median(ts),
         out_gb_per_s=64 * MiB / statistics.median(ts) / 1e9,
         copy_gb_per_s=copy_rate(64 * MiB, reps))
    bench_sparse_floor(ident, reps)


def copy_rate(n: int, reps: int) -> float:
    """The card's copy rate (read + write bytes per second): 1 and 101
    in-place passes over ``n`` bytes inside one program each; the
    difference of their medians is 100 passes without dispatch."""
    import jax
    import jax.numpy as jnp

    x = jnp.zeros(n, jnp.uint8)
    med = {}
    for k in (1, 101):
        prog = jax.jit(lambda a, k=k: jax.lax.fori_loop(
            0, k, lambda _i, v: v + jnp.uint8(1), a))
        med[k] = statistics.median(
            times(lambda: prog(x).block_until_ready(), reps))
    return 2 * n * 100 / (med[101] - med[1]) / 1e9


def bench_sparse_floor(ident: dict, reps: int) -> None:
    """What a short chain costs under each engine, swept over the mean
    bytes per sequence (pipeline._SPARSE_MIN_SEQ_BYTES): 96 runs of one
    byte each, so the sparse program is ~190 copy/fill ops.  Two
    requests per size, each with its own run lengths, so the sparse
    engine meets a new op layout (a compile) on each; the resolver's
    shape bucket is shared."""
    import numpy as np

    import lz4tpu
    from lz4tpu.device import sparse_decode as sp
    from lz4tpu.frame import parse_frames
    from lz4tpu.pipeline import (_chains_of, build_seq_table,
                                 resolve_chains, stage_comp)

    rng = np.random.default_rng(1)
    for per_seq in (256, 1024, 4096, 16384):
        for request in range(2):
            runs = rng.integers(per_seq // 2, per_seq * 3 // 2, 96)
            byte = rng.integers(0, 256, 96)
            payload = b"".join(bytes([b]) * n
                               for b, n in zip(byte.tolist(), runs.tolist()))
            frame = lz4tpu.compress(payload, content_checksum=False)
            buf = np.frombuffer(frame, np.uint8)
            table = build_seq_table(buf, parse_frames(buf), lz4tpu.FOR_ALL,
                                    frame)
            (chain,) = _chains_of(table)
            sl = slice(chain.seq_lo, chain.seq_hi)
            comp = stage_comp(buf)
            comp.block_until_ready()

            def sparse():
                prog = sp.build_sparse_program(
                    table.lit_len[sl], table.match_len[sl],
                    table.match_off[sl], table.lit_src[sl], buf)
                return sp.decode_sparse_device(prog, comp)

            def resolver():
                (_lo, arr), = resolve_chains(table, [chain], comp)
                return arr

            for engine, fn in (("sparse", sparse), ("resolve", resolver)):
                t0 = time.perf_counter()
                got = np.asarray(fn())
                first = time.perf_counter() - t0
                if got.tobytes() != payload:
                    raise AssertionError(f"sparse floor {engine}: wrong bytes")
                ts = times(lambda: fn().block_until_ready(), reps, warm=False)
                emit(ident, kernel="sparse_floor", bytes_per_seq=per_seq,
                     request=request, engine=engine,
                     seqs=chain.seq_hi - chain.seq_lo, out_bytes=len(payload),
                     first_call_s=first, seconds=ts,
                     median_s=statistics.median(ts))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--kernels", action="store_true",
                    help="time the hand-written kernels against their "
                         "plain versions instead of the decode inputs")
    args = ap.parse_args()

    import jax

    from lz4tpu.device import platform, use_compile_cache

    use_compile_cache(os.path.join(HERE, ".jax_cache"))
    if platform() != "gpu":
        print("bench: needs an NVIDIA GPU; JAX's default device is "
              f"{jax.devices()[0].platform!r}", file=sys.stderr)
        return 1
    ident = card()
    if args.kernels:
        bench_kernels(ident, args.reps)
    else:
        bench_decode(ident, args.seed, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
