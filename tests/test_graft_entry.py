"""The entry points in __graft_entry__.py must keep working: entry()
returns a jittable forward decode step, and dryrun_multichip() runs the
full sharded decode (chain-parallel AND span-sharded resolver) over
the 8-device mesh.  They also run outside the suite; this pins them
in-suite so a refactor cannot silently break them.
"""

import jax
import numpy as np

import __graft_entry__ as ge


def test_entry_compiles_and_runs():
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    arr = np.asarray(out)
    assert arr.size > 0
    # The flagship is the byte-parallel resolver on every platform: its
    # output is the decoded byte stream, so it reproduces the payload.
    assert arr[: len(ge.PAYLOAD)].tobytes() == ge.PAYLOAD


def test_dryrun_multichip_8():
    assert len(jax.devices()) >= 8
    ge.dryrun_multichip(8)
