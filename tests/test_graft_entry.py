"""Keep the driver entry points (__graft_entry__.py) compiling and running."""

import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_entry_compiles_and_runs():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    # entry() returns the production frame program's outputs:
    # (SlamFrame, velocity, host_vec, MapState, LocalMap)
    new_state, velocity, host_vec, mapstate, local = out
    Tcw = np.asarray(new_state.Tcw)
    assert Tcw.shape == (4, 4)
    assert np.isfinite(Tcw).all()
    assert np.isfinite(np.asarray(host_vec)).all()


def test_dryrun_multichip_8():
    import __graft_entry__ as g

    assert len(jax.devices()) >= 8
    g.dryrun_multichip(8)


def test_dryrun_multichip_2():
    import __graft_entry__ as g

    g.dryrun_multichip(2)
