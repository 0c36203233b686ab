"""The port's entry points (``vector_db_torch/graft_entry.py``) against the
reference's (``__graft_entry__.py``), on the CPU.

``entry()`` gives (8, 8) results; the reference's example state (its
codebooks trained by ``jax.random``), carried across as numpy through the
port's flagship search with the same ``functools.partial``, gives the
reference's ids (apart from distance ties) and its distances within 1e-4;
the port's own example rows and queries are the reference's (the same
numpy draws); ``dryrun_multichip`` runs its asserts on 4 and 8 CPU shards.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import __graft_entry__ as ref_ge  # noqa: E402
from vector_db_torch import graft_entry as ge  # noqa: E402


def test_entry_gives_8_by_8_results():
    fn, args = ge.entry(device="cpu")
    d, ext = fn(*args)
    assert d.shape == (8, 8) and ext.shape == (8, 8)
    assert ((ext >= 0) & (ext < 512)).all()
    assert (d[:, :-1] <= d[:, 1:]).all()


def test_reference_state_through_the_port_gives_its_results():
    ref_fn, ref_args = ref_ge.entry()
    want_d, want_e = (np.asarray(x) for x in jax.jit(ref_fn)(*ref_args))
    fn, _ = ge.entry(device="cpu")
    assert fn.keywords == ref_fn.keywords
    d, e = fn(*(torch.from_numpy(np.array(a)) for a in ref_args))
    d, e = d.numpy(), e.numpy()
    np.testing.assert_allclose(d, want_d, rtol=1e-4, atol=1e-4)
    for row in np.argwhere((e != want_e).any(1))[:, 0]:
        # ids differ only where the distances tie within the tolerance
        np.testing.assert_allclose(np.sort(d[row]), np.sort(want_d[row]),
                                   rtol=1e-4, atol=1e-4)
    assert (e == want_e).mean() >= 0.95


def test_example_rows_are_the_references():
    ref = ref_ge._example_state()
    got = ge._example_state(device="cpu")
    for i in (0, 4, 5):  # queries, vectors, ids
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]))
    cb = got[1]
    assert cb.shape == tuple(np.asarray(ref[1]).shape)
    assert got[2].shape == tuple(np.asarray(ref[2]).shape)
    # the same seed gives the same codebooks
    assert torch.equal(ge._example_state(device="cpu")[1], cb)


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip_on_cpu_shards(n):
    ge.dryrun_multichip(n, device="cpu")  # asserts internally
