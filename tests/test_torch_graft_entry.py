"""``graft_entry_torch.py``, the torch twin of ``__graft_entry__.py``, on
the CPU: ``entry()``'s step against the JAX entry's step on the same
example inputs (``_tiny_cfg``, both packages pinned to "hashgrid", the JAX
package's "auto" on a CPU), and ``dryrun_multichip`` at one process and
at two gloo processes."""

import jax
import numpy as np
import pytest
import torch.distributed as dist

import __graft_entry__ as jentry
from direct_lidar_odometry_tpu.config import resolve_backend
import graft_entry_torch as tentry


def test_example_inputs_match_reference():
    """The same uniform points, mask and identity prior, also batched."""
    for batch in (None, 3):
        cfg = tentry._tiny_cfg()
        for t, j in zip(tentry._example_inputs(cfg, batch, device="cpu"),
                        jentry._example_inputs(jentry._tiny_cfg(), batch)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_entry_step_matches_reference(monkeypatch):
    """One step of the port's entry (on "hashgrid") against the JAX
    entry's jitted step: pose within 1e-4 m, S2M correspondences equal."""
    assert resolve_backend(jentry._tiny_cfg()) == "hashgrid"
    fn_j, args_j = jentry.entry()
    _, res_j = jax.jit(fn_j)(*args_j)
    tiny = tentry._tiny_cfg
    monkeypatch.setattr(tentry, "_tiny_cfg", lambda: tiny().replace(nn_backend="hashgrid"))
    fn, args = tentry.entry(device="cpu")
    _, res = fn(*args)
    np.testing.assert_allclose(res.pose.numpy(), np.asarray(res_j.pose), atol=1e-4)
    assert int(res.s2m_num_corr) == int(res_j.s2m_num_corr)
    assert np.isfinite(res.pose.numpy()).all()


@pytest.mark.parametrize("n", [1, 2])
def test_dryrun_multichip_over_gloo(n):
    """The sharded step and the distributed refine on a group of ``n``
    gloo processes (this one at n = 1); no group is left open."""
    tentry.dryrun_multichip(n, device="cpu")
    assert not dist.is_initialized()
