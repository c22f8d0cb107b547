"""The dp-sharded coupled chain (`pvio_torch/parallel/multi_seq.run_batched`
with a mesh) over gloo process groups on the CPU: the port's counterpart of
`tests/test_multi_seq.py::test_dp_sharded_batch_matches_unbatched`, with
its `small_cfg` (320x240, 7 frame slots, 128 tracks, planes on, float64).

Each dp rank runs the vmapped chain on its block of the sequences and the
costs and windows are gathered over the dp group; every rank's result must
equal the unbatched port chain of each sequence with the reference's
tolerances (costs rtol 1e-9, positions atol 1e-9). Tier 1 runs dp = 2 over
two sequences at one group of two frames; the reference's own case (dp = 4
over four sequences, two groups of four frames) is `slow`, as the reference
marks it. The worlds are spawned by `tests/test_torch_sharded_ba.run_world`;
this module imports no JAX at its top, since the workers import it.
"""

import numpy as np
import pytest
import torch

from pvio_torch.core.kernels import DeviceKernels as TKernels
from pvio_torch.parallel import multi_seq as Tms
from pvio_torch.parallel import sharded_ba as Tsh
from tests.test_torch_sharded_ba import run_world

torch.set_num_threads(2)
SEED = 648


def chain_worker(dp, cfg, ws, arrays, groups, kf_every):
    """`run_batched` over a dp x 1 gloo mesh: (costs, positions of each
    sequence's final window)."""
    mesh = Tsh.ProcessMesh(dp, 1, device="cpu")
    kern = TKernels(cfg, device="cpu")
    costs, wfs = Tms.run_batched(kern, cfg, ws, arrays, groups, kf_every, mesh=mesh)
    return costs, [w.p for w in wfs]


@pytest.fixture(scope="module")
def port_cfg():
    from tests.test_torch_multi_seq import _port_cfg

    return _port_cfg()


def _dp_case(tmp_path, cfg, dp, groups, kf_every):
    kern = TKernels(cfg, device="cpu")
    ws, arrays = [], []
    for i in range(dp):
        w, a = Tms.build_sequence_inputs(cfg, kern, groups * kf_every, seed=SEED + 31 * i)
        ws.append(w)
        arrays.append(a)
    results = run_world(tmp_path, dp, chain_worker, dp, cfg, ws, arrays, groups, kf_every)
    chain = Tms.make_chain(kern, cfg, groups, kf_every)
    costs0, p0 = results[0]
    assert costs0.shape == (dp, groups) and np.isfinite(costs0).all()
    # distinct scenes must yield distinct solves
    assert len({round(float(c[-1]), 6) for c in costs0}) == dp
    for r, (costs, p) in enumerate(results[1:], 1):
        assert np.array_equal(costs, costs0) and all(map(torch.equal, p, p0)), r
    for i in range(dp):
        costs, wf = chain(ws[i], Tms.upload_arrays(kern, arrays[i]),
                          torch.zeros((), dtype=kern.dtype))
        np.testing.assert_allclose(costs0[i], costs.numpy(), rtol=1e-9)
        np.testing.assert_allclose(p0[i].numpy(), wf.p.numpy(), rtol=0, atol=1e-9)


def test_dp_sharded_chain_matches_unbatched(port_cfg, tmp_path):
    """dp = 2 over two sequences, one group of two frames (one BA and one
    marginalization each)."""
    _dp_case(tmp_path, port_cfg, 2, 1, 2)


@pytest.mark.slow
def test_dp_sharded_chain_matches_unbatched_full(port_cfg, tmp_path):
    """The reference's contract: dp = 4 over four sequences, GROUPS = 2,
    KF_EVERY = 4."""
    _dp_case(tmp_path, port_cfg, 4, 2, 4)
