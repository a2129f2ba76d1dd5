"""`parallel/dryrun.py::dryrun_multichip(2)`, the port's counterpart of
the JAX package's `__graft_entry__.dryrun_multichip`: two gloo ranks on
the CPU, one data-parallel step of the dry run's narrow Hourglass-104,
each rank's decode and device augmentation, in one spawn."""
import numpy as np
import pytest

from offsetguided_tpu_torch.parallel import dryrun


@pytest.fixture(scope='module')
def ranks():
    return dryrun.dryrun_multichip(2, device='cpu')


def test_dryrun_multichip_two_ranks(ranks):
    """What `_dryrun_impl` asserts, per rank: one step, a finite loss, a
    (1, 4, 17, 6) pose block and a (1, 32, 32, 3) warped image for its
    one image; and the ranks' weights bit-equal after the step."""
    assert [r['rank'] for r in ranks] == [0, 1]
    for r in ranks:
        assert np.isfinite(r['loss'])
        assert r['poses_shape'] == (1, 4, dryrun.J, 6)
        assert r['aug_shape'] == (1, dryrun.HW, dryrun.HW, 3)
    assert ranks[0]['checksum'] == ranks[1]['checksum']
    assert ranks[0]['loss'] == ranks[1]['loss']


def test_a_failing_rank_is_raised():
    """A rank that fails raises in the caller with its traceback, and the
    other ranks are stopped (here: a case naming no worker)."""
    from offsetguided_tpu_torch.parallel import distributed, parity
    with pytest.raises(RuntimeError, match='KeyError'):
        distributed.spawn(parity.run_cases, 2, [('x', 'no_such_worker', {})],
                          timeout=120)
