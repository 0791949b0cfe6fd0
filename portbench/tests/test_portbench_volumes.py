"""The seeded volume pools: the same seed gives the same volumes, the
configuration's sizes are kept whatever the seed, and the seed draws
content and order."""

import numpy as np
import pytest
import torch

from portbench import volumes


@pytest.mark.parametrize("kind", ["heart", "lits"])
def test_pool_is_a_function_of_the_seed(kind):
    cpu = torch.device("cpu")
    a = volumes.pool(kind, (40, 36), (12, 17), 2 ** 31 + 11, cpu)
    b = volumes.pool(kind, (40, 36), (12, 17), 2 ** 31 + 11, cpu)
    c = volumes.pool(kind, (40, 36), (12, 17), 5, cpu)
    assert [v.shape for v in a] == [(40, 36, 12), (40, 36, 17)]
    assert [v.shape for v in c] == [(40, 36, 12), (40, 36, 17)]
    assert all(v.dtype == np.float32 for v in a)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])


def test_labels_mark_the_organs():
    vol, lab = (t.numpy() for t in volumes.lits((60, 60, 30), 3, 0,
                                                torch.device("cpu")))
    assert set(np.unique(lab)) == {0, 1, 2}
    assert np.all(vol[lab == 1] == -150.0) and np.all(vol[lab == 2] == -280.0)
    vol, lab = (t.numpy() for t in volumes.heart((60, 60, 30), 3, 0,
                                                 torch.device("cpu")))
    assert set(np.unique(lab)) == set(range(8))
    assert vol[lab > 0].mean() > vol[lab == 0].mean() + 2.0


def test_order_is_a_permutation_drawn_from_the_seed():
    assert sorted(volumes.order(6, 9)) == list(range(6))
    assert volumes.order(6, 9) == volumes.order(6, 9)
    assert len({tuple(volumes.order(6, s)) for s in range(20)}) > 1
