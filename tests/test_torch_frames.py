"""PyTorch port vs the JAX reference: the synthetic frame task.

``repro_torch.data.synthetic`` draws from ``core.prng``.  Tolerances: the
label probe within 4 ulp of ``repro.data.synthetic``'s (its ``normal``; see
tests/test_torch_prng.py); frames within 4e-6 absolute (4 ulp of a normal
below 8 in magnitude, twice over for the non-IID frame plus speaker bias,
where cancellation makes a count of ulp meaningless); labels, an argmax
over ``windows @ probe``, equal on every seed, client, round and step here
(no tie flipped).
"""

import numpy as np
import pytest
import torch

from repro.data import synthetic as jsyn
from repro_torch.data import synthetic

torch.set_num_threads(1)


def _ulp(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)).max()


@pytest.mark.parametrize("iid", [True, False], ids=["iid", "non_iid"])
@pytest.mark.parametrize("seed", [0, 3])
def test_frame_batches_match_reference(iid, seed):
    kw = dict(d_in=8, n_classes=16, seq_len=24, num_clients=16, iid=iid, seed=seed)
    jtask = jsyn.make_frame_task(**kw)
    task = synthetic.make_frame_task(**kw, device="cpu")
    assert _ulp(task.probe().numpy(), np.asarray(jtask.probe())) <= 4
    for client, rnd, step in ((0, 0, 0), (5, 1, 0), (15, 2, 1), (7, 0, 3)):
        want = jtask.batch(client, rnd, step, 4)
        got = task.batch(client, rnd, step, 4)
        assert got["frames"].shape == (4, 24, 8) and got["labels"].dtype == torch.int32
        np.testing.assert_allclose(got["frames"].numpy(), np.asarray(want["frames"]),
                                   rtol=0, atol=4e-6)
        np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))


def test_non_iid_speakers_shift_frames():
    """Non-IID clients add a per-speaker bias: the same (client, round, step)
    differs from the IID draw by one vector per client."""
    iid = synthetic.make_frame_task(d_in=8, n_classes=16, seq_len=24, device="cpu")
    skew = synthetic.make_frame_task(d_in=8, n_classes=16, seq_len=24, iid=False, device="cpu")
    shift = skew.batch(3, 0, 0, 2)["frames"] - iid.batch(3, 0, 0, 2)["frames"]
    torch.testing.assert_close(shift, shift[:1, :1].expand_as(shift), rtol=0, atol=1e-6)
    other = skew.batch(4, 0, 0, 2)["frames"] - iid.batch(4, 0, 0, 2)["frames"]
    assert not torch.allclose(shift[0, 0], other[0, 0])


def test_domains_have_their_own_probe():
    jtask = jsyn.make_frame_task(d_in=8, n_classes=16, domain=1)
    task = synthetic.make_frame_task(d_in=8, n_classes=16, domain=1, device="cpu")
    assert _ulp(task.probe().numpy(), np.asarray(jtask.probe())) <= 4
    assert not torch.allclose(task.probe(0), task.probe(1))
