"""Training repeats bit for bit: two CPU train() runs of one seed on one
dataset give the same losses and parameters, and the NCE's row gather
(whose backward on the card sums repeated rows with index_put_'s
fixed-order accumulation) has torch.gather's value and gradient."""
import numpy as np
import torch

from pose6d_tpu_torch.models.weights import read_flax_msgpack
from pose6d_tpu_torch.train import loss
from pose6d_tpu_torch.train.loop import train

from test_torch_train import _KW, _cfg, _records

torch.set_num_threads(2)


def test_two_train_runs_are_bit_equal(tmp_path):
    import __graft_entry__ as ge
    ds = ge._RawSynthDataset(8, vc=96, vp=48)
    runs = []
    for name in ("a", "b"):
        train(_cfg(tmp_path / name, augment_rotation_deg=30.0), dataset=ds,
              max_steps=4, sample_kw=_KW, device="cpu")
        (run,) = (tmp_path / name).iterdir()
        runs.append(run)
    la, lb = ([r["loss"] for r in _records(run) if "step" in r]
              for run in runs)
    assert len(la) == 4 and la == lb
    assert (runs[0] / "params_latest.msgpack").read_bytes() == \
        (runs[1] / "params_latest.msgpack").read_bytes()
    assert read_flax_msgpack(runs[0] / "params_latest.msgpack")["params"]


def test_gather_rows_backward_sums_repeated_rows():
    """The card's gather (run here through the same autograd Function on
    CPU tensors) against torch.gather: the same rows, and gradients
    within f32 summation order of repeated rows (exact where a row is
    taken once)."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(2, 40, 8)).astype(np.float32))
    idx = torch.as_tensor(rng.integers(0, 40, size=(2, 100)))
    g = torch.as_tensor(rng.normal(size=(2, 100, 8)).astype(np.float32))
    xa = x.clone().requires_grad_()
    xb = x.clone().requires_grad_()
    ya = loss._GatherRows.apply(xa, idx)
    yb = torch.gather(xb, 1, idx[..., None].expand(-1, -1, 8))
    assert torch.equal(ya, yb)
    ya.backward(g)
    yb.backward(g)
    np.testing.assert_allclose(xa.grad.numpy(), xb.grad.numpy(), rtol=1e-6,
                               atol=1e-6)
    counts = np.stack([np.bincount(i, minlength=40) for i in idx.numpy()])
    once = torch.as_tensor(counts <= 1)
    assert torch.equal(xa.grad[once], xb.grad[once])
    assert torch.equal(loss.gather_rows(x, idx), yb.detach())
