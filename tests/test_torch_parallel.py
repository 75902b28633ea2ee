"""The port's parallel/ (torch.distributed) against the JAX package's on
the CPU: the frame partition and the metric all-reduce, the data-parallel
train step over two gloo processes against JAX's make_parallel_train_step
over a 2-device mesh, the sharded forward, train() over two spawned
workers against one device, and evaluate() over two processes against
one. Every spawned process has its own time limit."""
import dataclasses
import json
import os
import pickle
import socket
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import pose6d_tpu.models.attention as jax_attention
from pose6d_tpu.models import DPFMConfig as JaxConfig
from pose6d_tpu.parallel import mesh as jax_mesh
from pose6d_tpu.parallel import multihost as jax_multihost
from pose6d_tpu.train import augment as jax_augment
from pose6d_tpu.train import loss as jax_loss
from pose6d_tpu.train.train_step import make_train_step
from pose6d_tpu_torch.config import Config
from pose6d_tpu_torch.models import DPFMNet, init_like_flax
from pose6d_tpu_torch.models.weights import state_dict_from_flax
from pose6d_tpu_torch.parallel import allreduce_metric_sums, shard_frame_list
from pose6d_tpu_torch.train.checkpoint import save_params
from pose6d_tpu_torch.train.eval_loop import evaluate
from pose6d_tpu_torch.train.loop import train
from tests.test_torch_train import (ANGLE, LOSS_CFG, TRANS, _flat,
                                    _torch_batch, jax_draws)
from tests.test_train import make_batch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PROC_TIMEOUT = 120      # seconds, each spawned process

WORKER = r"""
import pickle, sys
import numpy as np
import torch
torch.set_num_threads(2)
from pose6d_tpu_torch.parallel import (init_multihost, shard_frame_list,
                                       allreduce_metric_sums)
mode, addr, rank, tmp = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
init_multihost(addr, num_processes=2, process_id=rank, backend="gloo")
import torch.distributed as dist
assert dist.get_world_size() == 2 and dist.get_rank() == rank
out = {}
if mode == "contract":
    idx = shard_frame_list(10)
    local = np.zeros(3, np.float64)
    local[0] = len(idx)            # frame count
    local[1] = float(idx.sum())    # shard content checksum
    local[2] = rank
    out["agg"] = allreduce_metric_sums({"v": local})["v"]
    out["idx"] = idx
    # a bare "cuda" is this rank's card: rank % visible cards
    from pose6d_tpu_torch import runtime
    torch.cuda.is_available = lambda: True
    torch.cuda.set_device = lambda d: None
    for n in (1, 2):
        torch.cuda.device_count = lambda: n
        out[f"cuda_{n}"] = str(runtime.resolve_device("cuda"))
    out["cuda_index"] = str(runtime.resolve_device("cuda:0"))
elif mode == "step":
    from pose6d_tpu_torch.models import DPFMNet
    from pose6d_tpu_torch.parallel import (make_mesh, make_parallel_forward,
                                           make_parallel_train_step,
                                           replicate, shard_batch)
    from pose6d_tpu_torch.train.loss import DPFMLossConfig
    from pose6d_tpu_torch.train.train_step import TrainStep
    d = torch.load(tmp + "/step_in.pt", weights_only=False)
    model = DPFMNet()
    model.load_state_dict(d["state_dict"])
    mesh = make_mesh(2, device="cpu")
    replicate(model, mesh)
    fwd = make_parallel_forward(lambda b: model(b["cad"], b["pc"]), mesh)
    with torch.no_grad():
        out["forward_C"] = fwd(d["batch"])["C"].numpy()
    ts = TrainStep(model, DPFMLossConfig(nce_num_pairs=32),
                   augment_angle=d["angle"], augment_trans=d["trans"])
    update = ts.apply_update
    def apply_update(grads, step):      # the averaged gradient, unclipped
        out["grads"] = {n: g.clone().numpy() for n, g in
                        zip(dict(model.named_parameters()), grads)}
        return update(grads, step)
    ts.apply_update = apply_update
    logs = make_parallel_train_step(ts, mesh)(shard_batch(d["batch"], mesh),
                                              0, d["draws"])
    out["logs"] = {k: float(v) for k, v in logs.items() if k != "_C"}
    out["C_rows"] = logs["_C"].numpy()
    out["params"] = {n: p.detach().numpy().copy()
                     for n, p in model.named_parameters()}
elif mode == "eval":
    from pose6d_tpu_torch.train.eval_loop import evaluate
    d = pickle.load(open(tmp + "/eval_in.pkl", "rb"))
    out["ir"] = evaluate(d["cfg"], d["params"], dataset=d["dataset"],
                         save_dir=tmp + "/eval_2proc", device="cpu")
pickle.dump(out, open(f"{tmp}/{mode}_{rank}.pkl", "wb"))
dist.destroy_process_group()
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(argv_of_rank, n: int = 2) -> list:
    """n processes (argv_of_rank(rank) each, from the repo root, 2
    threads); their stdout, after all exit 0."""
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "2"}
    procs = [subprocess.Popen(argv_of_rank(r), cwd=ROOT, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PROC_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    return outs


def run_workers(mode: str, tmp: Path) -> list:
    addr = f"localhost:{free_port()}"
    run_ranks(lambda r: [sys.executable, "-c", WORKER, mode, addr, str(r),
                         str(tmp)])
    return [pickle.load(open(tmp / f"{mode}_{r}.pkl", "rb"))
            for r in range(2)]


# -- multihost --------------------------------------------------------------

@pytest.mark.parametrize("n,world", [(10, 2), (103, 4), (7, 3), (5, 8),
                                     (0, 2)])
def test_shard_frame_list_matches_jax(n, world):
    parts = [shard_frame_list(n, process_index=r, process_count=world)
             for r in range(world)]
    for r, part in enumerate(parts):
        np.testing.assert_array_equal(part, jax_multihost.shard_frame_list(
            n, process_index=r, process_count=world))
    assert sorted(np.concatenate(parts).tolist()) == list(range(n))
    # without a group: the whole list
    np.testing.assert_array_equal(shard_frame_list(n), np.arange(n))


def test_world1_allreduce_is_identity():
    local = {"ir_sum": np.linspace(0, 1, 7), "count": np.arange(7.0)}
    out = allreduce_metric_sums(local)
    ref = jax_multihost.allreduce_metric_sums(local)
    for k, v in local.items():
        assert out[k].dtype == np.float64 == ref[k].dtype
        np.testing.assert_array_equal(out[k], v)
        np.testing.assert_array_equal(out[k], ref[k])


def test_two_process_shard_and_allreduce(tmp_path):
    """tests/test_multihost.py's contract over two gloo processes, with
    JAX's float32 result; and a bare "cuda" names the rank's card."""
    outs = run_workers("contract", tmp_path)
    for r, out in enumerate(outs):
        assert out["agg"].dtype == np.float32
        np.testing.assert_array_equal(out["agg"], [10, 45, 1])
        np.testing.assert_array_equal(out["idx"], np.arange(r, 10, 2))
        assert out["cuda_1"] == "cuda:0" and out["cuda_2"] == f"cuda:{r}"
        assert out["cuda_index"] == "cuda:0"


# -- the data-parallel step and forward -------------------------------------

@pytest.fixture(scope="module")
def parallel_step(tmp_path_factory):
    """One step of JAX's make_parallel_train_step over make_mesh(2) on a
    batch of 4, and the port's over two gloo processes (2 rows each) on
    the same params, batch and global draws; plus the sharded forward."""
    tmp = tmp_path_factory.mktemp("parallel_step")
    with pytest.MonkeyPatch.context() as mp:
        # JAX's attention in f32 (its bf16 casts), as the one-device
        # step test runs it
        proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                         if not k.startswith("__")})
        proxy.bfloat16 = jnp.float32
        mp.setattr(jax_attention, "jnp", proxy)
        batch = make_batch(np.random.default_rng(0), B=4)
        init_fn, step_fn, fwd_batch = make_train_step(
            JaxConfig(), LOSS_CFG, augment_angle=ANGLE, augment_trans=TRANS)
        state = init_fn(jax.random.PRNGKey(0), batch)
        key = jax.random.PRNGKey(10)
        kaug, kloss = jax.random.split(key)
        aug = jax_augment.augment_pc_batch(kaug, batch, ANGLE, TRANS)
        (_, _), ref_grads = jax.value_and_grad(
            lambda p: jax_loss.dpfm_loss(kloss, fwd_batch(p, aug), aug,
                                         LOSS_CFG), has_aux=True)(
            state.params)
        mesh = jax_mesh.make_mesh(2)
        pstep = jax_mesh.make_parallel_train_step(step_fn, mesh)
        state1, logs = pstep(jax_mesh.replicate(state, mesh),
                             jax_mesh.shard_batch(batch, mesh), key)
        ref = {"grads": _flat(jax.device_get(ref_grads)["params"]),
               "logs": {k: float(v) for k, v in logs.items() if k != "_C"},
               "params": _flat(jax.device_get(state1.params)["params"])}
    sd = state_dict_from_flax(jax.device_get(state.params)["params"])
    torch.save({"state_dict": sd, "batch": _torch_batch(batch),
                "draws": jax_draws(key, 4, 64), "angle": ANGLE,
                "trans": TRANS}, tmp / "step_in.pt")
    model = DPFMNet()
    model.load_state_dict(sd)
    tb = _torch_batch(batch)
    with torch.no_grad():
        single_C = model(tb["cad"], tb["pc"])["C"].numpy()
    return ref, run_workers("step", tmp), single_C


def _by_flax_name(named: dict) -> dict:
    from pose6d_tpu_torch.models.weights import flax_from_state_dict
    return _flat(flax_from_state_dict({k: torch.as_tensor(v)
                                       for k, v in named.items()}))


def test_parallel_step_matches_jax_mesh(parallel_step):
    """Step 1: the all-reduced gradient against JAX's global-batch
    gradient (tests/test_torch_train.py's bounds), the logged loss terms
    and grad_norm to 1e-4, both replicas bit for bit equal after the
    update, and the update against JAX's mesh step where the gradient
    is clear of rounding (as tests/test_torch_train.py holds it)."""
    ref, outs, _ = parallel_step
    for k in ("loss", "fmap_loss", "acc_loss", "nce_loss", "grad_norm"):
        for out in outs:
            np.testing.assert_allclose(out["logs"][k], ref["logs"][k],
                                       rtol=1e-4, err_msg=k)
    grads = _by_flax_name(outs[0]["grads"])
    assert grads.keys() == ref["grads"].keys() and len(grads) == 38
    gmax = max(np.abs(r).max() for r in ref["grads"].values())
    for name, g in grads.items():
        r = ref["grads"][name]
        np.testing.assert_allclose(
            g, r, rtol=0, atol=1e-3 * np.abs(r).max() + 2e-6 * gmax,
            err_msg=name)
    for name, p in outs[0]["params"].items():
        np.testing.assert_array_equal(p, outs[1]["params"][name],
                                      err_msg=name)
    params = _by_flax_name(outs[0]["params"])
    for name, p in params.items():
        g = ref["grads"][name]
        clear = np.abs(g) > 1e-2 * np.abs(g).max()
        np.testing.assert_allclose(p[clear], ref["params"][name][clear],
                                   rtol=0, atol=2e-2, err_msg=name)
    # each rank's C is its own rows of the batch
    assert [o["C_rows"].shape[0] for o in outs] == [2, 2]


def test_parallel_forward_matches_single(parallel_step):
    _, outs, single_C = parallel_step
    for out in outs:
        assert out["forward_C"].shape == single_C.shape
        np.testing.assert_allclose(out["forward_C"], single_C, atol=5e-4)


# -- train() over spawned workers ---------------------------------------------

def _train_cfg(logdir, batch_size=8):
    cfg = Config()
    cfg.logging_dir = str(logdir)
    cfg.train.batch_size = batch_size
    cfg.train.epochs = 2
    cfg.train.num_threads = 2
    cfg.train.seed = 0
    cfg.train.log_ir = True
    cfg.loss = dataclasses.replace(cfg.loss, nce_num_pairs=32)
    return cfg


_KW = {"v_cad": 128, "v_pc": 64, "nce_pairs": 32}


def _losses(logdir):
    (run,) = Path(logdir).iterdir()
    rows = [json.loads(line) for line in
            (run / "metrics.jsonl").read_text().splitlines()]
    return [r["loss"] for r in rows if "step" in r], run


def test_train_two_workers_matches_one_device(tmp_path, capfd):
    """train(n_devices=2) on the CPU against n_devices=1: JAX's
    TestDataParallelTrainLoop bounds, one run directory, the
    data-parallel line printed."""
    ds = ge._RawSynthDataset(8, vc=96, vp=48)
    s1 = train(_train_cfg(tmp_path / "single"), dataset=ds, max_steps=2,
               sample_kw=_KW, device="cpu", n_devices=1)
    s2 = train(_train_cfg(tmp_path / "mesh"), dataset=ds, max_steps=2,
               sample_kw=_KW, device="cpu", n_devices=2)
    assert "train: data-parallel over 2 devices (4 frames/device)" in \
        capfd.readouterr().out
    assert s1.step == s2.step == 2
    (l1, _), (l2, run) = _losses(tmp_path / "single"), _losses(
        tmp_path / "mesh")
    assert len(l1) == len(l2) == 2
    np.testing.assert_allclose(l2[0], l1[0], rtol=1e-4)
    np.testing.assert_allclose(l2[1], l1[1], rtol=0.05)
    assert {p.name for p in run.iterdir()} == {
        "ckpt", "metrics.jsonl", "params_latest.msgpack"}
    d = max(float((a - b).abs().max()) for a, b in zip(
        s1.model.state_dict().values(), s2.model.state_dict().values()))
    assert d < 0.05
    # the returned state is the final checkpoint's, optimizer included
    assert all(float(v["step"]) == 2.0
               for v in s2.optimizer.state_dict()["state"].values())


def test_train_indivisible_batch_takes_one_device(tmp_path, capfd):
    ds = ge._RawSynthDataset(3, vc=96, vp=48)
    s = train(_train_cfg(tmp_path, batch_size=3), dataset=ds, max_steps=1,
              sample_kw=_KW, device="cpu", n_devices=2)
    assert s.step == 1
    assert "data-parallel" not in capfd.readouterr().out


# -- evaluate() over two processes ------------------------------------------

def test_two_process_evaluate_matches_one(tmp_path):
    """Five frames of two objects (shards of 3 and 2): the union of the
    ranks' result files has the one-process run's names (global frame
    indices), each file bit for bit at eval.batch_size=1; mean and
    per-object IR within the float32 rounding of the sums."""
    ds = ge._RawSynthDataset(5, vc=96, vp=48)
    for i, (_, _, obj) in enumerate(ds.items):
        obj["obj_id"] = 1 + i % 2
    cfg = Config()
    cfg.pad_v_cad, cfg.pad_v_pc = 128, 64
    cfg.eval.batch_size = 1
    params = tmp_path / "params.msgpack"
    save_params(params, init_like_flax(DPFMNet(),
                                       torch.Generator().manual_seed(0)))
    with open(tmp_path / "eval_in.pkl", "wb") as f:
        pickle.dump({"cfg": cfg, "params": str(params),
                     "dataset": list(ds.items)}, f)
    ir1, obj1 = evaluate(cfg, str(params), dataset=ds,
                         save_dir=tmp_path / "eval_1proc", device="cpu")
    outs = run_workers("eval", tmp_path)
    one = sorted(p.name for p in (tmp_path / "eval_1proc").iterdir())
    two = sorted(p.name for p in (tmp_path / "eval_2proc").iterdir())
    assert one == two == [f"result_{i:06d}.npz" for i in range(5)]
    for name in one:
        a = np.load(tmp_path / "eval_1proc" / name)
        b = np.load(tmp_path / "eval_2proc" / name)
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"{name} {k}")
    for out in outs:
        ir2, obj2 = out["ir"]
        assert sorted(obj2) == sorted(obj1) == [1, 2]
        np.testing.assert_allclose(ir2, ir1, rtol=4e-7, atol=1e-7)
        for k in obj1:
            np.testing.assert_allclose(obj2[k], obj1[k], rtol=4e-7,
                                       atol=1e-7)
