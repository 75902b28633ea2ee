"""Static-shape collation and host loading (port of
pose6d_tpu/data/pipeline.py).

make_sample pads one (CAD, PC, obj) triple to fixed shapes: CAD to
V_CAD (5120), the partial cloud to V_PC (2048), masks explicit, with
the gather-form gradient operators where the shapes carry them; the
ragged GT pair list becomes (a) the 30x30 normal equations of the C_gt
least-squares solve and (b) a fixed buffer of at most NCE_PAIRS pairs
for the NCE loss. collate stacks samples (numpy, leading B);
HostLoader shuffles and prefetches on threads, with one numpy
Generator per (seed, epoch, index). to_device turns a collated batch
into tensors on a device.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from ..ops.masking import K_EIG, N_FMAP, V_CAD, V_PC, pad_to

NCE_PAIRS = 4096  # max GT pairs carried per sample for the NCE loss


def make_sample(cad: dict, pc: dict, obj: dict, rng=None,
                v_cad: int = V_CAD, v_pc: int = V_PC,
                n_fmap: int = N_FMAP, nce_pairs: int = NCE_PAIRS) -> dict:
    """One (CAD, PC, obj) triple -> dict of fixed-shape numpy arrays."""
    rng = rng or np.random.default_rng(0)
    nc = len(cad["xyz"])
    npc = len(pc["xyz"])
    pairs = np.asarray(obj["P"], np.int64).reshape(-1, 2)

    # C_gt normal equations from the full pair set:
    # min_C || Phi2[P[:,1]] C - Phi1[P[:,0]] ||  ->  (A) C = (B)
    p2 = cad["evecs"][:, :n_fmap][pairs[:, 0]] if len(pairs) else \
        np.zeros((0, n_fmap), np.float32)
    p1 = pc["evecs"][:, :n_fmap][pairs[:, 1]] if len(pairs) else \
        np.zeros((0, n_fmap), np.float32)
    A = p1.T @ p1  # Phi2^p^T Phi2^p  (PC side is "shape 2")
    B = p1.T @ p2  # Phi2^p^T Phi1^p

    # NCE pair subsample, without replacement
    if len(pairs) > nce_pairs:
        sel = rng.choice(len(pairs), nce_pairs, replace=False)
        sub = pairs[sel]
    else:
        sub = pairs
    pair_buf = np.zeros((nce_pairs, 2), np.int32)
    pair_buf[:len(sub)] = sub
    pair_valid = np.zeros(nce_pairs, bool)
    pair_valid[:len(sub)] = True

    def shape_block(ops, v_max, n_valid):
        block = {
            "xyz": pad_to(ops["xyz"], v_max).astype(np.float32),
            "mass": pad_to(ops["mass"], v_max).astype(np.float32),
            "evals": np.asarray(ops["evals"], np.float32)[:K_EIG],
            "evecs": pad_to(ops["evecs"], v_max).astype(np.float32),
            "valid": np.arange(v_max) < n_valid,
        }
        # optional gather-form tangent-gradient operators (the gradient-
        # feature model); padded rows gather row 0 with zero coefficients
        if "grad_idx" in ops:
            block["grad_idx"] = pad_to(
                np.asarray(ops["grad_idx"]), v_max).astype(np.int32)
            block["grad_cx"] = pad_to(
                np.asarray(ops["grad_cx"]), v_max).astype(np.float32)
            block["grad_cy"] = pad_to(
                np.asarray(ops["grad_cy"]), v_max).astype(np.float32)
        return block

    return {
        "cad": shape_block(cad, v_cad, nc),
        "pc": shape_block(pc, v_pc, npc),
        "pairs": pair_buf,
        "pairs_valid": pair_valid,
        "cgt_A": A.astype(np.float32),
        "cgt_B": B.astype(np.float32),
        "overlap12": pad_to(np.asarray(obj["overlap_12"], np.float32), v_cad),
        "overlap21": pad_to(np.asarray(obj["overlap_21"], np.float32), v_pc),
        "align_pc": pad_to(np.asarray(obj["align_pc"], np.float32), v_pc),
        "R_m2c": np.asarray(obj["R_m2c"], np.float32),
        "t_m2c": np.asarray(obj["t_m2c"], np.float32),
        # zeros when the obj carries no intrinsics
        "K": (np.asarray(obj["K"], np.float32) if "K" in obj
              else np.zeros((3, 3), np.float32)),
        "im_hw": (np.asarray(obj["im_hw"], np.int32) if "im_hw" in obj
                  else np.asarray([480, 640], np.int32)),
        "diam_cad": np.float32(obj["diam_cad"]),
        "obj_id": np.int32(obj["obj_id"]),
        "visib_fract": np.float32(obj["visib_fract"]),
    }


def collate(samples: list[dict]) -> dict:
    """Stack fixed-shape samples into a batch (leading axis B)."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: collate([s[k] for s in samples]) for k in first}
    return np.stack(samples)


def to_device(batch: dict, device) -> dict:
    """A collated numpy batch -> tensors on `device` (same dtypes)."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    return torch.as_tensor(batch).to(device, non_blocking=True)


class HostLoader:
    """Shuffling, thread-prefetching loader over a (cad, pc, obj)
    dataset."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True,
                 num_threads: int = 4, prefetch: int = 2, **sample_kw):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.sample_kw = sample_kw
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        epoch = self.epoch
        self.epoch += 1
        rng = np.random.default_rng(self.seed + epoch)
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng.shuffle(order)
        batches = [order[b * self.batch_size:(b + 1) * self.batch_size]
                   for b in range(len(self))]

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def sample_one(idx):
            from .dataset import SampleDropped
            # per-sample Generator: deterministic given (seed, epoch,
            # index) whatever the thread interleaving
            rng_i = np.random.default_rng((self.seed, epoch, int(idx)))
            for _ in range(8):
                try:
                    cad, pc, obj = self.dataset[int(idx)]
                    return make_sample(cad, pc, obj, rng=rng_i,
                                       **self.sample_kw)
                except SampleDropped:
                    idx = (int(idx) + 1) % max(len(self.dataset), 1)
            raise RuntimeError("too many dropped samples in a row")

        def producer():
            from concurrent.futures import ThreadPoolExecutor
            try:
                with ThreadPoolExecutor(
                        max_workers=self.num_threads) as pool:
                    for idxs in batches:
                        if stop.is_set():
                            return
                        q.put(collate(list(pool.map(sample_one, idxs))))
            except BaseException as e:  # surface in the consumer
                q.put(e)
            finally:
                q.put(None)

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while th.is_alive():   # unblock a producer on a full queue
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
