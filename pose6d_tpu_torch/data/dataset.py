"""Per-(frame, instance) object dataset with its preprocessing and
operator cache (port of pose6d_tpu/data/dataset.py), and the GT
supervision of a frame with a known pose (gt_correspondences,
gt_object).

BOPObjectDataset, per sample:
  1. visibility and obj_take filters over the scene walk (data/bop.py)
  2. mask erosion and depth backprojection (x100 units), on `device`
  3. statistical outlier removal (20 neighbours, 0.3 sigma), on `device`
  4. FPS to max_pc = 2000 points, on `device`
  5. CAD load, QEM decimation to target_faces, x0.1 scale (host)
  6. the GT-aligned cloud (inverse model-to-camera transform)
  7. GT pairs within 0.05 * diameter and overlap masks, on `device`
  8. spectral operators (k_eig 64) of the CAD (per object, shared) and
     of each cloud (host eigsh, or the graph Laplacian + LOBPCG on
     `device`), cached as npz

The cache has the JAX package's file names and npz layouts
(mapping_list.npz, {i}_{j}_obj.npz, {i}_{j}_pc_LBO{_dev}{_grad}.npz,
CAD_LBO_{id}{_grad}.npz and the content-addressed
shared_cad/CAD_LBO_{md5[:16]}_f{faces}_k{k}{_grad}.npz): a cache built
by either package serves the other. The cloud stages use the JAX
package's arithmetic (ops/geometry.pairwise_sqdist_fma), so the points,
FPS picks and GT pairs are the same on the CPU, the card and in JAX; the
operators are not (ARPACK starts from a random vector).

A training or evaluation dataset is any sequence of (cad_ops, pc_ops,
obj) triples, with obj as gt_object (or this dataset) builds it.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
import threading
from pathlib import Path

import numpy as np
import torch

from ..ops import geometry, sampling
from ..ops.geometry import overlap_from_mask, radius_correspondence_mask
from ..runtime import resolve_device
from .bop import BOPSceneDataset
from .decimate import decimate_mesh
from .ply import read_ply

MAX_RAW_POINTS = 32768


class SampleDropped(Exception):
    """Raised by a dataset when a sample fails preprocessing (it is then
    removed from the mapping list); the loader substitutes the next
    sample, as the JAX package's loader does."""


def gt_correspondences(cad_xyz, align_pc, radius: float, device="cpu"):
    """GT pairs within `radius` of CAD points and the GT-aligned cloud,
    on `device`.

    cad_xyz (V1, 3), align_pc (V2, 3) host arrays (compared in f32).
    Returns pairs (N, 2) int64 [cad_idx, pc_idx] in row-major order,
    overlap_12 (V1,) int8, overlap_21 (V2,) int8. Both clouds are padded
    to 512-multiples (as in the JAX package, where a shape is a compile):
    the card sees a few shapes, which its caching allocator reuses.
    """
    def pad(a):
        a = np.asarray(a, np.float32)
        n = len(a)
        out = np.zeros((512 * ((n + 511) // 512), 3), np.float32)
        out[:n] = a
        return (torch.as_tensor(out, device=device),
                torch.arange(len(out), device=device) < n)

    m = radius_correspondence_mask(*pad(cad_xyz), *pad(align_pc),
                                   float(radius))
    m = m[:len(cad_xyz), :len(align_pc)]
    o12, o21 = overlap_from_mask(m)
    return (torch.nonzero(m).cpu().numpy().astype(np.int64),
            o12.cpu().numpy().astype(np.int8),
            o21.cpu().numpy().astype(np.int8))


def gt_object(cad_xyz, pc, R, t, diam: float, obj_id: int,
              visib_fract: float = 1.0, K=None, im_hw=None) -> dict:
    """The obj dict that data.pipeline.make_sample reads, for an observed
    cloud pc (N, 3) in the camera frame and the model-to-camera pose
    (R (3, 3), t (3,), pipeline units), GT pairs at 0.05 * diam."""
    R = np.asarray(R, np.float64).reshape(3, 3)
    t = np.asarray(t, np.float64).reshape(3)
    # GT-aligned cloud in the model frame (dataset.py:318)
    align_pc = (np.asarray(pc, np.float64) - t.reshape(1, 3)) @ R
    pairs, o12, o21 = gt_correspondences(cad_xyz, align_pc, diam * 0.05)
    obj = {
        "visib_fract": visib_fract,
        "R_m2c": R.astype(np.float32),
        "t_m2c": t.astype(np.float32),
        "obj_id": obj_id,
        "pcd_depth": np.asarray(pc, np.float32),
        "scale_cad": 0.1,
        "diam_cad": diam,
        "align_pc": align_pc.astype(np.float32),
        "P": pairs,
        "overlap_12": o12,
        "overlap_21": o21,
    }
    if K is not None:
        obj["K"] = np.asarray(K, np.float32)
    if im_hw is not None:
        obj["im_hw"] = np.asarray(im_hw, np.int32)
    return obj


def _save_npz(path: Path, **arrays) -> None:
    """np.savez to a private name, then renamed into place: parallel
    cache writers never read a half-written file."""
    tmp = path.with_name(f"{path.stem}.{os.getpid()}."
                         f"{threading.get_ident()}.tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _load_npz(path: Path) -> dict:
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


class BOPObjectDataset:
    def __init__(self, data_root, render_data_name, mode: str = "train_pbr",
                 min_vis: float = 0.3, cache_dir=None, lbo_pc: bool = True,
                 obj_take=(), num_samples: int = -1, k_eig: int = 64,
                 max_pc: int = 2000, target_faces: int = 10000,
                 models_dir: str = "models",
                 pc_lbo_backend: str = "host",
                 build_gradients: bool = False, device="cuda"):
        """pc_lbo_backend: 'host' = scipy eigsh over the local-
        triangulation Laplacian (the reference protocol); 'device' = the
        graph Laplacian + LOBPCG on `device` (spectral/device_lbo.py, the
        operator family of the online Predictor).

        build_gradients: also build and cache the gather-form tangent-
        gradient operators of both shapes (the with_gradient_features
        model). Host pc_lbo_backend only.

        device: where the cloud preprocessing, the GT radius mask and
        the 'device' LBO backend run (default cuda; raises when CUDA is
        missing unless "cpu" is asked for)."""
        if build_gradients and pc_lbo_backend != "host":
            raise ValueError("build_gradients requires the host "
                             "pc_lbo_backend (tangent frames come from "
                             "the host operator build)")
        self.device = resolve_device(device)
        self.scenes = BOPSceneDataset(data_root, render_data_name, mode,
                                      num_samples=num_samples,
                                      cache_dir=cache_dir)
        self.data_root = Path(data_root)
        self.render_data_name = str(render_data_name)
        self.min_vis = min_vis
        self.lbo_pc = lbo_pc
        self.obj_take = list(obj_take)
        self.k_eig = k_eig
        self.max_pc = max_pc
        self.target_faces = target_faces
        self.models_dir = models_dir
        self.pc_lbo_backend = pc_lbo_backend
        self.build_gradients = build_gradients
        self.cache_dir = None
        self.cache_root = None
        if cache_dir is not None:
            self.cache_root = Path(cache_dir)
            self.cache_dir = Path(cache_dir) / self.render_data_name / mode
            self.cache_dir.mkdir(parents=True, exist_ok=True)
        self._cad_hash = {}
        # in-memory memo of the CAD operators: the loader's threads ask
        # for them once per sample, for a handful of objects (benign if
        # racy: every writer stores the same dict)
        self._cad_mem = {}
        self._models_info = None
        self._collect_obj_data()

    # ------------------------------------------------------------------
    @property
    def models_info(self):
        if self._models_info is None:
            p = (self.data_root / self.render_data_name / self.models_dir /
                 "models_info.json")
            self._models_info = json.loads(p.read_text())
        return self._models_info

    def _collect_obj_data(self):
        cache_file = (self.cache_dir / "mapping_list.npz"
                      if self.cache_dir else None)
        if cache_file is not None and cache_file.exists():
            self.mapping_list = [tuple(int(v) for v in x) for x in
                                 _load_npz(cache_file)["mapping_list"]]
            # the cached mapping covers the full scene walk; keep the
            # num_samples-truncated view (data/bop.py)
            n = len(self.scenes)
            self.mapping_list = [m for m in self.mapping_list if m[0] < n]
            return
        self.mapping_list = []
        for i in range(len(self.scenes)):
            frame = self.scenes[i]
            infos = frame["scene_info"]
            gts = frame["scene_gt"]
            for j, info in enumerate(infos):
                if info["visib_fract"] < self.min_vis:
                    continue
                if gts is not None and self.obj_take:
                    if gts[j]["obj_id"] not in self.obj_take:
                        continue
                self.mapping_list.append((i, j))
        # persist only full walks (see data/bop.py)
        if cache_file is not None and self.scenes.num_samples <= 0:
            _save_npz(cache_file,
                      mapping_list=np.asarray(self.mapping_list, np.int64))

    def __len__(self):
        return len(self.mapping_list)

    # ------------------------------------------------------------------
    def _preprocess_cloud(self, depth, K, depth_scale, seg_mask):
        """Backproject, clean and FPS on the device; returns pc (N, 3)
        float32 on the host."""
        # the buffer is the smallest power-of-two bucket (>= 4096) that
        # holds the frame's masked pixels (erosion only shrinks the mask):
        # typical frames carry 3-10k points, so the outlier kNN and FPS
        # walk 3-8x fewer points than at MAX_RAW_POINTS
        n_mask = int(np.count_nonzero(np.asarray(seg_mask)))
        bucket = max(4096, 1 << max(n_mask - 1, 1).bit_length())
        bucket = min(bucket, MAX_RAW_POINTS)
        dev = self.device
        pts, valid = geometry.backproject_depth(
            torch.as_tensor(np.asarray(depth, np.float32), device=dev)[None],
            torch.as_tensor(np.asarray(K, np.float32), device=dev)[None],
            1000.0 / depth_scale,
            torch.as_tensor(np.asarray(seg_mask, bool), device=dev)[None],
            max_points=bucket)
        keep = geometry.statistical_outlier_mask(pts, valid)
        if int(keep.sum()) > self.max_pc:
            idx, sel_valid = sampling.farthest_point_sample(pts, keep,
                                                            self.max_pc)
            pc = pts[0][idx[0]][sel_valid[0]]
        else:
            pc = pts[0][keep[0]]
        return pc.cpu().numpy().astype(np.float32)

    def cad_operators(self, obj_id: int):
        """Decimated CAD mesh and its spectral operators, cached per
        object.

        The cache is content-addressed (md5 of the ply file and the build
        knobs) and shared across datasets under <cache_root>/shared_cad:
        corpora rendered from one CAD bank reuse one eigsh build. A
        per-dataset CAD_LBO_<id>.npz is still read where it exists.
        """
        if obj_id in self._cad_mem:
            return self._cad_mem[obj_id]
        gsuf = "_grad" if self.build_gradients else ""
        cad_path = (self.data_root / self.render_data_name / self.models_dir
                    / f"obj_{obj_id:06d}.ply")
        cache_file = (self.cache_dir / f"CAD_LBO_{obj_id}{gsuf}.npz"
                      if self.cache_dir else None)
        if cache_file is not None and cache_file.exists():
            out = _load_npz(cache_file)
            self._cad_mem[obj_id] = out
            return out
        shared_file = None
        if self.cache_root is not None:
            if obj_id not in self._cad_hash:
                self._cad_hash[obj_id] = hashlib.md5(
                    cad_path.read_bytes()).hexdigest()[:16]
            shared_dir = self.cache_root / "shared_cad"
            shared_file = shared_dir / (
                f"CAD_LBO_{self._cad_hash[obj_id]}_f{self.target_faces}"
                f"_k{self.k_eig}{gsuf}.npz")
            if shared_file.exists():
                out = _load_npz(shared_file)
                self._cad_mem[obj_id] = out
                return out
            shared_dir.mkdir(parents=True, exist_ok=True)
        from ..spectral.operators import mesh_operators
        mesh = read_ply(cad_path)
        verts, faces = decimate_mesh(mesh["verts"], mesh["faces"],
                                     self.target_faces)
        verts = verts * 0.1  # the reference's scale_cad
        so = mesh_operators(verts, faces, k_eig=self.k_eig,
                            build_gradients=self.build_gradients)
        out = {
            "xyz": so["xyz"], "faces": so["faces"].astype(np.int32),
            "norm": so["normals"], "frames": so["frames"],
            "mass": so["mass"], "evals": so["evals"], "evecs": so["evecs"],
        }
        if self.build_gradients:
            out.update(grad_idx=so["grad_idx"], grad_cx=so["grad_cx"],
                       grad_cy=so["grad_cy"])
        if shared_file is not None:
            _save_npz(shared_file, **out)
        elif cache_file is not None:
            _save_npz(cache_file, **out)
        self._cad_mem[obj_id] = out
        return out

    def pc_operators(self, i: int, j: int, pc: np.ndarray):
        suffix = "_dev" if self.pc_lbo_backend == "device" else ""
        if self.build_gradients:
            suffix += "_grad"
        cache_file = (self.cache_dir / f"{i}_{j}_pc_LBO{suffix}.npz"
                      if self.cache_dir else None)
        if cache_file is not None and cache_file.exists():
            return _load_npz(cache_file)
        if self.pc_lbo_backend == "device":
            from ..spectral.device_lbo import device_pc_operators
            v = len(pc)
            vpad = 256 * ((self.max_pc + 255) // 256)  # one shape
            pts = np.zeros((vpad, 3), np.float32)
            pts[:v] = pc
            with torch.inference_mode():
                mass, evals, evecs = device_pc_operators(
                    torch.as_tensor(pts, device=self.device)[None],
                    (torch.arange(vpad, device=self.device) < v)[None],
                    k_eig=self.k_eig)
            out = {
                "xyz": pc.astype(np.float32),
                "frames": np.zeros((v, 3, 3), np.float32),
                "mass": mass[0, :v].cpu().numpy(),
                "evals": evals[0].cpu().numpy(),
                "evecs": evecs[0, :v].cpu().numpy(),
            }
        else:
            from ..spectral.operators import point_cloud_operators
            so = point_cloud_operators(
                pc, k_eig=self.k_eig, build_gradients=self.build_gradients)
            out = {k: so[k] for k in ("xyz", "frames", "mass", "evals",
                                      "evecs")}
            if self.build_gradients:
                out.update(grad_idx=so["grad_idx"], grad_cx=so["grad_cx"],
                           grad_cy=so["grad_cy"])
        if cache_file is not None:
            _save_npz(cache_file, **out)
        return out

    # ------------------------------------------------------------------
    def __getitem__(self, index):
        i, j = self.mapping_list[index]
        obj_file = (self.cache_dir / f"{i}_{j}_obj.npz"
                    if self.cache_dir else None)
        if obj_file is not None and obj_file.exists():
            obj = _load_npz(obj_file)
            obj_id = int(obj["obj_id"])
        else:
            frame = self.scenes[i]
            gt = frame["scene_gt"][j] if frame["scene_gt"] else None
            if gt is None:
                raise ValueError(
                    f"frame {i} has no scene_gt.json; GT-dependent sample "
                    "generation needs poses")
            obj_id = gt["obj_id"]
            seg_mask = frame["seg"][j] == 255
            K = np.asarray(frame["camera"]["cam_K"],
                           np.float64).reshape(3, 3)
            with torch.inference_mode():
                pc = self._preprocess_cloud(frame["depth"], K,
                                            frame["camera"]["depth_scale"],
                                            seg_mask)
            R = np.asarray(gt["cam_R_m2c"], np.float64).reshape(3, 3)
            t = np.asarray(gt["cam_t_m2c"], np.float64) * 0.1
            diam = self.models_info[str(obj_id)]["diameter"] * 0.1
            cad = self.cad_operators(obj_id)
            # the GT-aligned cloud in the model frame
            align_pc = (pc - t.reshape(1, 3)) @ R
            with torch.inference_mode():
                pairs, o12, o21 = gt_correspondences(
                    cad["xyz"], align_pc, diam * 0.05, device=self.device)
            obj = {
                "visib_fract": frame["scene_info"][j]["visib_fract"],
                "R_m2c": R.astype(np.float32),
                "t_m2c": t.astype(np.float32),
                "obj_id": obj_id,
                # intrinsics and image size: the pose stage's depth-render
                # flip disambiguation reads them
                "K": K.astype(np.float32),
                "im_hw": np.asarray(frame["depth"].shape, np.int32),
                "pcd_depth": pc,
                "scale_cad": 0.1,
                "diam_cad": diam,
                "align_pc": align_pc.astype(np.float32),
                "P": pairs,
                "overlap_12": o12,
                "overlap_21": o21,
            }
            if obj_file is not None:
                _save_npz(obj_file, **obj)
        cad = self.cad_operators(obj_id)
        pc_ops = None
        if self.lbo_pc:
            try:
                pc_ops = self.pc_operators(i, j, np.asarray(obj["pcd_depth"],
                                                            np.float32))
            except Exception as e:
                # self-heal as the reference does: drop the sample from the
                # mapping list, persist it, and let the loader substitute
                print(f"sample ({i},{j}) dropped: {e!r}", file=sys.stderr)
                self.mapping_list = [m for m in self.mapping_list
                                     if tuple(m) != (i, j)]
                if self.cache_dir is not None:
                    _save_npz(self.cache_dir / "mapping_list.npz",
                              mapping_list=np.asarray(self.mapping_list,
                                                      np.int64))
                raise SampleDropped(f"sample ({i},{j}): {e!r}") from e
        return cad, pc_ops, obj


def dataset_from_config(cfg, block, device="cuda") -> BOPObjectDataset:
    """The BOPObjectDataset of one dataset block (config.DatasetConfig)
    of the Config `cfg`, preprocessing on `device`."""
    return BOPObjectDataset(
        cfg.data_root, block.render_data_name, mode=block.mode,
        min_vis=block.min_vis, cache_dir=cfg.cache_dir, lbo_pc=block.lbo_pc,
        obj_take=block.obj_take, num_samples=block.num_samples,
        models_dir=block.models_dir, target_faces=cfg.target_faces,
        pc_lbo_backend=block.pc_lbo_backend,
        build_gradients=(block.build_gradients
                         or cfg.model.with_gradient_features),
        device=device)
