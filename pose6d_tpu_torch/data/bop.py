"""BOP dataset walking and per-frame loading on the host (port of
pose6d_tpu/data/bop.py).

Walks <data_root>/<name>/<mode>/*/depth/*.png, resolves the sibling
scene_camera.json / scene_gt.json / scene_gt_info.json / mask_visib
files, drops scenes with missing files (with a warning) and caches the
scene list as JSON (scene_list.json, the JAX package's format: either
package reads the other's). Images are read by data/png.read_png.
"""
from __future__ import annotations

import json
from pathlib import Path

from .png import read_png


class BOPSceneDataset:
    def __init__(self, data_root, render_data_name, mode: str = "train_pbr",
                 num_samples: int = -1, color: bool = False, cache_dir=None):
        mode = mode.lower()
        if mode == "validation":
            mode = "val"
        assert mode in ("train", "val", "test", "train_pbr"), mode
        self.data_root = Path(data_root)
        self.render_data_name = str(render_data_name)
        self.mode = mode
        self.color = color
        self.num_samples = num_samples
        self.cache_dir = None
        if cache_dir is not None:
            self.cache_dir = Path(cache_dir) / self.render_data_name / mode
            self.cache_dir.mkdir(parents=True, exist_ok=True)
        self._collect()

    # -- scene list ---------------------------------------------------------
    def _collect(self):
        cache_file = (self.cache_dir / "scene_list.json"
                      if self.cache_dir else None)
        if cache_file is not None and cache_file.exists():
            entries = json.loads(cache_file.read_text())
            self.entries = [
                {k: (Path(v) if k != "seg" else [Path(p) for p in v])
                 for k, v in e.items()} for e in entries]
            # the cached list is always the full walk; the limit is a
            # per-run view, so apply it after loading too
            if self.num_samples > 0:
                self.entries = self.entries[:self.num_samples]
            return
        root = self.data_root / self.render_data_name / self.mode
        self.entries = []
        for depth_path in sorted(root.rglob("*/depth/*.png")):
            scene_dir = depth_path.parents[1]
            stem = depth_path.stem
            seg_dir = scene_dir / "mask_visib"
            segs = sorted(seg_dir.glob(f"{stem}_*.png"))
            entry = {
                "depth": depth_path,
                "camera": scene_dir / "scene_camera.json",
                "scene_gt": scene_dir / "scene_gt.json",
                "scene_info": scene_dir / "scene_gt_info.json",
                "seg": segs,
            }
            if self.color:
                rgb = scene_dir / "rgb" / f"{stem}.jpg"
                if not rgb.exists():
                    rgb = scene_dir / "rgb" / f"{stem}.png"
                entry["color"] = rgb
            required = [depth_path, entry["camera"], entry["scene_info"]]
            required += segs if segs else [seg_dir / "missing"]
            if self.color:
                required.append(entry["color"])
            missing = [p for p in required if not p.exists()]
            # scene_gt is optional (absent in the shipped sample data);
            # GT-dependent fields are then None.
            if missing or not segs:
                print(f"Warning: scene {depth_path} dropped "
                      f"(missing {missing})")
                continue
            self.entries.append(entry)
            if self.num_samples > 0 and len(self.entries) >= self.num_samples:
                break
        # persist only full walks: a truncated first run must not poison
        # the shared scene list for later unlimited runs
        if cache_file is not None and self.num_samples <= 0:
            ser = [{k: (str(v) if k != "seg" else [str(p) for p in v])
                    for k, v in e.items()} for e in self.entries]
            cache_file.write_text(json.dumps(ser))

    # -- frame loading ------------------------------------------------------
    def __len__(self):
        return len(self.entries)

    def __getitem__(self, idx):
        e = self.entries[idx]
        depth_path = e["depth"]
        sub_nr = str(int(depth_path.stem))
        cam = json.loads(e["camera"].read_text())[sub_nr]
        info = json.loads(e["scene_info"].read_text())[sub_nr]
        gt = None
        if e["scene_gt"].exists():
            gt = json.loads(e["scene_gt"].read_text())[sub_nr]
        out = {
            "depth": read_png(depth_path),
            "camera": cam,
            "scene_gt": gt,
            "scene_info": info,
            "seg": [read_png(p) for p in e["seg"]],
        }
        if self.color:
            out["color"] = read_png(e["color"])
        return out
