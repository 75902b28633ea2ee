"""The port's BOP data layer against the JAX package's on the CPU: PNG
reading and writing (against PIL), the scene walk, QEM decimation
(native and Python), the object dataset's preprocessing and its cache
(each package reads the other's), and the scene writer's bytes.

Tolerances: points, FPS picks, GT pairs, overlap masks, decimated
meshes, masses, frames and every cached array read across packages are
held exactly. Freshly built spectral operators are not repeatable
(ARPACK and LOBPCG start from random blocks): their eigenvalues within
1e-3 * (|lambda| + 1e-2 * max |lambda|), and each eigenvector's
|<u, v>|_M >= 0.999.
"""
import io
import json
import struct
import subprocess
import time
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image
from scipy.spatial.transform import Rotation

import bop_fixture
import pose6d_tpu.data.dataset as jax_dataset
from pose6d_tpu.data.bop import BOPSceneDataset as JaxScenes
from pose6d_tpu.data.decimate import decimate_mesh as jax_decimate
from pose6d_tpu.data.ply import write_ply_mesh as jax_write_ply
from pose6d_tpu.data.shapes import diameter, random_shape
from pose6d_tpu.data.synth import write_bop_scene as jax_write_scene
from pose6d_tpu_torch import native
from pose6d_tpu_torch.data import dataset as port_dataset
from pose6d_tpu_torch.data.bop import BOPSceneDataset
from pose6d_tpu_torch.data.decimate import decimate_mesh
from pose6d_tpu_torch.data.ply import write_ply_mesh
from pose6d_tpu_torch.data.png import read_png, write_png
from pose6d_tpu_torch.data.synth import write_bop_scene

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
OBJ = 3
DS_KW = {"target_faces": 1500, "max_pc": 500}   # FPS runs: > 500 points
EVAL_TOL, VEC_TOL = 1e-3, 0.999


def images():
    rng = np.random.default_rng(0)
    depth = np.zeros((48, 64), np.uint16)
    depth[10:30, 20:50] = 900 + rng.integers(0, 400, (20, 30))
    depth[0, :5] = [0, 1, 255, 256, 65535]
    return {"depth16": depth,
            "mask8": ((depth > 0) * 255).astype(np.uint8),
            "rgb8": rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)}


FORMS = list(images())


@pytest.mark.parametrize("form", FORMS)
def test_read_png_equals_pil(form, tmp_path):
    a = images()[form]
    p = tmp_path / "a.png"
    Image.fromarray(a).save(p)
    got, ref = read_png(p), np.asarray(Image.open(p))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def encode_filtered(a: np.ndarray, colour: int, depth: int) -> bytes:
    """A PNG whose rows cycle through the five filters, its image data
    split over IDAT chunks of 97 bytes."""
    h = a.shape[0]
    be = a.astype(">u2") if depth == 16 else a
    rows = np.ascontiguousarray(be).view(np.uint8).reshape(h, -1)
    bpp = rows.shape[1] // a.shape[1]
    out, prior = bytearray(), [0] * rows.shape[1]
    for y in range(h):
        kind, line = y % 5, [int(v) for v in rows[y]]
        enc = []
        for x, v in enumerate(line):
            left = line[x - bpp] if x >= bpp else 0
            ul = prior[x - bpp] if x >= bpp else 0
            pred = (0, left, prior[x], (left + prior[x]) // 2,
                    _paeth(left, prior[x], ul))[kind]
            enc.append((v - pred) & 0xFF)
        out += bytes([kind] + enc)
        prior = line
    data = zlib.compress(bytes(out))

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    idat = b"".join(chunk(b"IDAT", data[i:i + 97])
                    for i in range(0, len(data), 97))
    ihdr = struct.pack(">IIBBBBB", a.shape[1], h, depth, colour, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + idat
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("form", FORMS)
def test_read_png_every_row_filter(form, tmp_path):
    a = images()[form]
    colour, depth = {"depth16": (0, 16), "mask8": (0, 8),
                     "rgb8": (2, 8)}[form]
    p = tmp_path / "f.png"
    p.write_bytes(encode_filtered(a, colour, depth))
    np.testing.assert_array_equal(np.asarray(Image.open(p)), a)
    np.testing.assert_array_equal(read_png(p), a)


@pytest.mark.parametrize("form", FORMS)
def test_write_png_read_by_pil(form, tmp_path):
    a = images()[form]
    p = tmp_path / "w.png"
    write_png(p, a)
    back = np.asarray(Image.open(p))
    assert back.dtype == a.dtype
    np.testing.assert_array_equal(back, a)


def _refused(kind, path):
    a = images()["mask8"]
    if kind == "palette":
        Image.fromarray(a).convert("P").save(path)
    elif kind == "rgba":
        Image.fromarray(a).convert("RGBA").save(path)
    elif kind == "gray_alpha":
        Image.fromarray(a).convert("LA").save(path)
    elif kind == "one_bit":
        Image.fromarray(a).convert("1").save(path)
    elif kind == "jpeg":
        Image.fromarray(images()["rgb8"]).save(path, format="JPEG")
    else:                                   # an interlaced header
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, format="PNG")
        b = bytearray(buf.getvalue())
        b[28] = 1                           # IHDR's interlace byte
        b[29:33] = struct.pack(">I", zlib.crc32(bytes(b[12:29])))
        path.write_bytes(bytes(b))


@pytest.mark.parametrize("kind", ["palette", "rgba", "gray_alpha", "one_bit",
                                  "jpeg", "interlaced"])
def test_read_png_refuses_other_forms(kind, tmp_path):
    p = tmp_path / f"{kind}.png"
    _refused(kind, p)
    with pytest.raises(ValueError, match=str(p.name)) as e:
        read_png(p)
    if kind == "jpeg":
        assert "JPEG decoder" in str(e.value)


# -- scenes, decimation, objects ---------------------------------------------
def mesh():
    v, f = random_shape(5, nu=24, nv=48)
    return {"verts": v, "faces": f}, diameter(v)


def poses():
    rng = np.random.default_rng(0)
    return [(Rotation.from_rotvec(rng.normal(size=3) * 0.9).as_matrix(),
             np.array([10.0, -5.0, 1400.0])) for _ in range(2)]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Two BOP datasets written by the JAX package (PIL PNGs): "fx"
    (two poses of one random shape) and "fixture" (tests/bop_fixture)."""
    r = tmp_path_factory.mktemp("bop")
    m, d = mesh()
    jax_write_scene(r, "fx", m, OBJ, poses(), d)
    bop_fixture.write_bop_scene(r, "fixture", m, OBJ, *poses()[1], d,
                                n_frames=2)
    return r


def _frames_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "seg":
            assert len(a[k]) == len(b[k])
            for x, y in zip(a[k], b[k]):
                np.testing.assert_array_equal(x, y)
        elif isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k]


@pytest.mark.parametrize("cache", ["none", "written_by_jax",
                                   "written_by_port", "num_samples_1"])
def test_scene_dataset_equals_jax(root, cache, tmp_path):
    kw = {}
    if cache == "num_samples_1":
        kw = {"num_samples": 1, "cache_dir": tmp_path}
    elif cache != "none":
        kw = {"cache_dir": tmp_path}
        writer = JaxScenes if cache == "written_by_jax" else BOPSceneDataset
        writer(root, "fixture", **kw)
        assert (tmp_path / "fixture" / "train_pbr" / "scene_list.json"
                ).exists()
    ref = JaxScenes(root, "fixture", **kw)
    got = BOPSceneDataset(root, "fixture", **kw)
    assert [{k: str(v) for k, v in e.items()} for e in got.entries] == \
        [{k: str(v) for k, v in e.items()} for e in ref.entries]
    assert len(got) == (1 if cache == "num_samples_1" else 2)
    for i in range(len(got)):
        _frames_equal(got[i], ref[i])
    if cache == "num_samples_1":       # a truncated walk is not persisted
        assert not (tmp_path / "fixture" / "train_pbr" / "scene_list.json"
                    ).exists()


@pytest.fixture(scope="module", autouse=True)
def jax_native_built():
    """The JAX package builds its native decimation on first use and
    falls back to its Python QEM (other results) when the build or load
    fails, as when a make in another test worker is still writing the
    library: load it here first, waiting out such a race."""
    from pose6d_tpu import native as jax_native
    for attempt in range(5):
        try:
            jax_native._load()
            return
        except (OSError, subprocess.CalledProcessError):
            jax_native._lib = None
            time.sleep(1 + attempt)
    pytest.fail("the JAX package's native decimation does not build")


def test_native_source_is_the_jax_one():
    """The port's C++ copy differs from the JAX package's only in its
    header comment."""
    def body(p):
        text = p.read_text()
        return text[text.index("#include"):]
    assert body(native.SOURCE) == body(
        ROOT / "pose6d_tpu" / "native" / "decimate.cpp")


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "python"])
def test_decimate_equals_jax(use_native):
    m, _ = mesh()
    got = decimate_mesh(m["verts"], m["faces"], 1500, use_native=use_native)
    ref = jax_decimate(m["verts"], m["faces"], 1500, use_native=use_native)
    assert len(got[1]) <= 1500
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No silent fallback: a compiler that fails raises with its output."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")
    m, _ = mesh()
    with pytest.raises(RuntimeError, match="native decimation"):
        decimate_mesh(m["verts"], m["faces"], 1500)
    monkeypatch.setenv("CXX", str(tmp_path / "no_such_compiler"))
    with pytest.raises(RuntimeError, match="cannot run"):
        decimate_mesh(m["verts"], m["faces"], 1500)


def _build(factory, root, cache_dir, **kw):
    ds = factory(root, "fx", cache_dir=cache_dir, **DS_KW, **kw)
    return ds, [ds[i] for i in range(len(ds))]


@pytest.fixture(scope="module")
def jax_built(root, tmp_path_factory):
    return _build(jax_dataset.BOPObjectDataset, root,
                  tmp_path_factory.mktemp("jax_cache"))


@pytest.fixture(scope="module")
def port_built(root, tmp_path_factory):
    return _build(port_dataset.BOPObjectDataset, root,
                  tmp_path_factory.mktemp("port_cache"), device="cpu")


def _eigen_close(a: dict, b: dict):
    """The module docstring's eigenvalue and eigenvector tolerances."""
    lam = np.asarray(a["evals"], np.float64)
    err = np.abs(lam - b["evals"])
    assert (err <= EVAL_TOL * (np.abs(lam) + 1e-2 * np.abs(lam).max())).all()
    dots = np.abs(np.einsum("vk,v,vk->k", a["evecs"], a["mass"], b["evecs"]))
    assert dots.min() >= VEC_TOL, dots.min()


def _operators_close(a: dict, b: dict):
    """Freshly built operators: exact but for the eigenbasis."""
    assert a.keys() == b.keys()
    for k in a:
        if k not in ("evals", "evecs"):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    _eigen_close(a, b)


def test_object_dataset_equals_jax(jax_built, port_built):
    """The port on the CPU against JAX, both building: the cloud (FPS to
    500 points), GT pairs, overlaps and decimated CAD exactly."""
    (jds, ref), (pds, got) = jax_built, port_built
    assert pds.mapping_list == jds.mapping_list and len(got) == 2
    for (jc, jp, jo), (pc_, pp, po) in zip(ref, got):
        assert jo.keys() == po.keys()
        for k in jo:
            np.testing.assert_array_equal(np.asarray(po[k]),
                                          np.asarray(jo[k]), err_msg=k)
        assert len(po["pcd_depth"]) == DS_KW["max_pc"]
        assert len(po["P"]) > 100
        _operators_close(jc, pc_)
        _operators_close(jp, pp)


def _files(cache) -> list:
    return sorted(str(p.relative_to(cache)) for p in cache.rglob("*")
                  if p.is_file() and p.name != "scene_list.json")


def _identical(items_a, items_b):
    for a, b in zip(items_a, items_b, strict=True):
        for da, db in zip(a, b):
            assert da.keys() == db.keys()
            for k in da:
                x, y = np.asarray(da[k]), np.asarray(db[k])
                assert x.dtype == y.dtype and x.shape == y.shape, k
                np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_served_across_packages(root, jax_built, port_built, writer):
    """One package builds the cache, the other reads it: the same file
    names, and arrays identical to what the writer returned."""
    jds, ref = jax_built
    pds, got = port_built
    assert _files(jds.cache_root) == _files(pds.cache_root)
    if writer == "jax":
        reader = port_dataset.BOPObjectDataset(
            root, "fx", cache_dir=jds.cache_root, device="cpu", **DS_KW)
        built = ref
    else:
        reader = jax_dataset.BOPObjectDataset(
            root, "fx", cache_dir=pds.cache_root, **DS_KW)
        built = got
    _identical([reader[i] for i in range(len(reader))], built)


def test_device_lbo_backend_agrees(root):
    ref = jax_dataset.BOPObjectDataset(root, "fx", pc_lbo_backend="device",
                                       **DS_KW)[0]
    got = port_dataset.BOPObjectDataset(root, "fx", pc_lbo_backend="device",
                                        device="cpu", **DS_KW)[0]
    np.testing.assert_array_equal(got[2]["pcd_depth"], ref[2]["pcd_depth"])
    a, b = ref[1], got[1]
    assert a.keys() == b.keys()
    np.testing.assert_array_equal(a["xyz"], b["xyz"])
    np.testing.assert_allclose(a["mass"], b["mass"], rtol=1e-6)
    _eigen_close(a, b)


def test_sample_dropped_self_heals(root, tmp_path, monkeypatch):
    """A failing operator build drops the sample and persists the shorter
    mapping list, as the JAX package does."""
    ds = port_dataset.BOPObjectDataset(root, "fx", cache_dir=tmp_path,
                                       device="cpu", **DS_KW)
    first = ds.mapping_list[0]

    def fail(*a, **k):
        raise RuntimeError("eigsh did not converge")
    import pose6d_tpu_torch.spectral.operators as ops
    monkeypatch.setattr(ops, "point_cloud_operators", fail)
    with pytest.raises(port_dataset.SampleDropped, match="eigsh"):
        ds[0]
    saved = np.load(tmp_path / "fx" / "train_pbr" / "mapping_list.npz")
    assert first not in ds.mapping_list
    assert [tuple(m) for m in saved["mapping_list"]] == ds.mapping_list


def test_scene_writer_bytes_equal_jax(tmp_path):
    """The port's PLY and scene writer against the JAX package's: the same
    PLY bytes (the shared CAD cache hashes them), JSON files, depth and
    masks; the colour frame is a black PNG where JAX writes a JPEG."""
    m, d = mesh()
    write_ply_mesh(tmp_path / "a.ply", m["verts"], m["faces"])
    jax_write_ply(tmp_path / "b.ply", m["verts"], m["faces"])
    assert (tmp_path / "a.ply").read_bytes() == \
        (tmp_path / "b.ply").read_bytes()
    kw = {"occlude_prob": 1.0, "depth_noise_mm": 1.0, "hole_frac": 0.02,
          "seed": 4}
    a = write_bop_scene(tmp_path / "port", "s", m, OBJ, poses(), d, **kw)
    b = jax_write_scene(tmp_path / "jax", "s", m, OBJ, poses(), d, **kw)
    for rel in ("models/obj_000003.ply", "models/models_info.json",
                "train_pbr/000000/scene_camera.json",
                "train_pbr/000000/scene_gt.json",
                "train_pbr/000000/scene_gt_info.json"):
        assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel
    assert json.loads((a / "train_pbr/000000/scene_gt_info.json")
                      .read_text())["0"][0]["visib_fract"] < 1
    for sub in ("depth/000000.png", "depth/000001.png",
                "mask_visib/000000_000000.png",
                "mask_visib/000001_000000.png"):
        np.testing.assert_array_equal(
            np.asarray(Image.open(a / "train_pbr/000000" / sub)),
            np.asarray(Image.open(b / "train_pbr/000000" / sub)))
    assert (a / "train_pbr/000000/rgb/000000.png").exists()
    assert (b / "train_pbr/000000/rgb/000000.jpg").exists()
