"""The port's baseline JPEG decoder (data/jpeg.py) against the JAX
package's image reader (pose6d_tpu/data/bop.py _load_image: PIL on
libjpeg) on files PIL writes here: 4:4:4, 4:2:2, 4:2:0 (also at an odd
size), grayscale, restart intervals by blocks and by rows, quality 100
and 5. The tolerance is 0 levels: the port follows libjpeg's islow
IDCT, fancy upsampling and integer YCbCr -> RGB, so every pixel is
PIL's. Progressive and arithmetic-coded files raise, naming their
coding; BOPSceneDataset(color=True) reads the rgb/*.jpg frames that the
JAX package's scene writer makes, as the JAX dataset does."""
import numpy as np
import pytest
from PIL import Image

from pose6d_tpu.data.bop import BOPSceneDataset as JaxScenes
from pose6d_tpu.data.bop import _load_image
from pose6d_tpu.data.synth import write_bop_scene as jax_write_scene
from pose6d_tpu_torch.data.bop import BOPSceneDataset, read_image
from pose6d_tpu_torch.data.jpeg import read_jpeg

from test_torch_bop import OBJ, mesh, poses

CASES = {
    "444": dict(subsampling=0, quality=90),
    "422": dict(subsampling=1, quality=75),
    "420": dict(subsampling=2, quality=75),
    "420_odd_size": dict(subsampling=2, quality=60),
    "gray": dict(quality=85),
    "restart_blocks": dict(subsampling=2, quality=80,
                           restart_marker_blocks=7),
    "restart_rows": dict(subsampling=0, quality=80, restart_marker_rows=1),
    "quality_100": dict(subsampling=0, quality=100),
    "quality_5": dict(subsampling=2, quality=5),
}


def _image(kind):
    """A 640 x 480 gradient with noise (the size of a BOP frame)."""
    rng = np.random.default_rng(0)
    h, w = 480, 640
    yy, xx = np.mgrid[:h, :w]
    a = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) % 256], -1)
    a = np.clip(a + rng.integers(-40, 40, a.shape), 0, 255).astype(np.uint8)
    if kind == "gray":
        return a[..., 0]
    if kind == "420_odd_size":
        return a[:477, :633]
    return a


@pytest.mark.parametrize("kind", list(CASES))
def test_jpeg_equals_pil(kind, tmp_path):
    path = tmp_path / f"{kind}.jpg"
    Image.fromarray(_image(kind)).save(path, format="JPEG", **CASES[kind])
    ref = _load_image(path)
    got = read_jpeg(path)
    assert got.dtype == ref.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(read_image(path), ref)


@pytest.mark.parametrize("coding", ["progressive", "arithmetic sequential"])
def test_other_codings_raise(coding, tmp_path):
    path = tmp_path / "x.jpg"
    a = _image("420")[:64, :80]
    if coding == "progressive":
        Image.fromarray(a).save(path, format="JPEG", progressive=True)
    else:                                   # the SOF0 marker made SOF9
        Image.fromarray(a).save(path, format="JPEG")
        b = bytearray(path.read_bytes())
        b[b.index(b"\xff\xc0") + 1] = 0xC9
        path.write_bytes(bytes(b))
    with pytest.raises(ValueError, match=f"x.jpg: {coding} JPEG"):
        read_jpeg(path)


def test_scene_dataset_reads_jpeg_colour_frames(tmp_path):
    m, d = mesh()
    jax_write_scene(tmp_path, "fx", m, OBJ, poses(), d)
    a = BOPSceneDataset(tmp_path, "fx", color=True)
    b = JaxScenes(tmp_path, "fx", color=True)
    assert len(a) == len(b) == 2
    for i in range(2):
        assert a.entries[i]["color"].suffix == ".jpg"
        fa, fb = a[i], b[i]
        assert fa["color"].shape == (480, 640, 3)
        np.testing.assert_array_equal(fa["color"], fb["color"])
        np.testing.assert_array_equal(fa["depth"], fb["depth"])
