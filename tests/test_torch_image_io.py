"""The port's PNG reader and writer (``utils/image_io.py``, zlib + struct)
against the JAX package's, which uses PIL: the same 8-bit pixels both ways,
including PIL's filtered RGB rows and a grey image."""

import numpy as np
import pytest
from PIL import Image

from gaussianimage_plus_tpu.utils import image_io as jio

from gaussianimage_plus_tpu_torch.utils import image_io as tio


def _image(H=37, W=53, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W] / max(H, W)
    smooth = np.stack([xx, yy, 0.5 * (xx + yy)], -1)       # filters 1-4 pay off
    noise = rng.uniform(size=(H, W, 3))
    return np.where(rng.uniform(size=(H, W, 1)) < 0.3, noise, smooth).astype(np.float32)


def test_port_png_reads_back_in_both_packages(tmp_path):
    img = _image()
    path = tmp_path / "port.png"
    tio.save_image(img, path)
    np.testing.assert_array_equal(tio.load_image(path), jio.load_image(path))
    np.testing.assert_allclose(tio.load_image(path), img, atol=0.5 / 255 + 1e-7)


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA"])
def test_port_reads_pil_pngs(tmp_path, mode):
    img = _image(seed=1)
    path = tmp_path / f"pil_{mode}.png"
    Image.fromarray(np.round(img * 255).astype(np.uint8)).convert(mode).save(path)
    np.testing.assert_array_equal(tio.load_image(path), jio.load_image(path))


def test_bad_inputs_raise(tmp_path):
    with pytest.raises(ValueError):
        tio.save_image(np.zeros((4, 4)), tmp_path / "x.png")
    (tmp_path / "bad.png").write_bytes(b"not a png")
    with pytest.raises(ValueError):
        tio.load_image(tmp_path / "bad.png")
