"""The port's io/image.py against the JAX package's: the memoised skybox
loader, image decoding, screenshots and the PNG encoders. Mirrors
tests/test_io.py; the tests write their own faces (the reference's skybox
is not read)."""

import os
import pathlib
import time

import numpy as np
import pytest

from ray_tracing_tpu.io import image as jimage
from ray_tracing_tpu.ops.cubemap import CubemapData as JCubemapData

from ray_tracing_tpu_torch.io import image as timage
from ray_tracing_tpu_torch.ops.cubemap import CubemapData


def write_faces(root: pathlib.Path, base: int, size: int = 8, ext: str = "jpg"):
    """Six faces, distinct per face and per `base`: gradients as JPEG (or
    PNG), so that the decoder's rounding matters."""
    from PIL import Image

    (root / "skybox").mkdir(parents=True, exist_ok=True)
    yy, xx = np.mgrid[0:size, 0:size]
    for face, rel in timage.SKYBOX_FILES.items():
        arr = np.stack([(base + 20 * face + 7 * xx) % 256, (base + 5 * yy) % 256,
                        np.full_like(xx, 255 - base)], -1).astype(np.uint8)
        Image.fromarray(arr).save((root / rel).with_suffix("." + ext), quality=95)


def test_skybox_files_match_jax():
    assert timage.SKYBOX_FILES == jimage.SKYBOX_FILES


def packed_u32(cm) -> np.ndarray:
    """The port's int32 texels read as the JAX package's uint32."""
    return cm.packed.numpy().view(np.uint32)


@pytest.mark.parametrize("size", [8, 33])
def test_load_cubemap_texels_equal_jax(tmp_path, size):
    """Exact: the same JPEG faces give the same packed texels (the port's
    int32 read as uint32) in both packages, with and without the memo."""
    write_faces(tmp_path, base=40, size=size)
    want = jimage.load_cubemap(tmp_path, use_cache=False)
    for use_cache in (False, True, True):
        got = timage.load_cubemap(tmp_path, use_cache=use_cache, device="cpu")
        assert (got.h, got.w) == (want.h, want.w) == (size, size)
        np.testing.assert_array_equal(packed_u32(got), np.asarray(want.packed))
    faces = np.stack([jimage.load_image(tmp_path / timage.SKYBOX_FILES[f]) for f in range(6)])
    np.testing.assert_array_equal(
        packed_u32(CubemapData.from_faces(faces, device="cpu")),
        np.asarray(JCubemapData.from_faces(faces).packed))


def test_load_cubemap_memoization_and_invalidation(tmp_path):
    """The memo returns the decode's texels, under the port's own directory;
    editing an asset (new mtime and size -> new key) never serves the stale
    texels."""
    write_faces(tmp_path, base=40)
    fresh = timage.load_cubemap(tmp_path, use_cache=False, device="cpu")
    first = timage.load_cubemap(tmp_path, device="cpu")   # decode + save
    cached = timage.load_cubemap(tmp_path, device="cpu")  # from the memo
    assert first.packed.equal(fresh.packed) and cached.packed.equal(fresh.packed)
    cache_dir = timage.skybox_cache_dir()
    assert cache_dir.name == f"rtt_torch_skybox_{os.getuid()}"
    assert cache_dir.name != f"rtt_skybox_{os.getuid()}"  # never the JAX package's
    assert cache_dir.is_dir() and any(cache_dir.glob("*.npz"))

    time.sleep(0.01)  # a distinct mtime_ns even on coarse clocks
    write_faces(tmp_path, base=200)
    reloaded = timage.load_cubemap(tmp_path, device="cpu")
    assert reloaded.packed.equal(timage.load_cubemap(tmp_path, use_cache=False,
                                                     device="cpu").packed)
    assert not reloaded.packed.equal(first.packed)


def test_corrupt_memo_is_decoded_again(tmp_path, monkeypatch):
    monkeypatch.setattr(timage, "skybox_cache_dir", lambda: tmp_path / "memo")
    write_faces(tmp_path, base=90)
    first = timage.load_cubemap(tmp_path, device="cpu")
    (memo,) = (tmp_path / "memo").glob("*.npz")
    memo.write_bytes(b"not an npz file")
    again = timage.load_cubemap(tmp_path, device="cpu")
    assert again.packed.equal(first.packed)


def test_load_cubemap_missing_face_raises(tmp_path):
    write_faces(tmp_path, base=10)
    (tmp_path / timage.SKYBOX_FILES[3]).unlink()
    with pytest.raises(OSError):
        timage.load_cubemap(tmp_path, device="cpu")


@pytest.mark.parametrize("ext", ["jpg", "png"])
def test_load_image_equals_jax(tmp_path, ext):
    write_faces(tmp_path, base=70, size=13, ext=ext)
    path = tmp_path / pathlib.Path(timage.SKYBOX_FILES[2]).with_suffix("." + ext)
    got = timage.load_image(path)
    assert got.shape == (13, 13, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jimage.load_image(path))


def test_screenshot_names_are_the_first_free_ones(tmp_path):
    """src/main.c:642-659: screenshot_<i>.png, the first i not taken; the
    same names as the JAX package's."""
    assert timage.next_screenshot_path(tmp_path) == jimage.next_screenshot_path(tmp_path)
    img = np.random.default_rng(3).uniform(0, 1, (6, 9, 3)).astype(np.float32)
    p0 = timage.screenshot(img, tmp_path)
    assert p0 == os.path.join(tmp_path, "screenshot_0.png")
    (tmp_path / "screenshot_1.png").write_bytes(b"")
    assert timage.next_screenshot_path(tmp_path) == jimage.next_screenshot_path(tmp_path) \
        == os.path.join(tmp_path, "screenshot_2.png")
    np.testing.assert_array_equal(timage.read_png(p0), timage.to_uint8(img)[::-1])


@pytest.mark.parametrize("use_native", [True, False])
def test_save_png_pixels_equal_jax(tmp_path, use_native):
    from PIL import Image

    img = np.random.default_rng(5).uniform(0, 1, (17, 11, 3)).astype(np.float32)
    timage.save_png(img, tmp_path / "t.png", use_native=use_native)
    jimage.save_png(img, tmp_path / "j.png", use_native=False)
    with Image.open(tmp_path / "j.png") as im:
        want = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(timage.read_png(tmp_path / "t.png"), want)


def test_encode_png_round_trips():
    from io import BytesIO

    from PIL import Image

    arr = np.random.default_rng(2).integers(0, 256, (7, 5, 3), dtype=np.uint8)
    data = timage.encode_png(arr)
    with Image.open(BytesIO(data)) as im:
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), arr)
    with pytest.raises(ValueError):
        timage.encode_png(arr[..., :2])
    with pytest.raises(ValueError):
        timage.save_png(np.zeros((4, 4), np.float32), "unused.png")
