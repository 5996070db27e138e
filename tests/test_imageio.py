"""Standard-library PNG output (core/imageio.py) and the compile-cache
directory choice (utils/compile_cache.py)."""

import io
import zlib

import numpy as np
import pytest

from small_pathtracer_tpu.core import imageio
from small_pathtracer_tpu.utils import compile_cache


def _img(h=5, w=7):
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def test_png_round_trip():
    img = _img()
    data = imageio.encode_png(img)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(imageio.decode_png(data), img)


def test_png_readable_by_pillow():
    Image = pytest.importorskip("PIL.Image")
    img = _img(3, 4)
    got = np.asarray(Image.open(io.BytesIO(imageio.encode_png(img))))
    np.testing.assert_array_equal(got, img)


def test_png_chunk_crcs_valid():
    data = imageio.encode_png(_img(2, 2))
    pos = 8
    tags = []
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc = int.from_bytes(data[pos + 8 + n:pos + 12 + n], "big")
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        tags.append(tag)
        pos += 12 + n
    assert tags == [b"IHDR", b"IDAT", b"IEND"]


def test_write_image_by_extension(tmp_path):
    img = _img()
    imageio.write_image(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(
        imageio.decode_png((tmp_path / "a.png").read_bytes()), img)
    imageio.write_image(str(tmp_path / "b.tmp"), img, ".png")
    np.testing.assert_array_equal(
        imageio.decode_png((tmp_path / "b.tmp").read_bytes()), img)
    imageio.write_image(str(tmp_path / "c.ppm"), img)
    np.testing.assert_array_equal(
        imageio.read_image(str(tmp_path / "c.ppm")), img)
    with pytest.raises(ValueError, match="unsupported"):
        imageio.write_image(str(tmp_path / "d.jpg"), img)
    with pytest.raises(ValueError):
        imageio.encode_png(np.zeros((2, 2), np.uint8))


def test_cache_dir_from_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: it is the cache, and the helper
    leaves JAX's config alone (JAX reads the variable itself)."""
    import jax

    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_default(monkeypatch):
    """Unset: the fixed <repo>/.jax_cache, set in JAX's config."""
    import jax

    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == str(compile_cache.DEFAULT_DIR)
        assert compile_cache.DEFAULT_DIR.name == ".jax_cache"
        assert (compile_cache.DEFAULT_DIR.parent / "small_pathtracer_tpu"
                ).is_dir()
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
