"""The standard-library PNG codec (utils/image.py)."""

import struct
import zlib

import numpy as np
import pytest

from python_ray_tracer_jax.utils.image import decode_png, encode_png, load_png, save_png, to_uint8


def _png(pixels: np.ndarray, color_type: int, row_filter: int) -> bytes:
    """A PNG of ``pixels`` (H, W, C) uint8 with every row in ``row_filter``,
    encoded here independently of the codec under test."""
    h, w, c = pixels.shape
    rows = pixels.reshape(h, w * c).astype(np.int64)
    raw = bytearray()
    prior = np.zeros(w * c, np.int64)
    for y in range(h):
        cur = rows[y]
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        up_left = np.concatenate([np.zeros(c, np.int64), prior[:-c]])
        if row_filter == 0:
            pred = np.zeros_like(cur)
        elif row_filter == 1:
            pred = left
        elif row_filter == 2:
            pred = prior
        elif row_filter == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, up_left))
        raw.append(row_filter)
        raw += ((cur - pred) % 256).astype(np.uint8).tobytes()
        prior = cur

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


def _pixels(h, w, c, seed=0):
    rng = np.random.default_rng(seed)
    # Smooth ramps plus noise: every filter sees both small and wrapping deltas.
    ramp = (np.arange(w)[None, :, None] * 7 + np.arange(h)[:, None, None] * 3 + np.arange(c) * 50) % 256
    return ((ramp + rng.integers(0, 40, (h, w, c))) % 256).astype(np.uint8)


@pytest.mark.parametrize("h,w", [(1, 1), (7, 13), (64, 33)])
def test_roundtrip(h, w):
    px = _pixels(h, w, 3, seed=h)
    np.testing.assert_array_equal(decode_png(encode_png(px)), px)


@pytest.mark.parametrize("row_filter", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("color_type,channels", [(0, 1), (2, 3), (4, 2), (6, 4)])
def test_decodes_every_filter_and_colour_type(row_filter, color_type, channels):
    px = _pixels(9, 11, channels, seed=row_filter)
    got = decode_png(_png(px, color_type, row_filter))
    expected = np.repeat(px[..., :1], 3, axis=2) if channels in (1, 2) else px[..., :3]
    np.testing.assert_array_equal(got, expected)


def test_save_load_quantizes_like_the_reference(tmp_path):
    img = np.random.default_rng(3).uniform(-0.2, 1.2, (10, 12, 3))
    save_png(img, tmp_path / "x.png")
    np.testing.assert_array_equal(load_png(tmp_path / "x.png"), to_uint8(img))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA"])
def test_matches_pillow_decoder(mode):
    image_mod = pytest.importorskip("PIL.Image")
    import io

    channels = {"RGB": 3, "RGBA": 4, "L": 1, "LA": 2}[mode]
    px = _pixels(37, 53, channels, seed=channels)
    buf = io.BytesIO()
    image_mod.fromarray(px[..., 0] if channels == 1 else px, mode).save(buf, "PNG", optimize=True)
    expected = np.asarray(image_mod.open(io.BytesIO(buf.getvalue())).convert("RGB"))
    np.testing.assert_array_equal(decode_png(buf.getvalue()), expected)


def test_pillow_reads_what_we_write():
    image_mod = pytest.importorskip("PIL.Image")
    import io

    px = _pixels(21, 34, 3)
    np.testing.assert_array_equal(np.asarray(image_mod.open(io.BytesIO(encode_png(px)))), px)


def test_rejects_unsupported_files():
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a")
    sixteen_bit = _png(_pixels(2, 2, 3), 2, 0).replace(
        struct.pack(">IIBB", 2, 2, 8, 2), struct.pack(">IIBB", 2, 2, 16, 2)
    )
    with pytest.raises(ValueError, match="bit depth 16"):
        decode_png(sixteen_bit)
