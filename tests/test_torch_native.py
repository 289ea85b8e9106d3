"""The port's native JPEG front end (``tpudet_torch/native``) against the
JAX package's (``tpudet.native``, ``tpudet.data.native_decode``) and PIL,
on JPEGs these tests write with PIL from seeded numpy: equal arrays from
the decode, the resize, the fused decode-resize-pad and the batch; the same
failures."""

import io

import numpy as np
import pytest
from PIL import Image

from tpudet.data import native_decode as jnd
from tpudet.native import native_available as jax_native_available
from tpudet_torch import native as tnative
from tpudet_torch.data import native_decode as nd
from tpudet_torch.data.preprocess import resize_uint8


@pytest.fixture(scope="module", autouse=True)
def both_built():
    assert tnative.native_available(), "the port's decoder did not build"
    assert jax_native_available(), "the JAX package's decoder did not build"


def photo(rng, h, w):
    """A JPEG-friendly image: noise upsampled (band-limited)."""
    small = rng.integers(0, 255, (max(2, h // 8), max(2, w // 8), 3), np.uint8)
    return np.asarray(Image.fromarray(small).resize((w, h), Image.BILINEAR))


def jpeg(img, quality=92, mode=None):
    buf = io.BytesIO()
    im = Image.fromarray(img)
    if mode:
        im = im.convert(mode)
    im.save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def test_library_builds_under_the_repository():
    path = tnative.build()
    assert path == tnative.library_path() and path.exists()
    assert path.parent.parts[-2:] == ("build", "tpudet_torch_native")


@pytest.mark.parametrize("hw", [(211, 337), (64, 80), (17, 9)])
def test_decode_equals_jax_and_pil(hw):
    rng = np.random.default_rng(hw[0])
    data = jpeg(photo(rng, *hw))
    assert nd.jpeg_dims(data) == jnd.jpeg_dims(data) == hw
    got = nd.decode_jpeg(data)
    np.testing.assert_array_equal(got, jnd.decode_jpeg(data))
    np.testing.assert_array_equal(
        got, np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


def test_decode_grayscale_equals_jax():
    data = jpeg(photo(np.random.default_rng(1), 64, 80), mode="L")
    got = nd.decode_jpeg(data)
    assert got.shape == (64, 80, 3)
    np.testing.assert_array_equal(got[..., 0], got[..., 1])  # replicated
    np.testing.assert_array_equal(got, jnd.decode_jpeg(data))


@pytest.mark.parametrize("in_hw,out_hw", [((240, 320), (123, 177)),
                                          ((60, 80), (150, 190)),
                                          ((100, 100), (100, 100))])
def test_resize_equals_jax(in_hw, out_hw):
    img = photo(np.random.default_rng(2), *in_hw)
    np.testing.assert_array_equal(nd.resize(img, *out_hw),
                                  jnd.resize(img, *out_hw))


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("hw,sizes", [((300, 400), (96, 160, 160, 160)),
                                      ((480, 640), (600, 1000, 640, 832)),
                                      ((90, 140), (90, 128, 96, 128))])
def test_decode_resize_pad_equals_jax(fast, hw, sizes):
    data = jpeg(photo(np.random.default_rng(hw[1]), *hw))
    got = nd.decode_resize_pad(data, *sizes, fast_dct_scale=fast)
    want = jnd.decode_resize_pad(data, *sizes, fast_dct_scale=fast)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def test_decode_resize_pad_near_pil_arithmetic():
    """The exact fused path against the decode, the port's resize (PIL's
    fixed point) and a top-left pad: within 2 levels, mean under 0.3 (the
    JAX package's bounds against PIL)."""
    data = jpeg(photo(np.random.default_rng(3), 375, 500), quality=90)
    canvas, (nh, nw), (h, w) = nd.decode_resize_pad(
        data, 600, 1000, 640, 832, fast_dct_scale=False)
    assert (h, w) == (375, 500) and (nh, nw) == (600, 800)
    want = np.zeros_like(canvas)
    want[:nh, :nw] = resize_uint8(nd.decode_jpeg(data), nh, nw)
    diff = np.abs(canvas.astype(int) - want.astype(int))
    assert diff.max() <= 2 and diff.mean() < 0.3


def test_decode_batch_equals_jax_and_single_calls():
    rng = np.random.default_rng(4)
    jpegs = [jpeg(photo(rng, h, w)) for h, w in [(120, 160), (200, 150),
                                                 (96, 96), (33, 250)]]
    jpegs.insert(2, b"corrupt")
    got = nd.decode_batch(jpegs, 64, 100, 100, 100, fast_dct_scale=True,
                          num_threads=3)
    want = jnd.decode_batch(jpegs, 64, 100, 100, 100, fast_dct_scale=True,
                            num_threads=3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] == 1
    assert tuple(got[1][2]) == (0, 0, 0, 0)
    for i, data in enumerate(jpegs):
        if i == 2:
            continue
        canvas, nhw, ohw = nd.decode_resize_pad(data, 64, 100, 100, 100)
        assert tuple(got[1][i]) == nhw + ohw
        np.testing.assert_array_equal(got[0][i], canvas)


def test_corrupt_and_truncated_jpegs_raise():
    whole = jpeg(np.random.default_rng(0).integers(0, 255, (120, 160, 3),
                                                   np.uint8), quality=90)
    nd.decode_resize_pad(whole, 100, 160, 128, 160)
    with pytest.raises(nd.NativeDecodeError):
        nd.jpeg_dims(b"not a jpeg at all")
    with pytest.raises(nd.NativeDecodeError):
        nd.decode_jpeg(b"\xff\xd8\xff\xe0 truncated garbage")
    # libjpeg fills a truncated scan with grey and warns: an error here.
    for call in (lambda d: nd.decode_jpeg(d),
                 lambda d: nd.decode_resize_pad(d, 100, 160, 128, 160)):
        with pytest.raises(nd.NativeDecodeError):
            call(whole[: len(whole) // 2])
    assert nd.decode_batch([whole[: len(whole) // 2]], 100, 160, 128,
                           160)[2] == 1


@pytest.mark.parametrize("quality", [75, 90, 100])
def test_decode_at_each_quality_equals_jax_and_pil(quality):
    """The decode and the fused front end at the qualities of real
    datasets and of the benchmark's JPEGs (90), at an odd size."""
    data = jpeg(photo(np.random.default_rng(quality), 131, 97),
                quality=quality)
    got = nd.decode_jpeg(data)
    np.testing.assert_array_equal(got, jnd.decode_jpeg(data))
    np.testing.assert_array_equal(
        got, np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
    for fast in (True, False):
        port = nd.decode_resize_pad(data, 64, 100, 128, 96,
                                    fast_dct_scale=fast)
        ref = jnd.decode_resize_pad(data, 64, 100, 128, 96,
                                    fast_dct_scale=fast)
        np.testing.assert_array_equal(port[0], ref[0])
        assert port[1:] == ref[1:]
