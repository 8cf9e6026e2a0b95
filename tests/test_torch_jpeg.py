"""The port's baseline JPEG encoder (langsplat4d_torch/data/jpeg.py)
against PIL's decoder and cv2's encoder, and the eval's ground-truth masks
written as JPEG where the JAX package writes them through cv2."""
import io

import cv2
import numpy as np
import pytest
from PIL import Image

from langsplat4d_torch.data import jpeg as J


def _decode(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data))).astype(np.int64)


def _mask(seed=0, h=61, w=83):
    """A binary mask of a few rectangles and a disc, 0 / 255."""
    rng = np.random.default_rng(seed)
    m = np.zeros((h, w), np.uint8)
    for _ in range(4):
        y, x = rng.integers(0, h - 10), rng.integers(0, w - 10)
        m[y:y + rng.integers(4, 20), x:x + rng.integers(4, 30)] = 255
    yy, xx = np.mgrid[:h, :w]
    m[(yy - h / 2) ** 2 + (xx - w / 3) ** 2 < 80] = 255
    return m


def test_tables_are_the_annex_k_tables():
    """Each AC table codes EOB, ZRL and every (run, size) with size 1-10
    once; each code set is prefix-free (Kraft sum below 1, as T.81 keeps
    the all-ones code free); quality 50 is Annex K.1 itself."""
    for spec in (J.AC_LUMA, J.AC_CHROMA):
        assert sum(spec[0]) == len(spec[1]) == 162
        assert set(spec[1]) == {0x00, 0xF0} | {
            r << 4 | s for r in range(16) for s in range(1, 11)}
    for spec in (J.DC_LUMA, J.DC_CHROMA, J.AC_LUMA, J.AC_CHROMA):
        _, length = J.huffman_codes(spec)
        used = length[length > 0]
        assert (2.0 ** -used).sum() < 1
    np.testing.assert_array_equal(J.quant_table(J.LUMA_Q, 50), J.LUMA_Q)
    assert J.quant_table(J.LUMA_Q, 100).max() == 1


@pytest.mark.parametrize("quality,to_input,to_cv2", [(75, 32, 12),
                                                     (95, 6, 4)])
def test_grey_mask_decodes_near_cv2(quality, to_input, to_cv2):
    """PIL decodes the port's file of a 0/255 mask. Bounds, per quality:
    `to_input` grey levels against the input (the quantizer's error at a
    hard edge, where every frequency is present: cv2's own file is off by
    31 and 5, and is held to the same bound) and `to_cv2` against cv2's
    decoded file (the same quantization tables; the port's DCT is
    floating-point where libjpeg's is the integer islow one, so a
    coefficient on a rounding boundary quantizes one step apart, and
    quality 75's steps are 5x quality 95's)."""
    m = _mask()
    port = _decode(J.jpeg_bytes(m, quality))
    ok, buf = cv2.imencode(".jpg", m, [cv2.IMWRITE_JPEG_QUALITY, quality])
    ref = cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE).astype(np.int64)
    assert port.shape == m.shape
    assert np.abs(ref - m).max() <= to_input
    assert np.abs(port - m).max() <= to_input
    assert np.abs(port - ref).max() <= to_cv2


def test_rgb_decodes_near_the_input():
    """An RGB image of smooth colour, 4:4:4 at PIL's quality 75, odd sizes
    (blocks padded by edge repetition): PIL decodes it within 16 levels
    of the input, mean within 2.5 (quality 75's quantizer on smooth content
    with noise of 2 levels; PIL's own 4:2:0 file of the same image, 12 and
    2.24, is held to the same bounds)."""
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[:45, :71] / 20.0
    img = np.stack([np.sin(xx + c) * np.cos(yy - c) for c in range(3)], -1)
    img = np.clip((img * 0.5 + 0.5) * 255 + rng.normal(0, 2, img.shape),
                  0, 255).astype(np.uint8)
    port = _decode(J.jpeg_bytes(img, 75))
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    pil = _decode(buf.getvalue())
    for dec in (port, pil):
        assert dec.shape == img.shape
        err = np.abs(dec - img)
        assert err.max() <= 16 and err.mean() <= 2.5, (err.max(),
                                                      err.mean())


def test_eval_writes_ground_truth_masks_as_jpeg(tmp_path):
    """vis_mask_save writes a `.jpg` path as JPEG at cv2's default quality
    95, as the JAX package's cv2.imwrite does, and any other path as PNG:
    the port's file decodes within 4 levels of cv2's file (the bound
    above)."""
    from langsplat4d_torch.data.png import read_png
    from langsplat4d_torch.eval.evaluate import vis_mask_save
    m = (_mask(seed=3) > 0).astype(np.uint8)
    vis_mask_save(m, tmp_path / "gt" / "obj.jpg")
    data = (tmp_path / "gt" / "obj.jpg").read_bytes()
    assert data[:2] == b"\xff\xd8"
    ok, buf = cv2.imencode(".jpg", m * 255)
    ref = cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE).astype(np.int64)
    assert np.abs(_decode(data) - ref).max() <= 4
    vis_mask_save(m, tmp_path / "chosen_obj")
    np.testing.assert_array_equal(
        read_png(str(tmp_path / "chosen_obj.png")).reshape(m.shape), m * 255)
