"""The port's image codec (csrc/imgcodec.cpp through data/codec.py) and its
numpy twins (data/png.py unfilter_rows, data/resample.py, data/jpeg.py
decode_jpeg) against the JAX package's native codec
(`langsplat4d.native.load_image_chw`: libpng, libjpeg and PIL's resample
arithmetic) and against PIL where the JAX codec does not reach: PNG in
each filter and colour type, the resample in four filters up and down on
RGB, RGBA, grey and grey + alpha, JPEG written by PIL at 4:4:4, 4:2:2 and
4:2:0, grey and with restart intervals, all byte-exact (float32 k / 255
equal); the JPEGs it refuses; `load_image` and the eval's frames through
it; and no path on which the readers decode without the compiled codec."""
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from PIL import Image

from langsplat4d import native
from langsplat4d.data.readers import load_image as j_load_image
from langsplat4d_torch.data import codec, jpeg
from langsplat4d_torch.data import png as P
from langsplat4d_torch.data import resample as RS
from langsplat4d_torch.data.readers import load_image
from langsplat4d_torch.utils import build

MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}
PIL_FILTERS = {"box": Image.BOX, "bilinear": Image.BILINEAR,
               "bicubic": Image.BICUBIC, "lanczos": Image.LANCZOS}


def _image(h, w, c, seed=0):
    """Smooth gradients plus noise (varied alpha where there is one)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = ((3 * xx + 5 * yy)[..., None] // 2 + 40 * np.arange(c)
           + rng.integers(0, 40, (h, w, c))) % 256
    if c in (2, 4):
        img[..., -1] = rng.integers(0, 256, (h, w))
        img[: h // 4, :, -1] = 255
        img[h // 4: h // 3, :, -1] = 0
    return img.astype(np.uint8)


def _chw(img):
    return np.ascontiguousarray(img.transpose(2, 0, 1)).astype(
        np.float32) / np.float32(255.0)


def _save_pil(path, img, **kw):
    c = img.shape[2]
    mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[c]
    Image.fromarray(img if c > 1 else img[..., 0], mode).save(path, **kw)


@pytest.mark.parametrize("c", [1, 2, 3, 4])
@pytest.mark.parametrize("filters", ["0", "1", "2", "3", "4", "mixed",
                                     "adaptive"])
def test_png_filters_match_jax_and_the_twin(c, filters, tmp_path):
    img = _image(29, 41, c, seed=c)
    ft = {"mixed": np.random.default_rng(c).integers(0, 5, 29),
          "adaptive": P.adaptive_filters(img)}.get(filters)
    data = P.png_bytes(img, int(filters) if ft is None else ft)
    path = str(tmp_path / "a.png")
    with open(path, "wb") as f:
        f.write(data)
    got = codec.decode_png(data)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(P.decode_png(data), got)
    np.testing.assert_array_equal(load_image(path), native.load_image_chw(
        path))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_png_written_by_pil_matches_jax(mode, tmp_path):
    img = _image(37, 53, MODES[mode], seed=len(mode))
    path = str(tmp_path / "a.png")
    _save_pil(path, img, optimize=True)
    np.testing.assert_array_equal(load_image(path), native.load_image_chw(
        path))
    np.testing.assert_array_equal(load_image(path), j_load_image(path))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("filt", sorted(PIL_FILTERS))
@pytest.mark.parametrize("size", [(23, 17), (90, 70), (57, 29), (41, 60)])
def test_resample_is_byte_exact(mode, filt, size, tmp_path):
    """Down, up and one axis at a time: the codec equals the JAX codec and
    PIL, and the twin equals the codec."""
    c = MODES[mode]
    img = _image(41, 57, c, seed=7 * c)
    path = str(tmp_path / "a.png")
    _save_pil(path, img)
    got = codec.resample(img, size, filt)
    np.testing.assert_array_equal(RS.resample(img, size, filt), got)
    want = np.asarray(Image.open(path).resize(size, PIL_FILTERS[filt]))
    np.testing.assert_array_equal(got, want.reshape(got.shape))
    np.testing.assert_array_equal(
        load_image(path, resize=size, filt=filt),
        native.load_image_chw(path, resize=size, filt=filt))


def test_resample_to_the_same_size_is_a_copy():
    img = _image(9, 11, 4)
    out = codec.resample(img, (11, 9), "lanczos")
    np.testing.assert_array_equal(out, img)
    np.testing.assert_array_equal(RS.resample(img, (11, 9), "lanczos"), img)
    with pytest.raises(ValueError, match="unknown filter"):
        codec.resample(img, (5, 5), "hamming")


@pytest.mark.parametrize("subsampling", [0, 1, 2])     # 4:4:4, 4:2:2, 4:2:0
@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("hw", [(97, 143), (17, 9), (8, 8), (33, 2)])
def test_jpeg_by_pil_matches_jax(subsampling, quality, hw, tmp_path):
    """libjpeg's bytes, at odd sizes too (partial MCUs, chroma planes of 1-2
    columns, where libjpeg replicates instead of interpolating)."""
    img = _image(*hw, 3, seed=quality + subsampling)
    path = str(tmp_path / "a.jpg")
    _save_pil(path, img, quality=quality, subsampling=subsampling)
    with open(path, "rb") as f:
        data = f.read()
    got = codec.decode_jpeg(data, path)
    np.testing.assert_array_equal(got, np.asarray(Image.open(path)))
    np.testing.assert_array_equal(jpeg.decode_jpeg(data, path), got)
    np.testing.assert_array_equal(load_image(path), native.load_image_chw(
        path))


@pytest.mark.parametrize("kw", [dict(), dict(restart_marker_blocks=3),
                                dict(restart_marker_rows=1)])
def test_jpeg_grey_and_restart_intervals_match_jax(kw, tmp_path):
    for c, sub in ((1, 0), (3, 2)):
        img = _image(61, 77, c, seed=c)
        path = str(tmp_path / f"a{c}.jpg")
        _save_pil(path, img, quality=90, subsampling=sub, **kw)
        with open(path, "rb") as f:
            data = f.read()
        got = codec.decode_jpeg(data, path)
        np.testing.assert_array_equal(jpeg.decode_jpeg(data, path), got)
        np.testing.assert_array_equal(load_image(path),
                                      native.load_image_chw(path))


@pytest.mark.parametrize("restart", [0, 1, 7])
def test_port_encoder_restart_intervals_decode_as_libjpeg(restart, tmp_path):
    """The port's encoder (4:4:4) with a restart marker every `restart`
    MCUs: PIL reads what both decoders read."""
    img = _image(45, 61, 3, seed=restart)
    data = jpeg.jpeg_bytes(img, 95, restart=restart)
    path = str(tmp_path / "a.jpg")
    with open(path, "wb") as f:
        f.write(data)
    got = codec.decode_jpeg(data)
    np.testing.assert_array_equal(got, np.asarray(Image.open(path)))
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), got)
    assert (b"\xff\xdd" in data) == bool(restart)


def test_unsupported_jpegs_raise_and_name_the_file(tmp_path):
    img = _image(32, 40, 3)
    path = str(tmp_path / "progressive.jpg")
    _save_pil(path, img, progressive=True)
    with pytest.raises(NotImplementedError, match="progressive.jpg.*"
                                                  "progressive JPEG"):
        load_image(path)
    with open(path, "rb") as f:
        data = f.read()
    with pytest.raises(NotImplementedError, match="x.jpg: progressive"):
        jpeg.decode_jpeg(data, "x.jpg")
    cmyk = str(tmp_path / "cmyk.jpg")
    Image.fromarray(_image(16, 16, 4), "CMYK").save(cmyk)
    with pytest.raises(NotImplementedError, match="cmyk.jpg.*components"):
        load_image(cmyk)
    with pytest.raises(ValueError, match="corrupt"):
        codec.decode_jpeg(b"\xff\xd8\xff\xe0" + bytes(16), "bad.jpg")
    # a Huffman table with more codes of a length than fit (200 of 1 bit)
    evil = bytearray(jpeg.jpeg_bytes(img, 90))
    evil[evil.index(b"\xff\xc4") + 5] = 200
    with pytest.raises(ValueError, match="evil.jpg: corrupt"):
        codec.decode_jpeg(bytes(evil), "evil.jpg")
    bmp = str(tmp_path / "a.bmp")
    Image.fromarray(img).save(bmp)
    with pytest.raises(NotImplementedError, match="a.bmp: neither PNG nor"):
        load_image(bmp)


def test_no_fallback_without_a_compiler(tmp_path, monkeypatch):
    """Where the codec cannot be built, load_image raises and names the
    compilers it looked for; it never decodes through a twin."""
    path = str(tmp_path / "a.png")
    with open(path, "wb") as f:
        f.write(P.png_bytes(_image(5, 6, 3)))
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(codec.shutil, "which", lambda name: None)
    codec.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="c\\+\\+ and g\\+\\+"):
            load_image(path)
    finally:
        monkeypatch.undo()
        codec.load_library.cache_clear()
    np.testing.assert_array_equal(load_image(path), _chw(_image(5, 6, 3)))


def test_build_is_keyed_and_atomic(tmp_path, monkeypatch):
    """The library's name carries a hash of the source, the flags and the
    compiler; a build compiles in a directory of its own, renames the
    library into place and leaves nothing else behind."""
    monkeypatch.setattr(codec, "BUILD_DIR", tmp_path)
    lib = codec.build_library()
    assert lib.parent == tmp_path and lib.exists()
    assert lib == codec.library_path()
    assert lib.name.startswith("imgcodec_")
    assert "-ffp-contract=off" in codec.CXX_FLAGS
    assert [p.name for p in tmp_path.iterdir()] == [lib.name]
    assert codec.build_library() == lib                # found, not rebuilt
    assert [p.name for p in tmp_path.iterdir()] == [lib.name]


def test_first_use_on_four_threads_builds_once(tmp_path, monkeypatch):
    """The loop decodes a batch's misses on 4 threads, so the codec's first
    use may come on all of them at once: one compiles, the others wait for
    it, and each decodes the same bytes."""
    path = str(tmp_path / "a.png")
    img = _image(9, 11, 3)
    with open(path, "wb") as f:
        f.write(P.png_bytes(img))
    build_dir = tmp_path / "_build"
    monkeypatch.setattr(codec, "BUILD_DIR", build_dir)
    runs, popen = [], build.subprocess.Popen

    def counted(cmd, **kw):
        runs.append(cmd)
        return popen(cmd, **kw)
    monkeypatch.setattr(build.subprocess, "Popen", counted)
    codec.load_library.cache_clear()
    start = threading.Barrier(4)

    def first_use(_):
        start.wait()
        return codec.load_chw(path)
    try:
        with ThreadPoolExecutor(4) as ex:
            got = list(ex.map(first_use, range(4)))
    finally:
        codec.load_library.cache_clear()
    assert len(runs) == 1
    assert [p.name for p in build_dir.iterdir()] == [
        codec.library_path().name]
    for g in got:
        np.testing.assert_array_equal(g, _chw(img))


def test_eval_reads_jpeg_frames_as_cv2(tmp_path):
    """`--visualize_results` reads a JPEG frame as the JAX CLI's
    cv2.imread does (BGR reversed, k / 255), grey spread over three
    channels."""
    cv2 = pytest.importorskip("cv2")
    from langsplat4d_torch.eval.__main__ import read_frame
    for c, sub in ((3, 2), (3, 0), (1, 0)):
        path = str(tmp_path / f"00001_png.rf.{c}{sub}.jpg")
        _save_pil(path, _image(35, 47, c, seed=sub), quality=92,
                  subsampling=sub)
        want = (cv2.imread(path)[..., ::-1] / 255.0).astype(np.float32)
        np.testing.assert_array_equal(read_frame(path), want)
