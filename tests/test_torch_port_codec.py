"""The port's image codec (`data/codec.py` + `csrc/codec.cpp`) against
OpenCV on the CPU: JPEG decode equal to cv2.imdecode(IMREAD_COLOR) pixel
for pixel (qualities, every sampling mode, grey, restart intervals, sizes
down to 1x1, EXIF orientation), the JPEG processes cv2 refuses (lossless,
hierarchical, 12-bit, two components, fractional sampling) refused with a
ValueError, PNG decode equal to cv2's for every colour type and depth,
the encoders' bodies decoding equal in cv2 and in the port (the JPEG
encoder's bytes equal to cv2.imencode's), `read_image` equal to the JAX
package's cv2 read without cv2, and the digests `chip_smoke.py`'s
[codec] phase checks on the card's host."""
import io
import struct
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / 'tests'))

import chip_smoke  # noqa: E402
import torch_port_jpeg_writer as W  # noqa: E402
from offsetguided_tpu_torch.data import codec, coco  # noqa: E402
from offsetguided_tpu_torch.data.synthetic import make_hard_dataset  # noqa: E402

SAMPLING = {'444': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            '422': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            '420': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            '440': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            '411': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
SIZES = ((1, 1), (17, 3), (97, 153), (480, 640))


def image(h, w, seed, kind=0):
    """Seeded uint8 RGB: noise, a gradient pattern or a smooth field."""
    rng = np.random.RandomState(seed)
    if kind == 0:
        return rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[:h, :w]
    if kind == 1:
        return np.stack([(xx * 7 + yy * 3) % 256, (yy * 5) % 256,
                         (xx * yy) % 256], -1).astype(np.uint8)
    return np.clip(rng.randn(h, w, 3) * 40 + 128, 0, 255).astype(np.uint8)


def cv_jpeg(rgb, quality=95, sampling='420', restart=0, extra=None):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    for k, v in (extra or {}).items():
        params += [k, v]
    src = rgb if rgb.ndim == 2 else rgb[:, :, ::-1]
    ok, buf = cv2.imencode('.jpg', src, params)
    assert ok
    return buf.tobytes()


def cv_decode(body):
    return cv2.imdecode(np.frombuffer(body, np.uint8),
                        cv2.IMREAD_COLOR)[:, :, ::-1]


def assert_decodes_as_cv2(body):
    got = codec.decode(body)
    ref = cv_decode(body)
    assert got.shape == ref.shape and got.dtype == np.uint8
    assert np.array_equal(got, ref), np.argwhere(got != ref)[:5].tolist()


@settings(max_examples=60, deadline=None)
@given(size=st.sampled_from(SIZES), quality=st.sampled_from([50, 75, 95, 100]),
       sampling=st.sampled_from(sorted(SAMPLING)),
       restart=st.sampled_from([0, 0, 1, 5]), grey=st.booleans(),
       kind=st.integers(0, 2), seed=st.integers(0, 2 ** 16))
def test_jpeg_decode_equals_cv2(size, quality, sampling, restart, grey, kind,
                                seed):
    img = image(*size, seed, kind)
    assert_decodes_as_cv2(cv_jpeg(img[:, :, 0] if grey else img, quality,
                                  sampling, restart))


@pytest.mark.parametrize('sampling', sorted(SAMPLING))
@pytest.mark.parametrize('h,w', [(97, 153), (16, 16), (9, 31), (33, 2)])
def test_jpeg_decode_every_sampling(sampling, h, w):
    """Each sampling mode at sizes that end inside an MCU, on an odd
    column, at a component width of 2 or less (box upsampling) and on
    whole MCUs."""
    for kind in range(3):
        assert_decodes_as_cv2(cv_jpeg(image(h, w, 3, kind), 95, sampling))


def test_jpeg_decode_tables_and_restarts():
    """Optimized Huffman tables, separate luma / chroma qualities, a
    restart marker after every MCU, grey at quality 100."""
    img = image(75, 130, 4, 2)
    assert_decodes_as_cv2(cv_jpeg(img, 90, '420', 0,
                                  {cv2.IMWRITE_JPEG_OPTIMIZE: 1}))
    assert_decodes_as_cv2(cv_jpeg(img, 90, '420', 0,
                                  {cv2.IMWRITE_JPEG_LUMA_QUALITY: 80,
                                   cv2.IMWRITE_JPEG_CHROMA_QUALITY: 30}))
    assert_decodes_as_cv2(cv_jpeg(img, 60, '422', restart=1))
    assert_decodes_as_cv2(cv_jpeg(img[:, :, 2], 100, '444', restart=2))


def exif_app1(orientation: int, little: bool) -> bytes:
    e = '<' if little else '>'
    tiff = ((b'II' if little else b'MM') + struct.pack(e + 'HI', 42, 8)
            + struct.pack(e + 'H', 1)
            + struct.pack(e + 'HHIHH', 0x0112, 3, 1, orientation, 0)
            + struct.pack(e + 'I', 0))
    body = b'Exif\0\0' + tiff
    return b'\xff\xe1' + struct.pack('>H', len(body) + 2) + body


@pytest.mark.parametrize('orientation', range(1, 9))
def test_jpeg_exif_orientation_as_cv2(orientation, tmp_path):
    """cv2.imdecode and cv2.imread turn the image by its EXIF orientation;
    so does the codec."""
    base = cv_jpeg(image(13, 21, orientation), 95, '420')
    for little in (True, False):
        body = base[:2] + exif_app1(orientation, little) + base[2:]
        assert_decodes_as_cv2(body)
        path = tmp_path / 'o.jpg'
        path.write_bytes(body)
        assert np.array_equal(coco.read_image(str(path)),
                              cv2.imread(str(path))[:, :, ::-1])


def _refused_body(case: str) -> bytes:
    """A body of a JPEG process cv2.imdecode does not read, written as
    that process writes it (the hierarchical one: a baseline body whose
    frame is marked SOF6, differential progressive)."""
    grey = image(20, 27, 3, 1)[:, :, 0]
    if case == 'lossless':
        return W.write_lossless(grey)
    if case == 'hierarchical':
        body = cv_jpeg(image(40, 56, 5, 2))
        i = body.index(b'\xff\xc0')
        return body[:i + 1] + b'\xc6' + body[i + 2:]
    if case == '12-bit':
        samples = np.random.RandomState(0).randn(20, 27) * 300 + 2048
        frame = W.frame_from_planes(
            [np.clip(samples, 0, 4095)], 27, 20, [(1, 1)],
            {0: W.quant_table(90, precision=12)}, [0], precision=12)
        return W.write_huffman(frame)
    factors = {'two components': [(1, 1), (1, 1)],
               'fractional sampling': [(3, 1), (2, 1), (1, 1)]}[case]
    frame = W.frame_from_planes([grey] * len(factors), 27, 20, factors,
                                {0: W.quant_table(90)}, [0] * len(factors))
    return W.write_huffman(frame)


@pytest.mark.parametrize('case,match', [
    ('hierarchical', 'hierarchical'), ('lossless', 'lossless'),
    ('12-bit', '12-bit'), ('two components', 'components'),
    ('fractional sampling', 'sampling'), ('not an image', None)])
def test_unsupported_jpeg_raises(case, match):
    """Each JPEG process the codec refuses is one cv2.imdecode refuses: a
    later cv2 that reads one of them shows here. Empty, cut and non-image
    bodies are refused too."""
    if case == 'not an image':
        for bad in (b'', b'not an image', b'\xff\xd8\xff',
                    b'\x89PNG\r\n\x1a\nxx'):
            with pytest.raises(ValueError):
                codec.decode(bad)
        return
    body = _refused_body(case)
    assert cv2.imdecode(np.frombuffer(body, np.uint8),
                        cv2.IMREAD_COLOR) is None
    with pytest.raises(ValueError, match=match):
        codec.decode(body)
    if case == 'lossless':       # a real lossless body: Pillow reads it
        assert np.array_equal(np.asarray(Image.open(io.BytesIO(body))),
                              image(20, 27, 3, 1)[:, :, 0])


def test_oversized_bodies_refused():
    """A few bytes that declare more than 2**28 pixels are refused before
    anything is allocated for them."""
    i = cv_jpeg(image(8, 8, 0)).index(b'\xff\xc0')
    body = bytearray(cv_jpeg(image(8, 8, 0)))
    body[i + 5:i + 9] = struct.pack('>HH', 65535, 65535)   # height, width
    with pytest.raises(ValueError, match='image size'):
        codec.decode(bytes(body))
    png = codec._PNG_SIG + codec._png_chunk(b'IHDR', struct.pack(
        '>IIBBBBB', 20000, 20000, 8, 2, 0, 0, 0)) + codec._png_chunk(
        b'IDAT', zlib.compress(b'')) + codec._png_chunk(b'IEND', b'')
    with pytest.raises(ValueError, match='image size'):
        codec.decode(png)
    with pytest.raises(ValueError, match='image size'):
        codec.encode_jpeg(np.zeros((16385, 16384), np.uint8))


# ---------------------------------------------------------------- PNG

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered(rows: np.ndarray, bpp: int, rng) -> bytes:
    """Scanlines, each with a random filter type of the five."""
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for r in rows.astype(np.int64):
        t = rng.randint(5)
        f = np.zeros_like(r)
        for i in range(len(r)):
            a = r[i - bpp] if i >= bpp else 0
            c = prev[i - bpp] if i >= bpp else 0
            pred = (0, a, prev[i], (a + prev[i]) // 2,
                    _paeth(a, prev[i], c))[t]
            f[i] = (r[i] - pred) % 256
        out.append(bytes([t]) + f.astype(np.uint8).tobytes())
        prev = r
    return b''.join(out)


def _packed(samples: np.ndarray, depth: int) -> np.ndarray:
    if depth == 16:
        return samples.astype('>u2').view(np.uint8).reshape(
            samples.shape[0], -1)
    if depth == 8:
        return samples.astype(np.uint8)
    bits = ((samples[..., None] >> np.arange(depth - 1, -1, -1)) & 1
            ).reshape(samples.shape[0], -1)
    bits = np.pad(bits, ((0, 0), (0, (-bits.shape[1]) % 8)))
    return np.packbits(bits.astype(np.uint8), axis=1)


def make_png(h, w, ctype, depth, interlace, trns, seed) -> bytes:
    """A PNG body of seeded samples, random filters, split IDAT chunks."""
    rng = np.random.RandomState(seed)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    chunk = codec._png_chunk
    head = chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, depth, ctype, 0, 0,
                                      interlace))
    if ctype == 3:
        n = rng.randint(1, min(256, 1 << depth) + 1)
        head += chunk(b'PLTE', rng.randint(0, 256, (n, 3)).astype(
            np.uint8).tobytes())
        if trns:
            head += chunk(b'tRNS', rng.randint(0, 256, n).astype(
                np.uint8).tobytes())
        px = rng.randint(0, n, (h, w, 1))
    else:
        px = rng.randint(0, 1 << depth, (h, w, ch))
        if trns and ctype in (0, 2):
            head += chunk(b'tRNS', bytes(2 * ch))
    bpp = max(1, ch * depth // 8)
    passes = codec._ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b''
    for r0, c0, dr, dc in passes:
        sub = px[r0::dr, c0::dc]
        if sub.size:
            raw += _filtered(_packed(sub.reshape(sub.shape[0], -1), depth),
                             bpp, rng)
    z = zlib.compress(raw)
    cut = len(z) // 2
    return (codec._PNG_SIG + head + chunk(b'IDAT', z[:cut])
            + chunk(b'IDAT', z[cut:]) + chunk(b'IEND', b''))


PNG_KINDS = {'grey1': (0, 1), 'grey2': (0, 2), 'grey4': (0, 4),
             'grey8': (0, 8), 'grey16': (0, 16), 'rgb8': (2, 8),
             'rgb16': (2, 16), 'palette1': (3, 1), 'palette4': (3, 4),
             'palette8': (3, 8), 'grey_alpha8': (4, 8),
             'grey_alpha16': (4, 16), 'rgba8': (6, 8), 'rgba16': (6, 16)}


@pytest.mark.parametrize('kind', sorted(PNG_KINDS))
def test_png_decode_equals_cv2(kind):
    ctype, depth = PNG_KINDS[kind]
    for seed, (h, w, interlace, trns) in enumerate(
            [(1, 1, 0, 0), (23, 37, 0, 1), (19, 11, 1, 0)]):
        assert_decodes_as_cv2(make_png(h, w, ctype, depth, interlace, trns,
                                       seed))


@pytest.mark.parametrize('shape,dtype', [((30, 41), np.uint8),
                                         ((30, 41, 3), np.uint8),
                                         ((30, 41, 4), np.uint8),
                                         ((30, 41, 3), np.uint16),
                                         ((30, 41), np.uint16)])
def test_png_decode_cv2_written(shape, dtype):
    rng = np.random.RandomState(7)
    arr = rng.randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    ok, buf = cv2.imencode('.png', arr)
    assert ok
    assert_decodes_as_cv2(buf.tobytes())


# ------------------------------------------------------------ encoders

@pytest.mark.parametrize('sampling', sorted(SAMPLING))
def test_jpeg_encoder_equals_cv2(sampling):
    """The encoder writes cv2.imencode's bytes (so its coefficients are
    libjpeg-turbo's), at several qualities, sizes and restart intervals;
    its bodies decode equal in cv2 and in the port."""
    for i, ((h, w), q, rst) in enumerate([((97, 153), 95, 0),
                                         ((17, 3), 50, 1), ((1, 1), 100, 0),
                                         ((40, 70), 75, 4)]):
        img = image(h, w, i, i % 3)
        body = codec.encode_jpeg(img, q, sampling, rst)
        assert body == cv_jpeg(img, q, sampling, rst)
        assert_decodes_as_cv2(body)
    grey = image(29, 45, 9, 2)[:, :, 0]
    body = codec.encode_jpeg(grey, 90)
    assert body == cv_jpeg(grey, 90, '420')
    assert_decodes_as_cv2(body)


def test_jpeg_encoder_error_on_smooth_scene():
    """At quality 95 the round trip of a smooth painted scene is within
    1.5 grey levels, mean (measured: 0.75; the hard set's backgrounds are
    uniform noise, which no quality-95 JPEG keeps that close)."""
    from offsetguided_tpu_torch.data.draw import circle, line3
    yy, xx = np.mgrid[:480, :640]
    img = np.stack([128 + 60 * np.sin(xx / 37) * np.cos(yy / 23),
                    128 + 50 * np.sin((xx + yy) / 51),
                    100 + 40 * np.cos(xx / 29)], -1).astype(np.uint8)
    line3(img, (100, 100), (300, 400), (210, 60, 60))
    line3(img, (400, 50), (420, 300), (210, 60, 60))
    circle(img, 300, 400, 3, (60, 200, 60))
    body = codec.encode_jpeg(img, 95)
    assert_decodes_as_cv2(body)
    err = np.abs(codec.decode(body).astype(int) - img).mean()
    assert err <= 1.5, err


def test_png_encoder_lossless():
    for img in (image(33, 47, 1, 0), image(33, 47, 2, 1)[:, :, 0]):
        body = codec.encode_png(img)
        rgb = img if img.ndim == 3 else np.repeat(img[..., None], 3, 2)
        assert np.array_equal(codec.decode(body), rgb)
        assert np.array_equal(cv_decode(body), rgb)


# ----------------------------------------------------------- read_image

@pytest.fixture(scope='module')
def image_files(tmp_path_factory):
    root = tmp_path_factory.mktemp('files')
    img = image(45, 70, 11, 2)
    paths = {}
    for ext in ('jpg', 'png'):       # written by cv2, as the JAX package
        paths[ext] = str(root / f'a.{ext}')
        cv2.imwrite(paths[ext], img[:, :, ::-1])
    paths['npy'] = str(root / 'a.npy')
    np.save(paths['npy'], img)
    return paths


@pytest.mark.parametrize('ext', ['jpg', 'png', 'npy'])
def test_read_image_equals_jax_reader(image_files, ext):
    """The JAX package reads with cv2.imread + BGR2RGB (its harness'
    `_load_eval_image`); `.npy` it does not read, numpy does."""
    path = image_files[ext]
    ref = (np.load(path) if ext == 'npy' else
           cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB))
    assert np.array_equal(coco.read_image(path), ref)
    assert coco.read_image(path + '.missing') is None


def test_read_image_without_cv2(image_files, monkeypatch):
    ref = cv2.cvtColor(cv2.imread(image_files['jpg']), cv2.COLOR_BGR2RGB)
    monkeypatch.setitem(sys.modules, 'cv2', None)
    with pytest.raises(ImportError):
        import cv2 as _  # noqa: F401
    assert np.array_equal(coco.read_image(image_files['jpg']), ref)


def test_hard_set_jpeg_reads_as_jax(tmp_path):
    """The painted hard set written as JPEG by the codec: the port's reader
    gives cv2.imread's pixels."""
    img_dir, _ = make_hard_dataset(str(tmp_path), n_images=3, ext='jpg')
    for f in sorted(Path(img_dir).iterdir()):
        assert np.array_equal(coco.read_image(str(f)), cv2.cvtColor(
            cv2.imread(str(f)), cv2.COLOR_BGR2RGB))


# ---------------------------------------------------- the [codec] digests

def test_chip_smoke_codec_digests():
    """The bodies `chip_smoke.py` decodes on the card's host: their
    digests and their pixels' are the pinned ones, and the pixels are
    cv2.imdecode's."""
    cases = chip_smoke.codec_cases()
    assert [n for n, _ in cases] == list(chip_smoke.CODEC_DIGESTS)
    for name, body in cases:
        px = codec.decode(body)
        assert np.array_equal(px, cv_decode(body)), name
        want = chip_smoke.CODEC_DIGESTS[name]
        got = chip_smoke.codec_digests(body, px)
        assert got[1] == want[1], name
        if want[0] is not None:
            assert got[0] == want[0], name
