"""Progressive JPEG in the port's codec (`csrc/codec.cpp`) against
OpenCV on the CPU: bodies cv2.imencode writes with IMWRITE_JPEG_PROGRESSIVE
(libjpeg-turbo's own scan script: DC first and refine, AC bands, AC
refinement, EOB runs) decode pixel-equal to cv2.imdecode over sizes,
sampling modes, grey, qualities and restart intervals; scan scripts cut
from them, and from their arithmetic twins, decode as cv2 decodes them,
libjpeg-turbo's block smoothing included; cut and corrupted bodies give
cv2's pixels or a ValueError, never a crash; the committed bodies
(tests/torch_port_data/) decode to the digests `chip_smoke.py` checks on
the card's host; and the server answers a progressive, an arithmetic and
a CMYK POST as it answers the PNG of the same pixels."""
import io
import json
import sys
import threading
import urllib.request
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
from offsetguided_tpu_torch.data import codec  # noqa: E402

SAMPLING = {'444': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            '422': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            '420': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            '440': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            '411': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def image(h, w, seed, kind):
    """Seeded uint8 RGB: noise (kind 0) or a smooth field with noise."""
    rng = np.random.RandomState(seed)
    if kind == 0:
        return rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([xx * 3.0 + yy, yy * 2.0, (xx + 2 * yy) * 1.5], -1)
    return np.clip(base % 256 + rng.randn(h, w, 3) * 10, 0,
                   255).astype(np.uint8)


def progressive(rgb, quality=90, sampling='420', restart=0):
    """cv2.imencode's progressive body of RGB (or grey) pixels."""
    src = rgb if rgb.ndim == 2 else rgb[:, :, ::-1]
    ok, buf = cv2.imencode('.jpg', src, [
        cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
        cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
    assert ok
    body = buf.tobytes()
    assert b'\xff\xc2' in body
    return body


def cv_decode(body):
    """cv2.imdecode(IMREAD_COLOR) in RGB, or None."""
    out = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
    return None if out is None else out[:, :, ::-1]


@settings(max_examples=60, deadline=None)
@given(h=st.integers(1, 70), w=st.integers(1, 70),
       sampling=st.sampled_from(sorted(SAMPLING) + ['grey']),
       quality=st.integers(1, 100), restart=st.sampled_from([0, 1, 2, 7]),
       kind=st.integers(0, 1), seed=st.integers(0, 10 ** 6))
def test_progressive_decode_equals_cv2(h, w, sampling, quality, restart,
                                       kind, seed):
    """Sizes from 1x1 up (odd, and off the 8 / 16 grids), every sampling
    mode and grey, qualities 1-100, restart intervals, noise and smooth
    scenes: the port's pixels are cv2.imdecode's."""
    img = image(h, w, seed, kind)
    if sampling == 'grey':
        img, sampling = img[:, :, 1], '420'
    body = progressive(img, quality, sampling, restart)
    assert np.array_equal(codec.decode(body), cv_decode(body))


@pytest.mark.parametrize('sampling', sorted(SAMPLING))
@pytest.mark.parametrize('h,w', [(480, 640), (123, 77)])
def test_progressive_decode_every_sampling(sampling, h, w):
    body = progressive(image(h, w, 1, 1), 95, sampling)
    assert np.array_equal(codec.decode(body), cv_decode(body))
    info = codec.decode(body).shape
    assert info == (h, w, 3)


def segments(body: bytes):
    """The body's marker segments after SOI, each scan with its entropy
    data (up to the next marker other than RSTn)."""
    out, i = [], 2
    while i < len(body):
        assert body[i] == 0xFF, i
        m = body[i + 1]
        if m == 0xD9:
            out.append((m, body[i:i + 2]))
            break
        j = i + 2 + int.from_bytes(body[i + 2:i + 4], 'big')
        if m == 0xDA:
            while not (body[j] == 0xFF and body[j + 1] != 0
                       and not 0xD0 <= body[j + 1] <= 0xD7):
                j += 1
        out.append((m, body[i:j]))
        i = j
    return out


def scans(body: bytes):
    """[(Ss, Se, Ah, Al, component ids)] of each scan, in order."""
    out = []
    for m, seg in segments(body):
        if m == 0xDA:
            ns = seg[4]
            ss, se, a = seg[5 + 2 * ns], seg[6 + 2 * ns], seg[7 + 2 * ns]
            out.append((ss, se, a >> 4, a & 15,
                        tuple(seg[5 + 2 * k] for k in range(ns))))
    return out


def without_scans(body: bytes, drop) -> bytes:
    """The body with the scans of index `drop` left out."""
    segs, k, out = segments(body), 0, [b'\xff\xd8']
    for m, seg in segs:
        if m == 0xDA:
            k += 1
            if k - 1 in drop:
                continue
        out.append(seg)
    return b''.join(out)


def would_smooth(script, n_comp):
    """libjpeg-turbo's smoothing_ok over a scan script (quantizers
    nonzero): some component's DC is sent and one of its coefficients
    1-9 has coef_bits != 0 after the last scan."""
    bits = np.full((n_comp, 64), -1)
    for ss, se, ah, al, comps in script:
        for c in comps:
            bits[c - 1, ss:se + 1] = al
    if (bits[:, 0] < 0).any():
        return False
    return bool((bits[:, 1:10] != 0).any())


def port_or_none(body):
    """codec.decode, or None where it raises a ValueError."""
    try:
        return codec.decode(body)
    except ValueError:
        return None


@pytest.mark.parametrize('coding', ['huffman', 'arithmetic'])
@pytest.mark.parametrize('grey', [False, True])
def test_cut_scan_scripts(grey, coding):
    """Every single scan left out of cv2's script (or of its arithmetic
    twin's), and every tail of it cut off: the pixels are cv2.imdecode's
    for every variant -- where libjpeg-turbo smooths the blocks (an AC
    band of the first nine coefficients not fully refined, e.g. the last
    luma refinement left out; with no AC data at all the DC interpolated
    too) as well as where it does not."""
    img = image(45, 61, 4, 1)
    body = progressive(img[:, :, 0] if grey else img, 85, '420', 3)
    if coding == 'arithmetic':
        body = W.transcode(body)
    script = scans(body)
    n_comp = 1 if grey else 3
    variants = [(i,) for i in range(len(script))]
    variants += [tuple(range(k, len(script))) for k in range(1, len(script))]
    smoothed = 0
    for drop in variants:
        cut = without_scans(body, drop)
        kept = [s for i, s in enumerate(script) if i not in drop]
        ref = cv_decode(cut)
        assert ref is not None, drop
        px = codec.decode(cut)
        assert np.array_equal(px, ref), drop
        smoothed += would_smooth(kept, n_comp)
    assert 2 <= smoothed < len(variants), smoothed


@pytest.mark.parametrize('coding', ['huffman', 'arithmetic'])
def test_cut_and_corrupt_bodies_never_crash(coding):
    """Cuts at every 7th byte (with and without an EOI put back) and
    random byte flips, of a progressive body or of its arithmetic twin: a
    body that ends before its EOI is refused as truncated, as cv2 gives
    nothing for it; a cut one with the EOI put back decodes as cv2 does
    (Huffman data stops at the cut, arithmetic data reads zero bytes past
    it; libjpeg smooths what the last scans left unrefined), or is refused
    where cv2 gives nothing; a flipped one gives a ValueError or pixels,
    never a crash, and cv2's pixels where both decode."""
    img = image(40, 56, 5, 1)
    body = progressive(img, 80, '420', 2)
    if coding == 'arithmetic':
        body = W.transcode(body)
    shape = img.shape
    same = 0
    for cut in range(2, len(body) - 2, 7):
        with pytest.raises(ValueError):
            codec.decode(body[:cut])
        fixed = body[:cut] + b'\xff\xd9'
        px, ref = port_or_none(fixed), cv_decode(fixed)
        assert (px is None) == (ref is None), cut
        if px is not None:
            assert px.shape == shape and np.array_equal(px, ref), cut
            same += 1
    assert same > 0
    rng = np.random.RandomState(0)
    for _ in range(300):
        bad = bytearray(body)
        for i in rng.randint(2, len(body), rng.randint(1, 6)):
            bad[i] = rng.randint(0, 256)
        px = port_or_none(bytes(bad))
        if px is None:
            continue
        assert px.dtype == np.uint8 and px.ndim == 3
        ref = cv_decode(bytes(bad))
        assert ref is None or np.array_equal(px, ref)


def test_truncated_baseline_refused_like_cv2():
    """A baseline body without its EOI is refused too (cv2.imdecode gives
    nothing for it); with the EOI put back after cut entropy data, the
    MCUs after the cut stay grey, as cv2 decodes them."""
    body = codec.encode_jpeg(image(48, 64, 6, 1), 90, '420', 2)
    for cut in (len(body) - 2, len(body) // 2):
        assert cv_decode(body[:cut]) is None
        with pytest.raises(ValueError, match='truncated'):
            codec.decode(body[:cut])
        fixed = body[:cut] + b'\xff\xd9'
        assert np.array_equal(codec.decode(fixed), cv_decode(fixed))


def test_committed_progressive_bodies():
    """The bodies `chip_smoke.py` [codec] decodes on the card's host: the
    pinned digests, the pixels cv2.imdecode's; the 480x640 scene is
    'jpeg 420 q95''s scene and decodes to its pixels."""
    bodies = dict(chip_smoke.progressive_cases())
    assert list(bodies) == list(chip_smoke.PROGRESSIVE_DIGESTS)
    for name, body in bodies.items():
        assert b'\xff\xc2' in body, name
        px = codec.decode(body)
        assert np.array_equal(px, cv_decode(body)), name
        assert chip_smoke.codec_digests(body, px) == \
            chip_smoke.PROGRESSIVE_DIGESTS[name][1:], name
    assert (chip_smoke.PROGRESSIVE_DIGESTS['progressive 420 q95'][2]
            == chip_smoke.CODEC_DIGESTS['jpeg 420 q95'][1])
    assert b'\xff\xdd' in bodies['progressive 420 q50 restart 2']


@pytest.fixture(scope='module')
def tiny_server():
    """`cli.serve` on the CPU (tiny model, random weights) on port 0."""
    from offsetguided_tpu_torch.cli import serve
    args = serve.cli(['--device', 'cpu', '--debug-tiny-model', '--long-edge',
                      '128', '--batch-size', '2', '--port', '0',
                      '--person-thre', '0.0', '--topk', '8'])
    cfg = serve.model_config(args)
    infer, skeleton, eval_cfg, _ = serve.build_infer(
        args, cfg, serve.load_weights(args, cfg), 'cpu')
    server = serve.make_server(args, infer, skeleton, eval_cfg)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield f'http://localhost:{server.server_address[1]}/v1/poses'
    server.shutdown()
    server.server_close()


def pillow_cmyk(rgb, subsampling=2, quality=90):
    """Pillow's CMYK JPEG body (Adobe marker, transform 0) of RGB pixels."""
    buf = io.BytesIO()
    Image.fromarray(rgb).convert('CMYK').save(buf, 'JPEG', quality=quality,
                                              subsampling=subsampling)
    return buf.getvalue()


@pytest.mark.parametrize('kind', ['progressive', 'arithmetic', 'cmyk'])
def test_server_answers_progressive_as_png(tiny_server, kind):
    """A progressive, an arithmetic-coded and a Pillow CMYK POST are
    answered 200 (each was 400, 'undecodable image'), with the poses of
    the PNG of the same pixels."""
    img = chip_smoke.codec_image(96, 128, seed=9)
    body = progressive(img, 90, '420')
    if kind == 'arithmetic':
        body = W.transcode(body)
    elif kind == 'cmyk':
        body = pillow_cmyk(img)
    png = codec.encode_png(codec.decode(body))
    answers = []
    for b in (body, png):
        req = urllib.request.Request(tiny_server, data=b, method='POST')
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
            answers.append(json.loads(r.read()))
    for a in answers:
        del a['latency_ms']
    assert answers[0] == answers[1] and answers[0]['poses']
