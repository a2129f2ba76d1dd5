"""Arithmetic-coded and four-component JPEG, every sampling-factor
combination, and libjpeg's rules for markers and tables, in the port's
codec (`csrc/codec.cpp`) against OpenCV on the CPU.

The bodies come from `tests/torch_port_jpeg_writer.py` (arithmetic twins
of cv2-written Huffman bodies, YCCK and odd sampling from numpy
coefficients) and from Pillow (CMYK). Each arithmetic twin is first held
to cv2 itself -- cv2.imdecode of it equals cv2.imdecode of its Huffman
twin, byte for byte -- and then the port's pixels to cv2's. The committed
bodies `chip_smoke.py` [codec] decodes on the card's host are pinned here.
"""
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / 'tests'))

import chip_smoke  # noqa: E402
import torch_port_jpeg_writer as W  # noqa: E402
from offsetguided_tpu_torch.data import codec  # noqa: E402
from test_torch_port_codec import exif_app1  # noqa: E402
from test_torch_port_codec_progressive import (  # noqa: E402
    SAMPLING, cv_decode, image, pillow_cmyk, port_or_none)

# DC table -> (L, U), 16 + AC table -> Kx; None: no DAC (L 0, U 1, Kx 5)
DACS = {'default': None,
        'L1 U5 K12': {0: (1, 5), 1: (0, 2), 16: 12, 17: 3},
        'L0 U0 K0': {0: (0, 0), 1: (0, 0), 16: 0, 17: 0},
        'L15 U15 K63': {0: (15, 15), 1: (3, 9), 16: 63, 17: 63}}


def huffman(rgb, quality=90, sampling='420', restart=0, progressive=False):
    """cv2.imencode's Huffman body of RGB (or grey) pixels."""
    src = rgb if rgb.ndim == 2 else rgb[:, :, ::-1]
    ok, buf = cv2.imencode('.jpg', src, [
        cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive),
        cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
        cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
    assert ok
    return buf.tobytes()


def assert_twin(arith: bytes, huff: bytes):
    """cv2 reads the arithmetic body as its Huffman twin; so does the
    port."""
    ref = cv_decode(arith)
    assert ref is not None and np.array_equal(ref, cv_decode(huff))
    got = codec.decode(arith)
    assert np.array_equal(got, ref), np.argwhere(got != ref)[:5].tolist()


def assert_as_cv2(body):
    """The port refuses where cv2 gives nothing, else gives cv2's pixels."""
    ref, got = cv_decode(body), port_or_none(body)
    assert (got is None) == (ref is None)
    assert got is None or np.array_equal(got, ref)


# ---------------------------------------------------------- arithmetic

@settings(max_examples=60, deadline=None)
@given(h=st.integers(1, 70), w=st.integers(1, 70),
       sampling=st.sampled_from(sorted(SAMPLING)), grey=st.booleans(),
       progressive=st.booleans(), quality=st.integers(50, 100),
       restart=st.sampled_from([0, 1, 3]), dac=st.sampled_from(sorted(DACS)),
       seed=st.integers(0, 10 ** 6))
def test_arithmetic_twin_equals_cv2(h, w, sampling, grey, progressive,
                                    quality, restart, dac, seed):
    """SOF9 and SOF10 (DC first / refine, AC first / refine), grey and
    colour, every sampling mode, sizes from 1x1, restart intervals 0, 1
    and 3, qualities 50-100, default and non-default conditioning."""
    img = image(h, w, seed, 1)
    huff = huffman(img[:, :, 0] if grey else img, quality, sampling, restart,
                   progressive)
    arith = W.transcode(huff, dac=DACS[dac])
    assert (b'\xff\xca' if progressive else b'\xff\xc9') in arith
    assert_twin(arith, huff)


@pytest.mark.parametrize('progressive', [False, True])
def test_arithmetic_480x640(progressive):
    """The [codec] scene at 480x640, 4:2:0 q95: the sequential twin is the
    one `chip_smoke.py` transcodes on the card's host (its digest pinned),
    the progressive one that of cv2's progressive body."""
    if progressive:
        huff = dict(chip_smoke.progressive_cases())['progressive 420 q95']
        arith = W.transcode(huff)
    else:
        huff = dict(chip_smoke.codec_cases())['jpeg 420 q95']
        arith = chip_smoke.arithmetic_twin(huff)
        assert chip_smoke.codec_digests(arith, codec.decode(arith)) == (
            chip_smoke.ARITH_480_DIGEST,
            chip_smoke.CODEC_DIGESTS['jpeg 420 q95'][1])
    assert_twin(arith, huff)


@pytest.mark.parametrize('case', ['ycck 3x1 restart 1', 'cmyk 1x2 dac',
                                  'ycck 2x2 progressive'])
def test_arithmetic_odd_frames(case):
    """Writer frames cv2.imencode cannot write: four components with odd
    sampling factors, restart interval 1, non-default DAC, a progressive
    script of the writer's own; Huffman and arithmetic twins."""
    rng = np.random.RandomState(len(case))
    factors = {'ycck 3x1 restart 1': [(3, 1), (1, 1), (1, 1), (3, 1)],
               'cmyk 1x2 dac': [(1, 2), (1, 1), (1, 2), (1, 1)],
               'ycck 2x2 progressive': [(2, 2), (1, 1), (1, 1), (2, 2)]}[case]
    h, w = 37, 53
    hm, vm = max(f[0] for f in factors), max(f[1] for f in factors)
    planes = [np.clip(rng.randn(-(-h * v // vm), -(-w * f // hm)) * 25 + 128
                      + 50 * np.sin(np.arange(-(-w * f // hm)) / 4), 0, 255)
              for f, v in factors]
    frame = W.frame_from_planes(
        planes, w, h, factors, {0: W.quant_table(85),
                                1: W.quant_table(70, True)}, [0, 1, 1, 0],
        markers=[W.adobe(0 if case.startswith('cmyk') else 2)])
    huff = W.write_huffman(frame)
    if case == 'ycck 2x2 progressive':
        scans = [W.Scan((0, 1, 2, 3), 0, 0, 0, 1)] + [
            W.Scan((c,), 1, 63, 0, 1) for c in range(4)] + [
            W.Scan((0, 1, 2, 3), 0, 0, 1, 0)] + [
            W.Scan((c,), 1, 63, 1, 0) for c in range(4)]
        arith = W.write_arithmetic(frame, scans, progressive=True,
                                   restart=2)
    else:
        arith = W.write_arithmetic(
            frame, restart=1 if 'restart' in case else 0,
            dac={0: (2, 6), 1: (1, 1), 16: 1, 17: 40} if 'dac' in case
            else None)
    assert_twin(arith, huff)


@pytest.mark.parametrize('progressive', [False, True])
def test_arithmetic_cut_at_markers_as_cv2(progressive):
    """An arithmetic body cut at each of its markers, or inside its data
    (every 5th byte), with an EOI put back: the data reads zero bytes past
    the marker as libjpeg's does; the pixels are cv2's, or both refuse."""
    huff = huffman(image(40, 56, 3, 1), 80, '420', 2, progressive)
    arith = W.transcode(huff)
    markers = [i for i in range(2, len(arith) - 1)
               if arith[i] == 0xFF and arith[i + 1] not in (0, 0xFF)]
    decoded = 0
    for cut in markers + list(range(2, len(arith) - 2, 5)):
        fixed = arith[:cut] + b'\xff\xd9'
        assert_as_cv2(fixed)
        decoded += port_or_none(fixed) is not None
    assert decoded > len(markers)


def test_idct_saturation_as_cv2():
    """Coefficients whose dequantized values leave 16 bits (as corrupt data
    gives): the pixels are those of libjpeg-turbo's x86 SIMD IDCT, which
    cv2 runs -- 16-bit products and sums, saturated between passes and at
    the output -- not those of its C code's wrapping range limit."""
    rng = np.random.RandomState(5)
    for rows_only in (False, True):
        frame = W.frame_from_planes([np.zeros((32, 48))], 48, 32, [(1, 1)],
                                    {0: rng.randint(1, 256, 64)}, [0])
        coef = rng.randint(-1023, 1024, frame.comps[0].coef.shape)
        coef[..., rng.rand(64) < 0.6] = 0
        if rows_only:                     # the pass-1 shortcut's blocks
            coef[..., 8:] = 0
        frame.comps[0].coef = coef.astype(np.int32)
        for body in (W.write_huffman(frame), W.write_arithmetic(frame)):
            got, ref = codec.decode(body), cv_decode(body)
            assert np.array_equal(got, ref)


# ------------------------------------------------------ four components

def writer_four(adobe, seed=0):
    """A Huffman body of four seeded components (4:2:0 first and last),
    with an Adobe marker of transform `adobe` or none."""
    rng = np.random.RandomState(seed)
    factors = [(2, 2), (1, 1), (1, 1), (2, 2)]
    planes = [np.clip(rng.randn(34, 46) * 20 + 40 * k + 60, 0, 255)
              for k in range(4)]
    frame = W.frame_from_planes(
        planes, 45, 33, factors, {0: W.quant_table(90)}, [0] * 4,
        markers=[] if adobe is None else [W.adobe(adobe)])
    return W.write_huffman(frame)


FOUR = {'pillow cmyk 444': lambda: pillow_cmyk(image(48, 64, 1, 1), 0),
        'pillow cmyk 420': lambda: pillow_cmyk(image(47, 61, 2, 1), 2, 75),
        'writer ycck': lambda: writer_four(2),
        'writer cmyk, no adobe marker': lambda: writer_four(None),
        'writer adobe transform 1 (as ycck)': lambda: writer_four(1)}


@pytest.mark.parametrize('orientation', [1, 6])
@pytest.mark.parametrize('case', sorted(FOUR))
def test_four_components_equal_cv2(case, orientation):
    """CMYK (Adobe transform 0, or no Adobe marker) and YCCK (any other
    transform), through OpenCV's CMYK -> BGR rule, turned by the EXIF
    orientation as cv2 turns them."""
    body = FOUR[case]()
    if orientation != 1:
        body = body[:2] + exif_app1(orientation, True) + body[2:]
    ref = cv_decode(body)
    assert ref is not None
    assert np.array_equal(codec.decode(body), ref)


# ------------------------------------------------------------- sampling

def sampling_body(factors, h, w, seed, arithmetic):
    rng = np.random.RandomState(seed)
    hm, vm = max(f[0] for f in factors), max(f[1] for f in factors)
    planes = []
    for fh, fv in factors:
        dh, dw = -(-h * fv // vm), -(-w * fh // hm)
        yy, xx = np.mgrid[:dh, :dw]
        planes.append(np.clip(128 + 60 * np.sin(xx / 3 + seed) *
                              np.cos(yy / 4) + rng.randn(dh, dw) * 20, 0, 255))
    frame = W.frame_from_planes(planes, w, h, factors,
                                {0: W.quant_table(90),
                                 1: W.quant_table(90, True)},
                                [0] + [1] * (len(factors) - 1))
    return W.write_arithmetic(frame) if arithmetic else W.write_huffman(frame)


def libjpeg_accepts(factors):
    """Integral factors, and at most 10 blocks to an interleaved MCU."""
    hm, vm = max(f[0] for f in factors), max(f[1] for f in factors)
    return (all(hm % fh == 0 and vm % fv == 0 for fh, fv in factors) and
            (len(factors) == 1 or sum(fh * fv for fh, fv in factors) <= 10))


@pytest.mark.parametrize('n_comp', [1, 3])
def test_every_sampling_combination_as_cv2(n_comp):
    """Every combination of factors 1-4 per component that libjpeg accepts
    (luma not the largest among them), at sizes off the MCU grid,
    Huffman and arithmetic in turn: cv2's pixels; a tenth of the others
    (fractional, or more than 10 blocks to the MCU): refused by both."""
    rng = np.random.RandomState(n_comp)
    one = [(fh, fv) for fh in range(1, 5) for fv in range(1, 5)]
    combos = [(f,) for f in one] if n_comp == 1 else [
        (a, b, c) for a in one for b in one for c in one]
    seen = 0
    for i, factors in enumerate(combos):
        accepted = libjpeg_accepts(factors)
        if not accepted and rng.rand() > 0.1:
            continue
        h, w = (int(x) for x in rng.randint(1, 40, 2))
        body = sampling_body(factors, h, w, i, arithmetic=i % 2 == 1)
        ref = cv_decode(body)
        assert (ref is not None) == accepted, factors
        assert_as_cv2(body)
        seen += accepted
    assert seen == (16 if n_comp == 1 else 311)


# ---------------------------------------------------- libjpeg's rules

def _segment(body, marker):
    """The first marker segment of that kind, marker bytes included."""
    i = body.index(bytes((0xFF, marker)))
    return body[i:i + 2 + int.from_bytes(body[i + 2:i + 4], 'big')]


def _replace_segment(body, marker, new):
    return body.replace(_segment(body, marker), new, 1)


def _marker_cases():
    base = huffman(image(21, 30, 2, 1), 70, '420', 1)
    prog = huffman(image(21, 30, 2, 1), 70, '420', 0, progressive=True)
    arith = W.transcode(base)
    dqt16 = _segment(base, 0xDB)[4:]
    dht = _segment(base, 0xC4)
    bad_dc = bytearray(dht)
    bad_dc[4 + 17] = 16                  # a DC symbol above 15
    return {
        # cv2's JPEG signature is FF D8 FF
        'third byte not FF': base[:2] + b'\x00' + base[3:],
        # one scan of every component: what follows it does not matter,
        # unless its data runs to the buffer's end
        'sequential, EOI turned into FF 83': base[:-1] + b'\x83',
        'sequential, junk marker before EOI':
            base[:-2] + b'\xff\x83\x00\x04ab\xff\xd9',
        'sequential, no EOI': base[:-2],
        'arithmetic, EOI turned into FF C8': arith[:-1] + b'\xc8',
        'arithmetic, FF at the end': arith[:-2] + b'\xff',
        # several scans: every marker is read before the pixels
        'progressive, junk marker before EOI':
            prog[:-2] + b'\xff\x83\x00\x04ab\xff\xd9',
        'progressive, second SOI': prog[:-2] + b'\xff\xd8\xff\xd9',
        'progressive, EOI then junk': prog + b'\xff\x83\x00\x04ab',
        # tables: libjpeg-turbo's defaults for a sequential body without
        # DHT, none for a progressive one; DC symbols up to 15
        'sequential without its first DHT': _replace_segment(base, 0xC4,
                                                             b''),
        'progressive without its first DHT': _replace_segment(prog, 0xC4,
                                                              b''),
        'DC symbol 16': base.replace(dht, bytes(bad_dc)),
        'DRI of length 5': _replace_segment(base, 0xDD,
                                            b'\xff\xdd\x00\x05\x00\x01\x00'),
        'DQT precision nibble 2 (16-bit)': _replace_segment(
            base, 0xDB, b'\xff\xdb\x00\x83' + bytes([0x20 | dqt16[0]]) +
            b''.join(bytes((0, v)) for v in dqt16[1:])),
    }


@pytest.mark.parametrize('case', sorted(_marker_cases()))
def test_marker_rules_as_cv2(case):
    """Where libjpeg errs on a marker or a table, and where it ignores
    one: the port refuses exactly where cv2.imdecode gives nothing, and
    otherwise gives its pixels."""
    assert_as_cv2(_marker_cases()[case])


@pytest.mark.parametrize('coding', ['huffman', 'arithmetic'])
@pytest.mark.parametrize('progressive', [False, True])
def test_corrupt_headers_as_cv2(coding, progressive):
    """One to three random bytes of the headers (SOI to the first SOS)
    replaced: the port refuses exactly where cv2 gives nothing, and
    otherwise gives cv2's pixels."""
    img = image(33, 50, 7, 1)[:, :, 0] if progressive else image(33, 50, 7, 1)
    body = huffman(img, 85, '420', 1 if coding == 'huffman' else 0,
                   progressive)
    if coding == 'arithmetic':
        body = W.transcode(body)
    rng = np.random.RandomState(progressive)
    end = body.index(b'\xff\xda')
    refused = 0
    for _ in range(150):
        bad = bytearray(body)
        for i in rng.randint(2, end, rng.randint(1, 4)):
            bad[i] = rng.randint(0, 256)
        assert_as_cv2(bytes(bad))
        refused += port_or_none(bytes(bad)) is None
    assert 0 < refused < 150


# ------------------------------------------------- the [codec] bodies

def test_committed_bodies():
    """The bodies `chip_smoke.py` [codec] decodes on the card's host
    besides the progressive ones: the pinned digests, the pixels
    cv2.imdecode's, and each of the process it stands for."""
    bodies = dict(chip_smoke.progressive_cases(chip_smoke.JPEG_FILE_DIGESTS))
    assert list(bodies) == list(chip_smoke.JPEG_FILE_DIGESTS)
    for name, body in bodies.items():
        px = codec.decode(body)
        assert np.array_equal(px, cv_decode(body)), name
        assert chip_smoke.codec_digests(body, px) == \
            chip_smoke.JPEG_FILE_DIGESTS[name][1:], name
        assert len(body) < 8192, name
    assert b'\xff\xc9' in bodies['arithmetic 420 restart 2 DAC']
    assert b'\xff\xcc' in bodies['arithmetic 420 restart 2 DAC']
    assert b'\xff\xca' in bodies['arithmetic progressive 444']
    assert b'Adobe' in bodies['Pillow CMYK 420']
    assert W.adobe(2) in bodies['YCCK 422']
    # libjpeg smooths its blocks: zigzag 1-9 of some component not refined
    frame, scans, _ = W.parse(bodies['progressive smoothed 420'])
    bits = np.full((3, 64), -1)
    for s in scans:
        for c in s.comps:
            bits[c, s.ss:s.se + 1] = s.al
    assert (bits[:, 1:10] != 0).any() and (bits[:, 0] >= 0).all()
