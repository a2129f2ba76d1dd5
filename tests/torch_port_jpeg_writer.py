"""JPEG bodies that no encoder installed beside the tests writes, for the
codec tests (`tests/test_torch_port_codec*.py`) and `chip_smoke.py`'s
[codec] phase. Not collected by pytest; imports numpy only.

- `parse(body)`: the frame, quantization tables, scan script and quantized
  coefficients of a Huffman-coded body (baseline, extended or progressive),
  through a small Huffman decoder of its own.
- `write_arithmetic(frame, ...)`: the same coefficients arithmetic-coded
  (SOF9 sequential or SOF10 progressive, any scan script, DAC conditioning,
  restart interval), by a QM coder that follows libjpeg's `jcarith.c`
  (`arith_encode`, `finish_pass`, `emit_restart`) -- a lossless transcode,
  as `jpegtran -arithmetic` makes.
- `frame_from_planes(...)`: coefficients of numpy sample planes (a float
  DCT and a quantizer) for any component count, sampling factors and
  precision; `write_huffman(frame, ...)` writes such a frame as a
  sequential Huffman body with flat code tables.
- `write_lossless(grey)`: a lossless (SOF3, predictor 1) body.

The QM coder's probability table is T.81 Table D.2 with libjpeg's fixed
probability entry 113, as the port's `csrc/codec.cpp` holds it.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# zigzag index -> natural index
NATURAL = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
           12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
           35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
           58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)

# (Qe, Next_Index_MPS, Switch_MPS, Next_Index_LPS) of Table D.2, packed as
# Qe << 16 | NMPS << 8 | SWITCH << 7 | NLPS; entry 113 is libjpeg's fixed
# 0.5 bin
ARITAB = (
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171)

DC_BINS, AC_BINS = 64, 256


@dataclass
class Component:
    id: int
    h: int
    v: int
    tq: int
    coef: Optional[np.ndarray] = None    # (bh, bw, 64) int32, natural order


@dataclass
class Frame:
    width: int
    height: int
    comps: List[Component]
    qt: Dict[int, np.ndarray]            # table id -> 64 natural-order
    precision: int = 8
    markers: List[bytes] = field(default_factory=list)   # APPn, copied
    progressive: bool = False

    @property
    def hmax(self):
        return max(c.h for c in self.comps)

    @property
    def vmax(self):
        return max(c.v for c in self.comps)

    @property
    def mcus(self):
        return (-(-self.width // (8 * self.hmax)),
                -(-self.height // (8 * self.vmax)))

    def blocks(self, c: Component):
        """(width, height) of the component in blocks, unpadded."""
        dw = -(-self.width * c.h // self.hmax)
        dh = -(-self.height * c.v // self.vmax)
        return -(-dw // 8), -(-dh // 8)

    def padded(self, c: Component):
        mx, my = self.mcus
        wib, hib = self.blocks(c)
        return max(mx * c.h, wib), max(my * c.v, hib)


@dataclass
class Scan:
    comps: Tuple[int, ...]     # component indices
    ss: int = 0
    se: int = 63
    ah: int = 0
    al: int = 0


def scan_mcus(frame: Frame, scan: Scan):
    """The scan's MCUs in order, each a list of (component index, block
    row, block column)."""
    if len(scan.comps) == 1:
        ci = scan.comps[0]
        wib, hib = frame.blocks(frame.comps[ci])
        for by in range(hib):
            for bx in range(wib):
                yield [(ci, by, bx)]
        return
    mx, my = frame.mcus
    for m in range(mx * my):
        x, y = m % mx, m // mx
        out = []
        for ci in scan.comps:
            c = frame.comps[ci]
            for yy in range(c.v):
                for xx in range(c.h):
                    out.append((ci, y * c.v + yy, x * c.h + xx))
        yield out


# ---------------------------------------------------------------- parse

def _huff_lookup(bits: Sequence[int], vals: Sequence[int]):
    """16-bit peek -> (code length, value) lists of a DHT table."""
    length, value = [0] * 65536, [0] * 65536
    code, p = 0, 0
    for n in range(1, 17):
        for _ in range(bits[n - 1]):
            lo = code << (16 - n)
            hi = (code + 1) << (16 - n)
            length[lo:hi] = [n] * (hi - lo)
            value[lo:hi] = [vals[p]] * (hi - lo)
            code += 1
            p += 1
        code <<= 1
    return length, value


class _Bits:
    """Bits of one restart interval's unstuffed entropy data."""

    def __init__(self, data: bytes):
        a = np.frombuffer(bytes(data) + b'\0\0\0\0', np.uint8).astype(
            np.int64)
        self.w = ((a[:-2] << 16) | (a[1:-1] << 8) | a[2:]).tolist()
        self.pos = 0

    def peek16(self):
        p = self.pos
        return (self.w[p >> 3] >> (8 - (p & 7))) & 0xFFFF

    def get(self, n):
        if n == 0:
            return 0
        v = self.peek16() >> (16 - n)
        self.pos += n
        return v

    def huff(self, tab):
        look = self.peek16()
        n = tab[0][look]
        if n == 0:
            raise ValueError('bad Huffman code')
        self.pos += n
        return tab[1][look]


def _extend(v, s):
    return v - (1 << s) + 1 if s and v < (1 << (s - 1)) else v


def _entropy_intervals(body: bytes, pos: int):
    """The scan's entropy data from `pos`, unstuffed and split at RSTn;
    and the position of the marker that ends it."""
    out, cur = [], bytearray()
    while True:
        j = body.find(b'\xff', pos)
        if j < 0:
            cur += body[pos:]
            return out + [bytes(cur)], len(body)
        cur += body[pos:j]
        k = j + 1
        while k < len(body) and body[k] == 0xFF:
            k += 1
        nb = body[k] if k < len(body) else 0xD9
        if nb == 0:
            cur.append(0xFF)
            pos = k + 1
        elif 0xD0 <= nb <= 0xD7:
            out.append(bytes(cur))
            cur = bytearray()
            pos = k + 1
        else:
            return out + [bytes(cur)], j


def parse(body: bytes):
    """(Frame with coefficients, [Scan], restart interval) of a Huffman
    body; coefficients of blocks no scan reached stay 0."""
    pos, qt, dc, ac = 2, {}, {}, {}
    frame, scans, restart, markers = None, [], 0, []
    progressive = False
    coef = []
    while pos < len(body):
        while body[pos] == 0xFF and body[pos + 1] == 0xFF:
            pos += 1
        assert body[pos] == 0xFF, pos
        m = body[pos + 1]
        if m == 0xD9:
            break
        n = struct.unpack('>H', body[pos + 2:pos + 4])[0]
        seg = body[pos + 4:pos + 2 + n]
        start, pos = pos, pos + 2 + n
        if 0xE0 <= m <= 0xEF:
            markers.append(body[start:pos])
        elif m == 0xDB:
            o = 0
            while o < len(seg):
                pq, tq = seg[o] >> 4, seg[o] & 15
                if pq:
                    z = np.frombuffer(seg[o + 1:o + 129], '>u2')
                else:
                    z = np.frombuffer(seg[o + 1:o + 65], np.uint8)
                t = np.zeros(64, np.int64)
                t[list(NATURAL)] = z
                qt[tq] = t
                o += 1 + 64 * (pq + 1)
        elif m == 0xC4:
            o = 0
            while o < len(seg):
                tc, th = seg[o] >> 4, seg[o] & 15
                bits = list(seg[o + 1:o + 17])
                vals = list(seg[o + 17:o + 17 + sum(bits)])
                (ac if tc else dc)[th] = _huff_lookup(bits, vals)
                o += 17 + sum(bits)
        elif m in (0xC0, 0xC1, 0xC2):
            progressive = m == 0xC2
            p, h, w, nc = struct.unpack('>BHHB', seg[:6])
            comps = [Component(seg[6 + 3 * i], seg[7 + 3 * i] >> 4,
                               seg[7 + 3 * i] & 15, seg[8 + 3 * i])
                     for i in range(nc)]
            frame = Frame(w, h, comps, qt, p, markers, progressive)
            for c in comps:
                bw, bh = frame.padded(c)
                coef.append([0] * (bw * bh * 64))
        elif m == 0xDD:
            restart = struct.unpack('>H', seg[:2])[0]
        elif m == 0xDA:
            ns = seg[0]
            ids = [seg[1 + 2 * i] for i in range(ns)]
            cis = tuple(next(k for k, c in enumerate(frame.comps)
                             if c.id == i) for i in ids)
            tabs = [(seg[2 + 2 * i] >> 4, seg[2 + 2 * i] & 15)
                    for i in range(ns)]
            a = seg[3 + 2 * ns]
            scan = Scan(cis, seg[1 + 2 * ns], seg[2 + 2 * ns], a >> 4, a & 15)
            if not progressive:
                scan.ss, scan.se, scan.ah, scan.al = 0, 63, 0, 0
            scans.append(scan)
            intervals, pos = _entropy_intervals(body, pos)
            _decode_scan(frame, scan, coef, intervals, restart, progressive,
                         {ci: (dc.get(t[0]), ac.get(t[1]))
                          for ci, t in zip(cis, tabs)})
    for c, flat in zip(frame.comps, coef):
        bw, bh = frame.padded(c)
        c.coef = np.array(flat, np.int32).reshape(bh, bw, 64)
    return frame, scans, restart


def _decode_scan(frame, scan, coef, intervals, restart, progressive, tabs):
    mcus = list(scan_mcus(frame, scan))
    per = restart or len(mcus)
    bws = [frame.padded(c)[0] for c in frame.comps]
    ss, se, ah, al = scan.ss, scan.se, scan.ah, scan.al
    kind = ('seq' if not progressive else
            ('dc' if ah == 0 else 'dcr') if ss == 0 else
            ('ac' if ah == 0 else 'acr'))
    p1, m1 = 1 << al, -1 << al
    for i in range(0, len(mcus), per):
        br = _Bits(intervals[i // per] if i // per < len(intervals) else b'')
        pred = {ci: 0 for ci in scan.comps}
        eobrun = 0
        for mcu in mcus[i:i + per]:
            for ci, by, bx in mcu:
                f = coef[ci]
                o = (by * bws[ci] + bx) * 64
                dct, act = tabs[ci]
                if kind in ('seq', 'dc'):
                    s = br.huff(dct)
                    pred[ci] += _extend(br.get(s), s)
                    f[o] = pred[ci] << al if kind == 'dc' else pred[ci]
                    if kind == 'dc':
                        continue
                    k = 1
                    while k < 64:
                        rs = br.huff(act)
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            f[o + NATURAL[k]] = _extend(br.get(s), s)
                        elif r != 15:
                            break
                        else:
                            k += 15
                        k += 1
                elif kind == 'dcr':
                    if br.get(1):
                        f[o] |= p1
                elif kind == 'ac':
                    if eobrun:
                        eobrun -= 1
                        continue
                    k = ss
                    while k <= se:
                        rs = br.huff(act)
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            f[o + NATURAL[k]] = _extend(br.get(s), s) * p1
                        elif r == 15:
                            k += 15
                        else:
                            eobrun = (1 << r) + br.get(r) - 1
                            break
                        k += 1
                else:
                    k = ss
                    if eobrun == 0:
                        while k <= se:
                            rs = br.huff(act)
                            r, s = rs >> 4, rs & 15
                            if s:
                                s = p1 if br.get(1) else m1
                            elif r != 15:
                                eobrun = (1 << r) + br.get(r)
                                break
                            while k <= se:
                                z = o + NATURAL[k]
                                if f[z]:
                                    if br.get(1) and (f[z] & p1) == 0:
                                        f[z] += p1 if f[z] >= 0 else m1
                                else:
                                    r -= 1
                                    if r < 0:
                                        break
                                k += 1
                            if s and k <= se:
                                f[o + NATURAL[k]] = s
                            k += 1
                    if eobrun > 0:
                        while k <= se:
                            z = o + NATURAL[k]
                            if f[z] and br.get(1) and (f[z] & p1) == 0:
                                f[z] += p1 if f[z] >= 0 else m1
                            k += 1
                        eobrun -= 1


# ------------------------------------------------------ the QM encoder

class QMEncoder:
    """jcarith.c's arithmetic encoder: `encode` is arith_encode, `finish`
    finish_pass; statistics bins are list entries."""

    def __init__(self, out: bytearray):
        self.out = out
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = (
            0, 0x10000, 0, 0, 11, -1)

    def _zeros(self):
        if self.zc:
            self.out += b'\0' * self.zc
            self.zc = 0

    def _emit(self, b):
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0)

    def encode(self, st, i, val):
        sv = st[i]
        qe = ARITAB[sv & 0x7F]
        nl = qe & 0xFF
        nm = (qe >> 8) & 0xFF
        qe >>= 16
        a = self.a - qe
        if val != (sv >> 7):
            if a >= qe:
                self.c += a
                a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if a >= 0x8000:
                self.a = a
                return
            if a < qe:
                self.c += a
                a = qe
            st[i] = (sv & 0x80) ^ nm
        c, ct = self.c, self.ct
        while True:
            a <<= 1
            c <<= 1
            ct -= 1
            if ct == 0:
                temp = c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer + 1)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._zeros()
                        self.out.append(self.buffer)
                    if self.sc:
                        self._zeros()
                        self.out += b'\xff\0' * self.sc
                        self.sc = 0
                    self.buffer = temp & 0xFF
                c &= 0x7FFFF
                ct += 8
            if a >= 0x8000:
                break
        self.a, self.c, self.ct = a, c, ct

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self.out.append(self.buffer)
            if self.sc:
                self._zeros()
                self.out += b'\xff\0' * self.sc
                self.sc = 0
        if self.c & 0x7FFF800:
            self._zeros()
            self._emit((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)


def _encode_magnitude(e, stats, st, v, ac_base=None):
    """Figures F.8 and F.9 for |v| >= 1 after its sign: the category of
    |v| - 1 from bin `st` on (DC: then from X1 = 20 on; AC, `ac_base` the
    189 / 217 of Kx: a second decision at `st`, then from `ac_base` on),
    then its bits. Returns the category's top bit (0 for |v| = 1)."""
    m = 0
    v -= 1
    if v:
        e.encode(stats, st, 1)
        m = 1
        v2 = v >> 1
        if ac_base is None:
            st = 20
        elif v2:
            e.encode(stats, st, 1)
            m = 2
            st = ac_base
            v2 >>= 1
        while v2:
            e.encode(stats, st, 1)
            m <<= 1
            st += 1
            v2 >>= 1
    e.encode(stats, st, 0)
    top = m
    st += 14
    m >>= 1
    while m:
        e.encode(stats, st, 1 if m & v else 0)
        m >>= 1
    return top


def _encode_dc(e, stats, ctx, ci, v, L, U):
    """Figure F.4 with the difference v; the conditioning category of the
    component's next difference (F.1.4.4.1.2) into ctx[ci]."""
    st = ctx[ci]
    if v == 0:
        e.encode(stats, st, 0)
        ctx[ci] = 0
        return
    e.encode(stats, st, 1)
    e.encode(stats, st + 1, 0 if v > 0 else 1)
    m = _encode_magnitude(e, stats, st + (2 if v > 0 else 3), abs(v))
    if m < ((1 << L) >> 1):
        ctx[ci] = 0
    elif m > ((1 << U) >> 1):
        ctx[ci] = 12 if v > 0 else 16
    else:
        ctx[ci] = 4 if v > 0 else 8


def _encode_ac_block(e, stats, fixed, blk, ss, se, al, K):
    """Figure F.5 over ss..se of natural-order `blk` with the point
    transform Al (sequential: ss 1, se 63, al 0)."""
    def pt(v):
        return v >> al if v >= 0 else -((-v) >> al)
    vals = [pt(blk[NATURAL[k]]) for k in range(64)]
    ke = se
    while ke > 0 and vals[ke] == 0:
        ke -= 1
    k = ss
    while k <= ke:
        st = 3 * (k - 1)
        e.encode(stats, st, 0)
        while vals[k] == 0:
            e.encode(stats, st + 1, 0)
            st += 3
            k += 1
        e.encode(stats, st + 1, 1)
        e.encode(fixed, 0, 0 if vals[k] > 0 else 1)
        _encode_magnitude(e, stats, st + 2, abs(vals[k]),
                          189 if k <= K else 217)
        k += 1
    if k <= se:
        e.encode(stats, 3 * (k - 1), 1)


def _encode_ac_refine(e, stats, fixed, blk, ss, se, ah, al):
    """Figure G.10 (jcarith.c encode_mcu_AC_refine)."""
    absv = [abs(int(blk[NATURAL[k]])) for k in range(64)]
    ke = se
    while ke > 0 and (absv[ke] >> al) == 0:
        ke -= 1
    kex = ke
    while kex > 0 and (absv[kex] >> ah) == 0:
        kex -= 1
    k = ss
    while k <= ke:
        st = 3 * (k - 1)
        if k > kex:
            e.encode(stats, st, 0)
        while True:
            v = absv[k] >> al
            if v:
                if v >> 1:
                    e.encode(stats, st + 2, v & 1)
                else:
                    e.encode(stats, st + 1, 1)
                    e.encode(fixed, 0, 1 if blk[NATURAL[k]] < 0 else 0)
                break
            e.encode(stats, st + 1, 0)
            st += 3
            k += 1
        k += 1
    if k <= se:
        e.encode(stats, 3 * (k - 1), 1)


def arithmetic_scan(frame: Frame, scan: Scan, progressive: bool,
                    restart: int = 0, tables=None, dac=None) -> bytes:
    """The entropy-coded data of one arithmetic scan (restart markers
    included). `tables`: component index -> (DC table, AC table), default
    0 for the first component and 1 for the others; `dac`: DC table ->
    (L, U) and AC table + 16 -> Kx, libjpeg's defaults (0, 1), 5."""
    tables = tables or default_tables(frame)
    dac = dac or {}
    out = bytearray()
    e = QMEncoder(out)
    dc_first = not progressive or (scan.ss == 0 and scan.ah == 0)
    has_ac = not progressive or scan.se
    dc_stats = {tables[ci][0]: [0] * DC_BINS for ci in scan.comps}
    ac_stats = {tables[ci][1]: [0] * AC_BINS for ci in scan.comps}
    fixed = [113]
    last, ctx = {}, {}

    def reset():
        for ci in scan.comps:
            if dc_first:
                dc_stats[tables[ci][0]][:] = [0] * DC_BINS
                last[ci], ctx[ci] = 0, 0
            if has_ac:
                ac_stats[tables[ci][1]][:] = [0] * AC_BINS
    reset()
    togo, rst = restart, 0
    for mcu in scan_mcus(frame, scan):
        if restart:
            if togo == 0:
                e.finish()
                out += bytes((0xFF, 0xD0 + rst))
                rst = (rst + 1) & 7
                e.reset()
                reset()
                togo = restart
            togo -= 1
        for ci, by, bx in mcu:
            blk = frame.comps[ci].coef[by, bx]
            dt, at = tables[ci]
            L, U = dac.get(dt, (0, 1))
            K = dac.get(16 + at, 5)
            if not progressive or (scan.ss == 0 and scan.ah == 0):
                dcv = int(blk[0]) >> scan.al
                _encode_dc(e, dc_stats[dt], ctx, ci, dcv - last[ci], L, U)
                last[ci] = dcv
                if not progressive:
                    _encode_ac_block(e, ac_stats[at], fixed, blk, 1, 63, 0,
                                     K)
            elif scan.ss == 0:
                e.encode(fixed, 0, (int(blk[0]) >> scan.al) & 1)
            elif scan.ah == 0:
                _encode_ac_block(e, ac_stats[at], fixed, blk, scan.ss,
                                 scan.se, scan.al, K)
            else:
                _encode_ac_refine(e, ac_stats[at], fixed, blk, scan.ss,
                                  scan.se, scan.ah, scan.al)
    e.finish()
    return bytes(out)


# -------------------------------------------------------------- bodies

def _seg(marker: int, payload: bytes) -> bytes:
    return struct.pack('>BBH', 0xFF, marker, len(payload) + 2) + payload


def _dqt(frame: Frame) -> bytes:
    out = b''
    for tq in sorted({c.tq for c in frame.comps}):
        q = np.asarray(frame.qt[tq])[list(NATURAL)]
        if q.max() > 255 or frame.precision > 8:
            out += _seg(0xDB, bytes([0x10 | tq]) + q.astype('>u2').tobytes())
        else:
            out += _seg(0xDB, bytes([tq]) + q.astype(np.uint8).tobytes())
    return out


def _sof(frame: Frame, marker: int) -> bytes:
    p = struct.pack('>BHHB', frame.precision, frame.height, frame.width,
                    len(frame.comps))
    for c in frame.comps:
        p += bytes((c.id, (c.h << 4) | c.v, c.tq))
    return _seg(marker, p)


def _sos(frame: Frame, scan: Scan, tables) -> bytes:
    p = bytes([len(scan.comps)])
    for ci in scan.comps:
        dt, at = tables[ci]
        p += bytes((frame.comps[ci].id, (dt << 4) | at))
    return _seg(0xDA, p + bytes((scan.ss, scan.se, (scan.ah << 4) | scan.al)))


def default_tables(frame: Frame):
    return {ci: (0, 0) if ci == 0 else (1, 1)
            for ci in range(len(frame.comps))}


def write_arithmetic(frame: Frame, scans: Optional[List[Scan]] = None,
                     progressive: bool = False, restart: int = 0,
                     dac: Optional[dict] = None, tables=None,
                     markers: Optional[List[bytes]] = None) -> bytes:
    """SOF9 (sequential: one interleaved scan unless `scans` says
    otherwise) or SOF10 (progressive, `scans` required) body of the
    frame's coefficients. `dac`: DC table -> (L, U), 16 + AC table -> Kx,
    written as one DAC segment when given. `markers` (default the frame's)
    are written after SOI."""
    tables = tables or default_tables(frame)
    if scans is None:
        scans = [Scan(tuple(range(len(frame.comps))))]
    out = b'\xff\xd8' + b''.join(frame.markers if markers is None
                                 else markers)
    out += _dqt(frame) + _sof(frame, 0xCA if progressive else 0xC9)
    if dac:
        p = b''
        for t, val in sorted(dac.items()):
            p += bytes((t, (val[1] << 4) | val[0]) if t < 16 else (t, val))
        out += _seg(0xCC, p)
    if restart:
        out += _seg(0xDD, struct.pack('>H', restart))
    for scan in scans:
        out += _sos(frame, scan, tables)
        out += arithmetic_scan(frame, scan, progressive, restart, tables,
                               dac)
    return out + b'\xff\xd9'


def transcode(body: bytes, **kw) -> bytes:
    """The arithmetic twin of a Huffman body: its coefficients, scan
    script, restart interval and APPn segments, arithmetic-coded."""
    frame, scans, restart = parse(body)
    kw.setdefault('restart', restart)
    return write_arithmetic(frame, scans, frame.progressive, **kw)


# ------------------------------------------- coefficients from samples

def _dct_matrix():
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) / 2
    m[0] /= np.sqrt(2)
    return m


_DCT = _dct_matrix()


def frame_from_planes(planes: Sequence[np.ndarray], width: int, height: int,
                      factors: Sequence[Tuple[int, int]],
                      qt: Dict[int, np.ndarray], tq: Sequence[int],
                      ids: Optional[Sequence[int]] = None,
                      precision: int = 8,
                      markers: Sequence[bytes] = ()) -> Frame:
    """A frame of quantized coefficients of sample planes, each at least
    its component's downsampled size (extra samples are cut, missing ones
    replicated from the edge, out to the padded MCU grid)."""
    ids = ids or list(range(1, len(planes) + 1))
    comps = [Component(i, h, v, t) for i, (h, v), t in zip(ids, factors, tq)]
    frame = Frame(width, height, comps, dict(qt), precision, list(markers))
    shift = 1 << (precision - 1)
    for c, plane in zip(comps, planes):
        bw, bh = frame.padded(c)
        dw = -(-width * c.h // frame.hmax)
        dh = -(-height * c.v // frame.vmax)
        p = np.asarray(plane, np.float64)[:dh, :dw]
        p = np.pad(p, ((0, bh * 8 - dh), (0, bw * 8 - dw)), mode='edge')
        blocks = p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3) - shift
        d = np.einsum('ui,abij,vj->abuv', _DCT, blocks, _DCT).reshape(
            bh, bw, 64)
        q = np.asarray(qt[c.tq], np.float64)
        c.coef = np.round(d / q).astype(np.int32)
    return frame


def quant_table(quality: int, chroma: bool = False,
                precision: int = 8) -> np.ndarray:
    """libjpeg's standard table at a quality, natural order (at 12 bits,
    scaled by 16 as libjpeg scales it)."""
    luma = [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
            14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
            18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113,
            92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100,
            103, 99]
    base = np.array([17, 18, 24, 47] + [99] * 4 + [18, 21, 26, 66] + [99] * 4
                    + [24, 26, 56] + [99] * 5 + [47, 66] + [99] * 6
                    + [99] * 32) if chroma else np.array(luma)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    q = np.clip((base * scale + 50) // 100, 1, 255)
    return q * (16 if precision == 12 else 1)


def adobe(transform: int) -> bytes:
    """An Adobe APP14 segment with the colour transform flag."""
    return _seg(0xEE, b'Adobe' + struct.pack('>HHHB', 100, 0, 0, transform))


# ------------------------------------------------ Huffman, flat tables

def _flat_table(symbols) -> Tuple[List[int], List[int], Dict[int, tuple]]:
    """(bits, values, symbol -> (code, length)) of a table that gives
    every symbol the same length."""
    syms = sorted(set(symbols)) or [0]
    n = len(syms).bit_length()
    bits = [0] * 16
    bits[n - 1] = len(syms)
    return bits, syms, {s: (i, n) for i, s in enumerate(syms)}


class _BitOut:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, code, size):
        self.acc = (self.acc << size) | (code & ((1 << size) - 1))
        self.n += size
        while self.n >= 8:
            self.n -= 8
            b = (self.acc >> self.n) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self):
        if self.n:
            self.put(0x7F, 8 - self.n)


def _category(v):
    return abs(int(v)).bit_length()


def write_huffman(frame: Frame, restart: int = 0, marker: int = 0xC1,
                  scans: Optional[List[Scan]] = None) -> bytes:
    """A sequential Huffman body (SOF0 / SOF1 by `marker`) of the frame's
    coefficients, with one flat DC and AC table for all components."""
    if scans is None:
        scans = [Scan(tuple(range(len(frame.comps))))]
    symbols_dc, symbols_ac = set(), set()
    for c in frame.comps:
        zz = c.coef[..., list(NATURAL)].reshape(-1, 64)
        for blk in zz:
            symbols_dc.update(range(0, 16))
            r = 0
            for v in blk[1:]:
                if v == 0:
                    r += 1
                    continue
                while r > 15:
                    symbols_ac.add(0xF0)
                    r -= 16
                symbols_ac.add((r << 4) | _category(v))
                r = 0
            symbols_ac.add(0)
    dbits, dvals, dcode = _flat_table(symbols_dc)
    abits, avals, acode = _flat_table(symbols_ac)
    tables = {ci: (0, 0) for ci in range(len(frame.comps))}
    out = b'\xff\xd8' + b''.join(frame.markers) + _dqt(frame)
    out += _sof(frame, marker)
    out += _seg(0xC4, bytes([0x00] + dbits + dvals) +
                bytes([0x10] + abits + avals))
    if restart:
        out += _seg(0xDD, struct.pack('>H', restart))
    for scan in scans:
        out += _sos(frame, scan, tables)
        bo = _BitOut()
        pred = {ci: 0 for ci in scan.comps}
        togo, rst = restart, 0
        for mcu in scan_mcus(frame, scan):
            if restart:
                if togo == 0:
                    bo.flush()
                    bo.out += bytes((0xFF, 0xD0 + rst))
                    rst = (rst + 1) & 7
                    pred = {ci: 0 for ci in scan.comps}
                    togo = restart
                togo -= 1
            for ci, by, bx in mcu:
                blk = frame.comps[ci].coef[by, bx]
                d = int(blk[0]) - pred[ci]
                pred[ci] = int(blk[0])
                s = _category(d)
                bo.put(*dcode[s])
                if s:
                    bo.put(d if d >= 0 else d - 1, s)
                r = 0
                for k in range(1, 64):
                    v = int(blk[NATURAL[k]])
                    if v == 0:
                        r += 1
                        continue
                    while r > 15:
                        bo.put(*acode[0xF0])
                        r -= 16
                    s = _category(v)
                    bo.put(*acode[(r << 4) | s])
                    bo.put(v if v >= 0 else v - 1, s)
                    r = 0
                if r:
                    bo.put(*acode[0])
        bo.flush()
        out += bytes(bo.out)
    return out + b'\xff\xd9'


def write_lossless(grey: np.ndarray) -> bytes:
    """A lossless (SOF3) body of 8-bit grey samples: predictor 1 (the
    sample to the left; the one above at a row's start; 128 first), no
    point transform, one flat DC-style table of categories 0-16."""
    g = np.asarray(grey, np.int64)
    h, w = g.shape
    pred = np.empty_like(g)
    pred[0, 0] = 128
    pred[0, 1:] = g[0, :-1]
    pred[1:, 0] = g[:-1, 0]
    pred[1:, 1:] = g[1:, :-1]
    diff = (g - pred) & 0xFFFF
    diff = np.where(diff >= 0x8000, diff - 0x10000, diff)
    bits, vals, code = _flat_table(range(17))
    bo = _BitOut()
    for d in diff.ravel().tolist():
        s = 16 if d == -32768 else _category(d)
        bo.put(*code[s])
        if 0 < s < 16:
            bo.put(d if d >= 0 else d - 1, s)
    bo.flush()
    sof = _seg(0xC3, struct.pack('>BHHBBBB', 8, h, w, 1, 1, 0x11, 0))
    dht = _seg(0xC4, bytes([0x00] + bits + vals))
    sos = _seg(0xDA, bytes((1, 1, 0x00, 1, 0, 0)))
    return b'\xff\xd8' + sof + dht + sos + bytes(bo.out) + b'\xff\xd9'
