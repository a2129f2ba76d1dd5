"""What of the kernels' tooling runs without a card: the phase cuts of
`kernel_phases.py` still find their anchors in `csrc/`, the grouping
phase stamps find their markers and barriers, the ptxas
report lines of `chip_smoke.py` name each kernel, and the peaks kernel's
dense tap table (weights over offsets -2..2, summed in offset order) gives
`upsample2d`'s terms in `upsample2d`'s order, bit for bit.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import kernel_phases  # noqa: E402
from offsetguided_tpu_torch.ops.cuda import peaks  # noqa: E402
from offsetguided_tpu_torch.ops.resize import upsample2d  # noqa: E402

CSRC = ROOT / 'offsetguided_tpu_torch' / 'csrc'


def kernel_body(src: str, name: str, next_name: str) -> str:
    return src[src.index(f'{name}('):src.index(f'{next_name}(')]


def test_phase_cuts_find_their_anchors():
    v = kernel_phases.variants(CSRC)
    assert set(v) == {('peaks', 'full'), ('peaks', 'no_select'),
                      ('peaks', 'no_nms'), ('topk', 'full'),
                      ('topk', 'no_select'), ('topk', 'tile_2048'),
                      ('topk', 'tile_8192')}
    full = kernel_body(v['peaks', 'full'], 'peaks_tile_kernel',
                       'peaks_merge_kernel')
    assert 'og::block_select(' in full and 'make_key(' in full
    cut = kernel_body(v['peaks', 'no_select'], 'peaks_tile_kernel',
                      'peaks_merge_kernel')
    assert 'og::block_select(' not in cut and 'og_phase_sink(' in cut
    assert 'make_key(' in cut
    cut = kernel_body(v['peaks', 'no_nms'], 'peaks_tile_kernel',
                      'peaks_merge_kernel')
    assert 'make_key(' not in cut and 'og_phase_sink_f(' in cut
    assert 'og::select_smallest(' in v['topk', 'full']
    assert 'og::select_smallest(' not in v['topk', 'no_select']
    for tile in (2048, 8192):
        assert f'constexpr int TILE = {tile};' in v['topk', f'tile_{tile}']


def test_merge_kernels_keep_their_scratch_in_dynamic_shared_memory():
    """The k > 512 repair: each merge launch takes win_keys(k) + k keys of
    dynamic shared memory (no fixed k), and the cut copies keep that."""
    v = kernel_phases.variants(CSRC)
    for name, merge in (('peaks', 'peaks_merge_kernel'),
                        ('topk', 'topk_merge_kernel')):
        for var in ('full', 'no_select'):
            body = v[name, var][v[name, var].index(f'{merge}('):]
            assert 'extern __shared__ unsigned long long wc[];' in body
            assert 'best = wc + og::win_keys(k);' in body
        src = (CSRC / f'{name}.cu').read_text()
        assert 'og::allow_dynamic_smem(' in src and 'MAX_K' not in src
    topk_tile = kernel_body(v['topk', 'no_select'], 'topk_tile_kernel',
                            'topk_merge_kernel')
    assert 'extern __shared__ unsigned long long win[];' in topk_tile
    assert 'MAX_K' not in (CSRC / 'topk_select.cuh').read_text()


# the two-launch nms_topk.cu (the kernel's first design): its tile
# selection call and its merge's gather, verbatim
TWO_LAUNCH_NMS = '''#include "topk_select.cuh"
__global__ void nms_topk_tile_kernel(int k, unsigned long long* cand) {
  const int tiles = gridDim.x * gridDim.y;
  og::block_select(keys, T * T / (THREADS / 32), k, wcand,
                   cand + ((size_t)m * tiles + (size_t)ty * gridDim.x + tx) * k);
}
__global__ void nms_topk_merge_kernel(int h, int w, int k) {
  for (int r = threadIdx.x; r < k; r += blockDim.x) {
    const int i = (int)og::key_index(best[r]);
  }
}
'''


def test_nms_topk_cuts_find_their_anchors(tmp_path):
    """The two-launch source's `no_select` cut (its tile selection becomes
    a sink, its merge's gather is clamped into the map), and this tree's
    one-launch source: phase markers and each ablation's anchor."""
    (tmp_path / 'nms_topk.cu').write_text(TWO_LAUNCH_NMS)
    v = kernel_phases.nms_topk_variants(CSRC, tmp_path)
    assert set(v) == {('nms_topk', 'full'), ('nms_topk', 'phased'),
                      ('nms_topk', 'baseline'),
                      ('nms_topk', 'baseline_no_select')} | {
        ('nms_topk', cut) for cut in {**kernel_phases.NMS_CUTS,
                                      **kernel_phases.NMS_SETTINGS}}
    cut = v['nms_topk', 'baseline_no_select']
    assert 'og::block_select(' not in cut and 'og_phase_sink(keys' in cut
    assert '% (uint32_t)(h * w)' in cut
    src = (CSRC / 'nms_topk.cu').read_text()
    assert not kernel_phases.SELECT.search(src)
    timed, names = kernel_phases.phased(src, 'nms_topk')
    assert names == ['load', 'nms', 'reduce', 'band_select', 'to_leader',
                     'merge', 'write']
    assert 'smem[]; og_phase_begin();' in timed
    for name, edits in {**kernel_phases.NMS_CUTS,
                        **kernel_phases.NMS_SETTINGS}.items():
        assert v['nms_topk', name] != src
        for old, new in edits:
            assert old in src and new in v['nms_topk', name]


def test_grouping_phase_markers_and_barriers():
    """The grouping copy times every marked phase, and a source without
    markers (an older tree's) gets one after each barrier, named by its
    line; the barriers one image passes are counted from the source."""
    src = (CSRC / 'grouping.cu').read_text()
    timed, names = kernel_phases.phased(src)
    assert names == ['merge_find', 'merge_copy', 'rows', 'new_rows', 'init',
                     'dedup', 'final_score', 'final_write']
    assert 'smem[]; og_phase_begin();' in timed
    assert timed.count('og_phase_stamp(OG_PHASE_##name)') == 1
    assert chip_smoke.grouping_barriers(src, 19, 2) == 19 * 4 + 2 * 2 + 3
    unmarked = src.replace('OG_PHASE(', 'NO_PHASE(')
    timed, names = kernel_phases.phased(unmarked)
    lines = unmarked.split('\n')
    assert names == [f'line{i + 1}' for i, ln in enumerate(lines)
                     if '__syncthreads();' in ln]
    assert timed.count('__syncthreads();\n') >= len(names)
    v = kernel_phases.grouping_variants(CSRC, CSRC)
    assert set(v) == {('grouping', 'full'), ('grouping', 'phased'),
                      ('grouping', 'baseline'),
                      ('grouping', 'baseline_phased')}


def test_ptxas_lines_name_each_kernel():
    report = '\n'.join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_116topk_tile_kernelILb0EEEvPKfiiPy' for 'sm_90a'",
        'ptxas info    : Function properties for '
        '_ZN12_GLOBAL__N_116topk_tile_kernelILb0EEEvPKfiiPy',
        '    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads',
        'ptxas info    : Used 56 registers, used 1 barriers, 5184 bytes smem',
        'ptxas info    : Function properties for '
        '_ZN12_GLOBAL__N_117peaks_tile_kernelEPKfiiiNS_4TapsEPy',
        '    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads',
        'ptxas info    : Used 45 registers, used 1 barriers, 44576 bytes smem',
        'ptxas info    : Function properties for _ZN12_GLOBAL__N_112group_'
        'kernelILi17EEEvPKfPKiNS_6ParamsEPfS5_Pi',
        '    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads',
        'ptxas info    : Used 56 registers, used 1 barriers',
    ])
    assert chip_smoke.ptxas_lines(report) == [
        'topk_tile_kernel<false>: 0 bytes stack frame, 0 bytes spill stores, '
        '0 bytes spill loads; Used 56 registers, used 1 barriers, 5184 bytes '
        'smem',
        'peaks_tile_kernel: 0 bytes stack frame, 0 bytes spill stores, 0 '
        'bytes spill loads; Used 45 registers, used 1 barriers, 44576 bytes '
        'smem',
        'group_kernel<17>: 0 bytes stack frame, 0 bytes spill stores, 0 bytes '
        'spill loads; Used 56 registers, used 1 barriers']


def dense_upsample_axis0(x, dense):
    """The kernel's arithmetic along axis 0: output row Y of phase Y & 3 is
    the sum over offsets o of x[clamp((Y >> 2) + o - 2)] * dense[p, o],
    nonzero weights only, in ascending offset order, in float32."""
    rows = []
    for Y in range(4 * x.shape[0]):
        i, p = Y >> 2, Y & 3
        acc = np.zeros(x.shape[1:], np.float32)
        first = True
        for o in range(5):
            if dense[p, o] != 0.0:
                term = x[np.clip(i + o - 2, 0, x.shape[0] - 1)] * dense[p, o]
                acc = term if first else (acc + term).astype(np.float32)
                first = False
        rows.append(acc)
    return np.stack(rows)


@pytest.mark.parametrize('method', ['bicubic', 'bilinear', 'nearest'])
def test_dense_tap_table_keeps_the_plain_term_order(method):
    n, off, w = peaks._tap_arrays(method)
    dense = np.zeros((4, 5), np.float32)     # as og_peaks_topk builds it
    for p in range(4):
        for t in range(n[p]):
            assert w[p, t] != 0.0 and (t == 0 or off[p, t] > off[p, t - 1])
            dense[p, off[p, t] + 2] = w[p, t]
    x = np.random.RandomState(0).rand(7, 9).astype(np.float32) ** 3
    got = dense_upsample_axis0(dense_upsample_axis0(x, dense).T, dense).T
    want = upsample2d(torch.from_numpy(x)[None, ..., None], 4,
                      method)[0, ..., 0].numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
