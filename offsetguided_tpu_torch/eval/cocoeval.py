"""COCO keypoint evaluation (OKS-based AP/AR) without pycocotools.

The JAX package's pure-numpy evaluator, copied: the COCOeval 'keypoints'
protocol (per-image greedy matching of score-sorted detections
to ground truths by Object Keypoint Similarity at 10 thresholds, 101-point
interpolated precision, with the standard all/medium/large area ranges and
maxDets=20), and the CrowdPose protocol's crowdIndex bands
(`evaluate_crowdpose_keypoints`).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = {
    'all': (0.0, 1e10),
    'medium': (32 ** 2, 96 ** 2),
    'large': (96 ** 2, 1e10),
}
MAX_DETS = 20


def compute_oks(dt_kps: np.ndarray, gt_kps: np.ndarray, gt_area: float,
                gt_bbox, sigmas: np.ndarray) -> float:
    """OKS between one detection and one GT (pycocotools computeOks semantics).

    dt_kps/gt_kps: (J, 3) [x, y, v].
    """
    vars_ = (2 * sigmas) ** 2
    vis = gt_kps[:, 2] > 0
    if vis.sum() > 0:
        dx = dt_kps[:, 0] - gt_kps[:, 0]
        dy = dt_kps[:, 1] - gt_kps[:, 1]
    else:
        # no labeled keypoints: measure distance to the enlarged bbox
        x0, y0 = gt_bbox[0] - gt_bbox[2], gt_bbox[1] - gt_bbox[3]
        x1, y1 = gt_bbox[0] + gt_bbox[2] * 2, gt_bbox[1] + gt_bbox[3] * 2
        z = np.zeros_like(dt_kps[:, 0])
        dx = np.maximum(z, x0 - dt_kps[:, 0]) + np.maximum(z, dt_kps[:, 0] - x1)
        dy = np.maximum(z, y0 - dt_kps[:, 1]) + np.maximum(z, dt_kps[:, 1] - y1)
        vis = np.ones(len(dt_kps), dtype=bool)
    e = (dx ** 2 + dy ** 2) / vars_ / (gt_area + np.spacing(1)) / 2.0
    return float(np.mean(np.exp(-e[vis])))


@dataclasses.dataclass
class ImageEval:
    """Per-image match results for one area range."""
    dt_scores: np.ndarray        # (D,)
    dt_matches: np.ndarray       # (T, D) matched gt id or 0
    dt_ignore: np.ndarray        # (T, D)
    gt_ignore: np.ndarray        # (G,)


class KeypointEval:
    """OKS AP evaluator.

    Args:
        gts: per-image list of GT dicts with keys keypoints (flat 3J list or
            (J,3) array), area, bbox, iscrowd, num_keypoints.
        dts: per-image list of detection dicts with keypoints + score.
    """

    def __init__(self, sigmas: Sequence[float]):
        self.sigmas = np.asarray(sigmas, dtype=np.float64)

    # ------------------------------------------------------------------ #
    def evaluate_image(self, gts: List[Dict], dts: List[Dict],
                       area_rng) -> Optional[ImageEval]:
        if not gts and not dts:
            return None
        # pycocotools _prepare: crowd GTs are kept as ignorable matches (a
        # detection overlapping a crowd region is matched-and-ignored via the
        # bbox-distance OKS fallback), never dropped. For keypoints,
        # num_keypoints == 0 also forces ignore.
        for g in gts:
            ignore = (g.get('ignore', 0) or bool(g.get('iscrowd'))
                      or g.get('num_keypoints', 0) == 0
                      or g['area'] < area_rng[0] or g['area'] > area_rng[1])
            g['_ignore'] = bool(ignore)
        # sort: non-ignored gts first (pycocotools order)
        gts = sorted(gts, key=lambda g: g['_ignore'])
        dts = sorted(dts, key=lambda d: -d['score'])[:MAX_DETS]

        T, G, D = len(IOU_THRS), len(gts), len(dts)
        ious = np.zeros((D, G))
        for i, dt in enumerate(dts):
            dkp = np.asarray(dt['keypoints'], dtype=np.float64).reshape(-1, 3)
            for j, gt in enumerate(gts):
                gkp = np.asarray(gt['keypoints'],
                                 dtype=np.float64).reshape(-1, 3)
                ious[i, j] = compute_oks(dkp, gkp, gt['area'],
                                         gt.get('bbox', (0, 0, 0, 0)),
                                         self.sigmas)

        gt_ig = np.array([g['_ignore'] for g in gts], dtype=bool)
        gt_crowd = np.array([bool(g.get('iscrowd')) for g in gts], dtype=bool)
        dt_m = np.zeros((T, D), dtype=np.int64)
        dt_ig = np.zeros((T, D), dtype=bool)
        for t, thr in enumerate(IOU_THRS):
            gt_matched = np.zeros(G, dtype=bool)
            for i in range(D):
                best_iou = min(thr, 1 - 1e-10)
                best_j = -1
                for j in range(G):
                    # a crowd gt may absorb any number of detections
                    # (pycocotools: "if this gt already matched, and not a
                    # crowd, continue")
                    if gt_matched[j] and not gt_crowd[j]:
                        continue
                    # stop at ignored gts once a real match was found
                    if best_j >= 0 and not gt_ig[best_j] and gt_ig[j]:
                        break
                    if ious[i, j] < best_iou:
                        continue
                    best_iou = ious[i, j]
                    best_j = j
                if best_j >= 0:
                    gt_matched[best_j] = True
                    dt_m[t, i] = best_j + 1
                    dt_ig[t, i] = gt_ig[best_j]

        # detections outside the area range and unmatched -> ignored
        dt_areas = np.array(
            [d.get('area', _kp_area(d['keypoints'])) for d in dts])
        out_of_rng = (dt_areas < area_rng[0]) | (dt_areas > area_rng[1])
        dt_ig = dt_ig | ((dt_m == 0) & out_of_rng[None, :])

        return ImageEval(
            dt_scores=np.array([d['score'] for d in dts], dtype=np.float64),
            dt_matches=dt_m, dt_ignore=dt_ig, gt_ignore=gt_ig)

    # ------------------------------------------------------------------ #
    def accumulate(self, per_image: List[Optional[ImageEval]]):
        """Precision/recall over the whole dataset for one area range."""
        evals = [e for e in per_image if e is not None]
        T = len(IOU_THRS)
        if not evals:
            return -np.ones((T, len(REC_THRS))), -np.ones(T)
        scores = np.concatenate([e.dt_scores for e in evals])
        order = np.argsort(-scores, kind='mergesort')
        matches = np.concatenate([e.dt_matches for e in evals],
                                 axis=1)[:, order]
        ignores = np.concatenate([e.dt_ignore for e in evals], axis=1)[:, order]
        n_gt = int(sum((~e.gt_ignore).sum() for e in evals))
        if n_gt == 0:
            return -np.ones((T, len(REC_THRS))), -np.ones(T)

        precision = -np.ones((T, len(REC_THRS)))
        recall = -np.ones(T)
        for t in range(T):
            keep = ~ignores[t]
            tps = ((matches[t] > 0) & keep).astype(np.float64)
            fps = ((matches[t] == 0) & keep).astype(np.float64)
            tp = np.cumsum(tps)
            fp = np.cumsum(fps)
            rc = tp / n_gt
            pr = tp / np.maximum(tp + fp, np.spacing(1))
            recall[t] = rc[-1] if len(rc) else 0.0
            # monotone-decreasing envelope
            pr = pr.tolist()
            for i in range(len(pr) - 1, 0, -1):
                pr[i - 1] = max(pr[i - 1], pr[i])
            inds = np.searchsorted(rc, REC_THRS, side='left')
            q = np.zeros(len(REC_THRS))
            for ri, pi in enumerate(inds):
                q[ri] = pr[pi] if pi < len(pr) else 0.0
            precision[t] = q
        return precision, recall

    # ------------------------------------------------------------------ #
    def run(self, gts_by_img: Dict, dts_by_img: Dict) -> Dict[str, float]:
        """Full evaluation; returns the 10 standard COCO keypoint metrics."""
        img_ids = sorted(set(gts_by_img) | set(dts_by_img))
        stats = {}
        acc = {}
        for name, rng in AREA_RNGS.items():
            per_image = [
                self.evaluate_image(
                    [dict(g) for g in gts_by_img.get(i, [])],
                    list(dts_by_img.get(i, [])), rng)
                for i in img_ids]
            acc[name] = self.accumulate(per_image)

        def ap(name, thr=None):
            precision, _ = acc[name]
            p = precision if thr is None else \
                precision[np.isclose(IOU_THRS, thr)]
            p = p[p > -1]
            return float(p.mean()) if p.size else -1.0

        def ar(name, thr=None):
            _, recall = acc[name]
            r = recall if thr is None else recall[np.isclose(IOU_THRS, thr)]
            r = r[r > -1]
            return float(r.mean()) if r.size else -1.0

        stats['AP'] = ap('all')
        stats['AP50'] = ap('all', 0.5)
        stats['AP75'] = ap('all', 0.75)
        stats['APm'] = ap('medium')
        stats['APl'] = ap('large')
        stats['AR'] = ar('all')
        stats['AR50'] = ar('all', 0.5)
        stats['AR75'] = ar('all', 0.75)
        stats['ARm'] = ar('medium')
        stats['ARl'] = ar('large')
        return stats


def _kp_area(kps) -> float:
    """Fallback detection area: enclosing box of ALL keypoint positions,
    matching pycocotools COCO.loadRes (which boxes x[0::3]/y[0::3] without
    filtering zeros/visibility)."""
    k = np.asarray(kps, dtype=np.float64).reshape(-1, 3)
    if not len(k):
        return 0.0
    w = k[:, 0].max() - k[:, 0].min()
    h = k[:, 1].max() - k[:, 1].min()
    return float(w * h)


def evaluate_coco_keypoints(gt_json_or_index, results: List[Dict],
                            sigmas, image_ids=None) -> Dict[str, float]:
    """COCOeval-style entry: GT annotation file/index + result dicts
    [{image_id, keypoints, score}, ...] -> metrics dict.

    image_ids: restrict the evaluation to these images — the reference sets
    `cocoEval.params.imgIds = validation_ids` when only part of the set was
    run (evaluate.py:324); without this, a subset run (--n-images) counts
    every unevaluated image's GT as missed recall and deflates AP."""
    from ..data.coco import CocoJson
    coco = (gt_json_or_index if isinstance(gt_json_or_index, CocoJson)
            else CocoJson(gt_json_or_index))
    keep = None if image_ids is None else set(image_ids)
    gts_by_img = defaultdict(list)
    for img_id in coco.image_ids(with_persons=True):
        if keep is None or img_id in keep:
            gts_by_img[img_id] = coco.anns_for_image(img_id)
    dts_by_img = defaultdict(list)
    for r in results:
        if keep is None or r['image_id'] in keep:
            dts_by_img[r['image_id']].append(r)
    return KeypointEval(sigmas).run(gts_by_img, dts_by_img)


def evaluate_crowdpose_keypoints(gt_json_or_index, results: List[Dict],
                                 sigmas, image_ids=None) -> Dict[str, float]:
    """The CrowdPose protocol: overall AP, and AP on the easy / medium /
    hard image bands split by each image's `crowdIndex` (the crowdpose-api
    bands: easy below 0.1, medium 0.1 to 0.8, hard from 0.8). A band with
    no image reads -1.0. image_ids: as in `evaluate_coco_keypoints`."""
    from ..data.coco import CocoJson
    coco = (gt_json_or_index if isinstance(gt_json_or_index, CocoJson)
            else CocoJson(gt_json_or_index))
    keep = None if image_ids is None else set(image_ids)
    gts_by_img = {i: coco.anns_for_image(i)
                  for i in coco.image_ids(with_persons=True)
                  if keep is None or i in keep}
    dts_by_img = defaultdict(list)
    for r in results:
        if keep is None or r['image_id'] in keep:
            dts_by_img[r['image_id']].append(r)
    ev = KeypointEval(sigmas)
    out = {'AP': ev.run(gts_by_img, dts_by_img)['AP']}

    def band(lo, hi):
        ids = [i for i in gts_by_img
               if lo <= coco.image_info(i).get('crowdIndex', 0.0) < hi]
        g = {i: gts_by_img[i] for i in ids}
        d = {i: dts_by_img.get(i, []) for i in ids}
        return ev.run(g, d)['AP'] if ids else -1.0

    out['AP_easy'] = band(-1.0, 0.1)
    out['AP_medium'] = band(0.1, 0.8)
    out['AP_hard'] = band(0.8, 10.0)
    return out
