"""The check of the copied calls, stage by stage.

Forward: each copied input slot is matched, pixel for pixel, to the
canvas the reference builds from a scene the benchmark painted (a slot of
the zero padding the batcher adds is skipped; any other slot without a
match is counted); the reference runs its float32 forward on the matched
canvases (and their mirror images where the cell flips), and each image's
maps are compared head by head: the relative error ||program - reference||
/ ||reference||. Decode: the reference decodes the program's own maps
(flip merge, peaks, limb collection, grouping) and its poses are compared
with the program's, keypoint by keypoint, at a tolerance far below a
pixel. The program's decoded poses then stand for each slot's image when
the answers are checked. So the decode and the answers are held to
what the reference makes of the program's maps; as a diagnostic, not
compared with a limit, the reference also decodes its own float32 maps
and reports how far those poses lie from the program's
(`own_maps_pose_mismatch`: random weights leave near-tied peaks, so a
rounding in the forward can move a keypoint whole).
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import numpy as np
import torch

import compare
import reference
from reference.decode import PostProcessor
from reference.model import PlainPoseNet, normalize
from tap import MAP_KEYS


def _key(a: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()


def match_slots(calls: List[Dict], canvases: Dict) -> Tuple[list, int]:
    """-> (per call the scene id of each slot, None for padding; number
    of non-padding slots that match no canvas)."""
    index = {_key(c): sid for sid, (c, _) in canvases.items()}
    out, unmatched = [], 0
    for call in calls:
        ids = []
        for img in call['u8'].numpy():
            sid = index.get(_key(img))
            if sid is None and img.any():
                unmatched += 1
            ids.append(sid)
        out.append(ids)
    return out, unmatched


def _decode(pp: PostProcessor, maps: Dict, flip: bool) -> tuple:
    """The reference's decode of one call's maps -> (poses, counts) on
    the host."""
    preds = {k: [maps[k]] if k in maps else [None] for k in MAP_KEYS}
    poses, _, counts = pp.decode_body(preds, flip_test=flip)
    return poses.cpu().numpy(), counts.cpu().numpy()


def _reference_pp(cfg: Dict, lowres: bool) -> PostProcessor:
    return PostProcessor(skeleton=reference.skeleton(cfg),
                         cfg=reference.decoder_config(cfg, lowres))


@torch.no_grad()
def forward_error(cfg: Dict, sd: Dict, calls: List[Dict], slot_ids: list,
                  canvases: Dict, flip: bool, lowres: bool,
                  device) -> Tuple[float, Dict]:
    """-> (the widest relative error of one image's map of one head;
    the diagnostic mismatch, widest and mean over images, between the
    program's poses and the reference's decode of its own maps, at
    1 px)."""
    net = PlainPoseNet(cfg, sd)
    pp = _reference_pp(cfg, lowres)
    worst, own = 0.0, []
    for call, ids in zip(calls, slot_ids):
        slots = [i for i, sid in enumerate(ids) if sid is not None]
        if not slots:
            continue
        x = torch.from_numpy(np.stack([canvases[ids[i]][0] for i in slots]))
        x = normalize(x.to(device), cfg['pixel_mean'], cfg['pixel_std'])
        if flip:
            x = torch.cat([x, torch.flip(x, dims=(2,))])
        ref = net(x)
        n, m = call['u8'].shape[0], len(slots)
        for k in MAP_KEYS:
            if k not in call['maps']:
                continue
            p = call['maps'][k].to(device)
            r = ref[k][-1]
            rows_p = slots + ([i + n for i in slots] if flip else [])
            rows_r = list(range(m)) + ([m + j for j in range(m)] if flip
                                       else [])
            for a, b in zip(rows_p, rows_r):
                den = r[b].norm()
                err = float((p[a] - r[b]).norm() / den) if den > 0 else \
                    float(p[a].abs().max())
                worst = max(worst, err)
        poses, counts = _decode(pp, {k: v[-1] for k, v in ref.items()
                                     if v and v[-1] is not None}, flip)
        pp_, pc = call['poses'].numpy(), call['counts'].numpy()
        for j, i in enumerate(slots):
            own.append(compare.mismatch(
                compare.from_poses(pp_[i][:int(pc[i])]),
                compare.from_poses(poses[j][:int(counts[j])]), 1.0))
    diag = ({'widest': max(own), 'mean': float(np.mean(own)),
             'images': len(own), 'tol_px': 1.0} if own else None)
    return worst, diag


@torch.no_grad()
def decode_calls(cfg: Dict, calls: List[Dict], flip: bool, lowres: bool,
                 tol: float, device) -> float:
    """The widest keypoint mismatch, slot by slot, between the program's
    decoded poses and the reference's decode of the program's maps."""
    pp = _reference_pp(cfg, lowres)
    worst = 0.0
    for call in calls:
        poses, counts = _decode(pp, {k: v.to(device) for k, v in
                                     call['maps'].items()}, flip)
        pp_, pc = call['poses'].numpy(), call['counts'].numpy()
        for i in range(len(pc)):
            worst = max(worst, compare.mismatch(
                compare.from_poses(pp_[i][:int(pc[i])]),
                compare.from_poses(poses[i][:int(counts[i])]), tol))
    return worst


def program_poses(calls: List[Dict], slot_ids: list) -> Tuple[Dict, int]:
    """(scene id -> the program's decoded poses of that scene in canvas
    pixels, from the first copied call that holds it; the number of later
    copies of a scene whose poses differ from the first's)."""
    out, differ = {}, 0
    for call, ids in zip(calls, slot_ids):
        poses, counts = call['poses'].numpy(), call['counts'].numpy()
        for i, sid in enumerate(ids):
            if sid is None:
                continue
            p = poses[i][:int(counts[i])]
            if sid not in out:
                out[sid] = p
            elif out[sid].shape != p.shape or not np.array_equal(out[sid], p):
                differ += 1
    return out, differ


def stage_numbers(cfg: Dict, sd_host: Dict, calls: List[Dict],
                  canvases: Dict, flip: bool, lowres: bool, tol: float,
                  device) -> Tuple[Dict, Dict, Dict]:
    """-> (numbers, the program's poses by scene id, diagnostics)."""
    slot_ids, unmatched = match_slots(calls, canvases)
    sd = {k: v.to(device) for k, v in sd_host.items()}
    numbers = {'inputs_unmatched': float(unmatched)}
    own = None
    if calls:
        numbers['maps_rel_err'], own = forward_error(
            cfg, sd, calls, slot_ids, canvases, flip, lowres, device)
        numbers['decode_mismatch'] = decode_calls(cfg, calls, flip, lowres,
                                                  tol, device)
    del sd
    prog, differ = program_poses(calls, slot_ids)
    return numbers, prog, {'calls_copied': len(calls),
                           'scenes_copied': len(prog),
                           'copies_that_differ': differ,
                           'own_maps_pose_mismatch': own}
