"""The comparisons that decide ``correct``.

Detections: each image's valid program detections against the
reference's, matched greedily (the reference's in descending score, each
to the unmatched program detection of its class with the highest IoU, a
match at IoU 0.5 or more). Numbers over every compared image:

* ``score_gap``: the largest score difference of a matched pair;
* ``unmatched_gap``: the largest score of a detection that has no match
  on the other side, above the image's cut (the reference's lowest kept
  score where it kept ``max_detections``, else the score threshold): a
  detection that swaps places at the cut reads near 0, one that is missing
  or moved reads its score;
* ``miss``: the share of detections, both sides, without a match;
* ``worst_image_box_gap``: of each detection, both sides, one minus its
  best IoU with the other side's detections of its class (1 where there
  is none); in each image the 25th percentile of those, and the worst
  image. Bf16 rounding reorders near-equal scores at the top-k cuts and in
  NMS, so a share of the detections differs between any two roundings,
  but most of each image's detections are the same proposal and class
  decoded on both sides, a fraction of a percent apart; a lower precision
  moves the boxes themselves, and an image whose detections are wrong
  reads 1;
* ``logit_gap``: over the detections whose best IoU is 0.9 or more, the
  median gap between the score's logit and its partner's (logits, since
  a seed whose scores crowd near 1 shows its rounding small in
  probability). A reading for the limits' files; no cell compares it.

Training (the first steps of the program against the reference following
them from the same weights on the same batches), each the worst case:

* ``loss1_gap``, ``grad_norm1_gap``: the first step's loss and global
  gradient norm before clipping (the step's ``grad_norm``), each as a gap
  over the reference's: steady from seed to seed, where the later steps
  carry the first update's noise;
* ``loss_gap``: the largest gap of a step's loss, over the reference's;
* ``grad_norm_gap``: the same of a step's global gradient norm before
  clipping (the step's ``grad_norm``);
* ``grad_gap``: the largest gap between a leaf's first-gradient norm and
  the reference's, over the larger of the reference's norm of that leaf
  and of the median leaf;
* ``update_gap``: the same of the norm of each leaf's change after the
  steps, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone);
* ``grad_median_gap``, ``update_median_gap``: the median leaf's gap of
  each, steady from seed to seed where the worst leaf is one small
  leaf's noise;
* ``first_<output>_gap``: of each tensor that the model's core returned
  in the first step's forward (per query: the decoder layers' logits and
  boxes), the root mean square of the program's difference from the
  reference over the reference's own spread about its mean. It is taken
  before the set loss's matching, so no near tie of the matching moves it,
  and no sum over the queries averages rounding away. A tensor of another
  shape than the reference's reads ``NO_OUTPUT``.
"""

from __future__ import annotations

import statistics

from typing import Dict, Iterable, List

import numpy as np

def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(
        a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(
        b[:, 3] - b[:, 1], 0, None)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0)


def image_numbers(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray],
                  max_detections: int, score_thresh: float) -> dict:
    """The numbers of one image (arrays of its ``max_detections`` slots)."""
    pv, rv = prog["valid"].astype(bool), ref["valid"].astype(bool)
    pb, ps, pc = prog["boxes"][pv], prog["scores"][pv], prog["classes"][pv]
    rb, rs, rc = ref["boxes"][rv], ref["scores"][rv], ref["classes"][rv]
    cut = float(rs.min()) if rv.sum() >= max_detections else score_thresh
    iou = iou_matrix(rb, pb) if len(rb) and len(pb) else np.zeros(
        (len(rb), len(pb)))
    partner = _match(iou, rs, rc, pc, 0.5)
    matched = partner >= 0
    score_gap = max((abs(float(ps[j]) - float(rs[i]))
                     for i, j in enumerate(partner) if j >= 0), default=0.0)
    free = np.ones(len(pb), bool)
    free[partner[matched]] = False
    lost = np.concatenate([rs[~matched], ps[free]])
    gaps, logits = _box_gaps(pb, ps, pc, rb, rs, rc)
    return {"score_gap": score_gap,
            "unmatched_gap": max(0.0, float(lost.max() - cut))
            if len(lost) else 0.0,
            "unmatched": int(len(lost)), "count": int(len(rs) + len(ps)),
            "worst_image_box_gap": float(np.quantile(gaps, 0.25))
            if len(gaps) else 0.0,
            "logit_gaps": [logits]}


def _box_gaps(pb, ps, pc, rb, rs, rc):
    """One minus each detection's best same-class IoU with the other side
    (program then reference), and the logit gaps of the pairs whose best
    IoU is 0.9 or more."""
    gaps, logits = [], []
    for (ab, a_s, ac), (bb, b_s, bc) in (((pb, ps, pc), (rb, rs, rc)),
                                         ((rb, rs, rc), (pb, ps, pc))):
        if not len(ab):
            continue
        if not len(bb):
            gaps.append(np.ones(len(ab)))
            continue
        iou = np.where(ac[:, None] == bc[None, :], iou_matrix(ab, bb), 0.0)
        best, j = iou.max(1), iou.argmax(1)
        gaps.append(1.0 - best)
        near = best >= 0.9
        logits.append(np.abs(_logit(a_s[near]) - _logit(b_s[j[near]])))
    return (np.concatenate(gaps) if gaps else np.zeros(0),
            np.concatenate(logits) if logits else np.zeros(0))


def _logit(s: np.ndarray) -> np.ndarray:
    s = np.clip(np.asarray(s, np.float64), 1e-7, 1 - 1e-7)
    return np.log(s / (1 - s))


def _match(iou: np.ndarray, rs: np.ndarray, rc: np.ndarray, pc: np.ndarray,
           least: float) -> np.ndarray:
    """Each reference detection, in descending score, takes the unmatched
    program detection of its class with the highest IoU where that is
    ``least`` or more -> the program index per reference detection, -1
    where none."""
    free = np.ones(len(pc), bool)
    partner = np.full(len(rs), -1)
    for i in np.argsort(-rs, kind="stable"):
        cand = np.where(free & (pc == rc[i]), iou[i], -1.0)
        if not len(cand):
            continue
        j = int(np.argmax(cand))
        if cand[j] >= least:
            free[j] = False
            partner[i] = j
    return partner


def empty() -> dict:
    return {"score_gap": 0.0, "unmatched_gap": 0.0, "unmatched": 0,
            "count": 0, "worst_image_box_gap": 0.0, "logit_gaps": []}


def detections(programs: Iterable[Dict[str, np.ndarray]],
               ref: Dict[str, np.ndarray], max_detections: int,
               score_thresh: float) -> dict:
    """The worst numbers over every image of every program output of one
    batch, held against the reference's output of that batch."""
    out = empty()
    for prog in programs:
        for i in range(ref["valid"].shape[0]):
            one = image_numbers({k: v[i] for k, v in prog.items()},
                                {k: v[i] for k, v in ref.items()},
                                max_detections, score_thresh)
            merge(out, one)
    return out


def merge(into: dict, one: dict) -> dict:
    for k in ("score_gap", "unmatched_gap", "worst_image_box_gap"):
        into[k] = max(into[k], one[k])
    for k in ("unmatched", "count"):
        into[k] += one[k]
    into["logit_gaps"] = into["logit_gaps"] + one["logit_gaps"]
    return into


def summary(numbers: dict) -> Dict[str, float]:
    """The numbers of merged counts."""
    count = max(numbers["count"], 1)
    logits = [g for g in numbers["logit_gaps"] if len(g)]
    return {"score_gap": numbers["score_gap"],
            "unmatched_gap": numbers["unmatched_gap"],
            "miss": numbers["unmatched"] / count,
            "worst_image_box_gap": numbers["worst_image_box_gap"],
            "logit_gap": float(np.median(np.concatenate(logits)))
            if len(logits) else NO_OUTPUT}


NO_OUTPUT = 1.0e6


def output_gaps(prog, ref) -> Dict[str, float]:
    """``first_<name>_gap`` of each named tensor (see the module's
    docstring)."""
    out = {}
    for name, r in ref.items():
        p = prog.get(name)
        if p is None or tuple(p.shape) != tuple(r.shape):
            out[f"first_{name}_gap"] = NO_OUTPUT
            continue
        p, r = np.asarray(p, np.float64), np.asarray(r, np.float64)
        out[f"first_{name}_gap"] = float(np.sqrt(np.mean((p - r) ** 2))
                                         / np.std(r))
    return out


def output_stats(prog, ref) -> Dict[str, list]:
    """Other readings of the same differences (for finding why): per
    tensor, the mean absolute difference over the reference's mean
    absolute deviation, and the largest absolute difference."""
    out = {}
    for name, r in ref.items():
        p = prog.get(name)
        if p is None or tuple(p.shape) != tuple(r.shape):
            continue
        p, r = np.asarray(p, np.float64), np.asarray(r, np.float64)
        d = np.abs(p - r)
        out[name] = [float(d.mean() / np.abs(r - r.mean()).mean()),
                     float(d.max())]
    return out


def training(prog: dict, ref: dict, floor: float = 1e-3) -> Dict[str,
                                                                float]:
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                       ref["losses"]))
    norm_gap = max(abs(a - b) / b for a, b in zip(prog["grad_norms"],
                                                  ref["grad_norms"]))
    g = ref["grad"]
    med = statistics.median(g.values())
    grad = [abs(prog["grad"][k] - g[k]) / max(g[k], med) for k in g]
    moved = [k for k in g if g[k] >= floor * med]
    c = ref["change"]
    med_c = statistics.median(c[k] for k in moved)
    change = [abs(prog["change"][k] - c[k]) / max(c[k], med_c)
              for k in moved]
    return {"loss1_gap": abs(prog["losses"][0] - ref["losses"][0])
            / abs(ref["losses"][0]),
            "grad_norm1_gap": abs(prog["grad_norms"][0] - ref["grad_norms"][0])
            / ref["grad_norms"][0],
            "loss_gap": loss_gap, "grad_norm_gap": norm_gap,
            "grad_gap": max(grad),
            "grad_median_gap": statistics.median(grad),
            "update_gap": max(change),
            "update_median_gap": statistics.median(change),
            **output_gaps(prog.get("outputs", {}), ref.get("outputs", {}))}


def worst_leaves(prog: dict, ref: dict, n: int = 3,
                 floor: float = 1e-3) -> dict:
    """The leaves behind ``grad_gap`` and ``update_gap``, largest first:
    ``[name, program norm, reference norm]`` (for finding why)."""
    g, c = ref["grad"], ref["change"]
    med = statistics.median(g.values())
    moved = [k for k in g if g[k] >= floor * med]
    med_c = statistics.median(c[k] for k in moved)
    grad = sorted(g, key=lambda k: -abs(prog["grad"][k] - g[k])
                  / max(g[k], med))[:n]
    change = sorted(moved, key=lambda k: -abs(prog["change"][k] - c[k])
                    / max(c[k], med_c))[:n]
    return {"grad": [[k, prog["grad"][k], g[k]] for k in grad],
            "change": [[k, prog["change"][k], c[k]] for k in change]}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> List:
    """``[(name, value, limit, passed)]`` for each limited number."""
    return [(k, float(numbers[k]), float(limits[k]),
             float(numbers[k]) <= float(limits[k])) for k in limits]
