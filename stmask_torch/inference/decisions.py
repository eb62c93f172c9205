"""Two runs of the TF eval step held against each other decision by
decision: the port against the JAX package on the CPU
(``tests/test_torch_eval_bf16_step.py``) and the card against the CPU
(``chip_smoke.py``), in bf16.

Both runs take the same tracker state into each step (the reference run's
state after the step before), so a decision the two take apart changes
that step only.  A run's step is a dict of CPU tensors, every one leading
with the lane axis [B]: ``preds`` (the forward's decode-side outputs,
``proto``, ``fpn_feat`` and ``T2S_feat``), ``det`` (``Detections``), the
tracker's record (``state_in``, ``shifted``, ``det_masks_soft``, ``comp``;
``tracker.track_step_tf_lanes``) and the new ``state`` and ``out``; the
port's ``video_chunk(..., record=[])`` writes one a step.

``compare_step`` re-derives each run's decisions from that run's own
numbers, with the port's functions (the NMS of ``detect_frame_lanes``
under ``cc`` or ``greedy``, and the tracker's match), and checks that they
give that run's detections.  The decisions, by kind:

  prefilter   a prior's (cc) or a prior and class's (greedy) confidence
              against its threshold;
  class       cc: the argmax of a prior's class scores;
  topk        a candidate inside the top ``nms_top_k`` (where the cut
              binds);
  rank        the order of two candidates (score difference against 0;
              under greedy within a class, and among the survivors);
  nms         two candidates' IoU against ``nms_thresh``;
  capacity    a survivor inside the ``det_capacity`` detections;
  active      a slot among the shift's active slots (its score against
              ``eval_conf_thresh``; the same state in, so never apart);
  crop        a mask pixel inside its box's crop (the pixel's distance
              from the nearest edge of the crop, in pixels);
  shift_mask  a pixel of a shifted track mask against 0.5;
  det_mask    a pixel of a detection's soft mask against 0.5;
  match       a detection's match-score argmax over the slots;
  new_id      the same argmax where one run picks the new-object column;
  winner      the detection a track keeps when several match it;
  keep_score  a new slot's score against ``eval_conf_thresh``;
  out_mask    a pixel of a kept slot's output mask against 0.5.

Where the two runs decide an entry alike, the quantity's difference
between the runs is taken; ``Ledger.check`` holds every entry decided
apart to lie within twice the largest such difference of its kind (over
the whole run) of the boundary, on both sides.  For an argmax the
quantity is the gap between two columns.  Values compared where the
decisions agree (detections paired by prior and class; slots by id,
class and the detection they took, if any; mask pixels inside the crop on
both sides): ``Ledger.values``.  ``compare_step`` raises where a lane's
detections differ without a detection decision apart in that lane, or its
new state or keep flags without any decision apart.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..config import STMaskConfig
from ..kernels.greedy_nms import greedy_nms_mask_reference, plus_one_iou
from ..ops.boxes import crop, decode, jaccard, sanitize_coordinates
from ..ops.nms import NEG_INF, _top_k_padded
from .candidates import _map

KINDS = ('prefilter', 'class', 'topk', 'rank', 'nms', 'capacity', 'active',
         'crop', 'shift_mask', 'det_mask', 'match', 'new_id', 'winner',
         'keep_score', 'out_mask')
DETECT_KINDS = KINDS[:6]
VALUE_FIELDS = {
    'preds': ('loc', 'conf', 'centerness', 'mask_coeff', 'track', 'proto',
              'fpn_feat', 'T2S_feat'),
    'det': ('box', 'score', 'mask_coeff', 'track', 'centerness'),
    'shift': ('box', 'mask_coeff', 'mask'),
    'state': ('box', 'score', 'mask_coeff', 'track', 'mask')}


def to_cpu(x):
    """A step's dict (or NamedTuple, or tensor) with every tensor on the
    CPU, floating ones in fp32 (bf16 features widen exactly)."""
    def one(t):
        t = t.detach().cpu()
        return t.float() if t.is_floating_point() else t
    return _map(one, x)


class Kind:
    """One kind's tally over a run: entries compared, entries apart, the
    largest difference of the quantity where the runs agree, and the
    largest distance from the boundary (the larger of the two runs') of
    an entry apart."""

    def __init__(self):
        self.n = 0
        self.apart = 0
        self.agree = 0.0
        self.near = 0.0

    @property
    def margin(self) -> float:
        return 2.0 * self.agree


class Ledger:
    """The decisions and values of a run of steps (``compare_step``)."""

    def __init__(self):
        self.kinds: Dict[str, Kind] = {k: Kind() for k in KINDS}
        self.values: Dict[Tuple[str, str], float] = {}
        self.lane_apart: Dict[Tuple[int, int], Dict[str, int]] = {}
        self.step = 0

    # -- tallies -----------------------------------------------------------
    def _tally(self, kind: str, lane: int, apart: torch.Tensor,
               diff: torch.Tensor, near: torch.Tensor,
               entries: Optional[int] = None) -> None:
        k = self.kinds[kind]
        k.n += int(apart.numel()) if entries is None else entries
        n = int(apart.sum())
        agree = diff[~apart]
        if agree.numel():
            k.agree = max(k.agree, float(agree.max()))
        if n:
            k.apart += n
            k.near = max(k.near, float(near[apart].max()))
            cell = self.lane_apart.setdefault((self.step, lane), {})
            cell[kind] = cell.get(kind, 0) + n

    def threshold(self, kind: str, lane: int, qa: torch.Tensor,
                  qb: torch.Tensor, bound: float,
                  dec_a: Optional[torch.Tensor] = None,
                  dec_b: Optional[torch.Tensor] = None) -> None:
        """Entries decided by ``q > bound`` (or by the given decisions):
        the quantity's difference and each side's distance from the
        boundary."""
        qa, qb = qa.double().flatten(), qb.double().flatten()
        dec_a = qa > bound if dec_a is None else dec_a.flatten()
        dec_b = qb > bound if dec_b is None else dec_b.flatten()
        near = torch.maximum((qa - bound).abs(), (qb - bound).abs())
        self._tally(kind, lane, dec_a != dec_b, (qa - qb).abs(), near)

    def argmax(self, kind: str, lane: int, ra: torch.Tensor,
               rb: torch.Tensor, alt: Optional[str] = None,
               alt_col: int = 0) -> None:
        """Rows [N, M] decided by their argmax (the first maximum).  The
        quantity is the gap between two columns: its difference between the
        runs is at most the spread of the row's differences; a row apart
        lies at the larger of its two gaps between the runs' choices.  With
        ``alt``, a row apart where exactly one run picks ``alt_col`` counts
        under ``alt``."""
        if ra.numel() == 0:
            return
        ra, rb = ra.double(), rb.double()
        ia, ib = ra.argmax(dim=-1), rb.argmax(dim=-1)
        d = ra - rb
        spread = d.max(dim=-1).values - d.min(dim=-1).values
        ga = (ra.gather(-1, ia[:, None]) - ra.gather(-1, ib[:, None]))[:, 0]
        gb = (rb.gather(-1, ib[:, None]) - rb.gather(-1, ia[:, None]))[:, 0]
        near = torch.maximum(ga, gb)
        apart = ia != ib
        if alt is None:
            self._tally(kind, lane, apart, spread, near)
            return
        other = (ia == alt_col) != (ib == alt_col)
        self._tally(kind, lane, apart & ~other, spread, near)
        self._tally(alt, lane, apart & other, spread, near, entries=0)

    def pairs(self, kind: str, lane: int, sa: torch.Tensor,
              sb: torch.Tensor) -> None:
        """The order of every pair i < j of entries scored [N]: i first
        when s_i >= s_j (a stable descending sort), on each side."""
        n = sa.numel()
        if n < 2:
            return
        i, j = torch.triu_indices(n, n, 1)
        qa = sa.double()[i] - sa.double()[j]
        qb = sb.double()[i] - sb.double()[j]
        self.threshold(kind, lane, qa, qb, 0.0, qa >= 0, qb >= 0)

    def value(self, group: str, field: str, a: torch.Tensor,
              b: torch.Tensor) -> None:
        if a.numel():
            d = float((a.double() - b.double()).abs().max())
            key = (group, field)
            self.values[key] = max(self.values.get(key, 0.0), d)

    # -- the verdict -------------------------------------------------------
    def apart_in(self, step: int, lane: int, kinds=KINDS) -> int:
        cell = self.lane_apart.get((step, lane), {})
        return sum(cell.get(k, 0) for k in kinds)

    def total_apart(self) -> int:
        return sum(k.apart for k in self.kinds.values())

    def where(self, kind: str) -> str:
        return '; '.join(f'step {s} lane {b}: {c[kind]}' for (s, b), c in
                         sorted(self.lane_apart.items()) if kind in c)

    def check(self, tolerances: Dict[Tuple[str, str], float]) -> None:
        """Every entry apart within its kind's margin of the boundary on
        both sides; every value compared within its tolerance."""
        for name, k in self.kinds.items():
            assert k.apart == 0 or k.near <= k.margin, (
                f'{name}: {k.apart} decisions apart, one at {k.near:.3e} '
                f'from its boundary, past the margin {k.margin:.3e} '
                f'({self.where(name)})')
        for key, d in self.values.items():
            if key in tolerances:
                assert d <= tolerances[key], (key, d, tolerances[key])

    def lines(self, tag: str) -> List[str]:
        out = []
        for name, k in self.kinds.items():
            out.append(f'{tag} {name}: {k.apart} of {k.n} apart, margin '
                       f'{k.margin:.3e} (agreeing entries differ by at most '
                       f'{k.agree:.3e}), entries apart within {k.near:.3e} '
                       f'of the boundary'
                       + (f' [{self.where(name)}]' if k.apart else ''))
        out.append(f'{tag} values (max|diff| where the decisions agree): '
                   + ', '.join(f'{g}.{f} {d:.3e}'
                               for (g, f), d in sorted(self.values.items())))
        return out

    def counts(self) -> Dict[str, int]:
        return {name: k.apart for name, k in self.kinds.items()}


# -- the detections, re-derived ---------------------------------------------
def _cut(s: torch.Tensor, k: int) -> Optional[float]:
    """The k-th largest of the valid scores s, or None when k or fewer are
    valid (no cut)."""
    valid = s[s > NEG_INF / 2]
    if valid.numel() <= k:
        return None
    return float(torch.sort(valid, descending=True).values[k - 1])


def _cc_view(cfg: STMaskConfig, preds: dict, priors: torch.Tensor,
             lane: int) -> dict:
    """One lane's cc NMS written out (``detect_frame_lanes``)."""
    boxes = decode(preds['loc'][lane], priors)
    fg = preds['conf'][lane, :, 1:]
    conf_max = fg.max(dim=-1).values
    passed = conf_max > cfg.eval_conf_thresh
    s = torch.where(passed, conf_max * preds['centerness'][lane, :, 0],
                    NEG_INF)
    top_s, cand = _top_k_padded(s, cfg.nms_top_k)
    cand = cand[top_s > NEG_INF / 2]
    bk = boxes[cand]
    iou_max = torch.triu(jaccard(bk, bk), diagonal=1).max(dim=0).values \
        if cand.numel() else cand.float()
    surv = cand[iou_max <= cfg.nms_thresh]
    d = min(cfg.det_capacity, cfg.nms_top_k)
    det = surv[:d]
    return dict(boxes=boxes, fg=fg, conf_max=conf_max, passed=passed, s=s,
                cand=cand, surv=surv, det=det,
                keys=[(int(p), int(fg[p].argmax()) + 1) for p in det],
                det_score=s[det])


def _greedy_view(cfg: STMaskConfig, preds: dict, priors: torch.Tensor,
                 lane: int) -> dict:
    """One lane's per-class greedy NMS written out (``ops/nms.py::
    greedy_nms_per_class`` with B5's plain version)."""
    boxes = decode(preds['loc'][lane], priors)
    sc = preds['conf'][lane, :, 1:].transpose(0, 1)              # [C-1, P]
    masked = torch.where(sc > cfg.nms_conf_thresh, sc, NEG_INF)
    top_s, cand = _top_k_padded(masked, cfg.nms_top_k)           # [C-1, K]
    cvalid = top_s > NEG_INF / 2
    scale = float(max(cfg.pad_w, cfg.pad_h))
    keep = greedy_nms_mask_reference(plus_one_iou(boxes[cand] * scale),
                                     cvalid, cfg.nms_thresh)
    n_fg, k = cand.shape
    flat = torch.where(keep, top_s, NEG_INF).flatten()
    best, order = _top_k_padded(flat, min(cfg.det_capacity, cfg.nms_top_k))
    order = order[best > NEG_INF / 2]
    cls = order // k
    det = cand.flatten()[order]
    surv_c, surv_k = torch.nonzero(keep, as_tuple=True)
    return dict(boxes=boxes, sc=sc, masked=masked, cand=cand,
                cvalid=cvalid, scale=scale,
                surv=list(zip(cand[surv_c, surv_k].tolist(),
                              (surv_c + 1).tolist())),
                surv_score=top_s[surv_c, surv_k],
                keys=list(zip(det.tolist(), (cls + 1).tolist())),
                det_score=flat[order])


def _common(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The entries of a that are also in b, in ascending order."""
    return torch.tensor(sorted(set(a.tolist()) & set(b.tolist())),
                        dtype=torch.long)


def _cut_decisions(led: Ledger, kind: str, lane: int, entries, sa, sb,
                   ina, inb, cut_a, cut_b, upstream: int) -> None:
    """Entries kept by a cut at the K-th score (top-k, capacity): where
    both runs cut, a threshold decision at each run's K-th score; where
    one run does not cut, the entries apart must follow from decisions
    apart upstream in the same lane."""
    if cut_a is None and cut_b is None:
        return
    if cut_a is not None and cut_b is not None:
        led.threshold(kind, lane, sa - cut_a, sb - cut_b, 0.0, ina, inb)
        return
    apart = ina != inb
    assert upstream or not bool(apart.any()), (
        f'step {led.step} lane {lane}: {int(apart.sum())} {kind} decisions '
        'apart with no decision apart upstream')
    zeros = torch.zeros(len(entries))
    led._tally(kind, lane, apart, zeros, zeros)


def _detect_cc(cfg, led: Ledger, lane: int, va: dict, vb: dict) -> None:
    led.threshold('prefilter', lane, va['conf_max'], vb['conf_max'],
                  cfg.eval_conf_thresh)
    both = va['passed'] & vb['passed']
    led.argmax('class', lane, va['fg'][both], vb['fg'][both])
    k = cfg.nms_top_k
    passed = torch.nonzero(both).flatten()
    ca, cb = set(va['cand'].tolist()), set(vb['cand'].tolist())
    _cut_decisions(led, 'topk', lane, passed, va['s'][passed],
                   vb['s'][passed],
                   torch.tensor([p in ca for p in passed.tolist()]),
                   torch.tensor([p in cb for p in passed.tolist()]),
                   _cut(va['s'], k), _cut(vb['s'], k),
                   led.apart_in(led.step, lane, ('prefilter',)))
    common = _common(va['cand'], vb['cand'])
    led.pairs('rank', lane, va['s'][common], vb['s'][common])
    if common.numel() > 1:
        i, j = torch.triu_indices(common.numel(), common.numel(), 1)
        ba, bb = va['boxes'][common], vb['boxes'][common]
        led.threshold('nms', lane, jaccard(ba, ba)[i, j],
                      jaccard(bb, bb)[i, j], cfg.nms_thresh)
    surv = _common(va['surv'], vb['surv'])
    d = min(cfg.det_capacity, cfg.nms_top_k)
    da, db = set(va['det'].tolist()), set(vb['det'].tolist())
    sa_surv = torch.sort(va['s'][va['surv']], descending=True).values
    sb_surv = torch.sort(vb['s'][vb['surv']], descending=True).values
    _cut_decisions(
        led, 'capacity', lane, surv, va['s'][surv], vb['s'][surv],
        torch.tensor([p in da for p in surv.tolist()]),
        torch.tensor([p in db for p in surv.tolist()]),
        float(sa_surv[d - 1]) if sa_surv.numel() > d else None,
        float(sb_surv[d - 1]) if sb_surv.numel() > d else None,
        led.apart_in(led.step, lane, DETECT_KINDS))


def _detect_greedy(cfg, led: Ledger, lane: int, va: dict, vb: dict) -> None:
    led.threshold('prefilter', lane, va['sc'], vb['sc'],
                  cfg.nms_conf_thresh)
    k = cfg.nms_top_k
    upstream = led.apart_in(led.step, lane, ('prefilter',))
    for c in range(va['sc'].shape[0]):
        both = torch.nonzero((va['masked'][c] > NEG_INF / 2)
                             & (vb['masked'][c] > NEG_INF / 2)).flatten()
        ca = set(va['cand'][c][va['cvalid'][c]].tolist())
        cb = set(vb['cand'][c][vb['cvalid'][c]].tolist())
        _cut_decisions(led, 'topk', lane, both, va['sc'][c, both],
                       vb['sc'][c, both],
                       torch.tensor([p in ca for p in both.tolist()]),
                       torch.tensor([p in cb for p in both.tolist()]),
                       _cut(va['masked'][c], k), _cut(vb['masked'][c], k),
                       upstream)
        common = torch.tensor(sorted(ca & cb), dtype=torch.long)
        led.pairs('rank', lane, va['sc'][c, common], vb['sc'][c, common])
        if common.numel() > 1:
            i, j = torch.triu_indices(common.numel(), common.numel(), 1)
            ia = plus_one_iou(va['boxes'][common] * va['scale'])[i, j]
            ib = plus_one_iou(vb['boxes'][common] * vb['scale'])[i, j]
            led.threshold('nms', lane, ia, ib, cfg.nms_thresh)
    surv = sorted(set(va['surv']) & set(vb['surv']))
    sa = {e: s for e, s in zip(va['surv'], va['surv_score'].tolist())}
    sb = {e: s for e, s in zip(vb['surv'], vb['surv_score'].tolist())}
    sa_s = torch.tensor([sa[e] for e in surv])
    sb_s = torch.tensor([sb[e] for e in surv])
    led.pairs('rank', lane, sa_s, sb_s)
    d = min(cfg.det_capacity, cfg.nms_top_k)
    da, db = set(va['keys']), set(vb['keys'])
    cuts = []
    for table in (sa, sb):
        s = torch.sort(torch.tensor(list(table.values())),
                       descending=True).values
        cuts.append(float(s[d - 1]) if s.numel() > d else None)
    _cut_decisions(led, 'capacity', lane, surv, sa_s, sb_s,
                   torch.tensor([e in da for e in surv]),
                   torch.tensor([e in db for e in surv]), *cuts,
                   led.apart_in(led.step, lane, DETECT_KINDS))


def _view_matches_run(view: dict, det, lane: int, tag: str) -> None:
    """The written-out NMS gives the run's own detections: the same boxes
    and scores in the same order, and no more valid ones."""
    n = len(view['keys'])
    valid = det.valid[lane]
    assert int(valid.sum()) == n and bool(valid[:n].all()), (
        tag, lane, int(valid.sum()), n)
    idx = torch.tensor([p for p, _ in view['keys']], dtype=torch.long)
    torch.testing.assert_close(det.box[lane, :n], view['boxes'][idx],
                               rtol=0, atol=1e-6, msg=f'{tag} boxes')
    torch.testing.assert_close(det.score[lane, :n], view['det_score'],
                               rtol=0, atol=1e-6, msg=f'{tag} scores')
    assert det.cls[lane, :n].tolist() == [c for _, c in view['keys']], tag


# -- the tracker -------------------------------------------------------------
def _winners(led: Ledger, lane: int, ma, mb, pairs, sa, sb) -> None:
    """Slots that several paired detections match on both runs: the
    detection each run keeps (the best score, the earliest on ties)."""
    for slot in sorted(set(ma.tolist())):
        if slot == 0:
            continue
        rows = [n for n, (x, y) in enumerate(zip(ma.tolist(), mb.tolist()))
                if x == slot and y == slot]
        if len(rows) < 2:
            continue
        ia = torch.tensor([pairs[n][0] for n in rows])
        ib = torch.tensor([pairs[n][1] for n in rows])
        led.argmax('winner', lane, sa[ia][None], sb[ib][None])


def compare_step(cfg: STMaskConfig, priors: torch.Tensor, a: dict, b: dict,
                 led: Ledger) -> None:
    """One step of two runs (``a`` the reference) from the same state:
    every decision of ``KINDS`` tallied in ``led``, the values where the
    decisions agree, and the lanes' outputs held to differ only where a
    decision was taken apart."""
    method = cfg.eval_nms_method
    if method not in ('cc', 'greedy') or cfg.nms_as_miou \
            or not cfg.temporal_fusion_module:
        raise ValueError('compare_step: cc or greedy NMS with box IoU and '
                         'the TF tracker')
    a, b = to_cpu(a), to_cpu(b)
    priors = priors.detach().cpu().float()
    for f in VALUE_FIELDS['preds']:
        led.value('preds', f, a['preds'][f], b['preds'][f])
    torch.testing.assert_close(tuple(a['state_in']), tuple(b['state_in']),
                               rtol=0, atol=0, msg='state_in')
    view = _cc_view if method == 'cc' else _greedy_view
    for lane in range(a['det'].box.shape[0]):
        va, vb = (view(cfg, r['preds'], priors, lane) for r in (a, b))
        _view_matches_run(va, a['det'], lane, 'a')
        _view_matches_run(vb, b['det'], lane, 'b')
        (_detect_cc if method == 'cc' else _detect_greedy)(
            cfg, led, lane, va, vb)
        if led.apart_in(led.step, lane, DETECT_KINDS) == 0:
            assert va['keys'] == vb['keys'], (
                f'step {led.step} lane {lane}: the detections differ with '
                'no detection decision apart')
        _track_lane(cfg, led, lane, a, b, va['keys'], vb['keys'])
        if led.apart_in(led.step, lane) == 0:
            for f in ('valid', 'obj_id', 'cls', 'age'):
                assert torch.equal(getattr(a['state'], f)[lane],
                                   getattr(b['state'], f)[lane]), (
                    f'step {led.step} lane {lane}: state {f} differs with no '
                    'decision apart')
            assert torch.equal(a['state'].next_id[lane],
                               b['state'].next_id[lane])
            assert torch.equal(a['out'].keep[lane], b['out'].keep[lane]), (
                f'step {led.step} lane {lane}: keep differs with no decision '
                'apart')
    led.step += 1


def _crop_q(box: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[N, h, w]: each pixel's signed distance, in pixels, from the nearest
    edge of box n's crop (``ops/boxes.py::crop``, padding 1); inside
    where >= 0 on the low edges and > 0 on the high ones."""
    x1, x2 = sanitize_coordinates(box[:, 0], box[:, 2], w, 1)
    y1, y2 = sanitize_coordinates(box[:, 1], box[:, 3], h, 1)
    col = torch.arange(w, dtype=box.dtype)[None, None, :]
    row = torch.arange(h, dtype=box.dtype)[None, :, None]
    return torch.minimum(
        torch.minimum(col - x1[:, None, None], x2[:, None, None] - col),
        torch.minimum(row - y1[:, None, None], y2[:, None, None] - row))


def _masks(led: Ledger, kind: str, lane: int, ma: torch.Tensor,
           mb: torch.Tensor, box_a: torch.Tensor, box_b: torch.Tensor,
           group: str) -> None:
    """Soft masks [N, h, w] cropped by their boxes [N, 4] on each side:
    the crop's decisions, then each pixel inside both crops against 0.5
    and its value."""
    if ma.numel() == 0:
        return
    h, w = ma.shape[-2:]
    qa, qb = _crop_q(box_a, h, w), _crop_q(box_b, h, w)
    ina = crop(torch.ones(*ma.shape[:-3], h, w, ma.shape[-3]), box_a)[0]
    inb = crop(torch.ones(*mb.shape[:-3], h, w, mb.shape[-3]), box_b)[0]
    ina, inb = (m.movedim(-1, -3) > 0 for m in (ina, inb))
    led.threshold('crop', lane, qa, qb, 0.0, ina, inb)
    both = ina & inb
    led.threshold(kind, lane, ma[both], mb[both], 0.5)
    led.value(group, 'mask', ma[both], mb[both])


def _sources(det, state, lane: int, keys) -> List:
    """The detection key each slot of a new state copied (its box and
    coefficients equal to the detection's), or None (a shifted or older
    track)."""
    n = len(keys)
    box = det.box[lane, :n]
    coeff = det.mask_coeff[lane, :n]
    out = []
    for s in range(state.box.shape[1]):
        hit = ((box == state.box[lane, s]).all(dim=-1)
               & (coeff == state.mask_coeff[lane, s]).all(dim=-1))
        idx = torch.nonzero(hit).flatten()
        out.append(keys[int(idx[0])] if idx.numel() else None)
    return out


def _track_lane(cfg, led: Ledger, lane: int, a: dict, b: dict, keys_a,
                keys_b) -> None:
    def active(st):
        return st.valid[lane] & ~((st.score[lane] <= cfg.eval_conf_thresh)
                                  & (st.age[lane]
                                     > cfg.max_tracked_mask_age))
    sia, sib = a['state_in'], b['state_in']
    live = sia.valid[lane]
    led.threshold('active', lane, sia.score[lane][live],
                  sib.score[lane][live], cfg.eval_conf_thresh,
                  active(sia)[live], active(sib)[live])
    sha, shb = a['shifted'], b['shifted']
    live = sha.valid[lane] & shb.valid[lane]
    _masks(led, 'shift_mask', lane, sha.mask[lane][live],
           shb.mask[lane][live], sha.box[lane][live], shb.box[lane][live],
           'shift')
    for f in ('box', 'mask_coeff'):
        led.value('shift', f, getattr(sha, f)[lane][live],
                  getattr(shb, f)[lane][live])

    where_b = {k: n for n, k in enumerate(keys_b)}
    pairs = [(n, where_b[k]) for n, k in enumerate(keys_a) if k in where_b]
    ia = torch.tensor([p for p, _ in pairs], dtype=torch.long)
    ib = torch.tensor([q for _, q in pairs], dtype=torch.long)
    da, db = a['det'], b['det']
    for f in VALUE_FIELDS['det']:
        led.value('det', f, getattr(da, f)[lane][ia],
                  getattr(db, f)[lane][ib])
    _masks(led, 'det_mask', lane, a['det_masks_soft'][lane][ia],
           b['det_masks_soft'][lane][ib], da.box[lane][ia], db.box[lane][ib],
           'det')
    ra, rb = a['comp'][lane][ia], b['comp'][lane][ib]
    led.argmax('match', lane, ra, rb, alt='new_id', alt_col=0)
    if pairs:
        _winners(led, lane, ra.argmax(-1), rb.argmax(-1), pairs,
                 da.score[lane], db.score[lane])

    na, nb = a['state'], b['state']
    src = torch.tensor([x == y for x, y in zip(_sources(da, na, lane, keys_a),
                                                _sources(db, nb, lane,
                                                         keys_b))])
    same = (na.valid[lane] & nb.valid[lane] & src
            & (na.obj_id[lane] == nb.obj_id[lane])
            & (na.cls[lane] == nb.cls[lane]))
    led.threshold('keep_score', lane, na.score[lane][same],
                  nb.score[lane][same], cfg.eval_conf_thresh)
    _masks(led, 'out_mask', lane, na.mask[lane][same], nb.mask[lane][same],
           na.box[lane][same], nb.box[lane][same], 'state')
    for f in VALUE_FIELDS['state']:
        if f != 'mask':
            led.value('state', f, getattr(na, f)[lane][same],
                      getattr(nb, f)[lane][same])
