"""The default bf16 eval (the lane step, detect, the TF tracker and the
results JSON) against the JAX package's bf16 path (``eval.py --bf16``:
``cast_params``, bf16 features in the tracker state), decision by
decision (``stmask_torch/inference/decisions.py``).

The reference takes the TPU's route on the CPU.  On the CPU the JAX
package's ``candidate_shift`` would run the XLA correlation
(``ops/correlation.py:35-36`` picks Pallas only on a TPU), which returns
bf16 for bf16 features, so the concatenation, RoIAlign and the TemporalNet
would run in bf16; on the TPU the Pallas kernel returns fp32
(``correlation_pallas.py:55``) and all three run in fp32.  So the JAX
step's correlation is ``correlate_pallas`` in interpret mode here (the
name ``stmask_tpu.inference.tracker.correlate`` patched while the module's
tests run): its output is fp32, and the TemporalNet's input is fp32,
both checked in ``test_reference_takes_the_tpu_route``.  Interpret mode
does not round the bf16 products to bf16 as the TPU does (ROADMAP C.4);
the port's correlation rounds them, as the TPU.

The reduced flagship (``torch_eval_common``: 96x128, ``layers=(1, 3, 3,
1)``, 16 track slots, weights that detect and track), 2 lanes x 4 frames:
lane 0 one video, lane 1 a video of 2 frames and then another from step 2.
Each step starts both sides from JAX's state after the step before, so a
decision taken apart changes one step only.  Two comparisons a step:

  * the step: each side's own forward, detections and tracker
    (``build_video_step_batched``'s chunk with ``record=[]`` on the port);
  * the modules: the port's detect and tracker on JAX's forward outputs,
    detections and features (in fp32 but for the bf16 correlation).

Values where the decisions agree are held to TOL (the step) and
MODULE_TOL (the modules), measured in these runs (2x the largest, rounded
up); each decision taken apart must lie within twice the largest
difference of its quantity among the entries decided alike of its
boundary, on both sides.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import stmask_tpu.inference.tracker as JT
from stmask_tpu.data.transforms import normalize_pad_device
from stmask_tpu.inference import cast_params
from stmask_tpu.inference.candidates import detect_frame as j_detect_frame
from stmask_tpu.kernels.correlation_pallas import correlate_pallas
from stmask_tpu.models import STMask as JSTMask
from stmask_tpu.ops.anchors import all_priors as j_all_priors
from stmask_tpu.ops.correlation import correlate as j_correlate_xla
from stmask_tpu.ops.masks import generate_mask as j_generate_mask

from stmask_torch import config as t_config
from stmask_torch import eval as t_eval
from stmask_torch.convert import state_dict_from_flax
from stmask_torch.data.synthetic import write_ytvis_set
from stmask_torch.inference import decisions as DEC
from stmask_torch.inference.candidates import Detections
from stmask_torch.inference.pipeline import (build_video_step_batched,
                                             detect_and_rescore)
from stmask_torch.inference.tracker import TrackState, track_step_tf_lanes
from stmask_torch.ops.anchors import all_priors
from stmask_torch.utils import rle

from torch_eval_common import JCFG, TCFG, flax_params, port_model
from torch_eval_common import few_torch_threads  # noqa: F401
from torch_eval_common import port_mask_values  # noqa: F401

B = 2
N_STEPS = 4
NAME = 'STMask_plus_resnet50_bf16step'

# values where the decisions agree, the port's bf16 step against JAX's:
# twice the largest difference, rounded up, over the cc and greedy runs on
# an Intel Xeon (AMX) host with oneDNN v3.12.0 limited to each of its AMX,
# AVX512-BF16, AVX512 and AVX2 kernels (ONEDNN_MAX_CPU_ISA), which round
# the port's bf16 convolutions in other orders.  The largest: preds loc
# 1.56e-2, conf 2.95e-2, centerness 1.27e-2, mask_coeff 1.95e-2, track
# 4.88e-3, proto 1.17e-2, fpn_feat 4.69e-2, T2S_feat 3.13e-2; det box
# 9.56e-4, score 2.56e-2, mask_coeff 1.56e-2, track 4.15e-3, centerness
# 1.27e-2, mask 8.22e-3; shift box 7.83e-5, mask_coeff 1.22e-3, mask
# 5.70e-3; state box 6.76e-4, score 1.89e-2, mask_coeff 1.56e-2, track
# 3.91e-3, mask 6.99e-3
TOL = {('preds', 'loc'): 4e-2, ('preds', 'conf'): 6e-2,
       ('preds', 'centerness'): 3e-2, ('preds', 'mask_coeff'): 4e-2,
       ('preds', 'track'): 1e-2, ('preds', 'proto'): 3e-2,
       ('preds', 'fpn_feat'): 1e-1, ('preds', 'T2S_feat'): 7e-2,
       ('det', 'box'): 2e-3, ('det', 'score'): 6e-2,
       ('det', 'mask_coeff'): 4e-2, ('det', 'track'): 9e-3,
       ('det', 'centerness'): 3e-2, ('det', 'mask'): 2e-2,
       ('shift', 'box'): 2e-4, ('shift', 'mask_coeff'): 3e-3,
       ('shift', 'mask'): 2e-2, ('state', 'box'): 2e-3,
       ('state', 'score'): 4e-2, ('state', 'mask_coeff'): 4e-2,
       ('state', 'track'): 8e-3, ('state', 'mask'): 2e-2}
# the port's detect and tracker on JAX's inputs: the detections are
# gathers of the same numbers (0), the boxes one decode apart (1.19e-7);
# the tracker differs by the correlation's bf16 products, which the port
# rounds and interpret mode does not, and by the fp32 sums' order (over
# the same runs: shift box 9.54e-7, mask_coeff 2.15e-5, mask 4.02e-6;
# state box 5.36e-7, mask_coeff 1.18e-5, mask 1.94e-6, or a shifted
# mask's); twice those, rounded up
MODULE_TOL = {('det', 'box'): 3e-7, ('det', 'score'): 0.0,
              ('det', 'mask_coeff'): 0.0, ('det', 'track'): 0.0,
              ('det', 'centerness'): 0.0, ('det', 'mask'): 3e-7,
              ('shift', 'box'): 2e-6, ('shift', 'mask_coeff'): 5e-5,
              ('shift', 'mask'): 9e-6, ('state', 'box'): 2e-6,
              ('state', 'score'): 0.0, ('state', 'mask_coeff'): 3e-5,
              ('state', 'track'): 0.0, ('state', 'mask'): 9e-6}
# how far the route the JAX package takes on the CPU (the XLA correlation
# in bf16, a bf16 TemporalNet) sits from the TPU route at least: half of
# what was measured (shifted box 1.12e-4, mask_coeff 1.63e-3, mask
# 2.26e-4), rounded down
ROUTE_GAP = {'box': 5e-5, 'mask_coeff': 8e-4, 'mask': 1e-4}


def _video(seed, n):
    rng = np.random.RandomState(seed)
    h, w = TCFG.img_h, TCFG.img_w
    coarse = rng.rand(h // 16 + 2, w // 16 + 2, 3)
    base = np.kron(coarse, np.ones((16, 16, 1)))[:h, :w]
    frame = np.clip(base * 200 + rng.rand(h, w, 3) * 55, 0, 255)
    return [np.roll(frame, (2 * i, 3 * i), axis=(0, 1)).astype(np.uint8)
            for i in range(n)]


def _schedule():
    """[N_STEPS, B] uint8 frames and is_first: lane 1 restarts at step 2."""
    videos = {'A': _video(21, 4), 'B': _video(22, 2), 'C': _video(23, 2)}
    plan = [[('A', 0), ('B', 0)], [('A', 1), ('B', 1)],
            [('A', 2), ('C', 0)], [('A', 3), ('C', 1)]]
    frames = np.stack([np.stack([videos[v][f] for v, f in row])
                       for row in plan])
    first = np.array([[f == 0 for _, f in row] for row in plan])
    return frames, first


# -- the JAX side ------------------------------------------------------------
def _tpu_route_correlate(seen):
    def correlate(x1, x2, patch_size=11, apply_activation=True,
                  use_pallas=False):
        out = correlate_pallas(x1, x2, patch_size, apply_activation)
        seen['correlation'] = out.dtype
        return out
    return correlate


def _jax_step(jcfg, jmodel, seen):
    """JAX's bf16 lane step (``pipeline.py:144-179``: the forward on the
    bf16 frames, ``detect_frame`` and ``track_step_tf`` under ``vmap``),
    jitted, returning besides the new states and outputs what the step
    decides on: the forward's outputs, the detections and the tracker's
    bank after the reset and after the shift, the soft detection masks and
    the match scores (the package's own functions, in ``track_step_tf``'s
    order)."""
    priors = jnp.asarray(j_all_priors(jcfg))
    normalize_pad = normalize_pad_device(jcfg)
    keys = ('loc', 'conf', 'mask_coeff', 'track', 'centerness')

    def step(params, states, frames, first):
        preds = jmodel.apply(params, normalize_pad(frames).astype(
            jnp.bfloat16), train=False)

        def temporal_net(x):
            seen['temporal_net'] = x.dtype
            return jmodel.apply(params, x, method=JSTMask.temporal_shift)

        def det_one(loc, conf, coeff, track, cent, proto):
            return j_detect_frame(jcfg, dict(zip(keys, (loc, conf, coeff,
                                                        track, cent))),
                                  priors, proto=proto)

        dets = jax.vmap(det_one)(*(preds[k] for k in keys), preds['proto'])

        def track_one(state, det, proto, fpn, t2s, first):
            new, out = JT.track_step_tf(jcfg, temporal_net, state, det,
                                        proto, fpn, t2s, first)
            empty = JT.init_state(jcfg, fpn.shape[:2], proto.shape[:2],
                                  fpn.shape[-1], state.track.shape[-1],
                                  fpn.dtype)
            s_in = jax.tree_util.tree_map(
                lambda e, s: jnp.where(first, e, s), empty, state)
            shifted = JT.candidate_shift(jcfg, temporal_net, s_in, fpn, t2s,
                                         proto)
            prev = jnp.any(s_in.valid)
            shifted = jax.tree_util.tree_map(
                lambda x, y: jnp.where(prev, x, y), shifted, s_in)
            soft = j_generate_mask(proto, det.mask_coeff, det.box)
            comp = JT._comp_scores(jcfg, det, (soft > 0.5).astype(
                jnp.float32), shifted)
            return new, out, dict(state_in=s_in, shifted=shifted,
                                  det_masks_soft=soft, comp=comp)

        new, out, rec = jax.vmap(track_one)(
            states, dets, preds['proto'], preds['fpn_feat'],
            preds['T2S_feat'], first)
        rec.update(preds={k: preds[k] for k in DEC.VALUE_FIELDS['preds']},
                   det=dets, state=new, out=out)
        return new, rec

    return jax.jit(step)


def _t(x):
    """A JAX array as a torch tensor (bf16 stays bf16, int32 -> int64)."""
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    t = torch.from_numpy(np.array(a))
    return t.long() if t.dtype == torch.int32 else t


def _to_torch(x):
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, '_fields'):
        cls = {'TrackState': TrackState, 'Detections': Detections}.get(
            type(x).__name__, None)
        vals = [_to_torch(v) for v in x]
        return cls(*vals) if cls else type(x)(*vals)
    return _t(x)


def _jax_init_states(jcfg):
    """JAX's bf16 lane states (``make_init_states(feat_dtype=bf16)``)."""
    one = JT.init_state(jcfg, jcfg.feature_shapes()[
        jcfg.correlation_selected_layer], (jcfg.pad_h // 4, jcfg.pad_w // 4),
        jcfg.fpn.num_features, jcfg.embed_dim, feat_dtype=jnp.bfloat16)
    return jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape).copy(), one)


@pytest.fixture(scope='module')
def jax_route():
    """The JAX step's correlation on the TPU's route (Pallas, interpret
    mode) while this module runs; the dtypes the step saw."""
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JT, 'correlate', _tpu_route_correlate(seen))
        yield seen


@pytest.fixture(scope='module')
def models():
    """(flax model, fp32 params, the port's model cast to bf16 in place by
    its first ``build_video_step_batched``)."""
    jmodel, params = flax_params(seed=2)
    return jmodel, params, port_model(params)


def _port_modules(tcfg, model, priors, jrec, state, first):
    """The port's detect and tracker on JAX's forward outputs and state,
    as a step's record."""
    with torch.inference_mode():
        det = detect_and_rescore(tcfg, model, jrec['preds'], priors)
        rec = {'preds': jrec['preds'], 'det': det}
        new, out = track_step_tf_lanes(
            tcfg, model.temporal_shift, state, det, jrec['preds']['proto'],
            jrec['preds']['fpn_feat'], jrec['preds']['T2S_feat'],
            torch.from_numpy(first), record=rec)
    rec.update(state=new, out=out)
    return rec


@pytest.fixture(scope='module')
def jax_steps(jax_route, models):
    """JAX's jitted bf16 lane step on the TPU's route, one an NMS family,
    built once for the module's tests (each costs a JAX compile)."""
    steps = {}

    def get(nms):
        if nms not in steps:
            steps[nms] = _jax_step(JCFG.replace(eval_nms_method=nms),
                                   models[0], jax_route)
        return steps[nms]
    return get


def _runs(tag, jcfg, tcfg, models, jstep, frames, first):
    """Step by step from JAX's state: JAX's step, the port's step and the
    port's modules on JAX's inputs, tallied in two ledgers."""
    _, params, tmodel = models
    p16 = cast_params(params, jnp.bfloat16)
    chunk, _ = build_video_step_batched(
        tcfg, tmodel, B, 1, uint8_input=True, device='cpu',
        compute_dtype=torch.bfloat16)
    priors = torch.as_tensor(all_priors(tcfg))
    jstates = _jax_init_states(jcfg)
    step_led, module_led = DEC.Ledger(), DEC.Ledger()
    for k in range(frames.shape[0]):
        with pltpu.force_tpu_interpret_mode():
            jnew, jrec = jstep(p16, jstates, jnp.asarray(frames[k]),
                               jnp.asarray(first[k]))
        jrec = _to_torch(jrec)
        state = _to_torch(jstates)
        rec = []
        chunk(state, frames[k:k + 1], first[k:k + 1], record=rec)
        DEC.compare_step(tcfg, priors, jrec, rec[0], step_led)
        DEC.compare_step(tcfg, priors, jrec, _port_modules(
            tcfg, tmodel, priors, jrec, state, first[k]), module_led)
        jstates = jnew
    for name, led in (('step', step_led), ('modules', module_led)):
        print('\n'.join(led.lines(f'[{tag} {name}]')))
    return step_led, module_led


@pytest.mark.parametrize('nms', ['cc', 'greedy'])
def test_steps_match_jax(nms, jax_route, jax_steps, models):
    """2 lanes x 4 frames under cc and greedy NMS: the port's bf16 step
    against JAX's from the same state, and the port's modules on JAX's
    inputs; every decision apart within its margin, the values within
    TOL and MODULE_TOL.  The JAX step saw an fp32 correlation and fed the
    TemporalNet fp32."""
    jcfg = JCFG.replace(eval_nms_method=nms)
    tcfg = TCFG.replace(eval_nms_method=nms)
    frames, first = _schedule()
    step_led, module_led = _runs(nms, jcfg, tcfg, models, jax_steps(nms),
                                 frames, first)
    assert jax_route == {'correlation': jnp.float32,
                         'temporal_net': jnp.float32}, jax_route
    step_led.check(TOL)
    module_led.check(MODULE_TOL)
    assert step_led.kinds['rank'].n and step_led.kinds['nms'].n
    assert step_led.kinds['match'].n and step_led.kinds['out_mask'].n


def test_reference_takes_the_tpu_route(jax_route, jax_steps, models):
    """JAX's step on the TPU's route (the Pallas correlation in interpret
    mode: fp32 out, fp32 into the TemporalNet) against the route the JAX
    package takes on the CPU (the XLA correlation: bf16 out, bf16 into the
    TemporalNet), at the first step that shifts tracks, from the same
    state: the TF branch's outputs (the shifted boxes, coefficients and
    masks of the live slots) apart by ROUTE_GAP and more, while the port's
    tracker on the same inputs sits within MODULE_TOL of the TPU route."""
    jmodel, params, tmodel = models
    p16 = cast_params(params, jnp.bfloat16)
    frames, first = _schedule()
    tpu = jax_steps('cc')
    with pltpu.force_tpu_interpret_mode():
        states, _ = tpu(p16, _jax_init_states(JCFG), jnp.asarray(frames[0]),
                        jnp.asarray(first[0]))
        _, rec_tpu = tpu(p16, states, jnp.asarray(frames[1]),
                         jnp.asarray(first[1]))
    naive = {}

    def xla(x1, x2, patch_size=11, apply_activation=True, use_pallas=False):
        out = j_correlate_xla(x1, x2, patch_size, apply_activation)
        naive['correlation'] = out.dtype
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JT, 'correlate', xla)
        _, rec_xla = _jax_step(JCFG, jmodel, naive)(
            p16, states, jnp.asarray(frames[1]), jnp.asarray(first[1]))
    assert jax_route['correlation'] == jnp.float32
    assert jax_route['temporal_net'] == jnp.float32
    assert naive == {'correlation': jnp.bfloat16,
                     'temporal_net': jnp.bfloat16}, naive
    rec_tpu, rec_xla = _to_torch(rec_tpu), _to_torch(rec_xla)
    build_video_step_batched(TCFG, tmodel, B, 1, device='cpu',
                             compute_dtype=torch.bfloat16)
    port = _port_modules(TCFG, tmodel, torch.as_tensor(all_priors(TCFG)),
                         rec_tpu, _to_torch(states), first[1])
    live = rec_tpu['shifted'].valid
    assert bool(live.any())
    apart = {}
    for f in ('box', 'mask_coeff', 'mask'):
        ref = getattr(rec_tpu['shifted'], f)[live]
        apart[f] = tuple(float((getattr(r['shifted'], f)[live] - ref).abs()
                               .max()) for r in (rec_xla, port))
        print(f'shifted {f} of {int(live.sum())} live slots: the CPU route '
              f'(XLA, bf16) {apart[f][0]:.3e} from the TPU route, the port '
              f'{apart[f][1]:.3e}')
    for f, (gap, d) in apart.items():
        assert d <= MODULE_TOL[('shift', f)] < ROUTE_GAP[f] <= gap, (f, d,
                                                                     gap)


# -- the CLI -----------------------------------------------------------------
def _cli_frames(ann, prefix):
    """The frames both eval scripts step through on the CLI's set, [steps,
    B] uint8 at the model's input size with is_first, and each (step,
    lane)'s (video id, frame id): 2 lanes, a lane taking the next video
    when its own ends (``eval.py``'s ``next_chunk``)."""
    from stmask_tpu.data import YTVISDataset, load_image_rgb
    from stmask_tpu.data.transforms import preprocess_frame_u8
    data = YTVISDataset(ann, prefix, has_annotations=True)
    queue, lanes = list(data.video_ids()), [None] * B
    frames, first, where = [], [], []
    while True:
        row = np.zeros((B, TCFG.img_h, TCFG.img_w, 3), np.uint8)
        flags, at = np.zeros(B, bool), [None] * B
        for lane in range(B):
            if lanes[lane] is None or lanes[lane][1] >= lanes[lane][2]:
                lanes[lane] = ([queue.pop(0), 0, 0] if queue else None)
                if lanes[lane] is None:
                    continue
                lanes[lane][2] = data.num_frames(lanes[lane][0])
            vid, f, _ = lanes[lane]
            row[lane] = preprocess_frame_u8(JCFG, load_image_rgb(
                data.frame_path(vid, f)))['image']
            flags[lane], at[lane] = f == 0, (vid, f)
            lanes[lane][1] += 1
        if all(a is None for a in at):
            return np.stack(frames), np.stack(first), where
        frames.append(row)
        first.append(flags)
        where.append(at)


def _tracks_by_start(tracks):
    """{(video, category, first frame with a mask): [tracks]}."""
    out = {}
    for t in tracks:
        f0 = next(f for f, s in enumerate(t['segmentations'])
                  if s is not None)
        out.setdefault((t['video_id'], t['category_id'], f0), []).append(t)
    return out


def _pair(got, want):
    """Tracks of one key paired by the overlap of their masks (the sum over
    frames of the IoU), the best first."""
    def iou(a, b):
        if a is None or b is None:
            return 0.0
        ma, mb = rle.decode(a), rle.decode(b)
        return (ma & mb).sum() / max((ma | mb).sum(), 1)
    cand = sorted(((sum(iou(x, y) for x, y in zip(
        g['segmentations'], w['segmentations'])), i, j)
        for i, g in enumerate(got) for j, w in enumerate(want)),
        reverse=True)
    used_g, used_w, pairs = set(), set(), []
    for _, i, j in cand:
        if i not in used_g and j not in used_w:
            used_g.add(i)
            used_w.add(j)
            pairs.append((got[i], want[j]))
    return pairs


@pytest.fixture(scope='module')
def cli_runs(tmp_path_factory, models, jax_route):
    """JAX's ``evaluate_dataset_batched`` with its default ``--bf16`` (on
    the TPU's route) over ``test_torch_eval_cli.py``'s set (3 videos x 3
    frames at 192x256, gt at 96x128), 2 lanes x 2-frame chunks."""
    import eval as j_eval       # the JAX package's eval.py, at the root
    root = tmp_path_factory.mktemp('ytvis_bf16')
    ann, prefix = write_ytvis_set(str(root), 3, 3, 2 * TCFG.img_h,
                                  2 * TCFG.img_w, seed=2,
                                  gt_hw=(TCFG.img_h, TCFG.img_w))
    jmodel, params, _ = models
    weights = str(root / 'weights.pth')
    torch.save(state_dict_from_flax(params), weights)
    out = root / 'jax.json'
    args = j_eval.parse_args([
        '--ann_file', ann, '--img_prefix', prefix, '--mask_det_file',
        str(out), '--eval_metrics', '--batch_videos', str(B),
        '--chunk_frames', '2'])
    assert args.bf16
    with pltpu.force_tpu_interpret_mode():
        stats = j_eval.evaluate_dataset_batched(args, JCFG, jmodel, params)
    return dict(root=root, ann=ann, prefix=prefix, weights=weights,
                tracks=json.loads(out.read_text()), stats=stats)


def test_cli_bf16_matches_jax_eval_script(cli_runs, models, jax_steps,
                                          monkeypatch, port_mask_values):
    """The port's eval CLI with its default bf16 (2 lanes x 2-frame chunks)
    against JAX's bf16 ``evaluate_dataset_batched`` on the same set and
    weights.  Tracks pair by (video, category, first frame); a pair's
    scores lie within TOL's state score, and its masks differ only in
    pixels whose value in the port's run lies within the out_mask margin
    of 0.5 that the step-by-step run over the same frames measures, or at
    a frame where a decision was taken apart.  A track without a partner
    needs a decision apart in its video's lane at or before its first
    frame, and there are no more of them than decisions apart on those
    frames."""
    monkeypatch.setitem(t_config.REGISTRY, NAME, TCFG.replace(name=NAME))
    out = cli_runs['root'] / 'port.json'
    assert t_eval.main([
        '--config', NAME, '--trained_model', cli_runs['weights'],
        '--ann_file', cli_runs['ann'], '--img_prefix', cli_runs['prefix'],
        '--mask_det_file', str(out), '--device', 'cpu',
        '--batch_videos', str(B), '--chunk_frames', '2']) == 0
    got = _tracks_by_start(json.loads(out.read_text()))
    want = _tracks_by_start(cli_runs['tracks'])
    frames, first, where = _cli_frames(cli_runs['ann'], cli_runs['prefix'])
    step_led, _ = _runs('cli', JCFG, TCFG, models, jax_steps('cc'), frames,
                        first)
    step_led.check(TOL)
    margin = step_led.kinds['out_mask'].margin
    score_tol = TOL[('state', 'score')]
    print(f'port tracks {sum(map(len, got.values()))}, JAX tracks '
          f'{sum(map(len, want.values()))}; mask margin {margin:.3e}')
    apart = {}
    for k, row in enumerate(where):
        for lane, at in enumerate(row):
            if at is not None:
                apart[at] = step_led.apart_in(k, lane)
    unpaired, flips, traced, n_pairs = [], [], [], 0
    for key in sorted(set(got) | set(want)):
        g, w = got.get(key, []), want.get(key, [])
        pairs = _pair(g, w)
        n_pairs += len(pairs)
        unpaired += [(key, 'port')] * (len(g) - len(pairs))
        unpaired += [(key, 'jax')] * (len(w) - len(pairs))
        for a, b in pairs:
            assert abs(a['score'] - b['score']) <= score_tol, key
            for f, (sa, sb) in enumerate(zip(a['segmentations'],
                                             b['segmentations'])):
                if sa == sb:
                    continue
                far = sa is None or sb is None
                if not far:
                    flip = rle.decode(sa) != rle.decode(sb)
                    v = port_mask_values[(key[0], f, sa['counts'])][flip]
                    d = float(np.abs(v - 0.5).max())
                    far = d > margin
                    flips += [] if far else [d]
                if far:
                    # a kept flag or a mask taken apart at this frame
                    assert apart[key[0], f], (key, f)
                    traced.append((key, f))
    print(f'{n_pairs} pairs; masks flipped in {len(flips)} frames of them, '
          f'within {max(flips, default=0):.3e} of 0.5 but for {traced} '
          f'(decisions apart there); {len(unpaired)} tracks unpaired '
          f'{unpaired}; {step_led.total_apart()} decisions apart on the '
          f'same frames')
    assert n_pairs > 0 and flips
    for (vid, _, f0), side in unpaired:
        assert any(apart.get((vid, f), 0) for f in range(f0 + 1)), (
            vid, f0, side)
    assert len(unpaired) <= step_led.total_apart()


def test_decisions_refuse_what_they_cannot_explain(models):
    """The ledger's verdicts: a decision apart farther from its boundary
    than its kind's margin fails the check, one nearer passes, and so do
    argmax rows; a value past its tolerance fails; a step whose new state
    differs in one lane with no decision apart there raises (two runs of
    the port's own bf16 step, one with a track id changed)."""
    led = DEC.Ledger()
    led.threshold('prefilter', 0, torch.tensor([0.30, 0.051, 0.9]),
                  torch.tensor([0.31, 0.049, 0.9]), 0.05)
    led.argmax('class', 0, torch.tensor([[0.5, 0.49], [0.1, 0.8]]),
               torch.tensor([[0.49, 0.5], [0.11, 0.79]]))
    led.check({})
    assert led.counts()['prefilter'] == 1 and led.counts()['class'] == 1
    led.threshold('prefilter', 1, torch.tensor([0.2]), torch.tensor([0.01]),
                  0.05)
    with pytest.raises(AssertionError, match='prefilter'):
        led.check({})
    led = DEC.Ledger()
    led.value('det', 'box', torch.zeros(3), torch.full((3,), 1e-3))
    led.check({('det', 'box'): 2e-3})
    with pytest.raises(AssertionError):
        led.check({('det', 'box'): 5e-4})

    _, _, tmodel = models
    chunk, make_states = build_video_step_batched(
        TCFG, tmodel, B, 1, uint8_input=True, device='cpu',
        compute_dtype=torch.bfloat16)
    priors = torch.as_tensor(all_priors(TCFG))
    frames, first = _schedule()
    state = make_states()
    runs = []
    for k in range(2):
        recs = [[], []]
        for rec in recs:
            chunk(state, frames[k:k + 1], first[k:k + 1], record=rec)
        runs.append(recs)
        state = recs[0][0]['state']
    led = DEC.Ledger()
    for a, b in runs:
        DEC.compare_step(TCFG, priors, a[0], b[0], led)
    assert led.total_apart() == 0 and led.kinds['match'].n
    a, b = runs[1][0][0], runs[1][1][0]
    ids = b['state'].obj_id.clone()
    ids[1, torch.nonzero(b['state'].valid[1])[0]] += 7
    with pytest.raises(AssertionError, match='obj_id differs'):
        DEC.compare_step(TCFG, priors, a, dict(
            b, state=b['state']._replace(obj_id=ids)), DEC.Ledger())
