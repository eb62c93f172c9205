"""Split the blame for a training run that loses its ProtoNet between the
initial weights and the port: the port's train step and the JAX package's
run side by side from the same weights on the same batches, and after
each step both report the loss, the gradient norm and how much of the
ProtoNet's output is still positive (its last layer is a ReLU).

    JAX_PLATFORMS=cpu python tests/torch_init_split.py --init random
    JAX_PLATFORMS=cpu python tests/torch_init_split.py --init flax

``--init random`` starts from the port's eval init
(``models.stmask.init_random``), ``--init flax`` from flax's own init of
the JAX model.  The model is the reduced flagship of
``torch_eval_common`` (``layers=(1, 3, 3, 1)``) at 96x128 under the
overfit gate's optimizer settings, trained on a synthetic set of 4 videos
x 8 JPEG frames (``write_ytvis_set``, seed 0), 4 clips a step.  A CPU
run of 40 steps takes about 5 minutes.
"""

import argparse
import dataclasses
import os
import sys
import tempfile

import numpy as np
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from stmask_tpu.config import get_config as j_get_config  # noqa: E402
from stmask_tpu.convert import convert_state_dict  # noqa: E402
from stmask_tpu.models import STMask as JSTMask  # noqa: E402
from stmask_tpu.train.train_step import \
    build_train_step as j_build_train_step  # noqa: E402

from stmask_torch.config import get_config as t_get_config  # noqa: E402
from stmask_torch.convert import state_dict_from_flax  # noqa: E402
from stmask_torch.data.loader import ClipLoader  # noqa: E402
from stmask_torch.data.synthetic import write_ytvis_set  # noqa: E402
from stmask_torch.data.ytvis import YTVISDataset  # noqa: E402
from stmask_torch.models.stmask import STMask, init_random  # noqa: E402
from stmask_torch.train.train_step import build_train_step  # noqa: E402

# the overfit gate's optimizer settings (stmask_torch/overfit_sanity.py)
KW = dict(img_w=128, img_h=96, lr=2e-3, lr_warmup_until=100,
          lr_steps=(10 ** 9,), max_iter=400, freeze_bn=False,
          grad_clip_norm=1e3)


def _reduced(cfg):
    return cfg.replace(backbone=dataclasses.replace(cfg.backbone,
                                                    layers=(1, 3, 3, 1)),
                       **KW)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--init', choices=('random', 'flax'), default='random')
    p.add_argument('--steps', type=int, default=40)
    args = p.parse_args(argv)
    tcfg = _reduced(t_get_config('STMask_plus_resnet50'))
    jcfg = _reduced(j_get_config('STMask_plus_resnet50'))

    model = STMask(tcfg)
    if args.init == 'random':
        init_random(model, torch.Generator().manual_seed(0))
        params = convert_state_dict({k: v.numpy() for k, v in
                                     model.state_dict().items()})
    else:
        x0 = jnp.zeros((1, 2, jcfg.pad_h, jcfg.pad_w, 3))
        params = JSTMask(jcfg).init(jax.random.PRNGKey(0), x0, train=True)
        params = {'params': jax.tree_util.tree_map(np.asarray,
                                                   params['params'])}
        model.load_state_dict(state_dict_from_flax(params))
    j_step, j_init = j_build_train_step(jcfg, JSTMask(jcfg))
    t_step, t_init = build_train_step(tcfg, model, 'cpu')
    j_state, t_state = j_init(params), t_init()

    with tempfile.TemporaryDirectory() as root:
        ann, prefix = write_ytvis_set(root, 4, 8, 96, 128, seed=0,
                                      ext='.jpg')
        batches = list(ClipLoader(tcfg, YTVISDataset(ann, prefix), 4,
                                  num_workers=4).epoch(0))

    def proto_positive(sd):
        m = STMask(tcfg)
        m.load_state_dict(sd)
        with torch.no_grad():
            proto = m.eval()(torch.from_numpy(
                batches[0]['images'][0, :1]))['proto']
        return float((proto > 0).float().mean())

    print(f'init {args.init}: ProtoNet output positive '
          f'{proto_positive(model.state_dict()):.4f}')
    for i in range(args.steps):
        b = batches[i % len(batches)]
        j_state, jm = j_step(j_state, {k: jnp.asarray(v)
                                       for k, v in b.items()})
        t_state, tm = t_step(t_state, {k: torch.from_numpy(v)
                                       for k, v in b.items()})
        if i >= 6 and (i + 1) % 5:
            continue
        j_sd = state_dict_from_flax(jax.tree_util.tree_map(
            np.asarray, j_state.params))
        print(f'step {i + 1}: total port {float(tm["total"]):.3f} jax '
              f'{float(jm["total"]):.3f}; M port {float(tm["M"]):.3f} jax '
              f'{float(jm["M"]):.3f}; gnorm port {float(tm["gnorm"]):.1f} '
              f'jax {float(jm["gnorm"]):.1f}; ProtoNet output positive '
              f'port {proto_positive(model.state_dict()):.4f} jax '
              f'{proto_positive(j_sd):.4f}', flush=True)


if __name__ == '__main__':
    main()
