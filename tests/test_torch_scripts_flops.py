"""``utils/flops.py`` (the count ``stmask_torch.scripts.mfu`` reads) against
the JAX model's jaxpr, on the reduced flagship at 96x128.

The JAX side counts the ``conv_general_dilated`` and ``dot_general``
equations of ``jax.make_jaxpr`` of the forward, two FLOPs a multiply-add,
recursing into nested jaxprs; it leaves out the ``pallas_call`` of the
correlation, whose 2 B H W 121 C it adds by formula, and the products
``jax.image.resize`` runs with its interpolation matrices (the ``jit``
named ``_resize``), since a resize is elementwise work, which neither side
counts.  XLA's own ``cost_analysis()`` count of the compiled forward is
printed beside the two, not compared: it counts elementwise work too.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stmask_tpu.kernels.correlation_pallas import correlate_pallas

from stmask_torch.ops.correlation import correlate as t_correlate
from stmask_torch.ops.deform_conv import deform_conv_window
from stmask_torch.utils import flops
from torch_eval_common import JCFG, TCFG, flax_params, port_model
from torch_eval_common import few_torch_threads  # noqa: F401

_LOOPS = ('scan', 'while', 'cond')


def jaxpr_flops(jaxpr) -> int:
    """conv_general_dilated and dot_general FLOPs of a jaxpr and the
    jaxprs nested in it, the resize's products left out."""
    total = 0
    for e in jaxpr.eqns:
        name = e.primitive.name
        assert name not in _LOOPS, name       # a loop would need its count
        if name == 'pallas_call' or e.params.get('name') == '_resize':
            continue
        if name == 'conv_general_dilated':
            rhs = e.invars[1].aval.shape
            spec = e.params['dimension_numbers'].rhs_spec
            assert all(d == 1 for d in e.params['lhs_dilation'])
            total += 2 * math.prod(e.outvars[0].aval.shape) * rhs[spec[1]] \
                * math.prod(rhs[i] for i in spec[2:])
        elif name == 'dot_general':
            (lc, _), _ = e.params['dimension_numbers']
            lhs = e.invars[0].aval.shape
            total += 2 * math.prod(e.outvars[0].aval.shape) * math.prod(
                lhs[i] for i in lc)
        for p in e.params.values():
            for sub in (p if isinstance(p, (tuple, list)) else (p,)):
                if hasattr(sub, 'jaxpr') and hasattr(sub, 'consts'):
                    total += jaxpr_flops(sub.jaxpr)
                elif hasattr(sub, 'eqns'):
                    total += jaxpr_flops(sub)
    return total


@pytest.fixture(scope='module')
def weights():
    return flax_params(0)


def test_forward_flops_equal_the_jax_jaxpr_count(weights):
    """The reduced flagship's eval forward and one correlation of the
    tracked level's maps: the port's count equals the jaxpr's, exactly."""
    j_model, params = weights
    x = np.random.RandomState(0).randn(1, JCFG.pad_h, JCFG.pad_w,
                                       3).astype(np.float32)
    (fh, fw) = JCFG.feature_shapes()[JCFG.correlation_selected_layer]
    c = JCFG.fpn.num_features
    maps = np.random.RandomState(1).randn(2, 1, fh, fw, c).astype(np.float32)

    def j_program(p, x, a, b):
        return j_model.apply(p, x, train=False), correlate_pallas(a, b)

    args = (params, jnp.asarray(x), jnp.asarray(maps[0]),
            jnp.asarray(maps[1]))
    corr = flops.correlate_flops(1, fh, fw, c)
    want = jaxpr_flops(jax.make_jaxpr(j_program)(*args).jaxpr) + corr

    model = port_model(params)

    @torch.no_grad()
    def t_program():
        return (model(torch.from_numpy(x)),
                t_correlate(torch.from_numpy(maps[0]),
                            torch.from_numpy(maps[1])))

    _, got = flops.count(t_program)
    assert got.flops_by_op['stmask.correlate'] == corr
    assert got.flops_by_op['stmask.deform_conv'] > 0
    assert got.flops == want, (got.flops_by_op, want)
    assert got.bytes > 0

    compiled = jax.jit(lambda p, x: j_model.apply(p, x, train=False)).lower(
        params, jnp.asarray(x)).compile()
    ca = compiled.cost_analysis()
    ca = ca[0] if isinstance(ca, list) else ca
    print(f'port {got.flops} = jaxpr {want} FLOPs (correlation {corr}); '
          f"XLA CPU cost_analysis of the forward: {ca.get('flops')}")


def test_dcn_training_counts_each_op_at_its_entry():
    """One window DCN forward and backward counts the forward, the weight
    gradient and the column gradient ``g @ w`` once each (2 M K Cin Cout
    apiece) and the gather's adjoint as 0: the plain versions' own matrix
    products are not seen."""
    rng = np.random.RandomState(0)
    b, h, w, cin, cout = 2, 7, 9, 6, 5
    x = torch.from_numpy(rng.randn(b, h, w, cin).astype(np.float32))
    off = torch.from_numpy(rng.randn(b, h, w, 18).astype(np.float32))
    mask = torch.from_numpy(rng.rand(b, h, w, 9).astype(np.float32))
    wt = torch.from_numpy(rng.randn(cout, 3, 3, cin).astype(np.float32))
    for t in (x, off, mask, wt):
        t.requires_grad_(True)

    def step():
        deform_conv_window(x, off, wt, mask, None, 1, 1, 2).sum().backward()

    _, got = flops.count(step)
    each = flops.deform_conv_flops(b, h, w, 9, cin, cout)
    assert got.flops_by_op == {'stmask.deform_conv': each,
                               'stmask.deform_wgrad': each,
                               'aten.mm': each, 'stmask.deform_col2im': 0}
    assert set(got.bytes_by_op) == set(got.flops_by_op)


def test_correlation_training_counts_both_contractions():
    """The correlation's forward counts 2 B H W P^2 C and its backward
    (dx1 and dx2) twice that."""
    rng = np.random.RandomState(0)
    a, b = (torch.from_numpy(rng.randn(2, 5, 6, 8).astype(np.float32))
            .requires_grad_(True) for _ in range(2))

    def step():
        t_correlate(a, b).sum().backward()

    _, got = flops.count(step)
    fwd = flops.correlate_flops(2, 5, 6, 8)
    assert got.flops_by_op == {'stmask.correlate': fwd,
                               'stmask.correlation_bwd': 2 * fwd}


def test_train_step_count_is_that_of_its_parts():
    """The reduced flagship's fp32 training step (mfu's program at one
    clip) counts the DCN sites' forward and weight gradient alike, and the
    convolutions' backward twice their forward (input and weight
    gradients; the first layer's input gradient is not taken)."""
    from stmask_torch.scripts import _common, mfu
    call = _common.train_call(TCFG, 'cpu', 1, bf16=False)
    _, got = flops.count(call)
    ops = got.flops_by_op
    assert ops['stmask.deform_conv'] == ops['stmask.deform_wgrad'] > 0
    assert ops['stmask.correlation_bwd'] == 2 * ops['stmask.correlate'] > 0
    assert ops['stmask.deform_col2im'] == 0
    assert ops['aten.convolution'] < ops['aten.convolution_backward'] \
        <= 2 * ops['aten.convolution']
    row = mfu.report('train', got, 1.0, 'fp32', 'cpu', 2)
    assert row['mfu_pct'] is None and row['gflops_per_frame'] == \
        got.flops / 2 / 1e9
