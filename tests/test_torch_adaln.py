"""The port's adaLN chains (`ddg_tpu_torch.ops.adaln`, plain versions on
the CPU) against the Pallas kernels of `ddg_tpu/ops/adaln_pallas.py` run
in interpret mode, on the same seeded inputs: float32, 1e-5 abs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddg_tpu.ops import adaln_pallas as jad
from ddg_tpu_torch.ops import adaln as tad

torch.set_num_threads(1)
B, L, D = 2, 16, 128
ATOL = 1e-5


@pytest.fixture(scope='module')
def inputs():
    r = np.random.RandomState(0)
    f = lambda *s: r.randn(*s).astype(np.float32)  # noqa: E731
    # An offset row mean exercises the one-pass moments.
    return dict(x=f(B, L, D) + 3.0, skip=f(B, L, D), gate=f(B, D),
                w=(1.0 + 0.1 * f(D)).astype(np.float32), shift=f(B, D),
                scale=0.5 * f(B, D))


def T(a):
    return torch.from_numpy(np.array(a))


def test_ln_modulate_matches_pallas(inputs):
    t = inputs
    want = jad.ln_modulate(*(jnp.asarray(t[k]) for k in
                             ('x', 'w', 'shift', 'scale')), interpret=True)
    got = tad.ln_modulate(*(T(t[k]) for k in ('x', 'w', 'shift', 'scale')))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_gate_res_ln_modulate_matches_pallas(inputs):
    t = inputs
    keys = ('x', 'skip', 'gate', 'w', 'shift', 'scale')
    wx, wh = jad.gate_res_ln_modulate(*(jnp.asarray(t[k]) for k in keys),
                                      interpret=True)
    gx, gh = tad.gate_res_ln_modulate(*(T(t[k]) for k in keys))
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), atol=ATOL, rtol=0)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), atol=ATOL, rtol=0)


def test_gate_res_normalises_the_unrounded_sum(inputs):
    """In bfloat16 the new residual is rounded, but h is LN of the fp32
    sum, as `_gr_fwd_kernel` computes it."""
    t = {k: T(v).to(torch.bfloat16) for k, v in inputs.items()}
    t['w'] = T(inputs['w'])
    x_new, h = tad.gate_res_ln_modulate(t['x'], t['skip'], t['gate'], t['w'],
                                        t['shift'], t['scale'])
    x32 = t['skip'].float() + t['gate'].float()[:, None] * t['x'].float()
    torch.testing.assert_close(x_new, x32.to(torch.bfloat16), rtol=0, atol=0)
    h32 = tad.ln_modulate_plain(x32, t['w'], t['shift'].float(),
                                t['scale'].float())
    torch.testing.assert_close(h, h32.to(torch.bfloat16), rtol=0, atol=0)


def test_non_cpu_tensors_never_take_the_plain_version(inputs):
    """Off the CPU the wrappers launch their kernel or raise: a tensor on
    another device is refused, and nothing is counted."""
    t = {k: torch.empty(v.shape, device='meta') for k, v in inputs.items()}
    before = tad.ln_modulate.launches, tad.gate_res_ln_modulate.launches
    with pytest.raises(ValueError):
        tad.ln_modulate(t['x'], t['w'], t['shift'], t['scale'])
    with pytest.raises(ValueError):
        tad.gate_res_ln_modulate(t['x'], t['skip'], t['gate'], t['w'],
                                 t['shift'], t['scale'])
    assert (tad.ln_modulate.launches,
            tad.gate_res_ln_modulate.launches) == before
