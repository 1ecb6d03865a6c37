"""Port fake quantizers (``compress/quantizers.py``) against the JAX package.

Values and gradients to ``x``, ``scale`` and ``beta`` of every training-time
quantizer from identical numpy inputs. The inputs keep ties on purpose: the
grids are initialised from the same rows, so the smallest rows' codes sit
exactly on ``qmin`` and the largest on ``qmax`` (``jnp.clip`` passes half the
gradient there), and rows beyond the grid are clipped. Tolerances: the
uniform codes equal exactly (the same float32 operations); gradients to rtol
1e-5, and to ``scale``/``beta`` atol 1e-4 (sums over rows in another order); the log quantizer's ``log``/``exp``
are float64 rounded once in the port against XLA's float32 ones, so its
values agree to 2 ulp and its codes equal except where JAX's code argument
lies within 1e-4 of a half-integer.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gaussianimage_plus_tpu.compress import quantizers as jq
from gaussianimage_plus_tpu_torch.compress import quantizers as tq

RTOL = 1e-5


def _tied_rows(seed, n=300, c=2, lo=-4.0, hi=9.0):
    """[n, c] float32 with repeated minima and maxima (ties at qmin and qmax)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, (n, c)).astype(np.float32)
    x[:5] = x.min(0)
    x[5:9] = x.max(0)
    return x


def _grads(jfn, tfn, args):
    """Value and gradients of sum(out * w) in both packages, w seeded."""
    outs_j = jfn(*[jnp.asarray(a) for a in args])
    w = [np.random.default_rng(i).normal(size=np.shape(o)).astype(np.float32)
         for i, o in enumerate(outs_j)]
    loss_j = lambda *a: sum(jnp.sum(o * jnp.asarray(wi)) for o, wi in zip(jfn(*a), w))
    gj = jax.grad(loss_j, argnums=tuple(range(len(args))))(*[jnp.asarray(a) for a in args])
    ts = [torch.as_tensor(a.copy()).requires_grad_(True) for a in args]
    outs_t = tfn(*ts)
    gt = torch.autograd.grad(sum((o * torch.as_tensor(wi)).sum() for o, wi in zip(outs_t, w)), ts,
                             allow_unused=True)
    return ([np.asarray(o) for o in outs_j], [o.detach().numpy() for o in outs_t],
            [np.asarray(g) for g in gj],
            [np.zeros_like(a) if g is None else g.numpy() for a, g in zip(args, gt)])


def test_ste_round_and_half_match_jax():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.49999997, 3.7, 70000.0, 1e-8],
                 np.float32)
    for jf, tf in ((jq.ste_round, tq.ste_round), (jq.fake_quantize_half, tq.fake_quantize_half)):
        vj, vt, gj, gt = _grads(lambda a: (jf(a),), lambda a: (tf(a),), [x])
        np.testing.assert_array_equal(vt[0], vj[0])            # half to even, fp16 round trip
        np.testing.assert_array_equal(gt[0], gj[0])            # identity gradient


@pytest.mark.parametrize("bits,signed", [(12, False), (6, False), (10, True)])
def test_uniform_init_forward_compress_match_jax(bits, signed):
    x = _tied_rows(bits)
    pj, pt = jq.uniform_init(jnp.asarray(x), bits, signed), tq.uniform_init(torch.as_tensor(x), bits,
                                                                            signed)
    for f in ("scale", "beta"):
        np.testing.assert_array_equal(getattr(pt, f).numpy(), np.asarray(getattr(pj, f)), err_msg=f)
    # rows beyond the grid on both sides: clipped, no gradient through the code
    xq = np.concatenate([x, x[:3] - 1.0, x[5:8] + 1.0]).astype(np.float32)
    qmin, qmax = jq.uniform_qrange(bits, signed)
    code0 = (xq - np.asarray(pj.beta)) / np.asarray(pj.scale)
    assert (code0 == qmin).sum() >= 5 and (code0 == qmax).sum() >= 4      # ties kept
    vj, vt, gj, gt = _grads(
        lambda a, s, b: jq.uniform_forward(jq.UniformQuantParams(s, b), a, bits, signed),
        lambda a, s, b: tq.uniform_forward(tq.UniformQuantParams(s, b), a, bits, signed),
        [xq, np.asarray(pj.scale), np.asarray(pj.beta)])
    for a, b in zip(vt, vj):
        np.testing.assert_array_equal(a, b)
    # scale and beta sum ~300 rows' terms of order one, in another order
    for name, a, b, atol in zip(("x", "scale", "beta"), gt, gj, (1e-6, 1e-4, 1e-4)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol, err_msg=name)
    # the half-gradient ties reach x: 0.5 on the rows exactly at qmin / qmax
    gx_j = np.asarray(jax.grad(lambda a: jnp.sum(jq.uniform_forward(pj, a, bits, signed)[0]))(
        jnp.asarray(xq)))
    xt = torch.as_tensor(xq).requires_grad_(True)
    (gx_t,) = torch.autograd.grad(tq.uniform_forward(pt, xt, bits, signed)[0].sum(), xt)
    np.testing.assert_array_equal(gx_t.numpy(), gx_j)
    assert (gx_j[code0 == qmin] == 0.5).all() and (gx_j[(code0 < qmin) | (code0 > qmax)] == 0).all()
    dq_j, c_j = jq.uniform_compress(pj, jnp.asarray(xq), bits, signed)
    dq_t, c_t = tq.uniform_compress(pt, torch.as_tensor(xq), bits, signed)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(dq_t.numpy(), np.asarray(dq_j))


def _off_half(arg, tol=1e-4):
    """Where a code argument is not within ``tol`` of a half-integer."""
    return np.abs(arg - np.floor(arg) - 0.5) > tol


def _assert_log_agrees(vt, vj, x, bits):
    """(dequant, code, beta, scale) of the log quantizer."""
    dq_t, code_t, beta_t, scale_t = vt
    dq_j, code_j, beta_j, scale_j = vj
    for a, b in ((beta_t, beta_j), (scale_t, scale_j)):
        assert abs(int(np.float32(a).view(np.int32)) - int(np.float32(b).view(np.int32))) <= 1
    arg = (np.log(np.abs(x.astype(np.float64)) + 1e-6) - beta_j) / scale_j
    ok = _off_half(arg)
    assert ok.mean() > 0.99
    np.testing.assert_array_equal(code_t[ok], code_j[ok])
    np.testing.assert_allclose(dq_t[ok], dq_j[ok], rtol=2.5e-7 * (2 ** bits) / 64, atol=0)


def test_log_forward_and_compress_match_jax():
    rng = np.random.default_rng(3)
    var = np.exp(rng.uniform(-3, 6, (400, 2))).astype(np.float32)
    var[:4] = var.min()                       # ties at qmin
    var[4:7] = var.max()                      # and at qmax
    bits = 10
    vj, vt, gj, gt = _grads(
        lambda a: (lambda r: (r[0], r[1], r[2].beta, r[2].scale))(jq.log_forward(a, bits)),
        lambda a: (lambda r: (r[0], r[1], r[2].beta, r[2].scale))(tq.log_forward(a, bits)),
        [var])
    _assert_log_agrees(vt, vj, var, bits)
    # the gradient reaches x through the dequant, the code and the min / max
    np.testing.assert_allclose(gt[0], gj[0], rtol=1e-4, atol=1e-6)
    cj, ct = jq.log_compress(jnp.asarray(var), bits), tq.log_compress(torch.as_tensor(var), bits)
    _assert_log_agrees([ct[0].numpy(), ct[1].numpy(), ct[2].beta.numpy(), ct[2].scale.numpy()],
                       [np.asarray(cj[0]), np.asarray(cj[1]), np.asarray(cj[2].beta),
                        np.asarray(cj[2].scale)], var, bits)
    # a constant input takes the 1e-8 scale floor in both
    const = np.full((8, 2), 3.0, np.float32)
    assert float(jq.log_forward(jnp.asarray(const), bits)[2].scale) == \
        float(tq.log_forward(torch.as_tensor(const), bits)[2].scale) == np.float32(1e-8)


def test_hybrid_init_forward_compress_match_jax():
    rng = np.random.default_rng(5)        # no log code argument near a half-integer
    a, c = rng.uniform(0.5, 40, 300), rng.uniform(0.5, 40, 300)
    b = rng.uniform(-0.9, 0.9, 300) * np.sqrt(a * c)
    cov = np.stack([a, b, c], -1).astype(np.float32)
    cov[:3, 1] = cov[:, 1].min()
    bits, cov_bits = 10, 10
    pj, pt = jq.hybrid_init(jnp.asarray(cov), cov_bits), tq.hybrid_init(torch.as_tensor(cov), cov_bits)
    for f in ("scale", "beta"):
        np.testing.assert_array_equal(getattr(pt.cov, f).numpy(), np.asarray(getattr(pj.cov, f)))
    assert tq.hybrid_size(bits, cov_bits) == jq.hybrid_size(bits, cov_bits) == 10.0
    assert tq.hybrid_size(6, 12) == jq.hybrid_size(6, 12)
    mk_j = lambda s, b_: jq.HybridQuantParams(cov=jq.UniformQuantParams(s, b_))
    mk_t = lambda s, b_: tq.HybridQuantParams(cov=tq.UniformQuantParams(s, b_))
    vj, vt, gj, gt = _grads(
        lambda x, s, b_: jq.hybrid_forward(mk_j(s, b_), x, bits, cov_bits)[:2],
        lambda x, s, b_: tq.hybrid_forward(mk_t(s, b_), x, bits, cov_bits)[:2],
        [cov, np.asarray(pj.cov.scale), np.asarray(pj.cov.beta)])
    np.testing.assert_array_equal(vt[1][:, 1], vj[1][:, 1])              # uniform channel
    np.testing.assert_array_equal(vt[0][:, 1], vj[0][:, 1])
    lj = jq.log_forward(jnp.asarray(cov[:, ::2]), bits)[2]
    arg = (np.log(np.abs(cov[:, ::2].astype(np.float64)) + 1e-6) - float(lj.beta)) / float(lj.scale)
    ok = _off_half(arg)
    assert ok.all()      # so the min / max rows' gradients sum the same terms
    np.testing.assert_array_equal(vt[1][:, ::2][ok], vj[1][:, ::2][ok])
    np.testing.assert_allclose(vt[0][:, ::2][ok], vj[0][:, ::2][ok], rtol=1e-5)
    for name, a_, b_ in zip(("x", "scale", "beta"), gt, gj):
        np.testing.assert_allclose(a_, b_, rtol=1e-4, atol=1e-6, err_msg=name)
    dj, cj, _ = jq.hybrid_compress(pj, jnp.asarray(cov), bits, cov_bits)
    dt, ct, _ = tq.hybrid_compress(pt, torch.as_tensor(cov), bits, cov_bits)
    np.testing.assert_array_equal(ct.numpy()[:, 1], np.asarray(cj)[:, 1])
    np.testing.assert_array_equal(ct.numpy()[:, ::2][ok], np.asarray(cj)[:, ::2][ok])
    np.testing.assert_allclose(dt.numpy()[:, ::2][ok], np.asarray(dj)[:, ::2][ok], rtol=1e-5)
    np.testing.assert_array_equal(dt.numpy()[:, 1], np.asarray(dj)[:, 1])


def test_clip_gradient_is_half_at_a_tie():
    """The port's clip against jnp.clip: [0, 1, 3, 4] clipped to [0, 3]."""
    x = np.array([0.0, 1.0, 3.0, 4.0], np.float32)
    gj = jax.grad(lambda a: jnp.sum(jnp.clip(a, 0, 3)))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    (gt,) = torch.autograd.grad(tq.clip(xt, 0, 3).sum(), xt)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(gt.numpy(), [0.5, 1.0, 0.5, 0.0])
