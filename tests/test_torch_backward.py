"""Port backward (plain PyTorch versions, on the CPU) against the JAX package.

- The projection VJP (``core/gaussian2d.py``) against JAX's
  ``_project_cov2d_bwd``, culled rows included, at rtol/atol 1e-6.
- ``list_backward`` (kernel C's plain version) for kc 128 lanes and kc 64 rows,
  in id and Morton order, with invalid rows, against the JAX
  ``list_backward`` in the same layout (Pallas in interpret mode) and against
  JAX ``dense_backward``; the port's ``dense_backward`` against JAX's; the
  ``rasterize_tiled`` VJP against JAX's. Tolerance rtol/atol 5e-4, the JAX
  suite's own (``tests/test_raster_list.py``): the gate is the same, the sums
  run in another order. The conic column adds 5e-6 of its largest entry to
  atol: it sums cancelling moment terms (``lmx^2 S1 - 2 lmx Sx + Sxx``), and
  two summation orders differ there by ~2e-6 of the column's largest entry
  (the JAX package's own list and dense kernels differ by 1.0e-3 to 1.8e-3
  on conic columns of 480 to 850 in these scenes).
- Gradients of the L2 loss through ``render`` with respect to ``xyz``,
  ``cov2d`` and ``features`` for ``'list_t'`` and ``'xla'``, with colours zero
  and nonzero, against ``jax.grad`` (atol 5e-4 of the largest entry, rtol
  5e-4), and the two faults of the forward-only port: the clamp's gradient at
  a tie and graph cuts at kernel launches.

Scenes follow ``test_raster_pallas.make_scene`` (``test_torch_raster.scene``).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gaussianimage_plus_tpu.core import gaussian2d as jg
from gaussianimage_plus_tpu.core.binning import bin_gaussians as jax_bin
from gaussianimage_plus_tpu.core.binning import morton_perm as jax_morton
from gaussianimage_plus_tpu.core.render_tiled import rasterize_tiled as jax_tiled
from gaussianimage_plus_tpu.kernels.raster_dense_pallas import dense_backward as jax_dense_bwd
from gaussianimage_plus_tpu.kernels.raster_list_pallas import list_backward as jax_list_bwd
from gaussianimage_plus_tpu.models import gaussian_image as jgi

from gaussianimage_plus_tpu_torch.core import gaussian2d as tg
from gaussianimage_plus_tpu_torch.core.binning import bin_gaussians
from gaussianimage_plus_tpu_torch.core.render_tiled import rasterize_tiled
from gaussianimage_plus_tpu_torch.kernels import raster_dense, raster_list
from gaussianimage_plus_tpu_torch.models import gaussian_image as tgi

from test_torch_gaussian2d import random_cov_inputs
from test_torch_raster import both_projections, scene

TOL = 5e-4
CONIC_REL = 5e-6
NAMES = ("xys", "conics", "colors", "opacity")


def assert_grads_close(port, ref, what):
    for a, b, name in zip(port, ref, NAMES):
        b = np.asarray(b)
        atol = TOL + (CONIC_REL * float(np.abs(b).max()) if name == "conics" else 0.0)
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=TOL, atol=atol,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("H,W,seed", [(48, 80, 0), (45, 77, 1)])
def test_projection_vjp_matches_jax(H, W, seed):
    xy, cov = random_cov_inputs(400, H, W, seed)
    rng = np.random.default_rng(seed + 10)
    v_xy = rng.normal(size=(400, 2)).astype(np.float32)
    v_con = rng.normal(size=(400, 3)).astype(np.float32)

    def f(m, c):
        p = jg.project_gaussians_2d_covariance(m, c, H, W)
        return p.xys, p.conics

    out, vjp = jax.vjp(f, jnp.asarray(xy), jnp.asarray(cov))
    g_mean, g_cov = vjp((jnp.asarray(v_xy), jnp.asarray(v_con)))
    means = torch.tensor(xy, requires_grad=True)
    covs = torch.tensor(cov, requires_grad=True)
    p = tg.project_gaussians_2d_covariance(means, covs, H, W)
    assert not bool(p.valid.all()) and bool(p.valid.any())     # culled rows included
    torch.autograd.backward([p.xys, p.conics], [torch.as_tensor(v_xy), torch.as_tensor(v_con)])
    np.testing.assert_allclose(means.grad.numpy(), np.asarray(g_mean), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(covs.grad.numpy(), np.asarray(g_cov), rtol=1e-6, atol=1e-6)
    assert not covs.grad[~p.valid].any() and not means.grad[~p.valid].any()
    # no gradient reaches the integer outputs
    assert not (p.radii.requires_grad or p.valid.requires_grad or p.num_tiles_hit.requires_grad)


def _list_case(seed, morton, n=150, H=48, W=80, n_invalid=9):
    xy, cov, colors, opacity, H, W = scene(n=n, H=H, W=W, seed=seed, n_invalid=n_invalid)
    perm = None
    if morton:
        pj, _ = both_projections(xy, cov, H, W)
        perm = np.asarray(jax_morton(pj.xys, pj.valid, H, W))
        colors, opacity = colors[perm], opacity[perm]
    pj, pt = both_projections(xy, cov, H, W, perm)
    v_img = np.random.default_rng(seed + 100).normal(size=(H, W, 3)).astype(np.float32)
    return pj, pt, colors, opacity, v_img, H, W


LIST_CASES = {
    "lanes-kc128-id": dict(seed=51, layout="lanes", kc=128, morton=False),
    "lanes-kc128-morton": dict(seed=52, layout="lanes", kc=128, morton=True),
    "rows-kc64-id": dict(seed=53, layout="rows", kc=64, morton=False),
    "rows-kc64-morton": dict(seed=54, layout="rows", kc=64, morton=True),
}


@pytest.mark.parametrize("case", list(LIST_CASES))
def test_list_backward_matches_jax(case):
    kw = dict(LIST_CASES[case])
    layout, kc = kw.pop("layout"), kw.pop("kc")
    pj, pt, colors, opacity, v_img, H, W = _list_case(**kw)
    assert not bool(pt.valid.all())
    port = raster_list.list_backward(pt, torch.as_tensor(colors), torch.as_tensor(opacity),
                                     torch.as_tensor(v_img), H, W, kc=kc, layout=layout)
    args = (pj, jnp.asarray(colors), jnp.asarray(opacity), jnp.asarray(v_img), H, W)
    assert_grads_close(port, jax_list_bwd(*args, kc=kc, layout=layout), f"list {case}")
    assert_grads_close(port, jax_dense_bwd(*args), f"list vs dense {case}")
    # the gradients of culled rows are zero
    assert not port[2][~pt.valid].any()


def test_dense_backward_matches_jax():
    pj, pt, colors, opacity, v_img, H, W = _list_case(seed=55, morton=False, H=45, W=77)
    port = raster_dense.dense_backward(pt, torch.as_tensor(colors), torch.as_tensor(opacity),
                                       torch.as_tensor(v_img), H, W)
    ref = jax_dense_bwd(pj, jnp.asarray(colors), jnp.asarray(opacity), jnp.asarray(v_img), H, W)
    assert_grads_close(port, ref, "dense odd grid")


TILED_CASES = {
    "id-order": dict(seed=60),
    "saturated": dict(seed=61, saturate=True),
    "invalid-rows": dict(seed=62, n_invalid=7),
    "odd-grid": dict(seed=63, H=45, W=77, n=70),
    "overflow-cap8": dict(seed=64, n=120, cap=8),
}


@pytest.mark.parametrize("case", list(TILED_CASES))
def test_rasterize_tiled_vjp_matches_jax(case):
    kw = dict(TILED_CASES[case])
    cap = kw.pop("cap", 64)
    xy, cov, colors, opacity, H, W = scene(**{"n": 60, **kw})
    pj, pt = both_projections(xy, cov, H, W)
    bj, bt = jax_bin(pj, H, W, cap=cap), bin_gaussians(pt, H, W, cap=cap)
    v_img = np.random.default_rng(kw["seed"]).normal(size=(H, W, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c, d: jax_tiled(a, b, c, d, bj.ids, bj.mask, H, W),
                     pj.xys, pj.conics, jnp.asarray(colors), jnp.asarray(opacity))
    ref = vjp(jnp.asarray(v_img))
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (pt.xys, pt.conics, torch.as_tensor(colors), torch.as_tensor(opacity))]
    img = rasterize_tiled(*leaves, bt.ids, bt.mask, H, W)
    img.backward(torch.as_tensor(v_img))
    assert_grads_close([t.grad for t in leaves], ref, f"tiled {case}")


def _model_case(seed, zero_colors, M=120, H=48, W=80):
    """A model state of ``M`` slots, 100 active, from numpy; gt from numpy."""
    rng = np.random.default_rng(seed)
    xy, cov, colors, _, H, W = scene(n=M, H=H, W=W, seed=seed)
    if zero_colors:
        colors = np.zeros_like(colors)
    raw = dict(xyz=xy, cov2d=cov - 0.5, features=colors,
               bound=np.tile(np.array([[0.5, 0.0, 0.5]], np.float32), (M, 1)),
               active=np.arange(M) < 100)
    gt = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    return raw, gt, H, W


def _jax_grads(raw, gt, cfg_j):
    def loss(params):
        st = jgi.GaussianState(params=params, active=jnp.asarray(raw["active"]),
                               bound=jnp.asarray(raw["bound"]),
                               num_active=jnp.asarray(int(raw["active"].sum()), jnp.int32))
        return jnp.mean((jgi.render(st, cfg_j) - jnp.asarray(gt)) ** 2)

    params = jgi.GaussianParams(**{k: jnp.asarray(raw[k]) for k in ("xyz", "cov2d", "features")})
    g = jax.grad(loss)(params)
    return [np.asarray(g.xyz), np.asarray(g.cov2d), np.asarray(g.features)]


def _port_grads(raw, gt, cfg_t):
    from gaussianimage_plus_tpu_torch.interop import state_from_numpy

    st = state_from_numpy(raw, device="cpu")
    params = tgi.GaussianParams(*(p.clone().requires_grad_(True) for p in st.params))
    img = tgi.render(st._replace(params=params), cfg_t)
    loss = torch.mean((img - torch.as_tensor(gt)) ** 2)
    return [g.numpy() for g in torch.autograd.grad(loss, params)]


@pytest.mark.parametrize("zero_colors", [True, False], ids=["colors-zero", "colors-random"])
@pytest.mark.parametrize("backend", ["list_t", "xla"])
def test_render_grads_match_jax(backend, zero_colors):
    raw, gt, H, W = _model_case(70 + zero_colors, zero_colors)
    kw = dict(H=H, W=W, max_num_points=raw["xyz"].shape[0], tile_cap=64, raster_backend=backend)
    ref = _jax_grads(raw, gt, jgi.GaussianConfig(**kw))
    port = _port_grads(raw, gt, tgi.GaussianConfig(**kw))
    for a, b, name in zip(port, ref, ("xyz", "cov2d", "features")):
        scale = float(np.abs(b).max())
        assert scale > 0 or (zero_colors and name != "features")
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL * scale, err_msg=f"{backend} {name}")


def test_clamp_gradient_at_zero_is_half(monkeypatch):
    """Colours zero: every pixel renders exactly 0, on the clamp's edge.
    ``jnp.clip`` passes half the gradient there; the port must too, while
    ``torch.clamp`` would pass all of it."""
    raw, gt, H, W = _model_case(72, zero_colors=True)
    kw = dict(H=H, W=W, max_num_points=raw["xyz"].shape[0], tile_cap=64, raster_backend="xla")
    ref = _jax_grads(raw, gt, jgi.GaussianConfig(**kw))[2]
    cfg_t = tgi.GaussianConfig(**kw)
    np.testing.assert_allclose(_port_grads(raw, gt, cfg_t)[2], ref, rtol=1e-5, atol=1e-9)
    monkeypatch.setattr(tgi, "_clip01", lambda img: torch.clamp(img, 0.0, 1.0))
    np.testing.assert_allclose(_port_grads(raw, gt, cfg_t)[2], 2 * ref, rtol=1e-5, atol=1e-9)


def test_kernel_paths_keep_or_refuse_the_graph():
    """Every backend stays differentiable through its kernels: the binned
    pair (kernel A forward, kernel D backward) too, which refused inputs
    that require grad before its backward was ported. A kernel launch must
    not cut the graph."""
    from gaussianimage_plus_tpu_torch.interop import state_from_numpy

    raw, _, H, W = _model_case(73, zero_colors=False)
    st = state_from_numpy(raw, device="cpu")
    params = tgi.GaussianParams(*(p.clone().requires_grad_(True) for p in st.params))
    live = st._replace(params=params)
    kw = dict(H=H, W=W, max_num_points=raw["xyz"].shape[0])
    for backend in ("list", "list_t", "xla", "pallas", "dense", "sweep", "range"):
        img = tgi.render(live, tgi.GaussianConfig(raster_backend=backend, **kw))
        assert img.grad_fn is not None, backend
        g = torch.autograd.grad(img.sum(), params)
        assert all(bool(x.abs().sum() > 0) for x in g), backend
    cfg_p = tgi.GaussianConfig(raster_backend="pallas", **kw)
    with torch.no_grad():
        assert tgi.render(live, cfg_p).shape == (H, W, 3)
    assert tgi.render(st, cfg_p).grad_fn is None
    assert dataclasses.replace(cfg_p, raster_backend="auto").raster_backend == "auto"
