"""The port's legacy 3DGS path (on the CPU) against the JAX package.

- ``eval_sh_bases`` and ``spherical_harmonics`` at degrees 0-4, and the
  colour's gradient in the coefficients and the view directions;
- ``quat_to_rotmat``, ``scale_rot_to_cov3d``, ``project_cov3d_ewa`` and
  ``project_gaussians_3d`` (a point behind the camera culled): integer
  outputs equal, floats within atol 2e-5 (relative to the magnitude);
- ``depth_order_projection`` (the same permutation) and
  ``rasterize_alpha_tiled`` with its gradient and ``return_alpha``, on a
  32x32 scene and the odd 30x52 grid: within atol 2e-5;
- ``render_3d`` from JAX's ``init_params_3d`` (carried across by
  ``interop.gaussian3d_params_from_numpy``), and ``init_params_3d``'s own
  draws (3-NN scales, logit(0.1) opacity, unit quaternions, zero SH rest);
- 20 steps of ``fit_image_3d`` with Adam and with Adan from JAX's initial
  parameters: the last step's PSNR within 1e-3 dB of JAX's, the final
  renders within atol 2e-4 (the test's docstring says why the parameters
  are held so).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gaussianimage_plus_tpu.core import project3d as jp3
from gaussianimage_plus_tpu.core import render_alpha as jra
from gaussianimage_plus_tpu.core import sh as jsh
from gaussianimage_plus_tpu.core.gaussian2d import project_gaussians_2d_covariance as jproj2d
from gaussianimage_plus_tpu.models import gaussian_3d as jg3

from gaussianimage_plus_tpu_torch.core import project3d as tp3
from gaussianimage_plus_tpu_torch.core import render_alpha as tra
from gaussianimage_plus_tpu_torch.core import sh as tsh
from gaussianimage_plus_tpu_torch.core.gaussian2d import project_gaussians_2d_covariance as tproj2d
from gaussianimage_plus_tpu_torch.interop import gaussian3d_params_from_numpy
from gaussianimage_plus_tpu_torch.models import gaussian_3d as tg3

ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(a, b, atol=ATOL, rtol=1e-5, what=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=rtol, err_msg=what)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_spherical_harmonics(degree):
    rng = np.random.default_rng(degree)
    n, k = 64, tsh.num_sh_bases(degree)
    assert k == jsh.num_sh_bases(degree) == (degree + 1) ** 2
    dirs = rng.normal(size=(n, 3)).astype(np.float32) * 3.0
    coeffs = rng.normal(size=(n, 25, 3)).astype(np.float32)
    unit = dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
    close(tsh.eval_sh_bases(degree, torch.as_tensor(unit)),
          jsh.eval_sh_bases(degree, jnp.asarray(unit)), what="bases")
    d_t, c_t = torch.as_tensor(dirs).requires_grad_(True), torch.as_tensor(coeffs).requires_grad_(True)
    out_t = tsh.spherical_harmonics(degree, d_t, c_t)
    close(out_t, jsh.spherical_harmonics(degree, jnp.asarray(dirs), jnp.asarray(coeffs)),
          what="colour")
    w = rng.normal(size=(n, 3)).astype(np.float32)
    g_t = torch.autograd.grad((out_t * torch.as_tensor(w)).sum(), (d_t, c_t), materialize_grads=True)
    g_j = jax.grad(lambda d, c: jnp.sum(jsh.spherical_harmonics(degree, d, c) * w),
                   argnums=(0, 1))(jnp.asarray(dirs), jnp.asarray(coeffs))
    for a, b, name in zip(g_t, g_j, ("v_dirs", "v_coeffs")):
        close(a, b, what=name)


def test_rotation_cov3d_and_ewa():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(32, 4)).astype(np.float32)
    s = rng.uniform(0.05, 2.0, (32, 3)).astype(np.float32)
    close(tp3.quat_to_rotmat(torch.as_tensor(q)), jp3.quat_to_rotmat(jnp.asarray(q)), what="R")
    cov_t = tp3.scale_rot_to_cov3d(torch.as_tensor(s), 1.5, torch.as_tensor(q))
    cov_j = jp3.scale_rot_to_cov3d(jnp.asarray(s), 1.5, jnp.asarray(q))
    close(cov_t, cov_j, what="cov3d")
    mean_view = np.stack([rng.uniform(-4, 4, 32), rng.uniform(-3, 3, 32),
                          rng.uniform(1, 9, 32)], -1).astype(np.float32)
    close(tp3.project_cov3d_ewa(torch.as_tensor(mean_view), cov_t, 300.0, 280.0, 0.8, 0.6),
          jp3.project_cov3d_ewa(jnp.asarray(mean_view), cov_j, 300.0, 280.0, 0.8, 0.6),
          rtol=2e-5, what="cov2d")


@pytest.mark.parametrize("H,W", [(32, 64), (30, 52)])
def test_project_gaussians_3d(H, W):
    rng = np.random.default_rng(2)
    n = 64
    means = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    means[0] = [0.0, 0.0, -20.0]                    # behind the camera (view z = -12)
    scales = rng.uniform(0.02, 0.2, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    viewmat = np.eye(4, dtype=np.float32)
    viewmat[2, 3] = 8.0
    f = 0.5 * W
    args = (1.0,)
    pj = jp3.project_gaussians_3d(jnp.asarray(means), jnp.asarray(scales), *args,
                                  jnp.asarray(quats), jnp.asarray(viewmat), f, f, W / 2, H / 2, H, W)
    pt = tp3.project_gaussians_3d(torch.as_tensor(means), torch.as_tensor(scales), *args,
                                  torch.as_tensor(quats), torch.as_tensor(viewmat), f, f, W / 2,
                                  H / 2, H, W)
    assert not bool(pt.proj.valid[0]) and int(pt.proj.valid.sum()) > n // 2
    for k in ("radii", "num_tiles_hit", "valid"):
        np.testing.assert_array_equal(getattr(pt.proj, k).numpy(), np.asarray(getattr(pj.proj, k)))
    close(pt.proj.xys, pj.proj.xys, what="xys")
    close(pt.proj.conics, pj.proj.conics, rtol=1e-4, what="conics")
    close(pt.depths, pj.depths, what="depths")
    close(pt.cov3d, pj.cov3d, what="cov3d")


def _alpha_scene(H, W, seed, n=12):
    rng = np.random.default_rng(seed)
    xys = np.stack([rng.uniform(2, W - 2, n), rng.uniform(2, H - 2, n)], -1).astype(np.float32)
    var = rng.uniform(4, 30, (n, 2))
    cov = np.stack([var[:, 0], rng.uniform(-0.5, 0.5, n) * np.sqrt(var.prod(1)), var[:, 1]],
                   -1).astype(np.float32)
    depths = rng.uniform(1, 10, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    opac = rng.uniform(0.3, 0.95, n).astype(np.float32)
    return xys, cov, depths, colors, opac


@pytest.mark.parametrize("H,W", [(32, 32), (30, 52)])
def test_rasterize_alpha_tiled_and_gradient(H, W):
    xys, cov, depths, colors, opac = _alpha_scene(H, W, seed=3)
    bg = np.array([1.0, 0.5, 0.25], np.float32)
    rng = np.random.default_rng(4)
    v_img = rng.normal(size=(H, W, 3)).astype(np.float32)
    v_alpha = rng.normal(size=(H, W)).astype(np.float32)

    def run_j(xy, cv, col, op):
        proj = jproj2d(xy, cv, H, W)
        ps, order = jra.depth_order_projection(proj, jnp.asarray(depths))
        img, alpha = jra.rasterize_alpha_tiled(ps, col[order], op[order], H, W,
                                               background=jnp.asarray(bg), return_alpha=True)
        return jnp.sum(img * v_img) + jnp.sum(alpha * v_alpha), (img, alpha, order)

    args_j = tuple(jnp.asarray(a) for a in (xys, cov, colors, opac))
    (_, (img_j, alpha_j, order_j)), g_j = jax.jit(jax.value_and_grad(
        run_j, argnums=(0, 1, 2, 3), has_aux=True))(*args_j)
    args_t = tuple(torch.as_tensor(a).requires_grad_(True) for a in (xys, cov, colors, opac))
    proj = tproj2d(args_t[0], args_t[1], H, W)
    ps, order = tra.depth_order_projection(proj, torch.as_tensor(depths))
    img_t, alpha_t = tra.rasterize_alpha_tiled(ps, args_t[2][order], args_t[3][order], H, W,
                                               background=torch.as_tensor(bg), return_alpha=True)
    np.testing.assert_array_equal(order.numpy(), np.asarray(order_j))
    close(img_t, img_j, what="image")
    close(alpha_t, alpha_j, what="alpha")
    assert float(alpha_t.max()) > 0.5 and float(alpha_t.min()) == 0.0
    loss_t = (img_t * torch.as_tensor(v_img)).sum() + (alpha_t * torch.as_tensor(v_alpha)).sum()
    for a, b, name in zip(torch.autograd.grad(loss_t, args_t), g_j, ("xy", "cov", "rgb", "opac")):
        scale = float(np.abs(np.asarray(b)).max())
        close(a, b, atol=ATOL * max(scale, 1.0), rtol=1e-4, what=f"v_{name}")
    # the default background is white
    img_w = tra.rasterize_alpha_tiled(ps, args_t[2][order], args_t[3][order], H, W)
    close(img_w, img_t.detach() + (1.0 - torch.as_tensor(bg)) * (1.0 - alpha_t.detach())[..., None],
          what="white background")


@pytest.fixture(scope="module")
def model_cfg():
    return jg3.Gaussian3DConfig(H=32, W=48, num_points=96, sh_degree=1, tile_cap=96), \
        tg3.Gaussian3DConfig(H=32, W=48, num_points=96, sh_degree=1, tile_cap=96)


def test_render_3d_from_jax_params(model_cfg):
    cfg_j, cfg_t = model_cfg
    pj = jg3.init_params_3d(cfg_j, jax.random.PRNGKey(0))
    pt = gaussian3d_params_from_numpy(pj, device="cpu")
    img_t = tg3.render_3d(pt, cfg_t)
    assert img_t.shape == (32, 48, 3)
    close(img_t, jax.jit(lambda p: jg3.render_3d(p, cfg_j))(pj), what="render_3d")
    viewmat, focal = tg3.camera(cfg_t)
    vj, fj = jg3.camera(cfg_j)
    assert focal == fj
    np.testing.assert_array_equal(viewmat.numpy(), np.asarray(vj))


def test_init_params_3d_draws(model_cfg):
    _, cfg = model_cfg
    p = tg3.init_params_3d(cfg, torch.Generator().manual_seed(5))
    again = tg3.init_params_3d(cfg, torch.Generator().manual_seed(5))
    for a, b in zip(p, again):
        assert torch.equal(a, b)
    n = cfg.num_points
    assert p.features_rest.shape == (n, 3, 3) and not bool(p.features_rest.any())
    assert p.features_dc.shape == (n, 1, 3) and 0 <= float(p.features_dc.min())
    assert float(p.features_dc.max()) < 1 and float(p.xyz.abs().max()) <= 1.0
    np.testing.assert_allclose(p.opacity.numpy(), np.log(0.1 / 0.9), rtol=1e-6)
    np.testing.assert_allclose(torch.linalg.vector_norm(p.rotation, dim=1).numpy(), 1.0, atol=1e-6)
    xyz = p.xyz.numpy().astype(np.float64)
    d = np.sqrt(((xyz[:, None] - xyz[None]) ** 2).sum(-1)) + np.eye(n) * 1e9
    knn = np.log(np.sort(d, axis=1)[:, :3].mean(1))
    np.testing.assert_allclose(p.scaling.numpy(), np.repeat(knn[:, None], 3, 1), atol=1e-5)


@pytest.mark.parametrize("opt,lr", [("adam", 0.05), ("adan", 0.01)])
def test_fit_image_3d_matches_jax(model_cfg, opt, lr):
    """The last step's PSNR within 1e-3 dB and loss within rtol 1e-4 of
    JAX's; the final parameters' renders within atol 2e-4, and the means,
    opacities and colours within 5e-4. Scales and rotations are held through
    the render only: the 3-NN scales start isotropic, so a rotation's gradient
    is rounding noise, which the optimizers' normalised steps turn into steps
    of up to ``lr`` either way."""
    cfg_j, cfg_t = model_cfg
    H, W = cfg_t.H, cfg_t.W
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    gt = np.stack([xx / W, yy / H, 0.5 * np.ones_like(xx)], -1)
    pj, mj = jg3.fit_image_3d(gt, cfg_j, iterations=20, lr=lr, loss_type="L2", seed=0, opt=opt)
    init = gaussian3d_params_from_numpy(jg3.init_params_3d(cfg_j, jax.random.PRNGKey(0)),
                                        device="cpu")
    pt, mt = tg3.fit_image_3d(gt, cfg_t, iterations=20, lr=lr, loss_type="L2", opt=opt,
                              params=init)
    assert mt["history"]["psnr"].shape == (20,)
    assert mt["psnr"] > float(mt["history"]["psnr"][0])
    assert abs(mt["psnr"] - mj["psnr"]) <= 1e-3
    np.testing.assert_allclose(mt["loss"], mj["loss"], rtol=1e-4)
    close(tg3.render_3d(pt, cfg_t), jax.jit(lambda p: jg3.render_3d(p, cfg_j))(pj), atol=2e-4,
          what="final render")
    for name in ("xyz", "opacity", "features_dc", "features_rest"):
        close(getattr(pt, name), getattr(pj, name), atol=5e-4, rtol=0, what=name)
