"""Tiles other than 16x16: the port's plain path against the JAX package.

The JAX package renders any ``block_h`` x ``block_w`` on every backend. The
port's kernels are written for 16x16 tiles, so the port renders and
differentiates other sizes through the plain tiled path (``'xla'``, and
``'auto'`` on the CPU) and refuses them wherever a kernel would run, naming
``raster_backend='xla'`` (``core/gaussian2d.py:check_kernel_tiles``).

- ``render`` and ``prepare_render`` + ``render_prepared`` at 8x8, 16x8 and
  32x32 tiles against the JAX ``render`` with the same ``GaussianConfig``:
  atol 2e-5, rtol 1e-5, the tolerance of ``tests/test_torch_raster.py``,
  where a pixel on the alpha >= 1/255 gate may miss it within the rounding
  bound of the expanded quadratic (``sigma_error_bound``), as in its
  full-width tests (at most ``MAX_FRAC`` of the pixels).
- The gradient of the L2 loss through ``render`` on ``'xla'`` at the same
  sizes against ``jax.grad``: rtol 5e-4, atol 5e-4 of each parameter's
  largest entry, the tolerance of ``tests/test_torch_backward.py``, for
  every Gaussian but those with a (member, pixel) pair inside the gate's
  rounding band (the JAX dot product and the port's FMA chain may round such
  a pair to opposite sides; at 32x32 tiles this scene holds one).
- A 20-step ``fit_image`` at 8x8 tiles (a prune every 10 steps, the growth
  with the final fill at step 10; JAX's initial state and candidate draws
  injected) against the JAX fit: per-step PSNR within 1e-3 dB before the
  growth (``tests/test_torch_train.py``'s chunk bound), then the active count
  within 1% and the best PSNR within 0.05 dB (its fit bound).
- ``resolve_backend(cfg, "cuda")`` with 8x8 tiles raises; every kernel
  backend, kernel E binning and each ``render_fast`` enumeration refuse 8x8
  tiles on the CPU too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianimage_plus_tpu.models import gaussian_image as jgi
from gaussianimage_plus_tpu.train import trainer as jtr

from gaussianimage_plus_tpu_torch.core.binning import bin_gaussians
from gaussianimage_plus_tpu_torch.interop import state_from_numpy
from gaussianimage_plus_tpu_torch.models import gaussian_image as tgi
from gaussianimage_plus_tpu_torch.train import trainer as ttr

from test_torch_backward import TOL, _jax_grads, _model_case, _port_grads
from test_torch_decode import MAX_FRAC
from test_torch_raster import assert_render_close, gate_band, sigma_error_bound

BLOCKS = [(8, 8), (16, 8), (32, 32)]


def _configs(raw, H, W, block_h, block_w, **kw):
    kw = dict(H=H, W=W, max_num_points=raw["xyz"].shape[0], tile_cap=256,
              block_h=block_h, block_w=block_w, **kw)
    return jgi.GaussianConfig(**kw), tgi.GaussianConfig(**kw)


def _jax_render(raw, cfg_j):
    st = jgi.GaussianState(
        params=jgi.GaussianParams(**{k: jnp.asarray(raw[k]) for k in ("xyz", "cov2d", "features")}),
        active=jnp.asarray(raw["active"]), bound=jnp.asarray(raw["bound"]),
        num_active=jnp.asarray(int(raw["active"].sum()), jnp.int32))
    return np.asarray(jgi.render(st, cfg_j))


def _gate_band_rows(st, cfg):
    """Gaussians with a (member, pixel) pair whose alpha >= 1/255 gate lies
    in the rounding band of the expanded quadratic (``gate_band``): the JAX
    dot product and the port's FMA chain may decide such a pair differently,
    and the larger the tile, the wider the band (the terms grow with px, py)."""
    proj = tgi.project(st.params, st.active, st.bound, cfg)
    bins = bin_gaussians(proj, cfg.H, cfg.W, cap=cfg.tile_cap, block_h=cfg.block_h,
                         block_w=cfg.block_w)
    ids, mask = bins.ids.numpy(), bins.mask.numpy()
    tb_x = -(-cfg.W // cfg.block_w)
    rows = set()
    for t in range(ids.shape[0]):
        k = ids[t][mask[t]]
        if k.size:
            edge = gate_band(proj.xys, proj.conics, k, t, tb_x,
                             block_h=cfg.block_h, block_w=cfg.block_w)[4]
            rows |= set(k[edge.any(1)].tolist())
    return proj, bins, rows


@pytest.mark.parametrize("block_h,block_w", BLOCKS)
def test_render_matches_jax_at_tile_size(block_h, block_w):
    """Every pixel within atol/rtol but at most ``MAX_FRAC`` of them, each
    within the rounding bound of the expanded quadratic (32x32 tiles put one
    pixel of this scene on the gate)."""
    raw, _, H, W = _model_case(82, zero_colors=False)
    cfg_j, cfg_t = _configs(raw, H, W, block_h, block_w, raster_backend="xla")
    ref = _jax_render(raw, cfg_j)
    st = state_from_numpy(raw, device="cpu")
    proj, bins, _ = _gate_band_rows(st, cfg_t)
    bound = sigma_error_bound(proj.xys, proj.conics, tgi.colors_of(st.params, cfg_t), bins.ids,
                              bins.mask, H, W, block_h=block_h, block_w=block_w)
    for what, img in (("render xla", tgi.render(st, cfg_t)),
                      ("render auto", tgi.render(st, dataclasses.replace(cfg_t, raster_backend="auto"))),
                      ("render_prepared", tgi.render_prepared(tgi.prepare_render(st, cfg_t), cfg_t))):
        assert img.shape == (H, W, 3), what
        assert_render_close(img, ref, bound=bound, max_frac=MAX_FRAC,
                            what=f"{what} {block_h}x{block_w}")
    assert float(ref.max()) > 0.1


@pytest.mark.parametrize("block_h,block_w", BLOCKS)
def test_xla_gradient_matches_jax_at_tile_size(block_h, block_w):
    """Every Gaussian's gradient within the tolerance, but those with a pair
    on the gate (``_gate_band_rows``, at most 5% of the rows)."""
    raw, gt, H, W = _model_case(82, zero_colors=False)
    cfg_j, cfg_t = _configs(raw, H, W, block_h, block_w, raster_backend="xla")
    ref = _jax_grads(raw, gt, cfg_j)
    port = _port_grads(raw, gt, cfg_t)
    _, _, band = _gate_band_rows(state_from_numpy(raw, device="cpu"), cfg_t)
    assert len(band) <= 0.05 * raw["xyz"].shape[0], band
    for a, b, name in zip(port, ref, ("xyz", "cov2d", "features")):
        scale = float(np.abs(b).max())
        assert scale > 0, name
        off = (np.abs(a - b) > TOL * scale + TOL * np.abs(b)).any(1)
        assert set(np.nonzero(off)[0].tolist()) <= band, f"{block_h}x{block_w} {name}"
        keep = np.array([i not in band for i in range(a.shape[0])])
        np.testing.assert_allclose(a[keep], b[keep], rtol=TOL, atol=TOL * scale,
                                   err_msg=f"{block_h}x{block_w} {name}")


def test_fit_image_at_8x8_tiles_matches_jax():
    H, W, M, seed = 40, 56, 96, 6
    gt = np.random.default_rng(9).uniform(0, 1, (H, W, 3)).astype(np.float32)
    kw = dict(H=H, W=W, max_num_points=M, tile_cap=48, block_h=8, block_w=8)
    cfg_j, cfg_t = jgi.GaussianConfig(**kw), tgi.GaussianConfig(**kw)
    tc = dict(iterations=20, grow_iter=10, prune_iter=10, lr=0.02)
    res_j = jtr.fit_image(jnp.asarray(gt), cfg_j, jtr.TrainConfig(**tc), 48, seed=seed)
    key = jax.random.PRNGKey(seed)
    k_init, key = jax.random.split(key)
    k_grow, _ = jax.random.split(key)
    init = jgi.init_state(cfg_j, 48, k_init)
    init = state_from_numpy({"xyz": init.params.xyz, "cov2d": init.params.cov2d,
                             "features": init.params.features, "active": init.active,
                             "bound": init.bound, "num_active": init.num_active}, device="cpu")
    draws = torch.as_tensor(np.array(jax.random.uniform(k_grow, (M, 3))))
    res_t = ttr.fit_image(gt, cfg_t, ttr.TrainConfig(**tc), 48, seed=seed, device="cpu",
                          gaussians=init, grow_draws=[draws])
    p_t, p_j = res_t.history["psnr"].numpy(), np.asarray(res_j.history["psnr"])
    assert p_t.shape == (20,) and np.isfinite(p_t).all() and p_t[9] > p_t[0]
    np.testing.assert_allclose(p_t[:10], p_j[:10], rtol=0, atol=1e-3)
    n_j, n_t = int(res_j.state.num_active), int(res_t.state.num_active)
    assert n_j > 48 and abs(n_t - n_j) <= 0.01 * n_j
    assert abs(res_t.best_psnr - res_j.best_psnr) <= 0.05


def test_auto_on_a_card_refuses_non_16_tiles():
    """A pure function of the config and the device type: no card needed."""
    cfg = tgi.GaussianConfig(H=48, W=80, block_h=8, block_w=8)
    with pytest.raises(NotImplementedError, match="raster_backend='xla'"):
        tgi.resolve_backend(cfg, "cuda")
    assert tgi.resolve_backend(cfg, "cpu") == "xla"
    assert tgi.resolve_backend(dataclasses.replace(cfg, raster_backend="xla"), "cuda") == "xla"
    assert tgi.resolve_backend(tgi.GaussianConfig(H=48, W=80), "cuda") == "pallas"   # 15 tiles
    assert tgi.resolve_backend(tgi.GaussianConfig(H=64, W=64), "cuda") == "list_t"   # 16 tiles


REFUSED = {
    **{f"render {b}": ("render", dict(raster_backend=b))
       for b in ("pallas", "list", "list_t", "dense", "sweep")},
    "render xla, kernel E binning": ("render", dict(raster_backend="xla", bin_method="pallas")),
    **{f"render_fast {s}": ("render_fast", dict(sweep=s))
       for s in (False, True, "range", "list", "list_t")},
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_kernel_paths_refuse_non_16_tiles(case):
    entry, kw = REFUSED[case]
    raw, _, H, W = _model_case(83, zero_colors=False)
    st = state_from_numpy(raw, device="cpu")
    sweep = kw.pop("sweep", None)
    _, cfg = _configs(raw, H, W, 8, 8, **kw)
    with pytest.raises(NotImplementedError, match="raster_backend='xla'"):
        if entry == "render":
            tgi.render(st, cfg)
        else:
            tgi.render_fast(st, cfg, sweep=sweep)
