"""The dense, sweep and range backends (kernels B and C through their plain
versions, on the CPU) against the JAX package's Pallas kernels in interpret
mode.

- Forwards: ``rasterize_dense_pallas``, ``rasterize_sweep_pallas`` and
  ``rasterize_range_pallas`` (kc 64 and 16) in id and Morton order, with
  invalid rows, on an odd tile grid; tolerance atol 2e-5, rtol 1e-5
  (``test_torch_raster.assert_render_close``). The chunk enumerations are
  checked as integers: sweep lists each tile's member chunks, range their
  span.
- Gradients: the VJPs of ``rasterize_dense`` and ``rasterize_sweep`` against
  JAX's, and ``sweep_backward`` against JAX's, at rtol/atol 5e-4 (plus 5e-6
  of the column's largest entry on the conics, ``test_torch_backward``);
  ``render`` with ``'dense'``, ``'sweep'`` and ``'range'`` against
  ``jax.grad`` of the JAX render with the same config (neither ``render``
  has a ``'range'`` branch: both take the capped tiled path there).
- ``render_fast``'s default is the dense kernel, as in the JAX package, and
  it calls the forwards directly, not through ``render``.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gaussianimage_plus_tpu.core.binning import morton_perm as jax_morton
from gaussianimage_plus_tpu.kernels import raster_dense_pallas as jrd
from gaussianimage_plus_tpu.models import gaussian_image as jgi

from gaussianimage_plus_tpu_torch.core.binning import bin_gaussians
from gaussianimage_plus_tpu_torch.core.gaussian2d import tile_bounds_for
from gaussianimage_plus_tpu_torch.interop import state_from_numpy
from gaussianimage_plus_tpu_torch.kernels import raster_dense, raster_list
from gaussianimage_plus_tpu_torch.models import gaussian_image as tgi

from test_torch_backward import TOL, _jax_grads, _model_case, _port_grads, assert_grads_close
from test_torch_raster import assert_render_close, both_projections, scene

FWD_CASES = {
    "id-order": dict(seed=101),
    "morton": dict(seed=102, morton=True),
    "invalid-rows": dict(seed=103, n_invalid=9),
    "odd-grid": dict(seed=104, H=45, W=77),
    "morton-kc16": dict(seed=105, morton=True, kc=16),
}


def _case(seed, n=150, H=48, W=80, n_invalid=0, morton=False):
    xy, cov, colors, opacity, H, W = scene(n=n, H=H, W=W, seed=seed, n_invalid=n_invalid)
    perm = None
    if morton:
        pj, _ = both_projections(xy, cov, H, W)
        perm = np.asarray(jax_morton(pj.xys, pj.valid, H, W))
        colors, opacity = colors[perm], opacity[perm]
    pj, pt = both_projections(xy, cov, H, W, perm)
    return pj, pt, colors, opacity, H, W


@pytest.mark.parametrize("kernel,case", [(k, c) for c in FWD_CASES for k in ("dense", "sweep", "range")
                                         if not (k == "dense" and "kc" in FWD_CASES[c])])
def test_forward_matches_jax(kernel, case):
    kw = dict(FWD_CASES[case])
    kc = kw.pop("kc", None)
    pj, pt, colors, opacity, H, W = _case(**kw)
    extra = {} if kc is None else {"kc": kc}
    name = f"rasterize_{kernel}_pallas"
    ref = getattr(jrd, name)(pj, jnp.asarray(colors), jnp.asarray(opacity), H, W, **extra)
    out = getattr(raster_dense, name)(pt, torch.as_tensor(colors), torch.as_tensor(opacity),
                                      H, W, **extra)
    assert_render_close(out, ref, what=f"{kernel} {case}")


@pytest.mark.parametrize("kc", [64, 16])
def test_enumerations_cover_the_member_chunks(kc):
    """Sweep lists exactly the member chunks; range spans the first to the
    last; dense visits every chunk."""
    _, pt, colors, opacity, H, W = _case(seed=106, n_invalid=5, morton=True)
    table, bbox, N, Np = raster_list._table_bbox(pt, torch.as_tensor(colors),
                                                 torch.as_tensor(opacity), H, W, kc)
    tb_x, tb_y = tile_bounds_for(H, W)
    mc = raster_list._bbox_members(table, bbox, tb_x, tb_x * tb_y).reshape(tb_x * tb_y, -1, kc).any(-1)
    nch = Np // kc
    lst, cnt, lo2, hi2 = raster_dense.sweep_lists(table, bbox, N, Np, kc, H, W)
    assert not (lo2.any() or hi2.any()) and lst.shape == (tb_x * tb_y, nch)
    for t in range(tb_x * tb_y):
        assert lst[t, :cnt[t]].tolist() == mc[t].nonzero().flatten().tolist()
    _, cnt_r, lo, hi = raster_dense.range_lists(table, bbox, N, Np, kc, H, W)
    assert not cnt_r.any()
    some = mc.any(1)
    ch = torch.arange(nch)
    first = torch.where(mc, ch, nch).amin(1)
    last = torch.where(mc, ch, -1).amax(1)
    assert torch.equal(lo, torch.where(some, first, 0).to(torch.int32))
    assert torch.equal(hi, torch.where(some, last + 1, 0).to(torch.int32))
    _, cnt_d, lo_d, hi_d = raster_dense.dense_lists(table, bbox, N, Np, kc, H, W)
    assert not (cnt_d.any() or lo_d.any()) and bool((hi_d == nch).all())


@pytest.mark.parametrize("kernel", ["dense", "sweep"])
@pytest.mark.parametrize("case", ["id-order", "morton", "odd-grid"])
def test_vjp_matches_jax(kernel, case):
    pj, pt, colors, opacity, H, W = _case(**{**FWD_CASES[case], "n_invalid": 6})
    v_img = np.random.default_rng(len(case)).normal(size=(H, W, 3)).astype(np.float32)
    jfn = jrd.rasterize_dense if kernel == "dense" else jrd.rasterize_sweep
    _, vjp = jax.vjp(lambda a, b, c, d: jfn(a, b, c, d, pj.radii, pj.valid, H, W),
                     pj.xys, pj.conics, jnp.asarray(colors), jnp.asarray(opacity))
    ref = vjp(jnp.asarray(v_img))
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (pt.xys, pt.conics, torch.as_tensor(colors), torch.as_tensor(opacity))]
    tfn = raster_dense.rasterize_dense if kernel == "dense" else raster_dense.rasterize_sweep
    tfn(*leaves, pt.radii, pt.valid, H, W).backward(torch.as_tensor(v_img))
    assert_grads_close([t.grad for t in leaves], ref, f"{kernel} {case}")
    assert not leaves[2].grad[~pt.valid].any()


def test_sweep_backward_matches_jax():
    pj, pt, colors, opacity, H, W = _case(seed=107, morton=True, n_invalid=4)
    v_img = np.random.default_rng(7).normal(size=(H, W, 3)).astype(np.float32)
    port = raster_dense.sweep_backward(pt, torch.as_tensor(colors), torch.as_tensor(opacity),
                                       torch.as_tensor(v_img), H, W)
    ref = jrd.sweep_backward(pj, jnp.asarray(colors), jnp.asarray(opacity), jnp.asarray(v_img), H, W)
    assert_grads_close(port, ref, "sweep_backward")


@pytest.mark.parametrize("backend", ["dense", "sweep", "range"])
def test_render_grads_match_jax_dense(backend):
    raw, gt, H, W = _model_case(110, zero_colors=False)
    kw = dict(H=H, W=W, max_num_points=raw["xyz"].shape[0])
    ref = _jax_grads(raw, gt, jgi.GaussianConfig(raster_backend=backend, tile_cap=16, **kw))
    cfg = tgi.GaussianConfig(raster_backend=backend, tile_cap=16, **kw)
    proj = tgi.project(*state_from_numpy(raw, device="cpu")[:3], cfg)
    most = int(bin_gaussians(proj, H, W, cap=4096).count.max())
    assert most > 16                      # the cap clips: capped and cap-free differ
    port = _port_grads(raw, gt, cfg)
    for a, b, name in zip(port, ref, ("xyz", "cov2d", "features")):
        scale = float(np.abs(b).max())
        assert scale > 0
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL * scale, err_msg=f"{backend} {name}")


def test_render_fast_defaults_to_the_dense_kernel(monkeypatch):
    """The JAX ``render_fast`` defaults to the dense kernel (``sweep=False``);
    the port's did to ``'list_t'``. Same image either way, so the call is
    traced: the default must enumerate every chunk."""
    raw, _, H, W = _model_case(111, zero_colors=False)
    st = state_from_numpy(raw, device="cpu")
    cfg = tgi.GaussianConfig(H=H, W=W, max_num_points=raw["xyz"].shape[0])
    calls = []
    orig = raster_dense.dense_lists

    def spy(*a):
        calls.append(a[4])                              # kc
        return orig(*a)

    monkeypatch.setattr(raster_dense, "dense_lists", spy)
    img = tgi.render_fast(st, cfg)
    assert calls == [raster_dense.DENSE_KC]
    for sweep in ("list_t", True, "range"):
        assert_render_close(tgi.render_fast(st, cfg, sweep=sweep), img.numpy(), what=str(sweep))
    assert calls == [raster_dense.DENSE_KC]
    # the forwards are called directly, not through render's backends
    monkeypatch.setattr(tgi, "render", None)
    assert_render_close(tgi.render_fast(st, cfg, sweep="range"), img.numpy(), what="no render")
    with pytest.raises(ValueError):
        tgi.render_fast(st, cfg, sweep="binned")
