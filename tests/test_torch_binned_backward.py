"""The binned, capped backward (kernel D's plain version, on the CPU) against
the JAX package.

- The VJP of ``rasterize_binned`` against JAX ``rasterize_pallas`` (Pallas in
  interpret mode), with ``gather_tiles`` 0 (the scatter-add) and 64 (the
  inverse-map gather): in id order, with invalid rows, on an odd tile grid,
  and at a cap small enough (16) that a crowded tile clips members.
- Gradients of the L2 loss through ``render`` with ``raster_backend=
  'pallas'``, binned by ``'top_k'`` and by ``'pallas'`` (kernel E's plain
  version; JAX's Pallas binner in interpret mode), against ``jax.grad`` of
  the JAX render.
- A 60-step ``train_chunk`` through ``'pallas'`` with a prune, from one
  interop'd state, against the JAX one: PSNR within 1e-3 dB at every step.

Tolerances as in ``test_torch_backward.py``: rtol/atol 5e-4, plus 5e-6 of the
column's largest entry on the conics (the sums run in another order);
through ``render``, atol 5e-4 of the largest entry. The JAX kernel evaluates
sigma as a dot product, the port as a fused-multiply-add chain; the scenes
above hold no (member, pixel) pair whose alpha >= 1/255 gate those two
roundings decide differently. Seed 82 of the odd grid holds one, and has a
test of its own: there the two JAX backwards agree with each other, and the
port's conic and colour gradients leave the tolerance above by the one
flipped pair's term (2e-4 of the colour column's largest entry), within a
bound of 3e-4 of each column's largest entry.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gaussianimage_plus_tpu.core.binning import bin_gaussians as jax_bin
from gaussianimage_plus_tpu.kernels.raster_pallas import rasterize_pallas as jax_rasterize_pallas
from gaussianimage_plus_tpu.models import gaussian_image as jgi
from gaussianimage_plus_tpu.train import trainer as jtr

from gaussianimage_plus_tpu_torch.core.binning import bin_gaussians
from gaussianimage_plus_tpu_torch.interop import state_from_numpy, train_state_from_numpy
from gaussianimage_plus_tpu_torch.kernels import raster_binned
from gaussianimage_plus_tpu_torch.models import gaussian_image as tgi
from gaussianimage_plus_tpu_torch.train import trainer as ttr

from test_torch_backward import (NAMES, TOL, _jax_grads, _model_case, _port_grads,
                                 assert_grads_close)
from test_torch_raster import both_projections, scene

CASES = {
    "id-order": dict(seed=80),
    "invalid-rows": dict(seed=81, n_invalid=7),
    "odd-grid": dict(seed=84, H=45, W=77, n=70),
    "clipped-cap16": dict(seed=83, n=120, cap=16, crowd=40),
}


def _binned_case(seed, n=60, H=48, W=80, n_invalid=0, cap=64, crowd=0):
    xy, cov, colors, opacity, H, W = scene(n=n, H=H, W=W, seed=seed, n_invalid=n_invalid)
    xy[n_invalid:n_invalid + crowd] = np.float32(12.3)   # one crowded tile, off the pixel grid
    pj, pt = both_projections(xy, cov, H, W)
    bj, bt = jax_bin(pj, H, W, cap=cap), bin_gaussians(pt, H, W, cap=cap)
    v_img = np.random.default_rng(seed).normal(size=(H, W, 3)).astype(np.float32)
    return pj, pt, bj, bt, colors, opacity, v_img, H, W


@pytest.mark.parametrize("gather_tiles", [0, 64])
@pytest.mark.parametrize("case", list(CASES))
def test_binned_vjp_matches_jax(case, gather_tiles):
    pj, pt, bj, bt, colors, opacity, v_img, H, W = _binned_case(**CASES[case])
    if case == "clipped-cap16":
        full = bin_gaussians(pt, H, W, cap=512)
        assert int(full.count.max()) > 16 and int(bt.count.max()) == 16   # members clipped
    _, vjp = jax.vjp(
        lambda a, b, c, d: jax_rasterize_pallas(a, b, c, d, bj.ids, bj.mask, pj.radii, H, W,
                                                16, 16, gather_tiles),
        pj.xys, pj.conics, jnp.asarray(colors), jnp.asarray(opacity))
    ref = vjp(jnp.asarray(v_img))
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (pt.xys, pt.conics, torch.as_tensor(colors), torch.as_tensor(opacity))]
    img = raster_binned.rasterize_binned(*leaves, bt.ids, bt.mask, pt.radii, H, W)
    img.backward(torch.as_tensor(v_img))
    assert_grads_close([t.grad for t in leaves], ref, f"binned {case} gather_tiles {gather_tiles}")
    # a Gaussian clipped from every tile it covers gets no gradient
    listed = torch.zeros(pt.xys.shape[0], dtype=torch.bool)
    listed[bt.ids[bt.mask].long()] = True
    assert not leaves[2].grad[~listed].any()


FLIP_REL = 3e-4


def test_binned_vjp_with_a_gate_flip_stays_within_its_bound():
    """Seed 82: one (member, pixel) pair sits on the alpha gate, and the JAX
    dot product and the port's FMA chain round it to opposite sides."""
    pj, pt, bj, bt, colors, opacity, v_img, H, W = _binned_case(seed=82, H=45, W=77, n=70)
    refs = []
    for gather_tiles in (0, 64):
        _, vjp = jax.vjp(
            lambda a, b, c, d: jax_rasterize_pallas(a, b, c, d, bj.ids, bj.mask, pj.radii, H, W,
                                                    16, 16, gather_tiles),
            pj.xys, pj.conics, jnp.asarray(colors), jnp.asarray(opacity))
        refs.append([np.asarray(g) for g in vjp(jnp.asarray(v_img))])
    for a, b, name in zip(*refs, NAMES):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * float(np.abs(b).max()),
                                   err_msg=f"JAX scatter vs gather {name}")
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (pt.xys, pt.conics, torch.as_tensor(colors), torch.as_tensor(opacity))]
    raster_binned.rasterize_binned(*leaves, bt.ids, bt.mask, pt.radii, H, W).backward(
        torch.as_tensor(v_img))
    excess = {}
    for t, b, name in zip(leaves, refs[0], NAMES):
        a, scale = t.grad.numpy(), float(np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL + FLIP_REL * scale, err_msg=name)
        excess[name] = float((np.abs(a - b) - TOL * np.abs(b)).max()) / scale
    # the flip is visible: the colours leave the tolerance of the other scenes
    assert excess["colors"] > TOL / float(np.abs(refs[0][2]).max()), excess


def test_tile_table_backward_plain_sums_the_slot_payload():
    """The wrapper on CPU tensors: the per-slot payload summed per Gaussian,
    with the inputs the autograd Function saves."""
    pj, pt, bj, bt, colors, opacity, v_img, H, W = _binned_case(**CASES["odd-grid"])
    col_t, op_t = torch.as_tensor(colors), torch.as_tensor(opacity)
    N = pt.xys.shape[0]
    table, ids_s, counts = raster_binned._slot_table(pt.xys, pt.conics, col_t, op_t, bt.ids,
                                                     bt.mask)
    bbox = raster_binned.tile_bbox_table(pt.xys, pt.radii, (5, 3))
    out = raster_binned.tile_table_backward(table, counts, ids_s, bbox, torch.as_tensor(v_img))
    assert out.shape == (N, 9)
    leaves = [t.detach().clone().requires_grad_(True) for t in (pt.xys, pt.conics, col_t, op_t)]
    raster_binned.rasterize_binned(*leaves, bt.ids, bt.mask, pt.radii, H, W).backward(
        torch.as_tensor(v_img))
    grads = torch.cat([leaves[0].grad, leaves[1].grad, leaves[2].grad, leaves[3].grad[:, None]], 1)
    assert torch.equal(out, grads)
    with pytest.raises(TypeError):
        raster_binned.tile_table_backward(table, counts, ids_s.to(torch.int64), bbox,
                                          torch.as_tensor(v_img))


def test_binned_function_saves_the_table_not_a_gathered_one():
    """The binned Function keeps the [N+1, 16] attribute table and the int32
    slot ids for kernel D, and no [T, K, 16] table."""
    pj, pt, bj, bt, colors, opacity, v_img, H, W = _binned_case(**CASES["id-order"])
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (pt.xys, pt.conics, torch.as_tensor(colors), torch.as_tensor(opacity))]
    img = raster_binned.rasterize_binned(*leaves, bt.ids, bt.mask, pt.radii, H, W)
    table, counts, ids_s, bbox = img.grad_fn.saved_tensors
    N = pt.xys.shape[0]
    assert table.shape == (N + 1, 16) and bbox.shape == (N, 4)
    assert ids_s.dtype == torch.int32 and ids_s.shape[0] == counts.shape[0] == bt.ids.shape[0]


@pytest.mark.parametrize("case", list(CASES))
def test_tile_table_backward_plain_on_the_table_matches_jax_vjp(case):
    """Kernel D's plain version, called as the kernel is (the [N+1, 16]
    attribute table, the int32 slot ids, the counts, the tile bboxes), against
    the JAX binned VJP (the scatter-add, ``gather_tiles`` 0)."""
    pj, pt, bj, bt, colors, opacity, v_img, H, W = _binned_case(**CASES[case])
    _, vjp = jax.vjp(
        lambda a, b, c, d: jax_rasterize_pallas(a, b, c, d, bj.ids, bj.mask, pj.radii, H, W),
        pj.xys, pj.conics, jnp.asarray(colors), jnp.asarray(opacity))
    ref = vjp(jnp.asarray(v_img))
    table, ids_s, counts = raster_binned._slot_table(
        pt.xys, pt.conics, torch.as_tensor(colors), torch.as_tensor(opacity), bt.ids, bt.mask)
    assert table.shape == (pt.xys.shape[0] + 1, 16) and ids_s.dtype == torch.int32
    bbox = raster_binned.tile_bbox_table(pt.xys, pt.radii, (-(-W // 16), -(-H // 16)))
    acc = raster_binned.tile_table_backward_plain(table, counts, ids_s, bbox,
                                                  torch.as_tensor(v_img))
    assert_grads_close([acc[:, 0:2], acc[:, 2:5], acc[:, 5:8], acc[:, 8]], ref,
                       f"kernel D plain {case}")


@pytest.mark.parametrize("bin_method", ["top_k", "pallas"])
def test_render_pallas_grads_match_jax(bin_method):
    raw, gt, H, W = _model_case(90, zero_colors=False)
    kw = dict(H=H, W=W, max_num_points=raw["xyz"].shape[0], tile_cap=16,
              raster_backend="pallas", bin_method=bin_method)
    ref = _jax_grads(raw, gt, jgi.GaussianConfig(**kw))
    port = _port_grads(raw, gt, tgi.GaussianConfig(**kw))
    for a, b, name in zip(port, ref, ("xyz", "cov2d", "features")):
        scale = float(np.abs(b).max())
        assert scale > 0
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL * scale, err_msg=f"{bin_method} {name}")


def test_render_pallas_keeps_the_graph():
    """``'pallas'`` is differentiable through kernels A and D: the loss
    reaches every parameter, and a no-grad render still works."""
    raw, _, H, W = _model_case(91, zero_colors=False)
    st = state_from_numpy(raw, device="cpu")
    params = tgi.GaussianParams(*(p.clone().requires_grad_(True) for p in st.params))
    cfg = tgi.GaussianConfig(H=H, W=W, max_num_points=raw["xyz"].shape[0], raster_backend="pallas")
    img = tgi.render(st._replace(params=params), cfg)
    assert img.grad_fn is not None
    assert all(bool(g.abs().sum() > 0) for g in torch.autograd.grad(img.sum(), params))
    with torch.no_grad():
        assert torch.equal(tgi.render(st, cfg), img.detach())


def test_train_chunk_pallas_matches_jax():
    """60 steps through the binned pair with the per-tile cap live, then a
    prune, from one interop'd state (no Morton re-sort: clipping follows id
    order)."""
    H, W = 48, 64
    gt = np.random.default_rng(4).uniform(0, 1, (H, W, 3)).astype(np.float32)
    kw = dict(H=H, W=W, max_num_points=64, tile_cap=8, raster_backend="pallas")
    cfg_j, cfg_t = jgi.GaussianConfig(**kw), tgi.GaussianConfig(**kw)
    tc = dict(iterations=60, grow_iter=30, prune_iter=30, lr=0.02)
    ts_j = jtr.init_train_state(cfg_j, jtr.TrainConfig(**tc), 48, seed=2)
    ts_t = train_state_from_numpy(ts_j, device="cpu")
    g = ts_t.gaussians
    proj = tgi.project(g.params, g.active, g.bound, cfg_t)
    assert int(bin_gaussians(proj, H, W, cap=64).count.max()) > 8      # the cap clips at init
    ts_j, m_j = jtr.train_chunk(ts_j, jnp.asarray(gt), cfg_j, jtr.TrainConfig(**tc), 60, True, False)
    ts_t, m_t = ttr.train_chunk(ts_t, torch.as_tensor(gt), cfg_t, ttr.TrainConfig(**tc), 60,
                                True, False)
    p_j, p_t = np.asarray(m_j["psnr"]), m_t["psnr"].numpy()
    assert p_t.shape == (60,) and p_t[-1] > p_t[0] + 1.0
    np.testing.assert_allclose(p_t, p_j, rtol=0, atol=1e-3)
    assert int(ts_t.gaussians.num_active) == int(ts_j.gaussians.num_active)
