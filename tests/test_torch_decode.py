"""The slice end to end at full width (768x512, ~5000 Gaussians), on the CPU:
the port's decode paths and ``render`` against the JAX package's.

- ``decode_bitstream`` of committed lsq and VQ streams against the JAX CPU
  decode (the binned path; on the CPU both pin the plain tiled render);
- ``prepare_decode`` + ``decode_frame``: the prepared table against JAX's
  prepare stage run eagerly, as its decode runs (counts exact, attributes to
  rtol 1e-6; JAX's ``prepare_decode`` jits that stage, and XLA's fused
  multiply-adds then move near-singular conics by up to 6e-5 relative), the
  frame against the JAX decode of the same stream. JAX's own ``decode_frame`` runs its Pallas
  kernel in interpret mode here; on kodim01 that render differs from JAX's
  binned decode of the same stream by up to 1.6e-3 at ~1300 pixels (sigma
  rounding flips the alpha >= 1/255 gate), so it is no reference at atol
  2e-5;
- ``render`` with the cap-free ``list_t`` backend on a fitted state against
  JAX ``render(raster_backend='xla')``, which is capped at 256: the same
  function when no tile has more than 256 members, asserted first;
- ``state_from_numpy`` round trip;
- the binned decode's CUDA graph inputs, on the CPU: padding a stream's rows
  to its 512-row bucket with inactive, zero-coded rows leaves the decode
  ``torch.equal``; the 50 committed streams share at most 8 graph keys; the
  CPU and an input that requires grad decode eagerly and capture nothing.

Tolerance atol 2e-5, rtol 1e-5 (``test_torch_raster.assert_render_close``);
at most ``MAX_FRAC`` of the pixels may miss it, each within the rounding bound
of the expanded quadratic. Measured: 60 pixels (0.015%) on kodim01, 121
(0.031%) on the fitted cn/kodim01 state.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gaussianimage_plus_tpu.compress.bitstream import decode_bitstream as jax_decode
from gaussianimage_plus_tpu.compress.pipeline import _decode_attributes as jax_decode_attributes
from gaussianimage_plus_tpu.compress.pipeline import prepare_decode as jax_prepare_decode
from gaussianimage_plus_tpu.models import gaussian_image as jgi

from gaussianimage_plus_tpu_torch.compress import pipeline as pl
from gaussianimage_plus_tpu_torch.compress.bitstream import decode_bitstream, deserialize_bitstream
from gaussianimage_plus_tpu_torch.compress.pipeline import (_decode_attributes, decode_frame,
                                                            morton_reorder, prepare_decode)
from gaussianimage_plus_tpu_torch.compress.quantizers import UniformQuantParams
from gaussianimage_plus_tpu_torch.core.binning import bin_gaussians
from gaussianimage_plus_tpu_torch.interop import config_from_numpy, state_from_numpy
from gaussianimage_plus_tpu_torch.kernels.raster_binned import _gather
from gaussianimage_plus_tpu_torch.models import gaussian_image as tgi

from test_torch_raster import assert_render_close, sigma_error_bound

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R4 = os.path.join(ROOT, "results", "bitstreams_r4", "kodim01.gipb")
VQ = os.path.join(ROOT, "results", "bitstreams_vq_r5", "kodim02.gipb")
R4_PORTRAIT = os.path.join(ROOT, "results", "bitstreams_r4", "kodim04.gipb")   # 768 x 512
# the benchmark's 50 streams (portbench/configs/kodak-768x512-n5000.json)
STREAMS = sorted(p for d in ("bitstreams_r3", "bitstreams_r4", "bitstreams_vq_r5")
                 for p in glob.glob(os.path.join(ROOT, "results", d, "*.gipb")))
STATE = os.path.join(ROOT, "results", "repr_states_cn", "kodim01.npz")
MAX_FRAC = 5e-4


def _stream_bound(dec, cfg):
    """Rounding bound of the expanded blend for a decoded stream's members."""
    means, cov, colors = _decode_attributes(dec.bundle, dec.enc, dec.qcfg)
    proj = tgi.project(None, dec.enc.active, dec.bound, cfg, cov_override=cov,
                       means_override=means)
    bins = bin_gaussians(proj, cfg.H, cfg.W, cap=cfg.tile_cap)
    return sigma_error_bound(proj.xys, proj.conics, colors, bins.ids, bins.mask, cfg.H, cfg.W)


def _cfg(dec):
    return tgi.GaussianConfig(H=dec.H, W=dec.W, max_num_points=dec.enc.active.shape[0],
                              tile_cap=dec.qcfg.decode_cap or 256)


@pytest.mark.parametrize("path", [R4, VQ], ids=["r4-kodim01", "vq_r5-kodim02"])
def test_decode_bitstream_matches_jax(path):
    data = open(path, "rb").read()
    ref, dj = jax_decode(data)
    img, dec = decode_bitstream(data, device="cpu")
    assert img.shape == (512, 768, 3) and img.dtype == torch.float32
    assert (dec.H, dec.W) == (dj.H, dj.W)
    assert_render_close(img, ref, bound=_stream_bound(dec, _cfg(dec)), max_frac=MAX_FRAC,
                        what=os.path.basename(path))
    # the cap-free chunk-list decode is the same function below the cap
    img_l, _ = decode_bitstream(data, backend="list_t", device="cpu")
    assert torch.equal(img_l, img)


def test_prepare_decode_and_frame_match_jax():
    data = open(R4, "rb").read()
    ref, dj = jax_decode(data)
    cfg_j = jgi.GaussianConfig(H=dj.H, W=dj.W, max_num_points=dj.enc.active.shape[0],
                               tile_cap=dj.qcfg.decode_cap or 256)
    _, dec = decode_bitstream(data, device="cpu")
    cfg = _cfg(dec)
    prep = prepare_decode(dec.bundle, dec.enc, dec.bound, cfg, dec.qcfg)
    # JAX's prepare_decode body, run eagerly like its decode_bitstream, on the
    # port's dequantized attributes: the two ``exp``s of the log-variance grid
    # differ by an ulp (test_torch_codec), which near-singular covariances
    # amplify in the conics, so identical inputs make the table comparable
    means, cov, colors = (jnp.asarray(a.numpy())
                          for a in _decode_attributes(dec.bundle, dec.enc, dec.qcfg))
    state_j = jgi.GaussianState(params=jgi.GaussianParams(xyz=means, cov2d=cov, features=colors),
                                active=dj.enc.active, bound=dj.bound, num_active=dj.enc.num_active)
    prep_j = jgi.prepare_render(state_j, cfg_j, cov_override=cov, means_override=means,
                                colors_override=colors)
    kmax = int(np.asarray(prep_j.counts).max())
    assert prep.ids.shape[1] == max(8, -(-kmax // 8) * 8)     # the trimmed cap
    np.testing.assert_array_equal(prep.counts.numpy(), np.asarray(prep_j.counts))
    # the rows the port's Prepared names through its slot ids, against JAX's gathered table
    raw = _gather(prep.table, prep.ids)
    np.testing.assert_allclose(raw.numpy(), np.asarray(prep_j.raw)[:, :prep.ids.shape[1]],
                               rtol=1e-6, atol=0)
    # JAX's jitted prepare_decode trims to the same cap
    assert tuple(jax_prepare_decode(dj.bundle, dj.enc, dj.bound, cfg_j, dj.qcfg).raw.shape) \
        == tuple(raw.shape)
    frame = decode_frame(prep, cfg)
    assert_render_close(frame, ref, bound=_stream_bound(dec, cfg), max_frac=MAX_FRAC,
                        what="decode_frame")
    # untrimmed and trimmed tables render identically
    full = prepare_decode(dec.bundle, dec.enc, dec.bound, cfg, dec.qcfg, trim=False)
    assert full.ids.shape[1] == 256 and torch.equal(decode_frame(full, cfg), frame)


def test_trimmed_prepared_decodes_the_untrimmed_frame():
    """``prepare_decode``'s trim cuts the slot ids to the fullest tile's
    occupancy (rounded up to 8) and keeps the attribute table: the trimmed
    and untrimmed ``Prepared`` name the same live rows and decode to the
    same frame (a VQ-colour stream)."""
    _, dec = decode_bitstream(open(VQ, "rb").read(), device="cpu")
    cfg = _cfg(dec)
    full = prepare_decode(dec.bundle, dec.enc, dec.bound, cfg, dec.qcfg, trim=False)
    trim = prepare_decode(dec.bundle, dec.enc, dec.bound, cfg, dec.qcfg)
    cap2 = trim.ids.shape[1]
    assert cap2 == max(8, -(-int(full.counts.max()) // 8) * 8) < full.ids.shape[1]
    assert torch.equal(trim.table, full.table) and torch.equal(trim.counts, full.counts)
    assert torch.equal(trim.ids, full.ids[:, :cap2]) and trim.ids.is_contiguous()
    assert bool((full.ids[:, cap2:] == full.table.shape[0] - 1).all())   # only sentinels cut
    assert torch.equal(decode_frame(trim, cfg), decode_frame(full, cfg))


def test_morton_reordered_stream_renders_the_same():
    _, dec = decode_bitstream(open(R4, "rb").read(), device="cpu")
    cfg = _cfg(dec)
    from gaussianimage_plus_tpu_torch.compress.pipeline import decompress_wo_ec

    base = decompress_wo_ec(dec.bundle, dec.enc, dec.bound, cfg, dec.qcfg, backend="list")
    enc_m, bound_m = morton_reorder(dec.enc, dec.bound, cfg)
    out = decompress_wo_ec(dec.bundle, enc_m, bound_m, cfg, dec.qcfg, backend="list")
    assert_render_close(out, base.numpy(), what="morton list")


def test_render_list_t_state_matches_jax_xla():
    d = dict(np.load(STATE))
    cfg = config_from_numpy(d, raster_backend="list_t")
    st = state_from_numpy(d, device="cpu")
    proj = tgi.project(st.params, st.active, st.bound, cfg)
    bins = bin_gaussians(proj, cfg.H, cfg.W, cap=10_000)
    assert int(bins.count.max()) <= 256          # capped == cap-free here
    out = tgi.render(st, cfg)
    cfg_j = jgi.GaussianConfig(H=cfg.H, W=cfg.W, max_num_points=cfg.max_num_points,
                               color_norm=cfg.color_norm, raster_backend="xla")
    state_j = jgi.GaussianState(
        params=jgi.GaussianParams(xyz=jnp.asarray(d["xyz"]), cov2d=jnp.asarray(d["cov2d"]),
                                  features=jnp.asarray(d["features"])),
        active=jnp.asarray(d["active"]), bound=jnp.asarray(d["bound"]),
        num_active=jnp.asarray(d["num_active"]))
    ref = jgi.render(state_j, cfg_j)
    colors = tgi.colors_of(st.params, cfg)
    bins = bin_gaussians(proj, cfg.H, cfg.W, cap=256)
    bound = sigma_error_bound(proj.xys, proj.conics, colors, bins.ids, bins.mask, cfg.H, cfg.W)
    assert_render_close(out, ref, bound=bound, max_frac=MAX_FRAC, what="list_t state")
    # 'auto' on the CPU is the plain binned path ('xla'), as in the JAX package
    auto = dataclasses.replace(cfg, raster_backend="auto")
    assert tgi.resolve_backend(auto, "cpu") == "xla"
    assert tgi.resolve_backend(auto, "cuda") == "list_t"
    assert tgi.resolve_backend(dataclasses.replace(auto, H=48, W=48), "cuda") == "pallas"
    assert torch.equal(tgi.render(st, auto), tgi.render(st, dataclasses.replace(cfg, raster_backend="xla")))


def test_state_from_numpy_round_trip():
    d = dict(np.load(STATE))
    st = state_from_numpy(d, device="cpu")
    for k, v in (("xyz", st.params.xyz), ("cov2d", st.params.cov2d),
                 ("features", st.params.features), ("bound", st.bound), ("active", st.active)):
        np.testing.assert_array_equal(v.numpy(), d[k])
    assert int(st.num_active) == int(d["num_active"])
    cfg = config_from_numpy(d)
    assert (cfg.H, cfg.W, cfg.max_num_points, cfg.color_norm) == (512, 768, 5000, True)


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        decode_bitstream(open(R4, "rb").read())
    with pytest.raises(RuntimeError):
        state_from_numpy(dict(np.load(STATE)))
    # the cap-free backends decode on the CPU when asked, through render_fast
    data = open(R4, "rb").read()
    ref, _ = decode_bitstream(data, backend="list_t", device="cpu")
    for backend in ("dense", "sweep", "range"):
        img, _ = decode_bitstream(data, backend=backend, device="cpu")
        assert_render_close(img, ref.numpy(), what=backend)
    assert jax.default_backend() == "cpu"


def _transposed(dec):
    """The stream's image transposed: x and y swapped in the position codes,
    their grid and the covariance codes, H and W swapped (the committed VQ
    streams are all landscape)."""
    enc, xy = dec.enc, dec.bundle.xy
    enc = enc._replace(means=enc.means[:, [1, 0]], quant_means=enc.quant_means[:, [1, 0]],
                       quant_cov=enc.quant_cov[:, [2, 1, 0]])
    bundle = dec.bundle._replace(xy=UniformQuantParams(scale=xy.scale[[1, 0]],
                                                       beta=xy.beta[[1, 0]]))
    return dec._replace(enc=enc, bundle=bundle, H=dec.W, W=dec.H)


@pytest.mark.parametrize("path,transpose", [(R4, False), (R4_PORTRAIT, False), (VQ, False),
                                            (VQ, True)],
                         ids=["lsq-landscape", "lsq-portrait", "vq-landscape", "vq-portrait"])
def test_row_bucket_padding_keeps_the_decode(path, transpose):
    """The graph's buffers hold a stream's rows padded to a multiple of 512
    with inactive rows of zero codes; reloaded after an input that filled
    the whole bucket with active rows, they decode to the eager image."""
    dec = deserialize_bitstream(open(path, "rb").read(), device="cpu")
    if transpose:
        dec = _transposed(dec)
    cfg = _cfg(dec)
    eager = pl.decompress_wo_ec(dec.bundle, dec.enc, dec.bound, cfg, dec.qcfg)
    gcfg = pl.decode_graph_key(dec.bundle, dec.enc, dec.bound, cfg, dec.qcfg)[1]
    m, n = dec.enc.active.shape[0], gcfg.max_num_points
    assert n % pl.ROW_BUCKET == 0 and 0 < n - m < pl.ROW_BUCKET
    assert gcfg.bin_method == "pallas" and (gcfg.H, gcfg.W) == (dec.H, dec.W)
    inp = pl._decode_inputs(dec.bundle, dec.enc, dec.bound)
    g = pl._DecodeGraph(inp, gcfg, dec.qcfg)
    full = [torch.cat([t, t[:n - m]]) for t in inp.rows]
    full[3] = torch.ones_like(full[3])                       # every row active
    g.load(inp._replace(rows=tuple(full)))
    assert bool(g.static.rows[3].all())
    g.load(inp)
    assert all(not bool(t[m:].any()) for t in g.static.rows)
    assert torch.equal(g.run(), eager)


def test_committed_streams_share_few_graph_keys():
    """The 50 committed streams (two orientations, two colour modes, 4552 to
    4960 rows) map to at most 8 graph keys, and each key to one config."""
    assert len(STREAMS) == 50
    keys = set()
    for path in STREAMS:
        dec = deserialize_bitstream(open(path, "rb").read(), device="cpu")
        keys.add(pl.decode_graph_key(dec.bundle, dec.enc, dec.bound, _cfg(dec), dec.qcfg))
    assert len(keys) <= 8
    assert {(k[1].H, k[1].W) for k in keys} == {(512, 768), (768, 512)}
    assert {k[3] for k in keys} == {"lsq", "vq"}


def test_cpu_and_grad_inputs_decode_eagerly():
    """On the CPU, and with an input that requires grad, the binned decode
    runs eagerly (dequantize, then ``render`` with its binning span) and
    counts no graph capture or replay."""
    from gaussianimage_plus_tpu_torch.utils import profiling

    dec = deserialize_bitstream(open(VQ, "rb").read(), device="cpu")
    cfg = _cfg(dec)
    color_vq = dec.bundle.color_vq._replace(layers=tuple(
        cb._replace(embed=cb.embed.clone().requires_grad_(True))
        for cb in dec.bundle.color_vq.layers))
    graded = dec.bundle._replace(color_vq=color_vq)
    profiling.reset()
    try:
        with profiling.recording():
            img = pl.decompress_wo_ec(dec.bundle, dec.enc, dec.bound, cfg, dec.qcfg)
            img_g = pl.decompress_wo_ec(graded, dec.enc, dec.bound, cfg, dec.qcfg)
        names = [s.name for s in profiling.spans()]
        counters = profiling.counters()
    finally:
        profiling.reset()
    assert not pl._graphs(pl._decode_inputs(dec.bundle, dec.enc, dec.bound), cfg)
    assert names.count("decode.dequantize") == 2 and names.count("render.bin") == 2
    assert "decode.graph_captures" not in counters and "decode.graph_replays" not in counters
    assert img_g.requires_grad and torch.equal(img_g.detach(), img)
    assert not pl._DECODE_GRAPHS
