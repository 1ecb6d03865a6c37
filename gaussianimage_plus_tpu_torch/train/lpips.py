"""LPIPS (Learned Perceptual Image Patch Similarity) with a VGG-16 backbone.

Port of ``gaussianimage_plus_tpu/train/lpips.py``, which mirrors the
``lpips`` package's ``LPIPS(net='vgg')`` as the reference uses it
(models/metrics.py:62-95): scaling layer -> VGG-16 feature slices (relu1_2,
relu2_2, relu3_3, relu4_3, relu5_3) -> unit-normalize over channels ->
squared difference -> 1x1 linear heads (no bias) -> spatial mean -> sum over
the five layers. ``lpips(img0, img1, params)`` takes [H, W, 3] images in
[0, 1] and does the reference's ``2 * rgb - 1`` remap itself.

The JAX version is plain XLA, so this one is plain PyTorch
(``torch.nn.functional.conv2d`` and ``max_pool2d``), float32 with TF32 off
(``core/precision.py``). Pretrained weights are not bundled: load an
``.npz`` export with ``params_from_npz`` (the JAX package's layout, so one
file serves both packages: ``conv{i}_w``, ``conv{i}_b`` for i in 0..12,
``lin{j}_w`` for j in 0..4), convert torchvision's ``vgg16`` state dict and
the lpips package's linear heads with ``params_from_torch``, or draw
architecture-shaped weights with ``random_params``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.precision import resolve_device

# torchvision vgg16 'D' configuration: 13 3x3 convs; a 2x2 max-pool before
# convs 2, 4, 7 and 10 (0-indexed), at the start of LPIPS slices 2..5.
VGG_CHANNELS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
POOL_BEFORE = (2, 4, 7, 10)
# LPIPS taps the ReLU after convs 1, 3, 6, 9, 12 (relu1_2 ... relu5_3).
SLICE_ENDS = (1, 3, 6, 9, 12)
LIN_CHANNELS = (64, 128, 256, 512, 512)

# lpips.ScalingLayer constants (lpips/lpips.py v0.1).
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPSParams(NamedTuple):
    conv_w: Tuple[torch.Tensor, ...]   # 13 x [O, I, 3, 3]
    conv_b: Tuple[torch.Tensor, ...]   # 13 x [O]
    lin_w: Tuple[torch.Tensor, ...]    # 5 x [C] (1x1 conv, no bias)


def random_params(generator: torch.Generator, scale: float = 0.1) -> LPIPSParams:
    """Architecture-shaped random weights on the generator's device (tests
    and smoke runs only)."""
    dev = generator.device
    normal = lambda *shape: torch.randn(shape, generator=generator, device=dev) * scale
    conv_w, conv_b = [], []
    c_in = 3
    for c_out in VGG_CHANNELS:
        conv_w.append(normal(c_out, c_in, 3, 3))
        conv_b.append(normal(c_out))
        c_in = c_out
    # real LPIPS heads are non-negative; keep that property
    lin_w = [normal(c).abs() for c in LIN_CHANNELS]
    return LPIPSParams(tuple(conv_w), tuple(conv_b), tuple(lin_w))


@functools.lru_cache(maxsize=2)
def _npz_arrays(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def params_from_npz(path: str, device=None) -> LPIPSParams:
    """Weights from an ``.npz`` export, on ``device`` (the card unless
    ``device='cpu'``). The file's arrays are cached (~55 MB of VGG weights;
    eval loops call this once an image)."""
    dev = resolve_device(device)
    z = _npz_arrays(str(path))
    t = lambda k: torch.as_tensor(z[k], dtype=torch.float32, device=dev)
    return LPIPSParams(tuple(t(f"conv{i}_w") for i in range(13)),
                       tuple(t(f"conv{i}_b") for i in range(13)),
                       tuple(t(f"lin{j}_w") for j in range(5)))


def save_npz(path: str, params: LPIPSParams) -> None:
    np_ = lambda x: x.detach().cpu().numpy()
    np.savez(path, **{f"conv{i}_w": np_(w) for i, w in enumerate(params.conv_w)},
             **{f"conv{i}_b": np_(b) for i, b in enumerate(params.conv_b)},
             **{f"lin{j}_w": np_(w) for j, w in enumerate(params.lin_w)})


def params_from_torch(vgg_state_dict, lin_state_dict, device=None) -> LPIPSParams:
    """Convert torchvision ``vgg16().state_dict()`` and the lpips package's
    ``weights/v0.1/vgg.pth`` (keys ``lin{j}.model.1.weight`` [1, C, 1, 1])."""
    dev = resolve_device(device)
    feat_idx = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32).to(dev)
    return LPIPSParams(tuple(t(vgg_state_dict[f"features.{i}.weight"]) for i in feat_idx),
                       tuple(t(vgg_state_dict[f"features.{i}.bias"]) for i in feat_idx),
                       tuple(t(lin_state_dict[f"lin{j}.model.1.weight"]).reshape(-1)
                             for j in range(5)))


def _vgg_slices(params: LPIPSParams, x: torch.Tensor):
    """x: [N, 3, H, W] scaled input -> the five tapped feature maps."""
    feats = []
    for i, (w, b) in enumerate(zip(params.conv_w, params.conv_b)):
        if i in POOL_BEFORE:
            x = F.max_pool2d(x, 2, 2)
        x = F.relu(F.conv2d(x, w, b, padding=1))
        if i in SLICE_ENDS:
            feats.append(x)
    return feats


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """lpips.normalize_tensor: divide by the channel L2 norm (eps outside
    the sqrt, as the package does)."""
    return x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + eps)


@torch.no_grad()
def lpips(img0: torch.Tensor, img1: torch.Tensor, params: LPIPSParams) -> torch.Tensor:
    """LPIPS distance between two [H, W, 3] images in [0, 1] on the weights'
    device, as a 0-d tensor: the reference's ``lpips_model(2 * rgb - 1,
    2 * gts - 1).mean()`` (models/metrics.py:95) in eval mode."""
    dev = params.lin_w[0].device
    shift = torch.tensor(_SHIFT, device=dev)[None, :, None, None]
    scale = torch.tensor(_SCALE, device=dev)[None, :, None, None]

    def prep(im):
        x = (2.0 * torch.as_tensor(im, dtype=torch.float32, device=dev) - 1.0)
        return (x.permute(2, 0, 1)[None] - shift) / scale

    total = torch.zeros((), device=dev)
    for a, b, lw in zip(_vgg_slices(params, prep(img0)), _vgg_slices(params, prep(img1)),
                        params.lin_w):
        d = (_unit_normalize(a) - _unit_normalize(b)) ** 2            # [1, C, H, W]
        total = total + torch.mean(torch.sum(d * lw[None, :, None, None], dim=1))
    return total
