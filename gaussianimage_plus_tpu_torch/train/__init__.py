"""Per-image fitting: metrics, losses, the Adam/StepLR recipe and the trainer;
the same public names as the JAX ``train/__init__.py``."""

from .losses import loss_fn, ms_ssim, ssim
from .lpips import lpips
from .metrics import clamped_psnr, mse, psnr
from .optim import adan, make_adam, step_lr
from .trainer import (
    FitResult,
    TrainConfig,
    TrainState,
    evaluate,
    fit_image,
    init_train_state,
    restore_best,
    train_chunk,
)
