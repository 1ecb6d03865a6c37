"""The port's command-line entry points, after the JAX package's
``scripts/train.py``, ``scripts/train_quantize.py`` and
``scripts/eval_kodak.py``; run each as ``python -m
gaussianimage_plus_tpu_torch.scripts.<name>``."""
