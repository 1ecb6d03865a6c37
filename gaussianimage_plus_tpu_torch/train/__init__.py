"""Per-image fitting: metrics, losses, the Adam/StepLR recipe and the trainer."""
