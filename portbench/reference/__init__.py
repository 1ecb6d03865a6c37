"""Plain reference of the port's benchmark: numpy and plain PyTorch only; it imports nothing of the program."""
