"""Plain PyTorch ops (conv, resample, pointwise, smooth) and, under
``cuda/``, the hand-written kernels with their wrappers."""
