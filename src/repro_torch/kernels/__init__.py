"""The port's kernels: the packed wire format, the hand-written CUDA
kernels with their plain PyTorch versions, and their public wrappers."""
