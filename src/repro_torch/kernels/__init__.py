"""Count-Sketch kernels: hand-written CUDA for Hopper, plain PyTorch on CPU."""
