"""PyTorch/CUDA port of open_duck_playground_tpu (see README.md)."""
