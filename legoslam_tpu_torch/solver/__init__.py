"""solver of the PyTorch/CUDA port (twin of legoslam_tpu/solver)."""
