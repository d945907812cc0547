"""Hand-written CUDA kernels for Hopper and their PyTorch bindings.

- `klt`: csrc/klt_anchored.cu, the anchored pyramid KLT with its ZNCC gate
  (replaces the reference's two Pallas KLT level kernels).
- `pose`: csrc/pose.cu, the whole motion-only pose estimate (replaces the
  reference's Pallas pose kernel).
- `stereo`: csrc/stereo.cu, scanline stereo for every keypoint in one
  launch (the reference's is XLA code; its plain version is ~950 launches).

Each module keeps the kernel's plain PyTorch version beside its wrapper, and
each wrapper counts its launches in a `launches` attribute.  Kernels build on
first use (`_build`); importing this package needs no CUDA.
"""
