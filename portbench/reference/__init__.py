"""The benchmark's plain reference: a frozen copy of the port's plain stage
functions (tracking, the pose, the keyframe branch, window BA), with the
imports pointed into this folder and the kernels' dispatch replaced by
their plain versions.  It imports nothing of the port, of JAX or of the
JAX package, and is handed NumPy arrays (`stages`), so a later change to
the port cannot move it.  It runs on the CPU."""
