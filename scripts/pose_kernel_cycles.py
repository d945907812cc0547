"""Where the pose kernel's time goes, on one GPU: clock64 around its phases.

    python3 scripts/pose_kernel_cycles.py

Builds an instrumented copy of legoslam_tpu_torch/csrc/pose.cu (clock64
reads around each phase of a pass, summed by atomics into a device array)
and runs it on chip_smoke.py's pose inputs (512 edges, 10% gross
outliers), then prints cycles per pass: the per-edge terms (phase A,
worker 0's own work and with its wait at the barrier), the sums' chains (b's,
H's lane 0, chi's, and worker 0 up to the barrier after them), warp 0's wait
for the sums and a worker's wait for the next pose (warp 0's serial LM step
that the speculative chain does not hide).  The counts are per SM cycle and
include the instrumentation's own atomics; the kernel's output is not
checked here (chip_smoke.py does that).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from legoslam_tpu_torch.kernels import _build  # noqa: E402
from legoslam_tpu_torch.kernels import pose as pose_k  # noqa: E402

NAMES = ["phase A with its barrier wait (worker 0)", "chains with their barrier (worker 0)", "b chain",
         "H chain (lane 0, entry 0)", "chi chain", "warp 0 waiting for the sums", "a worker waiting for the pose",
         "phase A, own work (worker 0)"]


def instrumented_source() -> str:
    src = (_build.CSRC / "pose.cu").read_text()

    def rep(a, b):
        nonlocal src
        if a not in src:
            raise ValueError(f"pose.cu changed; cannot instrument at: {a[:60]!r}")
        src = src.replace(a, b)

    rep("namespace {\n", "__device__ unsigned long long g_prof[8];\nnamespace {\n")
    rep('''    chunk_terms(wt, c0, n, T, ed, use_mask, k, robust, delta, cjw, cJ, cbt, cm);
    bar_sync_workers();
    acc = chunk_chain(wt, n, cjw, cJ, cbt, cm, acc);
    bar_sync_workers();  // the chunk's terms are read''', '''    long long t0 = clock64();
    chunk_terms(wt, c0, n, T, ed, use_mask, k, robust, delta, cjw, cJ, cbt, cm);
    long long t1 = clock64();
    bar_sync_workers();
    long long t2 = clock64();
    acc = chunk_chain(wt, n, cjw, cJ, cbt, cm, acc);
    long long t3 = clock64();
    bar_sync_workers();  // the chunk's terms are read
    long long t4 = clock64();
    if (wt == 0) {
      atomicAdd(&g_prof[0], (unsigned long long)(t2 - t0));
      atomicAdd(&g_prof[1], (unsigned long long)(t4 - t2));
      atomicAdd(&g_prof[3], (unsigned long long)(t3 - t2));
      atomicAdd(&g_prof[7], (unsigned long long)(t1 - t0));
    }
    if (wt == kBWorker) atomicAdd(&g_prof[2], (unsigned long long)(t3 - t2));
    if (wt == kChiWorker) atomicAdd(&g_prof[4], (unsigned long long)(t3 - t2));''')
    rep('''        bar_sync(kSumsReady);
        gather_sums(s_tot, tot);
        ++attempts;''', '''        long long w0 = clock64();
        bar_sync(kSumsReady);
        if (threadIdx.x == 0) atomicAdd(&g_prof[5], (unsigned long long)(clock64() - w0));
        gather_sums(s_tot, tot);
        ++attempts;''')
    rep('''      bar_arrive(kSumsReady);
      bar_sync(kPoseReady);''', '''      bar_arrive(kSumsReady);
      long long w1 = clock64();
      bar_sync(kPoseReady);
      if (threadIdx.x == 32) atomicAdd(&g_prof[6], (unsigned long long)(clock64() - w1));''')
    return src + '''
extern "C" int legoslam_pose_prof(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[8] = {0};
    return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, g_prof, 8 * sizeof(unsigned long long));
}
'''


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("pose_kernel_cycles: no CUDA device")
    tmp = tempfile.mkdtemp(prefix="pose_cycles_")
    cu, so = os.path.join(tmp, "pose_prof.cu"), os.path.join(tmp, "pose_prof.so")
    with open(cu, "w") as f:
        f.write(instrumented_source())
    proc = subprocess.run([_build._nvcc(), *_build._flags("pose"), "-o", so, cu], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr[-3000:])
    lib = ctypes.CDLL(so)
    _build._loaded["pose"] = lib  # the wrapper now launches the instrumented kernel
    dev = torch.device("cuda:0")
    intr, T_prior, P, uv, valid, _ = chip_smoke.pose_inputs(dev)
    attempts = torch.zeros(4, dtype=torch.int32, device=dev)
    pose_k.estimate_pose_kernel(intr, T_prior, P, uv, valid, attempts=attempts)  # warm up
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 8)()
    lib.legoslam_pose_prof(buf, 1)
    pose_k.estimate_pose_kernel(intr, T_prior, P, uv, valid)
    torch.cuda.synchronize()
    lib.legoslam_pose_prof(buf, 0)
    passes = int(attempts.sum()) + len(attempts)  # each attempt, and each round's first pass
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"pose kernel: {int(valid.shape[0])} edges, LM attempts per round {attempts.tolist()}, {passes} passes on "
          f"{smi}")
    for name, v in zip(NAMES, buf):
        print(f"  {name:42s} {v / passes:9.0f} cycles per pass")


if __name__ == "__main__":
    main()
