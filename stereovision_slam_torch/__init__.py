"""PyTorch/CUDA port of the stereo visual SLAM system.

A second package beside `stereovision_slam_tpu` (the JAX reference, which
stays unchanged). Same layout and names, so each module has a counterpart:

  * `geometry/` - SE(3), pinhole cameras, Jacobians, Jacobi eigensolver,
    DLT triangulation;
  * `ops/` - image pyramids, GFTT, pyramidal LK (kernel A, `csrc/lk_level.cu`)
    and the fused multi-start pose solve (kernel B, `csrc/pose_lm.cu`);
  * `slam/` - config, map state, frontend, sliding-window Schur BA, the
    fused per-frame step (`FusedVisualOdometry`), multi-stream serving and
    the pose graph;
  * `parallel/` - the (dp, mp) rank mesh on one device, the ring all-reduce
    (kernel D, `csrc/ring_reduce.cu`), sharded BA and sharded PGO;
  * `csrc/` - hand-written CUDA C++ for Hopper (sm_90a), built with nvcc at
    first use and loaded through ctypes (see `ops/_cuda.py`).

The port imports torch and numpy only. Entry points take `device=` with the
default "cuda"; pass "cpu" to run the kernels' plain PyTorch versions.
"""

__version__ = "0.1.0"
