"""PyTorch/CUDA port of the stereo visual SLAM system.

A second package beside `stereovision_slam_tpu` (the JAX reference, which
stays unchanged). Same layout and names, so each module has a counterpart:

  * `geometry/` - SE(3), pinhole cameras, Jacobians, Jacobi eigensolver,
    DLT triangulation;
  * `ops/` - image pyramids, GFTT and FAST corners, pyramidal LK (kernel
    A, `csrc/lk_pyramid.cu`), the fused multi-start pose solve (kernel B,
    `csrc/pose_lm.cu`), ORB descriptors, Hamming matching, the Threefry
    PRNG, dense block matching (`stereo_bm.py`) and statistical outlier
    removal (`sor.py`);
  * `models/` - the place embedders: MobileNet-V2 (`mobilenet_v2.py`,
    ONNX or torchvision weights through `onnx_reader.py`, or the seeded
    network), PlaceNet with the shipped weights, the weight-free thumbnail;
  * `slam/` - config, map state, frontend, sliding-window Schur BA, the
    fused per-frame step (`FusedVisualOdometry`, with loop closure
    `FusedLoopVisualOdometry`, and their chunked CUDA-graph modes), the
    classic host pipeline (`VisualOdometry`, `LoopClosure`), checkpoints,
    multi-stream serving and the pose graph;
  * `dense/` - offline dense reconstruction of a SLAM run's keyframes
    into a coloured point cloud;
  * `io/`, `viz/`, `utils/` - the KITTI loader, PCD and keyframes.txt
    outputs, the viewer (rerun or a JSONL transcript), trajectory metrics,
    stage timers and device traces;
  * `apps/` - the command lines (`python -m
    stereovision_slam_torch.apps.run_slam CONFIG.yaml`, `python -m
    stereovision_slam_torch.apps.run_dense_reconstruction CONFIG.yaml`)
    and the trajectory evaluation;
  * `parallel/` - the (dp, mp) rank mesh on one device, the ring all-reduce
    (kernel D, `csrc/ring_reduce.cu`), sharded BA and sharded PGO;
  * `csrc/` - hand-written CUDA C++ for Hopper (sm_90a), built with nvcc at
    first use and loaded through ctypes (see `ops/_cuda.py`).

The port imports torch, numpy and PyYAML (Pillow for KITTI PNGs). Entry
points take `device=` with the default "cuda"; pass "cpu" to run the
kernels' plain PyTorch versions.
"""

__version__ = "0.1.0"
