"""Minimal PCD (Point Cloud Data) reader/writer (the port's own copy of
`io/pcd.py`, numpy only).

Replaces the reference's PCL dependency for its two outputs: ASCII
`landmarks.pcd` (visual_odometry.cpp:226-246) and binary colored clouds from
dense reconstruction (dense_reconstruction.cpp:212-237). Interop format —
files open in pcl_viewer / Open3D.
"""

from __future__ import annotations

import numpy as np


def _header(n: int, fields, ascii_mode: bool) -> str:
    names = " ".join(f[0] for f in fields)
    sizes = " ".join(str(f[1]) for f in fields)
    types = " ".join(f[2] for f in fields)
    counts = " ".join("1" for _ in fields)
    return (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {names}\n"
        f"SIZE {sizes}\n"
        f"TYPE {types}\n"
        f"COUNT {counts}\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {'ascii' if ascii_mode else 'binary'}\n"
    )


def write_pcd_xyz(path: str, points: np.ndarray, ascii_mode: bool = True) -> None:
    """Write an (N, 3) float cloud (pcl::PointXYZ layout)."""
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    fields = [("x", 4, "F"), ("y", 4, "F"), ("z", 4, "F")]
    header = _header(len(pts), fields, ascii_mode)
    if ascii_mode:
        with open(path, "w") as f:
            f.write(header)
            for p in pts:
                f.write(f"{p[0]:.8g} {p[1]:.8g} {p[2]:.8g}\n")
    else:
        with open(path, "wb") as f:
            f.write(header.encode())
            f.write(pts.tobytes())


def write_pcd_xyzrgb(path: str, points: np.ndarray, colors: np.ndarray,
                     ascii_mode: bool = False) -> None:
    """Write an (N, 3) cloud with (N, 3) uint8 RGB (pcl::PointXYZRGB layout:
    rgb packed into a float)."""
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    cols = np.asarray(colors, dtype=np.uint8).reshape(-1, 3)
    rgb_int = (cols[:, 0].astype(np.uint32) << 16 \
               | cols[:, 1].astype(np.uint32) << 8 \
               | cols[:, 2].astype(np.uint32))
    rgb_f = rgb_int.view(np.float32)
    fields = [("x", 4, "F"), ("y", 4, "F"), ("z", 4, "F"), ("rgb", 4, "F")]
    header = _header(len(pts), fields, ascii_mode)
    if ascii_mode:
        with open(path, "w") as f:
            f.write(header)
            for p, r in zip(pts, rgb_f):
                f.write(f"{p[0]:.8g} {p[1]:.8g} {p[2]:.8g} {r:.9g}\n")
    else:
        data = np.concatenate([pts, rgb_f[:, None]], axis=1).astype(np.float32)
        with open(path, "wb") as f:
            f.write(header.encode())
            f.write(data.tobytes())


def read_pcd(path: str):
    """Read xyz[rgb] PCD (ascii or binary). Returns (points, colors|None)."""
    with open(path, "rb") as f:
        raw = f.read()
    head_end = raw.find(b"DATA")
    nl = raw.find(b"\n", head_end)
    header = raw[: nl + 1].decode()
    body = raw[nl + 1:]
    fields, n, mode = [], 0, "ascii"
    for line in header.splitlines():
        if line.startswith("FIELDS"):
            fields = line.split()[1:]
        elif line.startswith("POINTS"):
            n = int(line.split()[1])
        elif line.startswith("DATA"):
            mode = line.split()[1]
    ncol = len(fields)
    if mode == "ascii":
        data = np.array(body.decode().split(), dtype=np.float32).reshape(n, ncol)
    else:
        data = np.frombuffer(body, dtype=np.float32, count=n * ncol).reshape(n, ncol)
    pts = data[:, :3]
    colors = None
    if "rgb" in fields:
        rgb_int = data[:, fields.index("rgb")].view(np.uint32)
        colors = np.stack([(rgb_int >> 16) & 0xFF, (rgb_int >> 8) & 0xFF,
                           rgb_int & 0xFF], axis=1).astype(np.uint8)
    return pts, colors
