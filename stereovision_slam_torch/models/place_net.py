"""PlaceNet, the compact learned place-recognition embedder (counterpart of
`models/place_net.py`), with the reference's trained weights.

Fixed 48x160 grayscale input (7-tap blur, then an antialiased linear
resize), four stride-2 3x3/5x5 convolutions with ReLU, a pooling that keeps
1x5 horizontal cells, a linear projection to 256-d, L2 normalization, and
zero padding to the 1280-d loop database layout.

The reference runs its convolutions in bf16 with float32 accumulation.
Here each layer's input activations and weights are rounded to bf16 and
back, and the convolution runs in float32 (`F.conv2d`): a product of two
bf16 values is exact in float32, so only the order of the sums differs. It
also makes cuDNN's TF32 mode harmless, since a bf16 value is exact in TF32.
Weights are kept as OIHW (`convert.place_net_params` turns the reference's
HWIO arrays around once).
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from stereovision_slam_torch.device import resolve_device
from stereovision_slam_torch.ops import image as imops

EMBED_DIM = 1280         # loop database layout
PROJ_DIM = 256           # learned embedding width (the rest is zero)
IN_H, IN_W = 48, 160     # fixed network input
# (out_ch, kernel, stride), all conv + ReLU
CONVS = [(32, 5, 2), (64, 3, 2), (96, 3, 2), (128, 3, 2)]
POOL_W = 5               # horizontal cells kept before the projection

# The trained weights ship with the package, as a data file (a byte-identical
# copy of the JAX package's).
WEIGHTS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "weights", "place_net.npz")


def preprocess(img_gray: torch.Tensor) -> torch.Tensor:
    """(H, W) grayscale in [0, 255] -> (IN_H, IN_W), centred on 0."""
    img = imops.gaussian_blur(img_gray, 7)
    img = imops.resize_linear(img, (IN_H, IN_W))
    return img / 255.0 - 0.5


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """Zero padding of XLA's "SAME" for a k x k kernel at `stride`."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """(N, IN_H, IN_W) preprocessed inputs -> (N, PROJ_DIM) L2-normalized."""
    h = x[:, None]
    for conv, (_, k, stride) in zip(params["convs"], CONVS):
        h = F.conv2d(_same_pad(_bf16(h), k, stride), _bf16(conv["w"]),
                     stride=stride)
        h = torch.relu(h + conv["b"][None, :, None, None])
    N, C, Hc, Wc = h.shape
    if Wc % POOL_W:
        raise ValueError(f"place_net: {Wc} columns do not pool into "
                         f"{POOL_W} cells")
    # collapse y, keep POOL_W horizontal cells; the reference's (cell,
    # channel) feature order
    h = h.reshape(N, C, Hc, POOL_W, Wc // POOL_W).mean(dim=(2, 4))
    h = h.permute(0, 2, 1).reshape(N, POOL_W * C)
    v = h @ params["proj"]["w"] + params["proj"]["b"]
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-12)


def embed_image(params: dict, img_gray: torch.Tensor) -> torch.Tensor:
    """(H, W) grayscale -> (EMBED_DIM,) L2-normalized, zero-padded."""
    v = forward(params, preprocess(img_gray)[None])[0]
    return F.pad(v, (0, EMBED_DIM - PROJ_DIM))


def load_params(path: str = WEIGHTS_PATH, device="cuda") -> dict:
    """The weights of an npz file in the reference's layout, on `device`."""
    import numpy as np

    from stereovision_slam_torch import convert
    with np.load(path) as data:
        return convert.place_net_params(dict(data), resolve_device(device))


def get_params(path: str = WEIGHTS_PATH, device="cuda") -> dict | None:
    """The shipped trained weights, or None if the file is absent."""
    return load_params(path, device) if os.path.exists(path) else None
