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
Training passes `compute_dtype=torch.float32`, which skips the rounding, so
gradients flow as through the reference's float32 training forward.
Weights are kept as OIHW (`convert.place_net_params` turns the reference's
HWIO arrays around once); `init_params` draws the reference's seeded
network and `save_params` writes the reference's npz layout
(`apps/train_place_net.py` trains the weights).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from stereovision_slam_torch.device import resolve_device
from stereovision_slam_torch.ops import image as imops
from stereovision_slam_torch.ops import prng

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


def forward(params: dict, x: torch.Tensor,
            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """(N, IN_H, IN_W) preprocessed inputs -> (N, PROJ_DIM) L2-normalized.
    `compute_dtype=torch.float32` skips the bf16 rounding of activations
    and weights (training)."""
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"place_net: compute_dtype {compute_dtype}")
    rnd = _bf16 if compute_dtype == torch.bfloat16 else (lambda t: t)
    h = x[:, None]
    for conv, (_, k, stride) in zip(params["convs"], CONVS):
        h = F.conv2d(_same_pad(rnd(h), k, stride), rnd(conv["w"]),
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


def init_params(key=None, seed: int = 0, device="cuda") -> dict:
    """The reference's seeded network for the same seed (or key word
    pair): He-normal HWIO convolutions and a projection scaled by
    sqrt(1 / features), each from the next of 16 split keys in order, zero
    biases; convolutions turned to OIHW."""
    dev = resolve_device(device)
    keys = iter(prng.split(seed if key is None else key, 16))

    def draw(shape, scale):
        w = prng.normal(next(keys), shape) * float(np.float32(scale))
        return w.to(dev)

    convs, cin = [], 1
    for cout, k, _ in CONVS:
        w = draw((k, k, cin, cout), np.sqrt(2.0 / (k * k * cin)))
        convs.append({"w": w.permute(3, 2, 0, 1).contiguous(),
                      "b": torch.zeros(cout, device=dev)})
        cin = cout
    feat = POOL_W * cin
    return {"convs": convs,
            "proj": {"w": draw((feat, PROJ_DIM), np.sqrt(1.0 / feat)),
                     "b": torch.zeros(PROJ_DIM, device=dev)}}


def save_params(params: dict, path: str) -> None:
    """Writes `params` as the reference's npz (conv{i}_w HWIO, conv{i}_b,
    proj_w, proj_b, float32, compressed), which either package loads."""
    def arr(t):
        return t.detach().to(torch.float32).cpu().numpy()

    flat = {}
    for i, c in enumerate(params["convs"]):
        flat[f"conv{i}_w"] = arr(c["w"].permute(2, 3, 1, 0))
        flat[f"conv{i}_b"] = arr(c["b"])
    flat["proj_w"] = arr(params["proj"]["w"])
    flat["proj_b"] = arr(params["proj"]["b"])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **flat)


def load_params(path: str = WEIGHTS_PATH, device="cuda") -> dict:
    """The weights of an npz file in the reference's layout, on `device`."""
    from stereovision_slam_torch import convert
    with np.load(path) as data:
        return convert.place_net_params(dict(data), resolve_device(device))


def get_params(path: str = WEIGHTS_PATH, device="cuda") -> dict | None:
    """The shipped trained weights, or None if the file is absent."""
    return load_params(path, device) if os.path.exists(path) else None
