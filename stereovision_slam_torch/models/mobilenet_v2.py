"""MobileNet-V2 place-recognition embedder (counterpart of
`models/mobilenet_v2.py`), and the weight-free thumbnail embedder.

The torchvision MobileNet-V2 up to the global average pool: the 1280-d
embedding of the reference's cv::dnn inference, L2-normalized. Plain
functions on NCHW tensors over a parameter tree {"stem", "blocks",
"head"}, each convolution {"w": OIHW float32, "bn": {"scale", "bias"}}
with batch norm folded in. The reference computes its convolutions in bf16
with float32 accumulation; here each convolution's input and weights are
rounded to bf16 and the convolution runs in float32 (`F.conv2d`, padding
k // 2 on both sides, the torch convention the reference insists on): a
product of two bf16 values is exact in float32 (and in TF32, so cuDNN's
TF32 mode changes nothing), and only the order of the sums differs.

Preprocessing as the reference's: a 7-tap Gaussian blur (OpenCV's small
table), an antialiased linear resize to 224x224, the grey image as three
channels with OpenCV's blobFromImage quirk (x - mean) / 255 per channel.

Weights: `load_onnx_weights` (the reference's ONNX artifact, through the
built-in protobuf reader), `load_torchvision_weights` (a torchvision
state_dict), or `init_params(seed)`, the JAX package's seeded network
(its Threefry split and normal draws, `ops/prng.py`).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from stereovision_slam_torch.device import resolve_device
from stereovision_slam_torch.ops import image as imops
from stereovision_slam_torch.ops import prng

# torchvision inverted-residual config: (expand_ratio, channels, repeats,
# stride)
_IR_CONFIG = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]
EMBED_DIM = 1280
IN_SIZE = 224
_MEAN = (0.485, 0.456, 0.406)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
          groups: int = 1) -> torch.Tensor:
    """NCHW convolution with OIHW weights, bf16 operands, float32 sums."""
    return F.conv2d(_bf16(x), _bf16(w), stride=stride,
                    padding=w.shape[-1] // 2, groups=groups)


def _bn(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Inference batch norm (folded at load time)."""
    return x * p["scale"][None, :, None, None] + p["bias"][None, :, None, None]


def _conv_bn_relu6(x, p, stride=1, groups=1):
    return torch.clamp(_bn(_conv(x, p["w"], stride, groups), p["bn"]),
                       0.0, 6.0)


def _inverted_residual(x, p, stride, expand):
    h = x
    if expand != 1:
        h = _conv_bn_relu6(h, p["expand"])
    h = _conv_bn_relu6(h, p["depthwise"], stride=stride, groups=h.shape[1])
    h = _bn(_conv(h, p["project"]["w"]), p["project"]["bn"])
    if stride == 1 and x.shape[1] == h.shape[1]:
        h = h + x
    return h


def forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """(N, 3, H, W) preprocessed input -> (N, 1280) embedding (pre-norm)."""
    h = _conv_bn_relu6(x, params["stem"], stride=2)
    i = 0
    for expand, _, repeats, stride in _IR_CONFIG:
        for r in range(repeats):
            h = _inverted_residual(h, params["blocks"][i],
                                   stride if r == 0 else 1, expand)
            i += 1
    h = _conv_bn_relu6(h, params["head"])
    return h.mean(dim=(2, 3))            # global average pool


def embed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """L2-normalized embedding of (N, 3, H, W) inputs."""
    v = forward(params, x)
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-12)


def preprocess(img_gray: torch.Tensor) -> torch.Tensor:
    """(H, W) grayscale in [0, 255] -> (1, 3, 224, 224)."""
    img = imops.gaussian_blur(img_gray, 7)
    img = imops.resize_linear(img, (IN_SIZE, IN_SIZE))
    rgb = torch.stack([img - m for m in _MEAN])
    return (rgb / torch.full((), 255.0, dtype=rgb.dtype,
                             device=rgb.device))[None]


def embed_image(params: dict, img_gray: torch.Tensor) -> torch.Tensor:
    """(H, W) grayscale -> (1280,) L2-normalized embedding."""
    return embed(params, preprocess(img_gray))[0]


def embed_image_thumbnail(img_gray: torch.Tensor) -> torch.Tensor:
    """Weight-free place embedding, (H, W) grayscale -> (EMBED_DIM,): a
    31-tap blur (sigma 7.75) trades selectivity for tolerance to a few
    frames of panning, an 8x40 thumbnail, mean-subtracted, L2-normalized
    and zero-padded to the 1280-d loop database layout."""
    img = imops.gaussian_blur(img_gray, 31, sigma=7.75)
    thumb = imops.resize_linear(img, (8, 40)).reshape(-1)
    thumb = thumb - torch.mean(thumb)
    thumb = thumb / torch.clamp(torch.linalg.norm(thumb), min=1e-9)
    return F.pad(thumb, (0, EMBED_DIM - thumb.shape[0]))


# --------------------------------------------------------------------- #
# parameters

def _layers():
    """(name path, kh, kw, cin, cout, groups) of every convolution, in the
    reference's construction order."""
    out = [(("stem",), 3, 3, 3, 32, 1)]
    cin, i = 32, 0
    for expand, cout, repeats, _ in _IR_CONFIG:
        for _ in range(repeats):
            hidden = cin * expand
            if expand != 1:
                out.append((("blocks", i, "expand"), 1, 1, cin, hidden, 1))
            out.append((("blocks", i, "depthwise"), 3, 3, hidden, hidden,
                        hidden))
            out.append((("blocks", i, "project"), 1, 1, hidden, cout, 1))
            cin, i = cout, i + 1
    out.append((("head",), 1, 1, cin, EMBED_DIM, 1))
    return out


def _put(tree: dict, path, leaf) -> None:
    if path[0] == "blocks":
        blocks = tree.setdefault("blocks", [])
        while len(blocks) <= path[1]:
            blocks.append({})
        blocks[path[1]][path[2]] = leaf
    else:
        tree[path[0]] = leaf


def init_params(key=None, seed: int = 0, device="cuda") -> dict:
    """Deterministic random parameters: the JAX package's `init_params`
    for the same seed (or key word pair). He-normal HWIO draws from the
    split keys in construction order, turned to OIHW; unit batch norm."""
    dev = resolve_device(device)
    keys = iter(prng.split(seed if key is None else key, 64))
    params: dict = {}
    for path, kh, kw, cin, cout, groups in _layers():
        fan_in = kh * kw * cin // groups
        w = prng.normal(next(keys), (kh, kw, cin // groups, cout)) * float(
            np.float32(np.sqrt(2.0 / max(fan_in, 1))))
        _put(params, path, {
            "w": w.permute(3, 2, 0, 1).contiguous().to(dev),
            "bn": {"scale": torch.ones(cout, device=dev),
                   "bias": torch.zeros(cout, device=dev)}})
    return params


def convert_param_arrays(sd: dict, device="cuda") -> dict:
    """Torchvision-named arrays (state_dict layout, OIHW) -> the parameter
    tree, batch norm folded into scale and bias in float32 numpy."""
    dev = resolve_device(device)

    def to_np(t):
        return np.asarray(t, dtype=np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def fold_bn(prefix):
        g = to_np(sd[f"{prefix}.weight"])
        b = to_np(sd[f"{prefix}.bias"])
        mean = to_np(sd[f"{prefix}.running_mean"])
        var = to_np(sd[f"{prefix}.running_var"])
        scale = g / np.sqrt(var + 1e-5)
        return {"scale": t(scale), "bias": t(b - mean * scale)}

    def conv(w_prefix, bn_prefix):
        return {"w": t(to_np(sd[f"{w_prefix}.weight"])),
                "bn": fold_bn(bn_prefix)}

    params = {"stem": conv("features.0.0", "features.0.1")}
    blocks = []
    idx = 1
    for expand, _, repeats, _ in _IR_CONFIG:
        for _ in range(repeats):
            base = f"features.{idx}.conv"
            b = {}
            if expand != 1:
                b["expand"] = conv(f"{base}.0.0", f"{base}.0.1")
                dw, pw, pbn = f"{base}.1", f"{base}.2", f"{base}.3"
            else:
                dw, pw, pbn = f"{base}.0", f"{base}.1", f"{base}.2"
            b["depthwise"] = conv(f"{dw}.0", f"{dw}.1")
            b["project"] = conv(pw, pbn)
            blocks.append(b)
            idx += 1
    params["blocks"] = blocks
    params["head"] = conv("features.18.0", "features.18.1")
    return params


def load_torchvision_weights(path: str, device="cuda") -> dict:
    """A torchvision mobilenet_v2 state_dict (.pth) as the parameter
    tree."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return convert_param_arrays(
        {k: v.detach().cpu().numpy() for k, v in sd.items()}, device)


def load_onnx_weights(path: str, device="cuda") -> dict:
    """The reference's ONNX artifact (an export that keeps torchvision's
    parameter names, without constant folding) as the parameter tree;
    raises otherwise."""
    from stereovision_slam_torch.models.onnx_reader import (
        read_onnx_initializers)

    arrays = {k: np.asarray(v, np.float32)
              for k, v in read_onnx_initializers(path).items()}
    if "features.0.0.weight" not in arrays:
        sample = ", ".join(list(arrays)[:5])
        raise ValueError(
            f"{path}: initializer names do not match torchvision parameter "
            f"names (got e.g. {sample}); the export was likely constant-"
            "folded. Re-export without folding, or convert the original "
            ".pth with load_torchvision_weights.")
    return convert_param_arrays(arrays, device)


def get_params(weights_path: str | None = None, seed: int = 0,
               device="cuda") -> dict:
    """The weights of `weights_path` if it exists (.onnx through the
    built-in reader, anything else as a torch state_dict), else the seeded
    random network."""
    if weights_path and os.path.exists(weights_path):
        if weights_path.endswith(".onnx"):
            return load_onnx_weights(weights_path, device)
        return load_torchvision_weights(weights_path, device)
    return init_params(seed=seed, device=device)
