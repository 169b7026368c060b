"""The weight-free thumbnail place embedder (counterpart of
`models/mobilenet_v2.embed_image_thumbnail`): a heavily blurred 8x40
thumbnail, mean-subtracted, L2-normalized and zero-padded to the 1280-d
loop database layout. The MobileNet-V2 forward itself is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stereovision_slam_torch.ops import image as imops

EMBED_DIM = 1280


def embed_image_thumbnail(img_gray: torch.Tensor) -> torch.Tensor:
    """(H, W) grayscale -> (EMBED_DIM,): a 31-tap blur (sigma 7.75) trades
    selectivity for tolerance to a few frames of panning."""
    img = imops.gaussian_blur(img_gray, 31, sigma=7.75)
    thumb = imops.resize_linear(img, (8, 40)).reshape(-1)
    thumb = thumb - torch.mean(thumb)
    thumb = thumb / torch.clamp(torch.linalg.norm(thumb), min=1e-9)
    return F.pad(thumb, (0, EMBED_DIM - thumb.shape[0]))
