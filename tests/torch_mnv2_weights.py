"""A seeded MobileNet-V2 state dict in torchvision's layout: no pretrained
weights file is at hand, so the ONNX loader, the loop path and
`chip_smoke.py` phase 17 take this network."""

from __future__ import annotations


def state_dict(seed: int = 0) -> dict:
    """A seeded MobileNet-V2 state dict with torchvision's names and
    shapes, as float32 numpy: He-normal convolutions, batch norm with
    scale 0.5-1.5, bias and mean +-0.1, variance 0.5-1.5 (`chip_smoke.py`
    phase 17 and the MobileNet tests write it as an ONNX file)."""
    import numpy as np
    from stereovision_slam_torch.models import mobilenet_v2 as mnv2

    rng = np.random.default_rng(seed)
    sd = {}

    def conv_bn(conv, bn, cin, cout, k, groups=1):
        fan_in = k * k * cin // groups
        sd[f"{conv}.weight"] = (rng.standard_normal(
            (cout, cin // groups, k, k)) * np.sqrt(2.0 / fan_in)).astype(
            np.float32)
        sd[f"{bn}.weight"] = rng.uniform(0.5, 1.5, cout).astype(np.float32)
        sd[f"{bn}.bias"] = rng.uniform(-0.1, 0.1, cout).astype(np.float32)
        sd[f"{bn}.running_mean"] = rng.uniform(-0.1, 0.1, cout).astype(
            np.float32)
        sd[f"{bn}.running_var"] = rng.uniform(0.5, 1.5, cout).astype(
            np.float32)

    conv_bn("features.0.0", "features.0.1", 3, 32, 3)
    cin, idx = 32, 1
    for expand, cout, repeats, _ in mnv2._IR_CONFIG:
        for _ in range(repeats):
            base, hidden = f"features.{idx}.conv", cin * expand
            if expand != 1:
                conv_bn(f"{base}.0.0", f"{base}.0.1", cin, hidden, 1)
                dw, pw, pbn = f"{base}.1", f"{base}.2", f"{base}.3"
            else:
                dw, pw, pbn = f"{base}.0", f"{base}.1", f"{base}.2"
            conv_bn(f"{dw}.0", f"{dw}.1", hidden, hidden, 3, groups=hidden)
            conv_bn(pw, pbn, hidden, cout, 1)
            cin, idx = cout, idx + 1
    conv_bn("features.18.0", "features.18.1", cin, mnv2.EMBED_DIM, 1)
    return sd
