"""Port parity, the MobileNet-V2 embedder: `models/mobilenet_v2.py`,
`models/onnx_reader.py`, the seeded network (`ops/prng.split`, `normal`),
and its wiring into the classic loop closure and the fused hook, against
the JAX package.

Tolerances: the split keys bit for bit; the seeded weights within 2e-5
(torch's erfinv is not XLA's polynomial: 9.4e-6 measured); the
preprocessing within 1e-5; the embedding's cosine with the reference's
above 0.999 and its largest element difference under 5e-3 (both round
activations and weights to bf16 and sum in float32 in other orders, so an
activation can round to the neighbouring bf16 value, and the flips
compound over 52 convolutions: cosine 0.99974-0.99999, differences up to
3.0e-3 measured); with the bf16 rounding taken out of both, the
embeddings agree within 1e-5 (1.0e-6 measured). ONNX and state-dict
loading bit for bit; the loop decisions (candidates, gates, loops) equal,
with the database embeddings within 5e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovision_slam_tpu.models import mobilenet_v2 as jmnv2
from stereovision_slam_tpu.models import onnx_reader as jonnx
from stereovision_slam_tpu.slam import fused_loop as jfl
from stereovision_slam_tpu.slam import loop_closure as jlc
from stereovision_slam_tpu.slam.config import SlamConfig as JConfig
from stereovision_slam_torch import convert
from stereovision_slam_torch.models import mobilenet_v2 as mnv2
from stereovision_slam_torch.models import onnx_reader
from stereovision_slam_torch.ops import prng
from stereovision_slam_torch.slam import fused_loop
from stereovision_slam_torch.slam import loop_closure as tlc
from tests import synthetic
from tests.torch_mnv2_weights import state_dict
from tests.test_loop_closure import make_entry
from tests.test_torch_loop_closure import _port_entry
from tests.test_torch_loop_hook import (  # noqa: F401  (module fixtures)
    GATES, _hold, _np, _revisit_state, reference_run, scene)

torch.set_num_threads(1)

W_TOL = 2e-5
COS_MIN = 0.999
EMB_TOL = 5e-3
F32_TOL = 1e-5


@pytest.fixture(scope="module")
def onnx_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mnv2") / "mobilenet_v2.onnx")
    onnx_reader.write_onnx_initializers(path, state_dict(0))
    return path


@pytest.fixture(scope="module")
def frames():
    """Textured forward-motion frames at the loader's 188x620."""
    rig = synthetic.make_stereo_rig()
    poses = synthetic.forward_motion_poses(4, step=0.5, yaw_rate=0.01)
    lefts, _ = synthetic.render_textured_stereo_sequence(poses, H=188, W=620,
                                                         rig=rig)
    return np.array(lefts, np.float32)


def _hold_embedding(e, je):
    cos = float(e @ je / np.linalg.norm(e) / np.linalg.norm(je))
    diff = float(np.abs(e - je).max())
    print(f"embedding cosine {cos:.7f}, largest difference {diff:.2e}")
    assert cos > COS_MIN and diff < EMB_TOL


def test_seeded_network_matches_reference():
    """`init_params(seed)` is the reference's network: the split keys bit
    for bit, the weights within W_TOL."""
    keys = np.asarray(jax.random.key_data(jax.random.split(
        jax.random.PRNGKey(3), 64))).astype(np.uint32)
    np.testing.assert_array_equal(np.array(prng.split(3, 64), np.uint32),
                                  keys)
    shape = (3, 3, 1, 96)
    np.testing.assert_array_equal(
        prng.uniform(tuple(int(k) for k in keys[7]), shape).numpy(),
        np.asarray(jax.random.uniform(jnp.asarray(keys[7]), shape)))
    jp = convert.mobilenet_params(jax.tree.map(np.asarray,
                                               jmnv2.init_params(seed=0)))
    p = mnv2.init_params(seed=0, device="cpu")
    leaves, jleaves = (jax.tree.leaves(p), jax.tree.leaves(jp))
    assert len(leaves) == len(jleaves) == 52 * 3
    for a, b in zip(leaves, jleaves):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=W_TOL)


def test_forward_matches_reference(onnx_path, frames):
    """The reference's network carried across: preprocessing, then the
    embedding of three frames."""
    jp = jmnv2.load_onnx_weights(onnx_path)
    p = convert.mobilenet_params(jax.tree.map(np.asarray, jp))
    assert p["stem"]["w"].shape == (32, 3, 3, 3)
    assert p["blocks"][1]["depthwise"]["w"].shape == (96, 1, 3, 3)
    for img in frames[:3]:
        x = mnv2.preprocess(torch.from_numpy(img))
        jx = np.asarray(jmnv2.preprocess(jnp.asarray(img)))
        np.testing.assert_allclose(x.permute(0, 2, 3, 1).numpy(), jx,
                                   rtol=0, atol=1e-5)
        _hold_embedding(mnv2.embed_image(p, torch.from_numpy(img)).numpy(),
                        np.asarray(jmnv2.embed_image(jp, jnp.asarray(img))))


def test_forward_without_bf16_matches_reference(onnx_path, frames,
                                               monkeypatch):
    """Both networks in plain float32 (the reference's convolution at
    HIGHEST precision, the port's without the bf16 rounding): what is left
    is the float32 sum order."""
    from jax import lax

    def conv32(x, w, stride=1, groups=1):
        kh, kw = w.shape[0], w.shape[1]
        return lax.conv_general_dilated(
            x, w, (stride, stride), ((kh // 2, kh // 2), (kw // 2, kw // 2)),
            feature_group_count=groups,
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=lax.Precision.HIGHEST)
    monkeypatch.setattr(jmnv2, "_conv", conv32)
    monkeypatch.setattr(mnv2, "_bf16", lambda x: x)
    jp = jmnv2.load_onnx_weights(onnx_path)
    p = convert.mobilenet_params(jax.tree.map(np.asarray, jp))
    img = frames[0]
    je = np.asarray(jmnv2.embed(jp, jmnv2.preprocess(jnp.asarray(img)))[0])
    e = mnv2.embed_image(p, torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(e, je, rtol=0, atol=F32_TOL)


def test_onnx_round_trip_and_loaders(onnx_path, tmp_path):
    sd = state_dict(0)
    back = onnx_reader.read_onnx_initializers(onnx_path)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v)
    # the reference's reader reads the port's writer's file
    jback = jonnx.read_onnx_initializers(onnx_path)
    for k, v in sd.items():
        np.testing.assert_array_equal(jback[k], v)
    a = mnv2.load_onnx_weights(onnx_path, device="cpu")
    b = mnv2.convert_param_arrays(sd, device="cpu")
    pth = str(tmp_path / "mnv2.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
    c = mnv2.get_params(pth, device="cpu")
    ref = convert.mobilenet_params(jax.tree.map(
        np.asarray, jmnv2.load_onnx_weights(onnx_path)))
    for x, y, z, r in zip(*(jax.tree.leaves(t) for t in (a, b, c, ref))):
        assert torch.equal(x, y) and torch.equal(x, z) and torch.equal(x, r)


def test_constant_folded_export_is_refused(tmp_path):
    path = str(tmp_path / "folded.onnx")
    onnx_reader.write_onnx_initializers(
        path, {"onnx::Conv_123": np.zeros((32, 3, 3, 3), np.float32)})
    with pytest.raises(ValueError, match="constant-folded"):
        mnv2.load_onnx_weights(path, device="cpu")
    with pytest.raises(ValueError, match="constant-folded"):
        mnv2.get_params(path, device="cpu")


def test_auto_picks_mobilenet_when_the_file_exists(onnx_path, tmp_path):
    name, params = tlc.resolve_embedder("auto", onnx_path, "cpu")
    assert name == "mobilenet" and "stem" in params
    name, _ = tlc.resolve_embedder("auto", str(tmp_path / "none.onnx"), "cpu")
    assert name == "placenet"
    # explicit 'mobilenet' without a file: the seeded network
    name, params = tlc.resolve_embedder("mobilenet", None, "cpu")
    assert name == "mobilenet"
    np.testing.assert_array_equal(params["head"]["w"].numpy(),
                                  mnv2.init_params(device="cpu")["head"][
                                      "w"].numpy())


def test_loop_closure_keyframes_match_reference(onnx_path, frames):
    """`LoopClosure('mobilenet')` over a few keyframes: each package embeds
    the same frames, and the candidate scans decide alike."""
    left, _ = synthetic.make_stereo_rig()
    cfg = JConfig(keyframes_to_skip_in_candidate_search=1)
    ref = jlc.LoopClosure(cfg, left, mnv2_weights_path=onnx_path)
    port = tlc.LoopClosure(convert.slam_config(cfg), convert.camera(left),
                           mnv2_weights_path=onnx_path)
    assert ref.embedder == port.embedder == "mobilenet"
    seq = list(frames) + [frames[0]]           # a revisit of frame 0
    found = []
    for k, img in enumerate(seq):
        je = np.asarray(jmnv2.embed_image(ref.params, jnp.asarray(img)))
        e = fused_loop.embed(port.params, torch.from_numpy(img)).numpy()
        _hold_embedding(e, je)
        jent, ent = make_entry(k, je), _port_entry(make_entry(k, e))
        jc, c = ref._find_candidate(jent), port._find_candidate(ent)
        assert (jc is None) == (c is None)
        if c is not None:
            assert c.kf_id == jc.kf_id
        assert abs(port.last_deep_score - ref.last_deep_score) < EMB_TOL
        found.append(None if c is None else c.kf_id)
        ref.db[k], port.db[k] = jent, ent
        ref._scan_cache_append(k, je)
        port._scan_cache_append(k, e)
    print(f"candidates {found}")


def test_fused_hook_matches_reference(reference_run, onnx_path):  # noqa: F811
    """The fused loop hook with MobileNet parameters, keyframe 0 and the
    fabricated revisit as keyframe 30, in both packages."""
    ref, cfg, rig, _ = reference_run
    jp = jmnv2.load_onnx_weights(onnx_path)
    p = mnv2.load_onnx_weights(onnx_path, device="cpu")
    fs, ms, arc = _np(ref.fs), _np(ref.ms), _np(ref.arc)
    ls = _np(jfl.empty_loop_state(64, cfg.max_features, 16))
    cam = rig[0]
    for kf_id, state in ((0, (fs, ms)), (30, None)):
        if state is None:
            state = _revisit_state(fs, ms)[:2]
        f, m = state
        a = jfl._loop_hook(
            jax.tree.map(jnp.asarray, ls), jax.tree.map(jnp.asarray, f),
            jax.tree.map(jnp.asarray, m), tuple(jnp.asarray(x) for x in f.pyr),
            jnp.int32(100 + kf_id), jnp.int32(kf_id),
            jax.tree.map(jnp.asarray, arc), cam_left=cam, mnv2_params=jp,
            **GATES)
        b = fused_loop._loop_hook(
            convert.loop_state(ls), convert.frontend_state(f),
            convert.map_state(m), tuple(convert.tensor(x) for x in f.pyr),
            100 + kf_id, kf_id, convert.archive_state(arc),
            cam_left=convert.camera(cam), place_params=p, **GATES)
        (jfs, jms, jls), (pfs, pms, pls) = tuple(_np(x) for x in a), b
        _hold(jls, pls, atol={"db_embed": EMB_TOL, "db_lm_pos": 1e-3,
                              "loop_info": 1e-3, "last_score": EMB_TOL})
        _hold(jfs, pfs)
        _hold(jms, pms, atol={"lm_pos": 1e-3})
        assert int(pls.db_valid.sum()) == (1 if kf_id == 0 else 2)
        ls, fs, ms = jls, jfs, jms
    print(f"loops {int(pls.n_loops)}, score {float(pls.last_score):.4f}")
