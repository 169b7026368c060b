"""Port parity, the loop path's ops: the port's blur, resize, PRNG,
descriptors, Hamming matching, PlaceNet and thumbnail embedders and the
single-start pose solve against the JAX package on the same numpy inputs.

Tolerances: the 5/7/31-tap blurs are the same shift-adds (bit for bit);
the antialiased resize agrees within 1e-4 on a 0-255 image (6.1e-5
measured); the PRNG and Hamming matching bit for bit; descriptors on >=
99.5% of bits (each bit compares two blurred values; the orientation's
sums may round otherwise) with `ok` exact; PlaceNet's embeddings within
1e-3 (both round activations and weights to bf16, then sum in float32 in
different orders; 1.7e-5 measured) with the strong/weak gate decisions
equal; the thumbnail within 1e-5; `solve_pose` within 1e-4 with equal
inliers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovision_slam_tpu.geometry import jacobians as jjac
from stereovision_slam_tpu.geometry import se3 as jse3
from stereovision_slam_tpu.models import mobilenet_v2 as jmnv2
from stereovision_slam_tpu.models import place_net as jplace
from stereovision_slam_tpu.ops import descriptors as jdesc
from stereovision_slam_tpu.ops import gftt as jgftt
from stereovision_slam_tpu.ops import image as jimage
from stereovision_slam_tpu.ops import matching as jmatch
from stereovision_slam_tpu.slam import pose_solver as jps
from stereovision_slam_tpu.slam.config import PLACENET_LOOP_GATES as JGATES
from stereovision_slam_torch import convert
from stereovision_slam_torch.models import mobilenet_v2 as mnv2
from stereovision_slam_torch.models import place_net
from stereovision_slam_torch.ops import descriptors, matching, prng
from stereovision_slam_torch.ops import image as imops
from stereovision_slam_torch.slam import pose_solver
from stereovision_slam_torch.slam.config import PLACENET_LOOP_GATES
from tests import synthetic

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def frames():
    """Textured forward-motion frames at the bench's 188x620."""
    rig = synthetic.make_stereo_rig()
    poses = synthetic.forward_motion_poses(4, step=0.5, yaw_rate=0.01)
    lefts, _ = synthetic.render_textured_stereo_sequence(poses, H=188, W=620,
                                                         rig=rig)
    return np.asarray(lefts)


@pytest.fixture(scope="module")
def circuit_frames():
    """The arena circuit at frames 0, 30, 56, 84 and the revisit at 112
    (same heading as frame 0), 188x620."""
    T = 112
    rig = synthetic.make_stereo_rig()
    poses = synthetic.forward_motion_poses(T + 1, step=0.35,
                                           yaw_rate=2 * np.pi / T)
    sel = jnp.asarray([0, 30, 56, 84, 112])
    lefts, _ = synthetic.render_arena_stereo_sequence(
        poses[sel], rig=rig, center=(0.0, 6.0), radius=25.0)
    return np.asarray(lefts)


@pytest.mark.parametrize("size,sigma", [(5, None), (7, None), (31, 7.75)])
def test_gaussian_blur_matches_reference(frames, size, sigma):
    img = frames[0]
    a = np.asarray(jimage.gaussian_blur(jnp.asarray(img), size, sigma=sigma))
    b = imops.gaussian_blur(torch.tensor(img), size, sigma=sigma).numpy()
    assert np.array_equal(a, b)
    assert np.array_equal(jimage.gaussian_kernel1d(size, sigma),
                          imops.gaussian_kernel1d(size, sigma))


@pytest.mark.parametrize("shape", [(48, 160), (8, 40), (94, 310)])
def test_resize_linear_matches_jax_image_resize(frames, shape):
    img = frames[1]
    a = np.asarray(jax.image.resize(jnp.asarray(img), shape, "linear"))
    b = imops.resize_linear(torch.tensor(img), shape).numpy()
    assert b.shape == shape
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-4)


@pytest.mark.parametrize("kf_id,shape", [(0, (7,)), (5, (256, 256)),
                                         (37, (128, 96)), (511, (3, 17)),
                                         (2 ** 31 + 3, (1000,))])
def test_prng_uniform_bit_equal_to_jax(kf_id, shape):
    a = np.asarray(jax.random.uniform(jax.random.PRNGKey(kf_id), shape,
                                      jnp.float32, 1e-9, 1.0))
    b = prng.uniform(kf_id, shape, 1e-9, 1.0).numpy()
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    c = np.asarray(jax.random.uniform(jax.random.PRNGKey(kf_id), shape))
    assert np.array_equal(c, prng.uniform(kf_id, shape).numpy())


def _descriptors_both(img, pts, valid):
    dj, okj = jdesc.compute(jnp.asarray(img), jnp.asarray(pts),
                            jnp.asarray(valid))
    dt, okt = descriptors.compute(torch.tensor(img), torch.tensor(pts),
                                  torch.tensor(valid))
    return np.asarray(dj), np.asarray(okj), dt, okt


def test_descriptors_and_match_match_reference(frames):
    assert np.array_equal(jdesc._make_pattern(), descriptors._make_pattern())
    out = []
    for img in (frames[0], frames[2]):
        pts, valid, _ = jgftt.detect(jnp.asarray(img), 256)
        pts, valid = np.array(pts), np.array(valid)
        valid[:3] = False                      # invalid slots stay out
        dj, okj, dt, okt = _descriptors_both(img, pts, valid)
        same = (np.unpackbits(dj.view(np.uint8))
                == np.unpackbits(dt.numpy().view(np.uint8)))
        assert same.mean() >= 0.995, same.mean()
        assert np.array_equal(okj, okt.numpy()) and int(okt.sum()) > 100
        assert np.array_equal(convert.tensor(dj).numpy(), dt.numpy())
        out.append((dj, okj, dt, okt))
    (dj0, okj0, dt0, okt0), (dj1, okj1, dt1, okt1) = out
    a = jmatch.match(jnp.asarray(dj0), jnp.asarray(okj0), jnp.asarray(dj1),
                     jnp.asarray(okj1))
    b = matching.match(dt0, okt0, dt1, okt1)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), y.numpy())
    assert int(b[2].sum()) > 20
    # distances of all pairs, bit for bit
    assert np.array_equal(
        np.asarray(jmatch.hamming_matrix(jnp.asarray(dj0), jnp.asarray(dj1))),
        matching.hamming_matrix(dt0, dt1).numpy())


def test_hamming_ties_take_the_lowest_index():
    rng = np.random.default_rng(3)
    words = rng.integers(0, 2 ** 32, (6, 8), dtype=np.uint64).astype(
        np.uint32)
    train = np.concatenate([words, words[::-1]])       # every row twice
    ok = np.ones(12, bool)
    a = jmatch.match(jnp.asarray(words), jnp.asarray(ok[:6]),
                     jnp.asarray(train), jnp.asarray(ok))
    b = matching.match(convert.tensor(words), torch.tensor(ok[:6]),
                       convert.tensor(train), torch.tensor(ok))
    assert np.array_equal(np.asarray(a[0]), b[0].numpy())
    assert b[0].tolist() == list(range(6)) and int(b[1].max()) == 0


def test_place_net_and_thumbnail_match_reference(circuit_frames):
    jp = jplace.get_params()
    tp = place_net.get_params(device="cpu")
    # the port's own copy of the reference's weights file, byte for byte
    assert place_net.WEIGHTS_PATH != jplace.WEIGHTS_PATH
    with open(place_net.WEIGHTS_PATH, "rb") as a, \
            open(jplace.WEIGHTS_PATH, "rb") as b:
        assert a.read() == b.read()
    # the reference's parameter tree converts to the same OIHW tensors
    tree = convert.place_net_params(jp)
    for a, b in zip(tree["convs"] + [tree["proj"]], tp["convs"] + [tp["proj"]]):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
    assert PLACENET_LOOP_GATES == JGATES
    ej, et = [], []
    for img in circuit_frames:
        a = np.asarray(jplace.embed_image(jp, jnp.asarray(img)))
        b = place_net.embed_image(tp, torch.tensor(img)).numpy()
        assert b.shape == (place_net.EMBED_DIM,)
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-3)
        ej.append(a)
        et.append(b)
        c = np.asarray(jmnv2.embed_image_thumbnail(jnp.asarray(img)))
        d = mnv2.embed_image_thumbnail(torch.tensor(img)).numpy()
        np.testing.assert_allclose(d, c, rtol=0, atol=1e-5)
    sj, st = np.stack(ej) @ np.stack(ej).T, np.stack(et) @ np.stack(et).T
    strong = PLACENET_LOOP_GATES["potential_loop_strong_threshold"]
    weak = PLACENET_LOOP_GATES["potential_loop_weak_threshold"]
    assert np.array_equal(sj >= strong, st >= strong)
    assert np.array_equal(sj > weak, st > weak)
    assert st[0, 4] >= strong            # the revisit fires the strong gate
    assert (st[0, 1:4] < strong).all()


def test_solve_pose_matches_reference():
    rng = np.random.default_rng(0)
    left, _ = synthetic.make_stereo_rig()
    N = 150
    pts = np.stack([rng.uniform(-8, 8, N), rng.uniform(-3, 3, N),
                    rng.uniform(6, 40, N)], 1).astype(np.float32)
    T = jse3.se3_exp(jnp.array([0.3, -0.1, 0.5, 0.02, -0.03, 0.01]))
    uv = np.asarray(jjac.project_points(left, T, jnp.asarray(pts))[0])
    uv = (uv + rng.normal(0, 0.5, (N, 2))).astype(np.float32)
    uv[:12] += 40.0
    valid = rng.uniform(size=N) > 0.1
    T0 = np.asarray(jse3.se3_compose(
        jse3.se3_exp(jnp.array([0.05, 0.02, -0.1, 0.01, 0.01, -0.01])), T))
    for rounds in (2, 4):
        kw = dict(chi2_th=5.991 ** 2, rounds=rounds, iters=10)
        a = jps.solve_pose(left, jnp.asarray(T0), jnp.asarray(pts),
                           jnp.asarray(uv), jnp.asarray(valid), **kw)
        b = pose_solver.solve_pose(convert.camera(left), torch.tensor(T0),
                                   torch.tensor(pts), torch.tensor(uv),
                                   torch.tensor(valid), **kw)
        np.testing.assert_allclose(b[0].numpy(), np.asarray(a[0]), rtol=0,
                                   atol=1e-4)
        assert np.array_equal(b[1].numpy(), np.asarray(a[1]))
        assert int(b[2]) == int(a[2]) and not bool(b[1][:12].any())
