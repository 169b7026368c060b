"""Port parity, PlaceNet's training side: `models/place_net.py`'s
`init_params`, `save_params` and `forward(compute_dtype=)`, and the
training tool `apps/train_place_net.py` against
`benchmarks/train_place_net.py`.

Tolerances: `init_params` draws the split keys and the uniforms under each
normal bit for bit, but the normals go through torch's erfinv, not XLA's
polynomial, so weights agree within 1e-5 relative (measured 5.8e-6). The
npz files are exchanged exactly. The float32 forward agrees within 1e-5
(measured 8.9e-8); the default forward (bf16 rounding) is bit for bit
what it was. The InfoNCE loss and every gradient on a fixed batch of 8
pairs are held to `jax.value_and_grad` of the reference's formula
(restated here from benchmarks/train_place_net.py:217-253 with optax's
cross-entropy) at 1e-4 relative, a gradient relative to its largest
element; Adam under the cosine schedule to optax's within 1e-6 over three
steps.
"""

import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from benchmarks import train_place_net as jtrain
from stereovision_slam_tpu.models import place_net as jpn
from stereovision_slam_torch import convert
from stereovision_slam_torch.apps import train_place_net as tp
from stereovision_slam_torch.models import place_net
from stereovision_slam_torch.ops import prng

torch.set_num_threads(1)

B = 8


def _port(jparams) -> dict:
    return convert.place_net_params(jax.tree.map(np.asarray, jparams))


def _leaves_hwio(params: dict) -> list:
    """The port's leaves in the reference's tree order and layout."""
    out = []
    for c in params["convs"]:
        out += [c["b"], c["w"].permute(2, 3, 1, 0)]
    return out + [params["proj"]["b"], params["proj"]["w"]]


@pytest.mark.parametrize("seed", [0, 1, 3])
def test_init_params_matches_reference(seed):
    keys = np.asarray(jax.random.key_data(jax.random.split(
        jax.random.PRNGKey(seed), 16))).astype(np.uint32)
    np.testing.assert_array_equal(np.array(prng.split(seed, 16), np.uint32),
                                  keys)
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    np.testing.assert_array_equal(
        prng.uniform(tuple(int(k) for k in keys[0]), (5, 5, 1, 32), lo,
                     1.0).numpy(),
        np.asarray(jax.random.uniform(jnp.asarray(keys[0]), (5, 5, 1, 32),
                                      minval=lo, maxval=1.0)))
    ref = _port(jpn.init_params(seed=seed))
    p = place_net.init_params(seed=seed, device="cpu")
    leaves, jleaves = jax.tree.leaves(p), jax.tree.leaves(ref)
    assert len(leaves) == len(jleaves) == 10
    for a, b in zip(leaves, jleaves):
        assert a.shape == b.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7)
    assert all(not c["b"].any() for c in p["convs"])
    assert not p["proj"]["b"].any()
    key = place_net.init_params(key=tuple(int(k) for k in keys[2]),
                                device="cpu")
    ref = _port(jpn.init_params(key=jnp.asarray(keys[2])))
    np.testing.assert_allclose(key["proj"]["w"].numpy(),
                               ref["proj"]["w"].numpy(), rtol=1e-5, atol=1e-7)


def test_npz_files_cross_over_exactly(tmp_path):
    """The port's file read by the reference and the reference's by the
    port, bit for bit, with the reference's key names."""
    p = place_net.init_params(seed=1, device="cpu")
    ours = str(tmp_path / "sub" / "port.npz")
    place_net.save_params(p, ours)
    jp = jpn.load_params(ours)
    for a, b in zip(_leaves_hwio(p), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    theirs = str(tmp_path / "ref.npz")
    jpn.save_params(jpn.init_params(seed=3), theirs)
    with np.load(theirs) as a, np.load(ours) as b:
        assert sorted(a.files) == sorted(b.files)
    back = place_net.load_params(theirs, device="cpu")
    for a, b in zip(jax.tree.leaves(back),
                    jax.tree.leaves(_port(jpn.init_params(seed=3)))):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.5, 0.5, (2 * B, place_net.IN_H, place_net.IN_W))
    meta = np.zeros((B, 2, 4), np.float32)
    meta[:, 0, :2] = rng.uniform(-10, 10, (B, 2))
    meta[:, 1, :2] = meta[:, 0, :2] + rng.normal(0, 0.4, (B, 2))
    meta[:, :, 2] = rng.uniform(0, 2 * np.pi, (B, 1))
    meta[:, :, 3] = np.array([0, 0, 0, 1, 1, 2, 2, 2])[:, None]
    meta[1, :, :3] = meta[0, :, :3] + [1.0, 0.5, 0.1]   # a false negative
    return (x.astype(np.float32), meta,
            rng.uniform(0.75, 1.3, (2 * B, 1, 1)).astype(np.float32),
            rng.uniform(-0.1, 0.1, (2 * B, 1, 1)).astype(np.float32),
            (rng.normal(0, 1, x.shape) * 0.015).astype(np.float32))


def test_forward_float32_matches_reference(batch):
    x = batch[0]
    jparams = jpn.init_params(seed=1)
    jv = np.asarray(jpn.forward(jparams, jnp.asarray(x),
                                compute_dtype=jnp.float32))
    v = place_net.forward(_port(jparams), torch.from_numpy(x),
                          compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(v, jv, atol=1e-5)
    with pytest.raises(ValueError):
        place_net.forward(_port(jparams), torch.from_numpy(x),
                          compute_dtype=torch.float16)


def _forward_before(params, x):
    """The default forward as it stood before `compute_dtype` (a copy)."""
    def bf16(t):
        return t.to(torch.bfloat16).to(torch.float32)

    h = x[:, None]
    for conv, (_, k, stride) in zip(params["convs"], place_net.CONVS):
        h = F.conv2d(place_net._same_pad(bf16(h), k, stride), bf16(conv["w"]),
                     stride=stride)
        h = torch.relu(h + conv["b"][None, :, None, None])
    N, C, Hc, Wc = h.shape
    h = h.reshape(N, C, Hc, place_net.POOL_W,
                  Wc // place_net.POOL_W).mean(dim=(2, 4))
    h = h.permute(0, 2, 1).reshape(N, place_net.POOL_W * C)
    v = h @ params["proj"]["w"] + params["proj"]["b"]
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-12)


def test_default_forward_is_unchanged(batch):
    params = place_net.get_params(device="cpu")
    x = torch.from_numpy(batch[0])
    before = _forward_before(params, x)
    assert torch.equal(place_net.forward(params, x), before)
    assert torch.equal(place_net.forward(params, x,
                                         compute_dtype=torch.bfloat16), before)


def _reference_loss(params, x, m, g, b, noise, tau=0.07):
    """benchmarks/train_place_net.py:217-253 on a given batch."""
    x = x * g + b + noise
    z = jpn.forward(params, x, compute_dtype=jnp.float32).reshape(B, 2, -1)
    logits = z[:, 0] @ z[:, 1].T / tau
    ma, mp = m[:, 0], m[:, 1]
    d2 = jnp.sum((ma[:, None, :2] - mp[None, :, :2]) ** 2, -1)
    dyaw = jnp.abs(jnp.angle(jnp.exp(1j * (ma[:, None, 2] - mp[None, :, 2]))))
    same_arena = ma[:, None, 3] == mp[None, :, 3]
    near = same_arena & (d2 < 9.0) & (dyaw < jnp.deg2rad(25.0))
    logits = jnp.where(near & ~jnp.eye(B, dtype=bool), -1e9, logits)
    labels = jnp.arange(B)
    l1 = optax.softmax_cross_entropy_with_integer_labels(logits,
                                                         labels).mean()
    l2 = optax.softmax_cross_entropy_with_integer_labels(logits.T,
                                                         labels).mean()
    return 0.5 * (l1 + l2)


def test_loss_and_gradients_match_reference(batch):
    jparams = jpn.init_params(seed=3)
    jloss, jgrads = jax.value_and_grad(_reference_loss)(
        jparams, *(jnp.asarray(a) for a in batch))
    params = _port(jparams)
    ps = tp.leaves(params)
    for p in ps:
        p.requires_grad_(True)
    loss = tp.infonce_loss(params, *(torch.from_numpy(a) for a in batch))
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-4 * abs(
        float(jloss))
    for a, g in zip(_leaves_hwio({"convs": [
            {"w": c["w"].grad, "b": c["b"].grad} for c in params["convs"]],
            "proj": {"w": params["proj"]["w"].grad,
                     "b": params["proj"]["b"].grad}}),
            jax.tree.leaves(jgrads)):
        g = np.asarray(g)
        scale = float(np.abs(g).max())
        assert scale > 0
        assert float(np.abs(a.numpy() - g).max()) <= 1e-4 * scale


def test_adam_matches_optax_under_the_schedule():
    """Three steps of the tool's optimizer (`optimizer`, `set_lr`) against
    optax's adam over the cosine decay of 10 steps, same gradients."""
    steps = 10
    rng = np.random.default_rng(2)
    p0 = {"a": rng.normal(0, 1, (6, 5)).astype(np.float32),
          "b": rng.normal(0, 1, (7,)).astype(np.float32)}
    grads = [{k: rng.normal(0, 1, v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(3)]
    opt = optax.adam(optax.cosine_decay_schedule(3e-4, steps, alpha=0.05))
    jp, state = jax.tree.map(jnp.asarray, p0), None
    state = opt.init(jp)
    ps = [torch.tensor(p0[k], requires_grad=True) for k in ("a", "b")]
    topt = tp.optimizer(ps, steps)
    for step, g in enumerate(grads):
        upd, state = opt.update(jax.tree.map(jnp.asarray, g), state)
        jp = optax.apply_updates(jp, upd)
        tp.set_lr(topt, step, steps)
        for p, k in zip(ps, ("a", "b")):
            p.grad = torch.from_numpy(g[k])
        topt.step()
        for p, k in zip(ps, ("a", "b")):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=1e-6)
    sched = optax.cosine_decay_schedule(3e-4, steps, alpha=0.05)
    for c in (0, 1, 5, 10, 12):
        assert tp.cosine_lr(c, steps) == pytest.approx(float(sched(c)),
                                                       rel=1e-6)


def test_candidate_pr_matches_reference():
    rng = np.random.default_rng(6)
    T = 60
    emb = rng.normal(0, 1, (T, 16))
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    emb[40:] = emb[:20] + rng.normal(0, 0.05, (20, 16))   # revisits
    th = np.linspace(0, 2 * np.pi * 1.5, T)
    cen = np.stack([10 * np.sin(th), 10 * np.cos(th)], axis=1)
    yaws = th + np.pi / 2
    for thr in (0.3, 0.5, 0.7, 0.9):
        assert tp.candidate_pr(emb, cen, yaws, thr) == \
            jtrain.candidate_pr(emb, cen, yaws, thr)
        assert tp.candidate_pr(emb, cen, yaws, thr, skip=10) == \
            jtrain.candidate_pr(emb, cen, yaws, thr, skip=10)


def test_arena_views_are_the_reference_views(monkeypatch):
    """The numpy draws are the reference's, so the poses and the meta are
    equal and the views held as the scene renders are (tests/
    test_torch_scenes.py), in preprocessed units (1/255 a grey level)."""
    h, w = 24, 64
    monkeypatch.setattr(tp, "H", h)
    monkeypatch.setattr(tp, "W", w)
    views, meta = tp.sample_arena_views(np.random.default_rng(7), 2.226, 6,
                                        "cpu")
    jviews, jmeta = jtrain.sample_arena_views(
        np.random.default_rng(7), 2.226, 6, h, w, jax.devices("cpu")[0])
    np.testing.assert_array_equal(meta, jmeta)
    assert views.shape == (12, place_net.IN_H, place_net.IN_W)
    d = np.abs(views.numpy() - jviews)
    assert d.mean() < 0.1 / 255, d.mean()
    assert (d > 1.0 / 255).mean() < 5e-3, (d > 1.0 / 255).mean()
    assert tp.pose_from_xz_yaw(1.0, 2.0, 0.3).tobytes() == \
        jtrain.pose_from_xz_yaw(1.0, 2.0, 0.3).tobytes()


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_cli_toy_run_writes_only_its_out(tmp_path, monkeypatch):
    """The command line's path (`run(parse_args(argv))`, what `main` calls)
    at toy sizes on the CPU (views at 48x160 to keep the renders cheap):
    it writes its --out and nothing else, the file
    loads in the reference, the loss is finite; --val-only reads it back;
    the shipped weights file is refused as --out and stays unchanged."""
    monkeypatch.setattr(tp, "H", 48)
    monkeypatch.setattr(tp, "W", 160)
    shipped = _digest(place_net.WEIGHTS_PATH)
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    out = str(out_dir / "w.npz")
    argv = ["--steps", "3", "--arenas", "2", "--anchors", "4", "--batch",
            "4", "--device", "cpu", "--out", out]
    s = tp.run(tp.parse_args(argv))
    assert os.listdir(out_dir) == ["w.npz"]
    jpn.load_params(out)
    assert len(s["losses"]) == 3 and np.isfinite(s["losses"]).all()
    assert len(s["table"]) == len(tp.VAL_PHASES) * len(tp.THRESHOLDS)
    assert tp.main(argv + ["--val-only"]) == 0
    assert os.listdir(out_dir) == ["w.npz"]
    assert tp.main(["--val-only", "--out", str(tmp_path / "none.npz"),
                    "--device", "cpu"]) == 1
    with pytest.raises(ValueError):
        tp.run(tp.parse_args(argv[:-1] + [place_net.WEIGHTS_PATH]))
    with pytest.raises(SystemExit):
        tp.parse_args(["--steps", "3"])
    assert _digest(place_net.WEIGHTS_PATH) == shipped


def test_shipped_weights_discriminate_the_heldout_world():
    """tests/test_place_net.py:49-85 (the reference's held-out world,
    texture phase 57.3) in the port, with the shipped weights."""
    pos, neg = tp.heldout_discrimination(place_net.get_params(device="cpu"),
                                         "cpu")
    assert min(pos) > max(neg) + 0.1, (pos, neg)
    assert np.mean(pos) > 0.8, pos
