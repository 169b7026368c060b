"""Loop closure as the reference verifies it: ORB descriptors, Hamming
matching, the PlaceNet embedding, the hypothesis draws, PnP RANSAC and the
local fusion of a corrected keyframe into the window.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import geometry as geo
from portbench.reference import image, pose, window

# -- ORB ---------------------------------------------------------------- #

PATCH = 31
N_BITS = 256


def orb_pattern(seed: int = 7) -> torch.Tensor:
    """(256, 4) pair offsets (x0, y0, x1, y1): normal with sigma PATCH / 5
    from numpy's generator of `seed`, clipped to +-(PATCH // 2 - 1)."""
    pat = np.random.default_rng(seed).normal(0.0, PATCH / 5.0, (N_BITS, 4))
    return torch.as_tensor(np.clip(pat, -(PATCH // 2 - 1), PATCH // 2 - 1)
                           .astype(np.float32))


def orb(img: torch.Tensor, pts: torch.Tensor, valid: torch.Tensor,
        pattern: torch.Tensor):
    """Descriptors (N, 8) int32 of 256 bits (bit i of word j is pair
    32 j + i) and whether each is defined. On the 5-tap blurred image: the
    keypoint's orientation from the intensity centroid of its 31 x 31 patch
    within the inscribed disc; each pair's offsets rotated by it, rounded,
    and read from the 33 x 33 patch; a bit is set where the first value is
    the smaller."""
    smooth = image.filter2(img, image.GAUSS5, image.GAUSS5)
    p31, ok31 = image.patches(smooth, pts, PATCH)
    h = (PATCH - 1) / 2.0
    r = torch.arange(PATCH, dtype=torch.float32) - h
    disc = ((r[:, None] ** 2 + r[None, :] ** 2) <= h * h).float()
    m10 = (p31 * disc * r[None, None, :]).sum((1, 2))
    m01 = (p31 * disc * r[None, :, None]).sum((1, 2))
    norm = torch.clamp(torch.sqrt(m10 * m10 + m01 * m01), min=1e-9)
    c, s = (m10 / norm)[:, None], (m01 / norm)[:, None]
    p33, ok33 = image.patches(smooth, pts, PATCH + 2)
    x = torch.cat([c * pattern[:, 0] - s * pattern[:, 1],
                   c * pattern[:, 2] - s * pattern[:, 3]], 1)
    y = torch.cat([s * pattern[:, 0] + c * pattern[:, 1],
                   s * pattern[:, 2] + c * pattern[:, 3]], 1)
    c0 = (PATCH + 1) / 2.0
    xi = torch.clamp(torch.round(x + c0).long(), 0, PATCH + 1)
    yi = torch.clamp(torch.round(y + c0).long(), 0, PATCH + 1)
    v = p33[torch.arange(len(pts))[:, None], yi, xi]
    bits = (v[:, :N_BITS] < v[:, N_BITS:]).long().reshape(-1, 8, 32)
    words = (bits << torch.arange(32)).sum(-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.int(), valid & ok31 & ok33


def hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Na, 8) x (Nb, 8) int32 words -> (Na, Nb) differing bits."""
    x = (a.long()[:, None] ^ b.long()[None]) & 0xFFFFFFFF
    bits = (x[..., None] >> torch.arange(32)) & 1
    return bits.sum((-1, -2))


def match(query, query_ok, train, train_ok):
    """Each query descriptor's nearest train descriptor (the first on a
    tie), kept where its distance is at most max(2 d_min, 30), d_min the
    least over the queries. Returns (index (Nq,), kept (Nq,))."""
    big = 10_000
    d = hamming(query, train)
    d = torch.where(train_ok[None] & query_ok[:, None], d,
                    torch.full_like(d, big))
    idx = torch.argmin(d, 1)
    dist = d.gather(1, idx[:, None])[:, 0]
    found = query_ok & (dist < big)
    d_min = int(torch.where(found, dist, torch.full_like(dist, big)).min())
    return idx, found & (dist <= max(2 * d_min, 30))


# -- PlaceNet ------------------------------------------------------------ #

CONVS = ((5, 2), (3, 2), (3, 2), (3, 2))     # (kernel, stride)
WEIGHTS = Path(__file__).resolve().parents[2] / "stereovision_slam_torch" \
    / "models" / "weights" / "place_net.npz"


def place_weights() -> dict:
    """The shipped network's arrays (conv{i}_w HWIO, conv{i}_b, proj_w,
    proj_b), read from the data file."""
    with np.load(WEIGHTS) as z:
        return {k: torch.as_tensor(np.asarray(z[k], np.float32))
                for k in z.files}


def embed(wts: dict, img: torch.Tensor) -> torch.Tensor:
    """The 1280-d place embedding of a grey image: blurred by the 7-tap
    Gaussian, resized to 48 x 160 (linear, antialiased), scaled to
    [-0.5, 0.5]; four convolutions with XLA's SAME padding, each on inputs
    and weights rounded to bfloat16, with bias and ReLU; the mean over
    rows and over each fifth of the columns; the projection to 256, unit
    length, zeros after."""
    x = image.filter2(img, image.GAUSS7, image.GAUSS7)
    x = F.interpolate(x[None, None], size=(48, 160), mode="bilinear",
                      antialias=True, align_corners=False)
    h = x / 255.0 - 0.5
    bf = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    for i, (k, s) in enumerate(CONVS):
        pads = []
        for n in (h.shape[-1], h.shape[-2]):
            tot = max((-(-n // s) - 1) * s + k - n, 0)
            pads += [tot // 2, tot - tot // 2]
        wt = wts[f"conv{i}_w"].permute(3, 2, 0, 1)
        h = torch.relu(F.conv2d(F.pad(bf(h), pads), bf(wt), stride=s)
                       + wts[f"conv{i}_b"][None, :, None, None])
    N, C, Hc, Wc = h.shape
    h = h.reshape(N, C, Hc, 5, Wc // 5).mean((2, 4)).permute(0, 2, 1) \
        .reshape(N, 5 * C)
    v = h @ wts["proj_w"] + wts["proj_b"]
    v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                        min=1e-12)
    return F.pad(v[0], (0, 1280 - v.shape[-1]))


# -- hypothesis draws ---------------------------------------------------- #

M32 = 0xFFFFFFFF


def threefry_uniform(key: int, shape, lo: float, hi: float) -> torch.Tensor:
    """float32 uniforms in [lo, hi) from Threefry-2x32 (20 rounds) under
    the key (0, key): element i encrypts the counter (i >> 32, i & M32),
    keeps the top 23 bits of x0 ^ x1 as a mantissa of [1, 2), less 1,
    scaled into [lo, hi) and held at lo from below."""
    n = int(np.prod(shape))
    k = (0, int(key) & M32)
    ks = (k[0], k[1], k[0] ^ k[1] ^ 0x1BD11BDA)
    i = torch.arange(n, dtype=torch.long)
    x0, x1 = ((i >> 32) + ks[0]) & M32, ((i & M32) + ks[1]) & M32
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    for blk in range(5):
        for r in rot[blk % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & M32) ^ x0
        x0 = (x0 + ks[(blk + 1) % 3]) & M32
        x1 = (x1 + ks[(blk + 2) % 3] + blk + 1) & M32
    m = ((x0 ^ x1) >> 9) | 0x3F800000
    f = m.int().view(torch.float32) - 1.0
    lo_t, hi_t = torch.tensor(lo), torch.tensor(hi)
    return torch.maximum(lo_t, f * (hi_t - lo_t) + lo_t).reshape(shape)


# -- PnP RANSAC ---------------------------------------------------------- #

SAMPLE = 10


def _dlt(X: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Poses (H, 3, 4) from H sets of world points (H, S, 3) and
    normalized pixels (H, S, 2): the null vector of the DLT system on the
    centred, scaled points (float64), projected onto SE(3) by its polar
    factor, the sign keeping more points in front."""
    X, x = X.double(), x.double()
    c = X.mean(1, keepdim=True)
    s = torch.clamp(torch.sqrt(((X - c) ** 2).sum(-1).mean(1) / 3.0),
                    min=1e-9)
    Xh = torch.cat([(X - c) / s[:, None, None], torch.ones_like(X[..., :1])],
                   -1)
    z = torch.zeros_like(Xh)
    A = torch.cat([torch.cat([Xh, z, -x[..., :1] * Xh], -1),
                   torch.cat([z, Xh, -x[..., 1:] * Xh], -1)], 1)
    _, V = torch.linalg.eigh(A.transpose(1, 2) @ A)
    Pn = V[:, :, 0].reshape(-1, 3, 4)
    M = Pn[..., :3] / s[:, None, None]
    t = Pn[..., 3] - (Pn[..., :3] @ c.transpose(1, 2))[..., 0] / s[:, None]

    def polar(M, t):
        U, sv, Vh = torch.linalg.svd(M)
        sg = torch.where(torch.linalg.det(M) >= 0, 1.0, -1.0).double()
        D = torch.ones_like(sv)
        D[:, 2] = sg
        R = (U * D[:, None, :]) @ Vh
        scale = sv.mean(-1) * sg
        scale = torch.where(scale.abs() < 1e-12, torch.full_like(scale,
                                                                 1e-12),
                            scale)
        return torch.cat([R, (t / scale[:, None])[..., None]], -1)

    Ta, Tb = polar(M, t), polar(-M, -t)

    def front(T):
        return ((X @ T[:, 2, :3, None])[..., 0] + T[:, 2, 3:]).gt(0).sum(1)
    return torch.where((front(Ta) >= front(Tb))[:, None, None], Ta, Tb) \
        .float()


def pnp(cam: geo.Cam, X, uv, valid, u, th: float = 5.991,
        refine_rounds: int = 2):
    """The rig pose from left-image pixels of world points: hypotheses from
    SAMPLE points each, the points drawn per hypothesis by the largest
    Gumbel keys -log(-log(u)) (u (H, N) uniforms) among the valid ones;
    the hypothesis with most points within `th` pixels and in front (the
    first on a tie); then two LM refinements (`pose.solve`, chi2 th^2, 2
    rounds of 10), the second on the points within th at the first.
    Returns (T, inlier (N,))."""
    xn = geo.normalized(cam, uv)
    score = torch.where(valid, 0.0, -1e9)[None] - torch.log(-torch.log(u))
    sel = torch.sort(score, dim=1, descending=True, stable=True).indices[
        :, :SAMPLE]
    Th = _dlt(X[sel], xn[sel])
    q = torch.einsum("hij,nj->hni", Th[:, :, :3], X) + Th[:, None, :, 3]
    z = q[..., 2]
    zs = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    err = torch.sqrt((cam.fx * q[..., 0] / zs + cam.cx - uv[:, 0]) ** 2
                     + (cam.fy * q[..., 1] / zs + cam.cy - uv[:, 1]) ** 2)
    inl = valid[None] & (err <= th) & (z > 0)
    best = int(torch.argmax(inl.sum(1)))
    th2 = th * th
    kw = dict(chi2_th=th2, rounds=refine_rounds, iters=10)
    T0 = geo.compose(geo.inverse(cam.ext), Th[best])
    T1, _ = pose.solve([cam], [X], [uv], inl[best], T0[None], **kw)
    r, _, _, zz = geo.reprojection(cam, T1, X, uv)
    c = torch.where(zz > 1e-6, (r * r).sum(-1), torch.full_like(zz, 1e12))
    return pose.solve([cam], [X], [uv], valid & (c <= th2), T1[None], **kw)


# -- local fusion -------------------------------------------------------- #

def fuse(w: dict, T_cur, feat_lm, feat_valid, kf_slot: int, match_idx,
         usable, cand_pos, cand_id, cand_first, T_corr):
    """The window moved rigidly so that the keyframe sits at T_corr, then
    each matched loop landmark (the lowest candidate index per current
    feature) takes the place of the current feature's duplicate: the
    feature relinks to the loop landmark's slot where that is in the
    window (a duplicate left with no observation leaves the window), else
    its linked slot takes the loop landmark's position and ids, else the
    loop landmark enters a free slot. Returns (window, T_cur, feat_lm)."""
    w = {k: v.clone() for k, v in w.items()}
    L = w["lm_valid"].shape[0]
    Fn = feat_lm.shape[0]
    D = geo.compose(geo.inverse(T_cur), T_corr)
    w["kf_pose"] = torch.where(w["kf_valid"][:, None, None],
                               geo.compose(w["kf_pose"], D[None]),
                               w["kf_pose"])
    w["lm_pos"] = torch.where(w["lm_valid"][:, None],
                              geo.apply(geo.inverse(D)[None], w["lm_pos"]),
                              w["lm_pos"])
    T_cur = geo.compose(T_cur, D)

    feat_lm = feat_lm.long().clone()
    m_pos = torch.zeros(Fn, 3)
    m_id = torch.full((Fn,), -1, dtype=torch.int32)
    m_first = torch.full((Fn,), -1, dtype=torch.int32)
    taken = torch.zeros(Fn, dtype=torch.bool)
    for i in torch.nonzero(usable).flatten().tolist():
        f = int(match_idx[i])
        if not taken[f]:
            taken[f] = True
            m_pos[f], m_id[f], m_first[f] = cand_pos[i], cand_id[i], \
                cand_first[i]
    has = taken & feat_valid & (m_id >= 0)
    contrib = 1 + w["obs_has_r"][kf_slot].int()
    eq = (w["lm_id"][None] == m_id[:, None]) & w["lm_valid"][None]
    exist = torch.where(has & eq.any(1), torch.argmax(eq.int(), 1),
                        torch.full_like(feat_lm, -1))
    relink = has & (exist >= 0) & (feat_lm != exist)
    count = w["lm_obs_count"].clone()
    count.index_add_(0, exist[relink], contrib[relink])
    old = relink & (feat_lm >= 0)
    count.index_add_(0, feat_lm[old], -contrib[old])
    count = torch.clamp(count, min=0)
    w["lm_valid"] = w["lm_valid"] & ~((count == 0)
                                      & (w["lm_obs_count"] > 0))
    w["lm_obs_count"] = count
    repl = has & (exist < 0) & (feat_lm >= 0)
    s = feat_lm[repl]
    w["lm_pos"][s], w["lm_id"][s], w["lm_first_kf"][s] = m_pos[repl], \
        m_id[repl], m_first[repl]
    ins = has & (exist < 0) & (feat_lm < 0)
    k = torch.cumsum(ins.long(), 0) - 1
    free = window.first_free(w["lm_valid"], Fn)
    slots = torch.where(ins, free[torch.clamp(k, 0, Fn - 1)],
                        torch.full_like(k, -1))
    ok = ins & (slots >= 0)
    s = slots[ok]
    w["lm_pos"][s], w["lm_valid"][s] = m_pos[ok], True
    w["lm_id"][s], w["lm_first_kf"][s] = m_id[ok], m_first[ok]
    w["lm_obs_count"][s] = contrib[ok]
    link = torch.where(ok, slots, torch.where(relink, exist, feat_lm))
    w["obs_lm"][kf_slot] = torch.where(ok | relink, link.int(),
                                       w["obs_lm"][kf_slot])
    return w, T_cur, link.int()
