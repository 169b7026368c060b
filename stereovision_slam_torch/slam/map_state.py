"""Fixed-capacity map store (counterpart of `slam/map_state.py`).

The active map is a tuple of fixed-size masked tensors: a keyframe window of
K slots, a landmark table of L slots and a dense (K, F) observation block,
with the reference's slot order, so a test can compare two states tensor by
tensor. Updates are functional (they return new tensors) and make no
device->host reads: the reference's `lax.cond` on a full window becomes a
select, and its static-size `nonzero` the sync-free `nonzero_static` below.

Semantics preserved: a window of `num_active` keyframes with the eviction
rule of the reference (the nearest keyframe if its SE(3)-log distance to the
new one is < 0.2, else the farthest); evicting a keyframe removes its
observations, and landmarks left with none leave the table and are reported
in `EvictedKeyframe` for archiving.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stereovision_slam_torch.geometry import se3

i32 = torch.int32


class MapState(NamedTuple):
    kf_pose: torch.Tensor       # (K, 3, 4) T_c_w
    kf_frame_id: torch.Tensor   # (K,) int32, -1 = empty
    kf_id: torch.Tensor         # (K,) int32, -1 = empty
    kf_valid: torch.Tensor      # (K,) bool
    lm_pos: torch.Tensor        # (L, 3)
    lm_valid: torch.Tensor      # (L,) bool
    lm_obs_count: torch.Tensor  # (L,) int32
    lm_first_kf: torch.Tensor   # (L,) int32
    lm_id: torch.Tensor         # (L,) int32
    obs_uv_l: torch.Tensor      # (K, F, 2)
    obs_uv_r: torch.Tensor      # (K, F, 2)
    obs_lm: torch.Tensor        # (K, F) int32, -1 = none
    obs_has_r: torch.Tensor     # (K, F) bool
    obs_valid: torch.Tensor     # (K, F) bool
    next_lm_id: torch.Tensor    # () int32


def empty_map(K: int, F: int, L: int, dtype=torch.float32,
              device="cpu") -> MapState:
    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=device)
    return MapState(
        kf_pose=full((K, 3, 4), 0.0, dtype),
        kf_frame_id=full((K,), -1, i32),
        kf_id=full((K,), -1, i32),
        kf_valid=full((K,), False, torch.bool),
        lm_pos=full((L, 3), 0.0, dtype),
        lm_valid=full((L,), False, torch.bool),
        lm_obs_count=full((L,), 0, i32),
        lm_first_kf=full((L,), -1, i32),
        lm_id=full((L,), -1, i32),
        obs_uv_l=full((K, F, 2), 0.0, dtype),
        obs_uv_r=full((K, F, 2), 0.0, dtype),
        obs_lm=full((K, F), -1, i32),
        obs_has_r=full((K, F), False, torch.bool),
        obs_valid=full((K, F), False, torch.bool),
        next_lm_id=full((), 0, i32),
    )


class EvictedKeyframe(NamedTuple):
    happened: torch.Tensor      # () bool
    pose: torch.Tensor          # (3, 4)
    frame_id: torch.Tensor      # () int32
    kf_id: torch.Tensor         # () int32
    lm_archived: torch.Tensor   # (L,) bool
    lm_pos: torch.Tensor        # (L, 3) positions at archival time
    lm_first_kf: torch.Tensor   # (L,) int32
    lm_id: torch.Tensor         # (L,) int32


def select(pred: torch.Tensor, a, b):
    """Leafwise torch.where over two NamedTuples of tensors."""
    return type(a)(*(torch.where(pred, x, y) for x, y in zip(a, b)))


def nonzero_static(mask: torch.Tensor, size: int, fill: int = -1):
    """Indices of the first `size` True entries of a 1-D mask, padded with
    `fill` (jnp.nonzero(mask, size=, fill_value=) without a host read)."""
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    dst = torch.where(mask & (rank < size), rank, torch.full_like(rank, size))
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=mask.device)
    out = out.index_put((dst,), torch.arange(mask.shape[0], device=mask.device))
    return out[:size]


def scatter_drop(x: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """x.at[idx].set(val, mode="drop") for idx in [0, len(x)], where
    len(x) marks a dropped write; the kept indices must be distinct."""
    ext = torch.cat([x, x[:1]])
    val = torch.as_tensor(val, dtype=x.dtype, device=x.device)
    return ext.index_put((idx.to(torch.int64),), val)[:-1]


def set_row(x: torch.Tensor, slot: torch.Tensor, val) -> torch.Tensor:
    """x.at[slot].set(val) for a 0-d index tensor, without a host read."""
    val = torch.as_tensor(val, dtype=x.dtype, device=x.device)
    return x.index_copy(0, slot.reshape(1).to(torch.int64),
                        val.expand(x.shape[1:]).unsqueeze(0))


def _evict_choice(m: MapState, new_pose: torch.Tensor, min_dis_th: float = 0.2):
    d = se3.se3_distance(m.kf_pose, new_pose[None])
    inf = torch.full_like(d, float("inf"))
    d = torch.where(m.kf_valid, d, inf)
    near = torch.argmin(d)
    far = torch.argmax(torch.where(m.kf_valid, d, -inf))
    return torch.where(d[near] < min_dis_th, near, far)


def _remove_keyframe_slot(m: MapState, slot: torch.Tensor):
    """Clear a keyframe slot, decrement its landmarks' counts and drop the
    landmarks left with none. Returns (map, archived_lm_mask)."""
    K, F = m.obs_lm.shape
    L = m.lm_valid.shape[0]
    obs_lm_row = m.obs_lm[slot]
    contrib = torch.where(m.obs_valid[slot] & (obs_lm_row >= 0),
                          1 + m.obs_has_r[slot].to(i32),
                          torch.zeros_like(obs_lm_row))
    safe_idx = torch.where(obs_lm_row >= 0, obs_lm_row,
                           torch.zeros_like(obs_lm_row)).to(torch.int64)
    dec = torch.zeros(L, dtype=i32, device=slot.device).index_add(
        0, safe_idx, contrib)
    new_count = torch.clamp(m.lm_obs_count - dec, min=0)
    archived = m.lm_valid & (new_count == 0) & (m.lm_obs_count > 0)
    m = m._replace(
        kf_valid=set_row(m.kf_valid, slot, False),
        kf_frame_id=set_row(m.kf_frame_id, slot, -1),
        kf_id=set_row(m.kf_id, slot, -1),
        obs_valid=set_row(m.obs_valid, slot, False),
        obs_lm=set_row(m.obs_lm, slot, -1),
        obs_has_r=set_row(m.obs_has_r, slot, False),
        lm_obs_count=new_count,
        lm_valid=m.lm_valid & ~archived,
    )
    return m, archived


def insert_keyframe(m: MapState, pose, frame_id, kf_id, feat_uv_l, feat_uv_r,
                    feat_lm, feat_has_r, feat_valid, num_active: int = 10):
    """Insert a keyframe with its feature->landmark links, evicting one
    first when the window holds `num_active`. Returns (map,
    EvictedKeyframe)."""
    L = m.lm_valid.shape[0]
    dev = pose.device
    full = m.kf_valid.sum() >= num_active
    evict_slot = _evict_choice(m, pose)
    m_ev, archived = _remove_keyframe_slot(m, evict_slot)
    ev = EvictedKeyframe(
        happened=full, pose=m.kf_pose[evict_slot],
        frame_id=m.kf_frame_id[evict_slot], kf_id=m.kf_id[evict_slot],
        lm_archived=archived & full, lm_pos=m.lm_pos,
        lm_first_kf=m.lm_first_kf, lm_id=m.lm_id)
    m = select(full, m_ev, m)

    slot = torch.argmax((~m.kf_valid).to(i32))
    safe_idx = torch.where(feat_lm >= 0, feat_lm,
                           torch.zeros_like(feat_lm)).to(torch.int64)
    obs_on = feat_valid & (feat_lm >= 0) & m.lm_valid[safe_idx]
    contrib = torch.where(obs_on, 1 + feat_has_r.to(i32),
                          torch.zeros_like(feat_lm))
    inc = torch.zeros(L, dtype=i32, device=dev).index_add(0, safe_idx, contrib)
    m = m._replace(
        kf_pose=set_row(m.kf_pose, slot, pose),
        kf_frame_id=set_row(m.kf_frame_id, slot, frame_id),
        kf_id=set_row(m.kf_id, slot, kf_id),
        kf_valid=set_row(m.kf_valid, slot, True),
        obs_uv_l=set_row(m.obs_uv_l, slot, feat_uv_l),
        obs_uv_r=set_row(m.obs_uv_r, slot, feat_uv_r),
        obs_lm=set_row(m.obs_lm, slot, torch.where(
            obs_on, feat_lm, torch.full_like(feat_lm, -1))),
        obs_has_r=set_row(m.obs_has_r, slot, feat_has_r & obs_on),
        obs_valid=set_row(m.obs_valid, slot, feat_valid),
        lm_obs_count=m.lm_obs_count + inc,
    )
    return m, ev


def add_landmarks(m: MapState, positions, create, first_kf_id):
    """Allocate landmark slots for up to F new points. Returns (map, slots):
    slots (F,) int32, -1 where `create` was False or the table was full."""
    L = m.lm_valid.shape[0]
    F = positions.shape[0]
    free_slots = nonzero_static(~m.lm_valid, F)
    order = torch.cumsum(create.to(torch.int64), 0) - 1
    slots = torch.where(create, free_slots[torch.clamp(order, 0, F - 1)],
                        torch.full_like(order, -1))
    ok = create & (slots >= 0)
    safe = torch.where(ok, slots, torch.full_like(slots, L))
    new_ids = (m.next_lm_id + order).to(i32)
    first = torch.as_tensor(first_kf_id, dtype=i32,
                            device=positions.device).expand(F)
    m = m._replace(
        lm_pos=scatter_drop(m.lm_pos, safe, positions),
        lm_valid=scatter_drop(m.lm_valid, safe, True),
        lm_obs_count=scatter_drop(m.lm_obs_count, safe, 0),
        lm_first_kf=scatter_drop(m.lm_first_kf, safe, first),
        lm_id=scatter_drop(m.lm_id, safe, new_ids),
        next_lm_id=m.next_lm_id + ok.sum().to(i32),
    )
    return m, slots.to(i32)


def active_counts(m: MapState):
    """(keyframes, landmarks) in the active window."""
    return m.kf_valid.sum(), m.lm_valid.sum()
