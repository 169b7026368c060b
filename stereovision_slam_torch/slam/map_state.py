"""Fixed-capacity map store (counterpart of `slam/map_state.py`).

The active map is a tuple of fixed-size masked tensors: a keyframe window of
K slots, a landmark table of L slots and a dense (K, F) observation block,
with the reference's slot order, so a test can compare two states tensor by
tensor. Updates are functional (they return new tensors) and make no
device->host reads: the reference's `lax.cond` on a full window becomes a
select, and its static-size `nonzero` the sync-free `nonzero_static` below.
Ids, slots and counts stay 0-d device tensors: a 0-d tensor used as a
Python index is read on the host, so rows are taken with `row` and written
with `set_row`, and a captured CUDA graph reads every id at its replay.

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


def as_value(val, like: torch.Tensor) -> torch.Tensor:
    """`val` (a tensor or a Python scalar) as a tensor of `like`'s type and
    device; a scalar is filled in on the device, not copied from the
    host."""
    if torch.is_tensor(val):
        return val.to(dtype=like.dtype, device=like.device)
    return torch.full((), val, dtype=like.dtype, device=like.device)


def scatter_drop(x: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """x.at[idx].set(val, mode="drop") for idx in [0, len(x)], where
    len(x) marks a dropped write; the kept indices must be distinct."""
    ext = torch.cat([x, x[:1]])
    return ext.index_put((idx.to(torch.int64),), as_value(val, x))[:-1]


def row(x: torch.Tensor, slot) -> torch.Tensor:
    """x[slot] for a 0-d index tensor (or an int), without a host read."""
    if not torch.is_tensor(slot):
        return x[slot]
    return x.index_select(0, slot.reshape(1).to(torch.int64))[0]


def set_row(x: torch.Tensor, slot, val) -> torch.Tensor:
    """x.at[slot].set(val) for a 0-d index tensor (or an int), without a
    host read."""
    slot = torch.as_tensor(slot, device=x.device)
    return x.index_copy(0, slot.reshape(1).to(torch.int64),
                        as_value(val, x).expand(x.shape[1:]).unsqueeze(0))


def _evict_choice(m: MapState, new_pose: torch.Tensor, min_dis_th: float = 0.2):
    d = se3.se3_distance(m.kf_pose, new_pose[None])
    inf = torch.full_like(d, float("inf"))
    d = torch.where(m.kf_valid, d, inf)
    near = torch.argmin(d)
    far = torch.argmax(torch.where(m.kf_valid, d, -inf))
    return torch.where(row(d, near) < min_dis_th, near, far)


def _remove_keyframe_slot(m: MapState, slot: torch.Tensor):
    """Clear a keyframe slot, decrement its landmarks' counts and drop the
    landmarks left with none. Returns (map, archived_lm_mask)."""
    K, F = m.obs_lm.shape
    L = m.lm_valid.shape[0]
    obs_lm_row = row(m.obs_lm, slot)
    contrib = torch.where(row(m.obs_valid, slot) & (obs_lm_row >= 0),
                          1 + row(m.obs_has_r, slot).to(i32),
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
    first when the window holds `num_active`. `frame_id` and `kf_id` are
    ints or 0-d integer tensors. Returns (map, EvictedKeyframe)."""
    L = m.lm_valid.shape[0]
    dev = pose.device
    full = m.kf_valid.sum() >= num_active
    evict_slot = _evict_choice(m, pose)
    m_ev, archived = _remove_keyframe_slot(m, evict_slot)
    ev = EvictedKeyframe(
        happened=full, pose=row(m.kf_pose, evict_slot),
        frame_id=row(m.kf_frame_id, evict_slot),
        kf_id=row(m.kf_id, evict_slot),
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
    """Allocate landmark slots for up to F new points; `first_kf_id` an int
    or a 0-d integer tensor. Returns (map, slots): slots (F,) int32, -1
    where `create` was False or the table was full."""
    L = m.lm_valid.shape[0]
    F = positions.shape[0]
    free_slots = nonzero_static(~m.lm_valid, F)
    order = torch.cumsum(create.to(torch.int64), 0) - 1
    slots = torch.where(create, free_slots[torch.clamp(order, 0, F - 1)],
                        torch.full_like(order, -1))
    ok = create & (slots >= 0)
    safe = torch.where(ok, slots, torch.full_like(slots, L))
    new_ids = (m.next_lm_id + order).to(i32)
    first = as_value(first_kf_id, m.lm_first_kf).expand(F)
    m = m._replace(
        lm_pos=scatter_drop(m.lm_pos, safe, positions),
        lm_valid=scatter_drop(m.lm_valid, safe, True),
        lm_obs_count=scatter_drop(m.lm_obs_count, safe, 0),
        lm_first_kf=scatter_drop(m.lm_first_kf, safe, first),
        lm_id=scatter_drop(m.lm_id, safe, new_ids),
        next_lm_id=m.next_lm_id + ok.sum().to(i32),
    )
    return m, slots.to(i32)


def add_drop(x: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """x.at[idx].add(val, mode="drop") for idx in [0, len(x)], where len(x)
    marks a dropped update; repeated indices accumulate."""
    ext = torch.cat([x, x[:1]])
    return ext.index_add(0, idx.to(torch.int64), as_value(val, x))[:-1]


def merge_loop_landmarks(m: MapState, feat_lm, feat_valid, kf_slot,
                         match_idx, usable, cand_lm_pos, cand_lm_id,
                         cand_lm_first):
    """Duplicate-landmark merge during loop fusion (the reference's
    `merge_loop_landmarks`). For each good match (loop-candidate feature i
    -> current feature match_idx[i], usable[i]) the loop keyframe's
    landmark replaces the current keyframe's duplicate, in priority order:
    relink to the loop landmark's slot where it is still in the table
    (a duplicate that loses its last observation leaves the table);
    rewrite the linked slot in place where the feature has a landmark;
    insert into a free slot and link where it has none. Of several
    candidate features matching one current feature, the lowest index
    wins. Apply after the rigid pose correction.

    feat_lm / feat_valid (F,); kf_slot () the newest keyframe's window
    slot; match_idx, usable (Fc,); cand_lm_pos (Fc, 3); cand_lm_id,
    cand_lm_first (Fc,). Returns (new_map, new_feat_lm (F,) int32)."""
    L = m.lm_valid.shape[0]
    F = feat_lm.shape[0]
    Fc = match_idx.shape[0]
    dev = feat_lm.device
    match_idx = match_idx.to(torch.int64)
    feat_lm = feat_lm.to(torch.int64)

    # unique targets: the lowest candidate index per current feature
    idx_i = torch.arange(Fc, device=dev)
    tgt0 = torch.where(usable, match_idx, torch.full_like(match_idx, F))
    first_i = torch.full((F + 1,), Fc, dtype=torch.int64, device=dev)
    first_i = first_i.scatter_reduce(
        0, tgt0, torch.where(usable, idx_i, torch.full_like(idx_i, Fc)),
        reduce="amin")
    usable = usable & (first_i[torch.clamp(tgt0, 0, F)] == idx_i)

    # candidate landmark data on the current-feature slots
    tgt = torch.where(usable, match_idx, torch.full_like(match_idx, F))
    m_pos = scatter_drop(torch.zeros((F, 3), dtype=m.lm_pos.dtype,
                                     device=dev), tgt, cand_lm_pos)
    m_id = scatter_drop(torch.full((F,), -1, dtype=i32, device=dev), tgt,
                        cand_lm_id)
    m_first = scatter_drop(torch.full((F,), -1, dtype=i32, device=dev), tgt,
                           cand_lm_first)
    m_has = scatter_drop(torch.zeros((F,), dtype=torch.bool, device=dev),
                         tgt, True) & feat_valid & (m_id >= 0)

    has_r = row(m.obs_has_r, kf_slot)
    obs_contrib = 1 + has_r.to(i32)          # per current feature

    # the loop landmark is still in the table -> relink to its slot
    eq = (m.lm_id[None, :] == m_id[:, None]) & m.lm_valid[None, :]  # (F, L)
    exist_slot = torch.where(m_has & eq.any(1),
                             torch.argmax(eq.to(torch.int32), 1),
                             torch.full_like(feat_lm, -1))
    relink = m_has & (exist_slot >= 0) & (feat_lm != exist_slot)
    zero = torch.zeros_like(obs_contrib)
    old_slot = torch.where(relink & (feat_lm >= 0), feat_lm,
                           torch.full_like(feat_lm, L))
    gain_slot = torch.where(relink, exist_slot, torch.full_like(feat_lm, L))
    new_count = add_drop(add_drop(
        m.lm_obs_count, gain_slot, torch.where(relink, obs_contrib, zero)),
        old_slot, torch.where(relink, -obs_contrib, zero))
    new_count = torch.clamp(new_count, min=0)
    # a duplicate that lost its last observation is merged away
    m = m._replace(
        lm_obs_count=new_count,
        lm_valid=m.lm_valid & ~((new_count == 0) & (m.lm_obs_count > 0)))

    # not in the table, feature linked -> rewrite the linked slot in place
    repl = m_has & (exist_slot < 0) & (feat_lm >= 0)
    slot_a = torch.where(repl, feat_lm, torch.full_like(feat_lm, L))
    m = m._replace(lm_pos=scatter_drop(m.lm_pos, slot_a, m_pos),
                   lm_id=scatter_drop(m.lm_id, slot_a, m_id),
                   lm_first_kf=scatter_drop(m.lm_first_kf, slot_a, m_first))

    # not in the table, feature unlinked -> insert and link
    ins = m_has & (exist_slot < 0) & (feat_lm < 0)
    free_slots = nonzero_static(~m.lm_valid, F)
    order = torch.cumsum(ins.to(torch.int64), 0) - 1
    slots = torch.where(ins, free_slots[torch.clamp(order, 0, F - 1)],
                        torch.full_like(order, -1))
    ok = ins & (slots >= 0)
    safe = torch.where(ok, slots, torch.full_like(slots, L))
    m = m._replace(
        lm_pos=scatter_drop(m.lm_pos, safe, m_pos),
        lm_valid=scatter_drop(m.lm_valid, safe, True),
        lm_id=scatter_drop(m.lm_id, safe, m_id),
        lm_first_kf=scatter_drop(m.lm_first_kf, safe, m_first),
        lm_obs_count=scatter_drop(m.lm_obs_count, safe,
                                  torch.where(ok, obs_contrib, zero)))
    new_link = torch.where(ok, slots, torch.where(relink, exist_slot,
                                                  feat_lm)).to(i32)
    new_row = torch.where(ok | relink, new_link, row(m.obs_lm, kf_slot))
    m = m._replace(obs_lm=set_row(m.obs_lm, kf_slot, new_row))
    return m, new_link


def active_counts(m: MapState):
    """(keyframes, landmarks) in the active window."""
    return m.kf_valid.sum(), m.lm_valid.sum()
