"""Mid-run checkpoint and resume of the whole SLAM state (counterpart of
`slam/checkpoint.py`).

The state - map tensors, frontend state with its pyramids, host archives,
counters, and the loop-closure database and edges - round-trips through
one compressed .npz in the reference's layout: the same array names, the
same JSON meta (`FORMAT_VERSION` 1; `mode`, the writer's class name, for
the streaming pipelines), descriptors as uint32 words. So a checkpoint the
JAX package writes resumes here, and the other way round. Loading moves
every array to the pipeline's device.
"""

from __future__ import annotations

import json

import numpy as np

from stereovision_slam_torch.convert import tensor
from stereovision_slam_torch.slam import frontend as fe
from stereovision_slam_torch.slam import map_state as mapmod
from stereovision_slam_torch.slam.loop_closure import (LoopEdge,
                                                       ProcessedKeyframe)
from stereovision_slam_torch.slam.pipeline import KeyframeRecord
from stereovision_slam_torch.utils.exceptions import CheckpointError

FORMAT_VERSION = 1
_LC_FIELDS = ("embedding", "desc", "desc_ok", "feat_uv", "lm_pos", "lm_has",
              "lm_id", "lm_first_kf", "pose")


def host(t) -> np.ndarray:
    """A tensor's value as a numpy array (int32 descriptor words stay
    int32; callers view them as uint32 where the layout asks for it)."""
    return t.detach().cpu().numpy()


def frontend_arrays(fs: fe.FrontendState) -> dict:
    """The frontend state under the checkpoint's `fs.` names."""
    arrays = {f"fs.{name}": host(getattr(fs, name)) for name in (
        "T_cur", "T_rel", "feat_uv", "feat_lm", "feat_valid", "ref_uv")}
    for i, level in enumerate(fs.pyr):
        arrays[f"fs.pyr.{i}"] = host(level)
    for i, level in enumerate(fs.ref_pyr):
        arrays[f"fs.ref_pyr.{i}"] = host(level)
    return arrays


def load_frontend(arrays, num_levels: int, device) -> fe.FrontendState:
    def t(name):
        return tensor(arrays[name], device)
    return fe.FrontendState(
        T_cur=t("fs.T_cur"), T_rel=t("fs.T_rel"), feat_uv=t("fs.feat_uv"),
        feat_lm=t("fs.feat_lm"), feat_valid=t("fs.feat_valid"),
        pyr=tuple(t(f"fs.pyr.{i}") for i in range(num_levels)),
        ref_uv=t("fs.ref_uv"),
        ref_pyr=tuple(t(f"fs.ref_pyr.{i}") for i in range(num_levels)))


def load_tuple(cls, arrays, prefix: str, device):
    """A NamedTuple of tensors from the arrays `prefix.<field>`."""
    return cls(**{name: tensor(arrays[f"{prefix}.{name}"], device)
                  for name in cls._fields})


def _write(path: str, arrays: dict, meta: dict) -> None:
    meta["version"] = FORMAT_VERSION
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(),
                                        dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def _read(path: str):
    data = np.load(path)
    meta = json.loads(bytes(data["meta_json"]).decode())
    if meta["version"] != FORMAT_VERSION:
        raise CheckpointError(
            f"checkpoint version {meta['version']} unsupported")
    return data, meta


def save_checkpoint(vo, path: str) -> None:
    """Serialize a `VisualOdometry`'s complete state."""
    arrays = {f"ms.{name}": host(val) for name, val in vo.ms._asdict().items()}
    arrays.update(frontend_arrays(vo.fs))
    lc_meta = None
    lc = vo.loop_closure
    if lc is not None:
        lc_meta = {
            "entries": [{"kf_id": p.kf_id, "frame_id": p.frame_id}
                        for p in lc.db.values()],
            "loop_edges": [
                {"kf_id": e.kf_id, "loop_kf_id": e.loop_kf_id,
                 "relative_pose": np.asarray(e.relative_pose).tolist(),
                 "info": None if e.info is None else e.info.tolist()}
                for e in lc.loop_edges],
            "last_closed_kf_id": lc.last_closed_kf_id,
            "last_deep_score": lc.last_deep_score,
        }
        for kf_id, p in lc.db.items():
            for field in _LC_FIELDS:
                arrays[f"lc.{kf_id}.{field}"] = np.asarray(getattr(p, field))
    meta = {
        "lc": lc_meta,
        "status": vo.status.name,
        "kf_count": vo.kf_count,
        "frame_count": vo.frame_count,
        "dataset_index": getattr(vo.dataset, "current_index", 0),
        "num_pyr_levels": len(vo.fs.pyr),
        "keyframes": [
            {"kf_id": r.kf_id, "frame_id": r.frame_id,
             "pose": r.pose.tolist(),
             "rel_to_prev": (r.rel_to_prev.tolist()
                             if r.rel_to_prev is not None else None)}
            for r in vo.archived_keyframes.values()],
        "landmarks": {str(k): v.tolist()
                      for k, v in vo.archived_landmarks.items()},
        "landmark_first_kf": {str(k): v for k, v in
                              vo.archived_landmark_first_kf.items()},
        "inlier_history": vo.inlier_history,
    }
    _write(path, arrays, meta)


def load_checkpoint(vo, path: str) -> None:
    """Restore a `save_checkpoint` state into an initialized
    `VisualOdometry` (the dataset and config must match)."""
    data, meta = _read(path)
    dev = vo.device
    vo.ms = load_tuple(mapmod.MapState, data, "ms", dev)
    vo.fs = load_frontend(data, meta["num_pyr_levels"], dev)
    vo.status = fe.FrontendStatus[meta["status"]]
    vo.kf_count = meta["kf_count"]
    vo.frame_count = meta["frame_count"]
    vo._reloc = None
    if hasattr(vo.dataset, "current_index"):
        vo.dataset.current_index = meta["dataset_index"]
    vo.archived_keyframes = {
        kf["kf_id"]: KeyframeRecord(
            frame_id=kf["frame_id"], kf_id=kf["kf_id"],
            pose=np.asarray(kf["pose"], np.float32),
            rel_to_prev=(np.asarray(kf["rel_to_prev"], np.float32)
                         if kf["rel_to_prev"] is not None else None))
        for kf in meta["keyframes"]}
    vo.archived_landmarks = {int(k): np.asarray(v, np.float32)
                             for k, v in meta["landmarks"].items()}
    vo.archived_landmark_first_kf = {
        int(k): int(v) for k, v in meta["landmark_first_kf"].items()}
    vo.inlier_history = list(meta["inlier_history"])

    lc, lc_meta = vo.loop_closure, meta.get("lc")
    if lc is not None and lc_meta is not None:
        lc.db = {}
        for ent in lc_meta["entries"]:
            kf_id = ent["kf_id"]
            lc.db[kf_id] = ProcessedKeyframe(
                kf_id=kf_id, frame_id=ent["frame_id"],
                **{f: data[f"lc.{kf_id}.{f}"] for f in _LC_FIELDS})
        lc.loop_edges = [
            LoopEdge(kf_id=e["kf_id"], loop_kf_id=e["loop_kf_id"],
                     relative_pose=np.asarray(e["relative_pose"], np.float32),
                     info=(None if e.get("info") is None
                           else np.asarray(e["info"], np.float32)))
            for e in lc_meta["loop_edges"]]
        lc.last_closed_kf_id = lc_meta["last_closed_kf_id"]
        lc.last_deep_score = lc_meta["last_deep_score"]
        lc.invalidate_scan_cache()


def save_fused_checkpoint(vo, path: str) -> None:
    """Serialize a `FusedVisualOdometry` or `FusedLoopVisualOdometry`
    (`vo.state_dict()`)."""
    arrays, meta = vo.state_dict()
    _write(path, arrays, meta)


def load_fused_checkpoint(vo, path: str) -> None:
    """Restore a `save_fused_checkpoint` state into an initialized
    streaming pipeline of the same class and config."""
    data, meta = _read(path)
    if meta["mode"] != type(vo).__name__:
        raise CheckpointError(
            f"checkpoint was written by {meta['mode']}, "
            f"loading into {type(vo).__name__}")
    vo.load_state_dict({k: data[k] for k in data.files if k != "meta_json"},
                       meta)
