"""Atlas: multi-map management + checkpoint/resume.

Re-design of `/root/reference/src/Atlas.cc`: the Atlas owns a set of maps,
one active; tracking failure spawns a fresh map (`CreateNewMap`
`Atlas.cc:66-106`) that place recognition may later merge back
(SURVEY.md §5.3 "elastic recovery").

The reference's boost-serialization checkpointing is designed but dormant
(`System.h:163-186` commented out; SURVEY.md §5.4); here map save/load is
a first-class, tested feature: a MapState is a pytree of arrays, so a
checkpoint is one compressed npz + a small host-metadata dict.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import jax.numpy as jnp

from orbslam3_jax.atlas.store import MapState, MapStore


class Atlas:
    def __init__(self, Kmax=256, Pmax=16384, Nf=1024):
        self._dims = (Kmax, Pmax, Nf)
        self.maps: List[MapStore] = [MapStore(Kmax, Pmax, Nf)]
        self.active_idx = 0
        self.imu_initialized = False

    @property
    def active(self) -> MapStore:
        return self.maps[self.active_idx]

    def create_new_map(self) -> MapStore:
        """`Atlas::CreateNewMap`: stash the current map, start fresh."""
        self.maps.append(MapStore(*self._dims))
        self.active_idx = len(self.maps) - 1
        return self.active

    def change_map(self, idx: int):
        self.active_idx = idx

    def remove_bad_maps(self, min_kfs: int = 5):
        """Drop non-active maps with too few keyframes (`Atlas::
        RemoveBadMaps`)."""
        keep = []
        for i, m in enumerate(self.maps):
            if i == self.active_idx or m.n_kf >= min_kfs:
                keep.append(m)
        self.active_idx = keep.index(self.maps[self.active_idx])
        self.maps = keep

    @property
    def n_maps(self) -> int:
        return len(self.maps)

    # ------------------------------------------------------------------
    # Checkpoint / resume (ref `System::SaveAtlas/LoadAtlas`, dormant in
    # the reference — functional here).
    # ------------------------------------------------------------------
    def save(self, path: str):
        os.makedirs(path, exist_ok=True)
        meta = {
            "dims": self._dims,
            "active_idx": self.active_idx,
            "imu_initialized": self.imu_initialized,
            "maps": [],
        }
        for i, m in enumerate(self.maps):
            arrays = {k: np.asarray(v) for k, v in m.state._asdict().items()}
            np.savez_compressed(os.path.join(path, f"map{i}.npz"), **arrays)
            meta["maps"].append(
                {
                    "n_kf": m.n_kf,
                    "n_mp": m.n_mp,
                    "kf_ts": m.kf_ts.tolist(),
                    "kf_frame_id": m.kf_frame_id.tolist(),
                    "free_mp_slots": m.free_mp_slots,
                    "free_kf_slots": m.free_kf_slots,
                    "change_index": m.change_index,
                }
            )
        with open(os.path.join(path, "atlas.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str) -> "Atlas":
        with open(os.path.join(path, "atlas.json")) as f:
            meta = json.load(f)
        atlas = cls(*meta["dims"])
        atlas.maps = []
        for i, m_meta in enumerate(meta["maps"]):
            store = MapStore(*meta["dims"])
            data = np.load(os.path.join(path, f"map{i}.npz"))
            store.state = MapState(**{k: jnp.asarray(data[k]) for k in data.files})
            store.n_kf = m_meta["n_kf"]
            store.n_mp = m_meta["n_mp"]
            store.kf_ts = np.asarray(m_meta["kf_ts"])
            store.kf_frame_id = np.asarray(m_meta["kf_frame_id"], np.int64)
            store.free_mp_slots = list(m_meta["free_mp_slots"])
            store.free_kf_slots = list(m_meta["free_kf_slots"])
            store.change_index = m_meta["change_index"]
            atlas.maps.append(store)
        atlas.active_idx = meta["active_idx"]
        atlas.imu_initialized = meta["imu_initialized"]
        return atlas
