"""Map persistence: save/load the device-resident map.

The reference serializes its pointer-web map to Protobuf (−78% time / −50%
size vs text streams per its README) with a relink pass after load
(reference: src/Map.cc:200-319 save/load, :322-381 processConnection;
proto/Keyframe.proto, proto/MapPoint.proto).  The map is already flat
arrays, so the checkpoint is a compressed npz of the SoA stores — no relink
pass is needed because the graph IS arrays (observation index, covisibility,
spanning tree are saved verbatim).  The keyframe database is rebuilt from
stored descriptors on load, mirroring the reference's KFDB refill
(System.cc:104-110).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from ..config import SLAMConfig
from ..mapstate.map_state import MapState


def save_map(path: str, state: MapState, cfg: SLAMConfig) -> None:
    """Write the full map + config snapshot to ``path`` (npz)."""
    arrays = {f: np.asarray(getattr(state, f)) for f in state._fields}
    arrays["__config__"] = np.frombuffer(
        json.dumps(_cfg_to_dict(cfg)).encode(), dtype=np.uint8
    )
    np.savez_compressed(path, **arrays)


def load_map(path: str) -> Tuple[MapState, dict]:
    """Load a map; returns (MapState, config-dict snapshot)."""
    z = np.load(path)
    fields = {}
    for f in MapState._fields:
        if f not in z.files:
            # forward-compat: maps saved before a field existed get its
            # empty-map default (kf_Tcp added r4 — identity)
            if f == "kf_Tcp":
                K = z["kf_Tcw"].shape[0]
                fields[f] = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (K, 4, 4))
                continue
            raise KeyError(f"map file {path} missing field {f}")
        fields[f] = jnp.asarray(z[f])
    cfg_dict = json.loads(bytes(z["__config__"].tobytes()).decode()) if "__config__" in z else {}
    return MapState(**fields), cfg_dict


def _cfg_to_dict(cfg: SLAMConfig) -> dict:
    out = {}
    for f in dataclasses.fields(cfg):
        sub = getattr(cfg, f.name)
        out[f.name] = dataclasses.asdict(sub)
    return out
