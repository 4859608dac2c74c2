"""Offline TrackML point-cloud builder, host-side pandas / numpy (port of
`hept_tpu/data/builders/trackml.py`).

Rebuilds the reference's preprocessing pipeline
(`data/tracking/raw/preprocessing/point_cloud_builder.py` and
`exatrkx_cell_features.py`) without the trackml / torch_geometric
dependencies:

  * raw TrackML csv.gz files (hits/particles/truth/cells) read with pandas;
  * pixel-layer restriction with integer layer relabeling (builder:149-174);
  * ExaTrkX cluster-shape cell features from detector geometry tables
    (rotations / thicknesses / pixel pitches -> local & global direction
    angles leta/lphi/lx/ly/lz/geta/gphi, cell_features:177-270), vectorized
    over modules instead of `iterrows`;
  * derived coordinates r/phi/eta_rz/u/v and one-hot volume labels
    (builder:209-219);
  * phi-sectorization with extended overlap windows (builder:221-303):
    majority-vote sector assignment per particle;
  * reconstructability = particle hit >= 3 distinct layers (builder:377-384);
  * optional true edges from shared particle ids (builder:25-34).

Output is the port's `Event` (numpy), not a PyG Data. pandas is imported
inside the functions that use it: nothing on a training path imports this
module, and the machine that trains need not have pandas.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Sequence

import numpy as np

from ..batching import Event

logger = logging.getLogger(__name__)

PIXEL_BARREL = [(8, 2), (8, 4), (8, 6), (8, 8)]
PIXEL_LEC = [(7, 14), (7, 12), (7, 10), (7, 8), (7, 6), (7, 4), (7, 2)]
PIXEL_REC = [(9, 2), (9, 4), (9, 6), (9, 8), (9, 10), (9, 12), (9, 14)]

DEFAULT_FEATURES = (
    "r", "phi", "z", "eta_rz", "u", "v", "charge_frac",
    "leta", "lphi", "lx", "ly", "lz", "geta", "gphi",
)


def load_trackml_event(prefix: str | Path):
    """Read one TrackML event's four CSVs (replaces trackml.dataset.load_event)."""
    import pandas as pd

    prefix = str(prefix)

    def rd(part):
        for suffix in (f"-{part}.csv.gz", f"-{part}.csv"):
            p = Path(prefix + suffix)
            if p.exists():
                return pd.read_csv(p)
        raise FileNotFoundError(f"{prefix}-{part}.csv[.gz]")

    return rd("hits"), rd("particles"), rd("truth"), rd("cells")


def calc_eta(r, z):
    theta = np.arctan2(r, z)
    return -np.log(np.tan(theta / 2.0))


def preprocess_detector(detector) -> dict:
    """Detector geometry tables keyed by (volume, layer, module)
    (cell_features:51-157), built with vectorized indexing."""
    v = detector.volume_id.to_numpy(int)
    l = detector.layer_id.to_numpy(int)
    m = detector.module_id.to_numpy(int)
    shape = (v.max() + 1, l.max() + 1, m.max() + 1)

    rot = np.zeros(shape + (3, 3))
    cols = [["rot_xu", "rot_xv", "rot_xw"],
            ["rot_yu", "rot_yv", "rot_yw"],
            ["rot_zu", "rot_zv", "rot_zw"]]
    for i in range(3):
        for j in range(3):
            rot[v, l, m, i, j] = detector[cols[i][j]].to_numpy()

    thickness = np.zeros(shape)
    thickness[v, l, m] = detector.module_t.to_numpy()

    pitch = np.zeros(shape + (2,))
    pitch[v, l, m, 0] = detector.pitch_u.to_numpy()
    pitch[v, l, m, 1] = detector.pitch_v.to_numpy()
    return {"rotations": rot, "thicknesses": thickness, "pixel_size": pitch}


def augment_cell_features(hits, cells, detector: dict):
    """ExaTrkX cluster-shape angles (cell_features:175-270)."""
    import pandas as pd

    agg_u = cells.groupby("hit_id").ch0.agg(["min", "max"])
    agg_v = cells.groupby("hit_id").ch1.agg(["min", "max"])
    counts = cells.groupby("hit_id").value.agg(["count", "sum"])
    per_hit = pd.DataFrame(
        {
            "nb_u": agg_u["max"] - agg_u["min"] + 1,
            "nb_v": agg_v["max"] - agg_v["min"] + 1,
            "cell_count": counts["count"].astype(float),
            "cell_val": counts["sum"].astype(float),
        }
    ).reindex(hits.hit_id).fillna(0.0)

    vols = hits.volume_id.to_numpy(int)
    lays = hits.layer_id.to_numpy(int)
    mods = hits.module_id.to_numpy(int)
    pitch = detector["pixel_size"][vols, lays, mods]
    thick = detector["thicknesses"][vols, lays, mods]
    rots = detector["rotations"][vols, lays, mods]

    l_u = per_hit.nb_u.to_numpy() * pitch[:, 0]
    l_v = per_hit.nb_v.to_numpy() * pitch[:, 1]
    l_w = 2.0 * thick
    dirs = np.stack([l_u, l_v, l_w], axis=1)[..., None]
    g = np.matmul(rots, dirs).squeeze(-1)

    def to_spherical(x, y, z):
        r3 = np.sqrt(x**2 + y**2 + z**2)
        phi = np.arctan2(y, x)
        theta = np.arccos(np.clip(z / np.maximum(r3, 1e-12), -1, 1))
        return r3, theta, phi

    _, g_theta, g_phi = to_spherical(g[:, 0], g[:, 1], g[:, 2])
    _, l_theta, l_phi = to_spherical(l_u, l_v, l_w)
    eta = lambda th: -np.log(np.tan(0.5 * np.maximum(th, 1e-12)))

    out = hits.copy()
    out["cell_count"] = per_hit.cell_count.to_numpy()
    out["cell_val"] = per_hit.cell_val.to_numpy()
    out["leta"] = eta(l_theta)
    out["lphi"] = l_phi
    out["lx"] = l_u
    out["ly"] = l_v
    out["lz"] = l_w
    out["geta"] = eta(g_theta)
    out["gphi"] = g_phi
    return out


def get_truth_edges(pids: np.ndarray) -> np.ndarray:
    """All same-particle hit pairs (builder:25-34), vectorized."""
    order = np.argsort(pids, kind="stable")
    sp = pids[order]
    edges = []
    start = 0
    for end in np.r_[np.nonzero(np.diff(sp))[0] + 1, len(sp)]:
        group = order[start:end]
        if sp[start] > 0 and len(group) >= 2:
            ii, jj = np.triu_indices(len(group), k=1)
            edges.append(np.stack([group[ii], group[jj]]))
        start = end
    if not edges:
        return np.zeros((2, 0), np.int64)
    return np.concatenate(edges, axis=1)


@dataclasses.dataclass
class PointCloudBuilder:
    """The builder pipeline (builder:60-430): `Event`s per sector."""

    detector: object = None  # a pandas DataFrame of the detector geometry
    n_sectors: int = 1
    pixel_only: bool = True
    sector_di: float = 0.0001
    sector_ds: float = 1.1
    remove_noise: bool = False
    add_true_edges: bool = False
    feature_names: Sequence[str] = DEFAULT_FEATURES

    def __post_init__(self):
        self._det = preprocess_detector(self.detector) if self.detector is not None else None

    def restrict_to_subdetectors(self, hits, cells):
        allowed = PIXEL_BARREL + PIXEL_REC + PIXEL_LEC if self.pixel_only else None
        key = list(zip(hits.volume_id, hits.layer_id))
        pairs = sorted(set(key) & set(allowed)) if allowed is not None else sorted(set(key))
        label = {p: i for i, p in enumerate(pairs)}
        sel = [k in label for k in key]
        hits = hits[sel].copy()
        hits["layer"] = [label[k] for k in zip(hits.volume_id, hits.layer_id)]
        cells = cells[cells.hit_id.isin(hits.hit_id)].copy()
        return hits, cells

    def append_features(self, hits, particles, truth, cells):
        import pandas as pd

        particles = particles.copy()
        particles["pt"] = np.sqrt(particles.px**2 + particles.py**2)
        particles["eta_pt"] = calc_eta(particles.pt, particles.pz)

        truth_noise = truth[["hit_id", "particle_id"]][truth.particle_id == 0].copy()
        truth_noise["pt"] = 0.0
        truth_noise["eta_pt"] = 0.0
        truth = truth[["hit_id", "particle_id"]].merge(
            particles[["particle_id", "pt", "eta_pt"]], on="particle_id"
        )
        if not self.remove_noise:
            truth = pd.concat([truth, truth_noise])

        cells_agg = cells.groupby("hit_id").agg(
            charge_sum=pd.NamedAgg(column="value", aggfunc="sum"),
            channel_counts=pd.NamedAgg(column="value", aggfunc="size"),
        )
        cells_agg["charge_frac"] = cells_agg.charge_sum / cells_agg.channel_counts
        hits = pd.merge(hits, cells_agg, on="hit_id", how="left")

        if self._det is not None:
            hits = augment_cell_features(hits, cells, self._det)
        else:
            for col in ("leta", "lphi", "lx", "ly", "lz", "geta", "gphi"):
                hits[col] = 0.0

        for v in (7, 8, 9, 12, 13, 14, 16, 17, 18):
            hits[f"V{v}"] = (hits.volume_id == v).astype(int)

        hits["r"] = np.sqrt(hits.x**2 + hits.y**2)
        hits["phi"] = np.arctan2(hits.y, hits.x)
        hits["eta_rz"] = calc_eta(hits.r, hits.z)
        rsq = hits.x**2 + hits.y**2
        hits["u"] = hits.x / rsq
        hits["v"] = hits.y / rsq
        return hits.merge(
            truth[["hit_id", "particle_id", "pt", "eta_pt"]], on="hit_id"
        )

    def sector_hits(self, hits, sector_id, pid_counts):
        if self.n_sectors == 1:
            out = hits.copy()
            out["sector"] = 0
            return out
        theta = np.pi / self.n_sectors
        slope = np.arctan(theta)
        c, s = np.cos(2 * sector_id * theta), np.sin(2 * sector_id * theta)
        ur = hits.u * c - hits.v * s
        vr = hits.u * s + hits.v * c
        hits = hits.assign(ur=ur, vr=vr)
        core = hits[(hits.vr > -slope * hits.ur) & (hits.vr < slope * hits.ur) & (hits.ur > 0)]

        in_core = core.groupby("particle_id").size()
        sector_of_pid = {
            pid: sector_id
            for pid, cnt in in_core.items()
            if pid != 0 and cnt / pid_counts[pid] >= 0.5
        }
        lb = -self.sector_ds * slope * hits.ur - self.sector_di
        ub = self.sector_ds * slope * hits.ur + self.sector_di
        ext = hits[(hits.vr > lb) & (hits.vr < ub) & (hits.ur > 0)].copy()
        ext["sector"] = ext.particle_id.map(lambda p: sector_of_pid.get(p, -1))
        return ext

    def build_event(self, hits, particles, truth, cells) -> list[Event]:
        hits, cells = self.restrict_to_subdetectors(hits, cells)
        hits = self.append_features(hits, particles, truth, cells)

        by_pid = hits.groupby("particle_id")
        pid_counts = by_pid.size().to_dict()
        layers_hit = by_pid.layer.nunique().to_dict()
        hits["reconstructable"] = hits.particle_id.map(
            lambda p: float(layers_hit.get(p, 0) >= 3 and p > 0)
        )
        hits["n_layers_hit"] = hits.particle_id.map(layers_hit)
        hits["n_hits"] = hits.particle_id.map(pid_counts)

        events = []
        for s in range(self.n_sectors):
            sec = self.sector_hits(hits, s, pid_counts).reset_index(drop=True)
            events.append(self.to_event(sec))
        return events

    def to_event(self, hits) -> Event:
        """Build the Event, applying the TrackingTransform at the same time
        (reference src/datasets/tracking.py:26-35): x <- [features, layer/10],
        coords = [eta, phi, x[:, :4]]; particle ids densified with noise at 0."""
        x = hits[list(self.feature_names)].to_numpy(float)
        x = np.concatenate([x, hits.layer.to_numpy(float)[:, None] / 10.0], axis=1)
        pos = np.stack([hits.eta_rz.to_numpy(float), hits.phi.to_numpy(float)], axis=1)
        coords = np.concatenate([pos, x[:, :4]], axis=1)

        pid = hits.particle_id.to_numpy()
        uniq = np.unique(pid[pid > 0])
        remap = {p: i + 1 for i, p in enumerate(uniq)}
        dense = np.asarray([remap.get(p, 0) for p in pid], np.int32)

        pairs = get_truth_edges(pid).astype(np.int32) if self.add_true_edges else None
        return Event(
            x=x.astype(np.float32),
            coords=coords.astype(np.float32),
            cluster_ids=dense,
            recons=hits.reconstructable.to_numpy(np.float32),
            pts=hits.pt.to_numpy(np.float32),
            pairs=pairs,
        )


def build_point_cloud(prefix: str | Path, detector_csv: str | Path | None = None,
                      **kwargs) -> list[Event]:
    """One-call helper: raw TrackML event prefix -> per-sector Events."""
    import pandas as pd

    hits, particles, truth, cells = load_trackml_event(prefix)
    det = pd.read_csv(detector_csv) if detector_csv else None
    builder = PointCloudBuilder(detector=det, **kwargs)
    return builder.build_event(hits, particles, truth, cells)
