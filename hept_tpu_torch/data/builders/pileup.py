"""Offline pileup dataset builder, Delphes ROOT -> Events (port of
`hept_tpu/data/builders/pileup.py`).

Rebuilds reference `src/datasets/pileup.py:94-142`: reads particle-flow
candidates from a Delphes ROOT tree via uproot (optional dependency — the
image may not ship it; a clear error is raised if missing), remaps PIDs onto
[0, 7), builds features (eta, phi, px, py, pt, E, rapidity, pid), label
`IsPU == 0`, the neutral-evaluation mask `is_neu = (charge == 0) & (pt >
0.9)`, and a per-event random permutation. The PileupTransform
(pileup.py:22-27) is applied inline: coords = [eta, phi, x[:, :2]].
"""

from __future__ import annotations

import numpy as np

from ..batching import Event


def remap_pid(pid: np.ndarray, charge: np.ndarray) -> np.ndarray:
    """PID remap onto [0, 7) (reference pileup.py:114-121): charged → 0,
    photon → 1, K0L → 2, K0S → 3, neutron → 4, Lambda → 5, Xi0 → 6."""
    out = pid.astype(np.int64).copy()
    out[charge != 0] = 0
    out[out == 22] = 1
    out[out == 130] = 2
    out[out == 310] = 3
    out[np.abs(out) == 2112] = 4
    out[np.abs(out) == 3122] = 5
    out[np.abs(out) == 3322] = 6
    return out


def build_pileup_events(
    root_path: str,
    tree: str = "Delphes",
    max_events: int | None = None,
    seed: int = 0,
) -> list[Event]:
    """Events of the Delphes tree `tree` in the ROOT file (at most
    `max_events`), each assembled by `build_one_pileup_event` with one
    generator seeded `seed`. Needs uproot, imported here."""
    try:
        import uproot
    except ImportError as e:
        raise ImportError("uproot is required to read Delphes ROOT files; install it or use "
                          "the synthetic-pileup dataset") from e

    rng = np.random.default_rng(seed)
    events = []
    with uproot.open(root_path) as f:
        t = f[tree]
        arrays = t.arrays(
            ["Eta", "Phi", "Px", "Py", "PT", "E", "Rapidity", "PID", "Charge", "IsPU"],
            library="np",
        )
        n_events = len(arrays["Eta"])
        for i in range(min(n_events, max_events or n_events)):
            events.append(
                build_one_pileup_event(
                    {k: np.asarray(v[i]) for k, v in arrays.items()}, rng
                )
            )
    return events


def build_one_pileup_event(cols: dict, rng: np.random.Generator) -> Event:
    """Assemble one event from raw column arrays (testable without uproot)."""
    pid = remap_pid(cols["PID"].astype(np.int64), cols["Charge"])
    x = np.stack(
        [
            cols["Eta"], cols["Phi"], cols["Px"], cols["Py"],
            cols["PT"], cols["E"], cols["Rapidity"], pid.astype(np.float64),
        ],
        axis=1,
    ).astype(np.float32)
    y = (cols["IsPU"] == 0).astype(np.float32)
    is_neu = (cols["Charge"] == 0) & (cols["PT"] > 0.9)

    perm = rng.permutation(len(y))
    x = x[perm]
    y = y[perm]
    is_neu = np.asarray(is_neu)[perm]
    pos = x[:, :2]
    coords = np.concatenate([pos, x[:, :2]], axis=1)
    return Event(x=x, coords=coords.astype(np.float32), y=y, is_neu=is_neu)
