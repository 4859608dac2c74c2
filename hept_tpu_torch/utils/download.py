"""Dataset download helpers (port of `hept_tpu/utils/download.py`, the
reference's src/utils/url.py).

OGB-style: download a URL with a size prompt, extract zip archives. Most
hosts that train this model have no network, so an unreachable URL raises
an error that says to place the archive by hand. The standard library only;
`file://` URLs work offline. `data/loaders.py:get_dataset` does not call
these, as the JAX package's loader does not.
"""

from __future__ import annotations

import os
import ssl
import sys
import urllib.request
import zipfile
from pathlib import Path

GBFACTOR = float(1 << 30)


def decide_download(url: str, interactive: bool = True) -> bool:
    """Ask before large downloads (reference url.py:14-26)."""
    try:
        d = urllib.request.urlopen(url)
    except Exception as e:
        raise ConnectionError(
            f"cannot reach {url} (zero-egress environment?) — download the "
            f"archive manually and place it under the data_dir"
        ) from e
    with d:
        size = int(d.info()["Content-Length"] or 0) / GBFACTOR
    if size < 1 or not interactive:
        return True
    return input(f"This will download {size:.2f} GB. Continue? (y/N) ").lower() == "y"


def download_url(url: str, folder: str | Path) -> Path:
    """Fetch `url` into `folder` under its last path component; a file
    already there is returned as it is."""
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    filename = url.rpartition("/")[2]
    path = folder / filename
    if path.exists():
        return path
    ctx = ssl._create_unverified_context()  # as the reference's url.py does
    print(f"downloading {url}", file=sys.stderr)
    with urllib.request.urlopen(url, context=ctx) as r, open(path, "wb") as f:
        while chunk := r.read(1 << 20):
            f.write(chunk)
    return path


def extract_zip(path: str | Path, folder: str | Path) -> None:
    with zipfile.ZipFile(path, "r") as z:
        z.extractall(folder)


def maybe_download_dataset(name: str, data_dir: str | Path, url: str | None) -> Path:
    """Fetch + extract a dataset archive if absent; raise helpfully offline."""
    target = Path(data_dir) / name
    if target.exists():
        return target
    if url is None:
        raise FileNotFoundError(
            f"dataset {name} not found under {data_dir} and no URL configured"
        )
    if decide_download(url, interactive=os.isatty(0)):
        archive = download_url(url, data_dir)
        extract_zip(archive, data_dir)
    return target
