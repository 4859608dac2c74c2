"""`hept_tpu_torch/utils/download.py` against `hept_tpu/utils/download.py`,
offline: `file://` URLs to a zip built in the test's directory, and a fake
response for the size prompt. The JAX module imports no JAX."""

import ast
import io
import urllib.request
import zipfile
from pathlib import Path

import pytest

import hept_tpu.utils.download as jdl
import hept_tpu_torch.utils.download as tdl

PACKAGES = {"jax": jdl, "port": tdl}
FILES = {"tracking-60k/raw/data.pt": b"\x80\x04event bytes", "tracking-60k/README": b"readme"}


def _archive(tmp_path: Path) -> str:
    """A zip of FILES under tmp_path/src; its file:// URL."""
    src = tmp_path / "src"
    src.mkdir()
    path = src / "tracking-60k.zip"
    with zipfile.ZipFile(path, "w") as z:
        for name, data in FILES.items():
            z.writestr(name, data)
    return path.as_uri()


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def _outcome(fn, *args, **kw):
    """(value or None, exception type or None, its message) of one call."""
    try:
        return fn(*args, **kw), None, None
    except Exception as e:  # noqa: BLE001 - the two packages' errors are compared
        return None, type(e), str(e)


def test_module_imports_the_standard_library_only():
    """No torch, no JAX, nothing of either package."""
    tree = ast.parse(Path(tdl.__file__).read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert roots == {"__future__", "os", "ssl", "sys", "urllib", "zipfile", "pathlib"}
    assert [n for n in dir(jdl) if not n.startswith("_")] == \
        [n for n in dir(tdl) if not n.startswith("_")]


def test_maybe_download_dataset_matches_jax(tmp_path):
    """A missing data set is fetched from its file:// URL and extracted: the
    same target, archive and files; a second call finds the target and
    fetches nothing (the URL now points nowhere)."""
    url = _archive(tmp_path)
    got = {}
    for name, mod in PACKAGES.items():
        data_dir = tmp_path / name
        target = mod.maybe_download_dataset("tracking-60k", data_dir, url)
        assert target == data_dir / "tracking-60k"
        got[name] = _tree(data_dir)
        assert mod.maybe_download_dataset("tracking-60k", data_dir,
                                          (tmp_path / "gone.zip").as_uri()) == target
    assert got["port"] == got["jax"]
    archive = (tmp_path / "src" / "tracking-60k.zip").read_bytes()
    assert got["port"]["tracking-60k.zip"] == archive
    assert {k: v for k, v in got["port"].items() if k != "tracking-60k.zip"} == FILES


def test_download_url_and_extract_zip_match_jax(tmp_path, capsys):
    """download_url writes the bytes under the URL's last component and says
    so on stderr; a file already there is returned without a fetch;
    extract_zip unpacks the same files."""
    url = _archive(tmp_path)
    out = {}
    for name, mod in PACKAGES.items():
        path = mod.download_url(url, tmp_path / name / "dl")
        assert path == tmp_path / name / "dl" / "tracking-60k.zip"
        out[name] = capsys.readouterr().err
        path.write_bytes(b"kept")
        assert mod.download_url(url, tmp_path / name / "dl").read_bytes() == b"kept"
        assert capsys.readouterr().err == ""
        mod.extract_zip(tmp_path / "src" / "tracking-60k.zip", tmp_path / name / "x")
    assert out["port"] == out["jax"] == f"downloading {url}\n"
    assert _tree(tmp_path / "port" / "x") == _tree(tmp_path / "jax" / "x") == FILES


@pytest.mark.parametrize("case", ["unreachable", "no_url"])
def test_errors_match_jax(tmp_path, case):
    """An unreachable URL raises ConnectionError (decide_download, and
    maybe_download_dataset through it); no data set and no URL raises
    FileNotFoundError: the same types and messages."""
    missing = (tmp_path / "missing.zip").as_uri()
    calls = {"unreachable": [("decide_download", (missing,)),
                             ("maybe_download_dataset", ("ds", tmp_path, missing))],
             "no_url": [("maybe_download_dataset", ("ds", tmp_path, None))]}[case]
    for fn, args in calls:
        want = _outcome(getattr(jdl, fn), *args)
        got = _outcome(getattr(tdl, fn), *args)
        assert got == want
        assert got[1] is {"unreachable": ConnectionError, "no_url": FileNotFoundError}[case]


class _Response:
    def __init__(self, length):
        self.length = length

    def info(self):
        return {"Content-Length": self.length}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("length,answer,interactive", [
    (str(2 << 30), "y", True), (str(2 << 30), "Y", True), (str(2 << 30), "n", True),
    (str(2 << 30), "", True), (str(2 << 30), None, False), (str(1 << 20), None, True),
    (None, None, True),
], ids=["2GiB_y", "2GiB_Y", "2GiB_n", "2GiB_empty", "2GiB_not_interactive", "1MiB",
        "no_length"])
def test_size_prompt_matches_jax(monkeypatch, length, answer, interactive):
    """decide_download asks before 1 GiB or more when interactive (a fake
    response's Content-Length; the answer through `input`): the same prompt
    and the same decision."""
    monkeypatch.setattr(urllib.request, "urlopen", lambda url, **kw: _Response(length))
    results = {}
    for name, mod in PACKAGES.items():
        prompts = []

        def ask(prompt, prompts=prompts):
            prompts.append(prompt)
            assert answer is not None, "asked where no prompt is due"
            return answer

        monkeypatch.setattr("builtins.input", ask)
        results[name] = (mod.decide_download("file:///big.zip", interactive=interactive),
                         prompts)
    assert results["port"] == results["jax"]
    decision, prompts = results["port"]
    assert decision == (answer is None or answer.lower() == "y")
    assert prompts == ([] if answer is None else
                       ["This will download 2.00 GB. Continue? (y/N) "])


def test_declined_download_fetches_nothing(monkeypatch, tmp_path):
    """Answering no at the prompt leaves the data dir without the archive,
    and both return the (missing) target."""
    monkeypatch.setattr(urllib.request, "urlopen",
                        lambda url, **kw: _Response(str(2 << 30)) if not kw else
                        io.BytesIO(b"never"))
    monkeypatch.setattr("builtins.input", lambda prompt: "n")
    monkeypatch.setattr("os.isatty", lambda fd: True)
    for name, mod in PACKAGES.items():
        target = mod.maybe_download_dataset("ds", tmp_path / name, "file:///big.zip")
        assert target == tmp_path / name / "ds"
        assert not (tmp_path / name).exists()
