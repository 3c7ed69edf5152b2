"""The port's scraping CLI with stubs only (no network, no yt-dlp,
ffmpeg, mediapipe or whisperx): ``tests/test_scrape.py``'s cases against
the port's module, and both packages' commands driven through the same
stubs must leave the same manifests, transcripts and files."""

import json
import subprocess
import sys
import types
from pathlib import Path
from unittest import mock

import pytest

from avatar_tpu.cli import scrape as jscrape
from avatar_tpu_torch.cli import scrape as tscrape
from avatar_tpu_torch.cli.scrape import BotDetectionError, _read_avspeech_csv, run_yt_dlp


def test_read_avspeech_csv(tmp_path):
    csv = tmp_path / "avspeech.csv"
    csv.write_text("abc123,1.5,7.25,0.1,0.2\nxyz789,0.0,3.0\nbad_row\n")
    rows = _read_avspeech_csv(str(csv))
    assert rows == [("abc123", 1.5, 7.25), ("xyz789", 0.0, 3.0)]
    assert rows == jscrape._read_avspeech_csv(str(csv))


def _fake_run(stderr="", returncode=1):
    def fake(cmd, shell, capture_output, text):
        return subprocess.CompletedProcess(cmd, returncode=returncode, stdout="", stderr=stderr)
    return fake


def test_run_yt_dlp_bot_detection_aborts():
    with mock.patch("subprocess.run", _fake_run(stderr="Sign in to confirm")):
        with pytest.raises(BotDetectionError):
            run_yt_dlp("yt-dlp ...")


@pytest.mark.parametrize("stderr", ["Video unavailable. This video is gone",
                                    "ERROR: Private video. Sign in"])
def test_run_yt_dlp_unavailable_returns_false(stderr):
    with mock.patch("subprocess.run", _fake_run(stderr=stderr, returncode=1)):
        assert run_yt_dlp("yt-dlp ...") is False


def test_run_yt_dlp_success():
    with mock.patch("subprocess.run", _fake_run(returncode=0)):
        assert run_yt_dlp("yt-dlp ...", sleep_after_success=False) is True


def test_run_yt_dlp_retries_then_fails():
    calls = []

    def fake(cmd, shell, capture_output, text):
        calls.append(1)
        return subprocess.CompletedProcess(cmd, returncode=1, stdout="", stderr="err")

    with mock.patch("subprocess.run", fake), mock.patch(
            "avatar_tpu_torch.cli.scrape.random_sleep") as sleep:
        assert run_yt_dlp("yt-dlp ...", retries=3) is False
    assert len(calls) == 3 and sleep.call_count == 3


def test_missing_tool_is_named():
    with mock.patch("shutil.which", lambda name: None):
        with pytest.raises(RuntimeError, match="yt-dlp"):
            tscrape._require("yt-dlp")
    assert tscrape.USER_AGENTS == jscrape.USER_AGENTS


def _download_world(mod, out_dir: Path, one_person):
    """Stubs for ``mod``: the tools found, yt-dlp writing the file its
    ``-o`` names, ffmpeg writing its last argument, and the face gate."""
    def fake_yt(cmd, retries=2, sleep_after_success=True):
        target = cmd.split('-o "')[1].split('"')[0]
        Path(target).write_bytes(b"video")
        return True

    def fake_run(cmd, shell=True, **kw):
        Path(cmd.rsplit('"', 2)[1]).write_bytes(b"clip")
        return subprocess.CompletedProcess(cmd, 0)

    return [mock.patch.object(mod, "_require", lambda name: name),
            mock.patch.object(mod, "run_yt_dlp", fake_yt),
            mock.patch.object(mod, "is_one_person_from_start",
                              lambda p: one_person(Path(p).name)),
            mock.patch.object(mod.subprocess, "run", fake_run)]


def _filter_and_download(mod, tmp, argv_extra=()):
    csv = tmp / "rows.csv"
    csv.write_text("aaa,1.0,4.5\nbbb,0.0,2.0\nccc,2.5,6.0\n")
    out = tmp / "videos"
    patches = _download_world(mod, out, lambda name: not name.startswith("bbb"))
    for p in patches:
        p.start()
    try:
        args = ["filter-and-download", "--csv_path", str(csv), "--output_dir", str(out),
                "--manifest", str(tmp / "manifest.json"), "--batch_size", "2",
                "--workers", "2", *argv_extra]
        with mock.patch.object(sys, "argv", ["scrape", *args]):
            mod.main()
    finally:
        for p in patches:
            p.stop()
    return json.loads((tmp / "manifest.json").read_text())


def test_filter_and_download_matches_jax_and_resumes(tmp_path):
    """Both packages keep the one-person rows, write the same manifest
    (entries sorted: downloads finish in any order), and a rerun adds
    nothing."""
    got = {}
    for name, mod in (("j", jscrape), ("t", tscrape)):
        tmp = tmp_path / name
        tmp.mkdir()
        manifest = _filter_and_download(mod, tmp)
        got[name] = sorted((Path(r["video_path"]).name, r["ytid"]) for r in manifest)
        assert len(_filter_and_download(mod, tmp)) == len(manifest)
        assert not list((tmp / "videos").glob("*_preview.mp4"))
    assert got["t"] == got["j"] == [("aaa_1000_4500.mp4", "aaa"), ("ccc_2500_6000.mp4", "ccc")]


def test_process_downloaded_matches_jax(tmp_path, monkeypatch):
    """whisperx stubbed: English videos transcribed, each trimmed to its
    first speech (0.5 s) and transcribed again, a French one skipped and
    deleted, previews removed afterwards; the same transcripts file from
    both packages."""
    runs = []

    class Model:
        def transcribe(self, path):
            lang = "fr" if "vfr" in path else "en"
            return {"language": lang, "segments": [{"start": 0.5, "text": "hi"}]}

    fake = types.SimpleNamespace(
        load_model=lambda name, device: (runs.append(("load", name, device)), Model())[1],
        load_align_model=lambda language_code, device: ("align", {"lang": language_code}),
        load_audio=lambda path: "audio",
        align=lambda segs, model, meta, audio, device: {"segments": segs},
    )
    monkeypatch.setitem(sys.modules, "whisperx", fake)

    def fake_run(cmd, shell=True, **kw):
        target = Path(cmd.rsplit('"', 2)[1])
        if target.suffix == ".mp4":
            runs.append("trimmed")
        target.write_bytes(b"x")
        return subprocess.CompletedProcess(cmd, 0)

    got = {}
    for name, mod in (("j", jscrape), ("t", tscrape)):
        runs.clear()
        vids = tmp_path / name / "videos"
        vids.mkdir(parents=True)
        for v in ("ven", "vfr", "ven_preview"):
            (vids / f"{v}.mp4").write_bytes(b"v")
        out = tmp_path / name / "transcripts.json"
        monkeypatch.setattr(mod, "_require", lambda binary: binary)
        monkeypatch.setattr(mod.subprocess, "run", fake_run)
        argv = ["process-downloaded", "--videos_dir", str(vids), "--transcripts_file", str(out)]
        if mod is tscrape:
            tscrape.main(argv + ["--device", "cpu"])
        else:
            with mock.patch.object(sys, "argv", ["scrape", *argv]):
                jscrape.main()
        assert ("load", "large-v2", "cpu") in runs or mod is jscrape
        data = json.loads(out.read_text())
        got[name] = [(Path(d["video_path"]).name, d["transcript"]) for d in data]
        assert sorted(p.name for p in vids.iterdir()) == ["ven.mp4"]
    assert got["t"] == got["j"]
    assert [n for n, _ in got["t"]] == ["ven.mp4", "ven_preview.mp4"]
    assert runs.count("trimmed") == 2
