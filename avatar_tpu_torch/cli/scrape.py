"""Data-acquisition CLIs, AVSpeech scraping and transcription (port of
``avatar_tpu/cli/scrape.py``; host only, no model of the port runs here):

  python -m avatar_tpu_torch.cli.scrape filter-and-download --csv_path avspeech.csv \
      --output_dir videos --manifest downloaded_videos.json
  python -m avatar_tpu_torch.cli.scrape process-downloaded --videos_dir videos \
      --transcripts_file video_transcripts.json

Fault handling: user-agent rotation, yt-dlp retries with a randomized
backoff, a hard stop on YouTube's bot detection, a 3 s preview per row
gated on exactly one face (mediapipe, else OpenCV's Haar cascade),
parallel downloads, and JSON manifests / transcripts written as they grow,
so that both stages resume. yt-dlp, ffmpeg, mediapipe and whisperx are
runtime tools, checked for with an error that names them.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import csv
import json
import random
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

USER_AGENTS = [
    "Mozilla/5.0 (Windows NT 10.0; Win64; x64; rv:109.0) Gecko/20100101 Firefox/117.0",
    "Mozilla/5.0 (Macintosh; Intel Mac OS X 10_15_7) AppleWebKit/605.1.15 (KHTML, like Gecko) Version/17.0 Safari/605.1.15",
    "Mozilla/5.0 (X11; Linux x86_64) AppleWebKit/537.36 (KHTML, like Gecko) Chrome/117.0.0.0 Safari/537.36",
    "Mozilla/5.0 (Windows NT 10.0; Win64; x64) AppleWebKit/537.36 (KHTML, like Gecko) Chrome/116.0.5845.96 Safari/537.36",
]


class BotDetectionError(RuntimeError):
    """YouTube's bot detection: the whole run stops."""


def _require(binary: str) -> str:
    path = shutil.which(binary)
    if not path:
        raise RuntimeError(
            f"`{binary}` is required for scraping but was not found on PATH."
        )
    return path


def random_sleep(min_s: float = 1, max_s: float = 4):
    t = random.uniform(min_s, max_s)
    time.sleep(t)


def run_yt_dlp(cmd: str, retries: int = 2, sleep_after_success: bool = True) -> bool:
    """Run a yt-dlp command line: True on success, False where the video is
    gone or private or after ``retries`` failures (a random 3-6 s pause
    between them); raises :class:`BotDetectionError` on bot detection."""
    for attempt in range(retries):
        result = subprocess.run(cmd, shell=True, capture_output=True, text=True)
        if "Sign in to confirm" in result.stderr:
            raise BotDetectionError("YouTube bot detection triggered - stopping")
        if "Video unavailable. This video" in result.stderr:
            return False
        if " Private video. Sign" in result.stderr:
            return False
        if result.returncode == 0:
            if sleep_after_success:
                random_sleep(2, 5)
            return True
        random_sleep(3, 6)
    return False


def is_one_person_from_start(
    video_path: Path, num_frames: int = 15, fps: int = 2
) -> bool:
    """True when ``num_frames`` frames sampled at ``fps`` from the start
    show exactly one face wherever they show one, in more than one frame
    (mediapipe when installed, OpenCV's Haar cascade otherwise)."""
    import cv2

    detector = None
    try:
        import mediapipe as mp

        detector = mp.solutions.face_detection.FaceDetection(
            model_selection=0, min_detection_confidence=0.5
        )
    except ImportError:
        cascade_path = Path(getattr(cv2.data, "haarcascades", "")) / (
            "haarcascade_frontalface_default.xml"
        )
        if not cascade_path.exists():
            raise RuntimeError(
                "Face detection needs mediapipe or OpenCV Haar cascades."
            )
        cascade = cv2.CascadeClassifier(str(cascade_path))

    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        return False
    frame_rate = cap.get(cv2.CAP_PROP_FPS)
    interval = int(frame_rate / fps) if frame_rate > 0 else 1

    frames_checked = 0
    ok = True
    for frame_idx in range(0, num_frames * max(interval, 1), max(interval, 1)):
        cap.set(cv2.CAP_PROP_POS_FRAMES, frame_idx)
        ret, frame = cap.read()
        if not ret:
            break
        rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        if detector is not None:
            res = detector.process(rgb)
            n = len(res.detections or [])
        else:
            gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
            n = len(cascade.detectMultiScale(gray, 1.1, 5))
        if n == 0:
            continue
        if n != 1:
            ok = False
            break
        frames_checked += 1
    cap.release()
    return ok and frames_checked > 1


def _read_avspeech_csv(csv_path: str) -> List[Tuple[str, float, float]]:
    rows = []
    with open(csv_path, newline="") as f:
        for row in csv.reader(f):
            if len(row) >= 3:
                rows.append((row[0], float(row[1]), float(row[2])))
    return rows


def cmd_filter_and_download(args):
    ffmpeg = _require("ffmpeg")
    _require("yt-dlp")
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    rows = _read_avspeech_csv(args.csv_path)
    end = len(rows) if args.end_row in (-1, None) else args.end_row
    rows = rows[args.start_row : end]

    # the manifest so far: a rerun skips what it lists
    manifest = Path(args.manifest)
    all_records: List[dict] = []
    existing = set()
    if manifest.exists():
        try:
            all_records = json.loads(manifest.read_text()) or []
            existing = {r.get("video_path") for r in all_records}
            print(f"Loaded {len(all_records)} existing manifest entries")
        except Exception as e:
            print(f"Warning: could not read manifest: {e}")

    def prefilter(ytid: str, start: float, end_t: float):
        preview = out_dir / f"{ytid}_preview.mp4"
        ua = random.choice(USER_AGENTS)
        cmd = (
            f"yt-dlp --retries 2 --fragment-retries 2 --socket-timeout 10 "
            f"--no-progress --quiet --no-warnings -f mp4 "
            f"--merge-output-format mp4 "
            f'--ffmpeg-location "{ffmpeg}" --user-agent "{ua}" '
            f'--download-sections "*{start}-{start + 3}" '
            f'-o "{preview}" "https://www.youtube.com/watch?v={ytid}"'
        )
        if not run_yt_dlp(cmd, sleep_after_success=False) or not preview.exists():
            return None
        keep = is_one_person_from_start(preview)
        preview.unlink(missing_ok=True)
        return (ytid, start, end_t) if keep else None

    def download(ytid: str, start: float, end_t: float) -> Optional[Path]:
        tmp = out_dir / f"{ytid}.full.mp4"
        final = out_dir / f"{ytid}_{int(start * 1000)}_{int(end_t * 1000)}.mp4"
        if final.exists():
            return final
        ua = random.choice(USER_AGENTS)
        if not tmp.exists():
            cmd = (
                f"yt-dlp --retries 2 --fragment-retries 2 --socket-timeout 10 "
                f"--no-progress --quiet --no-warnings -f mp4 "
                f"--merge-output-format mp4 "
                f'--ffmpeg-location "{ffmpeg}" --user-agent "{ua}" '
                f'-o "{tmp}" "https://www.youtube.com/watch?v={ytid}"'
            )
            if not run_yt_dlp(cmd) or not tmp.exists():
                return None
        subprocess.run(
            f"ffmpeg -hide_banner -loglevel error -nostats -y "
            f'-ss {start} -to {end_t} -i "{tmp}" '
            f'-c:v libx264 -preset veryfast -crf 23 -c:a aac "{final}"',
            shell=True,
        )
        tmp.unlink(missing_ok=True)
        return final if final.exists() else None

    for b_start in range(0, len(rows), args.batch_size):
        batch = rows[b_start : b_start + args.batch_size]
        print(f"=== Pre-filtering rows {b_start} to {b_start + len(batch) - 1} ===")
        filtered = []
        with concurrent.futures.ThreadPoolExecutor(max_workers=args.workers) as ex:
            futures = [ex.submit(prefilter, *row) for row in batch]
            for fut in concurrent.futures.as_completed(futures):
                res = fut.result()  # BotDetectionError propagates = hard stop
                if res is not None:
                    filtered.append(res)
        print(f"Batch complete: {len(filtered)}/{len(batch)} passed")
        if not filtered:
            continue

        new_paths = []
        with concurrent.futures.ThreadPoolExecutor(max_workers=args.workers) as ex:
            futures = [ex.submit(download, *row) for row in filtered]
            for fut in concurrent.futures.as_completed(futures):
                res = fut.result()
                if res is not None:
                    new_paths.append(res)

        added = 0
        for p in new_paths:
            if str(p) in existing:
                continue
            all_records.append(
                {"video_path": str(p), "ytid": p.name.split("_")[0]}
            )
            existing.add(str(p))
            added += 1
        if added:
            manifest.write_text(json.dumps(all_records, indent=2))
            print(f"Appended {added} entries -> {manifest} (total {len(all_records)})")


def cmd_process_downloaded(args):
    """WhisperX transcription and forced alignment, English only; each
    video trimmed to its first speech and transcribed again; the
    transcripts file written after every video; videos without a
    transcript (and previews) deleted."""
    ffmpeg = _require("ffmpeg")
    try:
        import whisperx
    except ImportError as e:
        raise RuntimeError(
            "process-downloaded needs `whisperx` (and torch): pip install whisperx"
        ) from e

    device = getattr(args, "device", "cuda")
    model = whisperx.load_model(args.whisper_model, device)

    def transcribe(video_path: Path) -> Dict:
        audio_path = video_path.with_suffix(".wav")
        subprocess.run(
            f'{ffmpeg} -y -i "{video_path}" -vn -ac 1 -ar 16000 "{audio_path}"',
            shell=True,
        )
        try:
            result = model.transcribe(str(audio_path))
            if result.get("language") != "en":
                print(f"Skipping {video_path}, language={result.get('language')}")
                return {}
            align_model, metadata = whisperx.load_align_model(
                language_code=result["language"], device=device
            )
            audio = whisperx.load_audio(str(audio_path))
            return whisperx.align(
                result.get("segments", []), align_model, metadata, audio, device
            )
        finally:
            audio_path.unlink(missing_ok=True)

    transcripts_file = Path(args.transcripts_file)
    all_data: List[Dict] = []
    if transcripts_file.exists():
        try:
            existing = json.loads(transcripts_file.read_text())
            if isinstance(existing, list):
                all_data = existing
        except Exception:
            pass

    paths = sorted(Path(args.videos_dir).glob("*.mp4"))
    for i, vp in enumerate(paths):
        print(f"Transcribing {i + 1}/{len(paths)}: {vp}")
        data = transcribe(vp)
        if not data:
            continue
        first = next(
            (
                float(s.get("start", 0.0))
                for s in data.get("segments", [])
                if str(s.get("text", "")).strip()
            ),
            None,
        )
        if first is not None and first > 0.0:
            tmp = vp.with_suffix(".tmp.mp4")
            rc = subprocess.run(
                f'{ffmpeg} -y -ss {first:.3f} -i "{vp}" '
                f'-c:v libx264 -preset veryfast -crf 23 -c:a aac "{tmp}"',
                shell=True,
            ).returncode
            if rc == 0 and tmp.exists():
                tmp.replace(vp)
                print(f"Re-transcribing trimmed video ({first:.2f}s): {vp}")
                data = transcribe(vp)

        all_data.append(
            {"video_path": str(vp), "transcript": data.get("segments", [])}
        )
        transcripts_file.write_text(json.dumps(all_data, indent=2))

    if args.delete_unsaved_videos:
        saved = {
            Path(e["video_path"]).resolve()
            for e in all_data
            if e.get("video_path")
        }
        for vp in paths:
            if vp.resolve() not in saved and vp.exists():
                vp.unlink()
                print(f"Deleted unsaved video: {vp}")
    for pattern in ("*_preview.mp4", "*_preview_trimmed.mp4"):
        for p in Path(args.videos_dir).glob(pattern):
            p.unlink(missing_ok=True)
    print(f"Processed {len(all_data)} videos -> {transcripts_file}")


def main(argv=None):
    parser = argparse.ArgumentParser(description="avatar_tpu_torch data scraping")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("filter-and-download")
    p.add_argument("--csv_path", type=str, default="avspeech_train.csv")
    p.add_argument("--start_row", type=int, default=0)
    p.add_argument("--end_row", type=int, default=-1)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=10)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--manifest", type=str, default="downloaded_videos.json")
    p.set_defaults(fn=cmd_filter_and_download)

    p = sub.add_parser("process-downloaded")
    p.add_argument("--videos_dir", type=str, required=True)
    p.add_argument("--transcripts_file", type=str, default="video_transcripts.json")
    p.add_argument("--whisper_model", type=str, default="large-v2")
    p.add_argument("--device", type=str, default="cuda",
                   help="where whisperx runs (cuda, or cpu)")
    p.add_argument(
        "--delete_unsaved_videos",
        action=argparse.BooleanOptionalAction,
        default=True,
    )
    p.set_defaults(fn=cmd_process_downloaded)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
