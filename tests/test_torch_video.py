"""Port parity: the ffmpeg / COLMAP helpers of data/video.py
(`have_binary`, `probe_fps`, `extract_frames`, `prepare_video_dataset`)
against the reference.

Both packages call the binaries on PATH.  Stand-ins for ffprobe and ffmpeg
(small scripts written into a directory that the test puts on PATH alone)
let both drive the same calls on a machine without them; the test with the
real ffmpeg skips without it, as the reference's helpers do.  Results are
host-side: equal."""

import os
import shutil
import stat
import subprocess
import sys

import numpy as np
import pytest

import test_data as fixtures
from casualhdrsplat_torch.data import video as t_video
from casualhdrsplat_tpu.data import video as j_video

# Stand-in ffmpeg: writes 5 PNG frames (or -frames:v of them) to the
# output pattern, its last argument.  Stand-in ffprobe: a 30000/1001 stream.
FFMPEG = """#!{python}
import sys
import numpy as np
from PIL import Image
args = sys.argv[1:]
n = int(args[args.index("-frames:v") + 1]) if "-frames:v" in args else 5
for i in range(1, n + 1):
    img = np.full((48, 64, 3), 40 * i, np.uint8)
    Image.fromarray(img).save(args[-1] % i)
"""
FFPROBE = """#!/bin/sh
echo '{{"streams": [{{"r_frame_rate": "{rate}"}}]}}'
"""


def _install(bin_dir, name, text):
    path = os.path.join(bin_dir, name)
    with open(path, "w") as f:
        f.write(text)
    os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)


@pytest.fixture
def stub_path(tmp_path, monkeypatch):
    """A PATH of one directory, which holds the stand-ins the test puts
    there (and sh, which the ffprobe stand-in needs)."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    os.symlink(shutil.which("sh"), bin_dir / "sh")
    monkeypatch.setenv("PATH", str(bin_dir))
    return str(bin_dir)


@pytest.mark.parametrize("name", ["sh", "python3", "no-such-binary-7f3a"])
def test_have_binary_matches(name):
    assert t_video.have_binary(name) == j_video.have_binary(name)


def test_have_binary_follows_path(stub_path):
    assert t_video.have_binary("sh") and not t_video.have_binary("ffmpeg")
    _install(stub_path, "ffmpeg", FFMPEG.format(python=sys.executable))
    assert t_video.have_binary("ffmpeg") and j_video.have_binary("ffmpeg")


def test_probe_fps_without_ffprobe(stub_path):
    assert t_video.probe_fps("clip.mp4") == j_video.probe_fps("clip.mp4") == 30.0


@pytest.mark.parametrize("rate", ["30000/1001", "24/1", "15/2"])
def test_probe_fps_reads_ffprobe(stub_path, rate):
    _install(stub_path, "ffprobe", FFPROBE.format(rate=rate))
    num, den = rate.split("/")
    assert t_video.probe_fps("clip.mp4") == j_video.probe_fps("clip.mp4") == int(num) / int(den)


def test_extract_frames_needs_ffmpeg(stub_path, tmp_path):
    for mod in (t_video, j_video):
        with pytest.raises(RuntimeError, match="ffmpeg not available"):
            mod.extract_frames("clip.mp4", str(tmp_path / "frames"))


@pytest.mark.parametrize("max_frames", [None, 3])
def test_extract_frames_with_ffmpeg(stub_path, tmp_path, max_frames):
    _install(stub_path, "ffmpeg", FFMPEG.format(python=sys.executable))
    got = t_video.extract_frames("clip.mp4", str(tmp_path / "t"), fps=10,
                                 max_frames=max_frames)
    want = j_video.extract_frames("clip.mp4", str(tmp_path / "j"), fps=10,
                                  max_frames=max_frames)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == (max_frames or 5)
    assert os.path.basename(got[0]) == "frame_00001.png"


def test_prepare_video_requires_colmap(stub_path, tmp_path):
    # frames present (extraction skipped), no sparse model: a clear error
    frames = tmp_path / "images"
    frames.mkdir()
    (frames / "frame_00001.png").write_bytes(b"x")
    for mod in (t_video, j_video):
        with pytest.raises(RuntimeError, match="COLMAP"):
            mod.prepare_video_dataset("missing.mp4", str(tmp_path))


@pytest.mark.parametrize("model_dir", ["sparse", "sparse/0"])
def test_prepare_video_dataset_equals_reference(stub_path, tmp_path, model_dir):
    """Frames from the stand-in ffmpeg, a COLMAP model of two of them
    (SfM dropped frame 2), timestamps from the registered names at the
    stand-in ffprobe's rate."""
    _install(stub_path, "ffmpeg", FFMPEG.format(python=sys.executable))
    _install(stub_path, "ffprobe", FFPROBE.format(rate="10/1"))
    fixtures.write_fake_colmap_bin(str(tmp_path / model_dir),
                                   names=(b"frame_00001.png", b"frame_00003.png"))
    got = t_video.prepare_video_dataset("clip.mp4", str(tmp_path))
    assert sorted(os.listdir(tmp_path / "images"))[0] == "frame_00001.png"
    want = j_video.prepare_video_dataset("clip.mp4", str(tmp_path))
    for f in ("images", "timestamps", "viewmats", "points_xyz", "points_rgb", "fx", "fy",
              "cx", "cy", "width", "height"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    np.testing.assert_allclose(got.timestamps, [0.0, 0.2], atol=1e-6)


def test_extract_frames_real_ffmpeg(tmp_path):
    if not (shutil.which("ffmpeg") and shutil.which("ffprobe")):
        pytest.skip("ffmpeg and ffprobe are not installed")
    clip = str(tmp_path / "clip.mp4")
    subprocess.run(["ffmpeg", "-y", "-f", "lavfi", "-i", "testsrc=size=64x48:rate=12",
                    "-t", "1", "-pix_fmt", "yuv420p", clip], check=True, capture_output=True)
    assert t_video.probe_fps(clip) == j_video.probe_fps(clip) == 12.0
    got = t_video.extract_frames(clip, str(tmp_path / "t"), max_frames=4)
    want = j_video.extract_frames(clip, str(tmp_path / "j"), max_frames=4)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    from PIL import Image

    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))
