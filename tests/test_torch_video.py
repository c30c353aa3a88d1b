"""The port's turntable writers (tgtc_torch/utils/video.py) against the JAX
package's (tgtc/utils/video.py), as tests/test_render_outputs.py:61-108 holds
the JAX ones: the same PNGs give the same decoded frames, in playback order,
and ``abort`` leaves no file."""

import os

import numpy as np
import pytest
from PIL import Image

from tgtc.utils import video as jax_video
from tgtc_torch.utils import video


def _frames(gif_path):
    gif = Image.open(gif_path)
    out = []
    for i in range(getattr(gif, "n_frames", 1)):
        gif.seek(i)
        out.append(np.asarray(gif.convert("RGB")))
    return out


def _same_frames(a, b):
    fa, fb = _frames(a), _frames(b)
    return len(fa) == len(fb) and all(np.array_equal(x, y) for x, y in zip(fa, fb))


@pytest.mark.parametrize("pattern,name", [(r"style_\d{5}_fine_\d{5}\.png", "style_00000_fine_{:05d}.png"),
                                          (r"rgb_\d{5}\.png", "rgb_{:05d}.png")])
def test_write_video_decodes_as_jax(tmp_path, pattern, name):
    d = tmp_path / "r"
    d.mkdir()
    rng = np.random.default_rng(3)
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (12, 16, 3), dtype=np.uint8)).save(
            d / name.format(i))
    Image.fromarray(np.zeros((12, 16, 3), np.uint8)).save(d / "depth_00000.png")  # not a frame
    ours = video.write_video(str(d), str(tmp_path / "port.gif"), pattern=pattern, fps=10)
    theirs = jax_video.write_video(str(d), str(tmp_path / "jax.gif"), pattern=pattern, fps=10)
    assert ours.endswith("port.gif") and theirs.endswith("jax.gif")
    assert len(_frames(ours)) == 5
    assert _same_frames(ours, theirs)
    with pytest.raises(FileNotFoundError):
        video.write_video(str(d), pattern=r"none_\d+\.png")


def test_streaming_gif_writer_decodes_as_jax_in_playback_order(tmp_path):
    rng = np.random.default_rng(4)
    frames = [rng.integers(0, 256, (8, 8, 3), dtype=np.uint8) for _ in range(3)]
    frames += [np.full((8, 8, 3), v, np.uint8) for v in (0, 85, 170, 255)]
    paths = []
    for mod, name in ((video, "port.gif"), (jax_video, "jax.gif")):
        w = mod.StreamingGifWriter(str(tmp_path / name), fps=10)
        for f in frames:
            w.add(f)
        paths.append(w.close())
    assert _same_frames(*paths)
    got = _frames(paths[0])
    assert len(got) == len(frames)
    for i, v in enumerate((0, 85, 170, 255)):  # order preserved
        assert abs(int(got[3 + i][0, 0, 0]) - v) <= 2


def test_streaming_gif_writer_abort_leaves_no_file(tmp_path):
    out = tmp_path / "video.gif"
    w = video.StreamingGifWriter(str(out))
    w.add(np.zeros((4, 4, 3), np.uint8))
    w.abort()
    assert not out.exists()
    empty = video.StreamingGifWriter(str(out))
    with pytest.raises(ValueError, match="no frames"):
        empty.close()
    assert not out.exists()
