"""Turntable/video export from render directories — the port's own copy of
tgtc/utils/video.py (host-side, PIL only).

The reference carries commented-out ``imageio.mimwrite`` mp4 writers
(its rendering.py:224-239); this is the working equivalent without an
ffmpeg dependency: an animated GIF via PIL, or an mp4 if imageio with
ffmpeg happens to be installed.
"""

from __future__ import annotations

import os
import queue
import re
import threading
from typing import List, Optional


def _frames_in(render_dir: str, pattern: str) -> List[str]:
    rx = re.compile(pattern)
    return sorted(os.path.join(render_dir, f) for f in os.listdir(render_dir)
                  if rx.fullmatch(f))


def write_video(render_dir: str, out_path: Optional[str] = None,
                pattern: str = r"style_\d{5}_fine_\d{5}\.png", fps: int = 30) -> str:
    """Assemble the frames matching ``pattern`` into an animation.

    ``out_path``'s extension picks the writer (.gif always works; .mp4 only
    with imageio-ffmpeg present). Returns the written path."""
    from PIL import Image

    frames = _frames_in(render_dir, pattern)
    if not frames:
        raise FileNotFoundError(f"no frames matching {pattern} in {render_dir}")
    out_path = out_path or os.path.join(render_dir, "video.gif")

    if out_path.endswith(".mp4"):
        try:
            import imageio.v2 as imageio
            import numpy as np

            imageio.mimwrite(out_path,
                             [np.asarray(Image.open(f).convert("RGB")) for f in frames],
                             fps=fps, quality=8)
            return out_path
        except Exception:
            out_path = out_path[:-4] + ".gif"

    imgs = [Image.open(f).convert("RGB") for f in frames]
    imgs[0].save(out_path, save_all=True, append_images=imgs[1:],
                 duration=max(1, int(1000 / fps)), loop=0)
    return out_path


class StreamingGifWriter:
    """Assemble the turntable GIF while the renderer produces frames.

    Palette quantization is most of a post-hoc :func:`write_video`'s cost;
    this writer quantizes each frame on a background thread as it arrives,
    and :meth:`close` only runs the LZW encode.

    Frames must be added in playback order. If the producer skipped frames
    (a resumed run), call :meth:`abort` and fall back to :func:`write_video`.
    """

    def __init__(self, out_path: str, fps: int = 30, max_queue: int = 16):
        self._out_path = out_path
        self._duration = max(1, int(1000 / fps))
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        self._frames: List = []  # quantized P-mode PIL images
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        from PIL import Image

        while True:
            frame = self._q.get()
            if frame is None:
                return
            if self._err is not None:
                continue  # drain after a failure; abort/close report it
            try:
                img = Image.fromarray(frame)
                self._frames.append(img.quantize(256, method=Image.Quantize.MEDIANCUT))
            except BaseException as e:  # noqa: BLE001 — raised again at close
                self._err = e

    def add(self, frame) -> None:
        """Queue one HxWx3 uint8 host frame. Blocks only if the quantizer
        falls ``max_queue`` frames behind the renderer."""
        self._q.put(frame)

    @property
    def n_frames(self) -> int:
        return len(self._frames) + self._q.qsize()

    def abort(self) -> None:
        self._q.put(None)
        self._thread.join()
        self._frames.clear()

    def close(self) -> str:
        """Finish quantization, LZW-encode, and write the GIF."""
        self._q.put(None)
        self._thread.join()
        if self._err is not None:
            raise self._err
        if not self._frames:
            raise ValueError("no frames were streamed")
        self._frames[0].save(self._out_path, save_all=True, append_images=self._frames[1:],
                             duration=self._duration, loop=0)
        return self._out_path
