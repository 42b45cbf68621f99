"""Video files as clips (a copy of ``cbinfer_tpu.fileio`` for the
PyTorch port, which imports nothing of the JAX package). CBinfer decodes
static-camera footage; these readers need no decoder library:

* **Y4M** (YUV4MPEG2): the uncompressed interchange format every ffmpeg
  writes (``ffmpeg -i cam.mp4 out.y4m``). C420* (chroma at half
  resolution, the common case) and C444, 8-bit, with BT.601 limited-range
  YUV->RGB conversion.
* **.npy / .npz**: a (T, H, W, 3) array clip (float in [0, 1] or uint8).

Both expose the SpriteVideo surface (``frame()``, ``clip(n)``,
``frames(n)``, ``height``, ``width``), so a file drops into the runner, the
tuner's calibration and ``cbinfer-torch --video`` unchanged. numpy only.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np

__all__ = ["Y4MVideo", "ArrayVideo", "open_video", "write_y4m"]


def _yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """BT.601 limited-range 8-bit YUV -> float32 RGB in [0, 1]."""
    yf = (y.astype(np.float32) - 16.0) * (255.0 / 219.0)
    uf = (u.astype(np.float32) - 128.0) * (255.0 / 224.0)
    vf = (v.astype(np.float32) - 128.0) * (255.0 / 224.0)
    r = yf + 1.402 * vf
    g = yf - 0.344136 * uf - 0.714136 * vf
    b = yf + 1.772 * uf
    rgb = np.stack([r, g, b], axis=-1) / 255.0
    return np.clip(rgb, 0.0, 1.0)


class Y4MVideo:
    """Streaming YUV4MPEG2 reader with the SpriteVideo surface.

    Frames are decoded lazily; ``loop=True`` restarts at EOF so finite
    files can drive unbounded streaming benchmarks (each wrap is a scene
    cut — CB sees it as a near-full-frame change, like the reference's
    camera switching).
    """

    def __init__(self, path: str, loop: bool = False):
        self.path = path
        self.loop = loop
        self._f = open(path, "rb")
        header = self._f.readline().decode("ascii", "replace").strip()
        if not header.startswith("YUV4MPEG2"):
            self._f.close()
            raise ValueError(f"{path}: not a YUV4MPEG2 file ({header[:20]!r})")
        self.height = self.width = 0
        self.colorspace = "C420"
        self.fps: Optional[float] = None
        for tok in header.split()[1:]:
            if tok[0] == "W":
                self.width = int(tok[1:])
            elif tok[0] == "H":
                self.height = int(tok[1:])
            elif tok[0] == "C":
                self.colorspace = tok
            elif tok[0] == "F":
                num, den = tok[1:].split(":")
                self.fps = int(num) / max(1, int(den))
        if self.height <= 0 or self.width <= 0:
            self._f.close()
            raise ValueError(f"{path}: missing W/H in Y4M header")
        if self.colorspace.startswith("C420"):
            # ceil, not floor: odd-dimension 4:2:0 stores (H+1)//2 chroma
            # rows (a floor read desyncs every later FRAME boundary)
            self._chroma_shape = ((self.height + 1) // 2,
                                  (self.width + 1) // 2)
        elif self.colorspace.startswith("C444"):
            self._chroma_shape = (self.height, self.width)
        else:  # C422 etc. — not worth the matrix of cases until needed
            self._f.close()
            raise ValueError(
                f"{path}: unsupported Y4M colorspace {self.colorspace} "
                "(supported: C420*, C444)")
        self._body_off = self._f.tell()
        self.frame_index = 0

    @property
    def shape(self):
        return (self.height, self.width, 3)

    def close(self):
        self._f.close()

    def _read_plane(self, h: int, w: int) -> np.ndarray:
        buf = self._f.read(h * w)
        if len(buf) != h * w:
            raise EOFError
        return np.frombuffer(buf, np.uint8).reshape(h, w)

    def frame(self) -> np.ndarray:
        """Next frame as float32 (H, W, 3) RGB in [0, 1]."""
        line = self._f.readline()
        if not line and self.loop:
            self._f.seek(self._body_off)
            line = self._f.readline()
        if not line.startswith(b"FRAME"):
            raise EOFError(f"{self.path}: end of stream at frame "
                           f"{self.frame_index}")
        y = self._read_plane(self.height, self.width)
        ch, cw = self._chroma_shape
        u, v = self._read_plane(ch, cw), self._read_plane(ch, cw)
        if (ch, cw) != (self.height, self.width):  # 420: nearest upsample
            u = np.repeat(np.repeat(u, 2, axis=0), 2, axis=1)
            v = np.repeat(np.repeat(v, 2, axis=0), 2, axis=1)
            u, v = u[:self.height, :self.width], v[:self.height, :self.width]
        self.frame_index += 1
        return _yuv_to_rgb(y, u, v)

    def frames(self, n: int) -> Iterator[np.ndarray]:
        for _ in range(n):
            yield self.frame()

    def clip(self, n: int) -> np.ndarray:
        return np.stack(list(self.frames(n)))


class ArrayVideo:
    """(T, H, W, 3) array file (.npy, or .npz key ``frames``) as a video.

    uint8 arrays are scaled to [0, 1]; float arrays pass through as
    float32. ``loop=True`` wraps at the end.
    """

    def __init__(self, path_or_array, loop: bool = False):
        if isinstance(path_or_array, np.ndarray):
            arr = path_or_array
        else:
            arr = np.load(path_or_array)
            if not isinstance(arr, np.ndarray):  # NpzFile
                arr = arr["frames"]
        if arr.ndim != 4 or arr.shape[-1] != 3:
            raise ValueError(f"expected (T, H, W, 3), got {arr.shape}")
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        self._arr = np.ascontiguousarray(arr, np.float32)
        self.loop = loop
        self.height, self.width = arr.shape[1:3]
        self.frame_index = 0

    def __len__(self):
        return self._arr.shape[0]

    @property
    def shape(self):
        return (self.height, self.width, 3)

    def frame(self) -> np.ndarray:
        if self.frame_index >= len(self):
            if not self.loop:
                raise EOFError(f"end of clip at frame {self.frame_index}")
            self.frame_index = 0
        f = self._arr[self.frame_index]
        self.frame_index += 1
        return f

    def frames(self, n: int) -> Iterator[np.ndarray]:
        for _ in range(n):
            yield self.frame()

    def clip(self, n: int) -> np.ndarray:
        return np.stack(list(self.frames(n)))


def _rgb_to_yuv(rgb: np.ndarray):
    """float32 RGB [0,1] -> BT.601 limited-range 8-bit Y, U, V planes.

    Exact inverse of ``_yuv_to_rgb`` up to 8-bit rounding, so a write/read
    round trip stays within 1/219 per channel."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    yf = 0.299 * r + 0.587 * g + 0.114 * b
    uf = (b - yf) / 1.772
    vf = (r - yf) / 1.402
    y = np.clip(yf * 219.0 + 16.0 + 0.5, 0, 255).astype(np.uint8)
    u = np.clip(uf * 224.0 + 128.0 + 0.5, 0, 255).astype(np.uint8)
    v = np.clip(vf * 224.0 + 128.0 + 0.5, 0, 255).astype(np.uint8)
    return y, u, v


def write_y4m(path: str, frames, fps: int = 30):
    """Write frames to an uncompressed YUV4MPEG2 file (C444, 8-bit).

    ``frames`` is a (T, H, W, 3) float array in [0, 1] or any iterable of
    (H, W, 3) frames. C444 (full-resolution chroma) keeps the round trip
    through ``Y4MVideo`` lossless up to 8-bit quantization: any array
    source writes a standard container that ``cbinfer-torch --video`` (and
    every ffmpeg) reads."""
    it = iter(frames)
    first = np.asarray(next(it))
    h, w = first.shape[:2]
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F{int(fps)}:1 Ip A1:1 C444\n"
                .encode("ascii"))

        def put(frame):
            frame = np.asarray(frame, np.float32)
            if frame.shape[:2] != (h, w) or frame.shape[-1] != 3:
                raise ValueError(f"frame shape {frame.shape} != ({h},{w},3)")
            y, u, v = _rgb_to_yuv(frame)
            f.write(b"FRAME\n")
            f.write(y.tobytes()); f.write(u.tobytes()); f.write(v.tobytes())

        put(first)
        for frame in it:
            put(frame)
    return path


def open_video(path: str, loop: bool = False):
    """Open a video file by extension: .y4m -> Y4MVideo, .npy/.npz ->
    ArrayVideo. The returned object plugs into the streaming runner
    exactly like a SpriteVideo."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".y4m":
        return Y4MVideo(path, loop=loop)
    if ext in (".npy", ".npz"):
        return ArrayVideo(path, loop=loop)
    raise ValueError(
        f"unsupported video container {ext!r} (supported: .y4m "
        "uncompressed YUV4MPEG2 — `ffmpeg -i in.mp4 out.y4m` — and "
        ".npy/.npz (T,H,W,3) clips)")
