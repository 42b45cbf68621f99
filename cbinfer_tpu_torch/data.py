"""Host-side live frame sources (PyTorch port of ``cbinfer_tpu.data``).

``NativeSpriteVideo`` drives the C++ frame generator (``native/framegen.cpp``
in this package, a copy of the JAX package's) through ctypes: the same
statistical model as ``video.SpriteVideo`` (a multi-octave background,
moving square sprites, optional sensor noise), rendered by threads at a
production rate, but not bit-identical to it (its own RNG).
``PrefetchingSource`` runs any ``frame()`` source on a producer thread, so
frame production (or decode, for footage) overlaps the card's work; it
counts how often the consumer found its queue empty. ``make_video`` gives
the native source where it builds, else the NumPy ``SpriteVideo``: a host
data source, not a device kernel.

The generator is built at first use with ``g++`` (the flags of the JAX
package's ``native/Makefile``) into ``build/native/`` beside the package,
which ``.gitignore`` lists. Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import queue
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from .video import SpriteVideo, SpriteVideoConfig

SOURCE = Path(__file__).resolve().parent / "native" / "framegen.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "native"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
LDFLAGS = ("-shared", "-lpthread")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def lib_path() -> Path:
    """Where the generator's library is built: named by a hash of its
    source and flags, so an edited source builds anew."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXXFLAGS + LDFLAGS).encode())
    return BUILD_DIR / f"libframegen_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the generator if it is not built yet; raises with the
    compiler's output when the build fails."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXXFLAGS, str(SOURCE), "-o", str(tmp), *LDFLAGS]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed (rc {r.returncode}):\n{r.stderr}")
    os.replace(tmp, out)
    return out


def _load_lib() -> Optional[ctypes.CDLL]:
    """The loaded generator, built on first use; None where it cannot be
    built (no compiler)."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        try:
            path = build()
        except (OSError, RuntimeError):
            return None
        lib = ctypes.CDLL(str(path))
        lib.fg_create.restype = ctypes.c_void_p
        lib.fg_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                  ctypes.c_float, ctypes.c_uint64]
        lib.fg_destroy.restype = None
        lib.fg_destroy.argtypes = [ctypes.c_void_p]
        lib.fg_next.restype = None
        lib.fg_next.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        lib.fg_next_batch.restype = None
        lib.fg_next_batch.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_float),
                                      ctypes.c_int, ctypes.c_int]
        lib.fg_frame_index.restype = ctypes.c_uint64
        lib.fg_frame_index.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def native_available() -> bool:
    return _load_lib() is not None


class NativeSpriteVideo:
    """C++ frame source with the SpriteVideo interface (the same model, its
    own RNG: not bit-identical to the NumPy generator). Reads only
    ``height``, ``width``, ``channels``, ``n_sprites``, ``sprite_size``,
    ``speed``, ``noise_std`` and ``seed`` of the config."""

    def __init__(self, cfg: SpriteVideoConfig, n_threads: int = 4):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError(f"the frame generator did not build: g++ "
                               f"{' '.join(CXXFLAGS)} {SOURCE}")
        self._lib = lib
        self.cfg = cfg
        self.n_threads = n_threads
        self._h = lib.fg_create(cfg.height, cfg.width, cfg.channels,
                                cfg.n_sprites, cfg.sprite_size,
                                float(cfg.speed), float(cfg.noise_std),
                                cfg.seed)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.fg_destroy(self._h)
            self._h = None

    @property
    def frame_index(self) -> int:
        return int(self._lib.fg_frame_index(self._h))

    def frame(self) -> np.ndarray:
        """Renders AND advances (unlike ``SpriteVideo.frame``)."""
        out = np.empty((self.cfg.height, self.cfg.width, self.cfg.channels),
                       np.float32)
        self._lib.fg_next(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.n_threads)
        return out

    def clip(self, n: int) -> np.ndarray:
        out = np.empty((n, self.cfg.height, self.cfg.width,
                        self.cfg.channels), np.float32)
        self._lib.fg_next_batch(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, self.n_threads)
        return out

    def frames(self, n: int) -> Iterator[np.ndarray]:
        for _ in range(n):
            yield self.frame()


class PrefetchingSource:
    """Producer-thread frame pipeline over any object with a
    ``frame() -> np.ndarray`` method: the thread keeps up to ``depth``
    frames queued while the caller's device work runs. A finite source
    ends the stream by raising ``EOFError``; iteration then stops.

    ``waited`` counts the ``next()`` calls that found the queue empty (the
    producer set the pace), ``served`` all of them."""

    _EOS = object()  # end-of-stream sentinel (finite file sources)

    def __init__(self, source, depth: int = 4):
        self._source = source
        self._q: "queue.Queue" = queue.Queue(depth)
        self._stop = threading.Event()
        self.waited = 0
        self.served = 0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            try:
                frame = self._source.frame()
            except EOFError:
                frame = self._EOS  # finite source drained -> StopIteration
            while not self._stop.is_set():
                try:
                    self._q.put(frame, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if frame is self._EOS:
                return

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        self.served += 1
        try:
            item = self._q.get_nowait()
        except queue.Empty:
            self.waited += 1
            item = self._q.get()
        if item is self._EOS:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def make_video(cfg: SpriteVideoConfig, prefer_native: bool = True):
    """The best available frame source for a config."""
    if prefer_native and native_available():
        return NativeSpriteVideo(cfg)
    return SpriteVideo(cfg)
