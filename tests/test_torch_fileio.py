"""The port's copy of the video-file readers and writer against the JAX
package's: the same frames, byte for byte, from the same .y4m (4:2:0,
4:4:4, odd sizes) and .npy/.npz files, the same errors, and the same
bytes written."""

import numpy as np
import pytest

from cbinfer_tpu import fileio as jfileio

from cbinfer_tpu_torch import fileio


def _write_y4m(path, ys, us, vs, colorspace):
    h, w = ys[0].shape
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F30:1 Ip A1:1 {colorspace}\n".encode())
        for y, u, v in zip(ys, us, vs):
            f.write(b"FRAME\n")
            for plane in (y, u, v):
                f.write(plane.astype(np.uint8).tobytes())


@pytest.mark.parametrize("colorspace,h,w", [
    ("C420jpeg", 16, 24), ("C420mpeg2", 15, 21), ("C444", 8, 12),
    ("C444", 7, 9)])
def test_y4m_frames_equal_the_reference(tmp_path, colorspace, h, w):
    rng = np.random.default_rng(0)
    ch, cw = ((h + 1) // 2, (w + 1) // 2) if colorspace.startswith("C420") \
        else (h, w)
    n = 3
    ys = [rng.integers(16, 236, (h, w)) for _ in range(n)]
    us = [rng.integers(16, 240, (ch, cw)) for _ in range(n)]
    vs = [rng.integers(16, 240, (ch, cw)) for _ in range(n)]
    p = str(tmp_path / "clip.y4m")
    _write_y4m(p, ys, us, vs, colorspace)
    a, b = fileio.open_video(p, loop=True), jfileio.open_video(p, loop=True)
    assert isinstance(a, fileio.Y4MVideo)
    assert (a.height, a.width, a.fps, a.colorspace, a.shape) == \
        (b.height, b.width, b.fps, b.colorspace, b.shape)
    ca, cb = a.clip(n + 2), b.clip(n + 2)   # wraps at the end
    assert ca.dtype == cb.dtype == np.float32
    assert ca.tobytes() == cb.tobytes()
    a.close()
    b.close()
    a = fileio.Y4MVideo(p)
    a.clip(n)
    with pytest.raises(EOFError):
        a.frame()
    a.close()


@pytest.mark.parametrize("kind", ["npy_float", "npy_uint8", "npz"])
def test_array_video_equals_the_reference(tmp_path, kind):
    rng = np.random.default_rng(1)
    clip = rng.random((5, 6, 10, 3), dtype=np.float32)
    if kind == "npy_uint8":
        clip = (clip * 255).astype(np.uint8)
    p = str(tmp_path / ("clip.npz" if kind == "npz" else "clip.npy"))
    if kind == "npz":
        np.savez(p, frames=clip)
    else:
        np.save(p, clip)
    a, b = fileio.open_video(p), jfileio.open_video(p)
    assert isinstance(a, fileio.ArrayVideo) and len(a) == len(b) == 5
    assert a.clip(5).tobytes() == b.clip(5).tobytes()
    with pytest.raises(EOFError):
        a.frame()


def test_same_errors_as_the_reference(tmp_path):
    bad = tmp_path / "bad.y4m"
    bad.write_bytes(b"NOTY4M W8 H8\n")
    c422 = tmp_path / "c422.y4m"
    c422.write_bytes(b"YUV4MPEG2 W8 H8 C422\n")
    for path in (bad, c422):
        with pytest.raises(ValueError) as e1:
            fileio.open_video(str(path))
        with pytest.raises(ValueError) as e2:
            jfileio.open_video(str(path))
        assert str(e1.value) == str(e2.value)
    with pytest.raises(ValueError, match="unsupported video container"):
        fileio.open_video(str(tmp_path / "x.mp4"))
    with pytest.raises(ValueError, match=r"expected \(T, H, W, 3\)"):
        fileio.ArrayVideo(np.zeros((2, 4, 4, 1), np.float32))


def test_write_y4m_round_trip_and_bytes(tmp_path):
    rng = np.random.default_rng(2)
    frames = rng.random((4, 9, 14, 3), dtype=np.float32)
    pa, pb = str(tmp_path / "a.y4m"), str(tmp_path / "b.y4m")
    fileio.write_y4m(pa, frames, fps=25)
    jfileio.write_y4m(pb, frames, fps=25)
    with open(pa, "rb") as fa, open(pb, "rb") as fb:
        assert fa.read() == fb.read()
    v = fileio.open_video(pa)
    assert (v.height, v.width, v.fps) == (9, 14, 25.0)
    back = v.clip(4)
    # BT.601 limited range, 8 bits: within a quantization step
    np.testing.assert_allclose(back, frames, atol=2.5 / 219)
    v.close()
    with pytest.raises(ValueError, match="frame shape"):
        fileio.write_y4m(str(tmp_path / "c.y4m"),
                         [frames[0], frames[0][:5]])
