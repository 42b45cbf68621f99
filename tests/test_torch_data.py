"""The port's host-side frame sources against the JAX package's ``data``:
the native generator (the package's own copy of ``framegen.cpp``, built
with g++ into build/native/) gives the reference's bytes for the same
config and seed; ``PrefetchingSource`` overlaps and ends a finite source;
``make_video`` picks the native source or the NumPy one."""

import shutil

import numpy as np
import pytest

from cbinfer_tpu import data as jdata
from cbinfer_tpu import fileio as jfileio
from cbinfer_tpu import video as jvideo

from cbinfer_tpu_torch import data, fileio, video


@pytest.fixture(scope="module")
def native():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the frame generator")
    assert data.native_available()
    return data


def test_the_generator_source_is_the_reference_copy():
    with open(jdata._NATIVE_DIR + "/framegen.cpp", "rb") as f:
        assert data.SOURCE.read_bytes() == f.read()
    assert data.BUILD_DIR.parts[-2:] == ("build", "native")


@pytest.mark.parametrize("kw", [
    dict(height=64, width=96, n_sprites=2, sprite_size=8, speed=3.0, seed=1),
    dict(height=36, width=64, n_sprites=5, sprite_size=12, speed=6.0,
         noise_std=0.002, seed=11),
    dict(height=16, width=24, channels=1, n_sprites=0, seed=0)])
def test_native_frames_are_the_references_bytes(native, kw):
    if not jdata.native_available():
        pytest.skip("the reference's generator did not build")
    port = data.NativeSpriteVideo(video.SpriteVideoConfig(**kw))
    ref = jdata.NativeSpriteVideo(jvideo.SpriteVideoConfig(**kw))
    a, b = port.clip(5), ref.clip(5)
    assert a.shape == b.shape and a.dtype == np.float32
    assert a.tobytes() == b.tobytes()
    # frame() renders and advances, as the reference's does
    assert port.frame().tobytes() == ref.frame().tobytes()
    assert port.frame_index == 6


def test_native_frames_valid_and_temporal(native):
    cfg = video.SpriteVideoConfig(height=64, width=96, n_sprites=2,
                                  sprite_size=8, speed=3.0, seed=1)
    clip = data.NativeSpriteVideo(cfg).clip(6)
    assert clip.shape == (6, 64, 96, 3) and clip.dtype == np.float32
    assert 0.0 <= clip.min() and clip.max() <= 1.0 + 1e-5
    changed = (np.abs(clip[1] - clip[0]).max(-1) > 1e-6).mean()
    assert 0 < changed < 0.2
    np.testing.assert_array_equal(data.NativeSpriteVideo(cfg).clip(6), clip)


def test_prefetching_source_over_the_native_generator(native):
    cfg = video.SpriteVideoConfig(height=32, width=32, n_sprites=1,
                                  sprite_size=4)
    src = data.PrefetchingSource(data.NativeSpriteVideo(cfg), depth=2)
    try:
        frames = [next(src) for _ in range(8)]
    finally:
        src.close()
    assert len(frames) == 8 and src.served == 8
    assert 0 <= src.waited <= 8
    assert not np.array_equal(frames[0], frames[4])
    assert not src._thread.is_alive()
    # the same frames, in order, as the generator alone gives
    np.testing.assert_array_equal(np.stack(frames),
                                  data.NativeSpriteVideo(cfg).clip(8))


def test_prefetching_source_drains_a_finite_file_to_stop_iteration(tmp_path):
    clip = video.SpriteVideo(video.SpriteVideoConfig(
        height=16, width=24, seed=2)).clip(5)
    path = str(tmp_path / "clip.npy")
    np.save(path, clip)
    with data.PrefetchingSource(fileio.open_video(path), depth=2) as src:
        got = list(src)
    assert len(got) == 5 and src.served == 6
    np.testing.assert_array_equal(np.stack(got), clip)
    ref = jdata.PrefetchingSource(jfileio.open_video(path), depth=2)
    try:
        np.testing.assert_array_equal(np.stack(list(ref)), clip)
    finally:
        ref.close()


def test_make_video_interface(native):
    cfg = video.SpriteVideoConfig(height=16, width=16)
    v = data.make_video(cfg, prefer_native=False)
    assert isinstance(v, video.SpriteVideo)
    ref = jdata.make_video(jvideo.SpriteVideoConfig(height=16, width=16),
                           prefer_native=False)
    assert v.clip(2).tobytes() == ref.clip(2).tobytes()
    n = data.make_video(cfg)
    assert isinstance(n, data.NativeSpriteVideo)
    assert n.clip(2).shape == (2, 16, 16, 3)
