"""Carrying caches across between the two packages, for the tests that
compare state. A stem cache: the JAX package keeps the accepted stem input
as a rank-2 "flat4" buffer (4 lanes per pixel, 128-lane rows, 8-row
margins), the port as the padded HWC storage of the stem's (8, 32)-tile
geometry. Every other cache: the JAX package's ``"pallas"`` backend stores
channels padded to 128 lanes (zeros), the port at their logical width, with
the same spatial layout.
"""

import numpy as np

from cbinfer_tpu.ops.flat4 import CP


def storage_from_flat4(f4, fg, g) -> np.ndarray:
    """Reference flat4 cache ``(fg.fh, fg.fl)`` -> the port's padded HWC
    stem storage for geometry ``g`` (zero margins), same dtype."""
    v = np.asarray(f4).reshape(fg.fh, fg.fl // CP, CP)
    st = np.zeros(g.store_shape, v.dtype)
    st[g.store_lo_h:g.store_lo_h + fg.h,
       g.store_lo_w:g.store_lo_w + fg.w] = v[1:1 + fg.h, 1:1 + fg.w, :fg.cin]
    return st


def storage_to_flat4(storage, fg, g) -> np.ndarray:
    """The port's stem storage -> the reference's flat4 layout (margins
    and the c >= cin lane slots zero), same dtype."""
    storage = np.asarray(storage)
    v = np.zeros((fg.fh, fg.fl // CP, CP), storage.dtype)
    v[1:1 + fg.h, 1:1 + fg.w, :fg.cin] = storage[
        g.store_lo_h:g.store_lo_h + fg.h, g.store_lo_w:g.store_lo_w + fg.w]
    return v.reshape(fg.fh, fg.fl)


def cache_from_lanes(arr, c: int) -> np.ndarray:
    """A reference cache ``(h, w, lane-padded c)`` -> the port's
    ``(h, w, c)``: a crop of the channel dim (the pad lanes carry the
    margins' fill and, inside the map, zeros once a frame was accepted)."""
    arr = np.asarray(arr)
    assert arr.shape[-1] >= c, (arr.shape, c)
    return np.ascontiguousarray(arr[..., :c])


def cache_to_lanes(arr) -> np.ndarray:
    """The port's ``(h, w, c)`` cache -> the reference's lane-padded
    ``(h, w, roundup(c, 128))`` with zero pad lanes."""
    arr = np.asarray(arr)
    return np.pad(arr, ((0, 0), (0, 0), (0, -arr.shape[-1] % 128)))
