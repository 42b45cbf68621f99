"""Carrying a stem cache across between the two packages, for the tests
that compare state: the JAX package keeps the accepted stem input as a
rank-2 "flat4" buffer (4 lanes per pixel, 128-lane rows, 8-row margins),
the port as the padded HWC storage of the stem's (8, 32)-tile geometry.
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
