"""Stream parallelism (PyTorch port of ``cbinfer_tpu.parallel``;
BASELINE.json configs[4]).

Independent camera streams, each with its own state, over a mesh of
devices (a list of ``torch.device``s): parameters replicate once per
device, and nothing crosses devices inside a frame. ``dryrun_multistream``
drives the three forms on n streams, the twin of the JAX package's
``__graft_entry__.dryrun_multichip``.
"""

from .dryrun import dryrun_multistream  # noqa: F401
from .streams import (MultiStreamRunner, make_stream_mesh,  # noqa: F401
                      shard_streams)
