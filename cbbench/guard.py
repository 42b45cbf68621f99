"""What the benchmark must never load: the JAX package and JAX itself.
Modules are compared by their top-level name (the part before the first
dot) as a whole, since the port's name begins with the JAX package's."""

from __future__ import annotations

from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "cbinfer_tpu")
# the plain reference must not load the program either
FORBIDDEN_IN_REFERENCE = FORBIDDEN + ("cbinfer_tpu_torch",)


def forbidden_modules(names: Iterable[str],
                      forbidden=FORBIDDEN) -> List[str]:
    """The names among ``names`` whose top-level name is forbidden."""
    return sorted(n for n in names if n.split(".", 1)[0] in forbidden)
