"""Model registry of the port (the scene, seg and pose families of
``cbinfer_tpu.models``; the DAG ``models.pose.pose_graph`` is built by a
call of its own, not through the registry)."""

from typing import Callable, Dict, List

_REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_model(name: str, **kwargs) -> List:
    """Return the layer-spec chain for a named model."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


from . import pose, scene, seg  # noqa: E402,F401
