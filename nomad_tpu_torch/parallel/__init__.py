"""Node-axis sharding on one card (reference: nomad_tpu/parallel)."""

from .mesh import (  # noqa: F401
    AXIS,
    Mesh,
    make_mesh,
    pad_nodes,
    place_sharded,
    place_sharded_packed,
)
