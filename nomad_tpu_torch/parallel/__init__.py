"""Node-axis sharding over a mesh of parts (reference: nomad_tpu/parallel)."""

from .mesh import (  # noqa: F401
    AXIS,
    Mesh,
    default_mesh,
    make_mesh,
    pad_nodes,
    place_sharded,
    place_sharded_packed,
)
