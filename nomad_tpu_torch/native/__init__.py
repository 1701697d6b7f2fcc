"""Native CUDA bridge bindings (reference: nomad_tpu/native/__init__.py):
ctypes over the C-ABI library that csrc/bridge.cu builds into."""

from .bridge import (  # noqa: F401
    BridgeError,
    CudaBridge,
    PlainBridge,
    bridge_available,
    build_bridge,
)
