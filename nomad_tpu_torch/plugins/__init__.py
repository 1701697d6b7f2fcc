"""External plugin framework (reference: plugins/ + go-plugin).

A copy of the reference's `nomad_tpu/plugins/`, importing the port.  The
handshake line, the magic-cookie key and value, the socket variable and
the length-prefixed JSON frames are the reference's byte for byte, so a
plugin of either package speaks to a host of the other.  A plugin
process imports this package, `structs`, `client.drivers.base` and
`core.logging`, none of which imports torch: a plugin starts as fast as
an interpreter with numpy does."""

from .base import (  # noqa: F401
    MAGIC_COOKIE_KEY,
    MAGIC_COOKIE_VALUE,
    PluginClient,
    PluginError,
    launch_plugin,
    serve,
)
from .device import (  # noqa: F401
    DevicePlugin,
    ExternalDevicePlugin,
    serve_device,
)
from .driver import ExternalDriver, serve_driver  # noqa: F401
from .manager import PluginManager  # noqa: F401
