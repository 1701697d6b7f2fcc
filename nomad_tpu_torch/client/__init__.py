"""Client / node agent layer (reference: client/)."""

from .alloc_runner import AllocRunner
from .client import Client, InProcessRPC
from .drivers import BUILTIN_DRIVERS, new_driver_registry
from .fingerprint import FingerprintManager
from .restarts import RestartTracker
from .state import StateDB
from .task_runner import TaskRunner
