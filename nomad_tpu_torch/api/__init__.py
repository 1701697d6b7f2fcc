"""HTTP API + Python SDK (reference: command/agent/http.go + api/)."""

from .http_server import HTTPAPIServer  # noqa: F401
from .client import APIClient  # noqa: F401
