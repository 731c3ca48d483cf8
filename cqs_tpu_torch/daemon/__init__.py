"""Daemon surfaces: socket server, watch loop, batch mode, MCP bridge."""

from cqs_tpu_torch.daemon.client import ping, request  # noqa: F401
from cqs_tpu_torch.daemon.dispatch import BatchContext  # noqa: F401
from cqs_tpu_torch.daemon.server import DaemonServer  # noqa: F401
