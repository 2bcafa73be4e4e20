"""The ABCI++ boundary (ref: abci/): the request and response types, the
Application interface, the in-process client and the kvstore example app."""

from .client import Client, LocalClient  # noqa: F401
from .types import Application, BaseApplication  # noqa: F401
