"""Node assembly (ref: node/).

A copy of the JAX package's node/: Node (its verifying layers on the card
unless device="cpu"), NodeKey, the home's files and the seed node."""

from .node import Node, NodeKey
from .setup import init_files_home

__all__ = ["Node", "NodeKey", "init_files_home"]
