"""Private validator (ref: privval/)."""

from .file_pv import DoubleSignError, FilePV, LastSignState  # noqa: F401
