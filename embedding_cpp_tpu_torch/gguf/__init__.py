"""GGUF model files: constants, block codecs and the reader."""
from .constants import FTYPE_TO_GGML, QK4, GGMLType, GGUFFileType, Keys, ggml_nbytes
from .reader import GGUFReader

__all__ = [
    "FTYPE_TO_GGML",
    "GGMLType",
    "GGUFFileType",
    "GGUFReader",
    "Keys",
    "QK4",
    "ggml_nbytes",
]
