from .bitmap import Bitmap
from .codec import (
    CONTAINER_ARRAY,
    CONTAINER_BITMAP,
    CONTAINER_RUN,
    OP_TYPE_ADD,
    OP_TYPE_REMOVE,
    deserialize,
    encode_op,
    fnv1a32,
    serialize,
)

__all__ = [
    "Bitmap",
    "serialize",
    "deserialize",
    "encode_op",
    "fnv1a32",
    "CONTAINER_ARRAY",
    "CONTAINER_BITMAP",
    "CONTAINER_RUN",
    "OP_TYPE_ADD",
    "OP_TYPE_REMOVE",
]
