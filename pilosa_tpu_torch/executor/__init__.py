from .executor import (
    Error,
    Executor,
    FieldNotFoundError,
    IndexNotFoundError,
    QueryResponse,
)

__all__ = [
    "Error",
    "Executor",
    "FieldNotFoundError",
    "IndexNotFoundError",
    "QueryResponse",
]
