from .executor import (
    Error,
    Executor,
    FieldNotFoundError,
    IndexNotFoundError,
    QueryResponse,
    ValCount,
)

__all__ = [
    "Error",
    "Executor",
    "FieldNotFoundError",
    "IndexNotFoundError",
    "QueryResponse",
    "ValCount",
]
