from .executor import (
    Error,
    Executor,
    FieldNotFoundError,
    FieldRow,
    GroupCount,
    IndexNotFoundError,
    QueryResponse,
    ValCount,
)

__all__ = [
    "Error",
    "Executor",
    "FieldNotFoundError",
    "FieldRow",
    "GroupCount",
    "IndexNotFoundError",
    "QueryResponse",
    "ValCount",
]
