from .executor import (
    ColumnAttrSet,
    Error,
    ExecOptions,
    Executor,
    FieldNotFoundError,
    FieldRow,
    GroupCount,
    IndexNotFoundError,
    QueryResponse,
    RowIdentifiers,
    ValCount,
)

__all__ = [
    "ColumnAttrSet",
    "Error",
    "ExecOptions",
    "Executor",
    "FieldNotFoundError",
    "FieldRow",
    "GroupCount",
    "IndexNotFoundError",
    "QueryResponse",
    "RowIdentifiers",
    "ValCount",
]
