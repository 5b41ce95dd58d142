from .ast import (
    ASSIGN,
    BETWEEN,
    EQ,
    GT,
    GTE,
    LT,
    LTE,
    NEQ,
    Call,
    Condition,
    Query,
)
from .parser import ParseError, parse

__all__ = [
    "ASSIGN",
    "BETWEEN",
    "EQ",
    "GT",
    "GTE",
    "LT",
    "LTE",
    "NEQ",
    "Call",
    "Condition",
    "ParseError",
    "Query",
    "parse",
]
