"""PQL abstract syntax tree.

Mirror of the reference's pql/ast.go: ``Query`` holds top-level ``Call``s;
a ``Call`` has a name, an args map, and child calls; BSI predicates are
``Condition`` values in the args map (ast.go:27,247,451).  Operator tokens
are plain strings (ast.go token.go:20-33).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

ASSIGN = "="
EQ = "=="
NEQ = "!="
LT = "<"
LTE = "<="
GT = ">"
GTE = ">="
BETWEEN = "><"


class Condition:
    """An operator + value used as an argument value (ast.go:451-458)."""

    __slots__ = ("op", "value")

    def __init__(self, op: str, value):
        self.op = op
        self.value = value

    def __eq__(self, other):
        return (
            isinstance(other, Condition)
            and self.op == other.op
            and self.value == other.value
        )

    def __repr__(self):
        return f"Condition({self.op!r}, {self.value!r})"

    def __str__(self):
        return f"{self.op} {format_value(self.value)}"

    def int_slice_value(self) -> List[int]:
        """ast.go IntSliceValue — the [lo, hi] of a BETWEEN."""
        if not isinstance(self.value, list):
            raise ValueError(f"expected list condition value, got {self.value!r}")
        return [int(v) for v in self.value]


class Call:
    """A function call node (ast.go:247-251)."""

    __slots__ = ("name", "args", "children")

    def __init__(
        self,
        name: str,
        args: Optional[Dict[str, object]] = None,
        children: Optional[List["Call"]] = None,
    ):
        self.name = name
        self.args = args if args is not None else {}
        self.children = children if children is not None else []

    # -- argument helpers (ast.go:256-360) ---------------------------------

    def field_arg(self) -> str:
        """The non-reserved key carrying field=row (ast.go FieldArg :256)."""
        for k in self.args:
            if not k.startswith("_"):
                return k
        raise ValueError("no field argument specified")

    def uint_arg(self, key: str) -> Tuple[int, bool]:
        val = self.args.get(key)
        if val is None:
            return 0, False
        if isinstance(val, bool) or not isinstance(val, int):
            raise ValueError(f"could not convert {val!r} to uint in arg {key!r}")
        return int(val), True

    def int_arg(self, key: str) -> Tuple[int, bool]:
        return self.uint_arg(key)

    def bool_arg(self, key: str) -> Tuple[bool, bool]:
        val = self.args.get(key)
        if val is None:
            return False, False
        if not isinstance(val, bool):
            raise ValueError(f"could not convert {val!r} to bool in arg {key!r}")
        return val, True

    def uint_slice_arg(self, key: str) -> Tuple[List[int], bool]:
        val = self.args.get(key)
        if val is None:
            return [], False
        if not isinstance(val, list):
            raise ValueError(f"unexpected type for slice arg {key!r}: {val!r}")
        out = []
        for v in val:
            if isinstance(v, bool) or not isinstance(v, int):
                raise ValueError(f"unexpected value in slice arg {key!r}: {v!r}")
            out.append(int(v))
        return out, True

    def call_arg(self, key: str) -> Optional["Call"]:
        val = self.args.get(key)
        if val is None:
            return None
        if not isinstance(val, Call):
            raise ValueError(f"expected call for arg {key!r}, got {val!r}")
        return val

    def has_condition_arg(self) -> bool:
        return any(isinstance(v, Condition) for v in self.args.values())

    def clone(self) -> "Call":
        return Call(
            self.name,
            dict(self.args),
            [c.clone() for c in self.children],
        )

    def __eq__(self, other):
        return (
            isinstance(other, Call)
            and self.name == other.name
            and self.args == other.args
            and self.children == other.children
        )

    def __repr__(self):
        return f"Call({self.name!r}, args={self.args!r}, children={self.children!r})"

    def __str__(self):
        """Canonical serialization (ast.go String :392) — children first,
        then args in key order — reparseable for remote execution."""
        parts = [str(c) for c in self.children]
        for k in sorted(self.args):
            v = self.args[k]
            if isinstance(v, Condition):
                parts.append(f"{k} {v}")
            else:
                parts.append(f"{k}={format_value(v)}")
        return f"{self.name}({', '.join(parts)})"


class Query:
    __slots__ = ("calls",)

    def __init__(self, calls: Optional[List[Call]] = None):
        self.calls = calls if calls is not None else []

    def write_call_n(self) -> int:
        """Number of mutating calls (ast.go WriteCallN :218)."""
        return sum(
            1
            for c in self.calls
            if c.name in ("Set", "Clear", "SetRowAttrs", "SetColumnAttrs")
        )

    def __eq__(self, other):
        return isinstance(other, Query) and self.calls == other.calls

    def __repr__(self):
        return f"Query({self.calls!r})"

    def __str__(self):
        return "\n".join(str(c) for c in self.calls)


def format_value(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, list):
        return "[" + ",".join(format_value(x) for x in v) + "]"
    if isinstance(v, Call):
        return str(v)
    return str(v)
