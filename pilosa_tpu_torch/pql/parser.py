"""PQL parser — recursive descent over the reference PEG grammar.

Hand-written equivalent of the generated parser (pql/pql.peg:8-84,
pql/pql.peg.go): the same productions, implemented with explicit
backtracking where the PEG relies on ordered choice (Range's
timerange / conditional / arg, Set's trailing timestamp).
"""

from __future__ import annotations

import re

from .ast import ASSIGN, BETWEEN, EQ, GT, GTE, LT, LTE, NEQ, Call, Condition, Query

_IDENT_RE = re.compile(r"[A-Za-z][A-Za-z0-9]*")
_FIELD_RE = re.compile(r"[A-Za-z][A-Za-z0-9_-]*")
_RESERVED_FIELDS = ("_row", "_col", "_start", "_end", "_timestamp", "_field")
_UINT_RE = re.compile(r"0|[1-9][0-9]*")
_INT_RE = re.compile(r"-?(?:0|[1-9][0-9]*)")
_NUM_RE = re.compile(r"-?(?:[0-9]+(?:\.[0-9]*)?|\.[0-9]+)")
# A bare word value: letters/digits/dash/underscore/colon (pql.peg item :50).
_WORD_RE = re.compile(r"[A-Za-z0-9\-_:]+")
_TIMESTAMP_RE = re.compile(
    r"[0-9]{4}-[01][0-9]-[0-3][0-9]T[0-9]{2}:[0-9]{2}"
)
# Longest-match order matters: '><' and two-char ops before '<' / '>'.
_COND_OPS = [("><", BETWEEN), ("<=", LTE), (">=", GTE), ("==", EQ), ("!=", NEQ), ("<", LT), (">", GT)]


class ParseError(Exception):
    def __init__(self, msg: str, pos: int = -1, src: str = ""):
        if pos >= 0:
            line = src.count("\n", 0, pos) + 1
            col = pos - (src.rfind("\n", 0, pos) + 1) + 1
            msg = f"{msg} at line {line}, col {col}"
        super().__init__(msg)


class _Parser:
    def __init__(self, src: str):
        self.src = src
        self.pos = 0

    # -- low-level ---------------------------------------------------------

    def error(self, msg: str):
        raise ParseError(msg, self.pos, self.src)

    def sp(self):
        while self.pos < len(self.src) and self.src[self.pos] in " \t\n\r":
            self.pos += 1

    def eof(self) -> bool:
        return self.pos >= len(self.src)

    def peek(self, s: str) -> bool:
        return self.src.startswith(s, self.pos)

    def accept(self, s: str) -> bool:
        if self.peek(s):
            self.pos += len(s)
            return True
        return False

    def expect(self, s: str):
        if not self.accept(s):
            self.error(f"expected {s!r}")

    def match(self, regex: re.Pattern):
        m = regex.match(self.src, self.pos)
        if m is None:
            return None
        self.pos = m.end()
        return m.group(0)

    def comma(self) -> bool:
        save = self.pos
        self.sp()
        if self.accept(","):
            self.sp()
            return True
        self.pos = save
        return False

    # -- entry -------------------------------------------------------------

    def parse(self) -> Query:
        calls = []
        self.sp()
        while not self.eof():
            calls.append(self.call())
            self.sp()
        return Query(calls)

    # -- calls (pql.peg Call :9-18) ----------------------------------------

    def call(self) -> Call:
        name = self.match(_IDENT_RE)
        if name is None:
            self.error("expected call name")
        handler = {
            "Set": self._set_call,
            "SetRowAttrs": self._set_row_attrs_call,
            "SetColumnAttrs": self._set_column_attrs_call,
            "Clear": self._clear_call,
            "ClearRow": self._clear_row_call,
            "Store": self._store_call,
            "TopN": self._topn_call,
            "Range": self._range_call,
        }.get(name)
        call = Call(name)
        self.sp()
        self.expect("(")
        self.sp()
        if handler is not None:
            # PEG ordered choice: if the special positional form fails —
            # including failing to reach the closing paren, as when
            # re-parsing the canonical serialization "Set(_col=2, f=10)" —
            # backtrack to the generic allargs production.
            save = self.pos
            try:
                handler(call)
                self.sp()
                self.expect(")")
            except ParseError:
                self.pos = save
                call.args.clear()
                call.children.clear()
                self._allargs(call)
                self.comma()
                self.sp()
                self.expect(")")
        else:
            self._allargs(call)
            self.comma()
            self.sp()
            self.expect(")")
        self.sp()
        return call

    def _set_call(self, call: Call):
        """Set(col, field=row[, timestamp])"""
        self._col(call)
        if not self.comma():
            self.error("expected ',' in Set()")
        self._args(call)
        save = self.pos
        if self.comma():
            ts = self._timestampfmt()
            if ts is None:
                self.pos = save
            else:
                call.args["_timestamp"] = ts

    def _set_row_attrs_call(self, call: Call):
        """SetRowAttrs(field, row, attrs...)"""
        f = self.match(_FIELD_RE)
        if f is None:
            self.error("expected field in SetRowAttrs()")
        call.args["_field"] = f
        if not self.comma():
            self.error("expected ',' in SetRowAttrs()")
        self._row(call)
        if not self.comma():
            self.error("expected ',' in SetRowAttrs()")
        self._args(call)

    def _set_column_attrs_call(self, call: Call):
        self._col(call)
        if not self.comma():
            self.error("expected ',' in SetColumnAttrs()")
        self._args(call)

    def _clear_call(self, call: Call):
        self._col(call)
        if not self.comma():
            self.error("expected ',' in Clear()")
        self._args(call)

    def _clear_row_call(self, call: Call):
        self._arg(call)

    def _store_call(self, call: Call):
        call.children.append(self.call())
        if not self.comma():
            self.error("expected ',' in Store()")
        self._arg(call)

    def _topn_call(self, call: Call):
        f = self.match(_FIELD_RE)
        if f is None:
            self.error("expected field in TopN()")
        call.args["_field"] = f
        if self.comma():
            self._allargs(call)

    def _range_call(self, call: Call):
        """Range(timerange / conditional / arg) — PEG ordered choice with
        explicit backtracking."""
        for alt in (self._timerange, self._conditional, self._arg):
            save = self.pos
            args_save = dict(call.args)
            try:
                alt(call)
                return
            except ParseError:
                self.pos = save
                call.args = args_save
        self.error("invalid Range() argument")

    # -- argument productions ---------------------------------------------

    def _allargs(self, call: Call):
        """allargs <- Call (comma Call)* (comma args)? / args / sp"""
        self.sp()
        if self._at_call():
            call.children.append(self.call())
            while True:
                save = self.pos
                if not self.comma():
                    break
                if self._at_call():
                    call.children.append(self.call())
                else:
                    self._args(call)
                    break
                continue
            # mop-up: the loop breaks with pos after the last parsed unit
            if not call.children:
                self.pos = save
        elif self._at_arg():
            self._args(call)

    def _at_call(self) -> bool:
        save = self.pos
        name = self.match(_IDENT_RE)
        ok = name is not None
        if ok:
            self.sp()
            ok = self.peek("(")
        self.pos = save
        return ok

    def _at_arg(self) -> bool:
        if any(self.peek(r) for r in _RESERVED_FIELDS):
            return True
        save = self.pos
        ok = self.match(_FIELD_RE) is not None
        self.pos = save
        return ok

    def _args(self, call: Call):
        """args <- arg (comma args)? sp"""
        self._arg(call)
        while True:
            save = self.pos
            if not self.comma():
                break
            if not self._at_arg():
                self.pos = save
                break
            # A nested call can't start an arg; check it's field = / COND.
            try:
                self._arg(call)
            except ParseError:
                self.pos = save
                break
        self.sp()

    def _arg(self, call: Call):
        """arg <- field '=' value / field COND value"""
        field = self._field()
        self.sp()
        op = None
        for text, tok in _COND_OPS:
            if self.accept(text):
                op = tok
                break
        if op is None:
            if self.accept("="):
                op = ASSIGN
            else:
                self.error("expected '=' or condition operator")
        self.sp()
        value = self._value()
        if op == ASSIGN:
            call.args[field] = value
        else:
            call.args[field] = Condition(op, value)

    def _field(self) -> str:
        for r in _RESERVED_FIELDS:
            if self.peek(r):
                self.pos += len(r)
                return r
        f = self.match(_FIELD_RE)
        if f is None:
            self.error("expected field name")
        return f

    def _col(self, call: Call):
        v = self._uint_or_quoted()
        call.args["_col"] = v

    def _row(self, call: Call):
        v = self._uint_or_quoted()
        call.args["_row"] = v

    def _uint_or_quoted(self):
        u = self.match(_UINT_RE)
        if u is not None:
            return int(u)
        s = self._quoted_string()
        if s is None:
            self.error("expected integer or quoted string")
        return s

    def _quoted_string(self):
        if self.accept('"'):
            return self._string_until('"')
        if self.accept("'"):
            return self._string_until("'")
        return None

    def _string_until(self, quote: str) -> str:
        out = []
        while self.pos < len(self.src):
            ch = self.src[self.pos]
            if ch == "\\" and self.pos + 1 < len(self.src):
                nxt = self.src[self.pos + 1]
                if nxt in (quote, "\\"):
                    out.append(nxt)
                    self.pos += 2
                    continue
            if ch == quote:
                self.pos += 1
                return "".join(out)
            out.append(ch)
            self.pos += 1
        self.error(f"unterminated string (expected {quote})")

    # -- Range alternatives ------------------------------------------------

    def _timerange(self, call: Call):
        """timerange <- field '=' value comma ts comma ts (pql.peg:36)"""
        field = self._field()
        self.sp()
        self.expect("=")
        self.sp()
        value = self._value()
        if not self.comma():
            self.error("expected ',' in time range")
        start = self._timestampfmt()
        if start is None:
            self.error("expected start timestamp")
        if not self.comma():
            self.error("expected ',' in time range")
        end = self._timestampfmt()
        if end is None:
            self.error("expected end timestamp")
        call.args[field] = value
        call.args["_start"] = start
        call.args["_end"] = end

    def _conditional(self, call: Call):
        """conditional <- int <[=] field <[=] int  (pql.peg:31-34), with
        the reference's exact bound adjustment (ast.go endConditional :82):
        low++ when the first op is '<', high++ when the second is '<='."""
        lo = self.match(_INT_RE)
        if lo is None:
            self.error("expected integer")
        self.sp()
        op1 = "<=" if self.accept("<=") else ("<" if self.accept("<") else None)
        if op1 is None:
            self.error("expected '<' or '<='")
        self.sp()
        field = self.match(_FIELD_RE)
        if field is None:
            self.error("expected field")
        self.sp()
        op2 = "<=" if self.accept("<=") else ("<" if self.accept("<") else None)
        if op2 is None:
            self.error("expected '<' or '<='")
        self.sp()
        hi = self.match(_INT_RE)
        if hi is None:
            self.error("expected integer")
        low, high = int(lo), int(hi)
        if op1 == "<":
            low += 1
        if op2 == "<=":
            high += 1
        call.args[field] = Condition(BETWEEN, [low, high])

    def _timestampfmt(self):
        save = self.pos
        q = None
        if self.accept('"'):
            q = '"'
        elif self.accept("'"):
            q = "'"
        ts = self.match(_TIMESTAMP_RE)
        if ts is None:
            self.pos = save
            return None
        if q is not None and not self.accept(q):
            self.pos = save
            return None
        return ts

    # -- values ------------------------------------------------------------

    def _value(self):
        if self.accept("["):
            self.sp()
            out = []
            if not self.peek("]"):
                while True:
                    out.append(self._item())
                    if not self.comma():
                        break
            self.sp()
            self.expect("]")
            self.sp()
            return out
        return self._item()

    def _item(self):
        """item (pql.peg:42-51), honoring the PEG's ordered choice."""
        # null/true/false only match when followed by a delimiter.
        for lit, val in (("null", None), ("true", True), ("false", False)):
            if self.peek(lit):
                end = self.pos + len(lit)
                rest = self.src[end:].lstrip(" \t\n")
                if rest[:1] in (",", ")", "]", ""):
                    self.pos = end
                    return val
        num = self.match(_NUM_RE)
        if num is not None:
            # Bare words may start with digits (e.g. time strings like
            # 2010-01-01 or ids with colons); if word chars follow, re-parse
            # as a word.
            if not _WORD_RE.match(self.src[self.pos : self.pos + 1] or " "):
                return float(num) if "." in num else int(num)
            self.pos -= len(num)
        if self._at_call():
            return self.call()
        word = self.match(_WORD_RE)
        if word is not None:
            return word
        s = self._quoted_string()
        if s is not None:
            return s
        self.error("expected value")


def parse(src: str) -> Query:
    """Parse a PQL query string into a Query AST."""
    return _Parser(src).parse()
