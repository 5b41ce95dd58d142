"""Query-layer key translation hooks.

The port's copy of ``pilosa_tpu/executor/translate.py`` (upstream Pilosa:
executor.go translateCalls/translateResults :2323-2589): before execution,
string keys in call args become ids (per-call arg naming rules, the bool
field's special case); after execution, Row columns, TopN pairs, GroupBy
rows and Rows ids become keys where the index or field has keys enabled.
Host work only: nothing here touches the card.
"""

from __future__ import annotations

from typing import List, Optional

from ..core.field import FIELD_TYPE_BOOL
from ..core.fragment import FALSE_ROW_ID, TRUE_ROW_ID
from ..core.row import Row
from ..pql import Call
from .executor import GroupCount, RowIdentifiers


class TranslateError(Exception):
    pass


class QueryTranslator:
    """Wraps a TranslateStore; plugged into Executor(translator=...)."""

    def __init__(self, store):
        self.store = store

    # -- call translation ---------------------------------------------------

    def translate_calls(self, index: str, idx, calls: List[Call]):
        for c in calls:
            self.translate_call(index, idx, c)

    def translate_call(self, index: str, idx, c: Call):
        col_key = row_key = field_name = ""
        name = c.name
        if name in ("Set", "Clear", "Row", "Range", "SetColumnAttrs"):
            col_key = "_col"
            try:
                field_name = c.field_arg()
            except ValueError:
                field_name = ""
            row_key = field_name
        elif name == "SetRowAttrs":
            row_key = "_row"
            field_name = c.args.get("_field") or ""
        elif name == "Rows":
            field_name = c.args.get("field") or ""
            row_key = "previous"
            col_key = "column"
        elif name == "GroupBy":
            return self._translate_group_by(index, idx, c)
        else:
            col_key = "col"
            field_name = c.args.get("field") or ""
            row_key = "row"

        if idx.keys:
            v = c.args.get(col_key)
            if v is not None and not isinstance(v, str):
                raise TranslateError(
                    "column value must be a string when index 'keys' option enabled"
                )
            if isinstance(v, str) and v:
                c.args[col_key] = self.store.translate_columns_to_uint64(
                    index, [v]
                )[0]
        else:
            if isinstance(c.args.get(col_key), str):
                raise TranslateError(
                    "string 'col' value not allowed unless index 'keys' option enabled"
                )

        if field_name:
            field = idx.field(field_name)
            if field is None:
                # Defer ErrFieldNotFound to execution (executor.go:2380).
                return
            if field.options.type == FIELD_TYPE_BOOL:
                v = c.args.get(row_key)
                if v is not None:
                    if not isinstance(v, bool):
                        # Strings and integers are invalid bool rows —
                        # executor_test.go:713-726 expects an error for
                        # both `f="true"` and `f=1`.
                        raise TranslateError("bool field rows must be true/false")
                    c.args[row_key] = TRUE_ROW_ID if v else FALSE_ROW_ID
            elif field.options.keys:
                v = c.args.get(row_key)
                if v is not None and not isinstance(v, str):
                    raise TranslateError(
                        "row value must be a string when field 'keys' option enabled"
                    )
                if isinstance(v, str) and v:
                    c.args[row_key] = self.store.translate_rows_to_uint64(
                        index, field_name, [v]
                    )[0]
            else:
                if isinstance(c.args.get(row_key), str):
                    raise TranslateError(
                        "string 'row' value not allowed unless field 'keys' option enabled"
                    )

        for child in c.children:
            self.translate_call(index, idx, child)

    def _translate_group_by(self, index: str, idx, c: Call):
        for child in c.children:
            self.translate_call(index, idx, child)
        prev = c.args.get("previous")
        if prev is None:
            return
        if not isinstance(prev, list):
            raise TranslateError("'previous' argument must be list")
        if len(c.children) != len(prev):
            raise TranslateError(
                f"mismatched lengths for previous: {len(prev)} "
                f"and children: {len(c.children)}"
            )
        for i, child in enumerate(c.children):
            field_name = child.args.get("field") or ""
            field = idx.field(field_name)
            if field is None:
                raise TranslateError(f"field not found: {field_name}")
            if field.options.keys:
                if not isinstance(prev[i], str):
                    raise TranslateError(
                        "prev value must be a string when field 'keys' option enabled"
                    )
                prev[i] = self.store.translate_rows_to_uint64(
                    index, field_name, [prev[i]]
                )[0]
            elif isinstance(prev[i], str):
                raise TranslateError(
                    f"got string row val in 'previous' for field {field_name} "
                    "which doesn't use string keys"
                )

    # -- result translation -------------------------------------------------

    def translate_results(self, index: str, idx, calls: List[Call], results: list):
        for i in range(len(results)):
            results[i] = self.translate_result(index, idx, calls[i], results[i])

    def translate_result(self, index: str, idx, call: Call, result):
        if isinstance(result, Row):
            if idx.keys:
                result.keys = self.store.translate_columns_to_strings(index, result.columns())
            return result
        if (
            isinstance(result, list)
            and result
            and isinstance(result[0], tuple)
            and call.name == "TopN"
        ):
            field_name = call.args.get("_field") or ""
            field = idx.field(field_name)
            if field is not None and field.options.keys:
                return [
                    (
                        self.store.translate_row_to_string(
                            index, field_name, row_id
                        ),
                        count,
                    )
                    for row_id, count in result
                ]
            return result
        if isinstance(result, list) and result and isinstance(result[0], GroupCount):
            for gc in result:
                for fr in gc.group:
                    field = idx.field(fr.field)
                    if field is not None and field.options.keys:
                        fr.row_key = self.store.translate_row_to_string(
                            index, fr.field, fr.row_id
                        )
            return result
        if call.name == "Rows" and isinstance(result, list):
            field_name = call.args.get("field") or ""
            field = idx.field(field_name)
            if field is None:
                raise TranslateError(f"field not found: {field_name}")
            if field.options.keys:
                return RowIdentifiers(
                    [],
                    [
                        self.store.translate_row_to_string(index, field_name, id)
                        for id in result
                    ],
                )
            return RowIdentifiers(list(result))
        return result

    # -- column attr translation (executor.go Execute :152-162) ------------

    def translate_column_to_string(self, index: str, id: int) -> str:
        return self.store.translate_column_to_string(index, id)
