"""Event query language (ref: internal/pubsub/query/query.go).

Grammar (query.go:1-13):
  condition   := tag OP operand
  query       := condition {" AND " condition}
  OP          := "=" | "<" | "<=" | ">" | ">=" | "CONTAINS" | "EXISTS"
  operand     := "'" string "'" | number | date | time

Example: tm.event = 'NewBlock' AND tx.height > 5
Events are flattened to {composite_key: [values]}; every condition must
match at least one value of its key (match-events semantics).
"""

from __future__ import annotations

import re
from dataclasses import dataclass


class QueryError(Exception):
    pass


_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<and>AND\b) |
        (?P<op><=|>=|=|<|>|CONTAINS\b|EXISTS\b) |
        (?P<str>'(?:[^'\\]|\\.)*') |
        (?P<num>-?\d+(?:\.\d+)?) |
        (?P<tag>[A-Za-z0-9_.\-/]+)
    )""",
    re.VERBOSE,
)


@dataclass(frozen=True)
class Condition:
    key: str
    op: str
    operand: object | None  # str | float | None (EXISTS)

    def matches(self, values: list[str]) -> bool:
        if self.op == "EXISTS":
            return True  # key present
        for v in values:
            if self._match_one(v):
                return True
        return False

    def _match_one(self, value: str) -> bool:
        op, operand = self.op, self.operand
        if op == "CONTAINS":
            return isinstance(operand, str) and operand in value
        if isinstance(operand, float):
            try:
                num = float(value)
            except ValueError:
                return False
            if op == "=":
                return num == operand
            if op == "<":
                return num < operand
            if op == "<=":
                return num <= operand
            if op == ">":
                return num > operand
            if op == ">=":
                return num >= operand
            return False
        # string comparisons: only equality is defined (query.go)
        if op == "=":
            return value == operand
        return False


class Query:
    """A compiled query (ref: query.go Query)."""

    def __init__(self, conditions: list[Condition], source: str):
        self.conditions = conditions
        self.source = source

    def __str__(self) -> str:
        return self.source

    def __eq__(self, other):
        return isinstance(other, Query) and self.source == other.source

    def __hash__(self):
        return hash(self.source)

    def matches(self, events: dict[str, list[str]]) -> bool:
        """True if every condition matches some value of its key
        (ref: query.go Matches)."""
        for cond in self.conditions:
            values = events.get(cond.key)
            if not values:
                return False
            if not cond.matches(values):
                return False
        return True


ALL = Query([], "tm.event EXISTS *")  # matches everything with any event key


class _EmptyQuery(Query):
    def matches(self, events) -> bool:
        return True


EMPTY = _EmptyQuery([], "empty")


def parse_query(s: str) -> Query:
    """ref: query.go New."""
    if not s or s.strip() == "":
        return EMPTY
    conditions: list[Condition] = []
    pos = 0
    expect = "tag"
    tag = op = None
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if m is None or m.end() == pos:
            if s[pos:].strip() == "":
                break
            raise QueryError(f"syntax error near position {pos}: {s[pos:pos+20]!r}")
        pos = m.end()
        if m.group("and"):
            if expect != "and":
                raise QueryError("unexpected AND")
            expect = "tag"
        elif m.group("op"):
            if expect != "op":
                raise QueryError(f"unexpected operator {m.group('op')!r}")
            op = m.group("op")
            if op == "EXISTS":
                conditions.append(Condition(tag, "EXISTS", None))
                expect = "and"
            else:
                expect = "operand"
        elif m.group("str"):
            if expect != "operand":
                raise QueryError("unexpected string literal")
            raw = m.group("str")[1:-1].replace("\\'", "'")
            conditions.append(Condition(tag, op, raw))
            expect = "and"
        elif m.group("num"):
            if expect == "operand":
                if op == "CONTAINS":
                    raise QueryError("CONTAINS requires a string operand")
                conditions.append(Condition(tag, op, float(m.group("num"))))
                expect = "and"
            elif expect == "tag":
                raise QueryError("condition must start with a tag")
            else:
                raise QueryError(f"unexpected number {m.group('num')}")
        elif m.group("tag"):
            if expect != "tag":
                raise QueryError(f"unexpected tag {m.group('tag')!r}")
            tag = m.group("tag")
            expect = "op"
    if expect != "and":
        raise QueryError(f"incomplete query: {s!r}")
    return Query(conditions, s)
