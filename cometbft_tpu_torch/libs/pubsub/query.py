"""Query language for event subscriptions.

Ported from cometbft_tpu/libs/pubsub/query.py.

Reference: libs/pubsub/query (PEG grammar query.peg) — e.g.
``tm.event='NewBlock' AND tx.height > 5``. Supported operators:
``=``, ``<``, ``<=``, ``>``, ``>=``, ``CONTAINS``, ``EXISTS``, combined with
``AND``. Values: single-quoted strings, numbers, dates (DATE/TIME prefixes).

Matching semantics follow the reference: a condition on tag T matches if ANY
value indexed under T satisfies it (events are multi-valued maps
tag -> [values]); numeric comparisons coerce the event value to a number and
fail the condition on parse failure.
"""

from __future__ import annotations

import datetime as _dt
import re
from typing import Dict, List, Sequence, Tuple

OP_EQ = "="
OP_LT = "<"
OP_LE = "<="
OP_GT = ">"
OP_GE = ">="
OP_CONTAINS = "CONTAINS"
OP_EXISTS = "EXISTS"

_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<and>AND\b)
      | (?P<contains>CONTAINS\b)
      | (?P<exists>EXISTS\b)
      | (?P<op><=|>=|=|<|>)
      | (?P<string>'(?:[^'])*')
      | (?P<datetime>DATE\s+\d{4}-\d{2}-\d{2}|TIME\s+\S+)
      | (?P<number>-?\d+(?:\.\d+)?)
      | (?P<tag>[A-Za-z_][A-Za-z0-9_.\-]*)
    )""",
    re.VERBOSE,
)


class Condition:
    def __init__(self, tag: str, op: str, operand):
        self.tag = tag
        self.op = op
        self.operand = operand

    def __repr__(self):
        return f"Condition({self.tag!r} {self.op} {self.operand!r})"

    def matches(self, events: Dict[str, Sequence[str]]) -> bool:
        if self.op == OP_EXISTS:
            return self.tag in events
        values = events.get(self.tag)
        if values is None:
            return False
        for v in values:
            if self._match_value(v):
                return True
        return False

    def _match_value(self, value: str) -> bool:
        op, operand = self.op, self.operand
        if op == OP_CONTAINS:
            return operand in value
        if isinstance(operand, (int, float)):
            try:
                num = float(value)
            except ValueError:
                return False
            opf = float(operand)
            if op == OP_EQ:
                return num == opf
            if op == OP_LT:
                return num < opf
            if op == OP_LE:
                return num <= opf
            if op == OP_GT:
                return num > opf
            if op == OP_GE:
                return num >= opf
            return False
        if isinstance(operand, _dt.datetime):
            try:
                ts = _parse_time(value)
            except ValueError:
                return False
            if op == OP_EQ:
                return ts == operand
            if op == OP_LT:
                return ts < operand
            if op == OP_LE:
                return ts <= operand
            if op == OP_GT:
                return ts > operand
            if op == OP_GE:
                return ts >= operand
            return False
        # string operand: only equality defined
        if op == OP_EQ:
            return value == operand
        return False


def _parse_time(s: str) -> _dt.datetime:
    s = s.strip()
    for fmt in ("%Y-%m-%dT%H:%M:%S.%f%z", "%Y-%m-%dT%H:%M:%S%z", "%Y-%m-%d"):
        try:
            dt = _dt.datetime.strptime(s.replace("Z", "+0000"), fmt)
            if dt.tzinfo is None:
                dt = dt.replace(tzinfo=_dt.timezone.utc)
            return dt
        except ValueError:
            continue
    raise ValueError(f"unparseable time {s!r}")


class Query:
    """Conjunction of conditions."""

    def __init__(self, source: str, conditions: List[Condition]):
        self._source = source
        self.conditions = conditions

    def __str__(self) -> str:
        return self._source

    def __eq__(self, other) -> bool:
        return isinstance(other, Query) and str(self) == str(other)

    def __hash__(self) -> int:
        return hash(str(self))

    def matches(self, events: Dict[str, Sequence[str]]) -> bool:
        if not events:
            return False
        return all(c.matches(events) for c in self.conditions)


class Empty(Query):
    """Matches everything (reference: libs/pubsub/query.Empty)."""

    def __init__(self):
        super().__init__("empty", [])

    def matches(self, events: Dict[str, Sequence[str]]) -> bool:
        return True


def parse_query(s: str) -> Query:
    tokens = _tokenize(s)
    conds: List[Condition] = []
    i = 0
    while i < len(tokens):
        kind, val = tokens[i]
        if kind != "tag":
            raise ValueError(f"expected tag at token {i} in {s!r}, got {val!r}")
        tag = val
        i += 1
        if i >= len(tokens):
            raise ValueError(f"query {s!r} ends after tag")
        kind, val = tokens[i]
        if kind == "exists":
            conds.append(Condition(tag, OP_EXISTS, None))
            i += 1
        elif kind in ("op", "contains"):
            op = OP_CONTAINS if kind == "contains" else val
            i += 1
            if i >= len(tokens):
                raise ValueError(f"query {s!r} ends after operator")
            vkind, vval = tokens[i]
            operand = _parse_operand(vkind, vval)
            if op == OP_CONTAINS and not isinstance(operand, str):
                raise ValueError("CONTAINS requires a string operand")
            conds.append(Condition(tag, op, operand))
            i += 1
        else:
            raise ValueError(f"expected operator after tag {tag!r} in {s!r}")
        if i < len(tokens):
            kind, val = tokens[i]
            if kind != "and":
                raise ValueError(f"expected AND at token {i} in {s!r}")
            i += 1
            if i >= len(tokens):
                raise ValueError(f"query {s!r} ends after AND")
    return Query(s, conds)


def _parse_operand(kind: str, val: str):
    if kind == "string":
        return val[1:-1]
    if kind == "number":
        return float(val) if "." in val else int(val)
    if kind == "datetime":
        return _parse_time(val.split(None, 1)[1])
    raise ValueError(f"bad operand token {val!r}")


def _tokenize(s: str) -> List[Tuple[str, str]]:
    tokens: List[Tuple[str, str]] = []
    pos = 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if not m or m.end() == pos:
            if s[pos:].strip() == "":
                break
            raise ValueError(f"cannot tokenize query at {s[pos:]!r}")
        pos = m.end()
        for name in ("and", "contains", "exists", "op", "string", "datetime", "number", "tag"):
            v = m.group(name)
            if v is not None:
                tokens.append((name, v))
                break
    return tokens
