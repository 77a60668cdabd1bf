"""Expression evaluator over records (reference pkg/s3select/sql/
evaluate.go + aggregation.go): dynamic typing with implicit numeric
coercion (CSV fields are strings; comparisons against numeric literals
coerce when possible, matching the reference's inferInt/inferFloat).

The port's copy of minio_tpu/s3select/evaluate.py: the port imports
nothing of the JAX package, not even this pure-Python module.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

from .sql import (AGGREGATES, Between, Binary, Call, Cast, Col, In, IsNull,
                  Like, Lit, SQLError, Unary)


class Record:
    """One input record: CSV row (positional + named) or JSON value."""

    def __init__(self, values: list | None = None,
                 names: dict[str, int] | None = None,
                 obj: dict | None = None, alias: str = ""):
        self.values = values          # CSV: list of strings
        self.names = names or {}      # lowercase column name -> index
        self.obj = obj                # JSON: dict
        self.alias = alias.lower()

    def get(self, path: tuple[str, ...]):
        parts = list(path)
        if parts and parts[0].lower() in (self.alias, "s3object"):
            parts = parts[1:]
        if not parts:
            return self.obj if self.obj is not None else None
        if self.obj is not None:
            cur = self.obj
            for p in parts:
                if isinstance(cur, dict):
                    if p in cur:
                        cur = cur[p]
                        continue
                    lowered = {k.lower(): v for k, v in cur.items()}
                    if p.lower() in lowered:
                        cur = lowered[p.lower()]
                        continue
                    return None
                elif isinstance(cur, list):
                    try:
                        cur = cur[int(p)]
                    except (ValueError, IndexError):
                        return None
                else:
                    return None
            return cur
        (name,) = parts[:1]
        if len(parts) > 1:
            return None
        m = re.fullmatch(r"_(\d+)", name)
        if m:
            idx = int(m.group(1)) - 1
            if 0 <= idx < len(self.values):
                return self.values[idx]
            return None
        idx = self.names.get(name.lower())
        if idx is not None and idx < len(self.values):
            return self.values[idx]
        return None

    def all_columns(self) -> list:
        if self.obj is not None:
            return [self.obj]
        return list(self.values)


def _num(v):
    """Implicit numeric coercion; None when not numeric."""
    if isinstance(v, bool):
        return None
    if isinstance(v, (int, float)):
        return v
    if isinstance(v, str):
        s = v.strip()
        try:
            return int(s)
        except ValueError:
            try:
                return float(s)
            except ValueError:
                return None
    return None


def _coerce_pair(a, b):
    """Common comparison domain: numeric when both coerce, else strings."""
    na, nb = _num(a), _num(b)
    if na is not None and nb is not None:
        return na, nb
    if a is None or b is None:
        return a, b
    return str(a), str(b)


def _like_to_re(pattern: str, escape: str) -> re.Pattern:
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if escape and ch == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    return re.compile("".join(out) + r"\Z", re.DOTALL)


@dataclass
class AggState:
    count: int = 0
    sum: float = 0
    min: object = None
    max: object = None
    seen: int = 0


class Evaluator:
    def __init__(self):
        self.aggs: dict[int, AggState] = {}
        self._agg_id = 0

    # -- scalar evaluation ----------------------------------------------------

    def eval(self, node, rec: Record):
        if isinstance(node, Lit):
            return node.value
        if isinstance(node, Col):
            return rec.get(node.path)
        if isinstance(node, Unary):
            v = self.eval(node.operand, rec)
            if node.op == "not":
                return (not _truthy(v)) if v is not None else None
            n = _num(v)
            return -n if n is not None else None
        if isinstance(node, Binary):
            return self._binary(node, rec)
        if isinstance(node, IsNull):
            v = self.eval(node.operand, rec)
            isnull = v is None or v == ""
            return (not isnull) if node.negate else isnull
        if isinstance(node, Like):
            v = self.eval(node.operand, rec)
            pat = self.eval(node.pattern, rec)
            if v is None or pat is None:
                return False
            hit = _like_to_re(str(pat), node.escape).match(str(v)) is not None
            return (not hit) if node.negate else hit
        if isinstance(node, In):
            v = self.eval(node.operand, rec)
            hit = False
            for opt in node.options:
                a, b = _coerce_pair(v, self.eval(opt, rec))
                if a is not None and a == b:
                    hit = True
                    break
            return (not hit) if node.negate else hit
        if isinstance(node, Between):
            v = self.eval(node.operand, rec)
            lo = self.eval(node.lo, rec)
            hi = self.eval(node.hi, rec)
            a, l2 = _coerce_pair(v, lo)
            a2, h2 = _coerce_pair(v, hi)
            try:
                hit = a is not None and l2 is not None and h2 is not None \
                    and l2 <= a and a2 <= h2
            except TypeError:
                hit = False
            return (not hit) if node.negate else hit
        if isinstance(node, Cast):
            return self._cast(self.eval(node.operand, rec), node.to)
        if isinstance(node, Call):
            return self._call(node, rec)
        raise SQLError(f"cannot evaluate {node!r}")

    def _binary(self, node: Binary, rec: Record):
        if node.op == "and":
            return _truthy(self.eval(node.left, rec)) and \
                _truthy(self.eval(node.right, rec))
        if node.op == "or":
            return _truthy(self.eval(node.left, rec)) or \
                _truthy(self.eval(node.right, rec))
        lv = self.eval(node.left, rec)
        rv = self.eval(node.right, rec)
        if node.op in ("=", "!=", "<", "<=", ">", ">="):
            a, b = _coerce_pair(lv, rv)
            if a is None or b is None:
                return False
            try:
                res = {"=": a == b, "!=": a != b, "<": a < b,
                       "<=": a <= b, ">": a > b, ">=": a >= b}[node.op]
            except TypeError:
                return False
            return res
        a, b = _num(lv), _num(rv)
        if a is None or b is None:
            return None
        if node.op == "+":
            return a + b
        if node.op == "-":
            return a - b
        if node.op == "*":
            return a * b
        if node.op == "/":
            return a / b if b != 0 else None
        if node.op == "%":
            return a % b if b != 0 else None
        raise SQLError(f"unknown operator {node.op}")

    @staticmethod
    def _cast(v, to: str):
        try:
            if to in ("int", "integer"):
                return int(float(v))
            if to in ("float", "double", "decimal", "numeric"):
                return float(v)
            if to in ("string", "varchar", "char"):
                return "" if v is None else str(v)
            if to in ("bool", "boolean"):
                return str(v).lower() in ("1", "true", "t", "yes")
        except (TypeError, ValueError):
            return None
        raise SQLError(f"unsupported CAST type {to}")

    def _call(self, node: Call, rec: Record):
        name = node.name
        if name in AGGREGATES:
            raise SQLError(f"aggregate {name} in scalar context")
        args = [self.eval(a, rec) for a in node.args]
        if name == "lower":
            return None if args[0] is None else str(args[0]).lower()
        if name == "upper":
            return None if args[0] is None else str(args[0]).upper()
        if name in ("char_length", "character_length", "length"):
            return None if args[0] is None else len(str(args[0]))
        if name == "trim":
            return None if args[0] is None else str(args[0]).strip()
        if name == "substring":
            if args[0] is None:
                return None
            s = str(args[0])
            start = int(_num(args[1]) or 1) - 1
            if len(args) > 2:
                return s[max(start, 0): max(start, 0) + int(_num(args[2]))]
            return s[max(start, 0):]
        if name == "coalesce":
            for a in args:
                if a is not None and a != "":
                    return a
            return None
        if name == "nullif":
            a, b = _coerce_pair(args[0], args[1])
            return None if a == b else args[0]
        if name == "utcnow":
            import datetime
            return datetime.datetime.utcnow().isoformat()
        raise SQLError(f"unknown function {name}")

    # -- aggregation ----------------------------------------------------------

    def accumulate(self, items, rec: Record):
        """Feed one record into the aggregate states of a select list."""
        aid = 0
        for item in items:
            aid = self._acc_walk(item.expr, rec, aid)

    def _acc_walk(self, node, rec: Record, aid: int) -> int:
        if isinstance(node, Call) and node.name in AGGREGATES:
            st = self.aggs.setdefault(aid, AggState())
            aid += 1
            if node.star:
                st.count += 1
                return aid
            v = self.eval(node.args[0], rec) if node.args else None
            if v is None or v == "":
                return aid
            st.count += 1
            n = _num(v)
            if n is not None:
                st.sum += n
            cmp = n if n is not None else str(v)
            try:
                if st.seen == 0 or cmp < st.min:
                    st.min = cmp
                if st.seen == 0 or cmp > st.max:
                    st.max = cmp
            except TypeError:
                # mixed numeric/string column: compare in string space
                # (SQL engines coerce; crashing mid-stream is worse)
                if str(cmp) < str(st.min):
                    st.min = cmp
                if str(cmp) > str(st.max):
                    st.max = cmp
            st.seen += 1
            return aid
        for attr in ("operand", "left", "right", "pattern", "lo", "hi"):
            child = getattr(node, attr, None)
            if child is not None:
                aid = self._acc_walk(child, rec, aid)
        for child in getattr(node, "args", []) or []:
            aid = self._acc_walk(child, rec, aid)
        for child in getattr(node, "options", []) or []:
            aid = self._acc_walk(child, rec, aid)
        return aid

    def finish(self, items) -> list:
        """Evaluate the select list in aggregate-result mode."""
        self._agg_id = 0
        return [self._fin_walk(item.expr) for item in items]

    def _fin_walk(self, node):
        if isinstance(node, Call) and node.name in AGGREGATES:
            st = self.aggs.get(self._agg_id, AggState())
            self._agg_id += 1
            if node.name == "count":
                return st.count
            if node.name == "sum":
                return st.sum if st.count else None
            if node.name == "avg":
                return st.sum / st.count if st.count else None
            if node.name == "min":
                return st.min
            if node.name == "max":
                return st.max
        if isinstance(node, Binary):
            left = self._fin_walk(node.left)
            right = self._fin_walk(node.right)
            return Evaluator()._binary(
                Binary(node.op, Lit(left), Lit(right)), Record(values=[]))
        if isinstance(node, Lit):
            return node.value
        raise SQLError("non-aggregate expression in aggregate query")


def _truthy(v) -> bool:
    if isinstance(v, bool):
        return v
    if v is None:
        return False
    if isinstance(v, (int, float)):
        return v != 0
    return str(v).lower() == "true"
