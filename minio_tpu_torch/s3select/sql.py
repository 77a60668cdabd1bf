"""SELECT SQL dialect: tokenizer + recursive-descent parser producing a
small AST the evaluator walks (reference pkg/s3select/sql/parser.go uses a
participle grammar; same language subset rebuilt directly).

Supported: SELECT <list|*> FROM S3Object[.path] [alias]
[WHERE <expr>] [LIMIT n] with comparison/logic operators, arithmetic,
IS [NOT] NULL, [NOT] LIKE, [NOT] IN, [NOT] BETWEEN, CAST, scalar
functions (LOWER/UPPER/CHAR_LENGTH/LENGTH/TRIM/SUBSTRING/COALESCE/NULLIF)
and aggregates (COUNT/SUM/AVG/MIN/MAX).

The port's copy of minio_tpu/s3select/sql.py: the port imports
nothing of the JAX package, not even this pure-Python module.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field


class SQLError(ValueError):
    pass


# --- tokens ------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<number>\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)
  | (?P<string>'(?:[^']|'')*')
  | (?P<qident>"(?:[^"]|"")*")
  | (?P<op><>|!=|<=|>=|=|<|>|\+|-|\*|/|%|\(|\)|,|\.)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
""", re.VERBOSE)

KEYWORDS = {
    "select", "from", "where", "limit", "as", "and", "or", "not", "is",
    "null", "like", "escape", "in", "between", "cast", "true", "false",
}


@dataclass
class Tok:
    kind: str  # number|string|ident|qident|op|kw|end
    value: str


def tokenize(s: str) -> list[Tok]:
    out: list[Tok] = []
    pos = 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if not m:
            raise SQLError(f"bad character {s[pos]!r} at {pos}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        v = m.group()
        if kind == "ident" and v.lower() in KEYWORDS:
            out.append(Tok("kw", v.lower()))
        else:
            out.append(Tok(kind, v))
    out.append(Tok("end", ""))
    return out


# --- AST ---------------------------------------------------------------------

@dataclass
class Lit:
    value: object


@dataclass
class Col:
    path: tuple[str, ...]   # ("name",) or ("s", "name") or ("_2",)


@dataclass
class Star:
    pass


@dataclass
class Unary:
    op: str
    operand: object


@dataclass
class Binary:
    op: str
    left: object
    right: object


@dataclass
class IsNull:
    operand: object
    negate: bool


@dataclass
class Like:
    operand: object
    pattern: object
    escape: str
    negate: bool


@dataclass
class In:
    operand: object
    options: list
    negate: bool


@dataclass
class Between:
    operand: object
    lo: object
    hi: object
    negate: bool


@dataclass
class Call:
    name: str
    args: list
    star: bool = False


@dataclass
class Cast:
    operand: object
    to: str


@dataclass
class SelectItem:
    expr: object
    alias: str = ""


@dataclass
class Select:
    items: list[SelectItem] = field(default_factory=list)   # empty = *
    table_path: tuple[str, ...] = ()
    alias: str = ""
    where: object = None
    limit: int = -1


AGGREGATES = {"count", "sum", "avg", "min", "max"}
SCALARS = {"lower", "upper", "char_length", "character_length", "length",
           "trim", "substring", "coalesce", "nullif", "utcnow"}


class _Parser:
    def __init__(self, toks: list[Tok]):
        self.toks = toks
        self.i = 0

    def peek(self) -> Tok:
        return self.toks[self.i]

    def next(self) -> Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind: str, value: str | None = None) -> Tok | None:
        t = self.peek()
        if t.kind == kind and (value is None or t.value == value):
            return self.next()
        return None

    def expect(self, kind: str, value: str | None = None) -> Tok:
        t = self.accept(kind, value)
        if t is None:
            raise SQLError(
                f"expected {value or kind}, got {self.peek().value!r}")
        return t

    # -- grammar -------------------------------------------------------------

    def select(self) -> Select:
        self.expect("kw", "select")
        sel = Select()
        if self.accept("op", "*"):
            sel.items = []
        else:
            sel.items.append(self.select_item())
            while self.accept("op", ","):
                sel.items.append(self.select_item())
        self.expect("kw", "from")
        sel.table_path, sel.alias = self.table()
        if self.accept("kw", "where"):
            sel.where = self.expr()
        if self.accept("kw", "limit"):
            sel.limit = int(self.expect("number").value)
        self.expect("end")
        return sel

    def select_item(self) -> SelectItem:
        e = self.expr()
        alias = ""
        if self.accept("kw", "as"):
            alias = self._ident_value(self.next())
        elif self.peek().kind in ("ident", "qident"):
            alias = self._ident_value(self.next())
        return SelectItem(e, alias)

    @staticmethod
    def _ident_value(t: Tok) -> str:
        if t.kind == "qident":
            return t.value[1:-1].replace('""', '"')
        if t.kind in ("ident", "kw"):
            return t.value
        raise SQLError(f"expected identifier, got {t.value!r}")

    def table(self) -> tuple[tuple[str, ...], str]:
        parts = [self._ident_value(self.next())]
        while self.accept("op", "."):
            parts.append(self._ident_value(self.next()))
        alias = ""
        t = self.peek()
        if t.kind in ("ident", "qident"):
            alias = self._ident_value(self.next())
        return tuple(parts), alias

    def expr(self):
        return self.or_expr()

    def or_expr(self):
        left = self.and_expr()
        while self.accept("kw", "or"):
            left = Binary("or", left, self.and_expr())
        return left

    def and_expr(self):
        left = self.not_expr()
        while self.accept("kw", "and"):
            left = Binary("and", left, self.not_expr())
        return left

    def not_expr(self):
        if self.accept("kw", "not"):
            return Unary("not", self.not_expr())
        return self.cmp_expr()

    def cmp_expr(self):
        left = self.add_expr()
        t = self.peek()
        if t.kind == "op" and t.value in ("=", "!=", "<>", "<", "<=", ">",
                                          ">="):
            self.next()
            op = "!=" if t.value == "<>" else t.value
            return Binary(op, left, self.add_expr())
        if t.kind == "kw" and t.value == "is":
            self.next()
            negate = self.accept("kw", "not") is not None
            self.expect("kw", "null")
            return IsNull(left, negate)
        negate = False
        if t.kind == "kw" and t.value == "not":
            nxt = self.toks[self.i + 1]
            if nxt.kind == "kw" and nxt.value in ("like", "in", "between"):
                self.next()
                negate = True
                t = self.peek()
        if t.kind == "kw" and t.value == "like":
            self.next()
            pattern = self.add_expr()
            esc = ""
            if self.accept("kw", "escape"):
                esc_tok = self.expect("string")
                esc = esc_tok.value[1:-1].replace("''", "'")
            return Like(left, pattern, esc, negate)
        if t.kind == "kw" and t.value == "in":
            self.next()
            self.expect("op", "(")
            options = [self.expr()]
            while self.accept("op", ","):
                options.append(self.expr())
            self.expect("op", ")")
            return In(left, options, negate)
        if t.kind == "kw" and t.value == "between":
            self.next()
            lo = self.add_expr()
            self.expect("kw", "and")
            return Between(left, lo, self.add_expr(), negate)
        return left

    def add_expr(self):
        left = self.mul_expr()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("+", "-"):
                self.next()
                left = Binary(t.value, left, self.mul_expr())
            else:
                return left

    def mul_expr(self):
        left = self.unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/", "%"):
                self.next()
                left = Binary(t.value, left, self.unary())
            else:
                return left

    def unary(self):
        if self.accept("op", "-"):
            return Unary("-", self.unary())
        self.accept("op", "+")
        return self.primary()

    def primary(self):
        t = self.peek()
        if t.kind == "number":
            self.next()
            v = float(t.value) if "." in t.value or "e" in t.value.lower() \
                else int(t.value)
            return Lit(v)
        if t.kind == "string":
            self.next()
            return Lit(t.value[1:-1].replace("''", "'"))
        if t.kind == "kw" and t.value in ("true", "false"):
            self.next()
            return Lit(t.value == "true")
        if t.kind == "kw" and t.value == "null":
            self.next()
            return Lit(None)
        if t.kind == "kw" and t.value == "cast":
            self.next()
            self.expect("op", "(")
            e = self.expr()
            self.expect("kw", "as")
            to = self._ident_value(self.next()).lower()
            self.expect("op", ")")
            return Cast(e, to)
        if t.kind == "op" and t.value == "(":
            self.next()
            e = self.expr()
            self.expect("op", ")")
            return e
        if t.kind in ("ident", "qident"):
            name = self._ident_value(self.next())
            if self.accept("op", "("):
                if self.accept("op", "*"):
                    self.expect("op", ")")
                    return Call(name.lower(), [], star=True)
                args = []
                if not self.accept("op", ")"):
                    args.append(self.expr())
                    while self.accept("op", ","):
                        args.append(self.expr())
                    self.expect("op", ")")
                return Call(name.lower(), args)
            path = [name]
            while self.accept("op", "."):
                path.append(self._ident_value(self.next()))
            return Col(tuple(path))
        raise SQLError(f"unexpected token {t.value!r}")


def parse_select(sql: str) -> Select:
    sel = _Parser(tokenize(sql)).select()
    if sel.table_path and sel.table_path[0].lower() != "s3object":
        raise SQLError("FROM must reference S3Object")
    return sel


def has_aggregates(sel: Select) -> bool:
    def walk(node) -> bool:
        if isinstance(node, Call) and node.name in AGGREGATES:
            return True
        for attr in ("operand", "left", "right", "pattern", "lo", "hi"):
            child = getattr(node, attr, None)
            if child is not None and walk(child):
                return True
        for child in getattr(node, "args", []) or []:
            if walk(child):
                return True
        for child in getattr(node, "options", []) or []:
            if walk(child):
                return True
        if isinstance(node, Cast) and walk(node.operand):
            return True
        return False

    return any(walk(item.expr) for item in sel.items)
