"""HCL2-subset lexer/parser/evaluator.

Re-derived from the *behavior* of hashicorp/hcl v2 as used by the reference's
`jobspec2/` package (see SURVEY.md §2 layer 13): block/attribute syntax,
string templates with `${...}` interpolation, heredocs, `variable`/`locals`
blocks, a practical subset of the go-cty stdlib functions, arithmetic /
comparison / conditional expressions, `dynamic` blocks, and `for` expressions.

This is a fresh implementation (the reference is Go + hashicorp/hcl; nothing
is translated) producing a plain Python tree:

    Body   = list of Node
    Node   = Attr(name, expr) | Block(type, labels, Body)

Evaluation happens against an EvalContext holding variables (`var.*`,
`local.*`, plus caller-injected roots) and functions.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple


class ParseError(Exception):
    def __init__(self, msg: str, line: int = 0, col: int = 0):
        self.line, self.col = line, col
        super().__init__(f"{msg} (line {line}, col {col})" if line else msg)


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_PUNCT = {
    "{", "}", "[", "]", "(", ")", "=", ",", ":", "?", ".", "...",
    "+", "-", "*", "/", "%", "==", "!=", "<", "<=", ">", ">=",
    "&&", "||", "!", "=>",
}

_KEYWORDS = {"true", "false", "null", "for", "in", "if"}

# HCL type-constructor keywords: evaluate to their own name so
# `variable "x" { type = string }` / `type = list(string)` work.
_TYPE_KEYWORDS = {"string", "number", "bool", "any",
                  "list", "map", "set", "tuple", "object", "optional"}


@dataclass
class Tok:
    kind: str        # ident | number | string | heredoc | punct | eof
    value: Any
    line: int
    col: int
    # for strings: list of parts (str literal | Expr template)
    parts: Optional[list] = None


class Lexer:
    def __init__(self, src: str):
        self.src = src
        self.i = 0
        self.line = 1
        self.col = 1
        self.toks: List[Tok] = []

    def error(self, msg: str) -> ParseError:
        return ParseError(msg, self.line, self.col)

    def _adv(self, n: int = 1) -> str:
        s = self.src[self.i:self.i + n]
        for ch in s:
            if ch == "\n":
                self.line += 1
                self.col = 1
            else:
                self.col += 1
        self.i += n
        return s

    def _peek(self, n: int = 1) -> str:
        return self.src[self.i:self.i + n]

    def lex(self) -> List[Tok]:
        while self.i < len(self.src):
            c = self._peek()
            if c in " \t\r\n":
                self._adv()
                continue
            if c == "#" or self._peek(2) == "//":
                while self.i < len(self.src) and self._peek() != "\n":
                    self._adv()
                continue
            if self._peek(2) == "/*":
                end = self.src.find("*/", self.i + 2)
                if end == -1:
                    raise self.error("unterminated comment")
                self._adv(end + 2 - self.i)
                continue
            if self._peek(2) in ("<<", ):
                self._heredoc()
                continue
            if c == '"':
                self._string()
                continue
            if c.isdigit() or (c == "." and self._peek(2)[1:].isdigit()):
                self._number()
                continue
            if c.isalpha() or c == "_":
                self._ident()
                continue
            for p in ("...", "==", "!=", "<=", ">=", "&&", "||", "=>"):
                if self._peek(len(p)) == p:
                    self.toks.append(Tok("punct", p, self.line, self.col))
                    self._adv(len(p))
                    break
            else:
                if c in "{}[]()=,:?.+-*/%<>!":
                    self.toks.append(Tok("punct", c, self.line, self.col))
                    self._adv()
                else:
                    raise self.error(f"unexpected character {c!r}")
        self.toks.append(Tok("eof", None, self.line, self.col))
        return self.toks

    def _number(self):
        line, col = self.line, self.col
        m = re.match(r"\d+(\.\d+)?([eE][+-]?\d+)?", self.src[self.i:])
        text = m.group(0)
        self._adv(len(text))
        val = float(text) if ("." in text or "e" in text or "E" in text) else int(text)
        self.toks.append(Tok("number", val, line, col))

    def _ident(self):
        line, col = self.line, self.col
        m = re.match(r"[A-Za-z_][A-Za-z0-9_-]*", self.src[self.i:])
        text = m.group(0)
        self._adv(len(text))
        self.toks.append(Tok("ident", text, line, col))

    def _string(self):
        line, col = self.line, self.col
        self._adv()  # opening quote
        parts: list = []
        buf: List[str] = []
        while True:
            if self.i >= len(self.src):
                raise self.error("unterminated string")
            c = self._peek()
            if c == '"':
                self._adv()
                break
            if c == "\\":
                esc = self._peek(2)[1:]
                self._adv(2)
                buf.append({"n": "\n", "t": "\t", "r": "\r", '"': '"',
                            "\\": "\\"}.get(esc, esc))
                continue
            if self._peek(3) in ("$${", "%%{"):
                # escaped template sequence -> literal ${ / %{
                buf.append(self._peek(2)[0] + "{")
                self._adv(3)
                continue
            if self._peek(2) == "${":
                if buf:
                    parts.append("".join(buf))
                    buf = []
                parts.append(self._template_expr())
                continue
            buf.append(self._adv())
        if buf or not parts:
            parts.append("".join(buf))
        self.toks.append(Tok("string", None, line, col, parts=parts))

    def _template_expr(self):
        """Consume `${ ... }` and return the inner source as a TemplatePart."""
        self._adv(2)
        depth = 1
        start = self.i
        in_str = False
        while self.i < len(self.src):
            c = self._peek()
            if in_str:
                if c == "\\":
                    self._adv(2)
                    continue
                if c == '"':
                    in_str = False
            elif c == '"':
                in_str = True
            elif c == "{":
                depth += 1
            elif c == "}":
                depth -= 1
                if depth == 0:
                    inner = self.src[start:self.i]
                    self._adv()
                    return TemplatePart(inner)
            self._adv()
        raise self.error("unterminated template interpolation")

    def _heredoc(self):
        line, col = self.line, self.col
        self._adv(2)
        indent = False
        if self._peek() == "-":
            indent = True
            self._adv()
        m = re.match(r"[A-Za-z_][A-Za-z0-9_]*", self.src[self.i:])
        if not m:
            raise self.error("invalid heredoc delimiter")
        delim = m.group(0)
        self._adv(len(delim))
        while self.i < len(self.src) and self._peek() != "\n":
            self._adv()
        self._adv()  # newline
        lines: List[str] = []
        while True:
            if self.i >= len(self.src):
                raise self.error(f"unterminated heredoc {delim}")
            nl = self.src.find("\n", self.i)
            if nl == -1:
                nl = len(self.src)
            text = self.src[self.i:nl]
            self._adv(nl + 1 - self.i)
            if text.strip() == delim:
                break
            lines.append(text)
        if indent and lines:
            pad = min((len(l) - len(l.lstrip()) for l in lines if l.strip()),
                      default=0)
            lines = [l[pad:] for l in lines]
        self.toks.append(Tok("string", None, line, col,
                             parts=["\n".join(lines) + ("\n" if lines else "")]))


@dataclass
class TemplatePart:
    """Raw source of a `${...}` interpolation, parsed lazily at eval time."""
    src: str


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclass
class Attr:
    name: str
    expr: "Expr"
    line: int = 0


@dataclass
class Block:
    type: str
    labels: List[str]
    body: List[Any]          # list of Attr | Block
    line: int = 0


# Expressions -----------------------------------------------------------------

@dataclass
class Lit:
    value: Any


@dataclass
class StrTpl:
    parts: list              # str | Expr


@dataclass
class Var:
    path: List[Any]          # e.g. ["var", "region"] / ["attr", Lit("x")]


@dataclass
class Index:
    target: Any
    index: Any


@dataclass
class GetAttr:
    target: Any
    name: str


@dataclass
class Call:
    name: str
    args: list
    varargs: bool = False


@dataclass
class ListExpr:
    items: list


@dataclass
class MapExpr:
    items: List[Tuple[Any, Any]]


@dataclass
class Unary:
    op: str
    operand: Any


@dataclass
class Binary:
    op: str
    left: Any
    right: Any


@dataclass
class Cond:
    cond: Any
    then: Any
    other: Any


@dataclass
class ForExpr:
    key_var: Optional[str]
    val_var: str
    coll: Any
    key_result: Optional[Any]   # None => list comprehension
    val_result: Any
    cond: Optional[Any]
    grouping: bool = False


Expr = Any


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------


class Parser:
    def __init__(self, toks: List[Tok]):
        self.toks = toks
        self.i = 0

    # -- token helpers --

    def peek(self) -> Tok:
        return self.toks[self.i]

    def next(self) -> Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind: str, value: Any = None) -> Tok:
        t = self.next()
        if t.kind != kind or (value is not None and t.value != value):
            want = value if value is not None else kind
            raise ParseError(f"expected {want!r}, got {t.value!r}", t.line, t.col)
        return t

    def at_punct(self, v: str) -> bool:
        t = self.peek()
        return t.kind == "punct" and t.value == v

    def eat_punct(self, v: str) -> bool:
        if self.at_punct(v):
            self.next()
            return True
        return False

    # -- body --

    def parse_body(self, top: bool = False) -> List[Any]:
        items: List[Any] = []
        while True:
            t = self.peek()
            if t.kind == "eof":
                if not top:
                    raise ParseError("unexpected EOF in block", t.line, t.col)
                return items
            if self.at_punct("}"):
                if top:
                    raise ParseError("unexpected '}'", t.line, t.col)
                return items
            if t.kind != "ident":
                raise ParseError(f"expected identifier, got {t.value!r}",
                                 t.line, t.col)
            name = self.next()
            if self.at_punct("="):
                self.next()
                items.append(Attr(name.value, self.parse_expr(), name.line))
                continue
            # block: zero or more labels then '{'
            labels: List[str] = []
            while True:
                t2 = self.peek()
                if t2.kind == "string":
                    self.next()
                    if any(isinstance(p, TemplatePart) for p in t2.parts):
                        raise ParseError("block label cannot contain template",
                                         t2.line, t2.col)
                    labels.append("".join(t2.parts))
                elif t2.kind == "ident":
                    labels.append(self.next().value)
                elif self.at_punct("{"):
                    self.next()
                    break
                else:
                    raise ParseError(
                        f"expected block label or '{{', got {t2.value!r}",
                        t2.line, t2.col)
            body = self.parse_body()
            self.expect("punct", "}")
            items.append(Block(name.value, labels, body, name.line))

    # -- expressions (precedence climbing) --

    _BINOPS = [
        {"||"},
        {"&&"},
        {"==", "!="},
        {"<", "<=", ">", ">="},
        {"+", "-"},
        {"*", "/", "%"},
    ]

    def parse_expr(self) -> Expr:
        return self.parse_cond()

    def parse_cond(self) -> Expr:
        cond = self.parse_binary(0)
        if self.eat_punct("?"):
            then = self.parse_expr()
            self.expect("punct", ":")
            other = self.parse_expr()
            return Cond(cond, then, other)
        return cond

    def parse_binary(self, level: int) -> Expr:
        if level >= len(self._BINOPS):
            return self.parse_unary()
        left = self.parse_binary(level + 1)
        while (self.peek().kind == "punct"
               and self.peek().value in self._BINOPS[level]):
            op = self.next().value
            right = self.parse_binary(level + 1)
            left = Binary(op, left, right)
        return left

    def parse_unary(self) -> Expr:
        if self.at_punct("!") or self.at_punct("-"):
            op = self.next().value
            return Unary(op, self.parse_unary())
        return self.parse_postfix()

    def parse_postfix(self) -> Expr:
        e = self.parse_primary()
        while True:
            if self.at_punct("."):
                self.next()
                t = self.next()
                if t.kind == "ident":
                    e = GetAttr(e, t.value)
                elif t.kind == "number" and isinstance(t.value, int):
                    e = Index(e, Lit(t.value))
                elif t.kind == "punct" and t.value == "*":
                    e = Call("__splat__", [e])
                else:
                    raise ParseError("expected attribute name", t.line, t.col)
            elif self.at_punct("["):
                self.next()
                if self.eat_punct("*"):
                    self.expect("punct", "]")
                    e = Call("__splat__", [e])
                else:
                    idx = self.parse_expr()
                    self.expect("punct", "]")
                    e = Index(e, idx)
            else:
                return e

    def parse_primary(self) -> Expr:
        t = self.next()
        if t.kind == "number":
            return Lit(t.value)
        if t.kind == "string":
            parts = []
            for p in t.parts:
                if isinstance(p, TemplatePart):
                    parts.append(parse_expression(p.src))
                else:
                    parts.append(p)
            if len(parts) == 1 and isinstance(parts[0], str):
                return Lit(parts[0])
            return StrTpl(parts)
        if t.kind == "punct" and t.value == "(":
            e = self.parse_expr()
            self.expect("punct", ")")
            return e
        if t.kind == "punct" and t.value == "[":
            if self.peek().kind == "ident" and self.peek().value == "for":
                return self.parse_for(t, is_map=False)
            items = []
            while not self.at_punct("]"):
                items.append(self.parse_expr())
                if not self.eat_punct(","):
                    break
            self.expect("punct", "]")
            return ListExpr(items)
        if t.kind == "punct" and t.value == "{":
            if self.peek().kind == "ident" and self.peek().value == "for":
                return self.parse_for(t, is_map=True)
            items: List[Tuple[Any, Any]] = []
            while not self.at_punct("}"):
                k = self.next()
                if k.kind == "ident":
                    key: Expr = Lit(k.value)
                elif k.kind == "string":
                    key = Lit("".join(p for p in k.parts if isinstance(p, str)))
                elif k.kind == "punct" and k.value == "(":
                    key = self.parse_expr()
                    self.expect("punct", ")")
                else:
                    raise ParseError("expected object key", k.line, k.col)
                if not (self.eat_punct("=") or self.eat_punct(":")):
                    raise ParseError("expected '=' or ':' after object key",
                                     k.line, k.col)
                items.append((key, self.parse_expr()))
                self.eat_punct(",")
            self.expect("punct", "}")
            return MapExpr(items)
        if t.kind == "ident":
            if t.value in ("true", "false"):
                return Lit(t.value == "true")
            if t.value == "null":
                return Lit(None)
            if self.at_punct("("):
                self.next()
                args = []
                varargs = False
                while not self.at_punct(")"):
                    args.append(self.parse_expr())
                    if self.eat_punct("..."):
                        varargs = True
                        break
                    if not self.eat_punct(","):
                        break
                self.expect("punct", ")")
                return Call(t.value, args, varargs)
            return Var([t.value])
        raise ParseError(f"unexpected token {t.value!r}", t.line, t.col)

    def parse_for(self, opening: Tok, is_map: bool) -> Expr:
        self.expect("ident", "for")
        v1 = self.expect("ident").value
        v2 = None
        if self.eat_punct(","):
            v2 = self.expect("ident").value
        self.expect("ident", "in")
        coll = self.parse_expr()
        self.expect("punct", ":")
        key_var, val_var = (v1, v2) if v2 else (None, v1)
        if is_map:
            key_result = self.parse_expr()
            self.expect("punct", "=>")
            val_result = self.parse_expr()
            grouping = self.eat_punct("...")
        else:
            key_result = None
            val_result = self.parse_expr()
            grouping = False
        cond = None
        if self.peek().kind == "ident" and self.peek().value == "if":
            self.next()
            cond = self.parse_expr()
        self.expect("punct", "}" if is_map else "]")
        return ForExpr(key_var, val_var, coll, key_result, val_result, cond,
                       grouping)


def parse_expression(src: str) -> Expr:
    toks = Lexer(src).lex()
    p = Parser(toks)
    e = p.parse_expr()
    if p.peek().kind != "eof":
        t = p.peek()
        raise ParseError(f"trailing tokens after expression: {t.value!r}",
                         t.line, t.col)
    return e


def parse(src: str) -> List[Any]:
    """Parse HCL source into a body (list of Attr | Block)."""
    return Parser(Lexer(src).lex()).parse_body(top=True)


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------


def _std_functions() -> Dict[str, Callable]:
    import hashlib
    import os.path as osp

    def _flatten(x):
        out = []
        for v in x:
            if isinstance(v, list):
                out.extend(_flatten(v))
            else:
                out.append(v)
        return out

    fns: Dict[str, Callable] = {
        "abs": abs,
        "ceil": lambda x: int(-(-x // 1)),
        "floor": lambda x: int(x // 1),
        "max": lambda *a: max(a),
        "min": lambda *a: min(a),
        "pow": lambda a, b: a ** b,
        "signum": lambda x: (x > 0) - (x < 0),
        "parseint": lambda s, base=10: int(str(s), int(base)),
        "format": lambda f, *a: _go_format(f, a),
        "formatlist": lambda f, *ls: [_go_format(f, t) for t in zip(*ls)],
        "join": lambda sep, lst: sep.join(str(x) for x in lst),
        "split": lambda sep, s: s.split(sep),
        "lower": lambda s: s.lower(),
        "upper": lambda s: s.upper(),
        "title": lambda s: s.title(),
        "trim": lambda s, cut: s.strip(cut),
        "trimprefix": lambda s, p: s[len(p):] if s.startswith(p) else s,
        "trimsuffix": lambda s, p: s[:-len(p)] if p and s.endswith(p) else s,
        "trimspace": lambda s: s.strip(),
        "replace": lambda s, old, new: s.replace(old, new),
        "regex": lambda pat, s: _regex(pat, s),
        "regexall": lambda pat, s: [_regex_match(m) for m in
                                    re.finditer(pat, s)],
        "substr": lambda s, off, ln: s[off:] if ln < 0 else s[off:off + ln],
        "strlen": len,
        "indent": lambda n, s: s.replace("\n", "\n" + " " * n),
        "chomp": lambda s: s.rstrip("\n"),
        "length": len,
        "concat": lambda *ls: sum((list(l) for l in ls), []),
        "contains": lambda lst, v: v in lst,
        "distinct": lambda lst: list(dict.fromkeys(lst)),
        "element": lambda lst, i: lst[i % len(lst)],
        "index": lambda lst, v: lst.index(v),
        "flatten": _flatten,
        "keys": lambda m: sorted(m.keys()),
        "values": lambda m: [m[k] for k in sorted(m.keys())],
        "lookup": lambda m, k, *d: m.get(k, d[0]) if d else m[k],
        "merge": lambda *ms: {k: v for m in ms for k, v in m.items()},
        "range": lambda *a: list(range(*[int(x) for x in a])),
        "reverse": lambda lst: list(reversed(lst)),
        "slice": lambda lst, a, b: lst[a:b],
        "sort": lambda lst: sorted(lst),
        "zipmap": lambda ks, vs: dict(zip(ks, vs)),
        "setunion": lambda *ss: sorted(set().union(*[set(s) for s in ss])),
        "setintersection": lambda s0, *ss: sorted(
            set(s0).intersection(*[set(s) for s in ss])),
        "coalesce": lambda *a: next((x for x in a if x not in (None, "")), None),
        "coalescelist": lambda *a: next((x for x in a if x), []),
        "compact": lambda lst: [x for x in lst if x not in (None, "")],
        "one": lambda lst: lst[0] if len(lst) == 1 else None,
        "tostring": lambda v: _to_string(v),
        "tonumber": lambda v: (float(v) if "." in str(v) else int(v))
                    if not isinstance(v, (int, float)) else v,
        "tobool": lambda v: v if isinstance(v, bool) else str(v) == "true",
        "tolist": list,
        "toset": lambda v: sorted(set(v)),
        "tomap": dict,
        "jsonencode": lambda v: json.dumps(v, separators=(",", ":")),
        "jsondecode": json.loads,
        "csvdecode": _csvdecode,
        "base64encode": lambda s: __import__("base64").b64encode(
            s.encode()).decode(),
        "base64decode": lambda s: __import__("base64").b64decode(s).decode(),
        "md5": lambda s: hashlib.md5(s.encode()).hexdigest(),
        "sha1": lambda s: hashlib.sha1(s.encode()).hexdigest(),
        "sha256": lambda s: hashlib.sha256(s.encode()).hexdigest(),
        "uuidv4": lambda: __import__("uuid").uuid4().hex,
        "basename": osp.basename,
        "dirname": osp.dirname,
        "pathexpand": osp.expanduser,
        "can": None,      # special-cased in Evaluator
        "try": None,      # special-cased in Evaluator
        "__splat__": None,
    }
    return fns


def _to_string(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return ""
    if isinstance(v, float) and v == int(v):
        return str(int(v))
    return str(v)


def _go_format(fmt: str, args: tuple) -> str:
    """Tiny %-verb formatter covering %s %d %f %q %v %%."""
    out: List[str] = []
    ai = 0
    i = 0
    while i < len(fmt):
        c = fmt[i]
        if c != "%":
            out.append(c)
            i += 1
            continue
        verb = fmt[i + 1] if i + 1 < len(fmt) else ""
        if verb == "%":
            out.append("%")
        else:
            a = args[ai] if ai < len(args) else ""
            ai += 1
            if verb == "d":
                out.append(str(int(a)))
            elif verb == "f":
                out.append(f"{float(a):f}")
            elif verb == "q":
                out.append(json.dumps(_to_string(a)))
            else:
                out.append(_to_string(a))
        i += 2
    return "".join(out)


def _regex_match(m: "re.Match"):
    if m.groupdict():
        return m.groupdict()
    if m.groups():
        return list(m.groups())
    return m.group(0)


def _regex(pat: str, s: str):
    m = re.search(pat, s)
    if not m:
        raise ValueError(f"regex {pat!r} did not match")
    return _regex_match(m)


def _csvdecode(s: str):
    import csv
    import io
    rows = list(csv.DictReader(io.StringIO(s)))
    return [dict(r) for r in rows]


class EvalContext:
    def __init__(self, variables: Optional[Dict[str, Any]] = None,
                 functions: Optional[Dict[str, Callable]] = None):
        self.variables: Dict[str, Any] = dict(variables or {})
        self.functions: Dict[str, Callable] = _std_functions()
        if functions:
            self.functions.update(functions)

    def child(self, extra: Dict[str, Any]) -> "EvalContext":
        c = EvalContext(self.variables, None)
        c.functions = self.functions
        c.variables.update(extra)
        return c


class Evaluator:
    """Evaluates parsed expressions against an EvalContext.

    Unknown `${...}` roots are preserved verbatim when `keep_unknown` names
    them — jobspec runtime interpolations (`node.*`, `attr.*`, `env.*`,
    `NOMAD_*`) must survive parsing untouched so the scheduler/taskenv can
    resolve them later (reference: jobspec2 leaves non-HCL vars to the
    server/client planes).
    """

    def __init__(self, ctx: EvalContext, keep_unknown: Tuple[str, ...] = ()):
        self.ctx = ctx
        self.keep_unknown = keep_unknown

    class _Unknown(Exception):
        def __init__(self, src: str):
            self.src = src

    def evaluate(self, e: Expr) -> Any:
        try:
            return self._ev(e)
        except Evaluator._Unknown as u:
            return "${" + u.src + "}"

    def _ev(self, e: Expr) -> Any:
        if isinstance(e, Lit):
            return e.value
        if isinstance(e, StrTpl):
            out: List[str] = []
            for p in e.parts:
                if isinstance(p, str):
                    out.append(p)
                else:
                    try:
                        out.append(_to_string(self._ev(p)))
                    except Evaluator._Unknown:
                        out.append("${" + _expr_src(p) + "}")
            return "".join(out)
        if isinstance(e, Var):
            root = e.path[0]
            if root not in self.ctx.variables:
                if root in _TYPE_KEYWORDS:
                    return root
                for pat in self.keep_unknown:
                    if (pat.endswith("*") and root.startswith(pat[:-1])) \
                            or root == pat:
                        raise Evaluator._Unknown(_expr_src(e))
                raise ParseError(f"unknown variable {root!r}")
            return self.ctx.variables[root]
        if isinstance(e, GetAttr):
            try:
                t = self._ev(e.target)
            except Evaluator._Unknown as u:
                raise Evaluator._Unknown(u.src + "." + e.name)
            if isinstance(t, dict):
                if e.name not in t:
                    raise ParseError(f"object has no attribute {e.name!r}")
                return t[e.name]
            if isinstance(t, list):
                # splat traversal: [*].a maps the access over elements
                return [x[e.name] if isinstance(x, dict)
                        else getattr(x, e.name) for x in t]
            return getattr(t, e.name)
        if isinstance(e, Index):
            t = self._ev(e.target)
            i = self._ev(e.index)
            if isinstance(t, list):
                return t[int(i)]
            return t[i]
        if isinstance(e, ListExpr):
            return [self._ev(x) for x in e.items]
        if isinstance(e, MapExpr):
            return {self._ev(k): self._ev(v) for k, v in e.items}
        if isinstance(e, Unary):
            v = self._ev(e.operand)
            return (not v) if e.op == "!" else -v
        if isinstance(e, Binary):
            return self._binary(e)
        if isinstance(e, Cond):
            return self._ev(e.then) if self._ev(e.cond) else self._ev(e.other)
        if isinstance(e, Call):
            return self._call(e)
        if isinstance(e, ForExpr):
            return self._for(e)
        raise ParseError(f"cannot evaluate {type(e).__name__}")

    def _binary(self, e: Binary) -> Any:
        op = e.op
        if op == "&&":
            return bool(self._ev(e.left)) and bool(self._ev(e.right))
        if op == "||":
            return bool(self._ev(e.left)) or bool(self._ev(e.right))
        l, r = self._ev(e.left), self._ev(e.right)
        if op == "==":
            return l == r
        if op == "!=":
            return l != r
        if op == "+":
            return l + r
        if op == "-":
            return l - r
        if op == "*":
            return l * r
        if op == "/":
            return l / r
        if op == "%":
            return l % r
        if op == "<":
            return l < r
        if op == "<=":
            return l <= r
        if op == ">":
            return l > r
        if op == ">=":
            return l >= r
        raise ParseError(f"unknown operator {op!r}")

    def _call(self, e: Call) -> Any:
        if e.name == "try":
            for arg in e.args:
                try:
                    return self._ev(arg)
                except Exception:
                    continue
            raise ParseError("try(): no expression succeeded")
        if e.name == "can":
            try:
                self._ev(e.args[0])
                return True
            except Exception:
                return False
        if e.name == "__splat__":
            t = self._ev(e.args[0])
            if t is None:
                return []
            return t if isinstance(t, list) else [t]
        fn = self.ctx.functions.get(e.name)
        if fn is None:
            if e.name in _TYPE_KEYWORDS:
                # type constructor, e.g. list(string) -> "list"
                return e.name
            raise ParseError(f"unknown function {e.name!r}")
        args = [self._ev(a) for a in e.args]
        if e.varargs and args:
            args = args[:-1] + list(args[-1])
        return fn(*args)

    def _for(self, e: ForExpr) -> Any:
        coll = self._ev(e.coll)
        if isinstance(coll, dict):
            pairs = list(coll.items())
        else:
            pairs = list(enumerate(coll))
        if e.key_result is None:
            out: List[Any] = []
            for k, v in pairs:
                sub = Evaluator(self.ctx.child(_loop_vars(e, k, v)),
                                self.keep_unknown)
                if e.cond is not None and not sub._ev(e.cond):
                    continue
                out.append(sub._ev(e.val_result))
            return out
        outm: Dict[Any, Any] = {}
        for k, v in pairs:
            sub = Evaluator(self.ctx.child(_loop_vars(e, k, v)),
                            self.keep_unknown)
            if e.cond is not None and not sub._ev(e.cond):
                continue
            kk = sub._ev(e.key_result)
            vv = sub._ev(e.val_result)
            if e.grouping:
                outm.setdefault(kk, []).append(vv)
            else:
                outm[kk] = vv
        return outm


def _loop_vars(e: ForExpr, k, v) -> Dict[str, Any]:
    out = {e.val_var: v}
    if e.key_var:
        out[e.key_var] = k
    return out


def _expr_src(e: Expr) -> str:
    """Best-effort re-serialization of an expression (for preserved
    runtime interpolations)."""
    if isinstance(e, Var):
        return ".".join(str(p) for p in e.path)
    if isinstance(e, GetAttr):
        return _expr_src(e.target) + "." + e.name
    if isinstance(e, Index):
        return f"{_expr_src(e.target)}[{_expr_src(e.index)}]"
    if isinstance(e, Lit):
        if isinstance(e.value, str):
            return json.dumps(e.value)
        return _to_string(e.value)
    if isinstance(e, Call):
        return f"{e.name}({', '.join(_expr_src(a) for a in e.args)})"
    if isinstance(e, Binary):
        return f"{_expr_src(e.left)} {e.op} {_expr_src(e.right)}"
    return "<expr>"
