"""Hand-written lexer + recursive-descent parser for the Cypher subset.

Port of ``repro.query.parser``: a verbatim copy (the module is backend-free), kept
in the port so that ``repro_torch`` imports nothing of the JAX package.
"""
from __future__ import annotations

import re
from typing import List

from repro_torch.query import qast as A

_TOKEN = re.compile(r"""
    (?P<WS>\s+)
  | (?P<NUM>-?\d+(\.\d+)?)
  | (?P<ARROW_R>->)
  | (?P<ARROW_L><-)
  | (?P<DOTS>\.\.)
  | (?P<NEQ><>)
  | (?P<LE><=) | (?P<GE>>=)
  | (?P<SYM>[(){}\[\],:.=<>*-])
  | (?P<NAME>[A-Za-z_][A-Za-z_0-9]*)
""", re.VERBOSE)

KEYWORDS = {"MATCH", "WHERE", "RETURN", "LIMIT", "AND", "OR", "NOT", "COUNT",
            "DISTINCT", "ID", "IN", "CREATE", "DELETE", "AS", "CALL", "YIELD"}


def tokenize(s: str) -> List[tuple]:
    out, pos = [], 0
    while pos < len(s):
        m = _TOKEN.match(s, pos)
        if not m:
            raise SyntaxError(f"bad token at: {s[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "WS":
            continue
        text = m.group()
        if kind == "NAME" and text.upper() in KEYWORDS:
            out.append((text.upper(), text))
        elif kind in ("ARROW_R", "ARROW_L", "DOTS", "NEQ", "LE", "GE"):
            out.append((text, text))
        elif kind == "SYM":
            out.append((text, text))
        elif kind == "NUM":
            out.append(("NUM", text))
        else:
            out.append(("NAME", text))
    out.append(("EOF", ""))
    return out


class Parser:
    def __init__(self, text: str):
        self.toks = tokenize(text)
        self.i = 0

    # -- token helpers ------------------------------------------------------
    def peek(self, k=0):
        return self.toks[min(self.i + k, len(self.toks) - 1)][0]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind):
        t = self.next()
        if t[0] != kind:
            raise SyntaxError(f"expected {kind}, got {t}")
        return t

    def accept(self, kind):
        if self.peek() == kind:
            return self.next()
        return None

    def expect_name(self) -> str:
        """A NAME, or a keyword used in name position (e.g. {id: ...})."""
        t = self.next()
        if t[0] == "NAME" or t[0] in KEYWORDS:
            return t[1]
        raise SyntaxError(f"expected name, got {t}")

    # -- entry ---------------------------------------------------------------
    def parse(self):
        if self.peek() == "CREATE":
            return self.parse_create()
        if self.peek() == "DELETE":
            return self.parse_delete()
        if self.peek() == "CALL":
            return self.parse_call()
        return self.parse_match()

    # -- CALL ----------------------------------------------------------------
    def parse_call(self):
        """CALL algo.name(arg: v, ...) [YIELD col [AS a], ...] [LIMIT k]"""
        self.expect("CALL")
        parts = [self.expect_name()]
        while self.accept("."):
            parts.append(self.expect_name())
        args = {}
        self.expect("(")
        while self.peek() != ")":
            name = self.expect_name()
            self.expect(":")
            args[name] = self.parse_call_value()
            self.accept(",")
        self.expect(")")
        yields = []
        if self.accept("YIELD"):
            yields.append(self.parse_yield_item())
            while self.accept(","):
                yields.append(self.parse_yield_item())
        limit = None
        if self.accept("LIMIT"):
            limit = int(self.expect("NUM")[1])
        self.expect("EOF")
        return A.CallQuery(".".join(parts), args, yields, limit)

    def parse_call_value(self):
        """number | [number, ...] -> tuple | bare word -> string."""
        if self.peek() == "NUM":
            return _num(self.next()[1])
        if self.accept("["):
            vals = []
            while self.peek() == "NUM":
                vals.append(_num(self.next()[1]))
                self.accept(",")
            self.expect("]")
            return tuple(vals)
        return self.expect_name()

    def parse_yield_item(self):
        item = A.ReturnItem("var", self.expect_name())
        if self.accept("AS"):
            item.alias = self.expect_name()
        return item

    # -- CREATE --------------------------------------------------------------
    def parse_create(self):
        items = []
        self.expect("CREATE")
        more = True
        while more:
            self.accept("CREATE")
            self.expect("(")
            if self.peek() == "NUM":  # CREATE (3)-[:R]->(5)
                src = int(self.next()[1])
                self.expect(")")
                self.expect("-")
                self.expect("[")
                self.expect(":")
                rel = self.expect("NAME")[1]
                self.expect("]")
                self.expect("->")
                self.expect("(")
                dst = int(self.expect("NUM")[1])
                self.expect(")")
                items.append(A.CreateEdge(src, rel, dst))
            else:                       # CREATE (:Label {id: 3, age: 30})
                label = None
                if self.accept(":"):
                    label = self.expect("NAME")[1]
                props = self.parse_props()
                self.expect(")")
                # "id" is optional: the engine auto-assigns next_id
                items.append(A.CreateNode(label, props))
            more = bool(self.accept(",")) or self.peek() == "CREATE"
        self.expect("EOF")
        return A.CreateQuery(items)

    # -- DELETE --------------------------------------------------------------
    def parse_delete(self):
        items = []
        self.expect("DELETE")
        more = True
        while more:
            self.accept("DELETE")
            self.expect("(")
            nid = int(self.expect("NUM")[1])
            self.expect(")")
            if self.peek() == "-":      # DELETE (3)-[:R]->(5)
                self.expect("-")
                self.expect("[")
                self.expect(":")
                rel = self.expect("NAME")[1]
                self.expect("]")
                self.expect("->")
                self.expect("(")
                dst = int(self.expect("NUM")[1])
                self.expect(")")
                items.append(A.DeleteEdge(nid, rel, dst))
            else:                       # DELETE (3): whole-node tombstone
                items.append(A.DeleteNode(nid))
            more = bool(self.accept(",")) or self.peek() == "DELETE"
        self.expect("EOF")
        return A.DeleteQuery(items)

    def parse_props(self):
        props = {}
        if self.accept("{"):
            while self.peek() != "}":
                name = self.expect_name()
                self.expect(":")
                props[name] = float(self.expect("NUM")[1])
                self.accept(",")
            self.expect("}")
        return props

    # -- MATCH ----------------------------------------------------------------
    def parse_match(self):
        self.expect("MATCH")
        nodes, edges = [self.parse_node()], []
        while self.peek() in ("-", "<-"):
            edges.append(self.parse_edge())
            nodes.append(self.parse_node())
        where = []
        if self.accept("WHERE"):
            where = self.parse_where()
        self.expect("RETURN")
        rets = [self.parse_return_item()]
        while self.accept(","):
            rets.append(self.parse_return_item())
        limit = None
        if self.accept("LIMIT"):
            limit = int(self.expect("NUM")[1])
        self.expect("EOF")
        return A.MatchQuery(nodes, edges, where, rets, limit)

    def parse_node(self):
        self.expect("(")
        var = label = None
        if self.peek() == "NAME":
            var = self.next()[1]
        if self.accept(":"):
            label = self.expect("NAME")[1]
        props = self.parse_props()
        self.expect(")")
        return A.NodePat(var, label, props)

    def parse_edge(self):
        direction = A.OUT
        if self.accept("<-"):
            direction = A.IN
        else:
            self.expect("-")
        var = rel = None
        minh = maxh = 1
        if self.accept("["):
            if self.peek() == "NAME":
                var = self.next()[1]
            if self.accept(":"):
                rel = self.expect("NAME")[1]
            if self.accept("*"):
                if self.peek() == "NUM":
                    minh = int(self.next()[1])
                    if self.accept(".."):
                        maxh = int(self.expect("NUM")[1])
                    else:
                        maxh = minh
                elif self.accept(".."):
                    minh, maxh = 1, int(self.expect("NUM")[1])
                else:
                    raise SyntaxError("unbounded *: give a max hop count")
            self.expect("]")
        if direction == A.IN:
            self.expect("-")
        elif self.accept("->"):
            pass
        else:
            self.expect("-")
            direction = A.BOTH
        return A.EdgePat(var, rel, direction, minh, maxh)

    # -- WHERE -----------------------------------------------------------------
    def parse_where(self):
        conj = [self.parse_or()]
        while self.accept("AND"):
            conj.append(self.parse_or())
        return conj

    def parse_or(self):
        left = self.parse_not()
        args = [left]
        while self.accept("OR"):
            args.append(self.parse_not())
        return args[0] if len(args) == 1 else A.BoolExpr("OR", args)

    def parse_not(self):
        if self.accept("NOT"):
            return A.BoolExpr("NOT", [self.parse_not()])
        if self.peek() == "(" and self.peek(1) in ("NOT",) :
            self.expect("(")
            e = self.parse_or()
            self.expect(")")
            return e
        return self.parse_cmp()

    def parse_cmp(self):
        if self.peek() == "(":
            self.expect("(")
            e = self.parse_or()
            self.expect(")")
            return e
        lhs = self.parse_operand()
        # id(v) IN [s1, s2, ...]
        if self.accept("IN"):
            if lhs[0] != "id":
                raise SyntaxError("IN only supported on id(var)")
            self.expect("[")
            seeds = []
            while self.peek() == "NUM":
                seeds.append(int(self.next()[1]))
                self.accept(",")
            self.expect("]")
            return A.InSeeds(lhs[1], seeds)
        op = self.next()[0]
        if op not in ("<", "<=", ">", ">=", "=", "<>"):
            raise SyntaxError(f"bad comparison op {op}")
        rhs = self.parse_operand()
        return A.Comparison(op, lhs, rhs)

    def parse_operand(self):
        if self.accept("ID"):
            self.expect("(")
            var = self.expect("NAME")[1]
            self.expect(")")
            return ("id", var)
        if self.peek() == "NUM":
            return ("lit", float(self.next()[1]))
        var = self.expect("NAME")[1]
        self.expect(".")
        prop = self.expect("NAME")[1]
        return ("prop", var, prop)

    def parse_return_item(self):
        if self.accept("COUNT"):
            self.expect("(")
            distinct = bool(self.accept("DISTINCT"))
            var = self.expect("NAME")[1]
            self.expect(")")
            item = A.ReturnItem("count", var, distinct=distinct)
        else:
            var = self.expect("NAME")[1]
            if self.accept("."):
                prop = self.expect("NAME")[1]
                item = A.ReturnItem("prop", var, prop=prop)
            else:
                item = A.ReturnItem("var", var)
        if self.accept("AS"):
            item.alias = self.expect("NAME")[1]
        return item


def _num(text: str):
    """CALL argument numbers keep their intness: `iters: 50` is an int."""
    return float(text) if "." in text else int(text)


def parse(text: str):
    return Parser(text).parse()
