"""VDB filter expression language -> SQLite SQL (pure Python).

Copy of ``biograph_tpu/tools/vdb_filter.py``.

Counterpart of the reference's pyparsing grammar
(python/biograph/vdb/filter.py:42 generate_vdb_parser): the same token
vocabulary — VCF columns, FORMAT/INFO fields with type casts, `info/X` and
`fmt/X` lookups, genotype literals, bcftools-style logical operators — but
translated to SQLite's JSON1 functions instead of Presto map lookups, and
implemented as a hand-rolled tokenizer + rewriter (no pyparsing in this
environment).

The reference parser rewrites tokens in place (no AST); this does the same:
each token maps to a SQL fragment, with three contextual fixups carried over
from the reference grammar:

  * QuoteFix  — a bareword compared against chrom/filt gets quoted
  * PosFix    — `pos` comparisons are given in VCF 1-based coordinates but
                rows store 0-based, so literal operands shift by one
  * IsNull    — `col = '.'` / `col != '.'` become IS NULL / IS NOT NULL

Unknown words are rejected (the reference's parser likewise fails the
parse), so typos cannot silently become always-false SQL.
"""

from __future__ import annotations

import re
from typing import List

# FORMAT fields and their SQL types (filter.py:108-119)
FORMAT_INT = set(
    "DP DV GQ LAALTSEQLEN LALANCH LARANCH LAREFSPAN LASCORE NUMASM OV PDP PI RC".split()
)
FORMAT_FLOAT = {"LAALTGC", "LAREFGC"}
FORMAT_STR = set(
    "AC AD DC DCC DDC DMO DS DXO EC GT MC MO MP NR PAD PG PL UC UCC UDC UMO US UXO XC XO".split()
)
INFO_INT = {"SVLEN", "END"}
INFO_STR = {"SVTYPE"}

# scalar/aggregate function names (filter.py:45-56); Presto-isms map to
# SQLite equivalents
FUNCS = {
    "MAX": "MAX",
    "MIN": "MIN",
    "AVG": "AVG",
    "MEAN": "AVG",
    "SUM": "SUM",
    "COUNT": "COUNT",
    "ABS": "ABS",
    "STRLEN": "LENGTH",
    "LENGTH": "LENGTH",
}

VCF_COLS = {
    "chrom": "chrom",
    "pos": "pos",
    "id": "varid",
    "ref": "ref",
    "alt": "alt",
    "qual": "qual",
    "filt": "filt",
    "filter": "filt",
}

# other VDB columns (filter.py:148-158); spans/reflen are derived
OTHER_COLS = {
    "varend": "varend",
    "varid": "varid",
    "checkpoint": "checkpoint",
    "study_name": "study_name",
    "sample_name": "sample_name",
    "aid": "aid",
    "reflen": "LENGTH(ref)",
    "spans": "(varend - pos)",
    # missingness pseudo-columns (filter.py generate_missingness_parser);
    # filter_study joins precomputed per-site / per-sample tables for these
    "f_miss": "f_miss",
    "sample_miss": "sample_miss",
}

_TOKEN_RE = re.compile(
    r"""\s*(
      "[^"]*" | '[^']*'
    | [012.][/|][012.]
    | [A-Za-z_][A-Za-z0-9_]* (?: / [A-Za-z_][A-Za-z0-9_]*)?
    | \d+\.\d+ | \d+
    | == | != | >= | <= | && | \|\|
    | [=<>!(),+*/-]
    )""",
    re.X,
)


class FilterError(ValueError):
    pass


def tokenize(expr: str) -> List[str]:
    out, i = [], 0
    while i < len(expr):
        m = _TOKEN_RE.match(expr, i)
        if not m:
            if expr[i:].strip() == "":
                break
            raise FilterError(f"cannot tokenize filter at: {expr[i:]!r}")
        out.append(m.group(1))
        i = m.end()
    return out


def _fmt_field(name: str) -> str:
    q = f"json_extract(sample, '$.{name}')"
    if name in FORMAT_INT:
        return f"CAST({q} AS INTEGER)"
    if name in FORMAT_FLOAT:
        return f"CAST({q} AS REAL)"
    return q


def _info_field(name: str) -> str:
    q = f"json_extract(info, '$.{name}')"
    if name in INFO_INT:
        return f"CAST({q} AS INTEGER)"
    return q


_CMPS = {"=", "==", "!=", ">", ">=", "<", "<="}
_STRINGY = {"chrom", "filt"}  # QuoteFix targets (filter.py:143)


def translate(expr: str, allow_missingness: bool = True) -> str:
    """Translate one filter expression to a SQLite boolean expression."""
    toks = tokenize(expr)
    if not toks:
        raise FilterError("empty filter expression")
    out: List[str] = []
    # context for the fixups: the semantic class of the token before a
    # comparison operator, and the pending comparison itself
    lhs_kind = None  # "pos" | "string" | None
    pending_cmp_at = None  # index in `out` of the last comparison operator
    i = 0
    while i < len(toks):
        t = toks[i]
        up = t.upper()
        low = t.lower()
        nxt_kind = None
        if t[0] in "\"'":  # quoted string
            body = t[1:-1].replace("'", "''")
            if body == "." and pending_cmp_at is not None:
                _isnull(out, pending_cmp_at)
                pending_cmp_at = None
                lhs_kind = None
                i += 1
                continue
            out.append(f"'{body}'")
        elif re.fullmatch(r"[012.][/|][012.]", t):
            out.append(f"'{t}'")
        elif re.fullmatch(r"\d+(\.\d+)?", t):
            if lhs_kind == "pos" and pending_cmp_at == len(out) - 1 and "." not in t:
                out.append(str(int(t) - 1))  # PosFix: 1-based -> 0-based
            else:
                out.append(t)
        elif t in ("==",):
            out.append("=")
            pending_cmp_at = len(out) - 1
            i += 1
            continue
        elif t in _CMPS:
            out.append(t)
            pending_cmp_at = len(out) - 1
            i += 1
            continue
        elif t == "&&" or up == "AND":
            out.append("AND")
        elif t == "||" or up == "OR" or t == ",":
            out.append("OR")
        elif t == "!" or up == "NOT":
            out.append("NOT")
        elif t in "()+-*/":
            out.append(t)
        elif "/" in t:  # info/X or fmt/X lookup (filter.py:133-137)
            head, _, field = t.partition("/")
            if head.lower() == "info":
                out.append(_info_field(field))
            elif head.lower() in ("fmt", "format"):
                if field not in (FORMAT_INT | FORMAT_FLOAT | FORMAT_STR):
                    raise FilterError(f"unknown FORMAT field: {field}")
                out.append(_fmt_field(field))
            else:
                raise FilterError(f"unknown lookup: {t}")
            nxt_kind = "string"
        elif up in FUNCS and i + 1 < len(toks) and toks[i + 1] == "(":
            out.append(FUNCS[up])
        elif t in FORMAT_INT or t in FORMAT_FLOAT or t in FORMAT_STR:
            out.append(_fmt_field(t))
            nxt_kind = "string"
        elif t in INFO_INT or t in INFO_STR:
            out.append(_info_field(t))
        elif low in VCF_COLS:
            out.append(VCF_COLS[low])
            nxt_kind = (
                "pos"
                if low == "pos"
                else ("string" if VCF_COLS[low] in _STRINGY else None)
            )
        elif low in OTHER_COLS:
            if low in ("f_miss", "sample_miss") and not allow_missingness:
                raise FilterError(f"{t} is only valid in study filters")
            out.append(OTHER_COLS[low])
            nxt_kind = "string" if low in ("sample_name", "study_name", "aid", "varid") else None
        else:
            # QuoteFix: bareword on the RHS of a string-column comparison
            if lhs_kind == "string" and pending_cmp_at == len(out) - 1:
                out.append(f"'{t}'")
            else:
                raise FilterError(f"unknown field or keyword: {t!r}")
        if nxt_kind is not None:
            lhs_kind = nxt_kind
        elif out and out[-1] not in ("(",) and pending_cmp_at != len(out) - 1:
            # a completed operand resets nothing until the next comparison
            pass
        if pending_cmp_at is not None and pending_cmp_at < len(out) - 1:
            pending_cmp_at = None
            lhs_kind = None
        i += 1
    return " ".join(out)


def _isnull(out: List[str], cmp_at: int) -> None:
    op = out[cmp_at]
    if op == "=":
        out[cmp_at] = "IS NULL"
    elif op == "!=":
        out[cmp_at] = "IS NOT NULL"
    else:
        raise FilterError("'.' (null) only supports = / != comparisons")


def uses_missingness(expr: str) -> bool:
    return bool(re.search(r"\b(f_miss|sample_miss)\b", expr, re.I))
