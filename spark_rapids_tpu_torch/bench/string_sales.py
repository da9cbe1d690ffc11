"""The string sales pass: the string family and RLIKE over the TPC-DS
tables (the generators of ``tpcds_schema``, none cut), on the card and on
the CPU engine.

``tables_for(sf)`` gives item, customer and store_sales as the generators
make them, and the untyped store_sales of ``scalar_sales`` (its keys,
quantity, money and sale date as the strings a CSV read without a schema
gives). The queries take the DataFrames of ``df_tables`` and a ``Lib``
(``scalar_sales.Lib``: the tests pass the JAX package's modules to run the
same plans there):

- G1, the dictionary path: store_sales joined with item, grouped by
  ``upper(i_brand)`` and ``concat_ws('/', i_category, i_class)``, with one
  aggregate of every device class that takes a string (``g1_columns``)
  over item's dictionary columns; ``pandas_g1`` computes it with pandas
  and Python's ``str`` over the joined rows;
- G2, the plain path: the same classes over the untyped store_sales'
  plain columns (``g2_columns``; a string result by its byte count),
  summed and counted per store, with the
  rows whose hex/unhex or base64/unbase64 round trip changes a value
  counted (all 0);
- G3, RLIKE: store_sales joined with customer filtered by a pattern of
  the device's subset over ``c_email_address`` and with item, filtered by
  one over ``i_item_desc``; ``g3_rejected`` filters customer by a
  back-reference, which runs on the CPU engine (``explain`` names it);
- G4, the CPU engine's classes (the digests, crc32, levenshtein,
  format_number, space, bin, regexp_extract/replace, overlay without FOR)
  over one store's untyped rows: only its projection runs on the CPU
  engine;
- G5, the scan: a running and a ROWS 30 PRECEDING sum of the quantity
  over ``lower(i_brand)`` partitions, summed per partition.

G6 (partitioned) is G1 and G2 with 4 splits and 4 shuffle partitions.
"""

from __future__ import annotations

import base64
from typing import Dict

import pyarrow as pa
import pyarrow.compute as pc

from spark_rapids_tpu_torch.bench import scalar_sales as SS
from spark_rapids_tpu_torch.bench.scalar_sales import (  # noqa: F401
    Lib, informative, port_lib)

TABLES = ("store_sales", "item", "customer", "date_dim")
ORDER_KEYS = {"G1": ("ub", "cc"), "G2": ("ss_store_sk",), "G3": ("cls",),
              "G3R": ("cls",), "G4": ("ss_store_sk",), "G5": ("part",)}
PARTITIONED = ("G1", "G2")
G3_EMAIL = "^c[0-9]*7@example\\.com$"
G3_DESC = "item [0-9]*(12|34)[0-9]$"
G3_REJECTED = "^c(\\d)\\1"


def tables_for(sf: float, seed: int = 0) -> Dict[str, pa.Table]:
    from spark_rapids_tpu_torch.bench import tpcds_schema as S

    base = S.tables_for(sf, seed, names=TABLES)
    out = {k: base[k] for k in ("store_sales", "item", "customer")}
    out["untyped_store_sales"] = SS.scalar_tables(base, seed)[
        "untyped_store_sales"]
    return out


def df_tables(tables, conf=None, batch_rows: int = 1 << 22, device=None,
              partitions: int = 1, shuffle_partitions: int = 4):
    from spark_rapids_tpu_torch.bench import tpcds_queries as Q

    return Q.df_tables(tables, conf, batch_rows=batch_rows, device=device,
                       partitions=partitions,
                       shuffle_partitions=shuffle_partitions)


def g1_columns(L: Lib):
    """(name, expression, kind, Python function of the item row): every
    device class over item's dictionary columns. ``kind`` is "num" and
    "bool" (summed) or "str" (its maximum)."""
    E = L.E
    col, lit = E.col, E.lit
    b, c, k, o = (col("i_brand"), col("i_class"), col("i_category"),
                  col("i_color"))
    return [
        ("len", E.Length(b), "num", lambda r: len(r["i_brand"])),
        ("oct", E.OctetLength(c), "num", lambda r: len(r["i_class"])),
        ("bits", E.BitLength(k), "num", lambda r: 8 * len(r["i_category"])),
        ("left", E.StringLeft(c, 3), "str", lambda r: r["i_class"][:3]),
        ("right", E.StringRight(b, 2), "str", lambda r: r["i_brand"][-2:]),
        ("lo", E.Lower(k), "str", lambda r: r["i_category"].lower()),
        ("sw", E.StartsWith(c, lit("s")), "bool",
         lambda r: r["i_class"].startswith("s")),
        ("ew", E.EndsWith(b, lit("7")), "bool",
         lambda r: r["i_brand"].endswith("7")),
        ("ct", E.Contains(o, lit("e")), "bool", lambda r: "e" in r["i_color"]),
        ("cat", E.Concat(k, lit("-"), o), "str",
         lambda r: r["i_category"] + "-" + r["i_color"]),
        ("cws", E.ConcatWs(c, o, sep="|"), "str",
         lambda r: r["i_class"] + "|" + r["i_color"]),
        ("trl", E.StringTrimLeft(b, "b"), "str",
         lambda r: r["i_brand"].lstrip("b")),
        ("trr", E.StringTrimRight(c, "s"), "str",
         lambda r: r["i_class"].rstrip("s")),
        ("tr", E.StringTrim(k, "W"), "str", lambda r: r["i_category"]
         .strip("W")),
        ("rep", E.StringReplace(b, "#", "::"), "str",
         lambda r: r["i_brand"].replace("#", "::")),
        ("instr", E.StringInstr(c, "e"), "num",
         lambda r: r["i_class"].find("e") + 1),
        ("loc", E.StringLocate(k, "e", 2), "num",
         lambda r: r["i_category"].find("e", 1) + 1),
        ("lpad", E.StringLPad(o, 10, "*"), "str",
         lambda r: r["i_color"][:10].rjust(10, "*")),
        ("rpad", E.StringRPad(c, 5, "_"), "str",
         lambda r: r["i_class"][:5].ljust(5, "_")),
        ("rpt", E.StringRepeat(o, 3), "str", lambda r: r["i_color"] * 3),
        ("rev", E.StringReverse(b), "str", lambda r: r["i_brand"][::-1]),
        ("tl", E.StringTranslate(k, "aeiou", "AEI"), "str",
         lambda r: r["i_category"].translate(str.maketrans(
             "aei", "AEI", "ou"))),
        ("ic", E.InitCap(E.Concat(o, lit(" "), c)), "str",
         lambda r: " ".join(w[:1].upper() + w[1:].lower() for w in (
             r["i_color"] + " " + r["i_class"]).split(" "))),
        ("si", E.SubstringIndex(b, "#", 1), "str",
         lambda r: r["i_brand"].split("#")[0]),
        ("si2", E.SubstringIndex(c, "e", -1), "str",
         lambda r: r["i_class"].split("e")[-1]),
        ("b64", E.Base64(c), "str",
         lambda r: base64.b64encode(r["i_class"].encode()).decode()),
        ("ub64", E.Hex(E.UnBase64(E.Base64(c))), "str",
         lambda r: base64.b64decode(base64.b64encode(
             r["i_class"].encode())).hex().upper()),
        ("hex", E.Hex(o), "str", lambda r: r["i_color"].encode().hex()
         .upper()),
        ("unhex", E.Hex(E.Unhex(E.Hex(o))), "str",
         lambda r: r["i_color"].encode().hex().upper()),
        ("hexn", E.Hex(col("i_brand_id")), "str",
         lambda r: format(r["i_brand_id"], "X")),
        ("fis", E.FindInSet(o, "red,blue,green,white"), "num",
         lambda r: (["red", "blue", "green", "white"].index(r["i_color"]) + 1
                    if r["i_color"] in ("red", "blue", "green", "white")
                    else 0)),
        ("ov", E.Overlay(b, lit("X"), 2, 3), "str",
         lambda r: r["i_brand"][:1] + "X" + r["i_brand"][4:]),
        ("asc", E.Ascii(c), "num", lambda r: ord(r["i_class"][0])
         if r["i_class"] else 0),
        ("chr", E.Chr(E.Add(E.Pmod(col("i_class_id"), lit(26)), lit(65))),
         "str", lambda r: chr(r["i_class_id"] % 26 + 65)),
        ("rlike", E.RLike(b, "#[0-9]*7$"), "bool",
         lambda r: r["i_brand"].endswith("7")),
    ]


def _aggregates(E, T, cols):
    out = []
    for name, _, kind, *_ in cols:
        x = E.col(name)
        if kind == "str":
            out.append(E.Alias(E.Max(x), f"max_{name}"))
        elif kind == "bool":
            out.append(E.Alias(E.Sum(E.Cast(x, T.INT)), f"sum_{name}"))
        else:
            out.append(E.Alias(E.Sum(x), f"sum_{name}"))
    return out


def _half(cols, part):
    if part is None:
        return cols
    return cols[:len(cols) // 2] if part == 0 else cols[len(cols) // 2:]


def g1(d, L: Lib = None, part: int = None):
    """G1; ``part`` 0 or 1 keeps the first or the second half of its
    columns (the same rows: a check can run the halves apart)."""
    L = L or port_lib()
    E, T = L.E, L.T
    col = E.col
    cols = _half(g1_columns(L), part)
    j = d["store_sales"].select(col("ss_item_sk")).join(
        d["item"], left_on="ss_item_sk", right_on="i_item_sk")
    p = j.select(E.Alias(E.Upper(col("i_brand")), "ub"),
                 E.Alias(E.ConcatWs(col("i_category"), col("i_class"),
                                    sep="/"), "cc"),
                 *[E.Alias(e, n) for n, e, *_ in cols])
    return p.group_by("ub", "cc").agg(
        *_aggregates(E, T, cols), E.Alias(E.Count(), "n")).sort(
        L.SortOrder(col("ub")), L.SortOrder(col("cc")))


def pandas_g1(tables):
    """G1 by pandas and Python's ``str``: each item's values by Python,
    store_sales joined to them by key (as rows a key, so a sum over the
    joined rows is a value times its rows) and aggregated per group; rows
    in G1's order."""
    import pandas as pd

    items = tables["item"].select(
        ["i_item_sk", "i_brand", "i_class", "i_category", "i_color",
         "i_brand_id", "i_class_id"]).to_pylist()
    cols = g1_columns(port_lib())
    per_item = pd.DataFrame([dict(
        i_item_sk=r["i_item_sk"], ub=r["i_brand"].upper(),
        cc=r["i_category"] + "/" + r["i_class"],
        **{n: fn(r) for n, _, _, fn in cols}) for r in items])
    keys = pd.Series(tables["store_sales"].column("ss_item_sk").to_numpy(
        zero_copy_only=False))
    j = per_item.merge(keys.value_counts().rename("rows"),
                       left_on="i_item_sk", right_index=True)
    out = {}
    for r in j.itertuples(index=False):
        r = r._asdict()
        g = out.setdefault((r["ub"], r["cc"]), {"n": 0})
        g["n"] += int(r["rows"])
        for n, _, kind, _ in cols:
            if kind == "str":
                key = "max_" + n
                g[key] = r[n] if key not in g else max(g[key], r[n])
            else:
                key = "sum_" + n
                g[key] = g.get(key, 0) + int(r[n]) * int(r["rows"])
    rows = []
    for (ub, cc), g in sorted(out.items()):
        row = {"ub": ub, "cc": cc}
        for n, _, kind, _ in cols:
            key = ("max_" if kind == "str" else "sum_") + n
            row[key] = g[key]
        row["n"] = g["n"]
        rows.append(row)
    return rows


def g2_columns(L: Lib):
    """(name, expression, kind) of G2's projection: the device classes
    over the untyped store_sales' plain columns."""
    E = L.E
    col, lit = E.col, E.lit
    item, cust, qty, price, paid, date = (
        col("ss_item_sk"), col("ss_customer_sk"), col("ss_quantity"),
        col("ss_sales_price"), col("ss_net_paid"), col("ss_sold_date"))
    return [
        ("len", E.Length(paid), "num"), ("oct", E.OctetLength(date), "num"),
        ("bits", E.BitLength(item), "num"),
        ("left", E.StringLeft(date, 4), "str"),
        ("right", E.StringRight(paid, 3), "str"),
        ("up", E.Upper(E.Concat(item, lit("x"))), "str"),
        ("lo", E.Lower(price), "str"),
        ("sw", E.StartsWith(paid, lit("1")), "bool"),
        ("ew", E.EndsWith(price, lit("9")), "bool"),
        ("ct", E.Contains(paid, lit("99")), "bool"),
        ("cat", E.Concat(item, lit("-"), qty), "str"),
        ("cws", E.ConcatWs(cust, qty, date, sep="|"), "str"),
        ("tr", E.StringTrim(paid, "0"), "str"),
        ("trl", E.StringTrimLeft(price, "1"), "str"),
        ("trr", E.StringTrimRight(date, "0123"), "str"),
        ("rep", E.StringReplace(date, "-", "//"), "str"),
        ("rep2", E.StringReplace(paid, "00", "#"), "str"),
        ("instr", E.StringInstr(paid, "."), "num"),
        ("loc", E.StringLocate(date, "-", 6), "num"),
        ("lpad", E.StringLPad(item, 8, "0"), "str"),
        ("rpad", E.StringRPad(qty, 4, "ab"), "str"),
        ("rpt", E.StringRepeat(qty, 2), "str"),
        ("rev", E.StringReverse(paid), "str"),
        ("tl", E.StringTranslate(date, "0-", "o"), "str"),
        ("ic", E.InitCap(E.ConcatWs(qty, lit("ab cd"), sep=" ")), "str"),
        ("si", E.SubstringIndex(date, "-", 2), "str"),
        ("si2", E.SubstringIndex(paid, ".", -1), "str"),
        ("fis", E.FindInSet(qty, "1,2,3,50,99"), "num"),
        ("ov", E.Overlay(date, lit("~"), 5, 1), "str"),
        ("asc", E.Ascii(price), "num"),
        ("chr", E.Chr(E.Add(E.Pmod(E.Cast(qty, L.T.INT), lit(26)),
                            lit(65))), "str"),
        ("rlike", E.RLike(paid, "^[0-9]+\\.[0-9]9$"), "bool"),
        ("b64", E.Base64(paid), "str"),
        ("hex", E.Hex(date), "str"),
        ("hexn", E.Hex(E.Cast(item, L.T.LONG)), "str"),
    ]


G2_BAD = ("bad_hex", "bad_b64")


def g2(d, L: Lib = None, part: int = None):
    """G2; ``part`` 0 or 1 keeps the first or the second half of its
    columns (the same rows: a check can run the halves apart)."""
    L = L or port_lib()
    E, T = L.E, L.T
    col = E.col
    cols = _half(g2_columns(L), part)
    paid, date = col("ss_net_paid"), col("ss_sold_date")

    def bad(x, back):  # 1 where a round trip changes the value
        return E.Cast(E.Not(E.EqualTo(back, x)), T.INT)

    def value(e, kind):  # a string's byte count, a boolean's 0 or 1
        return (E.OctetLength(e) if kind == "str" else
                E.Cast(e, T.INT) if kind == "bool" else e)

    p = d["untyped_store_sales"].select(
        col("ss_store_sk"), *[E.Alias(value(e, k), n) for n, e, k in cols],
        E.Alias(bad(E.Hex(date), E.Hex(E.Unhex(E.Hex(date)))), "bad_hex"),
        E.Alias(bad(E.Hex(paid), E.Hex(E.UnBase64(E.Base64(paid)))),
                "bad_b64"))
    aggs = []
    for n, _, _ in cols:
        aggs += [E.Alias(E.Sum(E.col(n)), f"sum_{n}"),
                 E.Alias(E.Count(E.col(n)), f"n_{n}")]
    aggs += [E.Alias(E.Sum(col(b)), b) for b in G2_BAD]
    return p.group_by("ss_store_sk").agg(*aggs).sort(
        L.SortOrder(col("ss_store_sk")))


def g3(d, L: Lib = None, rejected: bool = False):
    """G3 (``rejected``: G3R, customer filtered by a back-reference)."""
    L = L or port_lib()
    E = L.E
    col = E.col
    pattern = G3_REJECTED if rejected else G3_EMAIL
    cust = d["customer"].filter(E.RLike(col("c_email_address"), pattern))
    s = d["store_sales"].select(col("ss_customer_sk"), col("ss_item_sk"),
                                col("ss_quantity"))
    j = s.join(cust.select(col("c_customer_sk")),
               left_on="ss_customer_sk", right_on="c_customer_sk").join(
        d["item"].select(col("i_item_sk"), col("i_item_desc"),
                         col("i_class")),
        left_on="ss_item_sk", right_on="i_item_sk")
    if not rejected:
        j = j.filter(E.RLike(col("i_item_desc"), G3_DESC))
    return j.select(E.Alias(col("i_class"), "cls"),
                    col("ss_quantity")).group_by("cls").agg(
        E.Alias(E.Sum(col("ss_quantity")), "qty"),
        E.Alias(E.Count(), "n")).sort(L.SortOrder(col("cls")))


def g3_rejected(d, L: Lib = None):
    return g3(d, L, rejected=True)


def g4_columns(L: Lib):
    """(name, expression, kind) of G4's projection: the CPU engine's
    classes (RegexpExtract and RegexpReplace only in the port: the
    reference's CPU engine does not evaluate them)."""
    E, T = L.E, L.T
    col, lit = E.col, E.lit
    item, qty, paid, date, price, store = (
        col("ss_item_sk"), col("ss_quantity"), col("ss_net_paid"),
        col("ss_sold_date"), col("ss_sales_price"), col("ss_store_sk"))
    cols = [
        ("md5", E.Md5(date), "str"), ("sha1", E.Sha1(qty), "str"),
        ("sha2", E.Sha2(price, 256), "str"), ("crc", E.Crc32(item), "num"),
        ("lev", E.Levenshtein(qty, store), "num"),
        ("fmt", E.FormatNumber(E.Cast(price, T.DOUBLE), 1), "str"),
        ("space", E.Concat(E.StringSpace(E.Pmod(E.Cast(qty, T.INT),
                                                lit(5))), lit("|")), "str"),
        ("bin", E.Bin(E.Cast(item, T.LONG)), "str"),
        ("ov", E.Overlay(date, store, 6), "str"),
    ]
    if L.port:
        cols += [("rx", E.RegexpExtract(date, "^(\\d+)-(\\d+)", 2), "str"),
                 ("rr", E.RegexpReplace(price, "(\\d+)\\.(\\d)", "$2.$1"),
                  "str")]
    return cols


def g4(d, L: Lib = None, store: str = None):
    L = L or port_lib()
    E, T = L.E, L.T
    col = E.col
    cols = g4_columns(L)
    s = d["untyped_store_sales"].filter(E.EqualTo(col("ss_store_sk"),
                                                  E.lit(store)))
    p = s.select(col("ss_store_sk"), *[E.Alias(e, n) for n, e, _ in cols])
    aggs = []
    for n, _, kind in cols:
        if kind == "str":
            aggs += [E.Alias(E.Max(col(n)), f"max_{n}"),
                     E.Alias(E.Min(col(n)), f"min_{n}")]
        else:
            aggs.append(E.Alias(E.Sum(col(n)), f"sum_{n}"))
    return p.group_by("ss_store_sk").agg(*aggs, E.Alias(E.Count(), "n"))


G5_ORDER = ("ss_ticket_number", "ss_item_sk")


def g5(d, L: Lib = None):
    L = L or port_lib()
    E, W = L.E, L.W
    col = E.col
    j = d["store_sales"].select(col("ss_item_sk"), col("ss_ticket_number"),
                                col("ss_quantity")).join(
        d["item"].select(col("i_item_sk"), col("i_brand")),
        left_on="ss_item_sk", right_on="i_item_sk")
    s = j.select(E.Alias(E.Lower(col("i_brand")), "part"),
                 col("ss_ticket_number"), col("ss_item_sk"),
                 col("ss_quantity"))
    order = tuple(L.SortOrder(col(c)) for c in G5_ORDER)
    running = W.WindowSpec((col("part"),), order,
                           W.WindowFrame("rows", None, 0))
    last30 = W.WindowSpec((col("part"),), order,
                          W.WindowFrame("rows", -30, 0))
    w = s.with_window(
        E.Alias(W.WindowExpression(E.Sum(col("ss_quantity")), running),
                "run"),
        E.Alias(W.WindowExpression(E.Sum(col("ss_quantity")), last30),
                "last30"))
    return w.group_by("part").agg(
        E.Alias(E.Sum(col("run")), "sum_run"),
        E.Alias(E.Sum(col("last30")), "sum_last30"),
        E.Alias(E.Count(), "n")).sort(L.SortOrder(col("part")))


QUERIES = {"G1": g1, "G2": g2, "G3": g3, "G3R": g3_rejected, "G4": g4,
           "G5": g5}


def first_store(tables) -> str:
    return pc.min(tables["untyped_store_sales"].column(
        "ss_store_sk")).as_py()


def check_rows(name: str, got, exp):
    """(ok, reason): ``scalar_sales.check_rows`` with this pass's ORDER BY
    keys."""
    return SS.check_rows(name, got, exp, ORDER_KEYS)
