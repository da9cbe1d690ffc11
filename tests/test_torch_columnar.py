"""Arrow -> batch -> Arrow through the port (spark_rapids_tpu_torch.columnar)
held against the JAX package's batch_from_arrow/batch_to_arrow: the same
values, nulls, and the same sorted dictionaries and codes."""

import datetime

import jax
import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import batch as JB
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar import batch as PB


def _table(n, seed):
    rng = np.random.default_rng(seed)
    nulls = lambda: rng.random(n) < 0.2  # noqa: E731
    words = np.array(["R", "A", "N", "MIDDLE EAST", "", "é-accent"])
    return pa.table({
        "l": pa.array(rng.integers(-10**15, 10**15, n), pa.int64(),
                      mask=nulls()),
        "i": pa.array(rng.integers(-100, 100, n).astype(np.int32),
                      pa.int32(), mask=nulls()),
        "d": pa.array(rng.normal(0, 1, n), pa.float64(), mask=nulls()),
        "dt": pa.array(rng.integers(0, 20000, n).astype(np.int32),
                       pa.int32(), mask=nulls()).cast(pa.date32()),
        "b": pa.array(rng.random(n) < 0.5, pa.bool_(), mask=nulls()),
        "s_dict": pa.array(words[rng.integers(0, len(words), n)].tolist(),
                           pa.string(), mask=nulls()),
        "s_plain": pa.array([f"row{int(x)}" for x in rng.integers(0, 10**9, n)],
                            pa.string(), mask=nulls()),
    })


@pytest.mark.parametrize("n,seed", [(1, 0), (50, 1), (333, 2)])
def test_round_trip_matches_jax(n, seed):
    t = JB.dictionary_encode_table(_table(n, seed))
    schema_p = PT.Schema.from_arrow(t.schema)
    schema_j = JT.Schema.from_arrow(t.schema)
    got = PB.batch_to_arrow(PB.batch_from_arrow(t, "cpu"), schema_p)
    exp = JB.batch_to_arrow(JB.batch_from_arrow(t), schema_j)
    assert got.schema == exp.schema
    assert got.to_pydict().keys() == exp.to_pydict().keys()
    for name in t.column_names:
        g = got.column(name).to_pylist()
        e = exp.column(name).to_pylist()
        if name == "d":
            np.testing.assert_array_equal(
                np.array([np.nan if v is None else v for v in g]),
                np.array([np.nan if v is None else v for v in e]))
        else:
            assert g == e, name
    # and both equal the source rows
    src = t.column("s_dict").cast(pa.string()).to_pylist()
    assert got.column("s_dict").to_pylist() == src


def test_dictionary_sorted_and_codes_match_jax():
    t = JB.dictionary_encode_table(_table(400, 5))
    jb = JB.batch_from_arrow(t)
    pb = PB.batch_from_arrow(t, "cpu")
    names = t.column_names
    k = names.index("s_dict")
    jc, pc = jb.columns[k], pb.columns[k]
    assert pc.is_dict and jc.is_dict
    n = pb.num_rows
    np.testing.assert_array_equal(pc.data.numpy(),
                                  np.asarray(jax.device_get(jc.data))[:n])
    dsize = jc.dict_size
    joff = np.asarray(jax.device_get(jc.dictionary.offsets))[: dsize + 1]
    np.testing.assert_array_equal(pc.dictionary.offsets.numpy(), joff)
    jbytes = np.asarray(jax.device_get(jc.dictionary.data))[: joff[-1]]
    np.testing.assert_array_equal(pc.dictionary.data.numpy(), jbytes)
    # code order is byte order
    d = pc.dictionary
    entries = [bytes(d.data[d.offsets[i]:d.offsets[i + 1]].numpy())
               for i in range(d.num_rows)]
    assert entries == sorted(entries)
    # the plain-string rule: high-cardinality strings stay plain
    assert pb.columns[names.index("s_plain")].offsets is not None


def test_slices_share_one_dictionary():
    t = JB.dictionary_encode_table(_table(100, 3))
    cache = {}
    a = PB.batch_from_arrow(t.slice(0, 40), "cpu", dict_cache=cache)
    b = PB.batch_from_arrow(t.slice(40, 60), "cpu", dict_cache=cache)
    k = t.column_names.index("s_dict")
    assert a.columns[k].dictionary is b.columns[k].dictionary
    cat = PB.concat_batches([a, b])
    schema = PT.Schema.from_arrow(t.schema)
    assert PB.batch_to_arrow(cat, schema).column("s_dict").to_pylist() == \
        t.column("s_dict").cast(pa.string()).to_pylist()


def test_date_and_empty_batches():
    t = pa.table({"dt": pa.array([datetime.date(1995, 3, 15), None],
                                 pa.date32())})
    schema = PT.Schema.from_arrow(t.schema)
    out = PB.batch_to_arrow(PB.batch_from_arrow(t, "cpu"), schema)
    assert out.column("dt").to_pylist() == [datetime.date(1995, 3, 15), None]
    empty = PB.batch_from_arrow(t.slice(0, 0), "cpu")
    assert empty.num_rows == 0
    assert PB.batch_to_arrow(empty, schema).num_rows == 0
