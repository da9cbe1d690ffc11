"""The port's sorted-hash join path, held against the JAX package on the
CPU:

- ``kernels.prepare_join_side`` and ``join_candidate_counts`` against the
  reference's: the same build rows in the same hash order and the same
  candidate ranges, over hashes on both sides of 2^63 (the port searches
  the top-bit-flipped bits, the reference the uint64 hash), null keys on
  both sides;
- every join type (inner, left, right, full, left_semi, left_anti)
  through the port's ``HashJoinExec`` with
  ``spark.rapids.gpu.sql.join.hashTable.enabled=false``, and with the
  hash table on but every seeded table build forced to overflow its probe
  bound (the fallback), against the reference's ``HashJoinExec`` with its
  own key off and against the port's CPU engine: null keys, duplicate
  build keys, int, two-column and plain-string keys, empty build and
  probe sides, three probe batches and a chunk budget small enough to cut
  a batch into chunks. Results are compared as row multisets, and the
  operator's metrics must name the path it took.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar import batch as JB
from spark_rapids_tpu.config import conf as JC
from spark_rapids_tpu.exec import HashJoinExec as JJoin
from spark_rapids_tpu.exec import kernels as JK
from spark_rapids_tpu.exprs import expr as JE
from spark_rapids_tpu_torch.bench.tpch import rows_match
from spark_rapids_tpu_torch.columnar import batch as PB
from spark_rapids_tpu_torch.config import conf as PC
from spark_rapids_tpu_torch.exec import kernels as PK
from spark_rapids_tpu_torch.exec.join import HashJoinExec as PJoin
from spark_rapids_tpu_torch.exprs import expr as PE

from test_torch_joins import (CASES, CHUNK_KEY, HT_CONF, JOIN_TYPES, _rows,
                              _port_cpu_engine, _sources)

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

SORTED = {"spark.rapids.tpu.sql.join.hashTable.enabled": "false"}
PORT_OFF = {"spark.rapids.gpu.sql.join.hashTable.enabled": "false"}


def _np(x):
    return np.asarray(x)


def test_sorted_join_structures_match_jax_across_two_to_the_63():
    rng = np.random.default_rng(61)
    n, m = 3000, 5000
    build = pa.table({"k": pa.array(rng.integers(0, 900, n), pa.int64(),
                                    mask=rng.random(n) < 0.05)})
    probe = pa.table({"k": pa.array(rng.integers(0, 1200, m), pa.int64(),
                                    mask=rng.random(m) < 0.05)})
    jb, jp = JB.batch_from_arrow(build, 16), JB.batch_from_arrow(probe, 16)
    pb, pp = PB.batch_from_arrow(build, "cpu"), PB.batch_from_arrow(probe,
                                                                    "cpu")
    jh = JK.prepare_join_side(jb, [0])
    ph = PK.prepare_join_side(pb, [0])
    nv = int(np.sum(_np(jh.valid)))
    assert ph.order.numel() == nv == int(pb.columns[0].validity.sum())
    # the same rows in the same order, and the same hashes as uint64
    np.testing.assert_array_equal(ph.order.numpy(), _np(jh.order)[:nv])
    bits = (ph.sorted_hash ^ PK._INT64_MIN).numpy().view(np.uint64)
    np.testing.assert_array_equal(bits, _np(jh.sorted_hash)[:nv])
    # hashes on both sides of 2^63 (a signed sort would put them apart)
    assert bits.min() < 1 << 63 <= bits.max()
    assert np.all(np.diff(ph.sorted_hash.numpy()) >= 0)
    jlo, jcnt, _ = JK.join_candidate_counts(jp, [0], jh)
    plo, pcnt = PK.join_candidate_counts(pp, [0], ph)
    jlo, jcnt = _np(jlo)[:m], _np(jcnt)[:m]
    np.testing.assert_array_equal(pcnt.numpy(), jcnt)
    hit = jcnt > 0
    assert hit.sum() > m // 2
    np.testing.assert_array_equal(plo.numpy()[hit], jlo[hit])


def _jax_sorted(left, lrows, right, rrows, lk, rk, chunk, how):
    jl, _ = _sources(left, lrows)
    jr, _ = _sources(right, rrows)
    jconf = dict(HT_CONF, **SORTED)
    if chunk is not None:
        jconf["spark.rapids.tpu.sql.join." + CHUNK_KEY] = str(chunk)
    saved = JC.get_active()
    JC.set_active(JC.RapidsConf(jconf))
    before = JK.counters()["hashtbl_probe_total"]
    try:
        exp = _rows(JJoin([JE.col(c) for c in lk], [JE.col(c) for c in rk],
                          how, jl, jr), JB.batch_to_arrow)
    finally:
        JC.set_active(saved)
    assert JK.counters()["hashtbl_probe_total"] == before  # JAX sorted
    return exp


def _port(left, lrows, right, rrows, lk, rk, chunk, how, conf):
    _, pl = _sources(left, lrows)
    _, pr = _sources(right, rrows)
    pconf = dict(conf)
    if chunk is not None:
        pconf["spark.rapids.gpu.sql.join." + CHUNK_KEY] = str(chunk)
    saved = PC.get_active()
    PC.set_active(PC.RapidsConf(pconf))
    try:
        node = PJoin([PE.col(c) for c in lk], [PE.col(c) for c in rk], how,
                     pl, pr)
    finally:
        PC.set_active(saved)
    return _rows(node, PB.batch_to_arrow), node


@pytest.mark.parametrize("how", JOIN_TYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_sorted_hash_join_matches_jax_and_cpu_engine(case, how,
                                                      monkeypatch):
    args = CASES[case]()
    left, right = args[0], args[2]
    exp = _jax_sorted(*args, how)
    built = bool(right.num_rows)
    # the key off: every join takes the sorted-hash path
    got, node = _port(*args, how, PORT_OFF)
    assert len(got) == len(exp) and rows_match(got, exp), (len(got),
                                                           len(exp))
    assert node.join_path == ("sorted" if built else None)
    assert node.metrics["hashTableJoins"].value == 0
    assert node.metrics["sortedHashJoins"].value == int(built)
    assert node.metrics["sortedHashFallbacks"].value == 0
    # the key on, every seeded table build overflowing: the fallback
    real = PK.build_hash_table

    def always_overflow(h1, h2, valid, capacity, seed, max_probes):
        return real(h1, h2, valid, capacity, seed, max_probes)[0], True

    monkeypatch.setattr(PK, "build_hash_table", always_overflow)
    got, node = _port(*args, how, {})
    assert len(got) == len(exp) and rows_match(got, exp)
    assert node.join_path == ("sorted" if built else None)
    assert node.metrics["sortedHashFallbacks"].value == int(built)
    assert node.metrics["hashTableJoins"].value == 0
    monkeypatch.undo()
    lk, rk = args[4], args[5]
    assert rows_match(_port_cpu_engine(left, right, lk, rk, how), exp)
