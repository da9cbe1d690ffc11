"""get_json_object and JsonToStructsText in the port, held against the
JAX package on the CPU: the reference's documents and ``PATHS`` of
``tests/test_json_device.py`` on the port's device path against the
reference's device path and on the port's CPU engine against the
reference's CPU engine; JSON control escapes; a path outside the device's
grammar placed on the CPU engine with the reference's reason.

Tolerance: exact.
"""

import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.config.conf import RapidsConf as JConf
from spark_rapids_tpu.exprs import expr as JE
from spark_rapids_tpu.plan import from_arrow as jax_from_arrow
from spark_rapids_tpu_torch.config.conf import RapidsConf
from spark_rapids_tpu_torch.exprs import expr as PE
from spark_rapids_tpu_torch.exprs import json_device as JD
from spark_rapids_tpu_torch.plan import from_arrow as port_from_arrow
from test_json_device import DOCS, PATHS

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

ESCAPES = ['{"a": "tab\\there"}', '{"a": "line\\nbreak\\r"}',
           '{"a": "\\b\\f"}', '{"a": "sl\\/ash"}', '{"a": "\\u00e9"}',
           '{"a": ["x\\"y", "z"]}', '{"a": {"b": "q\\\\"}}']
DOC_TABLE = pa.table({"s": pa.array(DOCS + ESCAPES, pa.string())})


def _select(M, paths):
    return [M.GetJsonObject(M.col("s"), p).alias(f"p{i}")
            for i, p in enumerate(paths)]


_JAX = {}


def jax_rows(device: bool):
    if device not in _JAX:
        conf = JConf({"spark.rapids.tpu.sql.enabled": device})
        _JAX[device] = jax_from_arrow(DOC_TABLE, conf).select(
            *_select(JE, PATHS)).to_arrow().to_pylist()
    return _JAX[device]


def port_df(device: bool, paths=PATHS):
    conf = None if device else RapidsConf({"spark.rapids.gpu.sql.enabled":
                                           "false"})
    return port_from_arrow(DOC_TABLE, conf, device="cpu").select(
        *_select(PE, paths))


@pytest.mark.parametrize("device", [True, False], ids=["device", "cpu"])
def test_get_json_object_matches_the_reference(device):
    df = port_df(device)
    if device:
        assert "!" not in df.explain()
    assert df.to_arrow().to_pylist() == jax_rows(device)


def test_control_escapes_are_substituted():
    got = port_df(True, ["$.a", "$.a[0]", "$.a.b"]).to_arrow().to_pylist()
    tail = got[len(DOCS):]
    assert [r["p0"] for r in tail[:4]] == ["tab\there", "line\nbreak\r",
                                          "\b\f", "sl/ash"]
    # a \\uXXXX escape loses its backslash and keeps its digits, as the
    # reference's device does (its docstring says verbatim)
    assert tail[4]["p0"] == "u00e9"
    assert tail[5]["p1"] == 'x"y' and tail[6]["p2"] == "q\\"


def test_unsupported_path_runs_on_the_cpu_engine_with_its_reason():
    path = "$.a[*]"
    assert JD.parse_path(path) is None
    df = port_df(True, [path, "$.a"])
    bad = [ln for ln in df.explain().splitlines() if "!" in ln]
    reason = f"json path {path!r} not on device"
    assert len(bad) == 1 and reason in bad[0]
    ref = jax_from_arrow(DOC_TABLE, JConf({})).select(*_select(JE, [path,
                                                                    "$.a"]))
    assert reason in ref.explain()
    assert df.to_arrow().to_pylist() == ref.to_arrow().to_pylist()


def test_json_to_structs_text_matches_the_reference_cpu_engine():
    df = port_from_arrow(DOC_TABLE, device="cpu").select(
        PE.JsonToStructsText(PE.col("s")).alias("j"))
    assert "expression JsonToStructsText not on device" in df.explain()
    ref = jax_from_arrow(DOC_TABLE, JConf({})).select(
        JE.JsonToStructsText(JE.col("s")).alias("j"))
    assert df.to_arrow().to_pylist() == ref.to_arrow().to_pylist()
