"""Delta table operations (the port's counterpart of
spark_rapids_tpu/delta/table.py; the reference plugin's GpuDeleteCommand,
GpuUpdateCommand, GpuMergeIntoCommand and GpuDeltaParquetFileFormat):
scans that apply deletion vectors, append, DELETE, UPDATE and MERGE.

- A scan reads the snapshot's files and drops each file's deleted rows.
- DELETE evaluates its predicate on the device over each file's rows and
  writes a deletion-vector sidecar for each file with a match
  (merge-on-read); a file whose rows are all deleted is removed.
- UPDATE rewrites each file with a match through the device's projection
  (copy-on-write): a column becomes If(condition, assignment, column).
- MERGE rewrites each file with a matched key and appends the source rows
  that matched nothing; the substitution is on the host, as the
  reference's. Its matching is Spark's where the reference's is not: a
  null key matches nothing, and a target row that more than one source
  row matches raises (the reference keys a dict by the source value, so a
  null matches a null and the last duplicate wins).

Data files are written as the port's writer writes them (``io/writer.py``):
decimals of precision up to 18 as integers, as Spark stores them (the
reference's as byte arrays); the rows read back are the same. The log's
actions are the reference's.
"""

from __future__ import annotations

import json
import os
import uuid
from typing import Dict, Optional

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (
    batch_from_arrow, batch_to_arrow, dictionary_encode_table,
    resolve_device)
from spark_rapids_tpu_torch.delta.log import (
    AddFile, DeltaLog, read_dv, write_dv)
from spark_rapids_tpu_torch.exec.base import BatchSourceExec, DeviceExec
from spark_rapids_tpu_torch.exprs import eval as EV
from spark_rapids_tpu_torch.exprs import expr as E

# Delta primitive names <-> Arrow types (the protocol's schema
# serialisation); inverse maps, so an empty snapshot reads back with the
# written types
_ARROW_TO_DELTA = {"int64": "long", "int32": "integer", "int16": "short",
                   "int8": "byte", "double": "double", "float": "float",
                   "bool": "boolean", "string": "string",
                   "binary": "binary", "date32[day]": "date",
                   "timestamp[us, tz=UTC]": "timestamp",
                   "timestamp[us]": "timestamp_ntz"}
_DELTA_TO_ARROW = {"long": pa.int64(), "integer": pa.int32(),
                   "short": pa.int16(), "byte": pa.int8(),
                   "double": pa.float64(), "float": pa.float32(),
                   "boolean": pa.bool_(), "string": pa.string(),
                   "binary": pa.binary(), "date": pa.date32(),
                   "timestamp": pa.timestamp("us", "UTC"),
                   "timestamp_ntz": pa.timestamp("us")}


def _delta_type(t: pa.DataType) -> str:
    if pa.types.is_decimal(t):
        return f"decimal({t.precision},{t.scale})"
    return _ARROW_TO_DELTA.get(str(t), str(t))


def _schema_to_delta_json(schema: pa.Schema) -> str:
    fields = [{"name": f.name, "type": _delta_type(f.type),
               "nullable": f.nullable, "metadata": {}} for f in schema]
    return json.dumps({"type": "struct", "fields": fields})


def _delta_json_to_schema(schema_json: Optional[str]) -> pa.Schema:
    if not schema_json:
        return pa.schema([])

    def _typ(name: str) -> pa.DataType:
        if name in _DELTA_TO_ARROW:
            return _DELTA_TO_ARROW[name]
        if name.startswith("decimal"):
            p, s = name[name.index("(") + 1:-1].split(",")
            return pa.decimal128(int(p), int(s))
        raise ValueError(f"unsupported delta type {name!r}")

    fields = [pa.field(f["name"], _typ(f["type"]), f.get("nullable", True))
              for f in json.loads(schema_json).get("fields", [])]
    return pa.schema(fields)


def _column_names(e: E.Expression) -> set:
    out, stack = set(), [e]
    while stack:
        x = stack.pop()
        if isinstance(x, E.UnresolvedColumn):
            out.add(x.name)
        stack.extend(x.children)
    return out


class DeltaTable:
    """A Delta table at ``path``; its predicates and projections run on
    ``device`` (``cuda`` unless named; without a card it raises)."""

    def __init__(self, path: str, device=None):
        self.path = path
        self.log = DeltaLog(path)
        self.device = resolve_device(device)

    # -- write -------------------------------------------------------------
    @staticmethod
    def create(path: str, table: pa.Table, device=None) -> "DeltaTable":
        t = DeltaTable(path, device)
        os.makedirs(path, exist_ok=True)
        add = t._write_file(table)
        t.log.commit([add], [], "WRITE",
                     schema_json=_schema_to_delta_json(table.schema))
        return t

    def append(self, table: pa.Table) -> int:
        return self.log.commit([self._write_file(table)], [], "WRITE")

    def _write_file(self, table: pa.Table) -> AddFile:
        name = f"part-{uuid.uuid4().hex}.parquet"
        full = os.path.join(self.path, name)
        pq.write_table(table, full, store_decimal_as_integer=True)
        return AddFile(name, os.path.getsize(full), table.num_rows, {})

    # -- read --------------------------------------------------------------
    def _file_table(self, add: AddFile) -> pa.Table:
        t = pq.read_table(os.path.join(self.path, add.path))
        if add.deletion_vector:
            deleted = read_dv(self.path, add.deletion_vector)
            keep = np.ones(t.num_rows, bool)
            keep[deleted[deleted < t.num_rows]] = False
            t = t.filter(pa.array(keep))
        return t

    def to_arrow(self, version: Optional[int] = None) -> pa.Table:
        """The snapshot's rows (the latest, or ``version``), deleted rows
        dropped; an empty snapshot has the logged schema."""
        snap = self.log.snapshot(version)
        tables = [self._file_table(a) for a in snap.files]
        if not tables:
            return _delta_json_to_schema(snap.schema_json).empty_table()
        return pa.concat_tables(tables)

    def scan_exec(self, version: Optional[int] = None) -> DeviceExec:
        """The snapshot as a source node of one partition and one batch
        on the table's device, strings dictionary-encoded as the
        planner's in-memory scan encodes them."""
        t = self.to_arrow(version)
        schema = T.Schema.from_arrow(t.schema)
        b = batch_from_arrow(dictionary_encode_table(t), self.device,
                             dict_cache={})
        return BatchSourceExec([[b]], schema, self.device)

    # -- DELETE (merge-on-read through deletion vectors) -------------------
    def delete(self, condition: E.Expression) -> int:
        """Delete the rows where ``condition`` is true, by sidecar; the
        committed version (the current one when nothing matched)."""
        snap = self.log.snapshot()
        adds, removes = [], []
        for add in snap.files:
            t = pq.read_table(os.path.join(self.path, add.path))
            mask = self._eval_mask(condition, t)
            prior = set()
            if add.deletion_vector:
                already = read_dv(self.path, add.deletion_vector)
                already = already[already < t.num_rows]
                mask[already] = False
                prior = set(int(i) for i in already)
            hit = np.nonzero(mask)[0]
            if hit.size == 0:
                continue
            all_deleted = sorted(prior | set(int(i) for i in hit))
            removes.append(add.path)
            if len(all_deleted) >= t.num_rows:
                continue  # every row gone: the file goes
            dv = write_dv(self.path, np.asarray(all_deleted))
            adds.append(AddFile(add.path, add.size,
                                t.num_rows - len(all_deleted),
                                add.partition_values, dv))
        if not adds and not removes:
            return snap.version
        return self.log.commit(adds, removes, "DELETE")

    def _eval_mask(self, condition: E.Expression,
                   t: pa.Table) -> np.ndarray:
        """``condition`` over a file's rows, on the table's device: true
        where it is true (null is false). Only the columns it names are
        uploaded (the first one when it names none)."""
        names = _column_names(condition)
        t = t.select([c for c in t.column_names if c in names]
                     or t.column_names[:1])
        schema = T.Schema.from_arrow(t.schema)
        b = batch_from_arrow(t, self.device)
        res = EV.eval_expr(E.resolve(condition, schema), EV.EvalContext(b))
        return (res.data & res.validity).cpu().numpy().copy()

    # -- UPDATE (copy-on-write) --------------------------------------------
    def update(self, condition: E.Expression,
               assignments: Dict[str, E.Expression]) -> int:
        """Rewrite each file with a match through the device's projection:
        a column becomes If(condition, assignment, column)."""
        from spark_rapids_tpu_torch.exec.project import ProjectExec

        snap = self.log.snapshot()
        adds, removes = [], []
        for add in snap.files:
            t = self._file_table(add)
            if not self._eval_mask(condition, t).any():
                continue
            schema = T.Schema.from_arrow(t.schema)
            src = BatchSourceExec([[batch_from_arrow(t, self.device)]],
                                  schema, self.device)
            exprs = []
            for f in schema:
                if f.name in assignments:
                    exprs.append(E.Alias(
                        E.If(condition, assignments[f.name], E.col(f.name)),
                        f.name))
                else:
                    exprs.append(E.Alias(E.col(f.name), f.name))
            node = ProjectExec(exprs, src)
            new_t = pa.concat_tables(
                batch_to_arrow(b, node.output_schema)
                for b in node.execute_all()).cast(t.schema)
            adds.append(self._write_file(new_t))
            removes.append(add.path)
        if not adds:
            return snap.version
        return self.log.commit(adds, removes, "UPDATE")

    # -- MERGE -------------------------------------------------------------
    def merge(self, source: pa.Table, on_target: str, on_source: str,
              when_matched_update: Optional[Dict[str, str]] = None,
              when_not_matched_insert: bool = True) -> int:
        """MERGE INTO target USING source ON target.k = source.k
        WHEN MATCHED THEN UPDATE SET tcol = scol ...
        WHEN NOT MATCHED THEN INSERT (the columns matched by name).

        Copy-on-write of each file holding a matched key (GpuMergeInto's
        low-shuffle shape). A null key matches nothing; a target row that
        two source rows match raises ValueError, as Delta does."""
        snap = self.log.snapshot()
        src_rows = source.to_pylist()
        src_by_key: dict = {}
        repeated = set()
        for r in src_rows:
            k = r[on_source]
            if k is None:
                continue
            if k in src_by_key:
                repeated.add(k)
            src_by_key[k] = r
        adds, removes = [], []
        matched_target_keys = set()
        for add in snap.files:
            t = self._file_table(add)
            tkeys = t.column(on_target).to_pylist()
            hits = [i for i, k in enumerate(tkeys)
                    if k is not None and k in src_by_key]
            if not hits:
                continue
            if when_matched_update:
                twice = sorted({tkeys[i] for i in hits} & repeated)
                if twice:
                    raise ValueError(
                        f"MERGE: more than one source row matched the "
                        f"target rows of {on_target} = {twice[0]!r}")
            matched_target_keys.update(tkeys[i] for i in hits)
            rows = t.to_pylist()
            for i in hits:
                srow = src_by_key[tkeys[i]]
                for tcol, scol in (when_matched_update or {}).items():
                    rows[i][tcol] = srow[scol]
            adds.append(self._write_file(
                pa.Table.from_pylist(rows, schema=t.schema)))
            removes.append(add.path)
        if when_not_matched_insert:
            if snap.files:
                target_schema = pq.read_schema(
                    os.path.join(self.path, snap.files[0].path))
            else:
                target_schema = source.schema
            names = set(target_schema.names)
            ins_rows = [{k: v for k, v in r.items() if k in names}
                        for r in src_rows
                        if r[on_source] is None
                        or r[on_source] not in matched_target_keys]
            if ins_rows:
                adds.append(self._write_file(
                    pa.Table.from_pylist(ins_rows, schema=target_schema)))
        if not adds and not removes:
            return snap.version
        return self.log.commit(adds, removes, "MERGE")
