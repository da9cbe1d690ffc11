"""The port (spark_rapids_tpu_torch) stands alone: it imports neither JAX
nor the JAX package, and its entry points never move to the CPU unasked."""

import ast
import os
import pkgutil
import subprocess
import sys

import pyarrow as pa
import pytest
import torch

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "spark_rapids_tpu_torch")


def _modules():
    import spark_rapids_tpu_torch

    names = ["spark_rapids_tpu_torch"]
    for m in pkgutil.walk_packages(spark_rapids_tpu_torch.__path__,
                                   "spark_rapids_tpu_torch."):
        names.append(m.name)
    return names


def test_every_module_imports_without_jax():
    mods = _modules()
    assert len(mods) > 15
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' "
            "or k.startswith('jax.') or k == 'spark_rapids_tpu' "
            "or k.startswith('spark_rapids_tpu.'))\n"
            "print('BAD', bad)\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "spark_rapids_tpu"
            or name.startswith("spark_rapids_tpu."))


def test_no_source_file_imports_jax_or_the_jax_package():
    files = []
    for d, _, fs in os.walk(PKG):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 15
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_from_arrow_without_device_raises_when_no_card(monkeypatch):
    import torch

    from spark_rapids_tpu_torch.columnar.batch import batch_from_arrow
    from spark_rapids_tpu_torch.plan import from_arrow

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = pa.table({"a": pa.array([1, 2], pa.int64())})
    with pytest.raises(RuntimeError, match="CUDA"):
        from_arrow(t)
    with pytest.raises(RuntimeError, match="CUDA"):
        batch_from_arrow(t)
    # asked for the CPU, it runs there
    assert from_arrow(t, device="cpu").to_arrow().column("a").to_pylist() \
        == [1, 2]


def test_unported_nodes_raise_naming_them():
    from spark_rapids_tpu_torch.exprs import expr as E
    from spark_rapids_tpu_torch.plan import from_arrow

    t = pa.table({"a": pa.array([1, 2], pa.int64())})
    df = from_arrow(t, device="cpu")
    with pytest.raises(NotImplementedError, match="cross join"):
        df.join(df, on="a", how="cross").to_arrow()

    class Modulo(E.Expression):
        pass

    with pytest.raises(NotImplementedError, match="Modulo"):
        df.filter(Modulo()).to_arrow()


def test_the_fallback_engine_modules_are_covered():
    mods = _modules()
    for m in ("spark_rapids_tpu_torch.support",
              "spark_rapids_tpu_torch.plan.cpu",
              "spark_rapids_tpu_torch.plan.cpu_agg",
              "spark_rapids_tpu_torch.plan.overrides"):
        assert m in mods
        assert os.path.exists(os.path.join(
            ROOT, *m.split(".")) + ".py")


def test_the_joins_slice_modules_are_covered():
    """The modules that carry the outer, semi and anti joins, the
    conditionals and the distinct rewrite are walked by the import checks
    above, and hold the names the slice adds."""
    import importlib

    mods = _modules()
    for m, names in (
            ("spark_rapids_tpu_torch.exec.join",
             ("JOIN_TYPES", "join_schema", "HashJoinExec")),
            ("spark_rapids_tpu_torch.exec.kernels",
             ("null_column", "mark_rows", "gather_column_or_null")),
            ("spark_rapids_tpu_torch.exprs.expr",
             ("If", "CaseWhen", "Coalesce", "CountDistinct", "value_as")),
            ("spark_rapids_tpu_torch.plan.overrides", ("rewrite_distinct",)),
            ("spark_rapids_tpu_torch.plan.cpu_agg", ("CpuJoinExec",)),
            ("spark_rapids_tpu_torch.bench.tpcds_schema",
             ("JOIN_TABLES", "gen_store_returns", "gen_catalog_sales",
              "gen_web_sales", "gen_customer", "gen_warehouse",
              "gen_reason", "gen_catalog_returns")),
            ("spark_rapids_tpu_torch.bench.tpcds_queries",
             ("JOINS", "TABLES")),
            ("spark_rapids_tpu_torch.bench.profile_tpch", ("main",))):
        assert m in mods
        mod = importlib.import_module(m)
        for n in names:
            assert hasattr(mod, n), (m, n)


def test_the_union_slice_modules_are_covered():
    """The modules that carry Union, Substring, Like, string-column
    equality and residual join conditions are walked by the import checks
    above, and hold the names the slice adds."""
    import importlib

    mods = _modules()
    for m, names in (
            ("spark_rapids_tpu_torch.exec.misc", ("UnionExec",)),
            ("spark_rapids_tpu_torch.exprs.regex",
             ("like_to_dfa", "match_strings", "DFA")),
            ("spark_rapids_tpu_torch.exprs.expr", ("Substring", "Like")),
            ("spark_rapids_tpu_torch.exprs.eval", ("substring_bytes",)),
            ("spark_rapids_tpu_torch.exec.kernels",
             ("strings_equal", "dictionary_unique")),
            ("spark_rapids_tpu_torch.exec.join",
             ("PairCondition", "condition_columns")),
            ("spark_rapids_tpu_torch.plan.logical", ("Union", "union_widen")),
            ("spark_rapids_tpu_torch.plan.overrides", ("widen_unions",)),
            ("spark_rapids_tpu_torch.plan.cpu",
             ("CpuUnionExec", "substring_sql", "like_regex")),
            ("spark_rapids_tpu_torch.bench.tpcds_queries",
             ("UNION_SLICE", "CONDITION_JOINS", "spend_threshold",
              "with_null_promotions"))):
        assert m in mods
        mod = importlib.import_module(m)
        for n in names:
            assert hasattr(mod, n), (m, n)


def test_the_threshold_queries_catch_nothing():
    """q23 and q24 compute their threshold without an exception handler
    (the reference's bare ``except`` hides a TypeError): no ``try`` in the
    queries module."""
    path = os.path.join(PKG, "bench", "tpcds_queries.py")
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))


def test_no_exception_handler_moves_work_elsewhere():
    """Placement is a plan-time decision: no ``except`` clause in the port
    builds a CPU operator or calls a kernel's plain version."""
    plain = {"probe_hash_table", "segmented_scan"}
    for d, _, fs in os.walk(PKG):
        for f in fs:
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                if not isinstance(node, ast.ExceptHandler):
                    continue
                for sub in ast.walk(node):
                    name = (sub.id if isinstance(sub, ast.Name) else
                            sub.attr if isinstance(sub, ast.Attribute)
                            else "")
                    assert not name.startswith("Cpu"), (path, node.lineno)
                    assert name not in plain, (path, node.lineno)


def test_the_partitioned_slice_modules_are_covered():
    """The modules that carry partitioned execution (the shuffle package,
    the broadcast join, the limits and coalesce, the row estimate) are
    walked by the import checks above, and hold the names the slice
    adds."""
    import importlib

    mods = _modules()
    for m, names in (
            ("spark_rapids_tpu_torch.shuffle.serializer",
             ("serialize_table", "deserialize_table", "merge_tables")),
            ("spark_rapids_tpu_torch.shuffle.integrity",
             ("seal", "unseal", "BlockCorruption")),
            ("spark_rapids_tpu_torch.shuffle.partition",
             ("HashPartitioner", "RoundRobinPartitioner",
              "SinglePartitioner", "RangePartitioner")),
            ("spark_rapids_tpu_torch.shuffle.manager",
             ("ShuffleManager", "get_manager", "set_manager")),
            ("spark_rapids_tpu_torch.shuffle.exchange_exec",
             ("ShuffleExchangeExec",)),
            ("spark_rapids_tpu_torch.exec.join_bcast",
             ("BroadcastHashJoinExec",)),
            ("spark_rapids_tpu_torch.exec.misc",
             ("CoalesceBatchesExec", "LocalLimitExec", "GlobalLimitExec",
              "take_ordered_and_project", "UnionExec")),
            ("spark_rapids_tpu_torch.plan.cbo", ("estimate_rows",))):
        assert m in mods
        mod = importlib.import_module(m)
        for n in names:
            assert hasattr(mod, n), (m, n)


def test_the_adaptive_reuse_and_prefetch_modules_are_covered():
    """The modules that carry adaptive shuffle reads, exchange and
    broadcast reuse and read-ahead are walked by the import checks above,
    and hold the names the slice adds."""
    import importlib

    mods = _modules()
    for m, names in (
            ("spark_rapids_tpu_torch.shuffle.aqe",
             ("CoalescedPartitionSpec", "PartialReducerPartitionSpec",
              "pack_ranges", "coalesce_specs", "split_map_ranges",
              "skew_threshold", "planning_scope", "AQEShuffleReadExec",
              "SkewJoinPlanner", "SkewAwareShuffleReadExec",
              "pair_for_skew_join")),
            ("spark_rapids_tpu_torch.shuffle.manager",
             ("ReadCounts",)),
            ("spark_rapids_tpu_torch.exec.dpp", ("ReplayExec",)),
            ("spark_rapids_tpu_torch.exec.reuse",
             ("MaterializationCache", "SharedExchangeEntry",
              "SharedBroadcast", "ReusedExchangeExec",
              "ReusedBroadcastExec", "counters")),
            ("spark_rapids_tpu_torch.plan.reuse",
             ("plan_fingerprint", "duplicate_groups", "apply_reuse")),
            ("spark_rapids_tpu_torch.exec.pipeline",
             ("PrefetchStats", "PrefetchIterator", "PrefetchExec",
              "prefetch_settings", "insert_prefetch")),
            ("spark_rapids_tpu_torch.plan.overrides", ("join_strategy",))):
        assert m in mods
        mod = importlib.import_module(m)
        for n in names:
            assert hasattr(mod, n), (m, n)
    from spark_rapids_tpu_torch.shuffle.manager import ShuffleManager

    for n in ("num_map_outputs", "partition_sizes", "partition_sizes_by_map",
              "read_spec"):
        assert hasattr(ShuffleManager, n), n


def test_no_adaptive_reuse_or_prefetch_failure_falls_back():
    """A failed AQE plan, read-ahead or reuse entry raises with its cause:
    the modules that carry them catch no exception (the prefetch worker's
    one handler hands the exception to its consumer, and a pool refusal
    sheds its queue)."""
    for rel in ("shuffle/aqe.py", "exec/reuse.py", "plan/reuse.py",
                "exec/dpp.py", "shuffle/exchange_exec.py",
                "exec/pipeline.py"):
        path = os.path.join(PKG, *rel.split("/"))
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        handlers = [n for n in ast.walk(tree)
                    if isinstance(n, ast.ExceptHandler)]
        if rel == "exec/pipeline.py":
            # the queue's Full and Empty, the worker's hand-over, and the
            # shed of a batch the pool refuses
            names = sorted(ast.unparse(h.type) for h in handlers)
            assert names == ["BaseException", "RetryOOM", "StopIteration",
                             "queue.Empty", "queue.Empty", "queue.Full"], \
                names
        else:
            assert not handlers, (rel, [h.lineno for h in handlers])


def test_the_memory_modules_are_covered():
    """The memory runtime's modules are walked by the import checks
    above and hold the names the slice adds, and the operators that shed
    through it hold theirs."""
    import importlib

    mods = _modules()
    for m, names in (
            ("spark_rapids_tpu_torch.mem.pool",
             ("HbmPool", "RetryOOM", "SplitAndRetryOOM", "CpuRetryOOM",
              "QueryBudgetExceeded", "OomInjector", "get_pool",
              "set_pool")),
            ("spark_rapids_tpu_torch.mem.spill",
             ("SpillableBatch", "SpillFramework", "BounceBufferPool",
              "SpillCorruptionError", "get_framework", "spillable",
              "try_spillable")),
            ("spark_rapids_tpu_torch.mem.retry",
             ("with_retry", "with_retry_no_split", "split_batch_half",
              "_oom_backoff", "get_with_retry")),
            ("spark_rapids_tpu_torch.mem.semaphore",
             ("TaskSemaphore", "get_task_semaphore")),
            ("spark_rapids_tpu_torch.mem.cleaner",
             ("register_pool", "register_framework", "register_manager",
              "sweep", "assert_clean")),
            ("spark_rapids_tpu_torch.exec.sort",
             ("OutOfCoreSortIterator", "_SortRun")),
            ("spark_rapids_tpu_torch.exec.window", ("plan_stream_mode",)),
            ("spark_rapids_tpu_torch.exec.aggregate",
             ("repartition_snapshot",))):
        assert m in mods
        mod = importlib.import_module(m)
        for n in names:
            assert hasattr(mod, n), (m, n)
    from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec
    from spark_rapids_tpu_torch.exec.window import WindowExec

    for cls, names in (
            (HashAggregateExec, ("_repart_conf", "_merge_all",
                                 "_bucket_ids", "_repartition_merge",
                                 "_merge_last_resort")),
            (WindowExec, ("_exec_running", "_init_carry",
                          "_streaming_compute", "_exec_bounded",
                          "_emit_bounded"))):
        for n in names:
            assert hasattr(cls, n), (cls, n)


def test_the_memory_modules_catch_only_pool_ooms():
    """The memory runtime recovers the pool's own OOMs and nothing else:
    each handler of ``mem/`` catches RetryOOM or SplitAndRetryOOM, or is
    the codec import check (which raises), or cleans up and raises the
    exception again; none catches torch's allocator error."""
    allowed = {"RetryOOM", "SplitAndRetryOOM", "(RetryOOM, SplitAndRetryOOM)",
               "ImportError"}
    seen = set()
    for f in ("pool.py", "spill.py", "retry.py", "semaphore.py",
              "cleaner.py"):
        path = os.path.join(PKG, "mem", f)
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for h in ast.walk(tree):
            if not isinstance(h, ast.ExceptHandler):
                continue
            name = ast.unparse(h.type) if h.type is not None else "bare"
            reraises = isinstance(h.body[-1], ast.Raise)
            if name == "ImportError":
                assert reraises, (f, h.lineno)
            assert name in allowed or (reraises and h.body[-1].exc is None), \
                (f, h.lineno, name)
            assert "OutOfMemoryError" not in ast.unparse(h), (f, h.lineno)
            seen.add(name)
    assert {"RetryOOM", "SplitAndRetryOOM"} <= seen


def test_the_scalar_types_and_datetime_modules_are_covered():
    """The utils package (the zone tables), the date-time modules and the
    four scalar types are walked by the import checks above, and every
    date-time class of the reference is in the port, with both engines'
    evaluation."""
    import importlib

    from spark_rapids_tpu_torch import types as PT
    from spark_rapids_tpu_torch.exprs import expr as PE

    mods = _modules()
    for m, names in (
            ("spark_rapids_tpu_torch.utils.tzdb",
             ("utc_transitions", "local_transitions")),
            ("spark_rapids_tpu_torch.exprs.datetime",
             ("eval_datetime", "civil_from_days", "days_from_civil",
              "iso_week")),
            ("spark_rapids_tpu_torch.plan.cpu_datetime",
             ("eval_datetime",)),
            ("spark_rapids_tpu_torch.exprs.expr",
             ("IsNaN", "Nanvl", "cast_supported", "DATETIME_FUNCTIONS")),
            ("spark_rapids_tpu_torch.types",
             ("BYTE", "SHORT", "FLOAT", "TIMESTAMP"))):
        assert m in mods
        mod = importlib.import_module(m)
        for n in names:
            assert hasattr(mod, n), (m, n)
    for path in ("utils/tzdb.py", "exprs/datetime.py",
                 "plan/cpu_datetime.py"):
        assert os.path.exists(os.path.join(PKG, path)), path
    assert PT.INTEGRAL_TYPES == (PT.BYTE, PT.SHORT, PT.INT, PT.LONG)
    assert PT.FRACTIONAL_TYPES == (PT.FLOAT, PT.DOUBLE)
    names = {c.__name__ for c in PE.DATETIME_FUNCTIONS}
    assert len(names) == 32
    for c in PE.DATETIME_FUNCTIONS + (PE.IsNaN, PE.Nanvl):
        assert c in PE.SUPPORTED and c.type_support is not None, c


def test_the_aggregate_family_modules_are_covered():
    """The modules that carry the aggregate family and the statistics pass
    are walked by the import checks above, and hold the names the slice
    adds."""
    import importlib

    mods = _modules()
    for m, names in (
            ("spark_rapids_tpu_torch.exprs.expr",
             ("VarianceSamp", "Kurtosis", "Corr", "MinBy", "BoolOr",
              "CountIf", "AnyValue", "BitXorAgg", "Median", "AGGREGATES")),
            ("spark_rapids_tpu_torch.exec.kernels",
             ("segment_pick", "segment_arg_extreme", "string_order_ranks")),
            ("spark_rapids_tpu_torch.exec.aggregate", ("agg_inputs",)),
            ("spark_rapids_tpu_torch.exec.window", ("_variance_window",)),
            ("spark_rapids_tpu_torch.plan.cpu_agg", ("_reduce_family",)),
            ("spark_rapids_tpu_torch.plan.cpu_window", ("_frame_moments",)),
            ("spark_rapids_tpu_torch.bench.stat_sales",
             ("QUERIES", "PANDAS", "s4_skew", "check_rows"))):
        assert m in mods
        mod = importlib.import_module(m)
        for n in names:
            assert hasattr(mod, n), (m, n)


def test_the_scalar_family_and_string_cast_modules_are_covered():
    """The modules that carry the scalar function families and the casts to
    and from strings are walked by the import checks above, hold the names
    the slice adds, and every one of the 56 classes is declared for the
    device (Rand, which the reference's planner keeps off it, for the CPU
    engine)."""
    import importlib

    from spark_rapids_tpu_torch.exprs import expr as PE
    from spark_rapids_tpu_torch.plan import cpu as PCPU

    mods = _modules()
    for m, names in (
            ("spark_rapids_tpu_torch.exprs.expr",
             ("SCALAR_FUNCTIONS", "IntegralDivide", "Pmod", "EqualNullSafe",
              "Greatest", "BRound", "Murmur3Hash", "Rand",
              "round_decimal_type")),
            ("spark_rapids_tpu_torch.exprs.math",
             ("eval_scalar", "round_fractional", "round_integral",
              "column_hash", "rand")),
            ("spark_rapids_tpu_torch.exprs.strings",
             ("row_ids", "make_offsets", "emit")),
            ("spark_rapids_tpu_torch.exprs.cast_strings",
             ("PARSE_WINDOW", "Literals", "from_string", "to_string")),
            ("spark_rapids_tpu_torch.plan.cpu_math",
             ("eval_scalar", "round_fractional", "engine_hash")),
            ("spark_rapids_tpu_torch.plan.cpu_cast_strings",
             ("PARSE_WINDOW", "from_string", "to_string", "java_text")),
            ("spark_rapids_tpu_torch.bench.scalar_sales",
             ("QUERIES", "scalar_tables", "pandas_n1", "check_rows"))):
        assert m in mods
        mod = importlib.import_module(m)
        for n in names:
            assert hasattr(mod, n), (m, n)
    assert len(PE.SCALAR_FUNCTIONS) == 56
    for c in PE.SCALAR_FUNCTIONS:
        assert c in PCPU.CPU_EXPRS, c
        if c is PE.Rand:
            assert c not in PE.SUPPORTED and c in PE.CPU_ONLY
        else:
            assert c in PE.SUPPORTED and c.type_support is not None, c
    assert importlib.import_module(
        "spark_rapids_tpu_torch.exprs.cast_strings").PARSE_WINDOW == 64


def test_the_string_family_and_regex_modules_are_covered():
    """The modules that carry the string family and regex are walked by
    the import checks above (no JAX, nothing of the JAX package), hold the
    names the slice adds, and each of the 44 classes is declared for the
    device or kept for the CPU engine as the reference keeps it."""
    import importlib

    from spark_rapids_tpu_torch.exprs import expr as PE
    from spark_rapids_tpu_torch.plan import cpu as PCPU

    mods = _modules()
    for m, names in (
            ("spark_rapids_tpu_torch.exprs.segscan",
             ("segmented_compose", "exclusive_states")),
            ("spark_rapids_tpu_torch.exprs.strings",
             ("concat", "concat_ws", "trim", "replace", "first_match_pos",
              "pad", "repeat", "reverse", "translate", "initcap",
              "substring_index", "ascii_code", "chr_of", "hex_encode",
              "unhex", "base64_encode", "unbase64", "hex_of_long")),
            ("spark_rapids_tpu_torch.exprs.regex",
             ("RegexUnsupported", "compile_rlike", "compile_fullmatch",
              "_Parser", "_find_wrap", "like_to_dfa", "match_strings")),
            ("spark_rapids_tpu_torch.plan.cpu_strings", ("eval_string",)),
            ("spark_rapids_tpu_torch.bench.string_sales",
             ("QUERIES", "pandas_g1", "check_rows", "tables_for"))):
        assert m in mods
        mod = importlib.import_module(m)
        for n in names:
            assert hasattr(mod, n), (m, n)
    classes = PE.STRING_FUNCTIONS + PE.REGEX_FUNCTIONS
    assert len(classes) == 44
    for c in classes:
        assert c in PCPU.CPU_EXPRS, c
        assert (c in PE.SUPPORTED) == c.device_supported, c
        assert (c in PE.CPU_ONLY) != c.device_supported, c


def test_the_nested_types_json_and_generate_modules_are_covered():
    """The modules that carry the nested types, BINARY, JSON, explode and
    sample are walked by the import checks above (no JAX, nothing of the
    JAX package), hold the names the slice adds, and each new class is
    declared for the device or kept for the CPU engine as the reference
    keeps it."""
    import importlib

    from spark_rapids_tpu_torch.exprs import expr as PE
    from spark_rapids_tpu_torch.plan import cpu as PCPU

    mods = _modules()
    for m, names in (
            ("spark_rapids_tpu_torch.types",
             ("ArrayType", "StructType", "MapType", "is_nested")),
            ("spark_rapids_tpu_torch.columnar.batch",
             ("array_element_nulls", "ELEMENT_NULLS")),
            ("spark_rapids_tpu_torch.exec.kernels",
             ("slice_column", "concat_columns")),
            ("spark_rapids_tpu_torch.exprs.eval", ("NestedVal",)),
            ("spark_rapids_tpu_torch.exprs.json_device",
             ("parse_path", "get_json_object")),
            ("spark_rapids_tpu_torch.plan.cpu_nested",
             ("eval_nested", "get_json_object", "json_to_text",
              "cast_binary")),
            ("spark_rapids_tpu_torch.plan.overrides", ("NESTED_OK",)),
            ("spark_rapids_tpu_torch.exec.generate", ("GenerateExec",)),
            ("spark_rapids_tpu_torch.exec.misc", ("SampleExec",)),
            ("spark_rapids_tpu_torch.bench.nested_sales",
             ("QUERIES", "h1_rows", "arrow_h1", "json_h3", "check_rows",
              "tables_for"))):
        assert m in mods
        mod = importlib.import_module(m)
        for n in names:
            assert hasattr(mod, n), (m, n)
    for c in PE.NESTED_FUNCTIONS + (PE.GetJsonObject,):
        assert c in PE.SUPPORTED and c.type_support is not None, c
    for c in (PE.MapValues, PE.CollectList, PE.CollectSet,
              PE.JsonToStructsText):
        assert c in PE.CPU_ONLY and c not in PE.SUPPORTED, c
    for c in PE.NESTED_FUNCTIONS + (PE.MapValues, PE.GetJsonObject,
                                    PE.JsonToStructsText):
        assert c in PCPU.CPU_EXPRS, c


def test_the_file_input_modules_are_covered():
    """The modules that carry the file scans, dynamic pruning, the
    columnar writers and the other formats are walked by the import
    checks above (no JAX, nothing of the JAX package) and hold the names
    the slice adds."""
    import importlib

    mods = _modules()
    for m, names in (
            ("spark_rapids_tpu_torch.exec.scan",
             ("windowed_map", "FileScanBase", "RowGroupTask",
              "ParquetScanExec", "_stats_may_match", "_col_lit",
              "stats_value", "values_may_overlap")),
            ("spark_rapids_tpu_torch.exec.dpp",
             ("ReplayExec", "DynamicPruningFilter")),
            ("spark_rapids_tpu_torch.io",
             ("CsvScanExec", "JsonScanExec", "OrcScanExec", "AvroScanExec",
              "CsvWriter", "OrcWriter", "ParquetWriter", "WriteStats",
              "write_columnar", "AsyncOutputStream", "HostMemoryThrottle",
              "TrafficController", "FileCache", "HiveTextScanExec",
              "discover_partitions", "parse_partition_values",
              "prune_partitions", "replace_paths")),
            ("spark_rapids_tpu_torch.io.paths",
             ("parse_rules", "replace_paths")),
            ("spark_rapids_tpu_torch.io.text_parse",
             ("parse_field", "CsvOptions", "convert_string_table",
              "parse_json_lines")),
            ("spark_rapids_tpu_torch.io.avro",
             ("read_avro", "write_avro", "read_avro_schema")),
            ("spark_rapids_tpu_torch.plan.logical", ("ParquetScan",)),
            ("spark_rapids_tpu_torch.plan.dataframe", ("read_parquet",)),
            ("spark_rapids_tpu_torch.plan.cpu", ("CpuParquetScanExec",)),
            ("spark_rapids_tpu_torch.plan.cbo", ("scan_rows",)),
            ("spark_rapids_tpu_torch.plan.overrides", ("apply_path_rules",)),
            ("spark_rapids_tpu_torch.plan.reuse", ("_dedupe_subqueries",)),
            ("spark_rapids_tpu_torch.bench.parquet_sales",
             ("write_tables", "df_tables", "clustered_fact",
              "row_groups"))):
        assert m in mods, m
        mod = importlib.import_module(m)
        for n in names:
            assert hasattr(mod, n), (m, n)
    for rel in ("exec/scan.py", "io/__init__.py", "io/paths.py",
                "io/writer.py", "io/async_write.py", "io/filecache.py",
                "io/text_parse.py", "io/csv.py", "io/json.py", "io/orc.py",
                "io/avro.py", "io/hive.py"):
        assert os.path.exists(os.path.join(PKG, *rel.split("/"))), rel


def test_read_parquet_without_device_raises_when_no_card(monkeypatch,
                                                         tmp_path):
    import pyarrow.parquet as pq
    import torch

    from spark_rapids_tpu_torch.exec.scan import ParquetScanExec
    from spark_rapids_tpu_torch.plan import read_parquet

    p = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"a": pa.array([1, 2], pa.int64())}), p)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        read_parquet(p)
    with pytest.raises(RuntimeError, match="CUDA"):
        ParquetScanExec([p])
    # asked for the CPU, it runs there
    assert read_parquet(p, device="cpu").to_arrow().column(
        "a").to_pylist() == [1, 2]


def test_the_lakehouse_modules_are_covered():
    """The table formats, caches and clustering modules are walked by the
    import checks above and hold the reference's names."""
    import importlib

    mods = set(_modules())
    for m, names in (
            ("spark_rapids_tpu_torch.plan.plan_cache",
             ("Unfingerprintable", "logical_fingerprint", "build_key",
              "lookup", "store", "release", "bump_epoch", "clear",
              "counters", "reset_stats")),
            ("spark_rapids_tpu_torch.exec.expand", ("ExpandExec",)),
            ("spark_rapids_tpu_torch.plan.cache", ("CachedRelation",)),
            ("spark_rapids_tpu_torch.exec.bloom",
             ("optimal_params", "default_bits", "build_bloom_filter",
              "might_contain")),
            ("spark_rapids_tpu_torch.exec.zorder",
             ("interleave_bits", "hilbert_index", "zorder_sort_indices")),
            ("spark_rapids_tpu_torch.delta",
             ("DeltaLog", "DeltaSnapshot", "DeltaTable")),
            ("spark_rapids_tpu_torch.delta.log",
             ("AddFile", "write_dv", "read_dv")),
            ("spark_rapids_tpu_torch.delta.table", ("DeltaTable",)),
            ("spark_rapids_tpu_torch.iceberg", ("IcebergTable",)),
            ("spark_rapids_tpu_torch.plan.ml",
             ("device_batches", "feature_matrix")),
            ("spark_rapids_tpu_torch.bench.lakehouse_sales",
             ("run_pass", "build_delta", "plain_fact", "plain_item",
              "write_iceberg", "rollup", "plain_rollup"))):
        assert m in mods, m
        mod = importlib.import_module(m)
        for n in names:
            assert hasattr(mod, n), (m, n)


def test_lakehouse_entry_points_without_device_raise_when_no_card(
        monkeypatch, tmp_path):
    import json

    import pyarrow.parquet as pq
    import torch

    from spark_rapids_tpu_torch import types as PT
    from spark_rapids_tpu_torch.columnar.batch import batch_from_arrow
    from spark_rapids_tpu_torch.delta import DeltaTable
    from spark_rapids_tpu_torch.exec import bloom, zorder
    from spark_rapids_tpu_torch.exec.base import BatchSourceExec
    from spark_rapids_tpu_torch.iceberg import IcebergTable
    from spark_rapids_tpu_torch.plan.cache import CachedRelation

    t = pa.table({"a": pa.array([1, 2], pa.int64())})
    p = str(tmp_path / "t.parquet")
    pq.write_table(t, p)
    (tmp_path / "ice" / "metadata").mkdir(parents=True)
    with open(tmp_path / "ice" / "metadata" / "v1.metadata.json", "w") as f:
        json.dump({"current-snapshot-id": 1, "snapshots": [
            {"snapshot-id": 1, "manifests": [str(tmp_path / "m.json")]}]}, f)
    with open(tmp_path / "m.json", "w") as f:
        json.dump([{"file_path": p}], f)
    DeltaTable.create(str(tmp_path / "d"), t, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeltaTable(str(tmp_path / "d")).scan_exec()
    with pytest.raises(RuntimeError, match="CUDA"):
        DeltaTable.create(str(tmp_path / "e"), t)
    with pytest.raises(RuntimeError, match="CUDA"):
        IcebergTable(str(tmp_path / "ice")).scan_exec()
    b = batch_from_arrow(t, "cpu")
    src = BatchSourceExec([[b]], PT.Schema.from_arrow(t.schema))
    with pytest.raises(RuntimeError, match="CUDA"):
        CachedRelation.cache(src)
    # asked for the CPU, each runs there; the batch functions run where
    # their batch lives
    assert DeltaTable(str(tmp_path / "d"), device="cpu").scan_exec() \
        .plan_device().type == "cpu"
    assert IcebergTable(str(tmp_path / "ice")).scan_exec(
        device="cpu").plan_device().type == "cpu"
    assert CachedRelation.cache(src, device="cpu").plan_device().type == \
        "cpu"
    assert zorder.zorder_sort_indices(b, (0,)).device.type == "cpu"
    assert bloom.build_bloom_filter(b, (0,), 64).device.type == "cpu"
