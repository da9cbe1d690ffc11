#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spark_rapids_tpu_torch) on one card.

    python3 chip_smoke.py [--sf 2.0] [--sf-ds 1.0] [--out PATH.json]

Phases, in order; any failure exits non-zero before the last line:

1. device: the card's name and power limit (nvidia-smi) and torch's view;
2. build: every CUDA kernel source under spark_rapids_tpu_torch/csrc, one
   nvcc process each, started together;
3. kernels: each kernel's wrapper against its plain torch version on the
   card at seeded shapes. The probe at three (Q3's lineitem-join shape, a
   duplicate-heavy build, near-full clusters that reach the probe bound),
   exactly equal.
   The segmented scan for int32/int64/float32/float64 x add/min/max at
   lengths around the 4096-row tile (tile - 1, tile, tile + 1, 127 tiles +
   1) and others from 1 to above a million rows, with random heads, all
   heads and one segment spanning the whole input, and on views at
   storage offsets 1-3 (misaligned values and flags): integers and
   min/max exactly equal (NaN equals NaN), float add within
   ``segscan_add_tolerance`` (a first-order rounding bound on the running
   sum of |values|). Then a look-back stress: 100 scans of 16,777,216
   int32 rows (max, 16 heads, so the look-back carries across many
   tiles), each equal to the first and the first to the plain version.
   Then one shape beyond the 50 MB L2 for each kernel (recorded, not
   gated): a 16,777,216-row int32 add scan and 8,388,608 probes into a 2^23-slot table. Times are CUDA-event
   medians of 20 runs after warm-up, each queued behind a spin on the
   card so that the kernel's time is device time (``call_ms`` is the
   wrapper's call with its host launch cost, timed without the spin;
   ``host_us`` the wrapper's mean host time over 200 calls made back to
   back; ``cold_ms`` the device time after a 128 MB write that flushes the
   L2 before each run). Bounds are the bytes each kernel must move over
   3.35 TB/s. The probe: 16 B of hashes in and 4 B of slot out per probe
   row, one byte of every table slot, and the 16 B record of the used
   slots only. The segmented scan: its value read and written once and
   its flag byte read once per row;
4. TPC-H main path: Q1/Q3/Q5/Q6 at SF ``--sf`` (12M lineitem rows at SF2)
   through ``from_arrow(...)...to_arrow()`` on ``cuda``, once with every
   kernel launch count set to 0 just before and read just after, each
   result held against the pandas reference (rel 1e-6, exact keys, counts
   and ORDER BY order); then the warm wall time of each query (median of
   3);
5. TPC-DS main path: q44 and q67 at SF ``--sf-ds`` (2,880,000 store_sales
   rows and 18,000 items at SF1, money columns decimal(7,2)) the same way,
   each held against its pandas reference; the segmented scan must launch
   in both queries; then warm wall times (median of 3);
6. TPC-DS headline: q3/q7/q42/q52/q96 at SF ``--sf-ds`` on the same
   generated tables, uploaded in batches of 2^22 rows as ``bench.py``
   does. For each query: ``explain("ALL")`` must mark no node for the CPU
   engine; one run on the card with the launch counts zeroed before and
   read after, held against the pandas reference; the same query with
   ``spark.rapids.gpu.sql.enabled=false`` (every node on the CPU engine,
   ``bench.py``'s gate), whose rows must match too; the warm wall (median
   of 3) and the CPU engine's wall. The probe must launch in every query.
   Then one mixed plan: a filter with a string ordering comparison, tagged
   for the CPU engine under device joins, an aggregate and a sort, held
   against pandas;
7. TPC-DS joins: q9/q28/q40/q43/q87/q88/q93/q97 at SF ``--sf-ds`` (the
   same tables plus store_returns, reason, catalog_sales, catalog_returns,
   web_sales, customer and warehouse from the reference's generators), in
   one batch of 2^22 rows a table as ``bench.py``: left, full, semi and
   anti joins, If/CaseWhen/Coalesce and COUNT(DISTINCT) (q28's, through
   the planner's distinct rewrite). For each query, as in phase 6:
   ``explain("ALL")`` must mark no node for the CPU engine; one run with
   the launch counts zeroed before and read after, held against the
   pandas reference and against the CPU engine; the warm wall (median of
   3). The probe must launch in every query that joins (all but q9);
8. each kernel against its plain version, as in phase 3, on the largest
   input the TPC-H and window paths gave it (for the segmented scan also
   against ``torch.cummax``, which computes the same function on the
   geometry scan's input and is timed as ``library_ms``), warm and with a
   cold L2, and the probe also on the headline's largest probe and on the
   joins path's (q93's 2,880,000 store_sales rows into the 288,000-row
   store_returns table). The kernels line reports the first input's
   times and bound, the joins path's under ``joins_largest``, and the
   launches of every main path.
9. TPC-DS breadth: the 33 queries of ``tpcds_queries.BREADTH`` at SF
   ``--sf-ds`` (all 24 tables of the reference's generators, one batch of
   2^22 rows a table). For each: ``explain("ALL")``, printing every node
   placed on the CPU engine with its reason (a query with any is reported
   "mixed"); one run with the launch counts zeroed before and read after,
   held against the same query on the CPU engine; each result must show
   values (``tpcds_queries.informative``) unless ``EMPTY_AT_SF`` names it
   at that SF; the probe must launch in every query; the warm wall
   (one warm run), the CPU engine's wall and the path each join took.
   Every query runs once more with each probe call held exactly against
   the plain version, and the path's largest table probe and its largest
   probe are checked as in phase 8; the kernels line reports the first
   under ``breadth_largest``. Then every join query of phases 6, 7 and 9
   runs again with ``spark.rapids.gpu.sql.join.hashTable.enabled=false``:
   every device join must report the sorted-hash path, none may launch
   the probe, and the rows must equal the hash-table run's (no warm
   wall);
10. TPC-DS union slice: the 25 queries of ``tpcds_queries.UNION_SLICE``
   (Union, Substring, Like, string-column equality, projected string
   literals and residual join conditions) at SF ``--sf-ds`` on the same
   tables, one batch of 2^22 rows a table, each as phase 9 runs a
   breadth query: its CPU-engine nodes printed with their reasons, one
   run with the launch counts zeroed before the query is built (q23 and
   q24 collect their threshold while they are built) and read after it,
   held against the CPU engine, required to show values unless
   ``EMPTY_AT_SF`` names it, the probe required to launch (but in q76,
   whose probe sides are empty); every probe
   call of the path held against the plain version, the path's largest
   table probe checked as in phase 8 (``union_largest`` on the kernels
   line); warm walls (medians of 3); each query's exchanges, joins by
   strategy and shuffle bytes and times (``plan_strategy``: a union of
   one-split children has a partition per child, so an aggregate or a
   join above it plans exchanges). q76, empty at every SF
   (no null promotion key is generated), runs once more on the same
   tables with 10% of the promotion keys nulled, where it must show
   values and equal the CPU engine. Then the six queries that join with
   a condition (``CONDITION_JOINS``) run with the hash table off: the
   same rows, no probe launch, every device join on the sorted-hash
   path;
11. TPC-DS decimal slice: the 21 queries of ``tpcds_queries.DECIMAL_SLICE``
   (Divide, Abs and DECIMAL128 on the device, window Sums and Averages
   into DECIMAL128) and q1/q30/q65/q81 (``WIDE_AVERAGES``, whose
   decimal(21,6) averages ran on the CPU engine before) at SF ``--sf-ds``
   on the same tables, one batch of 2^22 rows a table, each as phase 10
   runs a union query, but every plan must place no node on the CPU
   engine (each one would be printed with its reason first); the
   segmented scan must launch in each window query (q12/q20/q98 and
   q36/q49/q51/q53/q63), the probe in every query. q24's threshold
   subquery (a decimal(21,6) average) must run wholly on the device and
   give the CPU engine's value. Every probe call of the path and every
   segmented-scan call of its window queries is held against the plain
   version (the scan: integers and min/max exactly, float adds within
   ``segscan_add_tolerance``); the path's largest table probe is checked
   as in phase 8 (``decimal_largest``); warm walls and exchanges as in
   phase 10. Every query runs again with the hash table off: the same
   rows, no probe launch. Last, one
   decimal(17,2) / decimal(17,2) Divide over 2,880,000 rows (a
   decimal(37,20) quotient through the 128-bit long division): its torch
   kernel launches and device time (one profiled call), its host time
   (median of 5 calls, each ending in a synchronise), and its rows equal
   to the same Divide on the CPU (the first 100,000);
12. TPC-DS window slice: q47/q57/q89 (decimal(21,6) window averages
   partitioned by plain strings) and q70/q86 (ranks over sums) at SF
   ``--sf-ds`` on the same tables, each as phase 11 runs a query: wholly
   on the device, held against the CPU engine (its first rows printed),
   with values, the probe and the segmented scan launched; every probe
   and segmented-scan call of the path held against the plain version,
   the path's largest table probe checked as in phase 8
   (``window_rest_largest``); warm walls; then all five with the hash
   table off (the same rows, no probe launch). Last, a window-surface
   pass over store_sales (2,880,000 rows at SF1, one batch), partitioned
   by (ss_store_sk, ss_item_sk) and ordered by ss_sold_date_sk: lead/lag
   with defaults, ntile(4), percent_rank, cume_dist, first/last and
   Sum/Min/Max over ROWS 3 PRECEDING..3 FOLLOWING on a double, an int and
   a decimal(7,2) column, a Sum over RANGE 30 PRECEDING..CURRENT ROW of
   the date key and a DECIMAL128 Sum over the ROWS frame, in one window
   node with the launch counts zeroed before and read after, each column
   equal to the CPU engine's; every segmented-scan call of the pass (its
   prefix and suffix min/max scans among them) held against the plain
   version; each window's warm wall alone (rows left on the card, a
   row_number over the same spec beside them) and its launches; the largest
   min scan's times against its byte bound (``window_min_scan``); and
   the torch kernels and device time the bounded RANGE window's
   bisection adds to a running sum of the same column (one profiled run
   each);
13. partitioned execution: TPC-H Q1/Q3/Q5/Q6 at SF ``--sf`` (12 batches
   of 2^20 lineitem rows at SF2, in 4 source splits), the TPC-DS queries
   of ``PARTITIONED_DS`` at SF ``--sf-ds`` in batches of 2^19 rows
   (store_sales' 6 in 4 splits), q38 again with a broadcast threshold
   under which its two string-keyed semi joins are shuffled joins
   (``SHUFFLED_Q38_BROADCAST_ROWS``), and one global ORDER BY
   ss_net_paid over store_sales' rows with no limit (a range exchange),
   all with 4 source splits and 4 shuffle partitions. For each:
   ``explain("ALL")`` must mark no node for the CPU engine; one run with
   the launch counts zeroed before and read after, held against the same
   query in one partition (one source split, one shuffle partition) and
   on the CPU engine (TPC-H and TPC-DS: ``rows_match``/``check_rows``,
   each result required to show values (``Q.informative``); the sort:
   all of store_sales' rows, the key column in the same order and the
   rows as a multiset); its exchanges by partitioner, broadcast and
   shuffled joins, shuffle bytes written and read and the exchanges'
   times (``plan_strategy``); the probe must launch in every query that
   joins (q38 with shuffled joins among them) and the segmented scan in
   q67 and q47. Every probe and segmented-scan call of those runs is held
   against the plain version (which launches no kernel, so the counts
   stay the kernels' own); the path's largest table probe is checked as
   in phase 8 (``partitioned_largest``), and the warm walls (median of
   3, the counted run and the one-partition run the first of their
   three since phase 21's arrival) of each query partitioned and in one
   partition are printed side by side;
14. adaptive reads and reuse. Phases 9-13 run at the port's defaults:
   AQE readers (coalesced and skew-split reads), exchange and broadcast
   reuse and prefetch on; ``plan_strategy`` prints each AQE reader's
   specs, the reused exchanges and broadcasts, the bytes reuse saved
   (``exec/reuse.counters``) and the prefetch boundaries. This phase
   holds them against the three switches off (``SWITCHES_OFF``, the
   plan shape without them): every query of phases 10-11 that plans an
   exchange and every case of phase 13 runs once with them off, its rows
   equal to the defaults' run (the query's check: ORDER BY order, rel
   1e-6 on doubles), with its probe launches on and off; q2, q75 and
   Q3's checked runs' walls with them off beside the defaults' warm
   walls, and Q3's checked run with prefetch alone off (the read-ahead
   isolated; Q5's off walls were cut with phase 16, Q3's prefetch-off
   repeats with phase 17, the repeats of the off runs with phase 21).
   Then q2, q4, q11 and q75 with 4 source splits, reuse on against off:
   equal rows, with values; q2 and q75 must reuse an exchange (the
   reference's plans of q4 and q11 reuse broadcasts only, and so must
   theirs; q74, whose plan is q11's, was cut with phase 21). Last, a
   skewed shuffled join (``skewed_tables``: 2^24
   fact rows in 4 splits of 2^22, 60% on one key, the rest uniform over
   2^20 keys, an int64 and a float64 payload; 2^20 dimension keys) with
   ``broadcastRowThreshold`` 0 and ``skewedPartitionThresholdBytes`` 64
   MB: inner, left and left_semi, each planning skew-split specs on the
   fact side with paired readers that line up, the probe launched and
   every probe call held against the plain version, the rows equal to
   AQE off as multisets sorted on the card by every column and their
   count equal to numpy's, and the walls on and off: medians of 3 for
   the inner join (the tables uploaded first, each checked run the first
   of its three), the checked runs' for the left and left_semi joins
   (their repeats were cut with phase 21).
   Every probe and segmented-scan call of the phase's counted runs is
   held against the plain version (``adaptive_calls_checked``), and the
   checked calls must cover every counted launch;
15. the memory path (``run_memory_path``). Phases 1-14 run at the
   port's memory defaults: task semaphore, pool accounting, spillable
   join builds, output chunks and aggregate partials, streaming windows
   (q44 streams). (a) Three streaming window nodes over store_sales
   (``tpcds_queries.streaming_windows``; 2,880,000 rows at SF1 in 2^17-row
   batches, so 22 sorted runs, past the 16 of ``maxMergeRuns``, and a
   pre-merge): a running and a bounded one partitioned by store, and a
   running one with no partition, whose one partition spans every
   streamed batch so that the carry continues across each edge; each
   with streaming on and off, the columns equal to each other's (the CPU
   engine's runs were cut with phase 18); runs, pre-merges, merged and
   streamed batches, and warm
   walls both ways (one warm run each, not the checked one).
   (b) Phase 13's Q3 and q67 (their frames, already uploaded) and
   the unpartitioned running window (over the date, ticket, item and
   quantity columns, in 2^20-row merged batches), each once uncapped on a fresh pool
   (its largest handle, the most bytes it pinned at once, its peak
   device memory, ``torch.cuda.max_memory_allocated`` above the tables
   as ``bench/peak_memory.py`` takes it) and once under a pool capped at
   the larger of the two (``memory.pool.maxBytes``: every handle and
   every pinned set fits) with a host tier and an aggregate repartition
   target of a sixteenth of it: rows equal to the uncapped ones; no
   registration split; spill counts and bytes by tier, chunks,
   repartition depth, prefetch sheds, wall and peak. Bytes must reach
   host and disk, and q67's aggregate must repartition. (c) The capped
   q67 again with two
   injected RETRYs and one SPLIT on the main thread: equal rows, the
   retry and split counters above zero. (d) Q1 and Q6 (4 splits) on two
   threads at 1 and 2 task permits, two runs a thread: rows equal to
   the serial runs, never
   more holders than permits (the semaphore's own high-water mark and a
   sampler), at least one wait at 1 permit. Both kernels must launch in
   the phase, every call of its counted runs held against the plain
   version (``memory_calls_checked``). After every query of phases 1-17
   (``MemoryChecks``) the pool's used bytes are 0, ``cleaner.sweep()``
   finds nothing and the spill directories hold no file;
16. typed sales (``--out``'s ``typed_sales`` key): the SF ``--sf-ds``
   store_sales retyped by pyarrow alone (``bench/typed_sales.py``: int8
   quantity, int16 store, float32 money, a ``timestamp[us, UTC]`` of
   sale) in one batch of 2^22 rows; T1 (hour x day-of-week profile
   between two TIMESTAMP literals), T2 (one projection of all 32
   date-time classes, summed), T3 (an aggregate per store and hour
   bucket joined back on both keys, on the hash-table and the
   sorted-hash paths) and T4 (a one-hour RANGE window and ROWS 10
   PRECEDING Min/Max of the int8 quantity) wholly on the card, each
   against the CPU engine (T1 also against pandas), then T5: T1 and T3
   with 4 splits and 4 shuffle partitions and the global sorts (one key
   through a range exchange, two keys in one partition) against one
   partition. Each query's launches, probe and scan counts and warm wall
   (median of 3); every probe and scan call of the counted runs held
   against the plain version (``typed_calls_checked``), the phase's
   largest probe timed (``typed_largest``);
17. the statistics pass (``--out``'s ``stat_sales`` key;
   ``bench/stat_sales.py``) over the SF ``--sf-ds`` tables in batches of
   2^22 rows: S1 (q17 with stddev_samp), S2a/S2b (q39a/b), S3 (every
   device aggregate of the family per store and category over
   store_sales joined with item), S4 (variance windows over UNBOUNDED,
   running, RANGE 7 PRECEDING and ROWS 30 PRECEDING frames, summed per
   store) wholly on the card, S5 (bit aggregates, percentile, median:
   the aggregate on the CPU engine) and S4_SKEW (skewness and kurtosis
   windows over one store: the windows on the CPU engine), each against
   the CPU engine (S1, S2a and S2b also against pandas); then S1 and S3
   with 4 splits and 4 shuffle partitions against one partition, and S3
   in 2^18-row batches under the least pool its largest handle and
   pinned set fit, which must spill and read back, against uncapped.
   Each query's launches and warm wall (median of 3); every probe and
   scan call of the counted runs held against the plain version
   (``stat_calls_checked``), the phase's largest probe and largest scan
   timed against their bounds (``stat_largest``);
18. the scalar sales pass (``--out``'s ``scalar_sales`` key;
   ``bench/scalar_sales.py``) over the SF ``--sf-ds`` store_sales (typed,
   with 4% null customer and promotion keys, and untyped: its keys,
   quantity, money and sale date as strings) in one batch of 2^22 rows:
   N1 (the strings cast to BIGINT, INT, DOUBLE and DATE, joined with item
   and summed per category and month), N2 (every device class of the
   scalar families, summed and counted per store), N3 (hash buckets of
   pmod(hash(...), 64) and xxhash64 over store_sales left-joined with
   customer, with the rounding, greatest/least and null functions), N4
   (keys, dates, timestamps and both decimal widths cast to strings,
   grouped by the date string, every cast back equal) and N5 (running and
   ROWS 30 PRECEDING sums of round(ss_net_paid * 1.07, 2) over a
   projected pmod partition) wholly on the card, N6 (a float -> string
   cast and decimal round/floor/pmod: its projection alone on the CPU
   engine, named with the reference's reasons), each against the CPU
   engine (N1 also against its typed twin and pyarrow's parse), N4
   against pyarrow's text; then N7: N1 and
   N3 with 4 splits and 4 shuffle partitions against one partition. The
   CPU engine's runs go to worker processes (spawned, reading the tables
   from Arrow files) that overlap the card's runs. Each query's
   launches, probe and scan counts and warm wall (median of 3, after its
   checks return);
   every probe and scan call of the counted runs held against the plain
   version (``scalar_calls_checked``), the phase's largest probe and
   largest scan timed against their bounds (``scalar_largest``).
19. the string sales pass (``bench/string_sales.py``) over the SF1
   tables, none cut (store_sales 2,880,000 rows in one 2^22-row batch,
   item 18,000, customer 100,000, and phase 18's untyped store_sales):
   G1 (store_sales joined with item, grouped by upper(i_brand) and
   concat_ws('/', i_category, i_class), one aggregate of every device
   class of the string family over item's dictionary columns), G2 (the
   same classes over the untyped store_sales' 2,880,000 plain rows,
   summed and counted per store, the hex/unhex and base64/unbase64 round
   trips counted as mismatches), G3 (RLIKE filters over c_email_address
   and i_item_desc around two joins) and G5 (running and ROWS 30 sums
   over a projected lower(i_brand) partition) wholly on the card; G3R (a
   back-reference pattern: its filter alone on the CPU engine) and G4
   (the CPU engine's classes over one store's rows: its projection alone
   there), each node named with its reasons; each against the CPU engine
   (G1 also against pandas and Python's str); then G6: G1 and G2 with 4
   splits and 4 shuffle partitions against one partition. Launches,
   probe and scan counts and warm walls as phase 18's; every probe and
   scan call of the counted runs held against the plain version
   (``string_calls_checked``), the largest probe and scan timed against
   their bounds (``string_largest``);
20. the nested sales pass (``bench/nested_sales.py``) over tables built
   from the SF1 store_sales and item, none cut: ``tickets`` (one row a
   ticket: a BINARY basket digest, the items as array<int>, the summed
   quantities as map<int,int>, a head struct, the ticket as JSON text)
   and ``lines`` (store_sales' 2,880,000 rows with the basket digest).
   H1 (posexplode through ``GenerateExec``, the hash join exec with
   item and the aggregate, composed as exec nodes: the probe over the
   2,880,000 exploded items) against pyarrow's list kernels; H2 (the
   nested functions grouped by ``head.store_sk``), H3 (get_json_object of
   five paths, also against Python's json), H4G (BINARY as a group key
   and an ORDER BY ... LIMIT 100 key), H4J (BINARY as the join key of
   tickets against lines: the probe) and H6 (a running sum over a
   projected ``head.store_sk`` partition: the scan) wholly on the card;
   H3R (a path outside the grammar: its projection on the CPU engine) and
   H5 (collect_list, collect_set, map_values, JsonToStructsText: CPU
   nodes), each named with its reasons; each against the CPU engine; then
   H7: H2, H4G and H4J with 4 splits and 4 shuffle partitions (BINARY
   keys through the hash exchanges; no nested column crosses one)
   against one partition. Launches, probe and scan counts and warm walls
   as phase 18's; every probe and scan call of the counted runs held
   against the plain version (``nested_calls_checked``), the largest
   probe and scan timed against their bounds (``nested_largest``);
21. the Parquet pass (``run_parquet_path``): the headline queries' eight
   SF1 tables written with the port's ``write_columnar`` from the card's
   batches (``bench/parquet_sales.py``: store_sales clustered by
   ``ss_sold_date_sk`` in 2^17-row row groups and 786,432-row files, so 4
   files and 22 row groups of about 83 days; a file a dimension), each
   read back by pyarrow equal to its source, the bytes and the write's
   wall reported. q3's CPU-engine run over the files starts in a check
   worker (``CpuParquetScanExec``: the worker reads the files itself).
   Then q3/q7/q42/q52/q96 from ``read_parquet`` frames (four scan
   partitions, so exchanges and broadcasts as Spark plans them):
   ``explain("ALL")`` marks no node for the CPU engine; one counted run
   (launch counts zeroed before and read after, every probe call held
   against the plain version), its rows equal to phase 6's verified rows
   of the query, its scans' ``numRowGroups``, ``numPrunedRowGroups``,
   ``numDynPrunedRowGroups``, ``scanTimeNs`` and ``uploadTimeNs``; the
   same query with dynamic pruning off: the same rows, none pruned
   dynamically. q3 must prune a row group dynamically, and its CPU-engine
   rows equal the card's. Warm walls with pruning on and off (medians of
   3, each checked run the first of its three); the largest probe timed
   against its bound (``parquet_largest``; ``parquet_calls_checked``
   counts the probe calls of the counted and the pruning-off runs).
22. the lakehouse pass (``run_lakehouse_path``,
   ``bench/lakehouse_sales.run_pass``) over the SF1 store_sales, item and
   date_dim: a Delta store_sales of four 720,000-row commits, a DELETE of
   November 1999's sales of more than 50 units (deletion vectors, the
   predicate on the card) and an UPDATE of November 2001's sales price
   (copy-on-write through the card's projection); item kept by a MERGE of
   2,000 updated and 500 new items; q3 at version 5 (item at version 1),
   at version 3 and over an Iceberg table of phase 21's store_sales files
   (Avro manifests written with the port's ``write_avro``), each wholly
   on the card, one counted run (launch counts zeroed before and read
   after, every probe call held against the plain version), version 5's
   rows equal to q3 on the CPU engine over the tables ``pyarrow.compute``
   modified alike (a check worker), version 3's to phase 6's and the
   Iceberg table's to phase 21's; two warm repeats over Delta that must
   hit the plan memo; each snapshot's records against the rows read; the
   Iceberg scan's row groups against the same scan of the files; a
   ``CachedRelation`` of a November filter read twice equal to its plan
   (its bytes against Arrow's, ``decodeTimeNs``); a ROLLUP of
   ``ss_ext_sales_price`` by (i_category, i_class) through ``ExpandExec``
   (8,640,000 rows) equal to three pyarrow group-bys; a bloom filter of
   the Music items' keys probed by every ``ss_item_sk`` (no false
   negative, the false-positive share), Z-order and Hilbert orders of
   (ss_item_sk, ss_customer_sk) and the Z-curve of three keys, each equal
   to the port's run on the CPU in a check worker (by digest); a feature
   matrix on the card equal to the rows' values; the largest probe timed
   against its bound (``lakehouse_largest``).

The plan memo (``plan/plan_cache.py``) is on in every phase, as at the
port's defaults: a warm repeat is served the tree its first run planned,
which dropped its broadcast builds when that run ended and builds them
again. A counted run whose tree the memo served has the tree's metrics
set to 0 first (``counted_plan``), so that they count that run alone;
phase 15 plans its counted runs afresh (``fresh_plan``), so that the
largest handle, the pinned sets and the peak that size its capped pool
are a first run's, range exchanges' planning samples included. Each phase's memo hits, misses, uncacheable plans and
evictions are logged (``MemoLog``), and the whole run's.

The CPU engine's comparison runs of phases 9-13, the window-surface pass
and phases 18-21 go to the run's one pool of spawned worker processes
(``check_workers``, the tables read from Arrow files written once; a
result of millions of rows comes back as an Arrow file,
``cpu_engine_table``) that overlap the card's runs: one after another on
the host's CPU they took a third of the whole run. Every such phase takes
its warm walls after its own checks have returned. Two sets of checks
start phases ahead and may still run beside an earlier phase's walls:
the window-surface pass's, and phase 19's beside phase 18's. Phase 20's
start after phase 19's walls.

The last lines are the kernels JSON line, the card's name and power limit,
and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
PROBE_SOURCE = "spark_rapids_tpu_torch/csrc/hashtbl_probe.cu"
PROBE_REPLACES = "spark_rapids_tpu/exec/kernels.py:1769"
SEGSCAN_SOURCE = "spark_rapids_tpu_torch/csrc/segscan.cu"
SEGSCAN_REPLACES = "spark_rapids_tpu/exec/kernels.py:1990"
SEGSCAN_TILE = 4096  # rows a tile of segscan.cu
SEGSCAN_LENGTHS = (1, 1023, 1024, 1025, SEGSCAN_TILE - 1, SEGSCAN_TILE,
                   SEGSCAN_TILE + 1, 127 * SEGSCAN_TILE + 1, 1_048_577)
SEGSCAN_SPAN_ROWS = 3_000_001  # one segment over the whole input
# (value offset, flag offset) of the misaligned views, in elements
SEGSCAN_OFFSETS = ((1, 1), (2, 2), (3, 3), (0, 3), (3, 0))
SEGSCAN_OFFSET_ROWS = 3 * SEGSCAN_TILE + 7
BEYOND_L2_SCAN_ROWS = 16_777_216
STRESS_CALLS = 100
BEYOND_L2_PROBES = 8_388_608
BEYOND_L2_SLOTS = 1 << 23
FLUSH_BYTES = 128 << 20  # written before each cold-L2 run (L2: 50 MB)


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """A line of the run's log, with the seconds since the script began."""
    print(f"[chip_smoke {time.perf_counter() - _T0:7.1f}s] {msg}",
          flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


_flush_buf = []


def flush_l2() -> None:
    """Write FLUSH_BYTES on the card, which evicts whatever the L2 held."""
    import torch

    if not _flush_buf:
        _flush_buf.append(torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                                      device="cuda"))
    _flush_buf[0].fill_(1)


def cuda_ms(fn, reps: int = 20, warmup: int = 3,
            queued: bool = True, cold: bool = False) -> float:
    """Median CUDA-event time of ``fn`` in milliseconds. With ``queued``
    the events and ``fn``'s launches wait behind a spin of about 2 ms on
    the card, so the interval holds device work only and not the host's
    time to make the launches (unless ``fn`` itself synchronises). With
    ``cold`` each run follows a write that flushes the L2 (outside the
    timed interval)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(4_000_000)
        if cold:
            flush_l2()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_us(fn, calls: int = 200) -> float:
    """Mean host time of one call of ``fn`` in microseconds, over ``calls``
    calls made back to back (the card runs them behind the host)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def probe_bound_ms(n: int, capacity: int, table_keys: int) -> float:
    """Least time of one probe call: 20 B per probe row, 1 B per slot and
    16 B per used slot, each read or written once, at the memory rate."""
    return (20 * n + capacity + 16 * table_keys) / HBM_BYTES_PER_S * 1e3


# ---------------------------------------------------------------------------
# kernel inputs
# ---------------------------------------------------------------------------


def synthetic_probe_inputs(name: str, seed: int, device):
    """(tbl, h1, h2, capacity, seed) for one seeded probe shape, the table
    built by the port's own build from int64 keys."""
    import numpy as np
    import pyarrow as pa
    import torch

    from spark_rapids_tpu_torch.columnar.batch import batch_from_arrow
    from spark_rapids_tpu_torch.exec import kernels as K

    rng = np.random.default_rng(seed)
    if name == "q3_lineitem":
        # ~292k unique order keys (every 4th integer, as tpch's orders) and
        # 1M probes of which about 1 in 41 hits
        build_keys = rng.choice(np.arange(1, 4 * 3_000_000, 4), 292_000,
                                replace=False)
        hits = rng.choice(build_keys, 24_000)
        miss = rng.integers(0, 1 << 40, 1_000_000 - 24_000) * 4 + 2
        probe_keys = rng.permutation(np.concatenate([hits, miss]))
    elif name == "duplicate_heavy":
        build_keys = rng.integers(0, 5_000, 500_000)
        probe_keys = rng.integers(0, 10_000, 1_000_000)
    elif name == "near_full":
        build_keys = rng.choice(1 << 40, 60_000, replace=False)
        probe_keys = np.concatenate([rng.choice(build_keys, 500_000),
                                     rng.integers(1 << 41, 1 << 42,
                                                  500_000)])
    else:
        raise KeyError(name)
    bb = batch_from_arrow(pa.table({"k": pa.array(build_keys, pa.int64())}),
                          device)
    pb = batch_from_arrow(pa.table({"k": pa.array(probe_keys, pa.int64())}),
                          device)
    h1 = K.hash_keys(bb, [0])
    h2 = K.hash_keys(bb, [0], variant=1)
    valid = torch.ones(bb.num_rows, dtype=torch.bool, device=device)
    if name == "near_full":
        # 60k keys into 2^16 slots: the build leaves some rows unplaced, and
        # the clusters it does leave run probes into the 16-slot bound
        capacity, seed_ = 1 << 16, 0
        tbl, _ = K.build_hash_table(h1, h2, valid, capacity, seed_,
                                    K.HASHTBL_MAX_PROBES)
    else:
        tbl, capacity, seed_ = K.build_batch_hash_table(bb, (0,))
    return (tbl, K.hash_keys(pb, [0]), K.hash_keys(pb, [0], variant=1),
            capacity, seed_)


def check_probe(label: str, tbl, h1, h2, capacity: int, seed: int,
                cold: bool = False) -> dict:
    """Kernel against the plain version on one input: exact slots, times;
    with ``cold`` also the time after an L2 flush."""
    import torch

    from spark_rapids_tpu_torch.exec import kernels as K

    mp = K.HASHTBL_MAX_PROBES
    saved = dict(K.KERNEL_LAUNCHES)
    ks, kh = K.probe_hash_table_kernel(tbl, h1, h2, capacity, seed, mp)
    torch.cuda.synchronize()
    ps, ph = K.probe_hash_table(tbl, h1, h2, capacity, seed, mp)
    exact = bool(torch.equal(ks, ps)) and bool(torch.equal(kh, ph))
    err = int((ks.long() - ps.long()).abs().max()) if ks.numel() else 0
    kernel_ms = cuda_ms(lambda: K.probe_hash_table_kernel(
        tbl, h1, h2, capacity, seed, mp))
    call_ms = cuda_ms(lambda: K.probe_hash_table_kernel(
        tbl, h1, h2, capacity, seed, mp), queued=False)
    host = host_us(lambda: K.probe_hash_table_kernel(
        tbl, h1, h2, capacity, seed, mp))
    plain_ms = cuda_ms(lambda: K.probe_hash_table(
        tbl, h1, h2, capacity, seed, mp))
    cold_ms = (cuda_ms(lambda: K.probe_hash_table_kernel(
        tbl, h1, h2, capacity, seed, mp), cold=True) if cold else None)
    K.KERNEL_LAUNCHES.update(saved)  # comparison launches do not count
    n = h1.numel()
    table_keys = int(tbl.slot_used.sum())
    res = {"shape": label, "probe_rows": n, "capacity": capacity,
           "seed": seed, "table_keys": table_keys,
           "hit_rate": float(kh.float().mean()) if n else 0.0,
           "exact": exact, "max_abs_err": err, "kernel_ms": kernel_ms,
           "call_ms": call_ms, "host_us": host, "cold_ms": cold_ms,
           "plain_ms": plain_ms,
           "bound_ms": probe_bound_ms(n, capacity, table_keys)}
    log(f"probe {label}: " + json.dumps(res))
    if not exact:
        raise AssertionError(f"probe kernel differs from its plain version "
                             f"on {label} (max abs err {err})")
    return res


def segscan_bound_ms(n: int, itemsize: int) -> float:
    """Least time of one segmented scan: each row's value read and written
    once and its flag byte read once, at the memory rate."""
    return (2 * itemsize + 1) * n / HBM_BYTES_PER_S * 1e3


def segscan_case(dtype, op: str, n: int, mode: str, rng, device):
    """Seeded (values, is_start) on the card: integers over their whole
    range (add wraps), floats over six decades with NaNs for min/max."""
    import numpy as np
    import torch

    if dtype.is_floating_point:
        v = rng.normal(0, 1, n) * 10.0 ** rng.integers(-3, 4, n)
        if op != "add":
            v[rng.random(n) < 0.01] = np.nan
        vals = torch.from_numpy(v).to(dtype)
    else:
        info = torch.iinfo(dtype)
        vals = torch.from_numpy(rng.integers(info.min, info.max, n,
                                             endpoint=True)).to(dtype)
    if mode == "random":
        f = rng.random(n) < 0.01
    elif mode == "all_heads":
        f = np.ones(n, np.bool_)
    else:  # "span": no head at all, one segment over every row
        f = np.zeros(n, np.bool_)
    return vals.to(device), torch.from_numpy(f).to(device)


def segscan_compare(k, p, values, is_start, op: str):
    """(ok, max abs err, largest err / tolerance) of the kernel's output
    against the plain one; the ratio is 0 where equality is required."""
    import torch

    from spark_rapids_tpu_torch.exec import kernels as K

    ratio = 0.0
    if values.is_floating_point() and op == "add":
        absrun = K.segmented_scan(values.abs().double(), is_start, "add")
        tol = K.segscan_add_tolerance(absrun, values.numel(), values.dtype)
        err = (k.double() - p.double()).abs()
        ok = bool((err <= tol).all())
        if err.numel():
            ratio = float((err / tol.clamp(min=1e-300)).max())
    else:
        same = k == p
        if values.is_floating_point():
            same = same | (torch.isnan(k) & torch.isnan(p))
        ok = bool(same.all())
        err = (k.double() - p.double()).abs().nan_to_num(0.0)
    return ok, float(err.max()) if err.numel() else 0.0, ratio


def check_segscan_shapes() -> dict:
    """The kernel against its plain version at every type, op and seeded
    shape; raises on the first disagreement."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.exec import kernels as K

    saved = dict(K.KERNEL_LAUNCHES)
    rng = np.random.default_rng(41)
    checked, worst, worst_ratio = 0, 0.0, 0.0
    for dtype in (torch.int32, torch.int64, torch.float32, torch.float64):
        for op in ("add", "min", "max"):
            shapes = [(n, m) for n in SEGSCAN_LENGTHS
                      for m in ("random", "all_heads")]
            shapes.append((SEGSCAN_SPAN_ROWS, "span"))
            shapes += [(SEGSCAN_OFFSET_ROWS, off) for off in SEGSCAN_OFFSETS]
            for n, mode in shapes:
                if isinstance(mode, tuple):  # misaligned views
                    vo, fo = mode
                    v, f = segscan_case(dtype, op, n + 3, "random", rng,
                                        "cuda")
                    v, f = v[vo:vo + n], f[fo:fo + n]
                else:
                    v, f = segscan_case(dtype, op, n, mode, rng, "cuda")
                k = K.segmented_scan_kernel(v, f, op)
                torch.cuda.synchronize()
                p = K.segmented_scan(v, f, op)
                ok, err, ratio = segscan_compare(k, p, v, f, op)
                checked += 1
                if dtype.is_floating_point and op == "add":
                    worst = max(worst, err)
                    worst_ratio = max(worst_ratio, ratio)
                if not ok:
                    raise AssertionError(
                        f"segscan kernel differs from its plain version: "
                        f"{dtype} {op} n={n} {mode} (max abs err {err})")
    K.KERNEL_LAUNCHES.update(saved)  # comparison launches do not count
    res = {"cases": checked, "lengths": list(SEGSCAN_LENGTHS)
           + [SEGSCAN_SPAN_ROWS], "offsets": [list(o) for o in
                                              SEGSCAN_OFFSETS],
           "offset_rows": SEGSCAN_OFFSET_ROWS, "float_add_max_abs_err": worst,
           "float_add_max_err_over_tolerance": worst_ratio,
           "int_and_minmax_exact": True}
    log("segscan shapes: " + json.dumps(res))
    return res


def check_segscan_main_input(values, is_start, op: str) -> dict:
    """Kernel, plain version and torch.cummax on the largest main-path
    input (a geometry max scan), with times and bound."""
    import torch

    from spark_rapids_tpu_torch.exec import kernels as K

    saved = dict(K.KERNEL_LAUNCHES)
    k = K.segmented_scan_kernel(values, is_start, op)
    torch.cuda.synchronize()
    p = K.segmented_scan(values, is_start, op)
    ok, err, _ratio = segscan_compare(k, p, values, is_start, op)
    if not ok:
        raise AssertionError(f"segscan kernel differs from its plain version "
                             f"on the main path's largest input ({err})")
    # the geometry scans carry a start row's index forward: a segmented
    # max of (index at heads, -1 elsewhere) equals the running max
    lib = torch.cummax(values, 0).values
    if op != "max" or not torch.equal(lib, k):
        raise AssertionError("torch.cummax differs from the kernel on the "
                             "main path's largest geometry scan")
    res = {"shape": "main_path_largest", "exact": True, "max_abs_err": err,
           **segscan_times(values, is_start, op),
           "library_ms": cuda_ms(lambda: torch.cummax(values, 0))}
    K.KERNEL_LAUNCHES.update(saved)  # comparison launches do not count
    log("segscan main_path_largest: " + json.dumps(res))
    return res


def segscan_times(values, is_start, op: str) -> dict:
    """The scan kernel's times on one input (warm device time, the call
    with its host cost, host time a call, cold-L2 device time), the plain
    version's, and the byte bound."""
    from spark_rapids_tpu_torch.exec import kernels as K

    def kernel():
        return K.segmented_scan_kernel(values, is_start, op)
    n = values.numel()
    return {"rows": n, "dtype": str(values.dtype), "op": op,
            "heads": int(is_start.sum()), "kernel_ms": cuda_ms(kernel),
            "call_ms": cuda_ms(kernel, queued=False),
            "host_us": host_us(kernel), "cold_ms": cuda_ms(kernel, cold=True),
            "plain_ms": cuda_ms(lambda: K.segmented_scan(values, is_start,
                                                          op)),
            "bound_ms": segscan_bound_ms(n, values.element_size())}


def check_segscan_stress() -> dict:
    """Look-back stress: STRESS_CALLS scans of BEYOND_L2_SCAN_ROWS int32
    rows (max, 16 heads, so tiles carry across many tiles before them),
    each output equal to the first, the first equal to the plain one."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.exec import kernels as K

    saved = dict(K.KERNEL_LAUNCHES)
    n = BEYOND_L2_SCAN_ROWS
    rng = np.random.default_rng(43)
    v, _ = segscan_case(torch.int32, "max", n, "span", rng, "cuda")
    f = torch.zeros(n, dtype=torch.bool, device="cuda")
    f[torch.from_numpy(rng.choice(n, 16, replace=False)).cuda()] = True
    first = K.segmented_scan_kernel(v, f, "max")
    if not torch.equal(first, K.segmented_scan(v, f, "max")):
        raise AssertionError("segscan stress: the kernel differs from its "
                             "plain version")
    differ = 0
    for _ in range(STRESS_CALLS):
        differ += int(not torch.equal(K.segmented_scan_kernel(v, f, "max"),
                                      first))
    K.KERNEL_LAUNCHES.update(saved)
    res = {"rows": n, "calls": STRESS_CALLS, "heads": 16,
           "calls_differing": differ}
    log("segscan look-back stress: " + json.dumps(res))
    if differ:
        raise AssertionError(f"segscan stress: {differ} of {STRESS_CALLS} "
                             f"calls differ from the first")
    return res


def check_segscan_beyond_l2() -> dict:
    """A BEYOND_L2_SCAN_ROWS-row int32 add scan (1% heads): exact against
    the plain version, its time beside its byte bound."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.exec import kernels as K

    saved = dict(K.KERNEL_LAUNCHES)
    n = BEYOND_L2_SCAN_ROWS
    v, f = segscan_case(torch.int32, "add", n, "random",
                        np.random.default_rng(47), "cuda")
    k = K.segmented_scan_kernel(v, f, "add")
    if not torch.equal(k, K.segmented_scan(v, f, "add")):
        raise AssertionError("segscan beyond L2: the kernel differs from "
                             "its plain version")
    kernel_ms = cuda_ms(lambda: K.segmented_scan_kernel(v, f, "add"))
    call_ms = cuda_ms(lambda: K.segmented_scan_kernel(v, f, "add"),
                      queued=False)
    K.KERNEL_LAUNCHES.update(saved)
    bound = segscan_bound_ms(n, 4)
    res = {"shape": "beyond_l2", "rows": n, "dtype": "torch.int32",
           "op": "add", "exact": True, "kernel_ms": kernel_ms,
           "call_ms": call_ms, "bound_ms": bound,
           "share_of_bound": bound / kernel_ms}
    log("segscan beyond_l2: " + json.dumps(res))
    return res


def beyond_l2_probe_inputs(device):
    """(tbl, h1, h2, capacity, seed): about 3,000,000 distinct int64 keys
    built into BEYOND_L2_SLOTS slots (about 143 MB of table), and
    BEYOND_L2_PROBES probes, half of them build keys."""
    import numpy as np
    import pyarrow as pa
    import torch

    from spark_rapids_tpu_torch.columnar.batch import batch_from_arrow
    from spark_rapids_tpu_torch.exec import kernels as K

    rng = np.random.default_rng(53)
    n_build = 3_000_000
    mult = np.int64(2_654_435_761)  # odd: distinct keys stay distinct
    build_keys = np.arange(1, n_build + 1, dtype=np.int64) * mult
    half = BEYOND_L2_PROBES // 2
    miss = np.arange(n_build + 1, n_build + 1 + half, dtype=np.int64) * mult
    probe_keys = rng.permutation(np.concatenate(
        [rng.choice(build_keys, BEYOND_L2_PROBES - half), miss]))
    bb = batch_from_arrow(pa.table({"k": pa.array(build_keys, pa.int64())}),
                          device)
    pb = batch_from_arrow(pa.table({"k": pa.array(probe_keys, pa.int64())}),
                          device)
    valid = torch.ones(n_build, dtype=torch.bool, device=device)
    tbl, _ = K.build_hash_table(K.hash_keys(bb, [0]),
                                K.hash_keys(bb, [0], variant=1), valid,
                                BEYOND_L2_SLOTS, 0, K.HASHTBL_MAX_PROBES)
    return (tbl, K.hash_keys(pb, [0]), K.hash_keys(pb, [0], variant=1),
            BEYOND_L2_SLOTS, 0)


# ---------------------------------------------------------------------------
# main paths
# ---------------------------------------------------------------------------


def _py(v):
    import numpy as np

    return v.item() if isinstance(v, np.generic) else v


def reference_rows(cpu, q: str):
    """The pandas reference of one query as (rows, ORDER BY key list)."""
    if q == "q6":
        return [{"revenue": cpu["q6"]()}], None
    df = cpu[q]()
    df = df.reset_index() if q == "q1" else df.reset_index(drop=True)
    rows = [{k: _py(v) for k, v in r.items()}
            for r in df.to_dict("records")]
    keys = {"q1": ("l_returnflag", "l_linestatus"), "q3": ("l_orderkey",),
            "q5": ("n_name",)}[q]
    return rows, [tuple(r[k] for k in keys) for r in rows]


def run_main_path(sf: float, tables_seed: int = 0) -> dict:
    import torch

    from spark_rapids_tpu_torch.bench import tpch
    from spark_rapids_tpu_torch.exec import kernels as K

    t0 = time.perf_counter()
    tables = tpch.tables_for(sf, seed=tables_seed)
    log(f"generated TPC-H SF{sf}: lineitem {tables['lineitem'].num_rows} "
        f"rows in {time.perf_counter() - t0:.1f}s")
    d = tpch.df_tables(tables, batch_rows=1 << 20, device="cuda")
    cpu = tpch.cpu_tpch(*[tables[k] for k in (
        "lineitem", "orders", "customer", "supplier", "nation", "region")])
    queries = ["q1", "q3", "q5", "q6"]

    # record the largest probe call the main path makes
    largest = {}
    real_probe = K.probe_hash_table_kernel

    def recording_probe(tbl, h1, h2, capacity, seed, max_probes):
        if h1.numel() > largest.get("n", -1):
            largest.update(n=h1.numel(), args=(tbl, h1, h2, capacity, seed))
        return real_probe(tbl, h1, h2, capacity, seed, max_probes)

    K.probe_hash_table_kernel = recording_probe
    results = {}
    K.reset_kernel_launches()
    try:
        for q in queries:
            before = dict(K.KERNEL_LAUNCHES)
            t1 = time.perf_counter()
            out = tpch.DF_QUERIES[q](d).to_arrow()
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t1
            launches = {k: K.KERNEL_LAUNCHES[k] - before[k]
                        for k in K.KERNEL_LAUNCHES}
            got = out.to_pylist()
            exp, exp_order = reference_rows(cpu, q)
            if not tpch.rows_match(got, exp):
                raise AssertionError(f"{q} differs from the pandas "
                                     f"reference:\n{got[:5]}\n{exp[:5]}")
            if exp_order is not None:
                keys = {"q1": ("l_returnflag", "l_linestatus"),
                        "q3": ("l_orderkey",), "q5": ("n_name",)}[q]
                got_order = [tuple(r[k] for k in keys) for r in got]
                if got_order != exp_order:
                    raise AssertionError(f"{q} ORDER BY order differs: "
                                         f"{got_order} vs {exp_order}")
            results[q] = {"rows": len(got), "first_s": first_s,
                          "launches": launches}
            log(f"{q}: {len(got)} rows match the pandas reference; "
                f"launches {launches}; first run {first_s:.3f}s")
    finally:
        K.probe_hash_table_kernel = real_probe
    main_launches = dict(K.KERNEL_LAUNCHES)
    for q in ("q3", "q5"):
        if results[q]["launches"]["hashtbl_probe"] <= 0:
            raise AssertionError(f"{q} launched no probe kernel")
    # warm wall time per query (launches here are not the main path's)
    for q in queries:
        walls = []
        for _ in range(3):
            t1 = time.perf_counter()
            tpch.DF_QUERIES[q](d).to_arrow()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
        results[q]["warm_s"] = statistics.median(walls)
        log(f"{q}: warm wall {results[q]['warm_s']:.4f}s (median of 3)")
    K.KERNEL_LAUNCHES.update(main_launches)
    return {"queries": results, "launches": main_launches,
            "largest_probe": largest.get("args"),
            "lineitem_rows": tables["lineitem"].num_rows, "tables": tables}


def tpcds_tables(sf: float, seed: int = 0):
    from spark_rapids_tpu_torch.bench import tpcds_schema as S

    t0 = time.perf_counter()
    tables = S.tables_for(sf, seed=seed, names=S.ALL_TABLES)
    log(f"generated TPC-DS SF{sf}: store_sales "
        f"{tables['store_sales'].num_rows} rows, item "
        f"{tables['item'].num_rows} in {time.perf_counter() - t0:.1f}s")
    return tables


def run_tpcds_path(tables) -> dict:
    """q44 and q67 through the port's planner on the card, each held against
    its pandas reference, with the launch counts zeroed before each query
    and read after it; then warm wall times."""
    import torch

    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.exec import kernels as K

    d = Q.df_tables(tables, batch_rows=1 << 20, device="cuda")
    queries = ["q44", "q67"]

    largest = {}
    real_scan = K.segmented_scan_kernel

    def recording_scan(values, is_start, op_name="add"):
        if values.numel() > largest.get("n", -1):
            largest.update(n=values.numel(), args=(values, is_start, op_name))
        return real_scan(values, is_start, op_name)

    K.segmented_scan_kernel = recording_scan
    results = {}
    total = {k: 0 for k in K.KERNEL_LAUNCHES}
    try:
        for q in queries:
            K.reset_kernel_launches()
            t1 = time.perf_counter()
            out = Q.QUERIES[q](d).to_arrow()
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t1
            launches = dict(K.KERNEL_LAUNCHES)
            for k, v in launches.items():
                total[k] += v
            got = out.to_pylist()
            ok, why = Q.check_rows(q, got, Q.PANDAS[q](tables))
            if not ok:
                raise AssertionError(f"{q} differs from the pandas reference "
                                     f"({why}):\n{got[:3]}")
            if launches["segscan"] <= 0:
                raise AssertionError(f"{q} launched no segscan kernel")
            results[q] = {"rows": len(got), "first_s": first_s,
                          "launches": launches}
            log(f"{q}: {len(got)} rows match the pandas reference; "
                f"launches {launches}; first run {first_s:.3f}s")
    finally:
        K.segmented_scan_kernel = real_scan
    for q in queries:
        walls = []
        for _ in range(3):
            t1 = time.perf_counter()
            Q.QUERIES[q](d).to_arrow()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
        results[q]["warm_s"] = statistics.median(walls)
        log(f"{q}: warm wall {results[q]['warm_s']:.4f}s (median of 3)")
    return {"queries": results, "launches": total,
            "largest_segscan": largest.get("args"),
            "store_sales_rows": tables["store_sales"].num_rows}


def _warm_wall(run, reps: int = 3, first=None) -> float:
    """The median of ``reps`` timed runs of ``run``; ``first``, the wall of
    a run just made (tables uploaded, kernels built), counts as one."""
    import torch

    walls = [] if first is None else [first]
    while len(walls) < reps:
        t1 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    return statistics.median(walls)


def run_headline_path(tables) -> dict:
    """The TPC-DS half of bench.py's headline (q3/q7/q42/q52/q96) on the
    card in batches of 2^22 rows: every plan wholly on the device, each
    result held against its pandas reference and against the same query
    on the CPU engine, with the launch counts zeroed before each query and
    read after it; then warm wall times and the CPU engine's wall."""
    import torch

    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import kernels as K

    d = Q.df_tables(tables, batch_rows=1 << 22, device="cuda")
    cpu = Q.df_tables(tables, RapidsConf(
        {"spark.rapids.gpu.sql.enabled": "false"}), device="cuda")
    largest = {}
    real_probe = K.probe_hash_table_kernel

    def recording_probe(tbl, h1, h2, capacity, seed, max_probes):
        if h1.numel() > largest.get("n", -1):
            largest.update(n=h1.numel(), args=(tbl, h1, h2, capacity, seed))
        return real_probe(tbl, h1, h2, capacity, seed, max_probes)

    results, rows = {}, {}
    total = {k: 0 for k in K.KERNEL_LAUNCHES}
    K.probe_hash_table_kernel = recording_probe
    try:
        for q in Q.HEADLINE:
            plan = Q.QUERIES[q](d).explain("ALL")
            off = [ln.strip() for ln in plan.splitlines()
                   if ln.lstrip().startswith("!")]
            if off:
                raise AssertionError(f"{q} has nodes on the CPU engine: "
                                     f"{off}")
            K.reset_kernel_launches()
            t1 = time.perf_counter()
            out = Q.QUERIES[q](d).to_arrow()
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t1
            launches = dict(K.KERNEL_LAUNCHES)
            for k, v in launches.items():
                total[k] += v
            got = out.to_pylist()
            ok, why = Q.check_rows(q, got, Q.PANDAS[q](tables))
            if not ok:
                raise AssertionError(f"{q} differs from the pandas reference "
                                     f"({why}):\n{got[:3]}")
            if launches["hashtbl_probe"] <= 0:
                raise AssertionError(f"{q} launched no probe kernel")
            t1 = time.perf_counter()
            on_cpu = Q.QUERIES[q](cpu).to_arrow().to_pylist()
            cpu_s = time.perf_counter() - t1
            ok, why = Q.check_rows(q, on_cpu, got)
            if not ok:
                raise AssertionError(f"{q} on the CPU engine differs from "
                                     f"the card ({why})")
            results[q] = {"rows": len(got), "first_s": first_s,
                          "launches": launches, "cpu_engine_s": cpu_s}
            rows[q] = got
            log(f"{q}: {len(got)} rows match the pandas reference and the "
                f"CPU engine; launches {launches}; first run "
                f"{first_s:.3f}s; CPU engine {cpu_s:.3f}s")
    finally:
        K.probe_hash_table_kernel = real_probe
    for q in Q.HEADLINE:
        results[q]["warm_s"] = _warm_wall(lambda q=q: Q.QUERIES[q](d)
                                          .to_arrow())
        log(f"{q}: warm wall {results[q]['warm_s']:.4f}s (median of 3), "
            f"probe launches {results[q]['launches']['hashtbl_probe']}, "
            f"CPU engine {results[q]['cpu_engine_s']:.3f}s")
    results["mixed_string_range"] = run_mixed_plan(tables, d)
    return {"queries": results, "launches": total,
            "largest_probe": largest.get("args"), "rows": rows}


def run_joins_path(tables) -> dict:
    """q9/q28/q40/q43/q87/q88/q93/q97 on the card in batches of 2^22 rows:
    every plan wholly on the device, each result held against its pandas
    reference and against the same query on the CPU engine, with the
    launch counts zeroed before each query and read after it; then warm
    wall times. Records q93's probe into its largest table (the left
    join's store_sales rows into store_returns)."""
    import torch

    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import kernels as K

    d = Q.df_tables(tables, batch_rows=1 << 22, device="cuda")
    cpu = Q.df_tables(tables, RapidsConf(
        {"spark.rapids.gpu.sql.enabled": "false"}), device="cuda")
    largest = {}
    current = [None]
    real_probe = K.probe_hash_table_kernel

    def recording_probe(tbl, h1, h2, capacity, seed, max_probes):
        if current[0] == "q93":
            size = (capacity, h1.numel())
            if size > largest.get("size", (-1, -1)):
                largest.update(size=size, args=(tbl, h1, h2, capacity, seed))
        return real_probe(tbl, h1, h2, capacity, seed, max_probes)

    results, rows = {}, {}
    total = {k: 0 for k in K.KERNEL_LAUNCHES}
    K.probe_hash_table_kernel = recording_probe
    try:
        for q in Q.JOINS:
            current[0] = q
            plan = Q.QUERIES[q](d).explain("ALL")
            off = [ln.strip() for ln in plan.splitlines()
                   if ln.lstrip().startswith("!")]
            if off:
                raise AssertionError(f"{q} has nodes on the CPU engine: "
                                     f"{off}")
            K.reset_kernel_launches()
            t1 = time.perf_counter()
            out = Q.QUERIES[q](d).to_arrow()
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t1
            launches = dict(K.KERNEL_LAUNCHES)
            for k, v in launches.items():
                total[k] += v
            got = out.to_pylist()
            ok, why = Q.check_rows(q, got, Q.PANDAS[q](tables))
            if not ok:
                raise AssertionError(f"{q} differs from the pandas reference "
                                     f"({why}):\n{got[:3]}")
            if q != "q9" and launches["hashtbl_probe"] <= 0:
                raise AssertionError(f"{q} launched no probe kernel")
            current[0] = None
            t1 = time.perf_counter()
            on_cpu = Q.QUERIES[q](cpu).to_arrow().to_pylist()
            cpu_s = time.perf_counter() - t1
            ok, why = Q.check_rows(q, on_cpu, got)
            if not ok:
                raise AssertionError(f"{q} on the CPU engine differs from "
                                     f"the card ({why})")
            results[q] = {"rows": len(got), "first_s": first_s,
                          "launches": launches, "cpu_engine_s": cpu_s,
                          "first_row": {k: str(v) for k, v in
                                        (got[0] if got else {}).items()}}
            rows[q] = got
            log(f"{q}: {len(got)} rows match the pandas reference and the "
                f"CPU engine; launches {launches}; first run "
                f"{first_s:.3f}s; CPU engine {cpu_s:.3f}s")
    finally:
        K.probe_hash_table_kernel = real_probe
    for q in Q.JOINS:
        results[q]["warm_s"] = _warm_wall(lambda q=q: Q.QUERIES[q](d)
                                          .to_arrow())
        log(f"{q}: warm wall {results[q]['warm_s']:.4f}s (median of 3), "
            f"probe launches {results[q]['launches']['hashtbl_probe']}, "
            f"CPU engine {results[q]['cpu_engine_s']:.3f}s")
    return {"queries": results, "launches": total,
            "largest_probe": largest.get("args"), "rows": rows}


# worker processes of a query slice's CPU-engine checks (the card's
# machine has 8 cores)
CHECK_WORKERS = 6
# tables written once as Arrow IPC files for the check workers, by the
# identity of the dict they came from: {id: (dict, directory)}
_TABLE_FILES: dict = {}


def table_files(tables: dict, names) -> str:
    """A directory holding ``names`` of ``tables`` as Arrow IPC files (each
    written once a run; removed when the process exits)."""
    import atexit
    import shutil
    import tempfile

    import pyarrow as pa

    ent = _TABLE_FILES.get(id(tables))
    if ent is None or ent[0] is not tables:
        d = tempfile.mkdtemp(prefix="chip_smoke_tables_")
        atexit.register(shutil.rmtree, d, True)
        ent = _TABLE_FILES[id(tables)] = (tables, d)
    for name in names:
        path = os.path.join(ent[1], f"{name}.arrow")
        if not os.path.exists(path):
            with pa.OSFile(path, "wb") as f:
                with pa.ipc.new_file(f, tables[name].schema) as w:
                    w.write_table(tables[name])
    return ent[1]


def read_table_files(table_dir: str, names) -> dict:
    """The tables ``table_files`` wrote, memory-mapped."""
    import pyarrow as pa

    out = {}
    for name in names:
        with pa.memory_map(os.path.join(table_dir, f"{name}.arrow")) as f:
            out[name] = pa.ipc.open_file(f).read_all()
    return out


_POOL: list = []  # the run's one pool of check workers, made at first use


def check_workers():
    """The run's pool of ``CHECK_WORKERS`` spawned processes for the CPU
    engine's check runs, shared by every phase: run one after another on
    the host's CPU, they, not the card, set a phase's wall, and one pool
    for the run imports torch and the port once a process (a pool for
    each phase spawned dozens of processes, each importing them, beside the
    card's host thread on the machine's 8 cores). Tasks run in the order
    submitted."""
    import multiprocessing

    if not _POOL:
        import atexit

        _POOL.append(multiprocessing.get_context("spawn").Pool(
            CHECK_WORKERS))
        atexit.register(stop_check_workers)
    return _POOL[0]


def stop_check_workers() -> None:
    """End the run's check workers."""
    while _POOL:
        pool = _POOL.pop()
        pool.terminate()
        pool.join()


def tpcds_cpu_rows(q: str, table_dir: str) -> tuple:
    """A worker's check: TPC-DS query ``q`` on the CPU engine over the
    tables in ``table_dir``: (rows, seconds)."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.set_num_threads(1)
    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.config.conf import RapidsConf

    tables = read_table_files(table_dir, Q.TABLES[q])
    t0 = time.perf_counter()
    cpu = Q.df_tables(tables, RapidsConf(
        {"spark.rapids.gpu.sql.enabled": "false"}), device="cpu")
    rows = Q.QUERIES[q](cpu).to_arrow().to_pylist()
    return rows, time.perf_counter() - t0


def run_query_slice(tables, sf: float, queries, what: str, *,
                    device_only: bool, scan_queries=(),
                    extra=None, warm_reps: int = 3) -> dict:
    """A slice's TPC-DS ``queries`` on the card in batches of 2^22 rows:
    each plan's CPU-engine nodes printed with their reasons (a query with
    any is "mixed"; ``device_only`` makes one fail), one run with the
    launch counts zeroed before and read after, held against the same
    query on the CPU engine. Each result must show values
    (``Q.informative``) unless ``Q.EMPTY_AT_SF`` names it at ``sf``; the
    probe must launch in every query (each joins on the device) unless
    ``Q.EMPTY_ALWAYS`` names it, and the segmented scan in each of
    ``scan_queries``. ``extra(d, cpu)``, if given, runs the slice's own
    checks and returns more result entries. Records the probe into the
    slice's largest table and its largest probe; then runs every query
    once more with each probe call, and each segmented-scan call of
    ``scan_queries``, held against the plain version; then warm walls
    (the median of ``warm_reps`` runs). The CPU engine's runs go to
    worker processes started first (``check_workers``), which overlap
    the card's runs; the warm walls come after they return."""
    import torch

    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import kernels as K
    from spark_rapids_tpu_torch.exec import pipeline as PP
    from spark_rapids_tpu_torch.exec import reuse as R
    from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow
    from spark_rapids_tpu_torch.plan.overrides import join_paths

    d = Q.df_tables(tables, batch_rows=1 << 22, device="cuda")
    cpu = Q.df_tables(tables, RapidsConf(
        {"spark.rapids.gpu.sql.enabled": "false"}), device="cuda")
    empty_ok = Q.EMPTY_AT_SF.get(sf, ())
    queries = list(queries)
    by_table, by_rows = {}, {}
    real_probe = K.probe_hash_table_kernel

    def recording_probe(tbl, h1, h2, capacity, seed, max_probes):
        args = (tbl, h1, h2, capacity, seed)
        for rec, size in ((by_table, (capacity, h1.numel())),
                          (by_rows, (h1.numel(), capacity))):
            if size > rec.get("size", (-1, -1)):
                rec.update(size=size, args=args)
        return real_probe(tbl, h1, h2, capacity, seed, max_probes)

    results, rows = {}, {}
    total = {k: 0 for k in K.KERNEL_LAUNCHES}
    table_dir = table_files(tables, Q.tables_of(queries))
    pool = check_workers()
    pending = {q: pool.apply_async(tpcds_cpu_rows, (q, table_dir))
               for q in queries}
    K.probe_hash_table_kernel = recording_probe
    try:
        for q in queries:
            # counted and timed from the query's construction: q23/q24
            # run their threshold subqueries there
            K.reset_kernel_launches()
            R.reset_counters()
            PP.STATS.reset()
            t1 = time.perf_counter()
            df = Q.QUERIES[q](d)
            t2 = time.perf_counter()
            # a range exchange samples its child's partitions here
            plan = counted_plan(df)
            torch.cuda.synchronize()
            plan_s = time.perf_counter() - t2
            out = execute_to_arrow(plan)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t1
            launches = dict(K.KERNEL_LAUNCHES)
            for k, v in launches.items():
                total[k] += v
            off = [ln.strip() for ln in df.explain("ALL").splitlines()
                   if ln.lstrip().startswith("!")]
            for ln in off:
                log(f"{q}: on the CPU engine: {ln}")
            if off and device_only:
                raise AssertionError(f"{q} places {len(off)} nodes on the "
                                     f"CPU engine")
            paths = join_paths(plan)
            strategy = plan_strategy(plan)
            strategy["bytes_saved"] = R.counters()["reuse_bytes_saved_total"]
            got = out.to_pylist()
            # q76's probe sides are empty (no null promotion key): its
            # joins probe nothing here
            if ((launches["hashtbl_probe"] <= 0 and q not in
                 Q.EMPTY_ALWAYS) or "ht" not in paths):
                raise AssertionError(f"{q} launched no probe kernel (join "
                                     f"paths {paths})")
            if q in scan_queries and launches["segscan"] <= 0:
                raise AssertionError(f"{q} launched no segscan kernel")
            if not Q.informative(got) and q not in empty_ok:
                raise AssertionError(f"{q} shows no value at SF {sf}: "
                                     f"{got[:3]}")
            on_cpu, cpu_s = pending[q].get(timeout=900)
            ok, why = Q.check_rows(q, on_cpu, got)
            if not ok:
                raise AssertionError(f"{q} on the CPU engine differs from "
                                     f"the card ({why}):\n{got[:3]}\n"
                                     f"{on_cpu[:3]}")
            results[q] = {"rows": len(got), "informative":
                          Q.informative(got), "first_s": first_s,
                          "plan_s": plan_s,
                          "launches": launches, "cpu_engine_s": cpu_s,
                          "placement": "mixed" if off else "device",
                          "cpu_nodes": off, "join_paths": paths,
                          "strategy": strategy,
                          "shown": [{k: str(v) for k, v in r.items()}
                                    for r in got[:2]]}
            rows[q] = got
            log(f"{q}: {len(got)} rows match the CPU engine; "
                f"{results[q]['placement']}; launches {launches}; join "
                f"paths {paths}; first run {first_s:.3f}s; CPU engine "
                f"{cpu_s:.3f}s; first rows {results[q]['shown']}")
            if strategy["exchanges"] or strategy["broadcast_joins"]:
                log(f"{q}: planned in {plan_s:.3f}s; "
                    f"{strategy_line(strategy)}")
        if extra is not None:
            results.update(extra(d, cpu))
    finally:
        K.probe_hash_table_kernel = real_probe
    res = {"queries": results, "launches": total, "rows": rows,
           "probe_calls_checked": check_every_probe(d, queries),
           "largest_table_probe": by_table.get("args"),
           "largest_probe": by_rows.get("args")}
    if scan_queries:
        res["segscan_calls_checked"] = check_every_segscan(
            [lambda q=q: Q.QUERIES[q](d).to_arrow() for q in scan_queries],
            f"{len(scan_queries)} window queries of the {what} slice")
    for q in queries:
        results[q]["warm_s"] = _warm_wall(lambda q=q: Q.QUERIES[q](d)
                                          .to_arrow(), warm_reps)
        log(f"{q}: warm wall {results[q]['warm_s']:.4f}s (median of "
            f"{warm_reps}), launches {results[q]['launches']}, CPU engine "
            f"{results[q]['cpu_engine_s']:.3f}s")
    return res


def q76_with_null_promotions(tables):
    """Phase 10's extra check: q76 on tables with null promotion keys,
    where its joins have rows to probe, against the CPU engine."""
    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import kernels as K

    nulled = Q.with_null_promotions(tables)
    dn = Q.df_tables(nulled, batch_rows=1 << 22, device="cuda")
    K.reset_kernel_launches()
    got = Q.QUERIES["q76"](dn).to_arrow().to_pylist()
    launches = dict(K.KERNEL_LAUNCHES)
    on_cpu = Q.QUERIES["q76"](Q.df_tables(nulled, RapidsConf(
        {"spark.rapids.gpu.sql.enabled": "false"}),
        device="cuda")).to_arrow().to_pylist()
    ok, why = Q.check_rows("q76", on_cpu, got)
    if not ok or not Q.informative(got) or not launches["hashtbl_probe"]:
        raise AssertionError(f"q76 with null promotion keys: {why}; "
                             f"{len(got)} rows; launches {launches}")
    log(f"q76 with 10% null promotion keys: {len(got)} rows match the "
        f"CPU engine; launches {launches}")
    return {"q76_null_promotions": {"rows": len(got), "launches": launches}}


def q24_threshold_check(d, cpu):
    """Phase 11's extra check: q24's threshold subquery (a decimal(21,6)
    average) wholly on the device and equal to the CPU engine's."""
    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.exec import kernels as K
    from spark_rapids_tpu_torch.exprs.expr import Average, col

    sub = Q._q24_paid(d).agg(Average(col("netpaid")).alias("m"))
    off = [ln.strip() for ln in sub.explain("ALL").splitlines()
           if ln.lstrip().startswith("!")]
    K.reset_kernel_launches()
    thresh = Q.q24_threshold(d)
    launches = dict(K.KERNEL_LAUNCHES)
    on_cpu = Q.q24_threshold(cpu)
    if off or thresh != on_cpu or not thresh or not launches[
            "hashtbl_probe"]:
        raise AssertionError(f"q24's threshold subquery: CPU nodes "
                             f"{off}; {thresh} against the CPU "
                             f"engine's {on_cpu}; launches {launches}")
    log(f"q24 threshold subquery wholly on the device: {thresh} equals "
        f"the CPU engine's; launches {launches}")
    return {"q24_threshold": {"value": str(thresh), "launches": launches}}


# the decimal slice's queries that compute a window (their geometry and
# window sums run through the segmented-scan kernel)
DECIMAL_WINDOWS = ("q12", "q20", "q98", "q36", "q49", "q51", "q53", "q63")


def check_every_segscan(runs, what: str) -> dict:
    """Calls each of ``runs`` once more with every segmented-scan call held
    against the plain version on the same inputs: integers and min/max
    exactly (NaN equal to NaN), float adds within
    ``segscan_add_tolerance``. These launches are not counted. Returns the
    number of calls checked by op."""
    from spark_rapids_tpu_torch.exec import kernels as K

    real_scan = K.segmented_scan_kernel
    calls = {"add": 0, "min": 0, "max": 0}
    saved = dict(K.KERNEL_LAUNCHES)
    K.segmented_scan_kernel = checking_scan(real_scan, calls)
    try:
        for run in runs:
            run()
    finally:
        K.segmented_scan_kernel = real_scan
        K.KERNEL_LAUNCHES.update(saved)  # comparison launches do not count
    log(f"segscan: all {sum(calls.values())} calls ({calls}) of {what} "
        f"equal the plain version")
    return calls


def checking_scan(real_scan, calls):
    """A segmented-scan wrapper that holds every call of ``real_scan``
    against the plain version (integers and min/max exactly, NaN equal to
    NaN, float adds within ``segscan_add_tolerance``) and counts it by op
    in ``calls``."""
    import torch

    from spark_rapids_tpu_torch.exec import kernels as K

    def scan(values, is_start, op_name="add"):
        k = real_scan(values, is_start, op_name)
        p = K.segmented_scan(values, is_start, op_name)
        if values.is_floating_point() and op_name == "add":
            running = K.segmented_scan(values.abs(), is_start, "add")
            tol = K.segscan_add_tolerance(running, values.numel(),
                                          values.dtype)
            ok = bool(((k - p).abs() <= tol).all())
        else:
            ok = torch.equal(k, p) or bool(
                ((k == p) | (torch.isnan(k) & torch.isnan(p))).all()
                if k.is_floating_point() else False)
        if not ok:
            raise AssertionError(
                f"segscan kernel differs from its plain version on a "
                f"{values.numel()}-row {values.dtype} {op_name} scan")
        with lock:
            calls[op_name] += 1
        return k

    lock = threading.Lock()  # prefetch workers call it too
    return scan


def decimal_divide_cost(n: int = 2_880_000, checked: int = 100_000) -> dict:
    """One decimal(17,2) / decimal(17,2) Divide (a decimal(37,20) quotient)
    over ``n`` seeded rows on the card: torch kernel launches and device
    time of one profiled call, host time of a call (median of 5, each
    ending in a synchronise), and its first ``checked`` rows against the
    same Divide on the CPU."""
    import numpy as np
    import pyarrow as pa
    import torch
    from torch.profiler import ProfilerActivity, profile

    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.bench.profile_tpch import device_events
    from spark_rapids_tpu_torch.columnar.batch import batch_from_arrow
    from spark_rapids_tpu_torch.exprs import eval as EV
    from spark_rapids_tpu_torch.exprs import expr as E

    rng = np.random.default_rng(17)
    a = rng.integers(-10**17 + 1, 10**17, n)
    b = rng.integers(-10**9, 10**9, n)
    b[::1000] = 0
    dec = T.DecimalType(17, 2)

    def column(u):
        limbs = np.stack([u, u >> 63], 1).astype(np.int64)
        return pa.Array.from_buffers(dec.arrow_type(), n,
                                     [None, pa.py_buffer(limbs.tobytes())])
    t = pa.table({"a": column(a), "b": column(b)})
    expr = E.resolve(E.Divide(E.col("a"), E.col("b")),
                     T.Schema.from_arrow(t.schema))
    batch = batch_from_arrow(t, "cuda")

    def call():
        return EV.eval_expr(expr, EV.EvalContext(batch))
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    events = device_events(prof)
    kernels = [us for name, us in events
               if "memcpy" not in name.lower() and "memset" not in
               name.lower()]
    walls = []
    for _ in range(5):
        t1 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    got = call()
    small = batch_from_arrow(t.slice(0, checked), "cpu")
    exp = EV.eval_expr(expr, EV.EvalContext(small))
    if not (torch.equal(got.data[:checked].cpu(), exp.data)
            and torch.equal(got.validity[:checked].cpu(), exp.validity)):
        raise AssertionError("the decimal Divide on the card differs from "
                             "the CPU's")
    res = {"rows": n, "result_type": expr.dtype.name,
           "kernel_launches": len(kernels),
           "device_ms": sum(kernels) / 1e3,
           "host_ms": statistics.median(walls) * 1e3,
           "host_ms_all": [w * 1e3 for w in walls],
           "null_rows": int((~got.validity).sum())}
    log(f"decimal divide {expr.dtype.name} over {n} rows: "
        f"{res['kernel_launches']} kernel launches, device "
        f"{res['device_ms']:.3f} ms, call {res['host_ms']:.3f} ms (median "
        f"of 5); first {checked} rows equal the CPU's")
    return res


def window_surface_exprs():
    """Phase 12's window-surface pass over store_sales, as (alias, window
    expression): one (partition, order) spec, partitioned by store and
    item and ordered by the sale date, with lead/lag (with defaults),
    ntile, percent_rank, cume_dist, first/last and Sum/Min/Max over ROWS 3
    PRECEDING..3 FOLLOWING on a double, an int and a decimal(7,2) column,
    a Sum over RANGE 30 PRECEDING..CURRENT ROW of the date key and a
    DECIMAL128 Sum over the ROWS frame."""
    import decimal

    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.exprs import expr as E
    from spark_rapids_tpu_torch.exprs import window as W

    parts, order = ["ss_store_sk", "ss_item_sk"], ["ss_sold_date_sk"]
    spec = W.window_spec(parts, order)
    rows = W.window_spec(parts, order, W.WindowFrame("rows", -3, 3))
    dates = W.window_spec(parts, order, W.WindowFrame("range", -30, 0))
    wide = E.Cast(E.col("ss_ext_sales_price"), T.DecimalType(20, 2))
    fs = (("lead_price", W.Lead(E.col("ss_sales_price"), 1, E.Literal(
              decimal.Decimal("0.00"), T.DecimalType(7, 2))), spec),
          ("lag_qty", W.Lag(E.col("ss_quantity"), 2, E.lit(-1.0)), spec),
          ("ntile4", W.NTile(4), spec),
          ("percent_rank", W.PercentRank(), spec),
          ("cume_dist", W.CumeDist(), spec),
          ("first_profit", E.First(E.col("ss_net_profit")), rows),
          ("last_customer", E.Last(E.col("ss_customer_sk")), rows),
          ("sum_qty", E.Sum(E.col("ss_quantity")), rows),
          ("min_qty", E.Min(E.col("ss_quantity")), rows),
          ("max_qty", E.Max(E.col("ss_quantity")), rows),
          ("sum_ticket", E.Sum(E.col("ss_ticket_number")), rows),
          ("min_ticket", E.Min(E.col("ss_ticket_number")), rows),
          ("max_ticket", E.Max(E.col("ss_ticket_number")), rows),
          ("sum_price", E.Sum(E.col("ss_sales_price")), rows),
          ("min_price", E.Min(E.col("ss_sales_price")), rows),
          ("max_price", E.Max(E.col("ss_sales_price")), rows),
          ("range_sum_price", E.Sum(E.col("ss_sales_price")), dates),
          ("sum_wide", E.Sum(wide), rows))
    return [(a, W.over(f, sp).alias(a)) for a, f, sp in fs]


def _columns_agree(a, b, rel: float = 1e-6) -> bool:
    """Two Arrow columns equal (nulls in the same rows; doubles within
    ``rel`` of each other, NaN equal to NaN)."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc

    a, b = a.combine_chunks(), b.combine_chunks()
    if a.type != b.type or len(a) != len(b):
        return False
    va = np.asarray(a.is_valid(), dtype=bool)
    if not (va == np.asarray(b.is_valid(), dtype=bool)).all():
        return False
    if pa.types.is_floating(a.type):
        x = a.fill_null(0).to_numpy(zero_copy_only=False)
        y = b.fill_null(0).to_numpy(zero_copy_only=False)
        same = (x == y) | (np.isnan(x) & np.isnan(y))
        close = np.abs(x - y) <= rel * np.maximum(
            1.0, np.maximum(np.abs(x), np.abs(y)))
        return bool((same | close).all())
    return bool(pc.all(pc.equal(a, b).fill_null(True)).as_py())


def start_window_surface_check(tables):
    """The window-surface pass's CPU-engine run in a worker process of
    its own, started phases ahead of the pass (it runs for tens of seconds
    on the host's CPU): its pending result."""
    return check_workers().apply_async(cpu_engine_table, (
        "window", "surface", table_files(tables, ["store_sales"])))


def window_surface_pass(tables, check) -> dict:
    """Phase 12's window-surface pass over store_sales (2,880,000 rows at
    SF1, one batch): all of ``window_surface_exprs`` in one window node,
    with the launch counts zeroed before and read after, each column held
    against the CPU engine's; every segmented-scan call of the pass held
    against the plain version; each window's wall alone (median of 3, its
    rows left on the card; a row_number over the same spec beside them)
    and its launches; the largest min scan's (in bytes) times against its
    byte bound;
    and the torch kernels and device time one bounded RANGE window adds
    to a running sum of the same column. The CPU engine's pass runs in a
    worker process (``check``, from ``start_window_surface_check``)
    while the card runs."""
    import torch

    from spark_rapids_tpu_torch.bench.profile_tpch import device_events
    from spark_rapids_tpu_torch.exec import kernels as K
    from spark_rapids_tpu_torch.exprs import expr as E
    from spark_rapids_tpu_torch.exprs import window as W
    from spark_rapids_tpu_torch.plan import from_arrow
    from torch.profiler import ProfilerActivity, profile

    ss = tables["store_sales"]
    dev = from_arrow(ss, batch_rows=1 << 22, device="cuda")
    pending = check  # ``start_window_surface_check``'s
    exprs = window_surface_exprs()
    windows = [w for _a, w in exprs]
    largest = {}
    real_scan = K.segmented_scan_kernel

    def recording_scan(values, is_start, op_name="add"):
        size = values.numel() * values.element_size()
        if op_name == "min" and size > largest.get("bytes", -1):
            largest.update(bytes=size, args=(values, is_start))
        return real_scan(values, is_start, op_name)

    df = dev.with_window(*windows)
    if any(ln.lstrip().startswith("!") for ln in df.explain().splitlines()):
        raise AssertionError("the window-surface pass is not wholly on the "
                             "device:\n" + df.explain())
    plan = counted_plan(df)
    K.segmented_scan_kernel = recording_scan
    try:
        from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow

        K.reset_kernel_launches()
        t1 = time.perf_counter()
        got = execute_to_arrow(plan)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t1
        launches = dict(K.KERNEL_LAUNCHES)
    finally:
        K.segmented_scan_kernel = real_scan
    if launches["segscan"] <= 0:
        raise AssertionError("the window-surface pass launched no segscan")
    t1 = time.perf_counter()
    path, cpu_s = pending.get(timeout=900)
    exp = read_cpu_table(path)
    log(f"window surface: waited {time.perf_counter() - t1:.2f}s for the "
        f"CPU engine's worker")
    columns = {}
    for a, _w in exprs:
        ok = _columns_agree(got.column(a), exp.column(a))
        if not ok:
            raise AssertionError(f"window-surface column {a} differs from "
                                 f"the CPU engine's")
        columns[a] = {"nulls": got.column(a).null_count}
    for name in ("ss_store_sk", "ss_item_sk", "ss_sold_date_sk"):
        if not _columns_agree(got.column(name), exp.column(name)):
            raise AssertionError(f"window-surface rows differ from the CPU "
                                 f"engine's in {name}")
    log(f"window surface over {ss.num_rows} store_sales rows: all "
        f"{len(exprs)} columns equal the CPU engine's; launches "
        f"{launches}; first run {first_s:.3f}s; CPU engine {cpu_s:.3f}s")
    scans = check_every_segscan([lambda: df.to_arrow()],
                                "the window-surface pass")
    # each window alone, its rows left on the card (no Arrow out): the
    # device wall of the scan and the window node; a row_number over the
    # same spec is the sort, gathers and geometry every window pays
    spec = W.window_spec(["ss_store_sk", "ss_item_sk"], ["ss_sold_date_sk"])
    alone = [("row_number", W.over(W.RowNumber(), spec).alias("rn"))]
    columns["row_number"] = {}
    for a, w in alone + exprs:
        one = dev.with_window(w).physical_plan()
        K.reset_kernel_launches()
        list(one.execute_all())
        torch.cuda.synchronize()
        columns[a]["launches"] = dict(K.KERNEL_LAUNCHES)
        columns[a]["warm_s"] = _warm_wall(
            lambda one=one: list(one.execute_all()))
        log(f"window {a}: warm wall {columns[a]['warm_s']:.4f}s (median of "
            f"3, rows left on the card), launches {columns[a]['launches']}")
    min_scan = segscan_times(*largest["args"], "min")
    log("segscan bounded-window min scan: " + json.dumps(min_scan))

    def profiled(w):
        one = dev.with_window(w)
        one.to_arrow()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            one.to_arrow()
            torch.cuda.synchronize()
        ks = [us for name, us in device_events(prof)
              if "memcpy" not in name.lower()
              and "memset" not in name.lower()]
        return len(ks), sum(ks) / 1e3
    ranged = dict(exprs)["range_sum_price"]
    running = W.over(E.Sum(E.col("ss_sales_price")), W.window_spec(
        ["ss_store_sk", "ss_item_sk"], ["ss_sold_date_sk"],
        W.WindowFrame("rows", None, 0))).alias("running_sum_price")
    (rk, rms), (bk, bms) = profiled(ranged), profiled(running)
    range_cost = {"kernels": rk, "device_ms": rms, "running_kernels": bk,
                  "running_device_ms": bms, "added_kernels": rk - bk,
                  "added_device_ms": rms - bms}
    log(f"bounded RANGE window: {rk} torch kernels, {rms:.3f} ms of device "
        f"time; a running ROWS sum of the same column {bk}, {bms:.3f} ms: "
        f"the bisection adds {rk - bk} kernels, {rms - bms:.3f} ms")
    return {"rows": ss.num_rows, "first_s": first_s, "cpu_engine_s": cpu_s,
            "launches": launches, "columns": columns,
            "segscan_calls_checked": scans, "min_scan": min_scan,
            "range_window": range_cost}


def check_every_probe(d, queries) -> int:
    """Runs each query once more with every probe call held against the
    plain version on the same inputs: slots and hits must be equal. These
    launches are not counted. Returns the number of calls checked."""
    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.exec import kernels as K

    real_probe = K.probe_hash_table_kernel
    calls = [0]
    saved = dict(K.KERNEL_LAUNCHES)
    K.probe_hash_table_kernel = checking_probe(real_probe, calls)
    try:
        for q in queries:
            Q.QUERIES[q](d).to_arrow()
    finally:
        K.probe_hash_table_kernel = real_probe
        K.KERNEL_LAUNCHES.update(saved)  # comparison launches do not count
    log(f"probe: all {calls[0]} calls of {len(queries)} queries equal the "
        f"plain version")
    return calls[0]


def checking_probe(real_probe, calls):
    """A probe wrapper that holds every call of ``real_probe`` exactly
    against the plain version and counts it in ``calls[0]``."""
    import torch

    from spark_rapids_tpu_torch.exec import kernels as K

    def probe(tbl, h1, h2, capacity, seed, max_probes):
        ks, kh = real_probe(tbl, h1, h2, capacity, seed, max_probes)
        ps, ph = K.probe_hash_table(tbl, h1, h2, capacity, seed,
                                    max_probes)
        if not (torch.equal(ks, ps) and torch.equal(kh, ph)):
            raise AssertionError(
                f"probe kernel differs from its plain version on a "
                f"{h1.numel()}-row probe into {capacity} slots")
        with lock:
            calls[0] += 1
        return ks, kh

    lock = threading.Lock()  # prefetch workers call it too
    return probe


def run_sorted_hash(tables, rows: dict) -> dict:
    """Every join query of phases 6, 7 and 9 again with
    ``spark.rapids.gpu.sql.join.hashTable.enabled=false``: every device
    join must take the sorted-hash path (no probe launch), and the rows
    must equal the hash-table run's (``rows``)."""
    import torch

    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import kernels as K
    from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow
    from spark_rapids_tpu_torch.plan.overrides import join_paths

    d = Q.df_tables(tables, RapidsConf(
        {"spark.rapids.gpu.sql.join.hashTable.enabled": "false"}),
        batch_rows=1 << 22, device="cuda")
    results = {}
    for q, exp in rows.items():
        plan = counted_plan(Q.QUERIES[q](d))
        K.reset_kernel_launches()
        got = execute_to_arrow(plan).to_pylist()
        torch.cuda.synchronize()
        paths = join_paths(plan)
        if "sorted" not in paths or any(p not in ("sorted", "empty", "cpu")
                                        for p in paths):
            raise AssertionError(f"{q} with the hash table off took join "
                                 f"paths {paths}")
        if K.KERNEL_LAUNCHES["hashtbl_probe"]:
            raise AssertionError(f"{q} launched the probe with the hash "
                                 f"table off")
        ok, why = Q.check_rows(q, got, exp)
        if not ok:
            raise AssertionError(f"{q} on the sorted-hash path differs from "
                                 f"the hash-table path ({why})")
        results[q] = {"rows": len(got), "join_paths": paths}
        log(f"{q}: sorted-hash path, {len(got)} rows equal the hash-table "
            f"run's; join paths {paths}")
    return results


def mixed_string_range(d):
    """Sales of the items whose brand sorts below "brand#5": the filter's
    string ordering comparison runs on the CPU engine, the joins, the
    aggregate and the sort above it on the card."""
    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.exprs.expr import (
        EqualTo, LessThan, Sum, col, lit)

    it = d["item"].filter(LessThan(col("i_brand"), lit("brand#5")))
    dt = d["date_dim"].filter(EqualTo(col("d_year"), lit(2001)))
    return (d["store_sales"]
            .join(dt, left_on="ss_sold_date_sk", right_on="d_date_sk")
            .join(it, left_on="ss_item_sk", right_on="i_item_sk")
            .group_by("i_category")
            .agg(Sum(col("ss_ext_sales_price")).alias("sales"))
            .sort(Q.desc("sales"), "i_category"))


def pandas_mixed_string_range(tables):
    import decimal

    import pandas as pd

    from spark_rapids_tpu_torch.bench import tpcds_queries as Q

    ss = tables["store_sales"]
    sales = {"ss_sold_date_sk": ss.column("ss_sold_date_sk").to_numpy(),
             "ss_item_sk": ss.column("ss_item_sk").to_numpy(),
             "price": Q._unscaled(ss.column("ss_ext_sales_price"))}
    dd = tables["date_dim"].to_pandas()
    it = tables["item"].to_pandas()
    it = it[it.i_brand < "brand#5"][["i_item_sk", "i_category"]]
    j = (pd.DataFrame(sales)
         .merge(dd[dd.d_year == 2001][["d_date_sk"]],
                left_on="ss_sold_date_sk", right_on="d_date_sk")
         .merge(it, left_on="ss_item_sk", right_on="i_item_sk"))
    g = j.groupby("i_category").price.sum().reset_index()
    g = g.sort_values(["price", "i_category"], ascending=[False, True],
                      kind="stable")
    return [{"i_category": c, "sales": decimal.Decimal(int(p)).scaleb(-2)}
            for c, p in zip(g.i_category, g.price)]


def run_mixed_plan(tables, d) -> dict:
    import torch

    from spark_rapids_tpu_torch.exec import kernels as K

    df = mixed_string_range(d)
    plan = df.explain("ALL")
    off = [ln.strip() for ln in plan.splitlines()
           if ln.lstrip().startswith("!")]
    if len(off) != 1 or not off[0].startswith("! Filter"):
        raise AssertionError(f"the mixed plan should put its string filter "
                             f"alone on the CPU engine:\n{plan}")
    K.reset_kernel_launches()
    t1 = time.perf_counter()
    got = df.to_arrow().to_pylist()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(K.KERNEL_LAUNCHES)
    exp = pandas_mixed_string_range(tables)
    if got != exp:
        raise AssertionError(f"the mixed plan differs from pandas:\n"
                             f"{got[:3]}\n{exp[:3]}")
    if launches["hashtbl_probe"] <= 0:
        raise AssertionError("the mixed plan launched no probe kernel")
    log(f"mixed plan (string range filter on the CPU engine): {len(got)} "
        f"rows match pandas; launches {launches}; {wall:.3f}s\n{plan}")
    return {"rows": len(got), "wall_s": wall, "launches": launches,
            "cpu_nodes": off}

# phase 13's TPC-DS queries: the headline, a window over a partial
# aggregate (q67), a window partitioned by plain strings (q47), left and
# full joins (q93, q97), string keys through distinct exchanges and semi
# joins (q38; q87, its EXCEPT twin, counts 0 at every SF of the
# generators, since every name pair is in every channel), a lone
# COUNT(DISTINCT) (q16) and a union (q77)
PARTITIONED_DS = ("q3", "q7", "q42", "q52", "q96", "q67", "q47", "q93",
                  "q97", "q38", "q16", "q77")
PARTITIONED_WINDOWS = ("q67", "q47")
# q38 once more with this broadcast threshold: customer (100,000 rows at
# SF1) and the filtered date_dim still broadcast, the two channels'
# distinct name pairs (estimates 360,000 and 180,000) do not, so both
# string-keyed semi joins are shuffled joins of two hash exchanges
SHUFFLED_Q38_BROADCAST_ROWS = 150_000
SORT_COLUMNS = ("ss_sold_date_sk", "ss_item_sk", "ss_ticket_number",
                "ss_net_paid")


def plan_strategy(plan) -> dict:
    """An executed physical plan's exchanges by partitioner, its joins by
    strategy, its exchanges' shuffle bytes and times (the device passes
    (split), waiting for the writer threads and the reads on the calling
    thread, AQE readers' reads included, and the part of the reads spent
    waiting for a read-ahead; serialization summed over the
    writer threads), each AQE reader's specs, its reused exchanges and
    broadcasts, its prefetch boundaries and the prefetch counters
    (``exec/pipeline.STATS``: batches handed over and consumer stalls,
    since the caller's ``reset``)."""
    from spark_rapids_tpu_torch.exec import pipeline as PP
    from spark_rapids_tpu_torch.exec.join import HashJoinExec
    from spark_rapids_tpu_torch.exec.pipeline import PrefetchExec
    from spark_rapids_tpu_torch.exec.reuse import (
        ReusedBroadcastExec, ReusedExchangeExec)
    from spark_rapids_tpu_torch.plan.overrides import join_strategy
    from spark_rapids_tpu_torch.shuffle.aqe import (
        AQEShuffleReadExec, CoalescedPartitionSpec)
    from spark_rapids_tpu_torch.shuffle.exchange_exec import (
        ShuffleExchangeExec)

    out = {"exchanges": {}, "broadcast_joins": 0, "shuffled_joins": 0,
           "one_partition_joins": 0, "shuffle_bytes_written": 0,
           "shuffle_bytes_read": 0, "split_ms": 0.0, "serialize_ms": 0.0,
           "wait_ms": 0.0, "read_ms": 0.0, "read_ahead_wait_ms": 0.0,
           "aqe_readers": [],
           "coalesced_specs": 0, "skew_split_specs": 0,
           "reused_exchanges": 0, "reused_broadcasts": 0, "prefetch": 0,
           "prefetch_stats": PP.STATS.snapshot()}
    stack = [plan]
    while stack:
        n = stack.pop()
        stack.extend(n.children)
        if isinstance(n, ShuffleExchangeExec):
            k = n.partitioner.describe()
            out["exchanges"][k] = out["exchanges"].get(k, 0) + 1
            m = n.metrics
            out["shuffle_bytes_written"] += m["shuffleBytesWritten"].value
            out["shuffle_bytes_read"] += m["shuffleBytesRead"].value
            for k in ("split", "serialize", "wait", "read"):
                out[f"{k}_ms"] += m[f"{k}TimeNs"].value / 1e6
            out["read_ahead_wait_ms"] += m["readAheadWaitNs"].value / 1e6
        elif isinstance(n, AQEShuffleReadExec):
            specs = n.planned_specs() or []
            co = sum(isinstance(sp, CoalescedPartitionSpec) for sp in specs)
            out["coalesced_specs"] += co
            out["skew_split_specs"] += len(specs) - co
            out["aqe_readers"].append(
                f"{type(n).__name__}: " + " ".join(sp.describe()
                                                   for sp in specs))
            out["shuffle_bytes_read"] += n.metrics["shuffleBytesRead"].value
            out["read_ms"] += n.metrics["readTimeNs"].value / 1e6
            out["read_ahead_wait_ms"] += (
                n.metrics["readAheadWaitNs"].value / 1e6)
        elif isinstance(n, ReusedExchangeExec):
            out["reused_exchanges"] += 1
        elif isinstance(n, ReusedBroadcastExec):
            out["reused_broadcasts"] += 1
        elif isinstance(n, PrefetchExec):
            out["prefetch"] += 1
        elif isinstance(n, HashJoinExec):
            out[f"{join_strategy(n)}_joins"] += 1
    return out


def strategy_line(s: dict) -> str:
    """plan_strategy's record as one log line."""
    return (f"exchanges {s['exchanges']}, joins broadcast "
            f"{s['broadcast_joins']} shuffled {s['shuffled_joins']} "
            f"one-partition {s['one_partition_joins']}; shuffle "
            f"{s['shuffle_bytes_written']} B written "
            f"{s['shuffle_bytes_read']} B read; split {s['split_ms']:.1f} "
            f"ms, serialize {s['serialize_ms']:.1f} ms, wait "
            f"{s['wait_ms']:.1f} ms, read {s['read_ms']:.1f} ms (of it "
            f"{s['read_ahead_wait_ms']:.1f} ms waiting for a read-ahead); "
            f"AQE "
            f"{s['aqe_readers']}; reused {s['reused_exchanges']} exchanges "
            f"{s['reused_broadcasts']} broadcasts, "
            f"{s.get('bytes_saved', 0)} B saved; {s['prefetch']} prefetch "
            f"boundaries ({s['prefetch_stats']['prefetch_items']} batches, "
            f"{s['prefetch_stats']['prefetch_stalls']} stalls)")


def sorted_store_sales(d):
    """One global ORDER BY ss_net_paid over store_sales, no limit."""
    return d["store_sales"].select(*SORT_COLUMNS).sort("ss_net_paid")


def same_sorted_rows(got, exp) -> bool:
    """The key column in the same order, the rows as a multiset."""
    if not got.column("ss_net_paid").equals(exp.column("ss_net_paid")):
        return False
    keys = [(c, "ascending") for c in SORT_COLUMNS]
    return got.sort_by(keys).equals(exp.sort_by(keys))


def cpu_engine_table(kind: str, name: str, table_dir: str) -> tuple:
    """A worker's check of phase 12 or 13: the CPU engine's result of a
    case over the tables in ``table_dir``, written there as an Arrow file
    (its path and seconds are returned; the rows may be millions). ``kind``
    "tpch" runs TPC-H ``name``, "sort" store_sales by SORT_COLUMNS,
    "window" the window-surface pass, "tpcds" TPC-DS ``name`` (q38 for
    "q38_shuffled_joins")."""
    import pyarrow as pa
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.set_num_threads(1)
    from spark_rapids_tpu_torch.bench import tpch
    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.plan import from_arrow

    off = RapidsConf({"spark.rapids.gpu.sql.enabled": "false"})
    names = [f[:-len(".arrow")] for f in os.listdir(table_dir)
             if f.endswith(".arrow") and not f.startswith("cpu_")]
    t0 = time.perf_counter()
    if kind == "tpch":
        tables = read_table_files(table_dir, names)
        out = tpch.DF_QUERIES[name](tpch.df_tables(
            tables, off, device="cpu")).to_arrow()
    elif kind == "window":
        ss = read_table_files(table_dir, ["store_sales"])["store_sales"]
        out = from_arrow(ss, off, device="cpu").with_window(
            *[w for _a, w in window_surface_exprs()]).to_arrow()
    else:
        q = "q38" if name == "q38_shuffled_joins" else name
        need = ["store_sales"] if kind == "sort" else query_tables(q)
        d = Q.df_tables(read_table_files(table_dir, need), off,
                        device="cpu")
        out = (sorted_store_sales(d) if kind == "sort"
               else Q.QUERIES[q](d)).to_arrow()
    secs = time.perf_counter() - t0
    path = os.path.join(table_dir, f"cpu_{kind}_{name}.arrow")
    with pa.OSFile(path, "wb") as f:
        with pa.ipc.new_file(f, out.schema) as w:
            w.write_table(out)
    return path, secs


def query_tables(q: str):
    """The TPC-DS tables query ``q`` reads (the headline queries read the
    generator's eight base tables)."""
    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.bench import tpcds_schema as S

    return Q.TABLES.get(q, S.BASE_TABLES)


def read_cpu_table(path: str):
    """A worker's result (``cpu_engine_table``), read whole and removed."""
    import pyarrow as pa

    with pa.memory_map(path) as f:
        out = pa.ipc.open_file(f).read_all()
    os.remove(path)
    return out


def run_partitioned_path(tpch_tables, ds_tables) -> dict:
    """Phase 13: each query with 4 source splits and 4 shuffle partitions,
    wholly on the device, against one partition and the CPU engine, with
    its exchanges, joins, shuffle bytes and times and kernel launches;
    every kernel call of the path against its plain version; warm walls
    partitioned and in one partition."""
    import torch

    from spark_rapids_tpu_torch.bench import tpch
    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import kernels as K
    from spark_rapids_tpu_torch.exec import pipeline as PP
    from spark_rapids_tpu_torch.exec import reuse as R
    from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow

    tpch_order = {"q1": ("l_returnflag", "l_linestatus"),
                  "q3": ("l_orderkey",), "q5": ("n_name",), "q6": ()}

    def tpch_check(q, got, exp):
        keys = tpch_order[q]
        ok = tpch.rows_match(got, exp) and (
            [tuple(r[k] for k in keys) for r in got]
            == [tuple(r[k] for k in keys) for r in exp])
        return ok, "" if ok else "rows or ORDER BY order differ"

    def four(extra=None):
        """The 4-split frames of the cases: TPC-H, TPC-DS, and TPC-DS with
        q38's string-keyed semi joins shuffled."""
        conf = RapidsConf(extra or {})
        shuffled = RapidsConf(dict(extra or {}, **{
            "spark.rapids.gpu.sql.join.broadcastRowThreshold":
                SHUFFLED_Q38_BROADCAST_ROWS}))
        return {"h": tpch.df_tables(tpch_tables, conf, batch_rows=1 << 20,
                                    device="cuda", partitions=4),
                "ds": Q.df_tables(ds_tables, conf, batch_rows=1 << 19,
                                  device="cuda", partitions=4),
                "ds_shuffled": Q.df_tables(ds_tables, shuffled,
                                           batch_rows=1 << 19,
                                           device="cuda", partitions=4)}

    frames = four()
    h = {"one": tpch.df_tables(tpch_tables, batch_rows=1 << 20,
                               device="cuda", shuffle_partitions=1),
         "four": frames["h"]}
    ds = {"one": Q.df_tables(ds_tables, batch_rows=1 << 19, device="cuda",
                             shuffle_partitions=1),
          "four": frames["ds"]}
    ds_shuffled = dict(ds, four=frames["ds_shuffled"])
    cases = ([(f"tpch_{q}", tpch.DF_QUERIES[q], h,
               lambda g, e, q=q: tpch_check(q, g, e), q in ("q3", "q5"),
               False) for q in ("q1", "q3", "q5", "q6")]
             + [(q, Q.QUERIES[q], ds,
                 lambda g, e, q=q: Q.check_rows(q, g, e), True,
                 q in PARTITIONED_WINDOWS) for q in PARTITIONED_DS]
             + [("q38_shuffled_joins", Q.QUERIES["q38"], ds_shuffled,
                 lambda g, e: Q.check_rows("q38", g, e), True, False)]
             + [("order_by_ss_net_paid", sorted_store_sales, ds, None,
                 False, False)])
    frame_of = {id(h): "h", id(ds): "ds", id(ds_shuffled): "ds_shuffled"}

    # every probe and segmented-scan call of the counted runs is held
    # against the plain version (which launches no kernel, so the counts
    # stay the kernels' own)
    largest = {}
    probe_calls = [0]
    scan_calls = {"add": 0, "min": 0, "max": 0}
    real_probe = K.probe_hash_table_kernel
    real_scan = K.segmented_scan_kernel
    check_probe_call = checking_probe(real_probe, probe_calls)
    check_scan_call = checking_scan(real_scan, scan_calls)

    def recording_probe(tbl, h1, h2, capacity, seed, max_probes):
        size = (capacity, h1.numel())
        if size > largest.get("size", (-1, -1)):
            largest.update(size=size, args=(tbl, h1, h2, capacity, seed))
        return check_probe_call(tbl, h1, h2, capacity, seed, max_probes)

    # the CPU engine's results come from worker processes started first,
    # over the tables written as Arrow files
    t1 = time.perf_counter()
    tpch_dir = table_files(tpch_tables, list(tpch_tables))
    ds_dir = table_files(ds_tables, sorted(
        {"store_sales"} | {t for q in PARTITIONED_DS
                           for t in query_tables(q)}))
    log(f"partitioned: tables written for the check workers in "
        f"{time.perf_counter() - t1:.2f}s")
    pool = check_workers()
    pending = {}
    for name, _b, d, check, _j, _w in cases:
        kind = ("tpch" if d is h else "sort" if check is None else "tpcds")
        pending[name] = pool.apply_async(cpu_engine_table, (
            kind, name[len("tpch_"):] if kind == "tpch" else name,
            tpch_dir if kind == "tpch" else ds_dir))
    results, rows, outs = {}, {}, {}
    total = {k: 0 for k in K.KERNEL_LAUNCHES}
    for name, build, d, check, joins, window in cases:
        t1 = time.perf_counter()
        exp = execute_to_arrow(build(d["one"]).physical_plan())
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t1
        df = build(d["four"])
        cpu_marks = [ln.strip() for ln in df.explain("ALL").splitlines()
                     if ln.lstrip().startswith("!")]
        if cpu_marks:
            raise AssertionError(f"{name} partitioned has nodes on the "
                                 f"CPU engine: {cpu_marks}")
        K.reset_kernel_launches()
        R.reset_counters()
        PP.STATS.reset()
        K.probe_hash_table_kernel = recording_probe
        K.segmented_scan_kernel = check_scan_call
        try:
            t1 = time.perf_counter()
            plan = counted_plan(df)
            out = execute_to_arrow(plan)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t1
        finally:
            K.probe_hash_table_kernel = real_probe
            K.segmented_scan_kernel = real_scan
        launches = dict(K.KERNEL_LAUNCHES)
        for k, v in launches.items():
            total[k] += v
        strategy = plan_strategy(plan)
        strategy["bytes_saved"] = R.counters()[
            "reuse_bytes_saved_total"]
        if check is None:
            if out.num_rows != ds_tables["store_sales"].num_rows:
                raise AssertionError(f"{name} gave {out.num_rows} rows")
            if not same_sorted_rows(out, exp):
                raise AssertionError(f"{name} partitioned differs from "
                                     f"one partition")
        else:
            got = out.to_pylist()
            # rows equal to an empty result prove nothing of the
            # exchanges
            if not Q.informative(got):
                raise AssertionError(f"{name} shows no value: "
                                     f"{got[:3]}")
            ok, why = check(got, exp.to_pylist())
            if not ok:
                raise AssertionError(f"{name} partitioned differs from "
                                     f"one partition ({why}):\n"
                                     f"{got[:3]}")
        if not strategy["exchanges"] and not strategy["broadcast_joins"]:
            raise AssertionError(f"{name} planned no exchange and no "
                                 f"broadcast join")
        if (name == "q38_shuffled_joins"
                and strategy["shuffled_joins"] < 2):
            raise AssertionError(f"{name} shuffled "
                                 f"{strategy['shuffled_joins']} joins, "
                                 f"not its two semi joins")
        if joins and launches["hashtbl_probe"] <= 0:
            raise AssertionError(f"{name} launched no probe kernel")
        if window and launches["segscan"] <= 0:
            raise AssertionError(f"{name} launched no segscan kernel")
        results[name] = dict(strategy, rows=out.num_rows,
                             first_s=first_s,
                             one_partition_first_s=one_s,
                             launches=launches)
        rows[name] = outs[name] = out
        log(f"{name}: {out.num_rows} rows, 4 splits equal one "
            f"partition; {strategy_line(strategy)}; launches "
            f"{launches}; first run {first_s:.3f}s")
    # the CPU engine's results, from the workers
    t1 = time.perf_counter()
    for name, _b, _d, check, _j, _w in cases:
        path, cpu_s = pending[name].get(timeout=900)
        on_cpu = read_cpu_table(path)
        out = outs[name]
        if check is None:
            ok, why = same_sorted_rows(out, on_cpu), "rows differ"
        else:
            ok, why = check(out.to_pylist(), on_cpu.to_pylist())
        if not ok:
            raise AssertionError(f"{name} partitioned differs from the "
                                 f"CPU engine ({why})")
        results[name]["cpu_engine_s"] = cpu_s
    log(f"partitioned: every case equals the CPU engine's rows; waited "
        f"{time.perf_counter() - t1:.2f}s for the workers")
    log(f"probe: all {probe_calls[0]} calls and segscan: all "
        f"{sum(scan_calls.values())} calls ({scan_calls}) of the "
        f"partitioned path equal the plain version")
    for name, build, d, _c, _j, _w in cases:
        r = results[name]
        # the counted run and the one-partition run are the first of
        # their three (room for phase 21)
        r["warm_s"] = _warm_wall(lambda: build(d["four"]).to_arrow(),
                                 first=r["first_s"])
        r["one_partition_warm_s"] = _warm_wall(
            lambda: build(d["one"]).to_arrow(),
            first=r["one_partition_first_s"])
        log(f"{name}: warm wall {r['warm_s']:.4f}s partitioned, "
            f"{r['one_partition_warm_s']:.4f}s in one partition (medians "
            f"of 3)")
    return {"queries": results, "launches": total,
            "probe_calls_checked": probe_calls[0],
            "segscan_calls_checked": scan_calls,
            "largest_table_probe": largest.get("args"),
            # for phase 14: each case's query, frame and check, the frames
            # under another conf, and the rows
            "cases": [(name, build, frame_of[id(d)], check)
                      for name, build, d, check, _j, _w in cases],
            "four": four, "frames": frames, "rows": rows}


# phase 14: the three switches off give the plan shape without them
SWITCHES_OFF = {"spark.rapids.gpu.sql.adaptive.enabled": "false",
                "spark.rapids.gpu.sql.exchange.reuse.enabled": "false",
                "spark.rapids.gpu.sql.prefetch.enabled": "false"}
# the queries whose walls with the switches off are reported: q2 and q75
# (phases 10-11) and TPC-H Q3 (phase 13), each its checked run's (Q5's
# off walls, 22 s of repeats, were cut with phase 16's arrival, the
# repeats of these with phase 21's, to keep the whole run near 650 s)
SWITCHES_OFF_WALLS = ("q2", "q75", "tpch_q3")
# the queries whose warm walls run with prefetch alone off (the read-ahead
# and the prefetch boundaries; AQE and reuse on): Q3, a phase 13 case
# whose AQE readers read several specs
PREFETCH_OFF_WALLS = ("tpch_q3",)
# phase 14's reuse queries at SF ``--sf-ds`` with 4 source splits: q2 and
# q75 read one exchange twice; q4 and q11 total each channel and year on
# its own (no exchange repeats, as in the reference's plans) and repeat
# their broadcast builds (q74, whose plan is q11's with other columns,
# was cut with phase 21's arrival)
REUSE_QUERIES = ("q2", "q4", "q11", "q75")
REUSED_EXCHANGE_QUERIES = ("q2", "q75")
# the skewed shuffled join: 2^24 fact rows in 4 splits of 2^22, 60% of
# them on one key, the rest uniform over 2^20 keys (the even ones in the
# dimension's 2^20 keys, 0, 2, ..., 2^21 - 2, the hot key among them)
SKEW_FACT_ROWS = 1 << 24
SKEW_BATCH_ROWS = 1 << 22
SKEW_KEYS = 1 << 20
SKEW_HOT_KEY = 1 << 19
SKEW_CONF = {"spark.rapids.gpu.sql.join.broadcastRowThreshold": 0,
             "spark.rapids.gpu.sql.adaptive.skewJoin."
             "skewedPartitionThresholdBytes": 64 << 20}
SKEW_JOINS = ("inner", "left", "left_semi")
# the skewed joins whose walls are medians of 3; the others report their
# checked runs' walls (repeats cut with phase 21's arrival)
SKEW_WALL_JOINS = ("inner",)


def same_rows_as(name, check, got, exp) -> None:
    """Phase 14's row check of a switched-off run against the default
    run: the query's own check (ORDER BY order, rel 1e-6 on doubles), the
    sort's key order and multiset."""
    if check is None:
        ok, why = same_sorted_rows(got, exp), "rows differ"
    else:
        ok, why = check(got.to_pylist(), exp if isinstance(exp, list)
                        else exp.to_pylist())
    if not ok:
        raise AssertionError(f"{name} with AQE, reuse and prefetch off "
                             f"differs from the defaults ({why})")


def skewed_tables(seed: int = 0):
    """The skewed join's fact and dimension tables, from ``seed``."""
    import numpy as np
    import pyarrow as pa

    rng = np.random.default_rng(seed)
    n = SKEW_FACT_ROWS
    keys = rng.integers(0, SKEW_KEYS, n)
    keys[rng.random(n) < 0.6] = SKEW_HOT_KEY
    facts = pa.table({"fk": keys,
                      "fv": rng.integers(-10**9, 10**9, n),
                      "fx": rng.normal(0, 1, n)})
    dims = pa.table({"dk": np.arange(SKEW_KEYS, dtype=np.int64) * 2,
                     "dv": rng.integers(0, 1000, SKEW_KEYS)})
    return facts, dims


def sorted_on_card(table):
    """A result's columns on the card, its rows sorted by every column
    (validity, then value, column by column): a multiset's one order."""
    import torch

    cols = []
    for name in table.column_names:
        arr = table.column(name).combine_chunks()
        valid = torch.tensor(arr.is_valid().to_numpy(zero_copy_only=False),
                             device="cuda")
        vals = torch.tensor(arr.fill_null(0).to_numpy(zero_copy_only=False),
                            device="cuda")
        cols += [valid, vals]
    perm = torch.arange(table.num_rows, device="cuda")
    for key in reversed(cols):
        perm = perm[torch.sort(key[perm], stable=True).indices]
    return [c[perm] for c in cols]


def skewed_join_case(facts, dims, how, probe_calls) -> dict:
    """Phase 14's skewed join ``how``: planned with skew-split specs on
    the fact side, every probe call held against the plain version, rows
    equal to AQE off as multisets sorted on the card, the row count equal
    to numpy's; walls on and off (warm medians of 3 for the joins of
    ``SKEW_WALL_JOINS``, the checked runs' for the others)."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import kernels as K
    from spark_rapids_tpu_torch.plan import from_arrow
    from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow
    from spark_rapids_tpu_torch.shuffle import aqe as A

    def query(extra=None):
        conf = RapidsConf(dict(SKEW_CONF, **(extra or {})))
        f = from_arrow(facts, conf, batch_rows=SKEW_BATCH_ROWS,
                       device="cuda", partitions=4)
        d = from_arrow(dims, conf, batch_rows=SKEW_BATCH_ROWS, device="cuda")
        return f.join(d, left_on="fk", right_on="dk", how=how)

    off = {"spark.rapids.gpu.sql.adaptive.enabled": "false"}
    runs = {}
    real_probe = K.probe_hash_table_kernel
    query().physical_plan()  # uploads the tables: every run below is warm
    for name, extra in (("on", None), ("off", off)):
        K.reset_kernel_launches()
        K.probe_hash_table_kernel = checking_probe(real_probe, probe_calls)
        try:
            t1 = time.perf_counter()
            plan = counted_plan(query(extra))
            out = execute_to_arrow(plan)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t1
        finally:
            K.probe_hash_table_kernel = real_probe
        runs[name] = {"plan": plan, "out": out, "first_s": first_s,
                      "launches": dict(K.KERNEL_LAUNCHES)}
        if K.KERNEL_LAUNCHES["hashtbl_probe"] <= 0:
            raise AssertionError(f"skewed {how} join ({name}) launched no "
                                 f"probe kernel")
    readers = [n for n in _walk_plan(runs["on"]["plan"])
               if isinstance(n, A.SkewAwareShuffleReadExec)]
    if len(readers) != 2:
        raise AssertionError(f"skewed {how} join has {len(readers)} "
                             f"skew-aware readers")
    lspecs, rspecs = readers[0].specs(), readers[1].specs()
    if len(lspecs) != len(rspecs):
        raise AssertionError(f"skewed {how} join's readers have "
                             f"{len(lspecs)} and {len(rspecs)} specs")
    for ls, rs in zip(lspecs, rspecs):
        coalesced = (isinstance(ls, A.CoalescedPartitionSpec),
                     isinstance(rs, A.CoalescedPartitionSpec))
        if coalesced == (True, True):
            if ls != rs:
                raise AssertionError(f"unpaired specs {ls} {rs}")
        elif True in coalesced or ls.reducer != rs.reducer:
            raise AssertionError(f"unpaired specs {ls} {rs}")
    split = sum(isinstance(sp, A.PartialReducerPartitionSpec)
                for sp in lspecs)
    if not split:
        raise AssertionError(f"skewed {how} join planned no skew split: "
                             f"{[sp.describe() for sp in lspecs]}")
    keys = facts.column("fk").to_numpy()
    want = (len(keys) if how == "left"
            else int(np.count_nonzero(keys % 2 == 0)))
    on, off_out = runs["on"]["out"], runs["off"]["out"]
    if on.num_rows != want or off_out.num_rows != want:
        raise AssertionError(f"skewed {how} join gave {on.num_rows} rows "
                             f"(AQE off {off_out.num_rows}), numpy {want}")
    a, b = sorted_on_card(on), sorted_on_card(off_out)
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"skewed {how} join differs from AQE off")
    del a, b
    # each checked run (its probe calls also run the plain version, a few
    # ms in all) is the first of three warm runs, or, for the joins not in
    # SKEW_WALL_JOINS, the only wall: a checked-run wall, not a warm one
    if how in SKEW_WALL_JOINS:
        walls = {name: _warm_wall(
            lambda extra=extra: query(extra).to_arrow(), 3,
            first=runs[name]["first_s"])
            for name, extra in (("on", None), ("off", off))}
        wall_key, wall_what, wall_of = "warm_s", "warm wall", "medians of 3"
    else:
        walls = {name: r["first_s"] for name, r in runs.items()}
        wall_key, wall_what, wall_of = ("checked_s", "checked-run wall",
                                        "one run each")
    lsizes, rsizes = readers[0].planner.sizes
    res = {"rows": want, "left_specs": [sp.describe() for sp in lspecs],
           "right_specs": [sp.describe() for sp in rspecs],
           "left_sizes": lsizes, "right_sizes": rsizes,
           "skew_split_specs": split,
           "first_s": {k: v["first_s"] for k, v in runs.items()},
           "launches": {k: v["launches"] for k, v in runs.items()},
           wall_key: walls}
    log(f"skewed {how} join: {want} rows, equal to AQE off and numpy; "
        f"reduce partitions {lsizes} B (facts), {rsizes} B (dimension); "
        f"left specs {res['left_specs']}, right specs "
        f"{res['right_specs']}; probe launches on "
        f"{res['launches']['on']['hashtbl_probe']} off "
        f"{res['launches']['off']['hashtbl_probe']}; {wall_what} on "
        f"{walls['on']:.4f}s off {walls['off']:.4f}s ({wall_of})")
    return res


def _walk_plan(node):
    yield node
    for c in node.children:
        yield from _walk_plan(c)


class MemoLog:
    """The plan memo's hits, misses, uncacheable plans and evictions since
    the previous mark, logged and kept by phase."""

    def __init__(self):
        from spark_rapids_tpu_torch.plan import plan_cache

        self._memo = plan_cache
        self._last = plan_cache.counters()
        self.by_phase = {}

    def mark(self, phase: str) -> None:
        now = self._memo.counters()
        d = {k[len("plan_cache_"):-len("_total")]: now[k] - self._last[k]
             for k in now if k.endswith("_total")}
        self._last = now
        self.by_phase[phase] = d
        log(f"plan memo, {phase}: {d['hit']} hits, {d['miss']} misses, "
            f"{d['uncacheable']} uncacheable, {d['evict']} evictions")


def fresh_plan(df):
    """``df``'s physical plan built afresh (the plan memo's key false): a
    run of it allocates, pins and spills all that a first run does, its
    range exchanges' planning samples included, which a served tree took
    at its own planning."""
    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.plan.overrides import Overrides

    conf = RapidsConf(dict(df.conf._values if df.conf is not None else {},
                           **{"spark.rapids.gpu.plan.cache.enabled": False}))
    return Overrides(conf, df.shuffle_partitions).apply(df.plan)


def counted_plan(df):
    """``df``'s physical plan for a counted run. The plan memo is on, as
    at the port's defaults; a tree it serves adds each run to its
    metrics, so a served tree's metrics are set to 0 first and then count
    this run alone (the difference from a snapshot taken just before
    it). A served tree builds its broadcasts again (it dropped them when
    its last run ended), so its kernel launches are a first run's. A tree
    planned now holds what its planning did (a range exchange's sample),
    as before the memo."""
    from spark_rapids_tpu_torch.plan import plan_cache

    hits = plan_cache.counters()["plan_cache_hit_total"]
    plan = df.physical_plan()
    if plan_cache.counters()["plan_cache_hit_total"] > hits:
        for n in _walk_plan(plan):
            for m in n.metrics.values():
                m.value = 0
    return plan


def run_adaptive_path(ds_tables, slices, part_res) -> dict:
    """Phase 14: every query of phases 10-11 that plans an exchange and
    every case of phase 13 once with AQE, reuse and prefetch off, its rows
    equal to the defaults', with its AQE specs, reuse and probe launches
    on and off; q2/q75/Q3's checked runs' walls off beside the defaults'
    warm walls, and Q3's with prefetch alone off; q2, q4, q11 and q75
    with 4 splits, reuse on against off; the skewed shuffled join. Every
    kernel call of the counted runs is held against its plain version."""
    import torch

    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import kernels as K
    from spark_rapids_tpu_torch.exec import pipeline as PP
    from spark_rapids_tpu_torch.exec import reuse as R
    from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow

    total = {k: 0 for k in K.KERNEL_LAUNCHES}
    results = {}
    # every probe and segmented-scan call of the counted runs is held
    # against the plain version (which launches no kernel)
    probe_calls = [0]
    scan_calls = {"add": 0, "min": 0, "max": 0}
    real_probe = K.probe_hash_table_kernel
    real_scan = K.segmented_scan_kernel
    check_probe_call = checking_probe(real_probe, probe_calls)
    check_scan_call = checking_scan(real_scan, scan_calls)

    def counted(build):
        """One run of ``build()``'s plan, launches and reuse counted and
        every kernel call checked, and its wall."""
        K.reset_kernel_launches()
        R.reset_counters()
        PP.STATS.reset()
        K.probe_hash_table_kernel = check_probe_call
        K.segmented_scan_kernel = check_scan_call
        try:
            t1 = time.perf_counter()
            plan = counted_plan(build())
            out = execute_to_arrow(plan)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        finally:
            K.probe_hash_table_kernel = real_probe
            K.segmented_scan_kernel = real_scan
        launches = dict(K.KERNEL_LAUNCHES)
        for k, v in launches.items():
            total[k] += v
        strategy = plan_strategy(plan)
        strategy["bytes_saved"] = R.counters()["reuse_bytes_saved_total"]
        strategy["wall_s"] = wall
        return out, launches, strategy

    # 1. every query that plans an exchange, switches off against on
    off_one = Q.df_tables(ds_tables, RapidsConf(SWITCHES_OFF),
                          batch_rows=1 << 22, device="cuda")
    walls_off = {}
    for slice_res, slice_rows in slices:
        for q, r in slice_res["queries"].items():
            # the slices' extra checks (q76 with null keys, q24's
            # threshold) have no plan of their own here
            st = r.get("strategy")
            if st is None or not (st["exchanges"]
                                  or st["reused_exchanges"]):
                continue
            out, launches, off_st = counted(lambda q=q: Q.QUERIES[q](off_one))
            same_rows_as(q, lambda g, e, q=q: Q.check_rows(q, g, e), out,
                         slice_rows[q])
            results[q] = {"on": st, "off": off_st,
                          "probe_on": r["launches"]["hashtbl_probe"],
                          "probe_off": launches["hashtbl_probe"],
                          "warm_s_on": r["warm_s"]}
            if q in SWITCHES_OFF_WALLS:
                walls_off[q] = off_st["wall_s"]
    off_four = part_res["four"](SWITCHES_OFF)
    for name, build, frame, check in part_res["cases"]:
        out, launches, off_st = counted(
            lambda build=build, frame=frame: build(off_four[frame]))
        same_rows_as(name, check, out, part_res["rows"][name])
        r = part_res["queries"][name]
        results[name] = {"on": {k: r[k] for k in (
            "exchanges", "aqe_readers", "coalesced_specs", "skew_split_specs",
            "reused_exchanges", "reused_broadcasts", "bytes_saved",
            "prefetch")}, "off": off_st,
            "probe_on": r["launches"]["hashtbl_probe"],
            "probe_off": launches["hashtbl_probe"], "warm_s_on": r["warm_s"]}
        if name in SWITCHES_OFF_WALLS:
            walls_off[name] = off_st["wall_s"]
    for name, r in results.items():
        on = r["on"]
        log(f"{name}: AQE, reuse and prefetch off equal the defaults; AQE "
            f"{on['aqe_readers']}; reused {on['reused_exchanges']} "
            f"exchanges {on['reused_broadcasts']} broadcasts, "
            f"{on['bytes_saved']} B saved; probe launches on "
            f"{r['probe_on']} off {r['probe_off']}; exchanges on "
            f"{on['exchanges']} off {r['off']['exchanges']}")
    # off, the wall is the checked run's alone: the first run under the
    # off settings, its kernel calls also running the plain version; not
    # like for like with the warm medians at the defaults
    for name, w in walls_off.items():
        results[name]["checked_s_off"] = w
        log(f"{name}: warm wall {results[name]['warm_s_on']:.4f}s at the "
            f"defaults (median of 3); checked-run wall {w:.4f}s with AQE, "
            f"reuse and prefetch off (one run, probes checked)")
    missing = set(SWITCHES_OFF_WALLS) - set(walls_off)
    if missing:
        raise AssertionError(f"{sorted(missing)} planned no exchange")
    # the read-ahead alone: prefetch off, AQE and reuse on
    pf_off = part_res["four"]({"spark.rapids.gpu.sql.prefetch.enabled":
                               "false"})
    for name, build, frame, check in part_res["cases"]:
        if name not in PREFETCH_OFF_WALLS:
            continue
        out, _l, st = counted(
            lambda build=build, frame=frame: build(pf_off[frame]))
        same_rows_as(name, check, out, part_res["rows"][name])
        r = results[name]
        r["prefetch_off"] = st
        # its checked run's wall alone (the two repeats were cut with
        # phase 17's arrival)
        r["checked_s_prefetch_off"] = st["wall_s"]
        log(f"{name}: warm wall {r['warm_s_on']:.4f}s at the defaults "
            f"(median of 3); checked-run wall "
            f"{r['checked_s_prefetch_off']:.4f}s with prefetch off (one "
            f"run, probes checked); read {st['read_ms']:.1f} ms off against "
            f"{part_res['queries'][name]['read_ms']:.1f} ms (of it "
            f"{part_res['queries'][name]['read_ahead_wait_ms']:.1f} ms "
            f"waiting for a read-ahead) at the defaults")

    # 2. reuse with 4 source splits, on against off
    reuse = {}
    four = {name: Q.df_tables(ds_tables, RapidsConf(extra),
                              batch_rows=1 << 19, device="cuda",
                              partitions=4)
            for name, extra in (("on", {}), ("off", {
                "spark.rapids.gpu.sql.exchange.reuse.enabled": "false"}))}
    for q in REUSE_QUERIES:
        on, on_launches, on_st = counted(lambda q=q: Q.QUERIES[q](four["on"]))
        off, _l, off_st = counted(lambda q=q: Q.QUERIES[q](four["off"]))
        same_rows_as(q, lambda g, e, q=q: Q.check_rows(q, g, e), off, on)
        if not Q.informative(on.to_pylist()):
            raise AssertionError(f"{q} with 4 splits shows no value")
        if q in REUSED_EXCHANGE_QUERIES and on_st["reused_exchanges"] < 1:
            raise AssertionError(f"{q} with 4 splits reused no exchange")
        if on_st["reused_exchanges"] + on_st["reused_broadcasts"] < 1:
            raise AssertionError(f"{q} with 4 splits reused nothing")
        if off_st["reused_exchanges"] or off_st["reused_broadcasts"]:
            raise AssertionError(f"{q} reused with reuse off")
        reuse[q] = {k: on_st[k] for k in (
            "reused_exchanges", "reused_broadcasts", "bytes_saved",
            "exchanges", "aqe_readers")}
        reuse[q]["probe_launches"] = on_launches["hashtbl_probe"]
        log(f"{q} with 4 splits: reuse on equals off; "
            f"{strategy_line(on_st)}")

    # 3. the skewed shuffled join
    facts, dims = skewed_tables(0)
    skew = {}
    for how in SKEW_JOINS:
        skew[how] = skewed_join_case(facts, dims, how, probe_calls)
        for k in total:
            total[k] += sum(skew[how]["launches"][r][k]
                            for r in ("on", "off"))
    del facts, dims
    torch.cuda.empty_cache()
    # a wrapper counts a launch only where it launches, so every counted
    # launch of the phase lies in a checked call
    if (probe_calls[0] < total["hashtbl_probe"]
            or sum(scan_calls.values()) < total["segscan"]):
        raise AssertionError(f"phase 14 checked {probe_calls[0]} probe and "
                             f"{scan_calls} segscan calls for {total} "
                             f"launches")
    log(f"probe: all {probe_calls[0]} calls and segscan: all "
        f"{sum(scan_calls.values())} calls ({scan_calls}) of phase 14 equal "
        f"the plain version ({total} launches)")
    return {"queries": results, "reuse_four_splits": reuse,
            "skewed_join": skew, "launches": total,
            "probe_calls_checked": probe_calls[0],
            "segscan_calls_checked": scan_calls}


# ---------------------------------------------------------------------------
# phase 15: the memory path
# ---------------------------------------------------------------------------

# a case's capped pool is the least that its uncapped run shows every
# handle and every set of handles an operator pins at once to fit in:
# the larger of the largest handle and the most bytes pinned at once, so
# no registration splits and whatever spills is state that outgrew the
# pool. Its host tier and the aggregate's repartition target are a
# sixteenth of the cap (the default target, a quarter, repartitions no
# partition of q67)
CAP_FRACTION = 16
# (Q5 was cut with phase 17's arrival: like Q3 it spills nothing, its
# largest handle being its high-water mark, and its two runs took 10 s)
CAPPED_CASES = ("tpch_q3", "q67", "running_global_window")
WINDOW_CASE = "running_global_window"
# the capped window's merged batches: each one reads a slice of every run,
# and under the cap the combined run and the others trade places, so
# 2^20-row batches (14, not 109 at 2^17) keep that traffic in bounds
CAPPED_WINDOW_TARGET_ROWS = 1 << 20
STREAM_BATCH_ROWS = 1 << 17  # 22 runs of store_sales at SF1
SEMAPHORE_RUNS = 2  # runs of Q1 and of Q6 on each of the two threads


class MemoryChecks:
    """After every query (``execute_to_arrow``, ``DataFrame.to_arrow``):
    the pool's used bytes are 0, ``cleaner.sweep()`` finds nothing and
    the spill directories hold no file. With queries in flight on other
    threads the check waits for the last one."""

    def __init__(self):
        self.checked = 0
        self._in_flight = 0
        self._lock = threading.Lock()

    def install(self) -> None:
        from spark_rapids_tpu_torch.plan import dataframe as DF

        real = DF.execute_to_arrow

        def checked(node):
            with self._lock:
                self._in_flight += 1
            try:
                out = real(node)
            finally:
                with self._lock:
                    self._in_flight -= 1
                    last = self._in_flight == 0
            if last:
                self.check()
            return out

        DF.execute_to_arrow = checked

    def check(self) -> None:
        from spark_rapids_tpu_torch.mem import cleaner
        from spark_rapids_tpu_torch.mem.pool import get_pool

        used = get_pool().used
        leaks = cleaner.sweep()
        files = [os.path.join(fw.spill_dir, f) for fw in cleaner.frameworks()
                 if os.path.isdir(fw.spill_dir)
                 for f in os.listdir(fw.spill_dir)]
        if used or leaks or files:
            raise AssertionError(f"after a query: pool used {used} B, leaks "
                                 f"{leaks}, spill files {files}")
        with self._lock:
            self.checked += 1


def run_memory_path(ds_tables, part_res) -> dict:
    """Phase 15: (a) streaming windows over store_sales against streaming
    off; (b) phase 13's Q3 and q67 under a capped
    pool against their uncapped rows, with spill counters, walls and peak
    device memory both ways; (c) the capped q67 with injected OOMs; (d)
    Q1 and Q6 on two threads at 1 and 2 task permits. Every probe and
    segmented-scan call of the counted runs is held against its plain
    version."""
    import torch

    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.config import conf as C
    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import aggregate as AGG
    from spark_rapids_tpu_torch.exec import kernels as K
    from spark_rapids_tpu_torch.exec import pipeline as PP
    from spark_rapids_tpu_torch.mem import pool as MP
    from spark_rapids_tpu_torch.mem import retry as MR
    from spark_rapids_tpu_torch.mem import semaphore as MS
    from spark_rapids_tpu_torch.mem import spill as MSP
    from spark_rapids_tpu_torch.plan import from_arrow
    from spark_rapids_tpu_torch.plan import dataframe as DF

    t_phase = time.perf_counter()
    total = {k: 0 for k in K.KERNEL_LAUNCHES}
    probe_calls = [0]
    scan_calls = {"add": 0, "min": 0, "max": 0}
    real_probe = K.probe_hash_table_kernel
    real_scan = K.segmented_scan_kernel
    check_probe_call = checking_probe(real_probe, probe_calls)
    check_scan_call = checking_scan(real_scan, scan_calls)

    def counted(df, peak=False):
        """(rows, wall, launches, peak bytes above the start or None,
        plan) of one planning and run of ``df`` (planning may run a range
        sort's sample, and with it the exchanges below), every kernel
        call checked. It is planned afresh (``fresh_plan``): the largest
        handle, the pinned sets and the peak that size the capped pool
        are a first run's."""
        torch.cuda.synchronize()
        if peak:
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        K.reset_kernel_launches()
        K.probe_hash_table_kernel = check_probe_call
        K.segmented_scan_kernel = check_scan_call
        try:
            t1 = time.perf_counter()
            plan = fresh_plan(df)
            out = DF.execute_to_arrow(plan)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        finally:
            K.probe_hash_table_kernel = real_probe
            K.segmented_scan_kernel = real_scan
        launches = dict(K.KERNEL_LAUNCHES)
        for k, v in launches.items():
            total[k] += v
        above = (torch.cuda.max_memory_allocated() - base) if peak else None
        return out, wall, launches, above, plan

    # (a) streaming windows over store_sales, on against off and the CPU
    ss = ds_tables["store_sales"]
    off_conf = {"spark.rapids.gpu.sql.window.streaming.enabled": "false"}
    on_df = from_arrow(ss, batch_rows=STREAM_BATCH_ROWS, device="cuda")
    off_df = from_arrow(ss, RapidsConf(off_conf),
                        batch_rows=STREAM_BATCH_ROWS, device="cuda")
    windows = {}
    for name, exprs in Q.streaming_windows().items():
        ws = [w for _a, w in exprs]
        got, on_s, on_launch, _, on_plan = counted(on_df.with_window(*ws))
        win = on_plan
        while type(win).__name__ != "WindowExec":
            win = win.children[0]
        srt = win.children[0]
        mode = name.split("_")[0]
        if win._mode is None or win._mode[0] != mode or not getattr(
                srt, "out_of_core", False):
            raise AssertionError(f"the {name} window does not stream over "
                                 f"an out-of-core sort:\n{on_plan.explain()}")
        exp, off_s, off_launch, _, _ = counted(off_df.with_window(*ws))
        # (held against streaming off on the card; the CPU engine's runs,
        # 9.2 s of the host's CPU, were cut with phase 18's arrival: the
        # CPU tests hold both engines' windows)
        for col in list(got.column_names):
            if not _columns_agree(got.column(col), exp.column(col)):
                raise AssertionError(f"the {name} streaming window's "
                                     f"{col} differs from streaming off")
        if on_launch["segscan"] <= 0:
            raise AssertionError(f"the {name} streaming window launched no "
                                 f"segscan")
        rec = {"rows": got.num_rows,
               "runs": srt.metrics["sortRuns"].value,
               "premerges": srt.metrics["sortPremerges"].value,
               "merged_batches": srt.metrics["sortMergeBatches"].value,
               "batches_streamed": win.metrics["streamedBatches"].value,
               "first_s": on_s, "off_first_s": off_s,
               "launches": on_launch,
               "off_launches": off_launch}
        if rec["runs"] <= C.SORT_OOC_MAX_MERGE_RUNS.default \
                or rec["premerges"] < 1:
            raise AssertionError(f"the {name} window's sort pre-merged "
                                 f"nothing: {rec}")
        if not win._part_bound and rec["batches_streamed"] < 2:
            # one partition over every batch: the carry must continue
            raise AssertionError(f"the {name} window streamed "
                                 f"{rec['batches_streamed']} batch(es)")
        # one warm run each (the checked runs compare every scan call
        # with its plain version, so they time more than the window; the
        # phase's repeats are cut to keep the whole run near 650 s)
        rec["warm_s"] = _warm_wall(lambda: DF.execute_to_arrow(
            on_df.with_window(*ws).physical_plan()), reps=1)
        rec["off_warm_s"] = _warm_wall(lambda: DF.execute_to_arrow(
            off_df.with_window(*ws).physical_plan()), reps=1)
        windows[name] = rec
        log(f"streaming {name} window over {got.num_rows} store_sales rows "
            f"in {STREAM_BATCH_ROWS}-row batches: equal to streaming off; "
            f"{rec['runs']} runs, {rec['premerges']} "
            f"pre-merge(s), {rec['merged_batches']} merged batches, "
            f"{rec['batches_streamed']} batches streamed; warm "
            f"{rec['warm_s']:.4f}s against {rec['off_warm_s']:.4f}s off "
            f"(one warm run each); launches {on_launch}")
    del on_df, off_df

    # (b) phase 13's Q3 and q67 uncapped, then under a capped pool
    cases = {name: (build, fkey, check)
             for name, build, fkey, check in part_res["cases"]}
    frames = part_res["frames"]
    rows13 = part_res["rows"]

    def same(name, out):
        build, fkey, check = cases[name]
        ok, why = check(out.to_pylist(), rows13[name].to_pylist())
        if not ok:
            raise AssertionError(f"{name} differs from phase 13 ({why})")

    def fresh_pool(conf=None):
        """A new pool and spill framework sized by ``conf`` (the defaults
        when None: the active conf is the last plan's, capped or not)."""
        conf = conf or RapidsConf()
        pool = MP.HbmPool(MP.pool_limit(conf))
        MP.set_pool(pool)
        MSP.SpillFramework(pool,
                           host_limit_bytes=C.HOST_SPILL_LIMIT.get(conf))
        return pool

    capped = {}
    tiers = {"to_host": 0, "to_disk": 0}
    global_window = [w for _a, w in Q.streaming_windows()["running_global"]]
    # the window's columns and the item: each spill moves what the sort
    # carries, not the 23 columns of store_sales
    narrow_ss = ss.select(["ss_sold_date_sk", "ss_ticket_number",
                           "ss_item_sk", "ss_quantity"])

    def case_df(name, settings=None):
        """The case's DataFrame, its plan under ``settings`` (phase 13's
        frames hold the defaults)."""
        if name == WINDOW_CASE:
            return from_arrow(narrow_ss, RapidsConf(dict(
                settings or {}, **{
                    "spark.rapids.gpu.sql.sort.outOfCore.targetRows":
                        CAPPED_WINDOW_TARGET_ROWS})),
                              batch_rows=STREAM_BATCH_ROWS,
                              device="cuda").with_window(*global_window)
        build, fkey, _check = cases[name]
        df = build(frames[fkey])
        df.conf = RapidsConf(settings or {})
        return df

    for name in CAPPED_CASES:
        pool = fresh_pool()
        out, wall, launches, peak, _ = counted(case_df(name), peak=True)
        if name == WINDOW_CASE:
            window_rows = out
        else:
            same(name, out)
        c0 = MSP.get_framework().counters()
        largest, pinned = c0["max_handle_bytes"], c0["max_pinned_bytes"]
        cap = max(largest, pinned)
        settings = {"spark.rapids.gpu.memory.pool.maxBytes": cap,
                    "spark.rapids.gpu.memory.host.spillStorageSize":
                        cap // CAP_FRACTION,
                    "spark.rapids.gpu.sql.agg.repartition.targetBytes":
                        cap // CAP_FRACTION}
        conf = RapidsConf(settings)
        rec = capped[name] = {
            "uncapped_wall_s": wall, "uncapped_launches": launches,
            "uncapped_peak_above_bytes": peak,
            "uncapped_largest_handle_bytes": largest,
            "uncapped_max_pinned_bytes": pinned,
            "uncapped_pool_max_used": pool.max_used,
            "pool_limit_uncapped": pool.limit, "cap_bytes": cap,
            "host_spill_bytes": cap // CAP_FRACTION,
            "repartition_target_bytes": cap // CAP_FRACTION,
            "settings": settings}
        if name != WINDOW_CASE:
            rec["phase13_warm_s"] = part_res["queries"][name]["warm_s"]
        log(f"{name} uncapped: largest handle {largest} B, at most {pinned} "
            f"B pinned and {pool.max_used} B accounted at once, peak {peak} "
            f"B above the tables, {wall:.3f}s; capped: memory.pool.maxBytes "
            f"{cap} B, memory.host.spillStorageSize and the repartition "
            f"target {cap // CAP_FRACTION} B")
        pool = fresh_pool(conf)
        fw = MSP.get_framework()
        PP.STATS.reset()
        MR.STATS.reset()
        s0 = AGG.repartition_snapshot()
        out, wall, launches, peak, plan = counted(case_df(name, settings),
                                                  peak=True)
        if name == WINDOW_CASE:
            if not out.equals(window_rows):
                raise AssertionError("the capped global window differs from "
                                     "its uncapped rows")
        else:
            same(name, out)
        c = fw.counters()
        splits = MR.STATS.snapshot()["splits"]
        if splits:
            raise AssertionError(f"{name} capped split {splits} "
                                 f"registration(s): a handle did not fit")
        depth = max([n.max_repartition_depth for n in _walk_plan(plan)
                     if hasattr(n, "max_repartition_depth")] or [0])
        rec.update(capped_wall_s=wall, capped_peak_above_bytes=peak,
                   capped_launches=launches, spill=c, splits=splits,
                   repartition_depth=depth,
                   repartitions=AGG.repartition_snapshot()["total"]
                   - s0["total"],
                   prefetch_sheds=PP.STATS.snapshot()["prefetch_sheds"],
                   pool_max_used=pool.max_used)
        tiers["to_host"] += c["spilled_to_host"]
        tiers["to_disk"] += c["spilled_to_disk"]
        log(f"{name} capped: rows equal uncapped; no split; spilled "
            f"{c['spilled_to_host']} x to host ({c['spilled_to_host_bytes']}"
            f" B), {c['spilled_to_disk']} x to disk "
            f"({c['spilled_to_disk_bytes']} B), {c['unspilled']} back "
            f"({c['unspilled_bytes']} B), {c['chunks_written']} chunks; "
            f"repartition depth {depth} ({rec['repartitions']} passes); "
            f"prefetch sheds {rec['prefetch_sheds']}; {wall:.3f}s against "
            f"{rec['uncapped_wall_s']:.3f}s uncapped; peak {peak} B against "
            f"{rec['uncapped_peak_above_bytes']} B uncapped")
    del window_rows, narrow_ss
    capped_conf = RapidsConf(capped["q67"]["settings"])
    if not (tiers["to_host"] and tiers["to_disk"]):
        raise AssertionError(f"the capped runs spilled {tiers}: nothing "
                             f"reached both tiers")
    if capped["q67"]["repartition_depth"] < 1:
        raise AssertionError("the capped q67's aggregate did not "
                             "repartition")

    # (c) the capped q67 with two injected RETRYs and one SPLIT
    pool = fresh_pool(capped_conf)
    me = threading.get_ident()
    injectors = [MP.OomInjector("RETRY", skip=2, count=2, thread_id=me),
                 MP.OomInjector("SPLIT", skip=1, count=1, thread_id=me)]

    class Chain:
        """The injectors in turn, each once its predecessor is spent."""

        def on_alloc(self):
            for inj in injectors:
                if inj.count > 0:
                    inj.on_alloc()
                    return

    pool.set_injector(Chain())
    MR.STATS.reset()
    out, wall, launches, _, _ = counted(case_df("q67",
                                                capped["q67"]["settings"]))
    pool.set_injector(None)
    same("q67", out)
    stats = MR.STATS.snapshot()
    MP.set_pool(None)
    C.set_active(None)
    injected = [i.injected for i in injectors]
    if injected != [2, 1] or stats["retries"] < 2 or stats["splits"] < 1:
        raise AssertionError(f"injected OOMs {injected}, retries and "
                             f"splits {stats}")
    oom = {"injected_retry": injected[0], "injected_split": injected[1],
           "retry_stats": stats, "wall_s": wall, "launches": launches}
    log(f"q67 capped with 2 injected RETRY and 1 SPLIT: rows equal phase "
        f"13; {stats['retries']} retries, {stats['splits']} splits")

    # (d) Q1 and Q6 on two threads at 1 and 2 task permits
    sem_res = {}
    for permits in (1, 2):
        fr = part_res["four"]({"spark.rapids.gpu.sql.concurrentGpuTasks":
                               permits})["h"]
        for q in ("q1", "q6"):  # uploads and serial rows
            same(f"tpch_{q}", DF.execute_to_arrow(tpch_plan(q, fr)))
        sem = MS.get_task_semaphore(RapidsConf(
            {"spark.rapids.gpu.sql.concurrentGpuTasks": permits}))
        sem.max_holders = 0
        w0 = sem.snapshot()["wait_count"]
        got, errors, samples = {}, [], []
        stop = threading.Event()

        def sample():
            while not stop.is_set():
                samples.append(len(sem.snapshot()["holders"]))
                time.sleep(0.0005)

        def run(q):
            # two runs a thread, so that the two overlap
            try:
                got[q] = [DF.execute_to_arrow(tpch_plan(q, fr))
                          for _ in range(SEMAPHORE_RUNS)]
            except BaseException as e:  # noqa: BLE001 - raised below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(q,))
                   for q in ("q1", "q6")]
        watcher = threading.Thread(target=sample)
        watcher.start()
        t1 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        stop.set()
        watcher.join()
        if errors:
            raise errors[0]
        for q in ("q1", "q6"):
            for out in got[q]:
                same(f"tpch_{q}", out)
        snap = sem.snapshot()
        waits = snap["wait_count"] - w0
        if snap["max_holders"] > permits or max(samples) > permits:
            raise AssertionError(f"{snap['max_holders']} holders at "
                                 f"{permits} permits")
        if permits == 1 and waits < 1:
            raise AssertionError("two threads at one permit never waited")
        sem_res[permits] = {"max_holders": snap["max_holders"],
                            "sampled_max_holders": max(samples),
                            "waits": waits, "wall_s": wall,
                            "total_wait_ns": snap["total_wait_ns"]}
        log(f"Q1 and Q6 on two threads at {permits} permit(s), "
            f"{SEMAPHORE_RUNS} runs a thread: rows equal the serial runs; "
            f"at most {snap['max_holders']} holders, {waits} waits; "
            f"{wall:.3f}s")
        del fr

    if total["hashtbl_probe"] <= 0 or total["segscan"] <= 0:
        raise AssertionError(f"phase 15 launched {total}: both kernels "
                             f"must launch")
    if (probe_calls[0] < total["hashtbl_probe"]
            or sum(scan_calls.values()) < total["segscan"]):
        raise AssertionError(f"phase 15 checked {probe_calls[0]} probe and "
                             f"{scan_calls} segscan calls for {total} "
                             f"launches")
    log(f"probe: all {probe_calls[0]} calls and segscan: all "
        f"{sum(scan_calls.values())} calls ({scan_calls}) of phase 15 equal "
        f"the plain version ({total} launches)")
    return {"windows": windows, "capped": capped, "injected": oom,
            "semaphore": sem_res, "launches": total,
            "probe_calls_checked": probe_calls[0],
            "segscan_calls_checked": scan_calls,
            "wall_s": time.perf_counter() - t_phase}


def run_typed_path(ds_tables) -> dict:
    """Phase 16: the typed store_sales pass (``bench/typed_sales.py``)."""
    import torch

    from spark_rapids_tpu_torch.bench import typed_sales as TS
    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import kernels as K
    from spark_rapids_tpu_torch.plan import dataframe as DF
    from spark_rapids_tpu_torch.plan.overrides import join_paths

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    tables = {"typed_store_sales": TS.typed_store_sales(ds_tables)}
    typed = tables["typed_store_sales"]
    n = typed.num_rows
    log(f"typed store_sales: {n} rows ({typed.schema.types}) in "
        f"{time.perf_counter() - t0:.2f}s")
    total = {k: 0 for k in K.KERNEL_LAUNCHES}
    probe_calls = [0]
    scan_calls = {"add": 0, "min": 0, "max": 0}
    real_probe = K.probe_hash_table_kernel
    real_scan = K.segmented_scan_kernel
    check_probe_call = checking_probe(real_probe, probe_calls)
    check_scan_call = checking_scan(real_scan, scan_calls)
    largest = {}

    def probe_and_record(tbl, h1, h2, capacity, seed, max_probes):
        if h1.numel() > largest.get("rows", -1):
            largest.update(rows=h1.numel(),
                           args=(tbl, h1, h2, capacity, seed))
        return check_probe_call(tbl, h1, h2, capacity, seed, max_probes)

    def counted(df):
        """(table, wall, launches, plan) of one planning and run of
        ``df`` with the counts zeroed before and read after, every kernel
        call held against its plain version."""
        torch.cuda.synchronize()
        K.reset_kernel_launches()
        K.probe_hash_table_kernel = probe_and_record
        K.segmented_scan_kernel = check_scan_call
        try:
            t1 = time.perf_counter()
            plan = counted_plan(df)
            out = DF.execute_to_arrow(plan)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        finally:
            K.probe_hash_table_kernel = real_probe
            K.segmented_scan_kernel = real_scan
        launches = dict(K.KERNEL_LAUNCHES)
        for k, v in launches.items():
            total[k] += v
        return out, wall, launches, plan

    def device_only(df, name):
        off = [ln.strip() for ln in df.explain("ALL").splitlines()
               if ln.lstrip().startswith("!")]
        if off:
            raise AssertionError(f"{name} places nodes on the CPU engine: "
                                 f"{off}")

    dev = TS.df_tables(tables, device="cuda")
    cpu = TS.df_tables(tables, RapidsConf(
        {"spark.rapids.gpu.sql.enabled": "false"}), device="cuda")
    res, rows = {}, {}
    for q, build in TS.QUERIES.items():
        df = build(dev)
        device_only(df, q)
        out, wall, launches, plan = counted(df)
        got = out.to_pylist()
        t1 = time.perf_counter()
        exp = build(cpu).to_arrow().to_pylist()
        cpu_s = time.perf_counter() - t1
        ok, why = TS.check_rows(q, got, exp)
        if not ok:
            raise AssertionError(f"{q} on the card differs from the CPU "
                                 f"engine ({why}):\n{got[:2]}\n{exp[:2]}")
        if q == "T1":
            ok, why = TS.check_rows(q, got, TS.pandas_t1(typed))
            if not ok:
                raise AssertionError(f"T1 differs from pandas ({why})")
        if q == "T3" and (launches["hashtbl_probe"] <= 0
                          or set(join_paths(plan)) != {"ht"}):
            raise AssertionError(f"T3 launched {launches} on join paths "
                                 f"{join_paths(plan)}")
        if q == "T4" and launches["segscan"] <= 0:
            raise AssertionError(f"T4 launched no segscan kernel")
        warm = _warm_wall(lambda b=build: b(dev).to_arrow(), 3, first=wall)
        rows[q] = got
        res[q] = {"rows": len(got), "first_s": wall, "warm_s": warm,
                  "cpu_engine_s": cpu_s, "launches": launches,
                  "probe_calls": launches["hashtbl_probe"],
                  "scan_calls": launches["segscan"],
                  "shown": [{k: str(v) for k, v in r.items()}
                            for r in got[:2]]}
        log(f"typed {q}: {len(got)} rows equal the CPU engine"
            f"{' and pandas' if q == 'T1' else ''}; launches {launches}; "
            f"warm wall {warm:.4f}s (median of 3); CPU engine {cpu_s:.3f}s;"
            f" first rows {res[q]['shown']}")

    # T3 on the sorted-hash path
    sh = TS.df_tables(tables, RapidsConf(
        {"spark.rapids.gpu.sql.join.hashTable.enabled": "false"}),
        device="cuda")
    out, wall, launches, plan = counted(TS.t3(sh))
    paths = join_paths(plan)
    ok, why = TS.check_rows("T3", out.to_pylist(), rows["T3"])
    if not ok or set(paths) != {"sorted"}:
        raise AssertionError(f"T3 on the sorted-hash path: {why}, paths "
                             f"{paths}")
    res["T3_sorted_hash"] = {"first_s": wall, "launches": launches,
                             "join_paths": paths}
    log(f"typed T3 on the sorted-hash path: rows equal; paths {paths}; "
        f"launches {launches}; {wall:.4f}s")

    # T5: 4 splits and 4 shuffle partitions against one partition
    # (the fast path, which plans one partition for small tables, off:
    # past 100,000 rows it is off anyway)
    four = TS.df_tables(tables, RapidsConf(
        {"spark.rapids.gpu.fastpath.enabled": "false"}), device="cuda",
        partitions=4, shuffle_partitions=4, batch_rows=-(-n // 4))
    one = TS.df_tables(tables, device="cuda", shuffle_partitions=1)
    for q in ("T1", "T3", "GLOBAL_SORT", "GLOBAL_SORT2"):
        build = TS.QUERIES.get(q) or TS.GLOBAL_SORTS[q]
        df = build(four)
        out, wall, launches, plan = counted(df)
        strategy = plan_strategy(plan)
        shown = plan.explain()
        want = {"GLOBAL_SORT": "RangePartitioner(4)",
                "GLOBAL_SORT2": "SinglePartitioner"}.get(
            q, "HashPartitioner(4)")
        if want not in shown:
            raise AssertionError(f"T5 {q} plans no {want}:\n{shown}")
        if q in TS.QUERIES:
            ok, why = TS.check_rows(q, out.to_pylist(), rows[q])
        else:
            ok, why = TS.check_sorted(q, out, build(one).to_arrow())
        if not ok:
            raise AssertionError(f"T5 {q} with 4 partitions differs from "
                                 f"one partition ({why})")
        warm = _warm_wall(lambda b=build: b(four).to_arrow(), 3, first=wall)
        res[f"T5_{q}"] = {"rows": out.num_rows, "first_s": wall,
                          "warm_s": warm, "launches": launches,
                          "strategy": strategy}
        log(f"typed T5 {q}: 4 splits x 4 partitions equal one partition "
            f"({out.num_rows} rows); {strategy_line(strategy)}; launches "
            f"{launches}; warm wall {warm:.4f}s (median of 3)")

    if total["hashtbl_probe"] <= 0 or total["segscan"] <= 0:
        raise AssertionError(f"phase 16 launched {total}: both kernels "
                             f"must launch")
    if (probe_calls[0] < total["hashtbl_probe"]
            or sum(scan_calls.values()) < total["segscan"]):
        raise AssertionError(f"phase 16 checked {probe_calls[0]} probe and "
                             f"{scan_calls} segscan calls for {total} "
                             f"launches")
    log(f"probe: all {probe_calls[0]} calls and segscan: all "
        f"{sum(scan_calls.values())} calls ({scan_calls}) of phase 16 equal "
        f"the plain version ({total} launches)")
    nulls = {c: typed.column(c).null_count for c in typed.column_names}
    return {"queries": res, "rows": n, "nulls": nulls, "launches": total,
            "probe_calls_checked": probe_calls[0],
            "segscan_calls_checked": scan_calls,
            "largest_probe": largest.get("args"),
            "wall_s": time.perf_counter() - t_phase}


class CountedRuns:
    """A pass phase's counted runs (phases 17-19): each run plans and runs
    a query with the launch counts zeroed before and read after, every
    probe and segmented-scan call held against its plain version; the
    totals, the checked calls and the largest probe and scan (by rows,
    or by ``scan_key(values, op)``) are kept for the phase's checks."""

    def __init__(self, scan_key=None):
        from spark_rapids_tpu_torch.exec import kernels as K

        self.K = K
        self.total = {k: 0 for k in K.KERNEL_LAUNCHES}
        self.probe_calls = [0]
        self.scan_calls = {"add": 0, "min": 0, "max": 0}
        self.real_probe = K.probe_hash_table_kernel
        self.real_scan = K.segmented_scan_kernel
        self._check_probe = checking_probe(self.real_probe, self.probe_calls)
        self._check_scan = checking_scan(self.real_scan, self.scan_calls)
        self._scan_key = scan_key or (lambda values, op: values.numel())
        self.largest = {}

    def _probe(self, tbl, h1, h2, capacity, seed, max_probes):
        if h1.numel() > self.largest.get("probe_rows", -1):
            self.largest.update(probe_rows=h1.numel(),
                                probe=(tbl, h1, h2, capacity, seed))
        return self._check_probe(tbl, h1, h2, capacity, seed, max_probes)

    def _scan(self, values, is_start, op_name="add"):
        key = self._scan_key(values, op_name)
        if "scan_key" not in self.largest or key > self.largest["scan_key"]:
            self.largest.update(scan_key=key,
                                scan=(values, is_start, op_name))
        return self._check_scan(values, is_start, op_name)

    def run(self, df):
        """(table, wall, launches, plan) of one planning and run of
        ``df``."""
        import torch

        from spark_rapids_tpu_torch.plan import dataframe as DF

        K = self.K
        torch.cuda.synchronize()
        K.reset_kernel_launches()
        K.probe_hash_table_kernel = self._probe
        K.segmented_scan_kernel = self._scan
        try:
            t1 = time.perf_counter()
            plan = counted_plan(df)
            out = DF.execute_to_arrow(plan)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        finally:
            K.probe_hash_table_kernel = self.real_probe
            K.segmented_scan_kernel = self.real_scan
        launches = dict(K.KERNEL_LAUNCHES)
        for k, v in launches.items():
            self.total[k] += v
        return out, wall, launches, plan

    def finish(self, phase: str) -> dict:
        """Both kernels launched and every launch in a checked call; the
        phase's result entries."""
        total, scans = self.total, self.scan_calls
        if total["hashtbl_probe"] <= 0 or total["segscan"] <= 0:
            raise AssertionError(f"{phase} launched {total}: both kernels "
                                 f"must launch")
        if (self.probe_calls[0] < total["hashtbl_probe"]
                or sum(scans.values()) < total["segscan"]):
            raise AssertionError(f"{phase} checked {self.probe_calls[0]} "
                                 f"probe and {scans} segscan calls for "
                                 f"{total} launches")
        log(f"probe: all {self.probe_calls[0]} calls and segscan: all "
            f"{sum(scans.values())} calls ({scans}) of {phase} equal the "
            f"plain version ({total} launches)")
        return {"launches": total,
                "probe_calls_checked": self.probe_calls[0],
                "segscan_calls_checked": scans,
                "largest_probe": self.largest.get("probe"),
                "largest_scan": self.largest.get("scan")}


def off_device(df):
    """The plan's nodes marked for the CPU engine (``explain("ALL")``)."""
    return [ln.strip() for ln in df.explain("ALL").splitlines()
            if ln.lstrip().startswith("!")]


# phase 17: the statistics pass; S3's capped run reads store_sales in
# 2^18-row batches (11 at SF1), so the aggregate holds 11 partials
STAT_CAPPED_BATCH_ROWS = 1 << 18


def run_stat_path(ds_tables) -> dict:
    """Phase 17: the statistics pass (``bench/stat_sales.py``): S1-S5 and
    S4_SKEW on the card against the CPU engine (S1 and S2 also against
    pandas), S1 and S3 with 4 splits and 4 shuffle partitions against one
    partition, and S3 under a capped pool against uncapped. Every probe
    and segmented-scan call of the counted runs is held against its plain
    version; the largest of each is kept for timing."""

    from spark_rapids_tpu_torch.bench import stat_sales as SS
    from spark_rapids_tpu_torch.config import conf as C
    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import aggregate as AGG
    from spark_rapids_tpu_torch.mem import pool as MP
    from spark_rapids_tpu_torch.mem import spill as MSP
    from spark_rapids_tpu_torch.plan.overrides import join_paths

    t_phase = time.perf_counter()
    tables = {n: ds_tables[n] for n in SS.TABLES}
    runs = CountedRuns(lambda values, op: (values.numel(), values.is_floating_point() and op == "add"))
    dev = SS.df_tables(tables, device="cuda")
    cpu = SS.df_tables(tables, RapidsConf(
        {"spark.rapids.gpu.sql.enabled": "false"}), device="cuda")
    store = SS.first_store(tables)
    queries = dict(SS.QUERIES)
    queries["S4_SKEW"] = lambda d: SS.s4_skew(d, store=store)
    res, rows = {}, {}
    for q, build in queries.items():
        df = build(dev)
        off = off_device(df)
        want = {"S5": "! Aggregate", "S4_SKEW": "! Window"}.get(q)
        if (want is None and off) or (want is not None and (
                len(off) != 1 or not off[0].startswith(want))):
            raise AssertionError(f"{q} places {off} on the CPU engine")
        out, wall, launches, plan = runs.run(df)
        got = out.to_pylist()
        t1 = time.perf_counter()
        exp = build(cpu).to_arrow().to_pylist()
        cpu_s = time.perf_counter() - t1
        ok, why = SS.check_rows(q, got, exp)
        if not ok:
            raise AssertionError(f"{q} on the card differs from the CPU "
                                 f"engine ({why}):\n{got[:2]}\n{exp[:2]}")
        pandas_s = None
        if q in SS.PANDAS:
            t1 = time.perf_counter()
            ok, why = SS.check_rows(q, got, SS.PANDAS[q](tables))
            pandas_s = time.perf_counter() - t1
            if not ok:
                raise AssertionError(f"{q} differs from pandas ({why})")
        if q in ("S1", "S2a", "S3") and (
                launches["hashtbl_probe"] <= 0
                or set(join_paths(plan)) != {"ht"}):
            raise AssertionError(f"{q} launched {launches} on join paths "
                                 f"{join_paths(plan)}")
        if q == "S4" and launches["segscan"] <= 0:
            raise AssertionError("S4 launched no segscan kernel")
        if q not in ("S2b",) and not SS.informative(got):
            raise AssertionError(f"{q} shows no values: {got[:2]}")
        warm = _warm_wall(lambda b=build: b(dev).to_arrow(), 3, first=wall)
        rows[q] = got
        res[q] = {"rows": len(got), "first_s": wall, "warm_s": warm,
                  "cpu_engine_s": cpu_s, "pandas_s": pandas_s,
                  "launches": launches, "off_device": off,
                  "shown": [{k: str(v) for k, v in r.items()}
                            for r in got[:1]]}
        log(f"stat {q}: {len(got)} rows equal the CPU engine"
            f"{' and pandas' if q in SS.PANDAS else ''}; launches "
            f"{launches}; warm wall {warm:.4f}s (median of 3); CPU engine "
            f"{cpu_s:.3f}s; on the CPU engine {off or 'nothing'}; first row "
            f"{res[q]['shown']}")

    # S6: S1 and S3 with 4 splits and 4 shuffle partitions (store_sales
    # in 4 batches, one a split, so S3's First/Last read its rows in
    # order) against one partition
    n = tables["store_sales"].num_rows
    four = SS.df_tables(tables, RapidsConf(
        {"spark.rapids.gpu.fastpath.enabled": "false"}), device="cuda",
        partitions=4, shuffle_partitions=4, batch_rows=-(-n // 4))
    for q in ("S1", "S3"):
        out, wall, launches, plan = runs.run(SS.QUERIES[q](four))
        strategy = plan_strategy(plan)
        shown = plan.explain()
        if "HashPartitioner(4)" not in shown or "mode=partial" not in shown:
            raise AssertionError(f"S6 {q} plans no partial aggregate over a "
                                 f"hash exchange:\n{shown}")
        ok, why = SS.check_rows(q, out.to_pylist(), rows[q])
        if not ok:
            raise AssertionError(f"S6 {q} with 4 partitions differs from "
                                 f"one partition ({why})")
        warm = _warm_wall(lambda q=q: SS.QUERIES[q](four).to_arrow(), 3,
                          first=wall)
        res[f"S6_{q}"] = {"rows": out.num_rows, "first_s": wall,
                          "warm_s": warm, "launches": launches,
                          "strategy": strategy}
        log(f"stat S6 {q}: 4 splits x 4 partitions equal one partition "
            f"({out.num_rows} rows); {strategy_line(strategy)}; launches "
            f"{launches}; warm wall {warm:.4f}s (median of 3)")

    # S6: S3 in 2^18-row batches uncapped, then under the least pool its
    # largest handle and pinned set fit (host tier and repartition target
    # a sixteenth of it), as phase 15 caps its cases
    def fresh_pool(conf):
        pool = MP.HbmPool(MP.pool_limit(conf))
        MP.set_pool(pool)
        MSP.SpillFramework(pool,
                           host_limit_bytes=C.HOST_SPILL_LIMIT.get(conf))
        return pool

    def s3_in_batches(settings):
        return SS.s3(SS.df_tables(tables, RapidsConf(settings),
                                  batch_rows=STAT_CAPPED_BATCH_ROWS,
                                  device="cuda"))

    try:
        fresh_pool(RapidsConf())
        out, wall, launches, _plan = runs.run(s3_in_batches({}))
        base = out.to_pylist()
        ok, why = SS.check_rows("S3", base, rows["S3"])
        if not ok:
            raise AssertionError(f"S3 in batches differs ({why})")
        c0 = MSP.get_framework().counters()
        cap = max(c0["max_handle_bytes"], c0["max_pinned_bytes"])
        settings = {"spark.rapids.gpu.memory.pool.maxBytes": cap,
                    "spark.rapids.gpu.memory.host.spillStorageSize":
                        cap // CAP_FRACTION,
                    "spark.rapids.gpu.sql.agg.repartition.targetBytes":
                        cap // CAP_FRACTION}
        fresh_pool(RapidsConf(settings))
        s0 = AGG.repartition_snapshot()["total"]
        out, cwall, claunches, _plan = runs.run(s3_in_batches(settings))
        c = MSP.get_framework().counters()
        repartitions = AGG.repartition_snapshot()["total"] - s0
    finally:
        MP.set_pool(None)
        C.set_active(None)
    ok, why = SS.check_rows("S3", out.to_pylist(), base)
    if not ok:
        raise AssertionError(f"S3 capped differs from uncapped ({why})")
    if not (c["spilled_to_host"] and c["unspilled"]):
        raise AssertionError(f"S3 capped spilled nothing back: {c}")
    res["S6_S3_capped"] = {
        "uncapped_s": wall, "capped_s": cwall, "cap_bytes": cap,
        "uncapped_largest_handle_bytes": c0["max_handle_bytes"],
        "uncapped_max_pinned_bytes": c0["max_pinned_bytes"], "spill": c,
        "repartitions": repartitions, "launches": claunches,
        "uncapped_launches": launches}
    log(f"stat S6 S3 in {STAT_CAPPED_BATCH_ROWS}-row batches capped at "
        f"{cap} B: rows equal uncapped; spilled {c['spilled_to_host']} x to "
        f"host ({c['spilled_to_host_bytes']} B), {c['spilled_to_disk']} x "
        f"to disk ({c['spilled_to_disk_bytes']} B), {c['unspilled']} back; "
        f"{repartitions} repartition passes; {cwall:.3f}s against "
        f"{wall:.3f}s uncapped")

    return dict(runs.finish("phase 17"), queries=res,
                wall_s=time.perf_counter() - t_phase)


SCALAR_CHECKS = ("N1", "N2a", "N2b", "N3", "N5", "N6", "pyarrow_N1")


def scalar_check(q: str, table_dir: str, store: int) -> tuple:
    """Phase 18's check of one query in a worker process of its own, over
    the scalar tables in ``table_dir`` (``table_files``): the query's rows
    on the CPU engine (``q`` "N2a" and "N2b" are N2's two halves of
    columns, "pyarrow_N1" N1 by pyarrow's parse and pandas) and its
    seconds."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.set_num_threads(1)
    from spark_rapids_tpu_torch.bench import scalar_sales as SS
    from spark_rapids_tpu_torch.config.conf import RapidsConf

    tables = read_table_files(table_dir, [f[:-len(".arrow")] for f in
                                          os.listdir(table_dir)])
    t0 = time.perf_counter()
    if q == "pyarrow_N1":
        rows = SS.pandas_n1(tables)
    else:
        cpu = SS.df_tables(tables, RapidsConf(
            {"spark.rapids.gpu.sql.enabled": "false"}), device="cpu")
        df = (SS.n6(cpu, store=store) if q == "N6"
              else SS.n2(cpu, part="ab".index(q[2])) if q.startswith("N2")
              else SS.QUERIES[q](cpu))
        rows = df.to_arrow().to_pylist()
    return rows, time.perf_counter() - t0


def run_scalar_path(ds_tables, started=None) -> dict:
    """Phase 18: the scalar sales pass (``bench/scalar_sales.py``): N1-N6
    on the card against the CPU engine (N1 also against its typed twin and
    pyarrow's parse; N4 against pyarrow's text), then N1 and N3 with 4
    splits and 4 shuffle partitions against one partition. Every probe
    and segmented-scan call of the counted runs is held against its plain
    version; the largest of each is kept for timing. The CPU engine's
    runs (N2's in two halves of its columns) go to worker processes
    started first (``check_workers``), which read the tables from Arrow
    files, so that they overlap the card's counted runs; the warm walls
    are taken after they have returned. ``started``, if given, is
    called with the phase's tables once its workers are started (phase
    19 starts its own workers then)."""

    from spark_rapids_tpu_torch.bench import scalar_sales as SS
    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.plan.overrides import join_paths

    t_phase = time.perf_counter()
    tables = {n: ds_tables[n] for n in ("item", "customer", "date_dim")}
    tables.update(SS.scalar_tables(ds_tables))
    n = tables["store_sales"].num_rows
    store = SS.first_store(tables)
    table_dir = table_files(tables, list(tables))
    log(f"scalar store_sales: {n} rows typed and untyped, written for the "
        f"check workers, in {time.perf_counter() - t_phase:.2f}s")
    pool = check_workers()
    pending = {q: pool.apply_async(scalar_check, (q, table_dir, store))
               for q in SCALAR_CHECKS}
    if started is not None:
        started(tables)
    runs = CountedRuns()
    dev = SS.df_tables(tables, device="cuda")
    queries = dict(SS.QUERIES)
    queries["N6"] = lambda d: SS.n6(d, store=store)
    res, rows = {}, {}
    for q, build in queries.items():
        df = build(dev)
        off = off_device(df)
        if q == "N6":
            want = ("float to string cast not on device",
                    "decimal floor/ceil/round not on device",
                    "decimal division not on device")
            if (len(off) != 1 or not off[0].startswith("! Project")
                    or not all(w in off[0] for w in want)):
                raise AssertionError(f"N6 places {off} on the CPU "
                                     f"engine")
        elif off:
            raise AssertionError(f"{q} places {off} on the CPU engine")
        out, wall, launches, plan = runs.run(df)
        got = out.to_pylist()
        if q in ("N1", "N3") and (launches["hashtbl_probe"] <= 0
                                  or set(join_paths(plan)) != {"ht"}):
            raise AssertionError(f"{q} launched {launches} on join "
                                 f"paths {join_paths(plan)}")
        if q == "N5" and launches["segscan"] <= 0:
            raise AssertionError("N5 launched no segscan kernel")
        if not SS.informative(got):
            raise AssertionError(f"{q} shows no values: {got[:2]}")
        rows[q] = got
        res[q] = {"rows": len(got), "first_s": wall,
                  "launches": launches,
                  "probe_calls": launches["hashtbl_probe"],
                  "scan_calls": launches["segscan"], "off_device": off,
                  "shown": [{k: str(v) for k, v in r.items()}
                            for r in got[:1]]}
    typed = SS.n1(dev, typed=True).to_arrow().to_pylist()
    ok, why = SS.check_rows("N1", rows["N1"], typed)
    if not ok:
        raise AssertionError(f"N1 differs from its typed twin ({why})")
    # N4 formats and parses every row twice over: it is held against
    # pyarrow's text (in this process: a few tenths of a second)
    t1 = time.perf_counter()
    exp4 = SS.arrow_n4(tables)
    res["N4"]["check_s"] = time.perf_counter() - t1
    ok, why = SS.check_rows("N4", rows["N4"], exp4)
    if not ok:
        raise AssertionError(f"N4 differs from pyarrow's text ({why}):"
                             f"\n{rows['N4'][:2]}\n{exp4[:2]}")

    # N7: N1 and N3 with 4 splits and 4 shuffle partitions against one
    # partition (the fast path off)
    four = SS.df_tables(tables, RapidsConf(
        {"spark.rapids.gpu.fastpath.enabled": "false"}), device="cuda",
        partitions=4, shuffle_partitions=4, batch_rows=-(-n // 4))
    for q in SS.PARTITIONED:
        out, wall, launches, plan = runs.run(SS.QUERIES[q](four))
        strategy = plan_strategy(plan)
        shown = plan.explain()
        if ("HashPartitioner(4)" not in shown
                or "mode=partial" not in shown):
            raise AssertionError(f"N7 {q} plans no partial aggregate "
                                 f"over a hash exchange:\n{shown}")
        ok, why = SS.check_rows(q, out.to_pylist(), rows[q])
        if not ok:
            raise AssertionError(f"N7 {q} with 4 partitions differs "
                                 f"from one partition ({why})")
        res[f"N7_{q}"] = {"rows": out.num_rows, "first_s": wall,
                          "launches": launches, "strategy": strategy}
        log(f"scalar N7 {q}: 4 splits x 4 partitions equal one "
            f"partition ({out.num_rows} rows); "
            f"{strategy_line(strategy)}; launches {launches}")

    # the CPU engine's rows (and pyarrow's N1) from the workers
    t1 = time.perf_counter()
    for q in SCALAR_CHECKS:
        exp, check_s = pending[q].get(timeout=600)
        name = "N1" if q == "pyarrow_N1" else q[:2]
        got = [{k: r[k] for k in exp[0]} for r in rows[name]] \
            if exp else rows[name]  # N2's half of the columns
        ok, why = SS.check_rows(name, got, exp)
        if not ok:
            raise AssertionError(
                f"{q} on the card differs from "
                f"{'pyarrow' if q == 'pyarrow_N1' else 'the CPU engine'}"
                f" ({why}):\n{got[:2]}\n{exp[:2]}")
        key = ("pyarrow_s" if q == "pyarrow_N1" else "check_s")
        res[name][key] = res[name].get(key, 0.0) + check_s
    log(f"scalar: the CPU engine's rows (N1 also pyarrow's) equal the "
        f"card's; waited {time.perf_counter() - t1:.2f}s for the "
        f"workers")

    # the warm walls, with the phase's checks returned
    for q, build in queries.items():
        res[q]["warm_s"] = _warm_wall(lambda b=build: b(dev).to_arrow(), 3,
                                      first=res[q]["first_s"])
    for q in SS.PARTITIONED:
        res[f"N7_{q}"]["warm_s"] = _warm_wall(
            lambda q=q: SS.QUERIES[q](four).to_arrow(), 3,
            first=res[f"N7_{q}"]["first_s"])
    for q, r in res.items():
        log(f"scalar {q}: {r['rows']} rows; launches {r['launches']}; "
            f"warm wall {r['warm_s']:.4f}s (median of 3); check "
            f"{r.get('check_s', 0.0):.3f}s; on the CPU engine "
            f"{r.get('off_device') or 'nothing'}")

    nulls = {c: tables["store_sales"].column(c).null_count
             for c in ("ss_customer_sk", "ss_promo_sk")}
    return dict(runs.finish("phase 18"), queries=res, rows=n, nulls=nulls,
                wall_s=time.perf_counter() - t_phase)


# phase 19: the string sales pass; G2 is checked in two halves of its
# columns, G1 also by pandas
STRING_CHECKS = ("G1a", "G1b", "G2a", "G2b", "G3", "G3R", "G4", "G5",
                 "pandas_G1")


def string_check(q: str, table_dir: str, store: str) -> tuple:
    """Phase 19's check of one query in a worker process of its own, over
    the string tables in ``table_dir``: the query's rows on the CPU engine
    ("G1a"/"G1b" and "G2a"/"G2b" are G1's and G2's two halves of columns,
    "pandas_G1" G1 by pandas and Python's ``str``) and its seconds."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.set_num_threads(1)
    from spark_rapids_tpu_torch.bench import string_sales as G
    from spark_rapids_tpu_torch.config.conf import RapidsConf

    tables = read_table_files(table_dir, ("store_sales", "item", "customer",
                                          "untyped_store_sales"))
    t0 = time.perf_counter()
    if q == "pandas_G1":
        rows = G.pandas_g1(tables)
    else:
        cpu = G.df_tables(tables, RapidsConf(
            {"spark.rapids.gpu.sql.enabled": "false"}), device="cpu")
        df = (G.g4(cpu, store=store) if q == "G4"
              else G.QUERIES[q[:2]](cpu, part="ab".index(q[2]))
              if q[:2] in ("G1", "G2") else G.QUERIES[q](cpu))
        rows = df.to_arrow().to_pylist()
    return rows, time.perf_counter() - t0


def start_string_checks(ds_tables, untyped) -> dict:
    """Phase 19's tables (the SF1 store_sales, item and customer, and
    phase 18's untyped store_sales) written as Arrow files, and its
    CPU-engine checks started in worker processes (``STRING_CHECKS``),
    ahead of the phase: (the phase's state for ``run_string_path``)."""
    from spark_rapids_tpu_torch.bench import string_sales as G

    t0 = time.perf_counter()
    tables = {n: ds_tables[n] for n in ("store_sales", "item", "customer")}
    tables["untyped_store_sales"] = untyped
    store = G.first_store(tables)
    table_dir = table_files(tables, list(tables))
    log(f"string tables: {tables['store_sales'].num_rows} store_sales rows "
        f"typed and untyped, written for the check workers, in "
        f"{time.perf_counter() - t0:.2f}s")
    pool = check_workers()
    pending = {q: pool.apply_async(string_check, (q, table_dir, store))
               for q in STRING_CHECKS}
    return {"tables": tables, "store": store, "pending": pending,
            "started_s": time.perf_counter() - t0}


def run_string_path(state) -> dict:
    """Phase 19: the string sales pass (``bench/string_sales.py``): G1-G5
    on the card against the CPU engine (G1 also against pandas), the
    placement of G3R's rejected pattern and of G4's CPU-engine classes
    named by ``explain``, then G6: G1 and G2 with 4 splits and 4 shuffle
    partitions against one partition. Every probe and segmented-scan call
    of the counted runs is held against its plain version; the largest of
    each is kept for timing. The CPU engine's runs go to worker processes
    started before phase 18's card runs (``start_string_checks``); the
    warm walls are taken after they have returned."""

    from spark_rapids_tpu_torch.bench import string_sales as G
    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.plan.overrides import join_paths

    t_phase = time.perf_counter()
    tables, store = state["tables"], state["store"]
    pending = state["pending"]
    n = tables["store_sales"].num_rows
    runs = CountedRuns()
    # the one node each query places on the CPU engine, and its reasons
    placed = {"G3R": ("! Filter", ["regex not on device: unknown escape "
                                   "\\1"]),
              "G4": ("! Project", [f"expression {c} not on device" for c in (
                  "Md5", "Sha1", "Sha2", "Crc32", "Levenshtein",
                  "FormatNumber", "StringSpace", "Bin", "Overlay",
                  "RegexpExtract", "RegexpReplace")])}
    dev = G.df_tables(tables, device="cuda")
    queries = dict(G.QUERIES)
    queries["G4"] = lambda d: G.g4(d, store=store)
    res, rows = {}, {}
    for q, build in queries.items():
        df = build(dev)
        off = off_device(df)
        if q in placed:
            node, reasons = placed[q]
            if (len(off) != 1 or not off[0].startswith(node)
                    or not all(r in off[0] for r in reasons)):
                raise AssertionError(f"{q} places {off} on the CPU "
                                     f"engine")
        elif off:
            raise AssertionError(f"{q} places {off} on the CPU engine")
        out, wall, launches, plan = runs.run(df)
        got = out.to_pylist()
        if q in ("G1", "G3", "G3R", "G5") and (
                launches["hashtbl_probe"] <= 0
                or set(join_paths(plan)) != {"ht"}):
            raise AssertionError(f"{q} launched {launches} on join "
                                 f"paths {join_paths(plan)}")
        if q == "G5" and launches["segscan"] <= 0:
            raise AssertionError("G5 launched no segscan kernel")
        if not G.informative(got):
            raise AssertionError(f"{q} shows no values: {got[:2]}")
        rows[q] = got
        res[q] = {"rows": len(got), "first_s": wall,
                  "launches": launches,
                  "probe_calls": launches["hashtbl_probe"],
                  "scan_calls": launches["segscan"], "off_device": off,
                  "shown": [{k: str(v) for k, v in r.items()}
                            for r in got[:1]]}
    bad = [{b: r[b] for b in G.G2_BAD} for r in rows["G2"]]
    if any(v for r in bad for v in r.values()):
        raise AssertionError(f"G2's round trips changed values: {bad}")

    # G6: G1 and G2 with 4 splits and 4 shuffle partitions against one
    # partition (the fast path off)
    four = G.df_tables(tables, RapidsConf(
        {"spark.rapids.gpu.fastpath.enabled": "false"}), device="cuda",
        partitions=4, shuffle_partitions=4, batch_rows=-(-n // 4))
    for q in G.PARTITIONED:
        out, wall, launches, plan = runs.run(G.QUERIES[q](four))
        strategy = plan_strategy(plan)
        shown = plan.explain()
        if ("HashPartitioner(4)" not in shown
                or "mode=partial" not in shown):
            raise AssertionError(f"G6 {q} plans no partial aggregate "
                                 f"over a hash exchange:\n{shown}")
        ok, why = G.check_rows(q, out.to_pylist(), rows[q])
        if not ok:
            raise AssertionError(f"G6 {q} with 4 partitions differs "
                                 f"from one partition ({why})")
        res[f"G6_{q}"] = {"rows": out.num_rows, "first_s": wall,
                          "launches": launches, "strategy": strategy}
        log(f"string G6 {q}: 4 splits x 4 partitions equal one "
            f"partition ({out.num_rows} rows); "
            f"{strategy_line(strategy)}; launches {launches}")

    # the CPU engine's rows (and pandas' G1) from the workers
    t1 = time.perf_counter()
    for q in STRING_CHECKS:
        exp, check_s = pending[q].get(timeout=600)
        name = "G1" if q == "pandas_G1" else q[:2] if q[:2] in (
            "G1", "G2") else q
        got = [{k: r[k] for k in exp[0]} for r in rows[name]] \
            if exp else rows[name]  # a half of the columns
        ok, why = G.check_rows(name, got, exp)
        if not ok:
            raise AssertionError(
                f"{q} on the card differs from "
                f"{'pandas' if q == 'pandas_G1' else 'the CPU engine'}"
                f" ({why}):\n{got[:2]}\n{exp[:2]}")
        key = "pandas_s" if q == "pandas_G1" else "check_s"
        res[name][key] = res[name].get(key, 0.0) + check_s
    log(f"string: the CPU engine's rows (G1 also pandas') equal the "
        f"card's; waited {time.perf_counter() - t1:.2f}s for the "
        f"workers")

    # the warm walls, with the phase's checks returned
    for q, build in queries.items():
        res[q]["warm_s"] = _warm_wall(lambda b=build: b(dev).to_arrow(), 3,
                                      first=res[q]["first_s"])
    for q in G.PARTITIONED:
        res[f"G6_{q}"]["warm_s"] = _warm_wall(
            lambda q=q: G.QUERIES[q](four).to_arrow(), 3,
            first=res[f"G6_{q}"]["first_s"])
    for q, r in res.items():
        log(f"string {q}: {r['rows']} rows; launches {r['launches']}; "
            f"warm wall {r['warm_s']:.4f}s (median of 3); check "
            f"{r.get('check_s', 0.0):.3f}s; on the CPU engine "
            f"{r.get('off_device') or 'nothing'}")

    return dict(runs.finish("phase 19"), queries=res, rows=n,
                wall_s=time.perf_counter() - t_phase + state["started_s"])


# phase 20: the nested sales pass; the CPU engine's runs (and the
# independent oracles: pyarrow's list kernels for H1, Python's json for H3)
# in worker processes
NESTED_CHECKS = ("H2", "H3", "H3R", "H4G", "H4J", "H5", "H6", "arrow_H1",
                 "json_H3")
NESTED_TABLES = ("tickets", "lines", "item")
# the one node each query places on the CPU engine, and its reasons (H5's
# aggregate and the nodes above it hold its collected arrays of strings)
NESTED_PLACED = {
    "H3R": ["json path '$.lines[*].item' not on device"],
    "H5": ["expression CollectList not on device",
           "expression CollectSet not on device",
           "expression MapValues not on device",
           "expression JsonToStructsText not on device",
           "arrays of variable-width elements are not on the device"]}


def nested_check(q: str, table_dir: str) -> tuple:
    """Phase 20's check of one query in a worker process of its own, over
    the nested tables in ``table_dir``: the query's rows on the CPU engine
    (``arrow_H1`` H1 by pyarrow's list kernels, ``json_H3`` H3 by
    Python's json) and its seconds."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.set_num_threads(1)
    from spark_rapids_tpu_torch.bench import nested_sales as NS
    from spark_rapids_tpu_torch.config.conf import RapidsConf

    tables = read_table_files(table_dir, NESTED_TABLES)
    t0 = time.perf_counter()
    if q == "arrow_H1":
        rows = NS.arrow_h1(tables)
    elif q == "json_H3":
        rows = NS.json_h3(tables)
    else:
        cpu = NS.df_tables(tables, RapidsConf(
            {"spark.rapids.gpu.sql.enabled": "false"}), device="cpu")
        rows = NS.QUERIES[q](cpu).to_arrow().to_pylist()
    return rows, time.perf_counter() - t0


def start_nested_checks(ds_tables) -> dict:
    """Phase 20's tables (``nested_sales.nested_tables`` of the SF1
    store_sales, and item) built on the host and written as Arrow files,
    and its CPU-engine checks started in worker processes
    (``NESTED_CHECKS``): (tables, pending results, seconds to build)."""
    from spark_rapids_tpu_torch.bench import nested_sales as NS

    t0 = time.perf_counter()
    tables = NS.nested_tables(ds_tables["store_sales"])
    tables["item"] = ds_tables["item"].select(["i_item_sk", "i_category"])
    build_s = time.perf_counter() - t0
    table_dir = table_files(tables, NESTED_TABLES)
    log(f"nested tables: {tables['tickets'].num_rows} tickets over "
        f"{tables['lines'].num_rows} lines, "
        f"{tables['tickets'].column('doc').nbytes} B of JSON, built in "
        f"{build_s:.2f}s and written for the check workers in "
        f"{time.perf_counter() - t0 - build_s:.2f}s")
    pool = check_workers()
    pending = {q: pool.apply_async(nested_check, (q, table_dir))
               for q in NESTED_CHECKS}
    return tables, pending, build_s


class _Planned:
    """A physical plan in a DataFrame's clothes, for ``CountedRuns.run``."""

    def __init__(self, build):
        self.build = build

    def physical_plan(self):
        return self.build()


def run_nested_path(ds_tables) -> dict:
    """Phase 20: the nested sales pass (``bench/nested_sales.py``): H1
    (posexplode through ``GenerateExec``, the hash join exec and the
    aggregate, composed as exec nodes) against pyarrow's list kernels;
    H2-H6 on the card against the CPU engine, H3 also against Python's
    json; the placement of H3R's rejected path and of H5's CPU-engine
    classes named by ``explain``; then H7: H2, H4G and H4J with 4 splits
    and 4 shuffle partitions against one partition. Every probe and
    segmented-scan call of the counted runs is held against its plain
    version; the largest of each is kept for timing. The CPU engine's
    runs start with the phase (``start_nested_checks``), after phase 19's
    warm walls, and overlap its counted runs; the warm walls are taken
    after they have returned."""
    from spark_rapids_tpu_torch.bench import nested_sales as NS
    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow
    from spark_rapids_tpu_torch.plan.overrides import join_paths

    t_phase = time.perf_counter()
    tables, pending, build_s = start_nested_checks(ds_tables)
    n = tables["tickets"].num_rows
    runs = CountedRuns()
    res, rows = {}, {}
    sources = NS.h1_sources(tables, "cuda")
    h1 = _Planned(lambda: NS.h1_plan(sources))
    out, wall, launches, plan = runs.run(h1)
    got = sorted(out.to_pylist(), key=lambda r: r["i_category"])
    if launches["hashtbl_probe"] <= 0:
        raise AssertionError(f"H1 launched {launches}")
    rows["H1"] = got
    res["H1"] = {"rows": len(got), "first_s": wall, "launches": launches,
                 "probe_calls": launches["hashtbl_probe"],
                 "scan_calls": launches["segscan"], "off_device": [],
                 "exploded": sum(r["n"] for r in got)}
    dev = NS.df_tables(tables, device="cuda")
    for q, build in NS.QUERIES.items():
        df = build(dev)
        off = off_device(df)
        if q in NESTED_PLACED:
            if not all(any(r in ln for ln in off)
                       for r in NESTED_PLACED[q]):
                raise AssertionError(f"{q} places {off} on the CPU "
                                     f"engine")
        elif off:
            raise AssertionError(f"{q} places {off} on the CPU engine")
        out, wall, launches, plan = runs.run(df)
        got = out.to_pylist()
        if q == "H4J" and (launches["hashtbl_probe"] <= 0
                           or set(join_paths(plan)) != {"ht"}):
            raise AssertionError(f"H4J launched {launches} on join "
                                 f"paths {join_paths(plan)}")
        if q == "H6" and launches["segscan"] <= 0:
            raise AssertionError("H6 launched no segscan kernel")
        if not got or (q == "H4J" and got[0]["bad"]):
            raise AssertionError(f"{q} gave {got[:2]}")
        rows[q] = got
        res[q] = {"rows": len(got), "first_s": wall,
                  "launches": launches,
                  "probe_calls": launches["hashtbl_probe"],
                  "scan_calls": launches["segscan"], "off_device": off}

    # H7: H2, H4G and H4J with 4 splits and 4 shuffle partitions
    # against one partition; no nested column crosses an exchange
    four = NS.df_tables(tables, RapidsConf(NS.H7_CONF), device="cuda",
                        partitions=4, shuffle_partitions=4,
                        batch_rows=-(-n // 4))
    for q in NS.PARTITIONED:
        out, wall, launches, plan = runs.run(NS.QUERIES[q](four))
        strategy = plan_strategy(plan)
        if "HashPartitioner(4)" not in plan.explain():
            raise AssertionError(f"H7 {q} plans no hash exchange:\n"
                                 f"{plan.explain()}")
        ok, why = NS.check_rows(q, out.to_pylist(), rows[q])
        if not ok:
            raise AssertionError(f"H7 {q} with 4 partitions differs "
                                 f"from one partition ({why})")
        res[f"H7_{q}"] = {"rows": out.num_rows, "first_s": wall,
                          "launches": launches, "strategy": strategy}
        log(f"nested H7 {q}: 4 splits x 4 partitions equal one "
            f"partition ({out.num_rows} rows); "
            f"{strategy_line(strategy)}; launches {launches}")

    # the CPU engine's rows (and the oracles') from the workers
    t1 = time.perf_counter()
    for q in NESTED_CHECKS:
        exp, check_s = pending[q].get(timeout=900)
        name = q.split("_")[-1]
        ok, why = NS.check_rows(name, rows[name], exp)
        if not ok:
            raise AssertionError(f"{name} on the card differs from "
                                 f"{q} ({why}):\n{rows[name][:2]}\n"
                                 f"{exp[:2]}")
        key = "oracle_s" if "_" in q else "check_s"
        res[name][key] = check_s
    waited = time.perf_counter() - t1
    log(f"nested: the CPU engine's rows (H1 pyarrow's, H3 also "
        f"json's) equal the card's; waited {waited:.2f}s for the "
        f"workers")

    # the warm walls, with the phase's checks returned
    res["H1"]["warm_s"] = _warm_wall(
        lambda: execute_to_arrow(NS.h1_plan(sources)), 3,
        first=res["H1"]["first_s"])
    for q, build in NS.QUERIES.items():
        res[q]["warm_s"] = _warm_wall(lambda b=build: b(dev).to_arrow(), 3,
                                      first=res[q]["first_s"])
    for q in NS.PARTITIONED:
        res[f"H7_{q}"]["warm_s"] = _warm_wall(
            lambda q=q: NS.QUERIES[q](four).to_arrow(), 3,
            first=res[f"H7_{q}"]["first_s"])
    for q, r in res.items():
        log(f"nested {q}: {r['rows']} rows; launches {r['launches']}; "
            f"warm wall {r['warm_s']:.4f}s (median of 3); check "
            f"{r.get('check_s', 0.0):.3f}s; on the CPU engine "
            f"{r.get('off_device') or 'nothing'}")
    return dict(runs.finish("phase 20"), queries=res, tickets=n,
                lines=tables["lines"].num_rows, waited_s=waited,
                build_s=build_s, wall_s=time.perf_counter() - t_phase)


def check_stat_scan(values, is_start, op: str, shape: str = "stat_largest",
                    phase: str = "phase 17") -> dict:
    """The segmented-scan kernel on a phase's largest scan: its output
    against the plain version, its times and its byte bound."""
    import torch

    from spark_rapids_tpu_torch.exec import kernels as K

    saved = dict(K.KERNEL_LAUNCHES)
    k = K.segmented_scan_kernel(values, is_start, op)
    torch.cuda.synchronize()
    ok, err, ratio = segscan_compare(k, K.segmented_scan(values, is_start,
                                                         op),
                                     values, is_start, op)
    if not ok:
        raise AssertionError(f"segscan kernel differs from its plain version "
                             f"on {phase}'s largest scan ({err})")
    res = {"shape": shape, "max_abs_err": err,
           "err_over_tolerance": ratio,
           **segscan_times(values, is_start, op)}
    K.KERNEL_LAUNCHES.update(saved)  # comparison launches do not count
    log(f"segscan {shape}: " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# phase 21: the Parquet pass
# ---------------------------------------------------------------------------

SCAN_COUNTS = ("numRowGroups", "numPrunedRowGroups", "numDynPrunedRowGroups")
DPP_OFF = {"spark.rapids.gpu.sql.dynamicPartitionPruning.enabled": "false"}


def parquet_files(ds_tables) -> tuple:
    """The headline queries' eight tables written as Parquet files with
    the port's writer from the card's batches (``bench/parquet_sales.py``:
    store_sales clustered by date, 2^17-row row groups, 786,432-row
    files) under the temporary directory (removed at exit), each read
    back by pyarrow and held equal to its source: (paths, stats, write
    seconds)."""
    import atexit
    import shutil
    import tempfile

    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch.bench import parquet_sales as PS
    from spark_rapids_tpu_torch.bench import tpcds_schema as S

    tables = {n: ds_tables[n] for n in S.BASE_TABLES}
    d = tempfile.mkdtemp(prefix="chip_smoke_parquet_")
    atexit.register(shutil.rmtree, d, True)
    t0 = time.perf_counter()
    paths, stats = PS.write_tables(tables, d, device="cuda")
    write_s = time.perf_counter() - t0
    for name, t in tables.items():
        back = pq.read_table(paths[name])
        if name == PS.FACT:
            t = PS.clustered_fact(t)
        if not back.equals(t.cast(back.schema)):
            raise AssertionError(f"the written {name} differs from its "
                                 f"source")
    return paths, stats, write_s


def parquet_cpu_rows(q: str, paths: dict) -> tuple:
    """A worker's check: ``q`` on the CPU engine over the Parquet files
    (``CpuParquetScanExec``): (rows, seconds)."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.set_num_threads(1)
    from spark_rapids_tpu_torch.bench import parquet_sales as PS
    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.config.conf import RapidsConf

    t0 = time.perf_counter()
    cpu = PS.df_tables(paths, RapidsConf(
        {"spark.rapids.gpu.sql.enabled": "false"}), device="cpu")
    rows = Q.QUERIES[q](cpu).to_arrow().to_pylist()
    return rows, time.perf_counter() - t0


def scan_metrics(plan) -> dict:
    """The Parquet scans' row-group counts and host times, summed over
    the plan's scans."""
    from spark_rapids_tpu_torch.exec.scan import ParquetScanExec

    out = {k: 0 for k in SCAN_COUNTS + ("scanTimeNs", "uploadTimeNs")}
    out["scans"] = 0
    for n in _walk_plan(plan):
        if isinstance(n, ParquetScanExec):
            out["scans"] += 1
            for k in SCAN_COUNTS + ("scanTimeNs", "uploadTimeNs"):
                out[k] += n.metrics[k].value
    return out


def run_parquet_path(ds_tables, head_rows: dict) -> dict:
    """Phase 21: the headline queries read from Parquet files. The files
    written from the card's batches and read back equal; q3's CPU-engine
    run over the files started in a check worker; then each of
    q3/q7/q42/q52/q96 on the card from ``read_parquet`` frames: no node on
    the CPU engine, one counted run (launch counts zeroed before and read
    after, every probe call held against the plain version) whose rows
    equal phase 6's verified rows, its scans' row-group counts and times;
    the same query with dynamic pruning off, its rows equal and none
    pruned dynamically; warm walls with pruning on and off (medians of 3,
    each checked run the first of its three). q3 must prune a row group
    dynamically."""
    import torch

    from spark_rapids_tpu_torch.bench import parquet_sales as PS
    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import dpp as DPP
    from spark_rapids_tpu_torch.exec import kernels as K
    from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow

    t_phase = time.perf_counter()
    paths, stats, write_s = parquet_files(ds_tables)
    written = sum(st.num_bytes for st in stats.values())
    fact_groups = PS.row_groups(paths[PS.FACT])
    log(f"parquet: {sum(st.num_files for st in stats.values())} files, "
        f"{written} B written from the card's batches in {write_s:.2f}s "
        f"(store_sales {len(paths[PS.FACT])} files, {fact_groups} row "
        f"groups); pyarrow reads each back equal to its source")
    pending = check_workers().apply_async(parquet_cpu_rows, ("q3", paths))
    frames = {"on": PS.df_tables(paths, device="cuda"),
              "off": PS.df_tables(paths, RapidsConf(DPP_OFF),
                                  device="cuda")}
    total = {k: 0 for k in K.KERNEL_LAUNCHES}
    probe_calls = [0]
    largest = {}
    real_probe = K.probe_hash_table_kernel
    check_call = checking_probe(real_probe, probe_calls)

    def recording(tbl, h1, h2, capacity, seed, max_probes):
        if h1.numel() > largest.get("n", -1):
            largest.update(n=h1.numel(), args=(tbl, h1, h2, capacity, seed))
        return check_call(tbl, h1, h2, capacity, seed, max_probes)

    # the pruning filters' collect (the build's run and its download
    # included) and, within it, the build batches' download, host clock
    dpp_ns = {"collect": 0, "download": 0}
    real_collect = DPP.DynamicPruningFilter._collect
    real_download = DPP.batch_to_arrow

    def timed(key, fn):
        def call(*args):
            t0 = time.perf_counter_ns()
            try:
                return fn(*args)
            finally:
                dpp_ns[key] += time.perf_counter_ns() - t0
        return call

    def checked_run(df):
        K.reset_kernel_launches()
        K.probe_hash_table_kernel = recording
        dpp_ns.update(collect=0, download=0)
        DPP.DynamicPruningFilter._collect = timed("collect", real_collect)
        DPP.batch_to_arrow = timed("download", real_download)
        try:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            plan = counted_plan(df)
            out = execute_to_arrow(plan)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        finally:
            K.probe_hash_table_kernel = real_probe
            DPP.DynamicPruningFilter._collect = real_collect
            DPP.batch_to_arrow = real_download
        scans = scan_metrics(plan)
        scans.update(dpp_collect_ns=dpp_ns["collect"],
                     dpp_download_ns=dpp_ns["download"])
        return out.to_pylist(), wall, dict(K.KERNEL_LAUNCHES), plan, scans

    res, rows = {}, {}
    for q in Q.HEADLINE:
        df = Q.QUERIES[q](frames["on"])
        off = off_device(df)
        if off:
            raise AssertionError(f"parquet {q} has nodes on the CPU engine: "
                                 f"{off}")
        got, wall, launches, plan, scans = checked_run(df)
        for k, v in launches.items():
            total[k] += v
        ok, why = Q.check_rows(q, got, head_rows[q])
        if not ok:
            raise AssertionError(f"parquet {q} differs from phase 6's rows "
                                 f"({why})")
        if launches["hashtbl_probe"] <= 0:
            raise AssertionError(f"parquet {q} launched no probe kernel")
        # the pruning-off run: its probe calls checked, its launches not
        # counted
        saved = dict(K.KERNEL_LAUNCHES)
        got_off, wall_off, _l, _p, scans_off = checked_run(
            Q.QUERIES[q](frames["off"]))
        K.KERNEL_LAUNCHES.update(saved)
        if got_off != got:
            raise AssertionError(f"parquet {q} with dynamic pruning off "
                                 f"differs")
        if scans_off["numDynPrunedRowGroups"]:
            raise AssertionError(f"parquet {q} pruned dynamically with it "
                                 f"off")
        rows[q] = got
        res[q] = {"rows": len(got), "first_s": wall, "launches": launches,
                  "scan": scans, "scan_dpp_off": scans_off,
                  "first_s_dpp_off": wall_off,
                  "strategy": plan_strategy(plan)}
        log(f"parquet {q}: {len(got)} rows equal phase 6's and with "
            f"dynamic pruning off; launches {launches}; row groups "
            f"{scans['numRowGroups']} read, {scans['numPrunedRowGroups']} "
            f"pruned, {scans['numDynPrunedRowGroups']} pruned dynamically "
            f"({scans_off['numRowGroups']} read with it off); scan "
            f"{scans['scanTimeNs'] / 1e6:.1f} ms, upload "
            f"{scans['uploadTimeNs'] / 1e6:.1f} ms (host); pruning "
            f"filters' collect {scans['dpp_collect_ns'] / 1e6:.1f} ms, of "
            f"it the build's download {scans['dpp_download_ns'] / 1e6:.1f}"
            f" ms (host; with pruning off: scan "
            f"{scans_off['scanTimeNs'] / 1e6:.1f} ms, upload "
            f"{scans_off['uploadTimeNs'] / 1e6:.1f} ms); "
            f"{strategy_line(res[q]['strategy'])}")
    if res["q3"]["scan"]["numDynPrunedRowGroups"] < 1:
        raise AssertionError("parquet q3 pruned no row group dynamically")
    if probe_calls[0] < total["hashtbl_probe"]:
        raise AssertionError(f"phase 21 checked {probe_calls[0]} probe calls "
                             f"for {total} launches")
    t1 = time.perf_counter()
    cpu_rows, cpu_s = pending.get(timeout=900)
    waited = time.perf_counter() - t1
    ok, why = Q.check_rows("q3", cpu_rows, rows["q3"])
    if not ok:
        raise AssertionError(f"parquet q3 on the CPU engine differs from "
                             f"the card ({why})")
    res["q3"]["cpu_engine_s"] = cpu_s
    log(f"parquet q3 on the CPU engine (a worker reading the files) equals "
        f"the card; {cpu_s:.2f}s, waited {waited:.2f}s")
    for q in Q.HEADLINE:
        r = res[q]
        for name in ("on", "off"):
            first = r["first_s"] if name == "on" else r["first_s_dpp_off"]
            r[f"warm_s_dpp_{name}"] = _warm_wall(
                lambda q=q, name=name: Q.QUERIES[q](frames[name]).to_arrow(),
                first=first)
        log(f"parquet {q}: warm wall {r['warm_s_dpp_on']:.4f}s with dynamic "
            f"pruning, {r['warm_s_dpp_off']:.4f}s without (medians of 3)")
    log(f"probe: all {probe_calls[0]} calls of phase 21 equal the plain "
        f"version ({total} launches)")
    return {"queries": res, "launches": total,
            "probe_calls_checked": probe_calls[0],
            "largest_probe": largest.get("args"),
            "paths": paths, "q3_rows": rows["q3"],
            "bytes_written": written, "write_s": write_s,
            "files": {n: len(p) for n, p in paths.items()},
            "fact_row_groups": fact_groups, "waited_s": waited,
            "wall_s": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# phase 22: the lakehouse pass
# ---------------------------------------------------------------------------

LAKE_TABLES = ("store_sales", "item", "date_dim")


def lakehouse_cpu_part(part: str, table_dir: str) -> tuple:
    """A worker's check of phase 22 on the CPU: ``"q3"``, q3 on the CPU
    engine over store_sales and item modified by ``pyarrow.compute`` as
    the Delta tables' versions 5 and 1 are (its rows), or a part of the
    bloom filter and Z-order steps (``lakehouse_sales.clustering``) on the
    CPU (its outputs' digests): (result, seconds)."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.set_num_threads(1)
    from spark_rapids_tpu_torch.bench import lakehouse_sales as LH
    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.config.conf import RapidsConf

    tables = read_table_files(table_dir, LAKE_TABLES)
    t0 = time.perf_counter()
    if part == "q3":
        t = dict(tables)
        t[LH.FACT] = LH.plain_fact(tables[LH.FACT], tables["date_dim"])
        t[LH.DIM] = LH.plain_item(tables[LH.DIM],
                                  LH.merge_source(tables[LH.DIM]))
        cpu = Q.df_tables(t, RapidsConf(
            {"spark.rapids.gpu.sql.enabled": "false"}), device="cpu")
        out = Q.QUERIES["q3"](cpu).to_arrow().to_pylist()
    else:
        out = {f"{part}.{k}": LH.digest(v)
               for k, v in LH.clustering(tables, "cpu", part).items()}
    return out, time.perf_counter() - t0


def run_lakehouse_path(ds_tables, parquet_paths: dict, head_rows: dict,
                       parquet_q3: list) -> dict:
    """Phase 22: the lakehouse pass (``bench/lakehouse_sales.run_pass``) on
    the card over the SF1 store_sales, item and date_dim and phase 21's
    files. q3 at Delta version 5 (item at version 1), at version 3 and over
    the Iceberg table runs wholly on the card, each one counted run
    (launch counts zeroed before and read after, every probe call held
    against the plain version); version 5's rows equal q3 on the CPU
    engine over the tables ``pyarrow.compute`` modified alike (a check
    worker), version 3's phase 6's and the Iceberg table's phase 21's; two
    warm repeats over the Delta tables must hit the plan memo. Each
    snapshot's records equal the rows read; the Iceberg scan prunes as the
    same scan of the files; the cache reads back its plan's rows, twice;
    the ROLLUP equals three pyarrow group-bys; the bloom filter has no
    false negative, and its bits and mask and the Z-order outputs equal
    the port's run on the CPU (workers, by digest); the feature matrix is
    a card tensor equal to the rows' values."""
    import atexit
    import shutil
    import tempfile

    import torch

    from spark_rapids_tpu_torch.bench import lakehouse_sales as LH
    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.exec import kernels as K
    from spark_rapids_tpu_torch.plan import plan_cache
    from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow

    t_phase = time.perf_counter()
    table_dir = table_files(ds_tables, LAKE_TABLES)
    pool = check_workers()
    pending = {p: pool.apply_async(lakehouse_cpu_part, (p, table_dir))
               for p in ("q3",) + LH.CLUSTERING_PARTS}
    work = tempfile.mkdtemp(prefix="chip_smoke_lakehouse_")
    atexit.register(shutil.rmtree, work, True)
    total = {k: 0 for k in K.KERNEL_LAUNCHES}
    launches = {}
    probe_calls = [0]
    largest = {}
    real_probe = K.probe_hash_table_kernel
    check_call = checking_probe(real_probe, probe_calls)

    def recording(tbl, h1, h2, capacity, seed, max_probes):
        if h1.numel() > largest.get("n", -1):
            largest.update(n=h1.numel(), args=(tbl, h1, h2, capacity, seed))
        return check_call(tbl, h1, h2, capacity, seed, max_probes)

    def run_query(name, df):
        off = off_device(df)
        if off:
            raise AssertionError(f"lakehouse {name} has nodes on the CPU "
                                 f"engine: {off}")
        K.reset_kernel_launches()
        K.probe_hash_table_kernel = recording
        try:
            out = execute_to_arrow(counted_plan(df))
        finally:
            K.probe_hash_table_kernel = real_probe
        launches[name] = dict(K.KERNEL_LAUNCHES)
        for k, v in launches[name].items():
            total[k] += v
        if launches[name]["hashtbl_probe"] <= 0:
            raise AssertionError(f"lakehouse {name} launched no probe "
                                 f"kernel")
        return out.to_pylist()

    memo0 = plan_cache.counters()
    res = LH.run_pass({n: ds_tables[n] for n in LAKE_TABLES}, parquet_paths,
                      work, device="cuda", run_query=run_query)
    if probe_calls[0] < total["hashtbl_probe"]:
        raise AssertionError(f"phase 22 checked {probe_calls[0]} probe "
                             f"calls for {total} launches")
    walls = res["walls"]
    # the warm repeats of q3 over the Delta tables: served by the memo
    frames = res.pop("frames_v5")
    c0 = plan_cache.counters()
    warm = _warm_wall(lambda: Q.QUERIES["q3"](frames).to_arrow(),
                      first=walls["q3_v5"])
    hits = (plan_cache.counters()["plan_cache_hit_total"]
            - c0["plan_cache_hit_total"])
    if hits < 2:
        raise AssertionError(f"the warm repeats of q3 over Delta hit the "
                             f"plan memo {hits} times")
    del frames
    # the checks against the references
    snaps, rows_read = res["snapshots"], res["rows_read"]
    if res["versions"] != [0, 1, 2, 3, 4, 5] or res["item_version"] != 1:
        raise AssertionError(f"Delta versions {res['versions']}, item "
                             f"{res['item_version']}")
    for v in (3, 5):
        if snaps[v]["num_records"] != rows_read[v]:
            raise AssertionError(f"Delta version {v} records "
                                 f"{snaps[v]['num_records']}, rows read "
                                 f"{rows_read[v]}")
    if res["item_records"] != rows_read["item"]:
        raise AssertionError("item's records differ from its rows read")
    if not (snaps[4]["dv_rows"] > 0 and 1 <= res["files_rewritten"] <= 2):
        raise AssertionError(f"DELETE wrote {snaps[4]['dv_rows']} deleted "
                             f"rows, UPDATE rewrote {res['files_rewritten']}"
                             f" files")
    for name, got, exp in (("q3_v3", res["q3_v3"], head_rows["q3"]),
                           ("q3_iceberg", res["q3_iceberg"], parquet_q3)):
        ok, why = Q.check_rows("q3", got, exp)
        if not ok:
            raise AssertionError(f"lakehouse {name} differs ({why})")
    if res["iceberg_files"] != parquet_paths[LH.FACT]:
        raise AssertionError("the Iceberg table's files differ from phase "
                             "21's")
    if (res["iceberg_scan"] != res["direct_scan"]
            or res["iceberg_scan"]["numPrunedRowGroups"] < 1):
        raise AssertionError(f"Iceberg scan {res['iceberg_scan']} against "
                             f"{res['direct_scan']}")
    cache = res["cache"]
    if not (cache["equal"] and cache["same_relation"]):
        raise AssertionError(f"the cached relation: {cache}")
    t0 = time.perf_counter()
    plain = LH.plain_rollup(ds_tables[LH.FACT], ds_tables[LH.DIM])
    plain_rollup_s = time.perf_counter() - t0
    if res["rollup"] != plain:
        raise AssertionError("the ROLLUP differs from pyarrow's group-bys")
    if res["rollup_rows_in"] != 3 * ds_tables[LH.FACT].num_rows:
        raise AssertionError(f"Expand gave {res['rollup_rows_in']} rows")
    bloom = res.pop("bloom")
    bloom.pop("bits")
    bloom.pop("mask")
    if bloom["false_negatives"]:
        raise AssertionError(f"the bloom filter has {bloom['false_negatives']}"
                             f" false negatives")
    res.pop("zorder")
    ml = res["ml"]
    if not (ml["equal"] and ml["device"] == "cuda"):
        raise AssertionError(f"the feature matrix: {ml}")
    t1 = time.perf_counter()
    cpu = {p: pending[p].get(timeout=900) for p in pending}
    waited = time.perf_counter() - t1
    ok, why = Q.check_rows("q3", res["q3_v5"], cpu["q3"][0])
    if not ok:
        raise AssertionError(f"lakehouse q3 over Delta differs from the CPU "
                             f"engine ({why})")
    cpu_digests = {}
    for p in LH.CLUSTERING_PARTS:
        cpu_digests.update(cpu[p][0])
    if cpu_digests != res["digests"]:
        raise AssertionError("the bloom filter or Z-order on the card "
                             "differs from the CPU's run")
    MemoryChecks().check()
    memo1 = plan_cache.counters()
    out = {"walls": walls, "warm_q3_v5_s": warm, "memo_hits_warm": hits,
           "memo": {k: memo1[k] - memo0[k] for k in memo1},
           "versions": res["versions"], "snapshots": snaps,
           "rows_read": rows_read, "files_rewritten": res["files_rewritten"],
           "iceberg_scan": res["iceberg_scan"], "cache": cache,
           "rollup_rows": len(plain), "rollup_rows_in": res["rollup_rows_in"],
           "plain_rollup_s": plain_rollup_s, "bloom": bloom,
           "ml": ml, "query_launches": launches, "launches": total,
           "probe_calls_checked": probe_calls[0],
           "largest_probe": largest.get("args"),
           "cpu_s": {p: cpu[p][1] for p in cpu}, "waited_s": waited,
           "q3_rows": {k: len(res[k]) for k in ("q3_v5", "q3_v3",
                                                  "q3_iceberg")},
           "wall_s": time.perf_counter() - t_phase}
    log(f"lakehouse: Delta versions {res['versions']} (records "
        f"{[snaps[v]['num_records'] for v in range(6)]}, {snaps[4]['dv_rows']}"
        f" rows deleted by deletion vectors, {res['files_rewritten']} files "
        f"rewritten), item {rows_read['item']} rows; q3 at version 5 equals "
        f"the CPU engine's, at version 3 phase 6's, over Iceberg phase 21's; "
        f"warm q3 over Delta {warm:.4f}s (memo hits {hits}); Iceberg scan "
        f"{res['iceberg_scan']}; cache {cache['bytes']} B for "
        f"{cache['arrow_bytes']} B of Arrow, decode "
        f"{cache['decode_ns'] / 1e6:.1f} ms; ROLLUP {len(plain)} rows from "
        f"{res['rollup_rows_in']} equal pyarrow's; bloom "
        f"{bloom['members']} members, no false negative, false positives "
        f"{bloom['false_positive_share']:.6f}, bits and mask equal the CPU's;"
        f" Z-order and Hilbert equal the CPU's; feature matrix {ml['shape']} "
        f"on the card equal; walls {json.dumps(walls)}; launches {total}; "
        f"memo {out['memo']}; CPU parts {json.dumps(out['cpu_s'])}, waited "
        f"{waited:.2f}s")
    log(f"probe: all {probe_calls[0]} calls of phase 22 equal the plain "
        f"version ({total} launches)")
    return out


def tpch_plan(q, frames):
    from spark_rapids_tpu_torch.bench import tpch

    return counted_plan(tpch.DF_QUERIES[q](frames))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=2.0)
    ap.add_argument("--sf-ds", type=float, default=1.0,
                    help="TPC-DS scale factor (q44/q67, the headline and the "
                         "joins queries)")
    ap.add_argument("--out", default="",
                    help="also write the full record as JSON to this path")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from spark_rapids_tpu_torch import native
    from spark_rapids_tpu_torch.exec import kernels as K

    t_all = time.perf_counter()
    memo_log = MemoLog()
    mem_checks = MemoryChecks()
    mem_checks.install()
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    import pyarrow

    log(f"device: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} pyarrow {pyarrow.__version__} | {kind} "
        f"x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    libs = native.build_all()
    for src in native.SOURCES:
        native.load(src)
    build_s = time.perf_counter() - t0
    log(f"built {len(libs)} kernel librar{'y' if len(libs) == 1 else 'ies'} "
        f"in {build_s:.1f}s")

    shapes = []
    for i, name in enumerate(("q3_lineitem", "duplicate_heavy",
                              "near_full")):
        shapes.append(check_probe(name, *synthetic_probe_inputs(
            name, 100 + i, "cuda")))

    scan_shapes = check_segscan_shapes()
    scan_stress = check_segscan_stress()
    scan_big = check_segscan_beyond_l2()
    probe_big = check_probe("beyond_l2", *beyond_l2_probe_inputs("cuda"))
    torch.cuda.empty_cache()

    main_res = run_main_path(args.sf)
    memo_log.mark("phase 4")
    ds_tables = tpcds_tables(args.sf_ds)
    ds_res = run_tpcds_path(ds_tables)
    memo_log.mark("phase 5")
    head_res = run_headline_path(ds_tables)
    memo_log.mark("phase 6")
    joins_res = run_joins_path(ds_tables)
    memo_log.mark("phase 7")

    tbl, h1, h2, capacity, seed = main_res.pop("largest_probe")
    real = check_probe("main_path_largest", tbl, h1, h2, capacity, seed,
                       cold=True)
    shapes.append(real)
    shapes.append(check_probe("headline_largest",
                              *head_res.pop("largest_probe"), cold=True))
    joins_probe = check_probe("joins_largest",
                              *joins_res.pop("largest_probe"), cold=True)
    shapes.append(joins_probe)
    scan_real = check_segscan_main_input(*ds_res.pop("largest_segscan"))
    torch.cuda.synchronize()

    from spark_rapids_tpu_torch.bench import tpcds_queries as Q

    # phase 9: the breadth slice (mixed plans allowed and printed)
    breadth_res = run_query_slice(ds_tables, args.sf_ds, Q.BREADTH,
                                  "breadth", device_only=False, warm_reps=1)
    breadth_probe = check_probe("breadth_largest",
                                *breadth_res.pop("largest_table_probe"),
                                cold=True)
    shapes.append(breadth_probe)
    shapes.append(check_probe("breadth_most_rows",
                              *breadth_res.pop("largest_probe"), cold=True))
    headline_rows = head_res.pop("rows")
    join_rows = dict(headline_rows)
    join_rows.update({q: r for q, r in joins_res.pop("rows").items()
                      if q != "q9"})
    join_rows.update(breadth_res.pop("rows"))
    sorted_res = run_sorted_hash(ds_tables, join_rows)
    memo_log.mark("phase 9")

    # the window-surface pass's CPU-engine run overlaps phases 10-12
    surface_check = start_window_surface_check(ds_tables)
    union_res = run_query_slice(
        ds_tables, args.sf_ds, Q.UNION_SLICE, "union", device_only=False,
        extra=lambda d, cpu: q76_with_null_promotions(ds_tables))
    union_probe = check_probe("union_largest",
                              *union_res.pop("largest_table_probe"),
                              cold=True)
    shapes.append(union_probe)
    union_rows = union_res.pop("rows")
    sorted_res.update(run_sorted_hash(ds_tables, {
        q: union_rows[q] for q in Q.CONDITION_JOINS}))
    memo_log.mark("phase 10")

    dec_res = run_query_slice(
        ds_tables, args.sf_ds,
        list(Q.DECIMAL_SLICE) + list(Q.WIDE_AVERAGES), "decimal",
        device_only=True, scan_queries=DECIMAL_WINDOWS,
        extra=q24_threshold_check)
    dec_probe = check_probe("decimal_largest",
                            *dec_res.pop("largest_table_probe"), cold=True)
    shapes.append(dec_probe)
    dec_rows = dec_res.pop("rows")
    sorted_res.update(run_sorted_hash(ds_tables, dec_rows))
    divide_res = decimal_divide_cost()
    memo_log.mark("phase 11")

    win_res = run_query_slice(ds_tables, args.sf_ds, Q.WINDOW_SLICE,
                              "window", device_only=True,
                              scan_queries=Q.WINDOW_SLICE)
    win_probe = check_probe("window_rest_largest",
                            *win_res.pop("largest_table_probe"), cold=True)
    shapes.append(win_probe)
    sorted_res.update(run_sorted_hash(ds_tables, win_res.pop("rows")))
    surface_res = window_surface_pass(ds_tables, surface_check)
    memo_log.mark("phase 12")

    part_res = run_partitioned_path(main_res.pop("tables"), ds_tables)
    part_probe = check_probe("partitioned_largest",
                             *part_res.pop("largest_table_probe"), cold=True)
    shapes.append(part_probe)
    memo_log.mark("phase 13")

    # phase 14: adaptive reads and reuse against the three switches off
    t_adaptive = time.perf_counter()
    adaptive_res = run_adaptive_path(
        ds_tables, [(union_res, union_rows), (dec_res, dec_rows)], part_res)
    adaptive_res["wall_s"] = time.perf_counter() - t_adaptive
    log(f"phase 14 took {adaptive_res['wall_s']:.1f}s")
    memo_log.mark("phase 14")
    # phase 15: the memory path
    memory_res = run_memory_path(ds_tables, part_res)
    log(f"phase 15 took {memory_res['wall_s']:.1f}s; the pool empty, the "
        f"leak sweep clean and no spill file after each of "
        f"{mem_checks.checked} queries")
    memo_log.mark("phase 15")
    for k in ("four", "cases", "rows", "frames"):
        part_res.pop(k)
    # phase 16: the typed store_sales pass
    checked_before = mem_checks.checked
    typed_res = run_typed_path(ds_tables)
    typed_probe = check_probe("typed_largest",
                              *typed_res.pop("largest_probe"), cold=True)
    shapes.append(typed_probe)
    log(f"phase 16 took {typed_res['wall_s']:.1f}s; the pool empty, the "
        f"leak sweep clean and no spill file after each of "
        f"{mem_checks.checked - checked_before} queries")
    memo_log.mark("phase 16")
    # phase 17: the statistics pass
    checked_before = mem_checks.checked
    stat_res = run_stat_path(ds_tables)
    stat_probe = check_probe("stat_largest", *stat_res.pop("largest_probe"),
                             cold=True)
    shapes.append(stat_probe)
    stat_scan = check_stat_scan(*stat_res.pop("largest_scan"))
    log(f"phase 17 took {stat_res['wall_s']:.1f}s; the pool empty, the "
        f"leak sweep clean and no spill file after each of "
        f"{mem_checks.checked - checked_before} queries")
    memo_log.mark("phase 17")
    # phase 18: the scalar sales pass
    checked_before = mem_checks.checked
    # phase 19's CPU-engine checks start beside phase 18's (they take
    # tens of seconds on the host's CPU)
    string_state = {}
    scalar_res = run_scalar_path(ds_tables, started=lambda t: string_state.
                                 update(start_string_checks(
                                     ds_tables, t["untyped_store_sales"])))
    scalar_probe = check_probe("scalar_largest",
                               *scalar_res.pop("largest_probe"), cold=True)
    shapes.append(scalar_probe)
    scalar_scan = check_stat_scan(*scalar_res.pop("largest_scan"),
                                  shape="scalar_largest", phase="phase 18")
    log(f"phase 18 took {scalar_res['wall_s']:.1f}s; the pool empty, the "
        f"leak sweep clean and no spill file after each of "
        f"{mem_checks.checked - checked_before} queries")
    memo_log.mark("phase 18")
    # phase 19: the string sales pass
    checked_before = mem_checks.checked
    string_res = run_string_path(string_state)
    string_probe = check_probe("string_largest",
                               *string_res.pop("largest_probe"), cold=True)
    shapes.append(string_probe)
    string_scan = check_stat_scan(*string_res.pop("largest_scan"),
                                  shape="string_largest", phase="phase 19")
    log(f"phase 19 took {string_res['wall_s']:.1f}s; the pool empty, the "
        f"leak sweep clean and no spill file after each of "
        f"{mem_checks.checked - checked_before} queries")
    memo_log.mark("phase 19")
    # phase 20: the nested sales pass
    checked_before = mem_checks.checked
    nested_res = run_nested_path(ds_tables)
    nested_probe = check_probe("nested_largest",
                               *nested_res.pop("largest_probe"), cold=True)
    shapes.append(nested_probe)
    nested_scan = check_stat_scan(*nested_res.pop("largest_scan"),
                                  shape="nested_largest", phase="phase 20")
    log(f"phase 20 took {nested_res['wall_s']:.1f}s; the pool empty, the "
        f"leak sweep clean and no spill file after each of "
        f"{mem_checks.checked - checked_before} queries")
    memo_log.mark("phase 20")
    # phase 21: the Parquet pass
    checked_before = mem_checks.checked
    parquet_res = run_parquet_path(ds_tables, headline_rows)
    parquet_probe = check_probe("parquet_largest",
                                *parquet_res.pop("largest_probe"), cold=True)
    shapes.append(parquet_probe)
    log(f"phase 21 took {parquet_res['wall_s']:.1f}s; the pool empty, the "
        f"leak sweep clean and no spill file after each of "
        f"{mem_checks.checked - checked_before} queries")
    memo_log.mark("phase 21")
    # phase 22: the lakehouse pass
    checked_before = mem_checks.checked
    lake_res = run_lakehouse_path(ds_tables, parquet_res.pop("paths"),
                                  headline_rows, parquet_res.pop("q3_rows"))
    lake_probe = check_probe("lakehouse_largest",
                             *lake_res.pop("largest_probe"), cold=True)
    shapes.append(lake_probe)
    log(f"phase 22 took {lake_res['wall_s']:.1f}s; the pool empty, the "
        f"leak sweep clean and no spill file after each of "
        f"{mem_checks.checked - checked_before} queries")
    memo_log.mark("phase 22")
    from spark_rapids_tpu_torch.plan import plan_cache

    memo = plan_cache.counters()
    log(f"plan memo over the whole run: {memo['plan_cache_hit_total']} hits, "
        f"{memo['plan_cache_miss_total']} misses, "
        f"{memo['plan_cache_uncacheable_total']} uncacheable, "
        f"{memo['plan_cache_evict_total']} evictions, "
        f"{memo['plan_cache_size']} held at the end")

    by_path = {name: {"tpch": main_res["launches"][name],
                      "tpcds_windows": ds_res["launches"][name],
                      "tpcds_headline": head_res["launches"][name],
                      "tpcds_joins": joins_res["launches"][name],
                      "tpcds_breadth": breadth_res["launches"][name],
                      "tpcds_union": union_res["launches"][name],
                      "tpcds_decimal": dec_res["launches"][name],
                      "tpcds_window_rest": win_res["launches"][name],
                      "window_surface": surface_res["launches"][name],
                      "partitioned": part_res["launches"][name],
                      "adaptive": adaptive_res["launches"][name],
                      "memory": memory_res["launches"][name],
                      "typed_sales": typed_res["launches"][name],
                      "stat_sales": stat_res["launches"][name],
                      "scalar_sales": scalar_res["launches"][name],
                      "string_sales": string_res["launches"][name],
                      "nested_sales": nested_res["launches"][name],
                      "parquet_sales": parquet_res["launches"][name],
                      "lakehouse_sales": lake_res["launches"][name]}
               for name in main_res["launches"]}
    for name, paths in by_path.items():
        if sum(paths.values()) <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"main paths")
    kernels_line = {"kernels": [{
        "name": "hashtbl_probe", "route": "cuda", "source": PROBE_SOURCE,
        "replaces": PROBE_REPLACES,
        "replaces_fn": "probe_hash_table_pallas",
        "launches": sum(by_path["hashtbl_probe"].values()),
        "launches_by_path": by_path["hashtbl_probe"],
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": real["kernel_ms"], "kernel_ms": real["kernel_ms"],
        "call_ms": real["call_ms"], "cold_ms": real["cold_ms"],
        "plain_ms": real["plain_ms"], "bound_ms": real["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "joins_largest": {k: joins_probe[k] for k in (
            "probe_rows", "capacity", "table_keys", "kernel_ms", "cold_ms",
            "call_ms", "host_us", "plain_ms", "bound_ms")},
        "breadth_largest": {k: breadth_probe[k] for k in (
            "probe_rows", "capacity", "table_keys", "kernel_ms", "cold_ms",
            "call_ms", "host_us", "plain_ms", "bound_ms")},
        "breadth_calls_checked": breadth_res["probe_calls_checked"],
        "union_largest": {k: union_probe[k] for k in (
            "probe_rows", "capacity", "table_keys", "kernel_ms", "cold_ms",
            "call_ms", "host_us", "plain_ms", "bound_ms")},
        "union_calls_checked": union_res["probe_calls_checked"],
        "decimal_largest": {k: dec_probe[k] for k in (
            "probe_rows", "capacity", "table_keys", "kernel_ms", "cold_ms",
            "call_ms", "host_us", "plain_ms", "bound_ms")},
        "decimal_calls_checked": dec_res["probe_calls_checked"],
        "window_rest_largest": {k: win_probe[k] for k in (
            "probe_rows", "capacity", "table_keys", "kernel_ms", "cold_ms",
            "call_ms", "host_us", "plain_ms", "bound_ms")},
        "window_rest_calls_checked": win_res["probe_calls_checked"],
        "partitioned_largest": {k: part_probe[k] for k in (
            "probe_rows", "capacity", "table_keys", "kernel_ms", "cold_ms",
            "call_ms", "host_us", "plain_ms", "bound_ms")},
        "partitioned_calls_checked": part_res["probe_calls_checked"],
        "adaptive_calls_checked": adaptive_res["probe_calls_checked"],
        "memory_calls_checked": memory_res["probe_calls_checked"],
        "typed_largest": {k: typed_probe[k] for k in (
            "probe_rows", "capacity", "table_keys", "kernel_ms", "cold_ms",
            "call_ms", "host_us", "plain_ms", "bound_ms")},
        "typed_calls_checked": typed_res["probe_calls_checked"],
        "stat_largest": {k: stat_probe[k] for k in (
            "probe_rows", "capacity", "table_keys", "kernel_ms", "cold_ms",
            "call_ms", "host_us", "plain_ms", "bound_ms")},
        "stat_calls_checked": stat_res["probe_calls_checked"],
        "scalar_largest": {k: scalar_probe[k] for k in (
            "probe_rows", "capacity", "table_keys", "kernel_ms", "cold_ms",
            "call_ms", "host_us", "plain_ms", "bound_ms")},
        "scalar_calls_checked": scalar_res["probe_calls_checked"],
        "string_largest": {k: string_probe[k] for k in (
            "probe_rows", "capacity", "table_keys", "kernel_ms", "cold_ms",
            "call_ms", "host_us", "plain_ms", "bound_ms")},
        "string_calls_checked": string_res["probe_calls_checked"],
        "nested_largest": {k: nested_probe[k] for k in (
            "probe_rows", "capacity", "table_keys", "kernel_ms", "cold_ms",
            "call_ms", "host_us", "plain_ms", "bound_ms")},
        "nested_calls_checked": nested_res["probe_calls_checked"],
        "parquet_largest": {k: parquet_probe[k] for k in (
            "probe_rows", "capacity", "table_keys", "kernel_ms", "cold_ms",
            "call_ms", "host_us", "plain_ms", "bound_ms")},
        "parquet_calls_checked": parquet_res["probe_calls_checked"],
        "lakehouse_largest": {k: lake_probe[k] for k in (
            "probe_rows", "capacity", "table_keys", "kernel_ms", "cold_ms",
            "call_ms", "host_us", "plain_ms", "bound_ms")},
        "lakehouse_calls_checked": lake_res["probe_calls_checked"],
        "key_types": "int32 int64 double date decimal string tinyint "
                     "smallint float timestamp binary (the 64-bit key "
                     "hashes)",
        "exact": all(s["exact"] for s in shapes)}, {
        "name": "segscan", "route": "cuda", "source": SEGSCAN_SOURCE,
        "replaces": SEGSCAN_REPLACES,
        "replaces_fn": "segmented_scan_pallas",
        "launches": sum(by_path["segscan"].values()),
        "launches_by_path": by_path["segscan"],
        "max_abs_err": max(scan_real["max_abs_err"],
                           scan_shapes["float_add_max_abs_err"]),
        "ms": scan_real["kernel_ms"], "kernel_ms": scan_real["kernel_ms"],
        "call_ms": scan_real["call_ms"], "cold_ms": scan_real["cold_ms"],
        "plain_ms": scan_real["plain_ms"],
        "bound_ms": scan_real["bound_ms"], "bound_by": "bytes",
        "library_ms": scan_real["library_ms"],
        "library_call": "torch.cummax",
        "decimal_calls_checked": dec_res["segscan_calls_checked"],
        "window_rest_calls_checked": win_res["segscan_calls_checked"],
        "window_surface_calls_checked": surface_res[
            "segscan_calls_checked"],
        "window_min_scan": surface_res["min_scan"],
        "partitioned_calls_checked": part_res["segscan_calls_checked"],
        "adaptive_calls_checked": adaptive_res["segscan_calls_checked"],
        "memory_calls_checked": memory_res["segscan_calls_checked"],
        "typed_calls_checked": typed_res["segscan_calls_checked"],
        "stat_calls_checked": stat_res["segscan_calls_checked"],
        "stat_largest": {k: stat_scan[k] for k in (
            "rows", "dtype", "op", "heads", "kernel_ms", "cold_ms",
            "call_ms", "host_us", "plain_ms", "bound_ms", "max_abs_err")},
        "scalar_calls_checked": scalar_res["segscan_calls_checked"],
        "scalar_largest": {k: scalar_scan[k] for k in (
            "rows", "dtype", "op", "heads", "kernel_ms", "cold_ms",
            "call_ms", "host_us", "plain_ms", "bound_ms", "max_abs_err")},
        "string_calls_checked": string_res["segscan_calls_checked"],
        "string_largest": {k: string_scan[k] for k in (
            "rows", "dtype", "op", "heads", "kernel_ms", "cold_ms",
            "call_ms", "host_us", "plain_ms", "bound_ms", "max_abs_err")},
        "nested_calls_checked": nested_res["segscan_calls_checked"],
        "nested_largest": {k: nested_scan[k] for k in (
            "rows", "dtype", "op", "heads", "kernel_ms", "cold_ms",
            "call_ms", "host_us", "plain_ms", "bound_ms", "max_abs_err")},
        "value_types": "int32 int64 float32 float64 (int8 and int16 "
                       "widened to int32 by the wrapper)",
        "exact": scan_shapes["int_and_minmax_exact"]}]}
    record = {"device": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s,
              "sf": args.sf, "lineitem_rows": main_res["lineitem_rows"],
              "queries": main_res["queries"], "probe_shapes": shapes,
              "sf_ds": args.sf_ds,
              "store_sales_rows": ds_res["store_sales_rows"],
              "tpcds_queries": ds_res["queries"],
              "tpcds_headline": head_res["queries"],
              "tpcds_joins": joins_res["queries"],
              "tpcds_breadth": breadth_res["queries"],
              "tpcds_union": union_res["queries"],
              "tpcds_decimal": dec_res["queries"],
              "decimal_divide": divide_res,
              "tpcds_window_rest": win_res["queries"],
              "window_surface": surface_res,
              "partitioned": part_res["queries"],
              "adaptive": {k: v for k, v in adaptive_res.items()
                           if k != "launches"},
              "memory": {k: v for k, v in memory_res.items()
                         if k != "launches"},
              "typed_sales": {k: v for k, v in typed_res.items()
                              if k != "launches"},
              "stat_sales": {k: v for k, v in stat_res.items()
                             if k != "launches"},
              "segscan_stat": stat_scan,
              "scalar_sales": {k: v for k, v in scalar_res.items()
                               if k != "launches"},
              "segscan_scalar": scalar_scan,
              "string_sales": {k: v for k, v in string_res.items()
                               if k != "launches"},
              "segscan_string": string_scan,
              "nested_sales": {k: v for k, v in nested_res.items()
                               if k != "launches"},
              "segscan_nested": nested_scan,
              "parquet_sales": {k: v for k, v in parquet_res.items()
                                if k != "launches"},
              "lakehouse_sales": {k: v for k, v in lake_res.items()
                                  if k != "launches"},
              "plan_memo": memo, "plan_memo_by_phase": memo_log.by_phase,
              "queries_memory_checked": mem_checks.checked,
              "sorted_hash": sorted_res,
              "segscan_shapes": scan_shapes, "segscan_main": scan_real,
              "segscan_stress": scan_stress, "segscan_beyond_l2": scan_big,
              "probe_beyond_l2": probe_big,
              "kernels": kernels_line["kernels"],
              "total_s": time.perf_counter() - t_all}
    stop_check_workers()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(kernels_line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
