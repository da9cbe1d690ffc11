"""Columnar shuffle (counterpart of spark_rapids_tpu/shuffle/): the kudo
wire format (``serializer``) with its integrity trailer (``integrity``),
device-side partitioners (``partition``), the multithreaded shuffle
manager with its CACHE_ONLY mode (``manager``), the exchange operator
with its read-ahead (``exchange_exec``) and the adaptive readers that
coalesce and skew-split its reduce partitions (``aqe``)."""
