"""PyTorch/CUDA port of the spark_rapids_tpu engine.

The JAX package ``spark_rapids_tpu`` stays the reference; this package
mirrors its module layout (types, config, columnar, exprs, exec, plan,
bench) with torch tensors on an explicit device. Entry point:
``spark_rapids_tpu_torch.plan.from_arrow(table, device=...)``, which puts
batches on ``cuda`` unless the caller names another device.

The hash-table probe of every join runs in a hand-written CUDA kernel
(``csrc/hashtbl_probe.cu``, loaded by ``native.py``); on CPU tensors the
same wrapper runs its plain torch version.
"""
