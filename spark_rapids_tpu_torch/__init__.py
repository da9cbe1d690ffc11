"""PyTorch/CUDA port of the spark_rapids_tpu engine.

The JAX package ``spark_rapids_tpu`` stays the reference; this package
mirrors its module layout (types, config, columnar, exprs, exec, plan,
bench) with torch tensors on an explicit device. Entry point:
``spark_rapids_tpu_torch.plan.from_arrow(table, device=...)``, which puts
batches on ``cuda`` unless the caller names another device.

Two hand-written CUDA kernels, loaded by ``native.py``, replace the JAX
package's two TPU kernels: the hash-table probe of every join
(``csrc/hashtbl_probe.cu``) and the segmented scan that gives every window
its segment and peer geometry (``csrc/segscan.cu``). On CPU tensors the
same wrappers run their plain torch versions.
"""
