"""Data parallelism across processes for the elastic AllReduce trainer
(counterpart of elasticdl_tpu/parallel/, its data-parallel part): batch
padding and the world fingerprint (mesh.py), one process group per
membership epoch (distributed.py) and rank 0's state broadcast
(broadcast.py)."""
