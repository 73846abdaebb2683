"""Parallelism for the elastic AllReduce trainer (counterpart of
elasticdl_tpu/parallel/): the world-spec ladder and batch padding
(mesh.py), one process group per membership epoch and the intra-process
axis groups (distributed.py), rank 0's state broadcast (broadcast.py),
the differentiable collectives (collectives.py), tensor and expert
parallelism (tensor_parallel.py), ring, zigzag and Ulysses attention
(ring_attention.py, ulysses.py), and a process's shards (shards.py)."""
