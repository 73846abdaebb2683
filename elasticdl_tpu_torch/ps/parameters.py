"""The PS shard's model store: dense numpy parameters and embedding tables
(counterpart of elasticdl_tpu/ps/parameters.py:22-89).

Dense parameters are float32 numpy arrays, updated in place by the host
library; embedding tables are slab-backed (ps/embedding_table.py).
Initialization happens once, from the first worker's push_model. That lazy
init is also how a shard recovers: a restarted empty shard is re-seeded by
whichever worker finds initialized=False on its next pull.
"""

import threading

import numpy as np

from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.ps.embedding_table import EmbeddingTable


class Parameters:
    def __init__(self):
        self.dense = {}  # name -> np.ndarray (float32, contiguous)
        self.embedding_tables = {}  # name -> EmbeddingTable
        self.version = 0
        # Training records behind accepted gradient pushes so far;
        # checkpointed for exact resume fast-forwarding.
        self.total_records = 0
        self.initialized = False
        self.init_lock = threading.Lock()

    def init_from_model_pb(self, model_pb):
        """First-push initialization; later pushes are no-ops. Returns True
        iff this call performed the init."""
        with self.init_lock:
            if self.initialized:
                return False
            self.init_embedding_infos(model_pb.embedding_table_infos)
            for t in model_pb.dense_parameters:
                self.dense[t.name] = np.ascontiguousarray(
                    tensor_utils.tensor_pb_to_ndarray(t), dtype=np.float32
                )
            for name, slices in model_pb.embedding_tables.items():
                values, ids = tensor_utils.indexed_slices_pb_to_ndarrays(
                    slices
                )
                self.embedding_tables[name].assign(ids, values)
            self.version = model_pb.version
            self.initialized = True
            return True

    def init_embedding_infos(self, infos):
        for info in infos:
            if info.name not in self.embedding_tables:
                self.embedding_tables[info.name] = EmbeddingTable(
                    info.name,
                    info.dim,
                    initializer=info.initializer or "uniform",
                )

    def to_model_pb(self, include_embeddings=True):
        model = pb.Model(
            version=self.version,
            total_records=self.total_records,
        )
        for name in sorted(self.dense):
            model.dense_parameters.append(
                tensor_utils.ndarray_to_tensor_pb(self.dense[name], name)
            )
        for name in sorted(self.embedding_tables):
            table = self.embedding_tables[name]
            model.embedding_table_infos.append(
                pb.EmbeddingTableInfo(
                    name=name,
                    dim=table.dim,
                    initializer=table.initializer,
                    dtype=pb.DT_FLOAT32,
                )
            )
            if include_embeddings and len(table):
                ids, values = table.export_rows()
                model.embedding_tables[name] = (
                    tensor_utils.ndarray_to_indexed_slices_pb(
                        values, ids, name
                    )
                )
        return model
