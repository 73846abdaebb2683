"""ODPS (MaxCompute) table writer: prediction outputs back to a table
(counterpart of elasticdl_tpu/data/odps_writer.py).

The output table is created or reused, and each worker streams its rows
into its own `worker=<id>` partition, in chunked writes retried with
backoff; a worker that loses the race to create the table adopts its
peer's. As in OdpsReader (data/odps_reader.py) the vendor SDK stays
behind `_default_client`, and the writer talks to any client with this
surface:
  exist_table(name) -> bool
  create_table(name, (cols_ddl, partition_ddl)) -> table
  get_table(name) -> table with
      open_writer(partition=..., create_partition=True), a context manager
      yielding an object with .write(rows)
The two-string schema ("c0 double, c1 double", "worker string") is
pyodps' documented lightweight create_table signature.

Delivery is AT-LEAST-ONCE: a chunk retried after a lost commit
acknowledgement writes the chunk again, and a prediction task that runs
again appends its rows again. Consumers that need exactly-once dedup on a
row key or truncate the `worker=<id>` partition before running a job
again.
"""

from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.data.odps_reader import _default_client, retrying
from elasticdl_tpu_torch.worker.prediction_outputs_processor import (
    BasePredictionOutputsProcessor,
)

logger = get_logger("data.odps_writer")

DEFAULT_WRITE_CHUNK_ROWS = 4096
DEFAULT_MAX_RETRIES = 3


class OdpsWriter:
    """Writes rows (lists of column values) into one ODPS table, one
    partition per worker — so N prediction workers stream concurrently
    without write conflicts."""

    def __init__(
        self,
        project=None,
        access_id=None,
        access_key=None,
        endpoint=None,
        table=None,
        columns=None,
        column_types=None,
        chunk_rows=DEFAULT_WRITE_CHUNK_ROWS,
        max_retries=DEFAULT_MAX_RETRIES,
        retry_base_seconds=0.5,
        client=None,
    ):
        if not table:
            raise ValueError("OdpsWriter requires a table name")
        if "." in table:
            # The "project.table" shorthand.
            project, table = table.split(".", 1)
        self._project = project
        self._table_name = table
        self._columns = list(columns) if columns else None
        self._column_types = list(column_types) if column_types else None
        self._chunk_rows = max(1, int(chunk_rows))
        self._max_retries = max(1, int(max_retries))
        self._retry_base_seconds = retry_base_seconds
        self._client = client or _default_client(
            project, access_id, access_key, endpoint
        )
        self._table = None

    def _retrying(self, fn, what):
        return retrying(
            fn, what, self._max_retries, self._retry_base_seconds,
            log=logger,
        )

    def _ensure_table(self):
        """Reuse the table when it exists; otherwise create it partitioned
        by worker (string), which requires explicit columns/types.
        Creation is raced by concurrent
        workers starting against a missing table: on ANY create failure,
        re-check existence and fall back to get_table — the winner's
        table is what everyone wanted (blindly retrying create_table
        would keep failing with already-exists until retries exhaust)."""
        if self._table is not None:
            return self._table
        if self._client.exist_table(self._table_name):
            self._table = self._client.get_table(self._table_name)
            return self._table
        if not self._columns or not self._column_types:
            raise ValueError(
                f"table {self._table_name!r} does not exist; creating it "
                "requires columns and column_types"
            )
        if len(self._columns) != len(self._column_types):
            raise ValueError(
                f"{len(self._columns)} columns vs "
                f"{len(self._column_types)} column_types"
            )
        cols_ddl = ", ".join(
            f"{c} {t}" for c, t in zip(self._columns, self._column_types)
        )

        def create_or_adopt():
            try:
                return self._client.create_table(
                    self._table_name, (cols_ddl, "worker string")
                )
            except Exception:
                if self._client.exist_table(self._table_name):
                    logger.info(
                        "Table %s appeared while creating it (peer "
                        "worker won the race); using it",
                        self._table_name,
                    )
                    return self._client.get_table(self._table_name)
                raise

        self._table = self._retrying(create_or_adopt, "create table")
        logger.info(
            "Created ODPS table %s (%s) partitioned by worker",
            self._table_name,
            cols_ddl,
        )
        return self._table

    def from_iterator(self, rows_iter, worker_index):
        """Stream rows into partition worker=<worker_index>. Rows are
        buffered into chunks so one upload call covers thousands of rows
        (per-row tunnel writes are the slow path), each chunk retried
        independently (at-least-once — see the module docstring).
        Returns the number of rows written."""
        partition = f"worker={worker_index}"
        written = 0
        chunk = []
        for row in rows_iter:
            chunk.append(list(row))
            if len(chunk) >= self._chunk_rows:
                self._write_chunk(partition, chunk)
                written += len(chunk)
                chunk = []
        if chunk:
            self._write_chunk(partition, chunk)
            written += len(chunk)
        logger.info(
            "Wrote %d rows to %s/%s", written, self._table_name, partition
        )
        return written

    def _write_chunk(self, partition, chunk):
        table = self._ensure_table()

        # A fresh writer session per attempt: like the reader, an
        # expired/broken tunnel session is the common failure, and
        # re-entering open_writer mints a new one.
        def attempt():
            with table.open_writer(
                partition=partition, create_partition=True
            ) as w:
                w.write(chunk)

        self._retrying(attempt, f"write {len(chunk)} rows")


class OdpsPredictionOutputsProcessor(BasePredictionOutputsProcessor):
    """Prediction-outputs processor writing each worker's model outputs to
    an ODPS table.

    The worker calls process() once per MINIBATCH (worker.py
    _process_predict_batch), so rows are buffered here across calls and
    flushed in writer-chunk-sized uploads — without this, a 1M-row job
    at minibatch 16 would open ~62k tunnel sessions. The worker calls
    close() when the prediction task stream ends; anything still
    buffered flushes then. `columns` default to f0..f{n-1} doubles
    inferred from the first batch's width when the table must be
    created."""

    def __init__(self, writer=None, table=None, columns=None,
                 column_types=None, client=None, **writer_kwargs):
        if writer is not None:
            self._writer = writer
        else:
            self._writer = OdpsWriter(
                table=table,
                columns=columns,
                column_types=column_types,
                client=client,
                **writer_kwargs,
            )
        self._buffer = []
        self._worker_id = None

    def process(self, predictions, worker_id):
        import numpy as np

        arr = np.asarray(predictions)
        if arr.ndim == 1:
            arr = arr[:, None]
        arr = arr.reshape(arr.shape[0], -1)
        w = self._writer
        if w._columns is None:
            w._columns = [f"f{i}" for i in range(arr.shape[1])]
            w._column_types = ["double"] * arr.shape[1]
        self._worker_id = worker_id
        self._buffer.extend(arr.tolist())
        if len(self._buffer) >= w._chunk_rows:
            self.flush()

    def flush(self):
        if not self._buffer:
            return 0
        rows, self._buffer = self._buffer, []
        try:
            return self._writer.from_iterator(iter(rows), self._worker_id)
        except Exception:
            # The buffer holds rows from tasks already reported done;
            # dropping them on a failed write would be at-most-once (the
            # master only re-dispatches the CURRENT task). Restore so the
            # next flush/close retries them — at-least-once as documented.
            self._buffer = rows + self._buffer
            raise

    def close(self):
        """Flush any buffered rows; the worker calls this after its last
        prediction task."""
        return self.flush()
