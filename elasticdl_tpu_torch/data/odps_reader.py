"""ODPS (MaxCompute) table reader (counterpart of
elasticdl_tpu/data/odps_reader.py).

Shard creation from the table's row count, ordered parallel page fetches
and per-page retries with backoff, as plain Python over any client with
the narrow pyodps surface the reader needs:
`get_table(name).open_reader(partition=...)` -> an object with `.count`
and `.read(start=, count=)` yielding records with `.values`. In production
that client is `odps.ODPS(...)` (pyodps, imported only inside
`_default_client`); tests inject a fake.

Origin URI (create_data_reader): odps://<project>/tables/<table>[/<part>]
with credentials from the environment (ODPS_ACCESS_ID, ODPS_ACCESS_KEY,
ODPS_ENDPOINT).
"""

import concurrent.futures
import os
import time

from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.data.reader import AbstractDataReader, Metadata

logger = get_logger("data.odps_reader")

DEFAULT_PAGE_RECORDS = 4096
DEFAULT_MAX_RETRIES = 3


def retrying(fn, what, max_retries, base_seconds, log=logger):
    """Run fn() up to max_retries times with exponential backoff — the
    one retry policy shared by the ODPS reader and writer."""
    for attempt in range(max_retries):
        try:
            return fn()
        except Exception:
            if attempt == max_retries - 1:
                raise
            delay = base_seconds * (2 ** attempt)
            log.warning(
                "ODPS %s failed (attempt %d/%d); retrying in %.1fs",
                what, attempt + 1, max_retries, delay,
                exc_info=True,
            )
            time.sleep(delay)


def _default_client(project, access_id, access_key, endpoint):
    try:
        from odps import ODPS  # pyodps, not baked into this image
    except ImportError as e:
        raise ImportError(
            "ODPS reading needs the pyodps package (`pip install pyodps`) "
            "or an injected client object"
        ) from e
    return ODPS(access_id, access_key, project=project, endpoint=endpoint)


class OdpsReader(AbstractDataReader):
    """Reads one ODPS table (optionally one partition) as record tuples.

    Records are yielded in table order as lists of column values — the
    same shape CSVDataReader yields — with column names in `metadata`,
    so a model's `feed` is reader-agnostic.
    """

    def __init__(
        self,
        project=None,
        access_id=None,
        access_key=None,
        endpoint=None,
        table=None,
        partition=None,
        columns=None,
        num_parallel=4,
        page_records=DEFAULT_PAGE_RECORDS,
        max_retries=DEFAULT_MAX_RETRIES,
        retry_base_seconds=0.5,
        client=None,
        **kwargs,
    ):
        super().__init__(**kwargs)
        if not table:
            raise ValueError("OdpsReader requires a table name")
        self._project = project
        self._table_name = table
        self._partition = partition or None
        self._columns = list(columns) if columns else None
        self._num_parallel = max(1, int(num_parallel))
        self._page_records = max(1, int(page_records))
        self._max_retries = max(1, int(max_retries))
        self._retry_base_seconds = retry_base_seconds
        self._client = client or _default_client(
            project, access_id, access_key, endpoint
        )
        self._metadata = None

    # ---------- shard creation (master side) ----------

    def _open_reader(self):
        table = self._client.get_table(self._table_name)
        if self._partition:
            return table.open_reader(partition=self._partition)
        return table.open_reader()

    def create_shards(self):
        """One logical shard spanning the table or partition; the
        master's task dispatcher cuts it into records_per_task ranges as it
        does for record files."""
        count = self._retrying(
            lambda: int(self._open_reader().count), "row count"
        )
        name = self._table_name + (
            f"/{self._partition}" if self._partition else ""
        )
        return {name: (0, count)}

    # ---------- record reading (worker side) ----------

    @property
    def metadata(self):
        if self._metadata is None:
            columns = self._columns
            if columns is None:
                try:
                    columns = self._retrying(
                        lambda: [
                            c.name
                            for c in self._client.get_table(
                                self._table_name
                            ).schema.columns
                        ],
                        "schema",
                    )
                except Exception:
                    # Schema introspection is best-effort (a client may
                    # not expose it at all) — but do NOT cache the empty
                    # answer: a transient failure here would otherwise
                    # poison every later feed that maps columns by name.
                    logger.warning(
                        "ODPS schema introspection failed; column names "
                        "unavailable this time", exc_info=True,
                    )
                    return Metadata(column_names=[])
            self._metadata = Metadata(column_names=columns)
        return self._metadata

    def read_records(self, task):
        """Yield the task's [start, end) rows in order. Pages of
        `page_records` rows are fetched by a small thread pool with a
        bounded look-ahead, each page retried on its own."""
        start, end = int(task.start), int(task.end)
        if end <= start:
            return
        pages = [
            (s, min(self._page_records, end - s))
            for s in range(start, end, self._page_records)
        ]
        if len(pages) == 1 or self._num_parallel == 1:
            for s, n in pages:
                yield from self._read_page(s, n)
            return
        with concurrent.futures.ThreadPoolExecutor(
            max_workers=self._num_parallel
        ) as pool:
            # Ordered delivery with bounded look-ahead: keep up to
            # num_parallel pages in flight, always yielding the oldest.
            futures = {}
            next_submit = 0
            for next_yield in range(len(pages)):
                while (
                    next_submit < len(pages)
                    and next_submit - next_yield < self._num_parallel
                ):
                    futures[next_submit] = pool.submit(
                        self._read_page, *pages[next_submit]
                    )
                    next_submit += 1
                yield from futures.pop(next_yield).result()

    def _read_page(self, start, count):
        def fetch():
            # A fresh download session per attempt: expired/broken tunnel
            # sessions are the common ODPS failure mode.
            reader = self._open_reader()
            rows = []
            for record in reader.read(start=start, count=count):
                values = getattr(record, "values", record)
                rows.append(list(values))
            if len(rows) != count:
                raise IOError(
                    f"short page at {start}: got {len(rows)}/{count}"
                )
            return rows

        return self._retrying(fetch, f"page@{start}")

    def _retrying(self, fn, what):
        return retrying(
            fn, what, self._max_retries, self._retry_base_seconds
        )


def parse_odps_origin(origin):
    """odps://<project>/tables/<table>[/<partition>] -> kwargs dict with
    credentials resolved from the environment."""
    rest = origin[len("odps://"):]
    parts = rest.split("/")
    if len(parts) < 3 or parts[1] != "tables" or not parts[2]:
        raise ValueError(
            f"bad ODPS origin {origin!r}; expected "
            "odps://<project>/tables/<table>[/<partition>]"
        )
    return {
        "project": parts[0],
        "table": parts[2],
        "partition": "/".join(parts[3:]) or None,
        "access_id": os.environ.get("ODPS_ACCESS_ID"),
        "access_key": os.environ.get("ODPS_ACCESS_KEY"),
        "endpoint": os.environ.get("ODPS_ENDPOINT"),
    }
