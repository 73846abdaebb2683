"""Sharded, reshardable PS checkpoints (counterpart of
elasticdl_tpu/ps/checkpoint.py:39-199; the format is the JAX package's, so
a shard saved by either package restores in the other).

Layout: `<dir>/version-<V>/variables-<i>-of-<N>.ckpt`, one serialized Model
per PS shard, and a `meta-<i>-of-<N>.json` sidecar with the consumed-record
count. A checkpoint is valid iff the complete shard set is present; restore
reshards (dense params by name hash, embedding ids by modulo) so a job can
come back with another shard count; keep_checkpoint_max prunes old
versions.
"""

import json
import os
import re
import shutil

import numpy as np

from elasticdl_tpu_torch.common import hash_utils, tensor_utils
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.proto import messages as pb

logger = get_logger("ps.checkpoint")

_SHARD_RE = re.compile(r"variables-(\d+)-of-(\d+)\.ckpt$")


def _version_dir(checkpoint_dir, version):
    return os.path.join(checkpoint_dir, f"version-{version}")


def _shard_path(checkpoint_dir, version, ps_id, num_ps):
    return os.path.join(
        _version_dir(checkpoint_dir, version),
        f"variables-{ps_id}-of-{num_ps}.ckpt",
    )


def _meta_path(checkpoint_dir, version, ps_id, num_ps):
    return os.path.join(
        _version_dir(checkpoint_dir, version),
        f"meta-{ps_id}-of-{num_ps}.json",
    )


class CheckpointSaver:
    def __init__(self, checkpoint_dir, ps_id, num_ps, keep_checkpoint_max=3):
        self._dir = checkpoint_dir
        self._ps_id = ps_id
        self._num_ps = num_ps
        self._keep_max = keep_checkpoint_max
        os.makedirs(checkpoint_dir, exist_ok=True)

    def snapshot(self, version, parameters):
        """A consistent Model of the store. Callers that share the store
        with concurrent writers hold the version lock here (and may release
        it before save_snapshot, which only does I/O)."""
        model = parameters.to_model_pb(include_embeddings=True)
        model.version = version
        return model

    def save(self, version, parameters):
        """Snapshot + write in one call (single-writer callers only)."""
        self.save_snapshot(version, self.snapshot(version, parameters))

    def save_snapshot(self, version, model):
        """Write this shard's file for `version` (atomic rename), then GC."""
        os.makedirs(_version_dir(self._dir, version), exist_ok=True)
        path = _shard_path(self._dir, version, self._ps_id, self._num_ps)
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as f:
            f.write(model.SerializeToString())
        os.replace(tmp, path)
        # Sidecar: a resuming master reads the consumed-record count without
        # parsing the shard.
        meta = _meta_path(self._dir, version, self._ps_id, self._num_ps)
        with open(f"{meta}.tmp", "w") as f:
            json.dump(
                {"version": version, "total_records": model.total_records},
                f,
            )
        os.replace(f"{meta}.tmp", meta)
        logger.info("Saved checkpoint shard %s", path)
        self._gc()

    def _gc(self):
        versions = list_checkpoint_versions(self._dir)
        for stale in versions[: -self._keep_max] if self._keep_max else []:
            shutil.rmtree(_version_dir(self._dir, stale), ignore_errors=True)
            logger.info("Pruned checkpoint version-%d", stale)


def list_checkpoint_versions(checkpoint_dir):
    versions = []
    if not os.path.isdir(checkpoint_dir):
        return versions
    for entry in os.listdir(checkpoint_dir):
        m = re.fullmatch(r"version-(\d+)", entry)
        if m:
            versions.append(int(m.group(1)))
    return sorted(versions)


def is_complete(checkpoint_dir, version):
    """Valid iff all N shard files of one write are present."""
    vdir = _version_dir(checkpoint_dir, version)
    if not os.path.isdir(vdir):
        return False
    shards = {}
    for entry in os.listdir(vdir):
        m = _SHARD_RE.fullmatch(entry)
        if m:
            shards[int(m.group(1))] = int(m.group(2))
    if not shards:
        return False
    n = next(iter(shards.values()))
    return set(shards) == set(range(n)) and all(
        v == n for v in shards.values()
    )


def latest_complete_version(checkpoint_dir):
    for version in reversed(list_checkpoint_versions(checkpoint_dir)):
        if is_complete(checkpoint_dir, version):
            return version
    return None


def _read_model(path):
    with open(path, "rb") as f:
        return pb.Model.FromString(f.read())


def read_total_records(checkpoint_dir, version):
    """Max total_records across a checkpoint's shards: the exact count of
    training records consumed when it was written. Reads the meta
    sidecars; falls back to parsing the shards (checkpoints without
    sidecars). 0 when absent."""
    vdir = _version_dir(checkpoint_dir, version)
    total = 0
    found_meta = False
    for entry in sorted(os.listdir(vdir)):
        if entry.startswith("meta-") and entry.endswith(".json"):
            with open(os.path.join(vdir, entry)) as f:
                total = max(total, json.load(f).get("total_records", 0))
            found_meta = True
    if found_meta:
        return total
    for entry in sorted(os.listdir(vdir)):
        if _SHARD_RE.fullmatch(entry):
            model = _read_model(os.path.join(vdir, entry))
            total = max(total, model.total_records)
    return total


def restore_shard(checkpoint_dir, version, parameters, ps_id, num_ps):
    """Load `parameters` for PS shard `ps_id` of `num_ps` from a checkpoint
    written by ANY shard count: reads every saved shard file and keeps what
    hashes to this shard (dense by name hash, ids by modulo)."""
    vdir = _version_dir(checkpoint_dir, version)
    if not is_complete(checkpoint_dir, version):
        raise ValueError(f"incomplete or missing checkpoint at {vdir}")
    with parameters.init_lock:
        for entry in sorted(os.listdir(vdir)):
            if not _SHARD_RE.fullmatch(entry):
                continue
            model = _read_model(os.path.join(vdir, entry))
            parameters.init_embedding_infos(model.embedding_table_infos)
            parameters.total_records = max(
                parameters.total_records, model.total_records
            )
            for t in model.dense_parameters:
                if hash_utils.string_to_id(t.name, num_ps) != ps_id:
                    continue
                parameters.dense[t.name] = np.ascontiguousarray(
                    tensor_utils.tensor_pb_to_ndarray(t), dtype=np.float32
                )
            for name, slices in model.embedding_tables.items():
                values, ids = tensor_utils.indexed_slices_pb_to_ndarrays(
                    slices
                )
                mask = (ids % num_ps) == ps_id
                if mask.any():
                    parameters.embedding_tables[name].assign(
                        ids[mask], values[mask]
                    )
        parameters.version = version
        parameters.initialized = True
    logger.info(
        "Restored shard %d/%d from %s: %d dense, %d tables",
        ps_id, num_ps, vdir, len(parameters.dense),
        len(parameters.embedding_tables),
    )
