"""CIFAR-10 python-pickle batches -> .edlr record converter, offline
(counterpart of elasticdl_tpu/data/gen/cifar10_pickle.py).

Reads the standard "CIFAR-10 python version" batch files (pickled dicts
with b"data" as uint8 [N, 3072] channel-major rows and b"labels"), possibly
inside the distributed tar.gz, from local disk and writes Example records
the zoo's `cifar10_cnn.feed` consumes: {"image": uint8 [32, 32, 3] (NHWC),
"label": int64}.

CLI:
    python -m elasticdl_tpu_torch.data.gen.cifar10_pickle \
        --batches data_batch_1 data_batch_2 ... --output train.edlr
    python -m elasticdl_tpu_torch.data.gen.cifar10_pickle \
        --tar cifar-10-python.tar.gz --split train --output train.edlr
"""

import argparse
import pickle
import tarfile

import numpy as np

from elasticdl_tpu_torch.data.example import encode_example
from elasticdl_tpu_torch.data.recordfile import RecordFileWriter


def read_batch_file(path):
    """One pickle batch file -> (images uint8 [N, 32, 32, 3], labels)."""
    with open(path, "rb") as f:
        return _decode_batch(f)


def _decode_batch(fileobj):
    batch = pickle.load(fileobj, encoding="bytes")
    data = np.asarray(batch[b"data"], dtype=np.uint8)
    if b"labels" not in batch:
        raise ValueError(
            "not a CIFAR-10 batch: no b'labels' key (CIFAR-100 files "
            "carry b'fine_labels' and 100 classes — this converter is "
            "CIFAR-10 only)"
        )
    labels = np.asarray(batch[b"labels"], dtype=np.int64)
    if data.ndim != 2 or data.shape[1] != 3072:
        raise ValueError(
            f"not a CIFAR-10 batch: data shape {data.shape}"
        )
    if labels.size and (labels.min() < 0 or labels.max() > 9):
        raise ValueError(
            f"not a CIFAR-10 batch: labels outside [0, 9] "
            f"(min {labels.min()}, max {labels.max()})"
        )
    # Rows are channel-major [3, 32, 32]; the zoo model is NHWC.
    images = data.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(images), labels


def read_tar(path, split="train"):
    """(images, labels) concatenated from the official tar.gz — the five
    data_batch_* members for train, test_batch for test."""
    wanted = (
        [f"data_batch_{i}" for i in range(1, 6)]
        if split == "train"
        else ["test_batch"]
    )
    images, labels = [], []
    with tarfile.open(path, "r:*") as tar:
        members = {m.name.rsplit("/", 1)[-1]: m for m in tar.getmembers()}
        for name in wanted:
            m = members.get(name)
            if m is None:
                raise ValueError(f"{path}: member {name!r} not found")
            imgs, lbls = _decode_batch(tar.extractfile(m))
            images.append(imgs)
            labels.append(lbls)
    return np.concatenate(images), np.concatenate(labels)


def convert(images, labels, output_path, limit=None):
    n = images.shape[0] if limit is None else min(limit, images.shape[0])
    with RecordFileWriter(output_path) as w:
        for i in range(n):
            w.write(
                encode_example(
                    {"image": images[i], "label": np.int64(labels[i])}
                )
            )
    return n


def main(argv=None):
    p = argparse.ArgumentParser("cifar10_pickle")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument(
        "--batches", nargs="+", help="pickle batch files (data_batch_*)"
    )
    src.add_argument("--tar", help="cifar-10-python.tar.gz")
    p.add_argument("--split", choices=["train", "test"], default="train")
    p.add_argument("--output", required=True)
    p.add_argument("--limit", type=int, default=None)
    args = p.parse_args(argv)
    if args.tar:
        images, labels = read_tar(args.tar, args.split)
    else:
        parts = [read_batch_file(b) for b in args.batches]
        images = np.concatenate([x for x, _ in parts])
        labels = np.concatenate([y for _, y in parts])
    n = convert(images, labels, args.output, args.limit)
    print(f"wrote {n} examples to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
