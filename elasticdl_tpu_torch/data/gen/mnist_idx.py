"""MNIST IDX -> .edlr record converter, offline (counterpart of
elasticdl_tpu/data/gen/mnist_idx.py).

Reads the standard IDX files (the format MNIST and Fashion-MNIST are
distributed in, possibly gzipped) from local disk and writes Example
records the zoo's `mnist_model.feed` consumes directly: {"image": uint8
[28, 28], "label": int64}.

CLI:
    python -m elasticdl_tpu_torch.data.gen.mnist_idx \
        --images train-images-idx3-ubyte[.gz] \
        --labels train-labels-idx1-ubyte[.gz] \
        --output mnist_train.edlr [--limit N]
"""

import argparse
import gzip
import struct

import numpy as np

from elasticdl_tpu_torch.data.example import encode_example
from elasticdl_tpu_torch.data.recordfile import RecordFileWriter

_IDX_DTYPES = {
    0x08: np.uint8,
    0x09: np.int8,
    0x0B: np.dtype(">i2"),
    0x0C: np.dtype(">i4"),
    0x0D: np.dtype(">f4"),
    0x0E: np.dtype(">f8"),
}


def read_idx(path):
    """Parse one IDX file (gzipped or raw) into an ndarray.

    IDX layout: 2 zero bytes, dtype code, ndim, then ndim big-endian
    uint32 dims, then the row-major payload."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    zeros, dtype_code, ndim = struct.unpack(">HBB", raw[:4])
    if zeros != 0:
        raise ValueError(f"{path}: not an IDX file (bad magic)")
    dtype = _IDX_DTYPES.get(dtype_code)
    if dtype is None:
        raise ValueError(f"{path}: unknown IDX dtype code {dtype_code:#x}")
    dims = struct.unpack(f">{ndim}I", raw[4:4 + 4 * ndim])
    data = np.frombuffer(raw[4 + 4 * ndim:], dtype=dtype)
    expect = int(np.prod(dims)) if dims else 0
    if data.size < expect:
        raise ValueError(
            f"{path}: truncated IDX payload ({data.size} < {expect})"
        )
    return data[:expect].reshape(dims)


def convert(images_path, labels_path, output_path, limit=None):
    """IDX image+label files -> one .edlr record file. Returns the number
    of examples written."""
    images = read_idx(images_path)
    labels = read_idx(labels_path)
    if images.shape[0] != labels.shape[0]:
        raise ValueError(
            f"image/label count mismatch: {images.shape[0]} vs "
            f"{labels.shape[0]}"
        )
    n = images.shape[0] if limit is None else min(limit, images.shape[0])
    with RecordFileWriter(output_path) as w:
        for i in range(n):
            w.write(
                encode_example(
                    {
                        "image": np.ascontiguousarray(
                            images[i], dtype=np.uint8
                        ),
                        "label": np.int64(labels[i]),
                    }
                )
            )
    return n


def main(argv=None):
    p = argparse.ArgumentParser("mnist_idx")
    p.add_argument("--images", required=True, help="IDX image file (.gz ok)")
    p.add_argument("--labels", required=True, help="IDX label file (.gz ok)")
    p.add_argument("--output", required=True, help=".edlr output path")
    p.add_argument("--limit", type=int, default=None)
    args = p.parse_args(argv)
    n = convert(args.images, args.labels, args.output, args.limit)
    print(f"wrote {n} examples to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
