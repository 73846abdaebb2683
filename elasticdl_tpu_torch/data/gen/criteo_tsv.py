"""Criteo DAC raw-TSV -> .edlr record converter (counterpart of
elasticdl_tpu/data/gen/criteo_tsv.py).

The raw format (the DAC dump's train.txt / day_N): one example per line,
TAB-separated: the label, 13 integer features (empty = missing) and 26
categorical features as 8-hex-digit strings (empty = missing). Records come
out with the synthetic generator's schema (data/gen/criteo.py: {label,
I1..I13 float32, C1..C26 int64}), so the dac_ctr models' feed and deepctr's
WDL read either. A missing dense value encodes -1.0 and a missing
categorical 0; a hex categorical parses to its int64 value.

CLI:
    python -m elasticdl_tpu_torch.data.gen.criteo_tsv \
        --input train.txt --output criteo.edlr [--limit N]
"""

import argparse
import gzip

import numpy as np

from elasticdl_tpu_torch.data.example import encode_example
from elasticdl_tpu_torch.data.recordfile import RecordFileWriter
from elasticdl_tpu_torch.models.dac_ctr import feature_config as fc

_NUM_FIELDS = 1 + fc.NUM_DENSE + len(fc.CATEGORICAL_FEATURES)


def parse_line(line):
    """One TSV line -> {label, I1..I13, C1..C26} feature dict."""
    parts = line.rstrip("\n").split("\t")
    if len(parts) != _NUM_FIELDS:
        raise ValueError(
            f"bad DAC line: {len(parts)} fields, expected {_NUM_FIELDS}"
        )
    features = {"label": np.int64(parts[0])}
    for k, name in enumerate(fc.DENSE_FEATURES):
        raw = parts[1 + k]
        features[name] = np.float32(raw) if raw else np.float32(-1.0)
    offset = 1 + fc.NUM_DENSE
    for k, name in enumerate(fc.CATEGORICAL_FEATURES):
        raw = parts[offset + k]
        features[name] = np.int64(int(raw, 16)) if raw else np.int64(0)
    return features


def convert(input_path, output_path, limit=None):
    """DAC TSV (optionally .gz) -> one .edlr file. Returns rows written."""
    opener = gzip.open if str(input_path).endswith(".gz") else open
    n = 0
    with opener(input_path, "rt") as f, RecordFileWriter(output_path) as w:
        for line in f:
            if limit is not None and n >= limit:
                break
            if not line.strip():
                continue
            w.write(encode_example(parse_line(line)))
            n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser("criteo_tsv")
    p.add_argument("--input", required=True, help="train.txt[.gz] DAC dump")
    p.add_argument("--output", required=True, help=".edlr output path")
    p.add_argument("--limit", type=int, default=None)
    args = p.parse_args(argv)
    n = convert(args.input, args.output, args.limit)
    print(f"wrote {n} examples to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
