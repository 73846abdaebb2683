"""Dataset-statistics lookup from the environment (a copy of
elasticdl_tpu/preprocessing/analyzer_utils.py; standard library only).

An external analysis job publishes per-feature statistics as environment
variables (`_{feature}_min`, `_{feature}_stddev`, ...) and the
preprocessing layers and feature columns pick them up when a model is
built, falling back to defaults. The variable names and defaults are the
JAX package's, so a job written against its analyzer contract
parameterizes the port's models unchanged.
"""

import os

_MIN = "_{}_min"
_MAX = "_{}_max"
_AVG = "_{}_avg"
_STDDEV = "_{}_stddev"
_BUCKET_BOUNDARIES = "_{}_boundaries"
_DISTINCT_COUNT = "_{}_distinct_count"
_VOCABULARY = "_{}_vocab"


def _float_env(template, feature_name, default_value):
    value = os.environ.get(template.format(feature_name))
    return float(value) if value is not None else default_value


def get_min(feature_name, default_value):
    return _float_env(_MIN, feature_name, default_value)


def get_max(feature_name, default_value):
    return _float_env(_MAX, feature_name, default_value)


def get_avg(feature_name, default_value):
    return _float_env(_AVG, feature_name, default_value)


def get_stddev(feature_name, default_value):
    return _float_env(_STDDEV, feature_name, default_value)


def get_bucket_boundaries(feature_name, default_value):
    """Comma-separated floats -> sorted list."""
    value = os.environ.get(_BUCKET_BOUNDARIES.format(feature_name))
    if value is None:
        return default_value
    return sorted(float(v) for v in value.split(",") if v.strip())


def get_distinct_count(feature_name, default_value):
    value = os.environ.get(_DISTINCT_COUNT.format(feature_name))
    return int(value) if value is not None else default_value


def get_vocabulary(feature_name, default_value):
    """Comma-separated tokens -> list."""
    value = os.environ.get(_VOCABULARY.format(feature_name))
    if value is None:
        return default_value
    return [v for v in value.split(",") if v]
