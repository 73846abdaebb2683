"""Criteo-shaped feature schema: 13 integer features + 26 categorical (a
copy of elasticdl_tpu/models/dac_ctr/feature_config.py).

The statistics describe the synthetic generator (data/gen/criteo.py): same
schema as the Criteo DAC dump, the generator's own numbers. Heavy-tailed
counts for the I-features, categorical cardinalities spanning 3..10M with a
1M hashing cap.
"""

import numpy as np

NUM_DENSE = 13
NUM_CATEGORICAL = 26

DENSE_FEATURES = [f"I{i}" for i in range(1, NUM_DENSE + 1)]
CATEGORICAL_FEATURES = [f"C{i}" for i in range(1, NUM_CATEGORICAL + 1)]
FEATURE_NAMES = DENSE_FEATURES + CATEGORICAL_FEATURES
LABEL_KEY = "label"

# The synthetic generator draws I_k ~ round(lognormal(mu_k, sigma_k)) - 1
# (so -1 "missing" occurs); these are the exact normalization constants for
# that family, playing the role of the reference's measured FEATURES_AVGS /
# FEATURES_STDDEVS.
DENSE_LOG_MU = np.linspace(0.0, 6.0, NUM_DENSE)
DENSE_LOG_SIGMA = np.full(NUM_DENSE, 1.25)
DENSE_MEAN = np.exp(DENSE_LOG_MU + DENSE_LOG_SIGMA**2 / 2) - 1.0
DENSE_STD = np.sqrt(
    (np.exp(DENSE_LOG_SIGMA**2) - 1.0)
    * np.exp(2 * DENSE_LOG_MU + DENSE_LOG_SIGMA**2)
)

# Bucket boundaries: a geometric ladder per feature, covering its lognormal
# mass (counterpart of the reference's hand-measured FEATURE_BOUNDARIES).
DENSE_BOUNDARIES = [
    list(
        np.unique(
            np.round(
                np.exp(mu + sigma * np.array([-1.0, -0.5, 0.0, 0.5, 1.0, 1.5, 2.0]))
            )
        )
    )
    for mu, sigma in zip(DENSE_LOG_MU, DENSE_LOG_SIGMA)
]

# Categorical cardinalities: same magnitude spread as real Criteo (a few
# huge id spaces, many small ones), our own values.
CATEGORICAL_CARDINALITY = {
    "C1": 1400,
    "C2": 550,
    "C3": 9_500_000,
    "C4": 2_100_000,
    "C5": 300,
    "C6": 24,
    "C7": 12_000,
    "C8": 620,
    "C9": 3,
    "C10": 90_000,
    "C11": 5_500,
    "C12": 7_800_000,
    "C13": 3_200,
    "C14": 27,
    "C15": 15_000,
    "C16": 5_000_000,
    "C17": 10,
    "C18": 5_600,
    "C19": 2_200,
    "C20": 4,
    "C21": 6_500_000,
    "C22": 18,
    "C23": 15,
    "C24": 270_000,
    "C25": 100,
    "C26": 140_000,
}

MAX_HASHING_BUCKET_SIZE = 1_000_000


def hash_bins(feature: str) -> int:
    return min(CATEGORICAL_CARDINALITY[feature], MAX_HASHING_BUCKET_SIZE)


# Feature groups: like the reference's default FEATURE_GROUPS, every feature
# is its own group/field (I4 has no boundaries in the reference and is
# dropped from the id path there; we keep all 13).
FEATURE_GROUPS = [[name] for name in DENSE_FEATURES + CATEGORICAL_FEATURES]
