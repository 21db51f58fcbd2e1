"""The frozen operation and byte counts equal a fresh count (the λᵀ·H
count takes about two minutes on one core)."""

import json

import pytest

from portbench.counts import count as counting


@pytest.mark.parametrize("config,mix", counting.pairs())
def test_frozen_counts_equal_a_fresh_count(root, config, mix):
    fresh = counting.count(config, mix, root)
    frozen = json.loads((root / "portbench" / "counts"
                         / f"{config}.{fresh['entry']}.json").read_text())
    for key in ("ops_per_state", "bytes_per_state", "ops_plain_per_state",
                "joints"):
        assert frozen[key] == fresh[key], key
