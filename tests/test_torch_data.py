"""repro_torch.data.datasets against repro.data.datasets, and the ratio.

The seeded surrogates must give the same bytes in both packages (the quant
codes go through each package's own quantizer), and the port's raw LZSS
ratio on hurr-quant must be the one the reference recorded.
"""

import numpy as np
import pytest

from repro.data import datasets as jds
from repro_torch import core as tcore
from repro_torch.data import datasets as tds


@pytest.mark.parametrize("name", sorted(jds.DATASETS))
def test_dataset_bytes_equal_reference(name):
    assert sorted(tds.DATASETS) == sorted(jds.DATASETS)
    got, want = tds.load(name, 65536), jds.load(name, 65536)
    assert got.dtype == np.uint8 and got.size == want.size
    assert np.array_equal(got, want)


def test_hurr_quant_ratio_is_the_recorded_one():
    # BENCH_ratio.json's 64 KiB sweep: the first 64 KiB of a 128 KiB
    # hurr-quant generation at the default LZSSConfig (S=2, W=128, C=2048)
    data = tds.load("hurr-quant", 1 << 17)[: 1 << 16]
    assert tcore.compression_ratio(data, device="cpu") == 2.431491856194116


def test_paper_ratio_table_is_carried_over():
    assert tds.PAPER_RATIOS_DEFAULT == jds.PAPER_RATIOS_DEFAULT
